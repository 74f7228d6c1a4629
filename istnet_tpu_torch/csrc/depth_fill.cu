// ip_basic multiscale depth completion of whole images for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/depth_fill_pallas.py: _fill_kernel
// (via fill_in_multiscale_pallas). Per image (metres in, metres out):
//   invert the valid depths (x > 0.01 -> max_depth - x);
//   three band-masked cross dilations of the ORIGINAL inverted map, far
//   (x0 > 2, r = 1), medium (1 < x0 <= 2, r = 2), near (0.01 < x0 <= 1,
//   r = 3), applied in that order where the dilation is > 0.01;
//   5x5 closing (dilation, then erosion = -dilate(-x));
//   5x5 median where valid;
//   top mask (rows at or below the first valid row of the column; an empty
//   column is all true); 9x9 dilation into the pixels that are not valid
//   under the mask;
//   a new top mask; six 5x5 dilations into the pixels with x < 0.01 under
//   the mask; 5x5 median where valid under the mask; 5x5 disk bilateral
//   (sigma_color 0.5, sigma_space 2) under that same mask; un-invert.
// Dilations see -inf outside the image, the erosion +inf, the median
// replicates the edge, the bilateral reflects (reflect-101).
//
// What bounds it on this card: instruction issue, not bytes. The image is
// read and written once (8 bytes a pixel, 2.46 MB a 480x640 frame); what
// costs is per pixel two exact medians of 25 (sorts and a merge network of
// compare-exchanges: ~170 min/max instructions each, the ALU pipe's work),
// the bilateral's 13 exps, the stencils and the halo each tile recomputes.
// The first version's five launches also spent two column scans on the
// top masks, one dependent load a row: an empty column scanned all 480
// rows (PERF.md section 6: 2 x 99 us of a 267 us frame). The design:
// - Two launches and one memset under one C entry. stage_a reduces the
//   first valid row of its tile's columns and merges it into `first` (b,
//   w) with atomicMin (deterministic in any order); "no valid row" is the
//   byte pattern 0x7f7f7f7f that cudaMemsetAsync writes first, read as
//   row 0 (an empty column is all true). The second top mask needs no
//   reduction of its own: the 9x9 fill writes only under the first mask,
//   so a column with a valid pixel keeps its first valid row, and an empty
//   one's becomes 4 above the least first valid row of the columns within
//   4 of it. So stage_b runs the fill on its own plane, halo included:
//     1. stage_a: bands + closing + first median, a 48x64 tile with a halo
//        of 3 + 2 + 2 + 2 = 9 in three shared planes (dynamic, 65 KB);
//     2. stage_b: the 9x9 fill, six dilations, median, bilateral and
//        un-invert, a 40x60 tile with a halo of 4 + 6 * 2 + 2 + 2 = 20 in
//        two shared planes (dynamic, 64 KB).
//   That makes 100 and 132 blocks a frame: none of the 132 SMs takes two
//   at one frame.
// - Every window is separable: a full (2R+1)^2 maximum or minimum is a row
//   pass into a second plane, then a column pass; a masked dilation takes
//   the full window's maximum that way and writes it only where its mask
//   holds (the column pass updates its own cell in place: no other thread
//   reads that plane in the pass). The band crosses read three planes of
//   band values (in band: the inverted depth, else 0; -inf outside the
//   image) formed once a pixel. stage_b skips the fill when its plane has
//   no pixel to fill under the first mask, and then the six dilations too
//   (the second mask lies inside the first).
// - The medians run down a column, P pixels a thread: the 5x5 windows of
//   vertically adjacent pixels share four of their five row quintuples, so
//   each row's quintuple is sorted once (9 compare-exchanges) for P
//   pixels, then every pixel runs the pruned merge network (82; the pair
//   merges it shares with the pixel two rows down are computed once). The
//   median of 25 values is the same whichever five quintuples are sorted
//   first.
// - Every thread issues all its loads of a plane before it waits on one;
//   before a median the plane's ring outside the image takes the edge's
//   values, before the bilateral the reflected ones, so every tap is a
//   load at a fixed offset.
// A tile recomputes its halo, so neighbouring tiles agree bit for bit. Any
// exact median of 25 gives the same bits; so does every max and min here.
// Only the bilateral's expf and divide round on their own; it keeps the
// 13-tap disk, reflect-101 and the row-major order of its sums.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kValid = 0.01f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7f7f7f7f;  // no valid row yet: cudaMemsetAsync's 0x7f bytes

// A shared plane of SW columns whose local (0, 0) is image pixel (gy0, gx0).
template <int SW>
struct Plane {
  int gy0, gx0, h, w;
  __device__ bool inside(int ly, int lx) const {
    const int gy = gy0 + ly, gx = gx0 + lx;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  }
  // whether the cells at margin M reach outside the image
  __device__ bool at_border(int sh, int m) const {
    return gy0 + m < 0 || gx0 + m < 0 || gy0 + sh - m > h || gx0 + SW - m > w;
  }
};

// f(ly, lx) on the cells of rows [r0, r1) and columns [c0, c1), the lanes
// of a warp along a row
template <typename F>
__device__ __forceinline__ void for_cells(int r0, int r1, int c0, int c1, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ly = r0 + warp; ly < r1; ly += kWarps)
    for (int lx = c0 + lane; lx < c1; lx += 32) f(ly, lx);
}

// Loads the SH x SW cells of plane p from `image` (h x w), then calls
// store(ly, lx, inside, value, k) on each, k the thread's k-th cell
// (threadIdx.x + k * kThreads, row-major): every load of a thread is in
// flight before the first store waits on one (value 0 outside the image).
template <int SH, int SW, typename F>
__device__ __forceinline__ void load_plane(const Plane<SW>& p, const float* __restrict__ image,
                                           F&& store) {
  constexpr int kCells = SH * SW, kPer = (kCells + kThreads - 1) / kThreads;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, ly = i / SW, lx = i - ly * SW;
    v[k] = 0.0f;
    if (i < kCells && p.inside(ly, lx)) {
      v[k] = image[static_cast<size_t>(p.gy0 + ly) * p.w + p.gx0 + lx];
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, ly = i / SW, lx = i - ly * SW;
    if (i < kCells) store(ly, lx, p.inside(ly, lx), v[k], k);
  }
}

template <bool kMax>
__device__ __forceinline__ float extreme(float a, float b) {
  return kMax ? fmaxf(a, b) : fminf(a, b);
}

// dst = the extreme of src over [lx - R, lx + R] in each cell's row
template <int SW, int R, bool kMax>
__device__ void row_pass(const float* src, float* dst, int r0, int r1, int c0, int c1) {
  for_cells(r0, r1, c0, c1, [&](int ly, int lx) {
    const float* s = src + ly * SW + lx;
    float v = s[-R];
#pragma unroll
    for (int d = 1 - R; d <= R; ++d) v = extreme<kMax>(v, s[d]);
    dst[ly * SW + lx] = v;
  });
}

// the extreme of a row pass's plane over [ly - R, ly + R] in lx's column
template <int SW, int R, bool kMax>
__device__ __forceinline__ float column_extreme(const float* rows, int ly, int lx) {
  const float* s = rows + ly * SW + lx;
  float v = s[-R * SW];
#pragma unroll
  for (int d = 1 - R; d <= R; ++d) v = extreme<kMax>(v, s[d * SW]);
  return v;
}

// dst = the full (2R+1)^2 extreme, from the row pass `rows`, inside the
// image; `pad` outside it, the neutral element of whatever reads dst next
template <int SW, int R, bool kMax>
__device__ void column_pass(const Plane<SW>& p, const float* rows, float* dst,
                            int r0, int r1, int c0, int c1, float pad) {
  for_cells(r0, r1, c0, c1, [&](int ly, int lx) {
    dst[ly * SW + lx] = p.inside(ly, lx) ? column_extreme<SW, R, kMax>(rows, ly, lx) : pad;
  });
}

// Before a median: the cells outside the image in [m, sh - m) x [m, SW - m)
// take the value of the nearest pixel inside (edge replicate). Before the
// bilateral (kReflect): that of the reflect-101 pixel. Only cells inside
// the image are read, so the step has no race.
template <int SW, bool kReflect>
__device__ void fill_ring(const Plane<SW>& p, float* plane, int sh, int m) {
  if (!p.at_border(sh, m)) return;  // block-uniform
  for_cells(m, sh - m, m, SW - m, [&](int ly, int lx) {
    if (p.inside(ly, lx)) return;
    int gy = p.gy0 + ly, gx = p.gx0 + lx;
    if (kReflect) {
      gy = gy < 0 ? -gy : (gy >= p.h ? 2 * p.h - 2 - gy : gy);
      gx = gx < 0 ? -gx : (gx >= p.w ? 2 * p.w - 2 - gx : gx);
    } else {
      gy = min(max(gy, 0), p.h - 1);
      gx = min(max(gx, 0), p.w - 1);
    }
    plane[ly * SW + lx] = plane[(gy - p.gy0) * SW + gx - p.gx0];
  });
}

__device__ __forceinline__ void cex(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// a quintuple sorted ascending (the optimal 9-exchange network)
__device__ __forceinline__ void sort5(float (&s)[5]) {
  cex(s[0], s[1]); cex(s[3], s[4]); cex(s[2], s[4]); cex(s[2], s[3]);
  cex(s[1], s[4]); cex(s[0], s[3]); cex(s[0], s[2]); cex(s[1], s[3]);
  cex(s[1], s[2]);
}

#define CE(a, b) cex(v[a], v[b]);

// rank 12 of 25 values held as five sorted quintuples v[5k .. 5k + 4]
__device__ __forceinline__ float merge25(float (&v)[25]) {
  // MEDIAN25-BEGIN: odd-even merges ((5,5),(5,5)) -> (10,10) -> (20,5) of the
  // five sorted runs, pruned to what rank 12 depends on; the median is v[14]
  CE(0, 5) CE(4, 9) CE(4, 5) CE(2, 7) CE(2, 4) CE(7, 5) CE(1, 6) CE(3, 8)
  CE(3, 6) CE(1, 2) CE(3, 4) CE(6, 7) CE(8, 5) CE(10, 15) CE(14, 19)
  CE(14, 15) CE(12, 17) CE(12, 14) CE(17, 15) CE(11, 16) CE(13, 18)
  CE(13, 16) CE(11, 12) CE(13, 14) CE(16, 17) CE(18, 15) CE(0, 10) CE(5, 15)
  CE(5, 10) CE(4, 14) CE(4, 5) CE(14, 10) CE(2, 12) CE(7, 17) CE(7, 12)
  CE(2, 4) CE(7, 5) CE(12, 14) CE(17, 10) CE(1, 11) CE(9, 19) CE(9, 11)
  CE(6, 16) CE(6, 9) CE(16, 11) CE(3, 13) CE(8, 18) CE(8, 13) CE(3, 6)
  CE(8, 9) CE(13, 16) CE(18, 11) CE(1, 2) CE(3, 4) CE(6, 7) CE(8, 5)
  CE(9, 12) CE(13, 14) CE(16, 17) CE(18, 10) CE(11, 15) CE(0, 20) CE(10, 20)
  CE(5, 10) CE(4, 24) CE(14, 24) CE(14, 10) CE(2, 22) CE(15, 22) CE(12, 15)
  CE(7, 12) CE(12, 14) CE(1, 21) CE(11, 21) CE(9, 11) CE(16, 11) CE(3, 23)
  CE(19, 23) CE(13, 19) CE(8, 13) CE(13, 16) CE(13, 14)
  // MEDIAN25-END
  return v[14];
}

#undef CE

// The exact 5x5 medians of the P pixels (ly0 + p, lx) of plane src; the
// ring the windows reach holds the edge-replicated values. Each row's
// quintuple is sorted once for the P windows that share it, and pixels p
// and p + 2 share a pair merge of the network (the compiler finds it: the
// run is one straight line of code).
template <int P, int SW>
__device__ __forceinline__ void median_run(const float* src, int ly0, int lx,
                                           float (&med)[P]) {
  float q[P + 4][5];
#pragma unroll
  for (int k = 0; k < P + 4; ++k) {
    const float* row = src + (ly0 - 2 + k) * SW + lx - 2;
#pragma unroll
    for (int j = 0; j < 5; ++j) q[k][j] = row[j];
    sort5(q[k]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v[25];
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int j = 0; j < 5; ++j) v[5 * k + j] = q[p + k][j];
    med[p] = merge25(v);
  }
}

__device__ __forceinline__ int top_row(int first) { return first == kNone ? 0 : first; }

// ---------------------------------------------------------------------------
// 1. bands + closing + first median
// ---------------------------------------------------------------------------
constexpr int kTileAH = 48, kTileAW = 64, kHaloA = 9;
constexpr int kRunA = 6, kBlocksA = 3;  // medians a thread; blocks an SM
constexpr int kSideAH = kTileAH + 2 * kHaloA, kSideAW = kTileAW + 2 * kHaloA;
constexpr int kPlaneA = kSideAH * kSideAW;
constexpr size_t kSmemA = 3 * sizeof(float) * kPlaneA;
constexpr int kRunsA = kTileAH / kRunA * (kTileAW / 32);
static_assert(kTileAH % kRunA == 0 && kTileAW % 32 == 0, "stage_a: median runs");

__device__ __forceinline__ float inverted(float x0, float max_depth) {
  return x0 > kValid ? max_depth - x0 : x0;
}

// maximum over the cross of radius R around (ly, lx) of a band plane
template <int R>
__device__ __forceinline__ float cross_max(const float* u, int ly, int lx) {
  const float* c = u + ly * kSideAW + lx;
  float d = c[0];
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    d = fmaxf(d, fmaxf(fmaxf(c[-k], c[k]), fmaxf(c[-k * kSideAW], c[k * kSideAW])));
  }
  return d;
}

__global__ void __launch_bounds__(kThreads, kBlocksA)
stage_a(const float* __restrict__ depth, int h, int w, float max_depth,
        float* __restrict__ out, int* __restrict__ first) {
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ int s_first[kTileAW];
  float* u_far = s_dyn;
  float* u_med = s_dyn + kPlaneA;
  float* u_near = s_dyn + 2 * kPlaneA;
  const int b = blockIdx.z;
  const size_t image = static_cast<size_t>(b) * h * w;
  const Plane<kSideAW> p{static_cast<int>(blockIdx.y) * kTileAH - kHaloA,
                         static_cast<int>(blockIdx.x) * kTileAW - kHaloA, h, w};

  // the band values (in band: the inverted depth, else 0; -inf outside the
  // image, where a cross leaves its taps out); a thread keeps its cells'
  // depths in registers (v[k] is cell threadIdx.x + k * kThreads)
  constexpr int kPer = (kPlaneA + kThreads - 1) / kThreads;
  float v[kPer];
  load_plane<kSideAH, kSideAW>(p, depth + image, [&](int ly, int lx, bool inside, float x0,
                                                   int k) {
    float far = -CUDART_INF_F, med = -CUDART_INF_F, near = -CUDART_INF_F;
    if (inside) {
      const float x = inverted(x0, max_depth);
      far = x0 > 2.0f ? x : 0.0f;
      med = x0 > 1.0f && x0 <= 2.0f ? x : 0.0f;
      near = x0 > kValid && x0 <= 1.0f ? x : 0.0f;
    }
    const int i = ly * kSideAW + lx;
    u_far[i] = far, u_med[i] = med, u_near[i] = near;
    v[k] = x0;
  });
  for (int c = threadIdx.x; c < kTileAW; c += kThreads) s_first[c] = kNone;
  __syncthreads();

  // the three band dilations, far -> medium -> near, each of the original
  // inverted map, at margin 3; -inf outside the image. The results wait in
  // registers until no thread reads the band planes, then go to s_x (the
  // far plane's memory).
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, ly = i / kSideAW, lx = i - ly * kSideAW;
    const bool inner = ly >= 3 && ly < kSideAH - 3 && lx >= 3 && lx < kSideAW - 3;
    float x = -CUDART_INF_F;
    if (i < kPlaneA && inner && p.inside(ly, lx)) {
      x = inverted(v[k], max_depth);
      float d = cross_max<1>(u_far, ly, lx);
      if (d > kValid) x = d;
      d = cross_max<2>(u_med, ly, lx);
      if (d > kValid) x = d;
      d = cross_max<3>(u_near, ly, lx);
      if (d > kValid) x = d;
    }
    v[k] = x;
  }
  __syncthreads();
  float* s_x = u_far;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kPlaneA) s_x[i] = v[k];
  }
  __syncthreads();

  // closing: dilation into u_near at margin 5 (+inf outside for the
  // erosion), erosion into s_x at margin 7; u_med holds the row passes
  row_pass<kSideAW, 2, true>(s_x, u_med, 3, kSideAH - 3, 5, kSideAW - 5);
  __syncthreads();
  column_pass<kSideAW, 2, true>(p, u_med, u_near, 5, kSideAH - 5, 5, kSideAW - 5,
                                CUDART_INF_F);
  __syncthreads();
  row_pass<kSideAW, 2, false>(u_near, u_med, 5, kSideAH - 5, 7, kSideAW - 7);
  __syncthreads();
  column_pass<kSideAW, 2, false>(p, u_med, s_x, 7, kSideAH - 7, 7, kSideAW - 7, 0.0f);
  __syncthreads();
  fill_ring<kSideAW, false>(p, s_x, kSideAH, 7);
  __syncthreads();

  // median where valid; a warp takes 32 columns x kRunA rows of the tile at
  // a time, a thread one column of them
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int task = warp; task < kRunsA; task += kWarps) {
    const int lx = kHaloA + (task % (kTileAW / 32)) * 32 + lane;
    const int ly0 = kHaloA + (task / (kTileAW / 32)) * kRunA;
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRunA; ++k) {
      any = any || (p.inside(ly0 + k, lx) && s_x[(ly0 + k) * kSideAW + lx] > kValid);
    }
    float med[kRunA];
    if (any) median_run<kRunA, kSideAW>(s_x, ly0, lx, med);
    int top = kNone;
#pragma unroll
    for (int k = kRunA - 1; k >= 0; --k) {
      if (!p.inside(ly0 + k, lx)) continue;
      const int gy = p.gy0 + ly0 + k;
      const float x = s_x[(ly0 + k) * kSideAW + lx];
      const float o = x > kValid ? med[k] : x;
      out[image + static_cast<size_t>(gy) * w + p.gx0 + lx] = o;
      if (o > kValid) top = gy;
    }
    if (top != kNone) atomicMin(&s_first[lx - kHaloA], top);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kTileAW; c += kThreads) {
    if (s_first[c] != kNone) atomicMin(&first[static_cast<size_t>(b) * w + p.gx0 + kHaloA + c], s_first[c]);
  }
}

// ---------------------------------------------------------------------------
// 2. 9x9 fill, six dilations, median, bilateral, un-invert
// ---------------------------------------------------------------------------
// The second top mask follows from the first: the 9x9 fill writes only
// under the first mask, so a column with a valid pixel keeps its first
// valid row, and an empty column's first valid row after the fill lies 4
// above the least first valid row of the columns within 4 of it (row 0 at
// least; none when they are all empty). So the fill needs no launch of its
// own: each tile fills its plane, halo included.
constexpr int kFillR = 4;
constexpr int kTileBH = 40, kTileBW = 60, kHaloB = kFillR + 16;
constexpr int kRunB = 11, kBlocksB = 2;  // medians a thread; blocks an SM
constexpr int kSideBH = kTileBH + 2 * kHaloB, kSideBW = kTileBW + 2 * kHaloB;
constexpr size_t kSmemB = 2 * sizeof(float) * kSideBH * kSideBW;
// the median runs over the tile and its ring of 2: (kTileBH + 4) x 64, in
// runs of 32 columns x kRunB rows
constexpr int kRunsB = (kTileBH + 4) / kRunB * 2;
static_assert((kTileBH + 4) % kRunB == 0 && kTileBW + 4 == 64, "stage_b: median runs");

__global__ void __launch_bounds__(kThreads, kBlocksB)
stage_b(const float* __restrict__ x_in, const int* __restrict__ first, int h, int w,
        float max_depth, int bilateral, float* __restrict__ out) {
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ int s_top0[kSideBW], s_top1[kSideBW];
  float* s_x = s_dyn;
  float* s_r = s_dyn + kSideBH * kSideBW;
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w;
  const Plane<kSideBW> p{static_cast<int>(blockIdx.y) * kTileBH - kHaloB,
                         static_cast<int>(blockIdx.x) * kTileBW - kHaloB, h, w};
  const int* f = first + static_cast<size_t>(blockIdx.z) * w;
  const auto first_at = [&](int gx) { return gx >= 0 && gx < w ? f[gx] : kNone; };
  for (int lx = threadIdx.x; lx < kSideBW; lx += kThreads) {
    const int gx = p.gx0 + lx;
    int g = kNone;
    for (int d = -kFillR; d <= kFillR; ++d) g = min(g, first_at(gx + d));
    const int f0 = first_at(gx);
    s_top0[lx] = top_row(f0);
    s_top1[lx] = f0 != kNone ? f0 : (g == kNone ? 0 : max(g - kFillR, 0));
  }
  __syncthreads();
  const auto under_mask = [&](int ly, int lx, const int* top) {
    return p.inside(ly, lx) && p.gy0 + ly >= top[lx];
  };

  // 9x9 dilation into the pixels that are not valid under the first mask,
  // at margin kFillR (in place: each cell reads only its own s_x and the
  // row pass)
  bool fill = false;
  load_plane<kSideBH, kSideBW>(p, x_in + image, [&](int ly, int lx, bool inside, float x, int) {
    const bool ring = ly >= kFillR && ly < kSideBH - kFillR && lx >= kFillR &&
                      lx < kSideBW - kFillR;
    fill = fill || (inside && ring && !(x > kValid) && p.gy0 + ly >= s_top0[lx]);
    s_x[ly * kSideBW + lx] = inside ? x : -CUDART_INF_F;
  });
  // the dilations fill pixels that the 9x9 fill could have (the second mask
  // lies inside the first): without the one, none of the other
  bool dilate = false;
  if (__syncthreads_or(fill)) {
    row_pass<kSideBW, kFillR, true>(s_x, s_r, 0, kSideBH, kFillR, kSideBW - kFillR);
    __syncthreads();
    for_cells(kFillR, kSideBH - kFillR, kFillR, kSideBW - kFillR, [&](int ly, int lx) {
      float& x = s_x[ly * kSideBW + lx];
      if (!(x > kValid) && under_mask(ly, lx, s_top0)) {
        x = column_extreme<kSideBW, kFillR, true>(s_r, ly, lx);
      }
      dilate = dilate || (x < kValid && under_mask(ly, lx, s_top1));
    });
  }
  // six 5x5 dilations into the pixels with x < 0.01 under the second mask
  if (__syncthreads_or(dilate)) {
    for (int m = kFillR + 2; m <= kFillR + 12; m += 2) {
      row_pass<kSideBW, 2, true>(s_x, s_r, m - 2, kSideBH - m + 2, m, kSideBW - m);
      __syncthreads();
      for_cells(m, kSideBH - m, m, kSideBW - m, [&](int ly, int lx) {
        float& x = s_x[ly * kSideBW + lx];
        if (x < kValid && under_mask(ly, lx, s_top1)) {
          x = column_extreme<kSideBW, 2, true>(s_r, ly, lx);
        }
      });
      __syncthreads();
    }
  }
  fill_ring<kSideBW, false>(p, s_x, kSideBH, kFillR + 12);
  __syncthreads();

  // median where valid under the mask: s_x (margin kHaloB - 4) -> s_r
  // (margin kHaloB - 2), a warp 32 columns x kRunB rows at a time
  const auto valid = [&](int ly, int lx) {
    return s_x[ly * kSideBW + lx] > kValid && under_mask(ly, lx, s_top1);
  };
  for (int task = threadIdx.x >> 5; task < kRunsB; task += kWarps) {
    const int lx = kHaloB - 2 + (task % 2) * 32 + (threadIdx.x & 31);
    const int ly0 = kHaloB - 2 + (task / 2) * kRunB;
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRunB; ++k) any = any || valid(ly0 + k, lx);
    float med[kRunB];
    if (any) median_run<kRunB, kSideBW>(s_x, ly0, lx, med);
#pragma unroll
    for (int k = 0; k < kRunB; ++k) {
      const int ly = ly0 + k;
      if (p.inside(ly, lx)) s_r[ly * kSideBW + lx] = valid(ly, lx) ? med[k] : s_x[ly * kSideBW + lx];
    }
  }
  __syncthreads();
  fill_ring<kSideBW, true>(p, s_r, kSideBH, kHaloB - 2);
  __syncthreads();

  // bilateral over the 13 taps of the radius-2 disk, row-major, under the
  // median step's mask; exp(-d2 / (2 * sigma_space^2)) for d2 = 0, 1, 2, 4
  const float space[5] = {1.0f, static_cast<float>(0.8824969025845953),
                          static_cast<float>(0.7788007830714049), 0.0f,
                          static_cast<float>(0.6065306597126334)};
  for_cells(kHaloB, kHaloB + kTileBH, kHaloB, kHaloB + kTileBW, [&](int ly, int lx) {
    if (!p.inside(ly, lx)) return;
    const float* c = s_r + ly * kSideBW + lx;
    float x = c[0];
    if (bilateral && valid(ly, lx)) {
      const float centre = x;
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int dy = -2; dy <= 2; ++dy)
#pragma unroll
        for (int dx = -2; dx <= 2; ++dx) {
          if (dy * dy + dx * dx > 4) continue;
          const float t = c[dy * kSideBW + dx];
          const float diff = t - centre;
          // exp(-0.5 * diff^2 / sigma_color^2), sigma_color = 0.5
          const float wgt = space[dy * dy + dx * dx] * expf(-2.0f * (diff * diff));
          num += wgt * t;
          den += wgt;
        }
      x = num / den;
    }
    out[image + static_cast<size_t>(p.gy0 + ly) * w + p.gx0 + lx] =
        x > kValid ? max_depth - x : x;
  });
}

}  // namespace

// depth (b, h, w) f32 metres, contiguous -> out (b, h, w) f32. tmp0 and tmp1
// are (b, h, w) f32 scratch (tmp1 is not used), first is (b, w) int32
// scratch; h, w >= 5.
extern "C" int istnet_depth_fill(const float* depth, int b, int h, int w,
                                 float max_depth, int bilateral, float* tmp0,
                                 float* tmp1, int* first, float* out,
                                 void* stream) {
  (void)tmp1;
  if (h < 5 || w < 5) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(first, 0x7f, sizeof(int) * b * w, s);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(stage_a, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemA));
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(stage_b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemB));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 tiles_a((w + kTileAW - 1) / kTileAW, (h + kTileAH - 1) / kTileAH, b);
  const dim3 tiles_b((w + kTileBW - 1) / kTileBW, (h + kTileBH - 1) / kTileBH, b);
  stage_a<<<tiles_a, kThreads, kSmemA, s>>>(depth, h, w, max_depth, tmp0, first);
  stage_b<<<tiles_b, kThreads, kSmemB, s>>>(tmp0, first, h, w, max_depth, bilateral, out);
  return static_cast<int>(cudaGetLastError());
}
