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
// What bounds it: one read and one write of the image (8 bytes a pixel,
// 2.46 MB a 480x640 frame), far below what the stencils cost in shared
// memory loads and compare-exchanges; at one frame the five launches
// themselves outweigh the bytes. The TPU kernel held the whole 1.2 MB image
// in VMEM. A block here has 227 KB, and the two top masks are reductions over
// a full column of an intermediate, so the chain is cut there into five
// launches under one C entry:
//   1. stage_a: bands + closing + first median, a 32x32 tile with a halo of
//      3+2+2+2 = 9 in two shared planes;
//   2. first_valid_row: one thread a column;
//   3. stage_c: the 9x9 fill, halo 4;
//   4. first_valid_row again;
//   5. stage_d: six dilations + median + bilateral + un-invert, halo
//      6*2+2+2 = 16, two shared planes of 64x64.
// A tile recomputes its halo, so neighbouring tiles agree bit for bit. The
// two intermediates between the launches are an image each in device memory
// (they stay in the 50 MB L2 at one frame). The median is a selection
// network in registers: five sorted vertical quintuples (9 compare-exchanges
// each), then a pruned odd-even merge tree to rank 12 (82). Any exact median
// of 25 gives the same bits; so does every max and min here. Only the
// bilateral's expf and divide round on their own.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kValid = 0.01f;
constexpr int kTile = 32;
constexpr int kThreads = 256;

// A square shared plane of side S whose local (0, 0) is image pixel
// (gy0, gx0); cells of the ring of width M are not written by the step
// that fills it.
template <int S>
struct Plane {
  int gy0, gx0, h, w;
  __device__ bool inside(int ly, int lx) const {
    const int gy = gy0 + ly, gx = gx0 + lx;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  }
};

// dst = full (2R+1)^2 maximum (or minimum) of src on the cells at margin M;
// src holds the neutral element outside the image, and dst gets `pad`
// there, the neutral element of whatever reads it next.
template <int S, int M, int R, bool kMax>
__device__ void window_extreme(const Plane<S>& p, const float* src, float* dst,
                               float pad) {
  constexpr int n = S - 2 * M;
  for (int i = threadIdx.x; i < n * n; i += kThreads) {
    const int ly = M + i / n, lx = M + i % n;
    float v = pad;
    if (p.inside(ly, lx)) {
      v = src[ly * S + lx];
#pragma unroll
      for (int dy = -R; dy <= R; ++dy)
#pragma unroll
        for (int dx = -R; dx <= R; ++dx) {
          const float t = src[(ly + dy) * S + lx + dx];
          v = kMax ? fmaxf(v, t) : fminf(v, t);
        }
    }
    dst[ly * S + lx] = v;
  }
}

#define CE(a, b)                        \
  {                                     \
    const float lo = fminf(v[a], v[b]); \
    v[b] = fmaxf(v[a], v[b]);           \
    v[a] = lo;                          \
  }

// Exact median of the 5x5 window of src around local (ly, lx), the window
// clamped to the image (edge replicate). v[5k + j] is column k, row j.
template <int S>
__device__ float median25(const Plane<S>& p, const float* src, int ly, int lx) {
  float v[25];
  const int gy = p.gy0 + ly, gx = p.gx0 + lx;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int cx = min(max(gx + k - 2, 0), p.w - 1) - p.gx0;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int cy = min(max(gy + j - 2, 0), p.h - 1) - p.gy0;
      v[5 * k + j] = src[cy * S + cx];
    }
  }
  // each vertical quintuple sorted ascending (the optimal 9-exchange network)
#pragma unroll
  for (int k = 0; k < 25; k += 5) {
    CE(k + 0, k + 1) CE(k + 3, k + 4) CE(k + 2, k + 4) CE(k + 2, k + 3)
    CE(k + 1, k + 4) CE(k + 0, k + 3) CE(k + 0, k + 2) CE(k + 1, k + 3)
    CE(k + 1, k + 2)
  }
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

// ---------------------------------------------------------------------------
// 1. bands + closing + first median
// ---------------------------------------------------------------------------
constexpr int kHaloA = 9;
constexpr int kSideA = kTile + 2 * kHaloA;

__device__ __forceinline__ float inverted(float x0, float max_depth) {
  return x0 > kValid ? max_depth - x0 : x0;
}

// maximum over the cross of radius R of (band(x0) ? inverted(x0) : 0), taps
// outside the image left out (they would be -inf)
template <int R>
__device__ float band_cross(const Plane<kSideA>& p, const float* raw, int ly,
                            int lx, float lo, float hi, float max_depth) {
  float d = -CUDART_INF_F;
#pragma unroll
  for (int k = -R; k <= R; ++k) {
#pragma unroll
    for (int vertical = 0; vertical < 2; ++vertical) {
      if (vertical && k == 0) continue;  // the centre once
      const int ty = vertical ? ly + k : ly, tx = vertical ? lx : lx + k;
      if (!p.inside(ty, tx)) continue;
      const float x0 = raw[ty * kSideA + tx];
      const bool in_band = x0 > lo && x0 <= hi;
      d = fmaxf(d, in_band ? inverted(x0, max_depth) : 0.0f);
    }
  }
  return d;
}

__global__ void __launch_bounds__(kThreads)
stage_a(const float* __restrict__ depth, int h, int w, float max_depth,
        float* __restrict__ out) {
  __shared__ float s_a[kSideA * kSideA];
  __shared__ float s_b[kSideA * kSideA];
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w;
  Plane<kSideA> p{static_cast<int>(blockIdx.y) * kTile - kHaloA,
                  static_cast<int>(blockIdx.x) * kTile - kHaloA, h, w};

  for (int i = threadIdx.x; i < kSideA * kSideA; i += kThreads) {
    const int ly = i / kSideA, lx = i % kSideA;
    s_a[i] = p.inside(ly, lx)
                 ? depth[image + static_cast<size_t>(p.gy0 + ly) * w + p.gx0 + lx]
                 : 0.0f;
  }
  __syncthreads();

  // the three band dilations, far -> medium -> near, each of the original
  // inverted map; s_b at margin 3, -inf outside the image for the dilation
  {
    constexpr int m = 3, n = kSideA - 2 * m;
    for (int i = threadIdx.x; i < n * n; i += kThreads) {
      const int ly = m + i / n, lx = m + i % n;
      float x = -CUDART_INF_F;
      if (p.inside(ly, lx)) {
        x = inverted(s_a[ly * kSideA + lx], max_depth);
        float d = band_cross<1>(p, s_a, ly, lx, 2.0f, CUDART_INF_F, max_depth);
        if (d > kValid) x = d;
        d = band_cross<2>(p, s_a, ly, lx, 1.0f, 2.0f, max_depth);
        if (d > kValid) x = d;
        d = band_cross<3>(p, s_a, ly, lx, kValid, 1.0f, max_depth);
        if (d > kValid) x = d;
      }
      s_b[ly * kSideA + lx] = x;
    }
  }
  __syncthreads();
  // closing: dilation (margin 5, +inf outside for the erosion), erosion
  // (margin 7; the median clamps its window, so the pad is never read)
  window_extreme<kSideA, 5, 2, true>(p, s_b, s_a, CUDART_INF_F);
  __syncthreads();
  window_extreme<kSideA, 7, 2, false>(p, s_a, s_b, 0.0f);
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ly = kHaloA + i / kTile, lx = kHaloA + i % kTile;
    if (!p.inside(ly, lx)) continue;
    const float x = s_b[ly * kSideA + lx];
    const float m = median25(p, s_b, ly, lx);
    out[image + static_cast<size_t>(p.gy0 + ly) * w + p.gx0 + lx] =
        x > kValid ? m : x;
  }
}

// ---------------------------------------------------------------------------
// 2./4. the first valid row of each column (0 for an empty column)
// ---------------------------------------------------------------------------
__global__ void first_valid_row(const float* __restrict__ x, int h, int w,
                                int* __restrict__ first) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;
  const float* image = x + static_cast<size_t>(blockIdx.y) * h * w;
  int row = 0;
  for (int y = 0; y < h; ++y) {
    if (image[static_cast<size_t>(y) * w + col] > kValid) {
      row = y;
      break;
    }
  }
  first[static_cast<size_t>(blockIdx.y) * w + col] = row;
}

// ---------------------------------------------------------------------------
// 3. 9x9 dilation into the pixels that are not valid, under the top mask
// ---------------------------------------------------------------------------
constexpr int kHaloC = 4;
constexpr int kSideC = kTile + 2 * kHaloC;

__global__ void __launch_bounds__(kThreads)
stage_c(const float* __restrict__ x_in, const int* __restrict__ first, int h,
        int w, float* __restrict__ out) {
  __shared__ float s_a[kSideC * kSideC];
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w;
  Plane<kSideC> p{static_cast<int>(blockIdx.y) * kTile - kHaloC,
                  static_cast<int>(blockIdx.x) * kTile - kHaloC, h, w};
  for (int i = threadIdx.x; i < kSideC * kSideC; i += kThreads) {
    const int ly = i / kSideC, lx = i % kSideC;
    s_a[i] = p.inside(ly, lx)
                 ? x_in[image + static_cast<size_t>(p.gy0 + ly) * w + p.gx0 + lx]
                 : -CUDART_INF_F;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ly = kHaloC + i / kTile, lx = kHaloC + i % kTile;
    if (!p.inside(ly, lx)) continue;
    const int gy = p.gy0 + ly, gx = p.gx0 + lx;
    float x = s_a[ly * kSideC + lx];
    const bool top = gy >= first[static_cast<size_t>(blockIdx.z) * w + gx];
    if (!(x > kValid) && top) {
#pragma unroll
      for (int dy = -kHaloC; dy <= kHaloC; ++dy)
#pragma unroll
        for (int dx = -kHaloC; dx <= kHaloC; ++dx)
          x = fmaxf(x, s_a[(ly + dy) * kSideC + lx + dx]);
    }
    out[image + static_cast<size_t>(gy) * w + gx] = x;
  }
}

// ---------------------------------------------------------------------------
// 5. six dilations + median + bilateral + un-invert
// ---------------------------------------------------------------------------
constexpr int kHaloD = 16;
constexpr int kSideD = kTile + 2 * kHaloD;

// one 5x5 dilation into the pixels with x < 0.01 under the top mask, on the
// cells at margin M; -inf outside the image
template <int M>
__device__ void masked_dilate(const Plane<kSideD>& p, const float* src,
                              float* dst, const int* s_first) {
  constexpr int n = kSideD - 2 * M;
  for (int i = threadIdx.x; i < n * n; i += kThreads) {
    const int ly = M + i / n, lx = M + i % n;
    float x = -CUDART_INF_F;
    if (p.inside(ly, lx)) {
      x = src[ly * kSideD + lx];
      if (x < kValid && p.gy0 + ly >= s_first[lx]) {
#pragma unroll
        for (int dy = -2; dy <= 2; ++dy)
#pragma unroll
          for (int dx = -2; dx <= 2; ++dx)
            x = fmaxf(x, src[(ly + dy) * kSideD + lx + dx]);
      }
    }
    dst[ly * kSideD + lx] = x;
  }
}

// reflect-101 of an image coordinate
__device__ __forceinline__ int reflect(int g, int n) {
  return g < 0 ? -g : (g >= n ? 2 * n - 2 - g : g);
}

__global__ void __launch_bounds__(kThreads)
stage_d(const float* __restrict__ x_in, const int* __restrict__ first, int h,
        int w, float max_depth, int bilateral, float* __restrict__ out) {
  __shared__ float s_a[kSideD * kSideD];
  __shared__ float s_b[kSideD * kSideD];
  __shared__ int s_first[kSideD];
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w;
  Plane<kSideD> p{static_cast<int>(blockIdx.y) * kTile - kHaloD,
                  static_cast<int>(blockIdx.x) * kTile - kHaloD, h, w};
  for (int i = threadIdx.x; i < kSideD * kSideD; i += kThreads) {
    const int ly = i / kSideD, lx = i % kSideD;
    s_a[i] = p.inside(ly, lx)
                 ? x_in[image + static_cast<size_t>(p.gy0 + ly) * w + p.gx0 + lx]
                 : -CUDART_INF_F;
  }
  for (int lx = threadIdx.x; lx < kSideD; lx += kThreads) {
    const int gx = p.gx0 + lx;
    s_first[lx] = gx >= 0 && gx < w
                      ? first[static_cast<size_t>(blockIdx.z) * w + gx]
                      : 0;
  }
  __syncthreads();
  masked_dilate<2>(p, s_a, s_b, s_first);
  __syncthreads();
  masked_dilate<4>(p, s_b, s_a, s_first);
  __syncthreads();
  masked_dilate<6>(p, s_a, s_b, s_first);
  __syncthreads();
  masked_dilate<8>(p, s_b, s_a, s_first);
  __syncthreads();
  masked_dilate<10>(p, s_a, s_b, s_first);
  __syncthreads();
  masked_dilate<12>(p, s_b, s_a, s_first);
  __syncthreads();

  // median where valid under the mask: s_a (margin 12) -> s_b (margin 14)
  {
    constexpr int m = 14, n = kSideD - 2 * m;
    for (int i = threadIdx.x; i < n * n; i += kThreads) {
      const int ly = m + i / n, lx = m + i % n;
      if (!p.inside(ly, lx)) continue;
      const float x = s_a[ly * kSideD + lx];
      const bool valid = x > kValid && p.gy0 + ly >= s_first[lx];
      s_b[ly * kSideD + lx] = valid ? median25(p, s_a, ly, lx) : x;
    }
  }
  __syncthreads();

  // bilateral over the 13 taps of the radius-2 disk, row-major, under the
  // median step's mask; exp(-d2 / (2 * sigma_space^2)) for d2 = 0, 1, 2, 4
  const float space[5] = {1.0f, static_cast<float>(0.8824969025845953),
                          static_cast<float>(0.7788007830714049), 0.0f,
                          static_cast<float>(0.6065306597126334)};
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ly = kHaloD + i / kTile, lx = kHaloD + i % kTile;
    if (!p.inside(ly, lx)) continue;
    const int gy = p.gy0 + ly, gx = p.gx0 + lx;
    float x = s_b[ly * kSideD + lx];
    const bool valid = s_a[ly * kSideD + lx] > kValid && gy >= s_first[lx];
    if (bilateral && valid) {
      const float centre = x;
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int dy = -2; dy <= 2; ++dy)
#pragma unroll
        for (int dx = -2; dx <= 2; ++dx) {
          if (dy * dy + dx * dx > 4) continue;
          const int ty = reflect(gy + dy, h) - p.gy0;
          const int tx = reflect(gx + dx, w) - p.gx0;
          const float t = s_b[ty * kSideD + tx];
          const float diff = t - centre;
          // exp(-0.5 * diff^2 / sigma_color^2), sigma_color = 0.5
          const float wgt = space[dy * dy + dx * dx] * expf(-2.0f * (diff * diff));
          num += wgt * t;
          den += wgt;
        }
      x = num / den;
    }
    out[image + static_cast<size_t>(gy) * w + gx] =
        x > kValid ? max_depth - x : x;
  }
}

}  // namespace

// depth (b, h, w) f32 metres, contiguous -> out (b, h, w) f32. tmp0 and tmp1
// are (b, h, w) f32 scratch, first is (b, w) int32 scratch; h, w >= 5.
extern "C" int istnet_depth_fill(const float* depth, int b, int h, int w,
                                 float max_depth, int bilateral, float* tmp0,
                                 float* tmp1, int* first, float* out,
                                 void* stream) {
  if (h < 5 || w < 5) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tiles((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  const dim3 columns((w + 127) / 128, b);
  stage_a<<<tiles, kThreads, 0, s>>>(depth, h, w, max_depth, tmp0);
  first_valid_row<<<columns, 128, 0, s>>>(tmp0, h, w, first);
  stage_c<<<tiles, kThreads, 0, s>>>(tmp0, first, h, w, tmp1);
  first_valid_row<<<columns, 128, 0, s>>>(tmp1, h, w, first);
  stage_d<<<tiles, kThreads, 0, s>>>(tmp1, first, h, w, max_depth, bilateral,
                                     out);
  return static_cast<int>(cudaGetLastError());
}
