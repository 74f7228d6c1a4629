// Fused eval SA-MSG stage for Hopper (sm_90a): ball query + grouping +
// BN-folded SharedMLP + ReLU + max over the slots, per radius, in one call.
//
// Replaces the TPU kernel istnet_tpu/ops/sa_fused_pallas.py:
// _sa_fused_kernel_l1 (and computes the function of its twins
// _sa_fused_kernel and _sa_fused_kernel_t_l1: C = 3 with no features is
// stage 1's form). Per radius with folded layers (W_l bf16, b_l f32):
//   query   the first ns points with d2 < r^2 in index order, padded with
//           the first hit, point 0 when nothing hits (ball_query.cuh, the
//           grouping kernel's query and arithmetic);
//   layer 1 reassociated (sa_fused_pallas.py:200-225): once per POINT,
//           U = bf16(vals @ W1) with vals = [xyz (f32), features (bf16)]
//           and f32 accumulation of exact products; per slot
//           z = f32(U[idx]) - cen @ W1[:3] in f32, h1 = bf16(relu(z + b1));
//   layers  h @ W_l with f32 accumulation of exact bf16 products, + b_l,
//           ReLU, rounded to bf16; for the last layer the max over the
//           slots of the pre-bias sums, then + b_L, ReLU and one rounding
//           (bias and ReLU commute past the max, :245-249). A one-layer MLP
//           takes the max of z itself (:230-239).
// Output per radius (B, M, c_last) bf16.
//
// What bounds it: the MLP FLOPs. Layers 2..L over the 48 slot rows of a
// centroid are ~2.4, ~4.8 and ~9.7 GFLOP at SA stages 2, 3 and 4 (B=32),
// ~0.03 ms together at the card's 989 TFLOP/s in bf16, against outputs of at
// most 2 MB a stage. Design, two launches on one stream:
//   (a) u_kernel: U per radius into a (B, N, c1 padded) bf16 scratch; its
//       feature part feats @ W1[3:] is a tensor-core product too (one thread
//       a (point, channel) with a 259-deep dependent chain took 13-17% of a
//       stage), the three f32 xyz terms join in the epilogue;
//   (b) sa_kernel: persistent blocks, one an SM. The grid is split between
//       the radii in proportion to their work; a block stages its radius's
//       W_2..W_L and biases in shared memory ONCE (row-major [k][n], rows
//       padded by 16 bytes so that ldmatrix meets no bank conflict), then
//       each of its warps walks a strided list of work items of 32 or 64
//       slot rows: two centroids at ns <= 16, one above. A warp does a
//       whole item alone, in its own slice of shared memory, so nothing
//       but __syncwarp orders its steps, and the warps of a block sit in
//       different steps at any time: one warp's query and gather (memory
//       latency) overlap another's products. Per item:
//         query    warp_ball_query into the warp's index list; a centroid's
//                  rows are padded to 16, 32 or 64 with its first hit, like
//                  its empty slots: duplicates leave the max as it is;
//         layer 1  16-byte loads of the U rows (L2-resident), minus
//                  cen @ W1[:3], + b1, ReLU, to bf16 row-major activations
//                  [row][k + 8];
//         layers   mma.sync.m16n8k16 (bf16 operands, f32 accumulators): a
//                  32-row x 64-column accumulator tile a pass, A by ldmatrix
//                  from the activations, B by ldmatrix.trans from the
//                  weights. Not-last epilogue in registers: + b, ReLU,
//                  round, store as the next layer's A. Last: the max over a
//                  centroid's rows inside the fragment (the two row halves
//                  a thread holds, then a halving __shfl_xor butterfly over
//                  the 8 row groups: 7 shuffles for 8 n-tiles, branch-free;
//                  a shuffle chain per value behind a divergent select took
//                  more time than the products), + b_L, ReLU, one rounding,
//                  one store. No atomics: two launches on the same inputs
//                  give the same bits.
// Channel counts are padded to multiples of 16 with zero weights and biases
// (ops/sa_fused.py packs them once per module), so any width takes the
// tensor-core route; a one-layer MLP has no product after U and takes the
// max of z in the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

#include "ball_query.cuh"
#include "mma.cuh"

namespace {

using istnet::kMaxNs;
using istnet::kMaxRadii;

constexpr int kUThreads = 128;
constexpr int kMaxLayers = 4;
constexpr int kMaxWarps = 16;
constexpr int kHalf = 32;    // slot rows of one accumulator pass (2 m16 tiles)
constexpr int kURows = kUThreads / 32 * kHalf;  // points of a u_kernel block
constexpr int kChunk = 64;   // output columns of one accumulator pass
constexpr int kPad = 8;      // bf16 elements (16 bytes) added to every row
constexpr size_t kMaxSmem = 232448;

struct Radius {
  float r2;
  int ns, nsp;        // slots, and the rows a centroid takes: 16, 32 or 64
  int cpw, rows;      // centroids and slot rows of a work item (32 or 64)
  int nlayers;
  int c[kMaxLayers + 1];   // widths: c[0] = 3 + cf, c[l + 1] layer l's output
  int cp[kMaxLayers + 1];  // c[l] rounded up to 16 (cp[0] unused)
  const __nv_bfloat16* w[kMaxLayers];  // (3 + cp(cf), cp[1]), then (cp[l], cp[l + 1])
  const float* b[kMaxLayers];          // (cp[l + 1]), zeros past c[l + 1]
  __nv_bfloat16* u;                     // scratch (B, N, cp[1])
  __nv_bfloat16* out;                   // (B, M, c[nlayers])
  int tiles, items;   // work items an image, and in all
  int block0, blocks; // the blocks of the grid that serve this radius
  int warps;          // warps of a block that take items
  // shared memory, bytes: the biases, the weights of layers 2..L, then per warp
  unsigned w_off[kMaxLayers], b_off[kMaxLayers];
  unsigned warp0, warp_bytes, cw_off, act_off[2];
  int act_stride[2];  // elements
};

struct Params {
  Radius r[kMaxRadii];
  int count;
};

__host__ __device__ inline unsigned align16(unsigned x) { return (x + 15u) & ~15u; }

// acc (32 rows x 8 * ntiles columns) += a (32, k) @ b (k, 8 * ntiles), by one
// warp. a_ptr and b_ptr are the lane's ldmatrix addresses: row (lane % 16)
// of the tile, column 8 * (lane / 16); k is a multiple of 16, ntiles even
// and uniform over the warp. (Double-buffering the fragments by hand, each
// loaded four products ahead of its use, measured the same: the 16
// independent accumulators of a k-step already cover ldmatrix's latency.)
__device__ __forceinline__ void warp_mma_tile(
    float (&acc)[2][kChunk / 8][4], const __nv_bfloat16* __restrict__ a_ptr,
    int a_stride, const __nv_bfloat16* __restrict__ b_ptr, int b_stride, int k,
    int ntiles) {
#pragma unroll 2
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t a[2][4];
    istnet::ldmatrix_x4(a[0], a_ptr + k0);
    istnet::ldmatrix_x4(a[1], a_ptr + 16 * a_stride + k0);
#pragma unroll
    for (int jp = 0; jp < kChunk / 16; ++jp) {
      if (2 * jp < ntiles) {
        uint32_t bf[4];
        istnet::ldmatrix_x4_trans(bf, b_ptr + k0 * b_stride + jp * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          istnet::mma_bf16(acc[mt][2 * jp], a[mt], bf[0], bf[1]);
          istnet::mma_bf16(acc[mt][2 * jp + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[2][kChunk / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// (a) U = bf16(vals @ W1) per radius, vals = [xyz, feats]: a block takes 128
// points and 64 of a radius's layer-1 channels. The feature part feats @
// W1[3:] runs on the tensor cores from shared memory (feats rows and W1
// columns staged with cp.async, zero-filled to cfp); the three xyz terms are
// added in f32 in the epilogue.
__global__ void __launch_bounds__(kUThreads)
u_kernel(const float* __restrict__ xyz, const __nv_bfloat16* __restrict__ feats,
         long long points, int cf, int cfp, const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Radius& R = p.r[blockIdx.z];
  const int c1p = R.cp[1];
  const int n0 = blockIdx.y * kChunk;
  if (n0 >= c1p) return;  // the other radius is wider
  const int ntiles = min(kChunk, c1p - n0) / 8;
  const long long p0 = static_cast<long long>(blockIdx.x) * kURows;
  const int a_stride = cfp + kPad, b_stride = kChunk + kPad;
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);  // (kURows, cfp)
  __nv_bfloat16* s_b = s_a + kURows * a_stride;                  // (3 + cfp, 64)
  const int tid = threadIdx.x;
  if (cf % 8 == 0) {
    const int chunks = cfp / 8;
    for (int q = tid; q < kURows * chunks; q += kUThreads) {
      const int row = q / chunks, ch = q - row * chunks;
      const bool real = p0 + row < points && ch * 8 < cf;
      istnet::cp_async16(s_a + row * a_stride + ch * 8,
                         real ? feats + (p0 + row) * cf + ch * 8 : feats, real ? 16 : 0);
    }
  } else {  // rows that are not 16-byte aligned
    for (int q = tid; q < kURows * cfp; q += kUThreads) {
      const int row = q / cfp, k = q - row * cfp;
      s_a[row * a_stride + k] = (p0 + row < points && k < cf)
                                    ? feats[(p0 + row) * cf + k]
                                    : __float2bfloat16_rn(0.f);
    }
  }
  for (int q = tid; q < (3 + cfp) * ntiles; q += kUThreads) {
    const int row = q / ntiles, ch = q - row * ntiles;
    istnet::cp_async16(s_b + row * b_stride + ch * 8, R.w[0] + row * c1p + n0 + ch * 8);
  }
  istnet::cp_async_commit();
  istnet::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  float acc[2][kChunk / 8][4];
  zero_tile(acc);
  warp_mma_tile(acc, s_a + (warp * kHalf + lrow) * a_stride + lcol, a_stride,
                s_b + (3 + lrow) * b_stride + lcol, b_stride, cfp, ntiles);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long pt = p0 + warp * kHalf + mt * 16 + hr * 8 + g;
      if (pt >= points) continue;
      const float x = xyz[3 * pt], y = xyz[3 * pt + 1], z = xyz[3 * pt + 2];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        if (j < ntiles) {
          const int col = j * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float tt = __fmul_rn(x, __bfloat162float(s_b[col + e]));
            tt = fmaf(y, __bfloat162float(s_b[b_stride + col + e]), tt);
            tt = fmaf(z, __bfloat162float(s_b[2 * b_stride + col + e]), tt);
            v[e] = __fadd_rn(acc[mt][j][2 * hr + e], tt);
          }
          *reinterpret_cast<uint32_t*>(R.u + pt * c1p + n0 + col) =
              istnet::pack_bf16x2(v[0], v[1]);
        }
      }
    }
}

// The max over the 16 rows of an m16 tile, for all 8 n-tiles of a chunk at
// once: v[j] holds the lane's max over its two rows (g, g + 8) of n-tile j,
// one of its two columns. The 8 row groups sit in lanes that differ in bits
// 2..4; a butterfly that halves the values a lane carries at each step (the
// lane keeps the n-tiles whose index bit equals its own lane bit and trades
// the others) takes 4 + 2 + 1 shuffles instead of 8 x 3, has no branch, and
// leaves lane (g, t) with the max of n-tile g.
__device__ __forceinline__ float warp_rows_max(const float (&v)[kChunk / 8]) {
  const int lane = threadIdx.x & 31;
  const bool up4 = lane & 16, up2 = lane & 8, up1 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float got = __shfl_xor_sync(0xffffffffu, up4 ? v[j] : v[j + 4], 16);
    a[j] = fmaxf(up4 ? v[j + 4] : v[j], got);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float got = __shfl_xor_sync(0xffffffffu, up2 ? a[j] : a[j + 2], 8);
    b[j] = fmaxf(up2 ? a[j + 2] : a[j], got);
  }
  const float got = __shfl_xor_sync(0xffffffffu, up1 ? b[0] : b[1], 4);
  return fmaxf(up1 ? b[1] : b[0], got);
}

// One layer of a work item, by one warp: in (rows, k) bf16 row-major in
// shared memory, w (k, n) row-major in shared memory. Not last: out (rows,
// n) = bf16(relu(in @ w + bias)). Last: per centroid the max over its nsp
// rows of in @ w, then + bias, ReLU, rounded, to dst (cpw, cl) in device
// memory, centroid q written only if q < ncen.
template <bool kLast>
__device__ __forceinline__ void warp_layer(
    const __nv_bfloat16* __restrict__ in, int in_stride, int rows,
    const __nv_bfloat16* __restrict__ w, int w_stride,
    const float* __restrict__ bias, int k, int n, __nv_bfloat16* __restrict__ out,
    int out_stride, int nsp, int ncen, int cl, __nv_bfloat16* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  for (int n0 = 0; n0 < n; n0 += kChunk) {
    const int ntiles = min(kChunk, n - n0) / 8;  // even: n is a multiple of 16
    // last layer: lane (g, t) keeps the maxima of n-tile g, per centroid
    float best[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    for (int r0 = 0; r0 < rows; r0 += kHalf) {
      float acc[2][kChunk / 8][4];
      zero_tile(acc);
      warp_mma_tile(acc, in + (r0 + lrow) * in_stride + lcol, in_stride,
                    w + lrow * w_stride + n0 + lcol, w_stride, k, ntiles);
      if (kLast) {
        // the two m16 tiles are two centroids at nsp == 16, else one's rows
        const bool two = nsp == 16;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v[2][kChunk / 8];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < kChunk / 8; ++j) {
              v[mt][j] = fmaxf(acc[mt][j][e], acc[mt][j][e + 2]);
            }
          if (two) {
            best[1][e] = fmaxf(best[1][e], warp_rows_max(v[1]));
          } else {
#pragma unroll
            for (int j = 0; j < kChunk / 8; ++j) v[0][j] = fmaxf(v[0][j], v[1][j]);
          }
          best[0][e] = fmaxf(best[0][e], warp_rows_max(v[0]));
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j) {
            if (j < ntiles) {
              const int col = n0 + j * 8 + 2 * t;
              const float b0 = bias[col], b1 = bias[col + 1];
              const int row = r0 + mt * 16 + g;
              *reinterpret_cast<uint32_t*>(out + row * out_stride + col) =
                  istnet::pack_bf16x2(fmaxf(__fadd_rn(acc[mt][j][0], b0), 0.f),
                                      fmaxf(__fadd_rn(acc[mt][j][1], b1), 0.f));
              *reinterpret_cast<uint32_t*>(out + (row + 8) * out_stride + col) =
                  istnet::pack_bf16x2(fmaxf(__fadd_rn(acc[mt][j][2], b0), 0.f),
                                      fmaxf(__fadd_rn(acc[mt][j][3], b1), 0.f));
            }
          }
      }
    }
    if (kLast) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + g * 8 + 2 * t + e;
          if (g < ntiles && q < ncen && col < cl) {
            dst[q * cl + col] = __float2bfloat16_rn(
                fmaxf(__fadd_rn(best[q][e], bias[col]), 0.f));
          }
        }
    }
  }
}

// (b) query + layer 1 from U + layers 2..L + slot max; see the header
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int n,
          int m, const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ri = (p.count > 1 && static_cast<int>(blockIdx.x) >= p.r[1].block0) ? 1 : 0;
  const Radius& R = p.r[ri];
  const int nl = R.nlayers;
  const int c1p = R.cp[1];

  // stage the biases, and the folded weights of layers 2..L, once a block
  for (int l = 0; l < nl; ++l) {
    float* bd = reinterpret_cast<float*>(smem + R.b_off[l]);
    for (int q = threadIdx.x; q < R.cp[l + 1]; q += blockDim.x) bd[q] = R.b[l][q];
  }
  for (int l = 1; l < nl; ++l) {
    const int chunks = R.cp[l + 1] / 8;            // 16-byte chunks a row
    const int stride = R.cp[l + 1] + kPad;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + R.w_off[l]);
    for (int q = threadIdx.x; q < R.cp[l] * chunks; q += blockDim.x) {
      const int row = q / chunks, ch = q - row * chunks;
      istnet::cp_async16(dst + row * stride + ch * 8, R.w[l] + row * R.cp[l + 1] + ch * 8);
    }
  }
  istnet::cp_async_commit();
  istnet::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= R.warps) return;
  unsigned char* mine = smem + R.warp0 + static_cast<size_t>(warp) * R.warp_bytes;
  int* s_idx = reinterpret_cast<int*>(mine);
  float* s_cw = reinterpret_cast<float*>(mine + R.cw_off);
  __nv_bfloat16* s_act[2] = {reinterpret_cast<__nv_bfloat16*>(mine + R.act_off[0]),
                             reinterpret_cast<__nv_bfloat16*>(mine + R.act_off[1])};
  const float r2[kMaxRadii] = {R.r2, 0.f};
  const int nsa[kMaxRadii] = {R.ns, 0};
  const __nv_bfloat16* w1 = R.w[0];
  const float* b1 = reinterpret_cast<const float*>(smem + R.b_off[0]);
  const int cl = R.c[nl];

  const int first_item = (static_cast<int>(blockIdx.x) - R.block0) * R.warps + warp;
  for (int item = first_item; item < R.items; item += R.blocks * R.warps) {
    const int b = item / R.tiles;
    const int j0 = (item - b * R.tiles) * R.cpw;
    const int ncen = min(R.cpw, m - j0);
    const float* pts = xyz + static_cast<size_t>(b) * n * 3;

    // query: the warp takes its centroids one after the other (a centroid
    // past the end repeats the last one and is not stored)
    for (int q = 0; q < R.cpw; ++q) {
      const float* cen = new_xyz + (static_cast<size_t>(b) * m + min(j0 + q, m - 1)) * 3;
      const float cx = cen[0], cy = cen[1], cz = cen[2];
      int* const idx[kMaxRadii] = {s_idx + q * R.nsp, s_idx + q * R.nsp};
      int cnt[kMaxRadii];
      istnet::warp_ball_query<false>(nullptr, pts, n, cx, cy, cz, r2, nsa, 1, idx, cnt);
      __syncwarp();
      const int hits = min(cnt[0], R.ns);
      const int first = hits > 0 ? idx[0][0] : 0;
      __syncwarp();
      for (int s = hits + lane; s < R.nsp; s += 32) idx[0][s] = first;
      // cen @ W1[:3], per layer-1 channel
      for (int c = lane; c < c1p; c += 32) {
        float cw = __fmul_rn(cx, __bfloat162float(w1[c]));
        cw = fmaf(cy, __bfloat162float(w1[c1p + c]), cw);
        s_cw[q * c1p + c] = fmaf(cz, __bfloat162float(w1[2 * c1p + c]), cw);
      }
    }
    __syncwarp();

    const __nv_bfloat16* u = R.u + static_cast<size_t>(b) * n * c1p;
    __nv_bfloat16* dst = R.out + (static_cast<size_t>(b) * m + j0) * cl;
    if (nl == 1) {
      // one layer: the max of z over the slots, + b1, ReLU
      for (int q = 0; q < ncen; ++q) {
        for (int c = lane; c < cl; c += 32) {
          float best = -INFINITY;
          for (int s = 0; s < R.ns; ++s) {
            const float uv = __bfloat162float(
                u[static_cast<size_t>(s_idx[q * R.nsp + s]) * c1p + c]);
            best = fmaxf(best, __fsub_rn(uv, s_cw[q * c1p + c]));
          }
          dst[q * cl + c] = __float2bfloat16_rn(fmaxf(__fadd_rn(best, b1[c]), 0.f));
        }
      }
      __syncwarp();
      continue;
    }

    // layer 1: gather U rows, 8 channels a load; z = U[idx] - cen @ W1[:3]
    const int chunks = c1p / 8;
    const int stride0 = R.act_stride[0];
    for (int q = lane; q < R.rows * chunks; q += 32) {
      const int row = q / chunks, ch = (q - row * chunks) * 8;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          u + static_cast<size_t>(s_idx[row]) * c1p + ch));
      const float* cw = s_cw + (row / R.nsp) * c1p + ch;
      const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
      uint4 h;
      unsigned* hw = reinterpret_cast<unsigned*>(&h);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z0 = __fsub_rn(__uint_as_float(wd[e] << 16), cw[2 * e]);
        const float z1 = __fsub_rn(__uint_as_float(wd[e] & 0xffff0000u), cw[2 * e + 1]);
        hw[e] = istnet::pack_bf16x2(fmaxf(__fadd_rn(z0, b1[ch + 2 * e]), 0.f),
                                    fmaxf(__fadd_rn(z1, b1[ch + 2 * e + 1]), 0.f));
      }
      *reinterpret_cast<uint4*>(s_act[0] + row * stride0 + ch) = h;
    }
    __syncwarp();

    // layers 2..L on the tensor cores
    for (int l = 1; l < nl; ++l) {
      const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(smem + R.w_off[l]);
      const float* bias = reinterpret_cast<const float*>(smem + R.b_off[l]);
      const int src = (l - 1) & 1;
      if (l + 1 < nl) {
        warp_layer<false>(s_act[src], R.act_stride[src], R.rows, w, R.cp[l + 1] + kPad,
                          bias, R.cp[l], R.cp[l + 1], s_act[src ^ 1],
                          R.act_stride[src ^ 1], R.nsp, ncen, cl, nullptr);
      } else {
        warp_layer<true>(s_act[src], R.act_stride[src], R.rows, w, R.cp[l + 1] + kPad,
                         bias, R.cp[l], R.cp[l + 1], nullptr, 0, R.nsp, ncen, cl, dst);
      }
      __syncwarp();
    }
  }
}

int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 0;
      return 1;
    }
  }
  return sms;
}

}  // namespace

// xyz (b, n, 3) and new_xyz (b, m, 3) f32; feats (b, n, cf) bf16, or null
// when cf == 0; all contiguous. Per radius r < nr: r2[r] = r^2 as f32,
// ns[r] <= 64; chans[r * (nlayers + 1) + l] the MLP widths (chans[.. + 0] =
// 3 + cf). With cp(c) = c rounded up to 16: w[r * nlayers + 0] (3 + cp(cf),
// cp(chans[1])) and w[r * nlayers + l] (cp(chans[l]), cp(chans[l + 1])) bf16,
// bias[r * nlayers + l] (cp(chans[l + 1])) f32, all zero in the padding;
// u[r] a (b, n, cp(chans[1])) bf16 scratch; out[r] (b, m, chans[nlayers])
// bf16.
extern "C" int istnet_sa_fused(const float* xyz, const float* new_xyz,
                               const void* feats, int b, int n, int m, int cf,
                               int nr, const float* r2, const int* ns,
                               int nlayers, const int* chans,
                               const void* const* w, const float* const* bias,
                               void* const* u, void* const* out, void* stream) {
  if (nr < 1 || nr > kMaxRadii || nlayers < 1 || nlayers > kMaxLayers ||
      n < 1 || cf < 0 || (cf > 0 && feats == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.count = nr;
  size_t smem = 0;
  double cost[kMaxRadii] = {0.0, 0.0};
  for (int r = 0; r < nr; ++r) {
    Radius& R = p.r[r];
    const int* ch = chans + r * (nlayers + 1);
    if (ns[r] < 1 || ns[r] > kMaxNs || ch[0] != 3 + cf) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    R.r2 = r2[r];
    R.ns = ns[r];
    R.nsp = ns[r] <= 16 ? 16 : (ns[r] <= 32 ? 32 : 64);
    R.cpw = R.nsp == 16 ? 2 : 1;
    R.rows = R.cpw * R.nsp;
    R.nlayers = nlayers;
    R.c[0] = ch[0];
    R.cp[0] = ch[0];
    for (int l = 0; l < nlayers; ++l) {
      if (ch[l + 1] < 1) return static_cast<int>(cudaErrorInvalidValue);
      R.c[l + 1] = ch[l + 1];
      R.cp[l + 1] = (ch[l + 1] + 15) / 16 * 16;
      R.w[l] = static_cast<const __nv_bfloat16*>(w[r * nlayers + l]);
      R.b[l] = bias[r * nlayers + l];
    }
    R.u = static_cast<__nv_bfloat16*>(u[r]);
    R.out = static_cast<__nv_bfloat16*>(out[r]);
    R.tiles = (m + R.cpw - 1) / R.cpw;
    R.items = b * R.tiles;
    // shared memory: weights and biases once, then a slice a warp
    unsigned o = 0;
    double macs = 0.0;   // multiply-adds a slot row, layers 2..L
    for (int l = 0; l < nlayers; ++l) {
      R.b_off[l] = o;
      o = align16(o + 4u * R.cp[l + 1]);
    }
    for (int l = 1; l < nlayers; ++l) {
      R.w_off[l] = o;
      o = align16(o + 2u * R.cp[l] * (R.cp[l + 1] + kPad));
      macs += static_cast<double>(R.cp[l]) * R.cp[l + 1];
    }
    R.warp0 = o;
    // activations: layer l's output sits in buffer (l - 1) & 1
    int width[2] = {0, 0};
    for (int l = 1; l < nlayers; ++l) {
      width[(l - 1) & 1] = std::max(width[(l - 1) & 1], R.cp[l]);
    }
    unsigned wo = 4u * R.rows;                      // the index list
    R.cw_off = wo;
    wo = align16(wo + 4u * R.cpw * R.cp[1]);
    for (int q = 0; q < 2; ++q) {
      R.act_off[q] = wo;
      R.act_stride[q] = width[q] + kPad;
      if (width[q] > 0) wo = align16(wo + 2u * R.rows * R.act_stride[q]);
    }
    R.warp_bytes = wo;
    if (kMaxSmem < R.warp0 + static_cast<size_t>(R.warp_bytes)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    R.warps = static_cast<int>(
        std::min<size_t>(kMaxWarps, (kMaxSmem - R.warp0) / R.warp_bytes));
    smem = std::max<size_t>(smem, R.warp0 + static_cast<size_t>(R.warps) * R.warp_bytes);
    // a row's share of the query (n distance tests a centroid) and of the
    // gather, beside its multiply-adds at the tensor cores' rate
    cost[r] = static_cast<double>(R.items) *
              (R.rows * (macs / 64.0 + 2.0 * R.cp[1]) + 4.0 * R.cpw * n);
  }
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long points = static_cast<long long>(b) * n;
  int c1max = 0;
  for (int r = 0; r < nr; ++r) c1max = std::max(c1max, p.r[r].cp[1]);
  const int cfp = (cf + 15) / 16 * 16;
  const size_t usmem = 2u * (static_cast<size_t>(kURows) * (cfp + kPad) +
                             static_cast<size_t>(3 + cfp) * (kChunk + kPad));
  if (usmem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(u_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(usmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 ugrid(static_cast<unsigned>((points + kURows - 1) / kURows),
                   (c1max + kChunk - 1) / kChunk, nr);
  u_kernel<<<ugrid, kUThreads, usmem, s>>>(xyz, static_cast<const __nv_bfloat16*>(feats),
                                           points, cf, cfp, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // one block an SM, split between the radii by their work
  const int sms = device_sms();
  int want[kMaxRadii] = {0, 0}, total = 0;
  for (int r = 0; r < nr; ++r) {
    want[r] = (p.r[r].items + p.r[r].warps - 1) / p.r[r].warps;
    total += want[r];
  }
  const int grid = std::max(nr, std::min(sms, total));
  int next = 0;
  for (int r = 0; r < nr; ++r) {
    Radius& R = p.r[r];
    int share = grid;
    if (nr == 2) {
      const int first = static_cast<int>(std::lround(grid * cost[0] / (cost[0] + cost[1])));
      const int mine = r == 0 ? first : grid - first;
      share = std::max(1, std::min(grid - 1, mine));
    }
    R.block0 = next;
    R.blocks = std::min(share, want[r]);
    next += R.blocks;
  }
  e = cudaFuncSetAttribute(sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  sa_kernel<<<next, kMaxWarps * 32, smem, s>>>(xyz, new_xyz, n, m, p);
  return static_cast<int>(cudaGetLastError());
}
