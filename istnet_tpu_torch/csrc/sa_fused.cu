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
// against outputs of at most 2 MB a stage; the plain composition instead
// writes the grouped rows and every activation to device memory. Layer 1
// costs 2 * B * N * C * c1 (once per point) instead of B * M * ns * C * c1.
// Design, two stages on one stream:
//   (a) u_kernel: U per radius into a (B, N, c1) bf16 scratch, one thread
//       per (point, channel);
//   (b) sa_kernel: one block per (centroid tile, image, radius). Each warp
//       queries one centroid at a time; the block stages the folded
//       W_2..W_L in shared memory (bf16), gathers the U rows of its slots
//       into the layer-1 activations (channel-major, rows = tile x slots),
//       and runs each later layer from shared memory with a 4-row x
//       8-column register tile a thread, on the CUDA cores in f32. The
//       last layer's slot max goes through shared-memory atomics on
//       order-preserving integer keys, then + b_L, ReLU and the store.
// The TPU kernel's one-hot extraction dots, bf16 hi/mid/lo splits,
// triangular-matmul cumsums and the transposed twin were Mosaic's; a direct
// indexed load is exact here. Tensor cores (mma/wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "ball_query.cuh"

namespace {

using istnet::kMaxNs;
using istnet::kMaxRadii;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
constexpr int kRowTile = 4, kColTile = 8;
constexpr int kMaxRows = 128;   // slot rows (centroids x ns) a block holds
constexpr int kMaxTile = 32;    // centroids a block holds
constexpr size_t kMaxSmem = 232448;

struct Radius {
  float r2;
  int ns, tm, nlayers, rstride, kmax;
  int cin[kMaxLayers], cout[kMaxLayers], cpad[kMaxLayers];
  const __nv_bfloat16* w[kMaxLayers];  // (cin, cpad), zero columns past cout
  const float* b[kMaxLayers];          // (cout)
  __nv_bfloat16* u;                     // scratch (B, N, cout[0])
  __nv_bfloat16* out;                   // (B, M, cout[nlayers - 1])
  unsigned smem;                        // dynamic shared memory of sa_kernel
};

struct Params {
  Radius r[kMaxRadii];
  int count;
};

__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// order-preserving int key of a float (not NaN): key(a) < key(b) iff a < b
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the shared-memory sections of sa_kernel.
struct Layout {
  size_t idx, cen, cw, red, w[kMaxLayers], act0, act1, total;
};

__host__ __device__ inline Layout layout(const Radius& R) {
  Layout L{};
  size_t o = 0;
  L.idx = o; o = align16(o + sizeof(int) * R.tm * R.ns);
  L.cen = o; o = align16(o + sizeof(float) * R.tm * 3);
  L.cw = o; o = align16(o + sizeof(float) * R.tm * R.cout[0]);
  L.red = o; o = align16(o + sizeof(int) * R.tm * R.cout[R.nlayers - 1]);
  for (int l = 1; l < R.nlayers; ++l) {
    L.w[l] = o;
    o = align16(o + sizeof(__nv_bfloat16) * R.cin[l] * R.cpad[l]);
  }
  const size_t act = sizeof(__nv_bfloat16) * R.kmax * R.rstride;
  L.act0 = o; o = align16(o + act);
  L.act1 = o; o = align16(o + act);
  L.total = o;
  return L;
}

// (a) U = bf16(vals @ W1) per radius; vals = [xyz, feats]
__global__ void __launch_bounds__(kThreads)
u_kernel(const float* __restrict__ xyz, const __nv_bfloat16* __restrict__ feats,
         long long points, int cf, const __grid_constant__ Params p) {
  const Radius& R = p.r[blockIdx.y];
  const int c1 = R.cout[0];
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= points * c1) return;
  const long long pt = e / c1;
  const int o = static_cast<int>(e - pt * c1);
  const __nv_bfloat16* w = R.w[0] + o;
  const int ws = R.cpad[0];
  float acc = __fmul_rn(xyz[3 * pt], __bfloat162float(w[0]));
  acc = fmaf(xyz[3 * pt + 1], __bfloat162float(w[ws]), acc);
  acc = fmaf(xyz[3 * pt + 2], __bfloat162float(w[2 * ws]), acc);
  const __nv_bfloat16* f = feats + pt * cf;
  for (int k = 0; k < cf; ++k) {
    acc = fmaf(__bfloat162float(f[k]), __bfloat162float(w[(3 + k) * ws]), acc);
  }
  R.u[pt * c1 + o] = __float2bfloat16_rn(acc);
}

// One layer of `rows` slot rows from channel-major bf16 activations `in`
// (cin, rstride) and weights w (cin, cpad) in shared memory. Not last:
// out (cout, rstride) = bf16(relu(in^T w + b)). Last: the per-centroid max
// of in^T w into the keys red (tile, cout).
template <bool kLast>
__device__ __forceinline__ void mlp_layer(
    const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, int rows, int ns, int rstride, int cin,
    int cout, int cpad, __nv_bfloat16* __restrict__ out, int* __restrict__ red) {
  const int nct = cpad / kColTile;
  const int tiles = (rows + kRowTile - 1) / kRowTile * nct;
  for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
    const int r0 = (tile / nct) * kRowTile;
    const int c0 = (tile % nct) * kColTile;
    float acc[kRowTile][kColTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i)
#pragma unroll
      for (int j = 0; j < kColTile; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < cin; ++k) {
      const uint2 hv = *reinterpret_cast<const uint2*>(in + k * rstride + r0);
      const uint4 wv = *reinterpret_cast<const uint4*>(w + k * cpad + c0);
      const float h[kRowTile] = {bf_lo(hv.x), bf_hi(hv.x), bf_lo(hv.y), bf_hi(hv.y)};
      const float wf[kColTile] = {bf_lo(wv.x), bf_hi(wv.x), bf_lo(wv.y), bf_hi(wv.y),
                                  bf_lo(wv.z), bf_hi(wv.z), bf_lo(wv.w), bf_hi(wv.w)};
#pragma unroll
      for (int i = 0; i < kRowTile; ++i)
#pragma unroll
        for (int j = 0; j < kColTile; ++j) acc[i][j] = fmaf(h[i], wf[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < kColTile; ++j) {
      const int c = c0 + j;
      if (c >= cout) break;
      if (kLast) {
        // max over the rows of one centroid in registers, then one atomic
        int t = r0 / ns;
        float best = acc[0][j];
#pragma unroll
        for (int i = 1; i < kRowTile; ++i) {
          const int row = r0 + i;
          if (row >= rows) break;
          if (row / ns != t) {
            atomicMax(red + t * cout + c, float_key(best));
            t = row / ns;
            best = acc[i][j];
          } else {
            best = fmaxf(best, acc[i][j]);
          }
        }
        atomicMax(red + t * cout + c, float_key(best));
      } else {
        const float bc = bias[c];
#pragma unroll
        for (int i = 0; i < kRowTile; ++i) {
          const int row = r0 + i;
          if (row < rows) {
            out[c * rstride + row] = __float2bfloat16_rn(fmaxf(__fadd_rn(acc[i][j], bc), 0.f));
          }
        }
      }
    }
  }
}

// (b) query + layer 1 from U + layers 2..L + slot max, one centroid tile
__global__ void __launch_bounds__(kThreads)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int n,
          int m, const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Radius& R = p.r[blockIdx.z];
  const int tm = R.tm, ns = R.ns;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * tm;
  if (j0 >= m) return;  // the other radius has more tiles
  const int nt = min(tm, m - j0);
  const int rows = nt * ns;
  const int nl = R.nlayers;
  const int c1 = R.cout[0];
  const int cl = R.cout[nl - 1];
  const Layout L = layout(R);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  float* s_cen = reinterpret_cast<float*>(smem + L.cen);
  float* s_cw = reinterpret_cast<float*>(smem + L.cw);
  int* s_red = reinterpret_cast<int*>(smem + L.red);
  __nv_bfloat16* s_act[2] = {reinterpret_cast<__nv_bfloat16*>(smem + L.act0),
                             reinterpret_cast<__nv_bfloat16*>(smem + L.act1)};

  // stage the folded weights of layers 2..L
  for (int l = 1; l < nl; ++l) {
    const uint4* src = reinterpret_cast<const uint4*>(R.w[l]);
    uint4* dst = reinterpret_cast<uint4*>(smem + L.w[l]);
    const int words = R.cin[l] * R.cpad[l] / 8;
    for (int q = threadIdx.x; q < words; q += kThreads) dst[q] = src[q];
  }
  for (int q = threadIdx.x; q < nt * cl; q += kThreads) s_red[q] = float_key(-INFINITY);

  // query: one warp per centroid
  const int lane = threadIdx.x & 31;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float r2[kMaxRadii] = {R.r2, 0.f};
  const int nsa[kMaxRadii] = {ns, 0};
  for (int t = threadIdx.x >> 5; t < nt; t += kWarps) {
    const float* cen = new_xyz + (static_cast<size_t>(b) * m + j0 + t) * 3;
    const float cx = cen[0], cy = cen[1], cz = cen[2];
    int* const idx[kMaxRadii] = {s_idx + t * ns, s_idx + t * ns};
    int cnt[kMaxRadii];
    istnet::warp_ball_query(pts, n, cx, cy, cz, r2, nsa, 1, idx, cnt);
    __syncwarp();
    const int hits = min(cnt[0], ns);
    const int first = hits > 0 ? idx[0][0] : 0;
    __syncwarp();
    for (int s = hits + lane; s < ns; s += 32) idx[0][s] = first;
    if (lane < 3) s_cen[t * 3 + lane] = lane == 0 ? cx : (lane == 1 ? cy : cz);
  }
  __syncthreads();

  // cen @ W1[:3], per centroid and layer-1 channel
  const __nv_bfloat16* w1 = R.w[0];
  const int ws = R.cpad[0];
  for (int q = threadIdx.x; q < nt * c1; q += kThreads) {
    const int t = q / c1, c = q - t * c1;
    float cw = __fmul_rn(s_cen[3 * t], __bfloat162float(w1[c]));
    cw = fmaf(s_cen[3 * t + 1], __bfloat162float(w1[ws + c]), cw);
    s_cw[q] = fmaf(s_cen[3 * t + 2], __bfloat162float(w1[2 * ws + c]), cw);
  }
  __syncthreads();

  // layer 1: gather U rows; z = U[idx] - cen @ W1[:3]
  const __nv_bfloat16* u = R.u + static_cast<size_t>(b) * n * c1;
  const float* b1 = R.b[0];
  for (int q = threadIdx.x; q < rows * c1; q += kThreads) {
    const int row = q / c1, c = q - row * c1;
    const int t = row / ns;
    const float z = __fsub_rn(__bfloat162float(u[static_cast<size_t>(s_idx[row]) * c1 + c]),
                              s_cw[t * c1 + c]);
    if (nl == 1) {
      atomicMax(s_red + t * cl + c, float_key(z));
    } else {
      s_act[0][c * R.rstride + row] = __float2bfloat16_rn(fmaxf(__fadd_rn(z, b1[c]), 0.f));
    }
  }
  __syncthreads();

  // layers 2..L
  for (int l = 1; l < nl; ++l) {
    const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(smem + L.w[l]);
    if (l + 1 < nl) {
      mlp_layer<false>(s_act[(l - 1) & 1], w, R.b[l], rows, ns, R.rstride, R.cin[l],
                       R.cout[l], R.cpad[l], s_act[l & 1], nullptr);
    } else {
      mlp_layer<true>(s_act[(l - 1) & 1], w, nullptr, rows, ns, R.rstride, R.cin[l],
                      R.cout[l], R.cpad[l], nullptr, s_red);
    }
    __syncthreads();
  }

  // + b_L, ReLU, one rounding
  const float* bl = R.b[nl - 1];
  __nv_bfloat16* o = R.out + (static_cast<size_t>(b) * m + j0) * cl;
  for (int q = threadIdx.x; q < nt * cl; q += kThreads) {
    const int c = q % cl;
    o[q] = __float2bfloat16_rn(fmaxf(__fadd_rn(key_float(s_red[q]), bl[c]), 0.f));
  }
}

}  // namespace

// xyz (b, n, 3) and new_xyz (b, m, 3) f32; feats (b, n, cf) bf16, or null
// when cf == 0; all contiguous. Per radius r < nr: r2[r] = r^2 as f32,
// ns[r] <= 64; chans[r * (nlayers + 1) + l] the MLP widths (chans[.. + 0] =
// 3 + cf); w[r * nlayers + l] (chans[l], cpad) bf16 with cpad = chans[l + 1]
// rounded up to a multiple of 8 (zero columns), bias[r * nlayers + l]
// (chans[l + 1]) f32; u[r] a (b, n, chans[1]) bf16 scratch; out[r]
// (b, m, chans[nlayers]) bf16.
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
  int tiles = 0;
  for (int r = 0; r < nr; ++r) {
    Radius& R = p.r[r];
    const int* ch = chans + r * (nlayers + 1);
    if (ns[r] < 1 || ns[r] > kMaxNs || ch[0] != 3 + cf) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    R.r2 = r2[r];
    R.ns = ns[r];
    R.nlayers = nlayers;
    R.kmax = 1;
    for (int l = 0; l < nlayers; ++l) {
      if (ch[l + 1] < 1) return static_cast<int>(cudaErrorInvalidValue);
      R.cin[l] = ch[l];
      R.cout[l] = ch[l + 1];
      R.cpad[l] = (ch[l + 1] + kColTile - 1) / kColTile * kColTile;
      R.w[l] = static_cast<const __nv_bfloat16*>(w[r * nlayers + l]);
      R.b[l] = bias[r * nlayers + l];
      if (l > 0 && ch[l] > R.kmax) R.kmax = ch[l];
    }
    R.u = static_cast<__nv_bfloat16*>(u[r]);
    R.out = static_cast<__nv_bfloat16*>(out[r]);
    // the largest centroid tile whose slot rows and shared memory fit
    R.tm = std::min(kMaxTile, std::max(1, kMaxRows / R.ns));
    for (;;) {
      R.rstride = (R.tm * R.ns + kRowTile - 1) / kRowTile * kRowTile + kRowTile;
      R.smem = static_cast<unsigned>(layout(R).total);
      if (R.smem <= kMaxSmem || R.tm == 1) break;
      R.tm /= 2;
    }
    if (R.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
    smem = std::max<size_t>(smem, R.smem);
    tiles = std::max(tiles, (m + R.tm - 1) / R.tm);
  }
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long points = static_cast<long long>(b) * n;
  int c1max = 0;
  for (int r = 0; r < nr; ++r) c1max = std::max(c1max, p.r[r].cout[0]);
  const dim3 ugrid(static_cast<unsigned>((points * c1max + kThreads - 1) / kThreads), nr);
  u_kernel<<<ugrid, kThreads, 0, s>>>(xyz, static_cast<const __nv_bfloat16*>(feats),
                                      points, cf, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  e = cudaFuncSetAttribute(sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles, b, nr);
  sa_kernel<<<grid, kThreads, smem, s>>>(xyz, new_xyz, n, m, p);
  return static_cast<int>(cudaGetLastError());
}
