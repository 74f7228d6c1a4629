// Fold-upsample conv for Hopper (sm_90a): conv3x3(pad 1) of the x2
// align-corners bilinear upsampling of x, plus bias, with an optional
// eval-BatchNorm + PReLU epilogue.
//
// Replaces the TPU kernel istnet_tpu/ops/fold_upsample_pallas.py:_kernel
// (PSPUpsample's up_2 at eval: (B, 48, 48, 256) -> (B, 96, 96, 64)).
// Epilogue rows ep (5, cout) = [mean, invstd, scale, bias, alpha], applied
// in the order of fold_upsample_pallas.py:96-107: y = conv + b;
// t = (y - mean) * invstd; t = t * scale + bias; out = t >= 0 ? t : alpha*t.
//
// Like the TPU kernel (and the plain version, nn/layers.py:
// conv3x3_on_doubled), it reassociates by linearity: the channel
// contraction runs once per LOW-resolution pixel and tap, and the x2
// interpolation is applied after it. Two stages on one stream:
//   1. y (B*h*w, 9*coutp) = x (B*h*w, cin) @ km (Kp, Np), km[ci, (3 dy + dx)
//      * coutp + c] = k[dy, dx, ci, c], zero-padded by the wrapper (coutp =
//      cout rounded up to 8, Np to the 192-column block tile, Kp to 32 in
//      f32 and to 64 in bf16, where km comes transposed, (Np, Kp));
//   2. out[b, i, j, c] = bias[c] + sum over taps (dy, dx) of the
//      align-corners lerp of y[b, :, :, dy, dx, c] at doubled-map position
//      (i + dy - 1, j + dx - 1), zero outside [0, 2h) x [0, 2w) (the conv's
//      zero padding); then the epilogue.
// The interpolation taps (lo, hi, w_lo, w_hi per output row and column)
// come from the host, built from the same f64 matrix as the plain version.
//
// What bounds it: the GEMM, 2 * B*h*w * cin * 9*cout = 21.7 GFLOP at B=32.
//   bf16: 0.022 ms at the tensor cores' 989 TFLOP/s, so device memory sets
//   the floor: x in and out out (0.023 ms), and while y goes through device
//   memory its 85 MB twice more. Stage 1 is a wgmma GEMM: 128 x 96 block
//   tiles (576 = 6 x 96), two warpgroups of 64 rows each issuing
//   wgmma.mma_async.m64n96k16 (f32 accumulators in registers) on operand
//   tiles that sit K-major in shared memory in the 128-byte swizzle, read by
//   the tensor cores through descriptors; k-slabs of 64 in a 4-deep cp.async
//   ring, the slab two behind refilled while the next runs; the result
//   rounded to bf16 once, staged through shared memory and stored as 16-byte
//   rows. Two blocks share an SM (113 KB each) and cover one another's
//   prologue and store.
//   f32: 0.32 ms at the CUDA cores' 67 TFLOP/s; the f32 policy takes no
//   tensor core (TF32 would change answers). Stage 1 is a 128 x 192 x 16
//   tile, 8 x 12 outputs a thread, in a 3-deep cp.async ring without a
//   conversion pass: A is read as float4 along k (one address a quarter
//   warp), B as float4 along n. Its inner loop is 93% FFMA, yet it runs at
//   53% of peak whatever the tile (128 x 96, 64 x 192, 8 x 8, 16 x 4 or 4 x 12
//   a thread, one to four blocks an SM all take 0.59-0.67 ms): a warp's
//   16-byte shared-memory load occupies the SM's 128-byte/clock path for 4
//   clocks even when it broadcasts, so a TM x TN thread tile needs 4 (TM +
//   TN) of those clocks for TM * TN FFMA clocks, 0.83 at 8 x 12: the loads
//   and the arithmetic are limited together.
// Stage 2 (both types) is separable, through shared memory: a block owns 8 x
// 16 output pixels; their taps read a patch of at most 6 x 10 low-resolution
// pixels. The block walks the channels a chunk of two 16-byte vectors (8
// floats, 16 bf16) at a time: the chunk's slice of the patch (9 taps a
// pixel) comes in by cp.async one chunk ahead, so every row of y is read
// once a tile (reading it per output row pair asked L2 for 2.7x the bytes);
// the row pass forms t[i][x][dx] = sum over dy of the row lerp, the column
// pass sums the three dx taps, adds the bias, applies the epilogue (its rows
// staged once a block) and stores 16 bytes a thread. What bounds it now:
// index arithmetic and tap lookups around few FMAs, which is why a thread
// works out the addresses of its loads once and not in every chunk.
//
// bf16 rounds where the plain bf16 fold rounds: the GEMM output y (stored
// bf16), the row-interpolated map t, the column-interpolated output, and
// the bias add; then the epilogue runs in f32, rounds to bf16, and PReLU
// multiplies by the bf16 slope with one more rounding
// (fold_upsample_pallas.py:96-107). The interpolation weights come in
// rounded to bf16, as the plain version casts its matrices to x.dtype
// (w_lo + w_hi != 1 in general).
// Keeping y on chip (one kernel: the y tile of a 16 x 32 output tile's
// patch by wgmma into shared memory 8 channels at a time, both passes by
// mma.sync against the tile's interpolation matrices) measured slower than
// these two stages (0.222-0.237 ms against 0.209 for the fold at B=32): with
// y held 8 channels at a time the passes become short dependent chains
// between barriers, and the patch's halo costs the GEMM 1.5x the products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBM = 128;
constexpr int kBN16 = 96, kBN32 = 192;  // block-tile columns, bf16 and f32
constexpr int kGemmThreads = 256;

// ---- stage 1, bf16: C (m, ncols) = A (m, lda) @ B^T, B (np, kp), by wgmma ----
constexpr int kBK16 = 64, kStages16 = 4;
constexpr int kATile16 = kBM * kBK16;     // bf16 elements: 128 rows of 128 bytes
constexpr int kBTile16 = kBN16 * kBK16;   // 96 rows of 128 bytes
constexpr int kStageElems16 = kATile16 + kBTile16;
constexpr int kCStride16 = kBN16 + 8;     // the C tile's rows, padded by 16 bytes
// the ring, and 1024 bytes to align it to the swizzle's 8-row groups; two
// blocks an SM
constexpr int kGemmSmem16 = kStages16 * kStageElems16 * 2 + 1024;
static_assert(kATile16 * 2 % 1024 == 0 && kStageElems16 * 2 % 1024 == 0,
              "every operand tile starts on a 1024-byte boundary");
static_assert(kBM * kCStride16 <= kStages16 * kStageElems16, "the C tile reuses the ring");
static_assert(kBN32 % kBN16 == 0, "one column padding serves both GEMMs");

__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                 __nv_bfloat16* __restrict__ c, int m, int lda, int kp, int ncols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (istnet::smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN16;
  const int nk = kp / kBK16;

  // a k-slab of A (128 x 64) and of B (96 x 64), both K-major and swizzled
  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* sa = smem + stage * kStageElems16;
    __nv_bfloat16* sb = sa + kATile16;
    const int k0 = kt * kBK16;
#pragma unroll
    for (int q = tid; q < kBM * 8; q += kGemmThreads) {
      const int r = q >> 3, ch = q & 7;
      const bool real = row0 + r < m && k0 + ch * 8 < lda;
      istnet::cp_async16(sa + r * kBK16 + istnet::swizzled_chunk(r, ch) * 8,
                         real ? a + static_cast<size_t>(row0 + r) * lda + k0 + ch * 8 : a,
                         real ? 16 : 0);
    }
#pragma unroll
    for (int q = tid; q < kBN16 * 8; q += kGemmThreads) {
      const int r = q >> 3, ch = q & 7;
      istnet::cp_async16(sb + r * kBK16 + istnet::swizzled_chunk(r, ch) * 8,
                         b + static_cast<size_t>(col0 + r) * kp + k0 + ch * 8);
    }
  };

  float acc[48];
#pragma unroll
  for (int e = 0; e < 48; ++e) acc[e] = 0.f;

  // one cp.async group a slab: the ring's kStages16 slabs first, then, in
  // iteration kt, slab kt - 2 + kStages16 into the buffer of slab kt - 2
  for (int s = 0; s < kStages16; ++s) {
    if (s < nk) load_stage(s, s);
    istnet::cp_async_commit();
  }
  const int wg = warp >> 2;  // the warpgroup's 64 rows of the tile
  for (int kt = 0; kt < nk; ++kt) {
    if (kt < kStages16) {
      istnet::cp_async_wait<kStages16 - 1>();
    } else {
      istnet::cp_async_wait<kStages16 - 3>();
    }
    istnet::fence_proxy_async();
    __syncthreads();  // slab kt has landed; every warp's products of slab kt - 2 are done
    if (kt >= 2 && kt - 2 + kStages16 < nk) {
      load_stage((kt - 2) % kStages16, kt - 2 + kStages16);
    }
    istnet::cp_async_commit();
    const __nv_bfloat16* sa = smem + (kt % kStages16) * kStageElems16 + wg * 64 * kBK16;
    const __nv_bfloat16* sb = smem + (kt % kStages16) * kStageElems16 + kATile16;
    istnet::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      istnet::wgmma_m64n96k16(acc, istnet::wgmma_desc(sa + kk), istnet::wgmma_desc(sb + kk));
    }
    istnet::wgmma_commit();
    istnet::wgmma_wait<1>();  // slab kt - 1's products are done in this warp
  }
  istnet::wgmma_wait<0>();
  istnet::cp_async_wait<0>();
  __syncthreads();

  // round once, stage the tile in shared memory, store 16-byte row pieces
  const int g = lane >> 2, t = lane & 3;
  const int r = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN16 / 8; ++j) {
    const int cc = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(smem + r * kCStride16 + cc) =
        istnet::pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(smem + (r + 8) * kCStride16 + cc) =
        istnet::pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int q = tid; q < kBM * (kBN16 / 8); q += kGemmThreads) {
    const int rr = q / (kBN16 / 8), ch = (q % (kBN16 / 8)) * 8;
    if (row0 + rr < m && col0 + ch < ncols) {
      *reinterpret_cast<uint4*>(c + static_cast<size_t>(row0 + rr) * ncols + col0 + ch) =
          *reinterpret_cast<const uint4*>(smem + rr * kCStride16 + ch);
    }
  }
}

// ---- stage 1, f32: the same product on the CUDA cores, full float32 --------
constexpr int kBK32 = 16, kStages32 = 3;
constexpr int kAStride32 = kBK32 + 4;   // floats a row of the A tile
constexpr int kStageElems32 = kBM * kAStride32 + kBK32 * kBN32;
constexpr int kGemmSmem32 = kStages32 * kStageElems32 * 4;  // 67,584 bytes
constexpr int kTM = 8, kTN = 12;        // outputs a thread: 16 x 16 threads

__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m, int lda, int kp, int np, int ncols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN32;
  const int tr = tid / 16, tc = tid % 16;  // rows tr * 8 + i; columns 64 j + 4 tc + q
  const int nk = kp / kBK32;

  auto load_stage = [&](int stage, int kt) {
    float* sa = smem + stage * kStageElems32;
    float* sb = sa + kBM * kAStride32;
    const int k0 = kt * kBK32;
#pragma unroll
    for (int q = tid; q < kBM * (kBK32 / 4); q += kGemmThreads) {
      const int r = q / (kBK32 / 4), ch = (q % (kBK32 / 4)) * 4;
      const bool real = row0 + r < m && k0 + ch < lda;
      istnet::cp_async16(sa + r * kAStride32 + ch,
                         real ? a + static_cast<size_t>(row0 + r) * lda + k0 + ch : a,
                         real ? 16 : 0);
    }
#pragma unroll
    for (int q = tid; q < kBK32 * (kBN32 / 4); q += kGemmThreads) {
      const int r = q / (kBN32 / 4), ch = (q % (kBN32 / 4)) * 4;
      istnet::cp_async16(sb + r * kBN32 + ch, b + static_cast<size_t>(k0 + r) * np + col0 + ch);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kStages32 - 1; ++s) {
    if (s < nk) load_stage(s, s);
    istnet::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    istnet::cp_async_wait<kStages32 - 2>();
    __syncthreads();
    if (kt + kStages32 - 1 < nk) {
      load_stage((kt + kStages32 - 1) % kStages32, kt + kStages32 - 1);
    }
    istnet::cp_async_commit();
    const float* sa = smem + (kt % kStages32) * kStageElems32;
    const float* sb = sa + kBM * kAStride32;
#pragma unroll
    for (int kk = 0; kk < kBK32; kk += 4) {
      float av[kTM][4];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(sa + (tr * kTM + i) * kAStride32 + kk);
        av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
      }
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        float bv[kTN];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(sb + (kk + k4) * kBN32 + j * 64 + tc * 4);
          bv[4 * j] = v.x; bv[4 * j + 1] = v.y; bv[4 * j + 2] = v.z; bv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i][k4], bv[j], acc[i][j]);
      }
    }
  }
  istnet::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + tr * kTM + i;
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int cc = col0 + j * 64 + tc * 4;
      if (cc < ncols) {  // ncols is a multiple of 8: the float4 is whole
        *reinterpret_cast<float4*>(c + static_cast<size_t>(r) * ncols + cc) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
      }
    }
  }
}

// ---- stage 2: separable interpolation of the 9 tap planes, bias, epilogue --
constexpr int kTH = 8, kTW = 16;        // output pixels of a block
constexpr int kLH = kTH / 2 + 2;        // low-resolution rows it can need
constexpr int kLW = kTW / 2 + 2;        // and columns
constexpr int kCV = 2;                  // 16-byte vectors of channels a chunk
constexpr int kInterpThreads = 256;
static_assert(kInterpThreads % kCV == 0, "a thread keeps its vector over its items");

struct Taps {
  const int* lo;   // (2 * out): lo[o], then hi[o]
  const float* w;  // (2 * out): w_lo[o], then w_hi[o]
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float scalar(float v) { return v; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[8]) {
    return make_uint4(istnet::pack_bf16x2(v[0], v[1]), istnet::pack_bf16x2(v[2], v[3]),
                      istnet::pack_bf16x2(v[4], v[5]), istnet::pack_bf16x2(v[6], v[7]));
  }
  static __device__ __forceinline__ float round(float v) { return round_bf16(v); }
  static __device__ __forceinline__ __nv_bfloat16 scalar(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// y (b, h, w, 9, coutp); out (b, 2h, 2w, cout). The block walks the channels
// a chunk of kCV vectors at a time: the chunk's slice of the tile's patch of
// y comes in by cp.async one chunk ahead of its use.
template <typename T>
__global__ void __launch_bounds__(kInterpThreads)
interp_kernel(const T* __restrict__ y, const T* __restrict__ bias,
              const float* __restrict__ ep, Taps ty, Taps tx, int h, int w, int cout,
              int coutp, T* __restrict__ out) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int kN = V::kN;
  constexpr int kCC = kCV * kN;                  // channels a chunk
  constexpr int kSlab = kLH * kLW * 9 * kCC;     // elements of y a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_y = reinterpret_cast<T*>(smem_raw);       // 2 x (kLH, kLW, 9, kCC)
  T* s_t = s_y + 2 * kSlab;                      // (kTH, kLW, 3, kCC)
  // (6, coutp): the bias, then the epilogue rows, as float32
  float* s_ep = reinterpret_cast<float*>(s_t + kTH * kLW * 3 * kCC);
  __shared__ float s_wy[(kTH + 2) * 2], s_wx[(kTW + 2) * 2];
  __shared__ int s_ry[(kTH + 2) * 2], s_cx[(kTW + 2) * 2];
  const int h2 = 2 * h, w2 = 2 * w;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  // the patch: the low-resolution rows and columns that the taps of doubled-map
  // rows i0 - 1 .. i0 + kTH and columns j0 - 1 .. j0 + kTW read
  const int r0 = ty.lo[max(i0 - 1, 0)];
  const int lh = min(ty.lo[h2 + min(i0 + kTH, h2 - 1)] - r0 + 1, kLH);
  const int x0 = tx.lo[max(j0 - 1, 0)];
  const int lw = min(tx.lo[w2 + min(j0 + kTW, w2 - 1)] - x0 + 1, kLW);
  // the tile's taps, once, relative to the patch; weight 0 outside the doubled
  // map (the conv's zero padding)
  for (int q = tid; q < (kTH + 2) * 2; q += kInterpThreads) {
    const int r = i0 - 1 + q / 2, side = q % 2;
    const bool in = r >= 0 && r < h2;
    s_wy[q] = in ? ty.w[side * h2 + r] : 0.f;
    s_ry[q] = in ? ty.lo[side * h2 + r] - r0 : 0;
  }
  for (int q = tid; q < (kTW + 2) * 2; q += kInterpThreads) {
    const int cc = j0 - 1 + q / 2, side = q % 2;
    const bool in = cc >= 0 && cc < w2;
    s_wx[q] = in ? tx.w[side * w2 + cc] : 0.f;
    s_cx[q] = in ? tx.lo[side * w2 + cc] - x0 : 0;
  }
  for (int q = tid; q < 6 * coutp; q += kInterpThreads) {
    const int row = q / coutp, co = q - row * coutp;
    float v = 0.f;
    if (co < cout) {
      if (row == 0) {
        if (bias != nullptr) v = to_f32(bias[co]);
      } else if (ep != nullptr) {
        v = ep[(row - 1) * cout + co];
        if (row == 5) v = V::round(v);   // PReLU's slope in the output's type
      }
    }
    s_ep[q] = v;
  }
  const size_t ldy = static_cast<size_t>(9) * coutp;
  const T* yb = y + (static_cast<size_t>(bi) * h + r0) * w * ldy + static_cast<size_t>(x0) * ldy;
  const bool vec_out = cout % kN == 0;
  const int nchunks = (coutp + kCC - 1) / kCC;

  // this thread's vectors of a chunk's slab: where each comes from, once (the
  // same for every chunk but for the channel offset)
  constexpr int kSlots = (kLH * kLW * 9 * kCV + kInterpThreads - 1) / kInterpThreads;
  int src[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int q = tid + k * kInterpThreads;
    const int tap = (q / kCV) % 9, px = q / (kCV * 9);
    const int r = px / kLW, xx = px % kLW;
    src[k] = (r < lh && xx < lw) ? ((r * w + xx) * 9 + tap) * coutp + (tid % kCV) * kN : -1;
  }
  auto load_chunk = [&](int chunk) {
    T* dst = s_y + (chunk & 1) * kSlab + tid * kN;
    const int c0 = chunk * kCC;
    if (tid % kCV >= min(kCC, coutp - c0) / kN) return;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (src[k] >= 0) istnet::cp_async16(dst + k * kInterpThreads * kN, yb + src[k] + c0);
    }
  };

  load_chunk(0);
  istnet::cp_async_commit();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int c0 = chunk * kCC;
    const int nvec = min(kCC, coutp - c0) / kN;
    if (chunk + 1 < nchunks) load_chunk(chunk + 1);
    istnet::cp_async_commit();
    istnet::cp_async_wait<1>();
    __syncthreads();   // the chunk's y has landed; t is read out

    // row pass: t[ii][xx][dx] = sum over dy of the row lerp of y's plane (dy, dx)
    const T* sy = s_y + (chunk & 1) * kSlab;
    for (int it = tid; it < kTH * 3 * kLW * kCV; it += kInterpThreads) {
      const int v = it % kCV, xx = (it / kCV) % kLW;
      const int dx = (it / (kCV * kLW)) % 3, ii = it / (kCV * kLW * 3);
      if (xx >= lw || v >= nvec) continue;
      float tv[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) tv[e] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          // a tap of weight 0 (outside the doubled map, hi == lo, an exact
          // grid point) reads a row of the patch and adds 0 * y
          const float wy = s_wy[(ii + dy) * 2 + side];
          const int row = s_ry[(ii + dy) * 2 + side];
          float yv[kN];
          V::unpack(*reinterpret_cast<const Raw*>(
                        sy + (((row * kLW + xx) * 9 + dy * 3 + dx) * kCV + v) * kN),
                    yv);
#pragma unroll
          for (int e = 0; e < kN; ++e) tv[e] = fmaf(wy, yv[e], tv[e]);
        }
      }
      *reinterpret_cast<Raw*>(s_t + (((ii * kLW + xx) * 3 + dx) * kCV + v) * kN) = V::pack(tv);
    }
    __syncthreads();

    // column pass, bias, epilogue, store
    for (int it = tid; it < kTH * kTW * kCV; it += kInterpThreads) {
      const int v = it % kCV, jj = (it / kCV) % kTW, ii = it / (kCV * kTW);
      const int i = i0 + ii, j = j0 + jj;
      if (i >= h2 || j >= w2 || v >= nvec) continue;
      float acc[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          // a tap of weight 0 reads a column the row pass wrote (column 0
          // when it lies outside the doubled map) and adds 0 * t
          const float wx = s_wx[(jj + dx) * 2 + side];
          const int xx = s_cx[(jj + dx) * 2 + side];
          float tv[kN];
          V::unpack(*reinterpret_cast<const Raw*>(
                        s_t + (((ii * kLW + xx) * 3 + dx) * kCV + v) * kN),
                    tv);
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[e] = fmaf(wx, tv[e], acc[e]);
        }
      }
      const int c = c0 + v * kN;
      const float* se = s_ep + c;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        if (c + e >= cout) {
          acc[e] = 0.f;
          continue;
        }
        float val = V::round(acc[e]);
        if (bias != nullptr) val = V::round(__fadd_rn(val, se[e]));
        if (ep != nullptr) {
          float tt = __fmul_rn(__fsub_rn(val, se[coutp + e]), se[2 * coutp + e]);
          tt = V::round(__fadd_rn(__fmul_rn(tt, se[3 * coutp + e]), se[4 * coutp + e]));
          val = tt >= 0.f ? tt : V::round(__fmul_rn(se[5 * coutp + e], tt));
        }
        acc[e] = val;
      }
      T* o = out + ((static_cast<size_t>(bi) * h2 + i) * w2 + j) * cout + c;
      if (vec_out && c + kN <= cout) {
        *reinterpret_cast<Raw*>(o) = V::pack(acc);
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          if (c + e < cout) o[e] = V::scalar(acc[e]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_interp(const void* scratch, const void* bias, const float* ep,
                          Taps ty, Taps tx, int b, int h, int w, int cout, int coutp,
                          void* out, cudaStream_t s) {
  const dim3 grid((2 * w + kTW - 1) / kTW, (2 * h + kTH - 1) / kTH, b);
  // 16-byte vectors of y (two chunks) and of t, then the epilogue rows
  const size_t smem = (2 * kLH * kLW * 9 + kTH * kLW * 3) * kCV * 16 +
                      static_cast<size_t>(6) * coutp * sizeof(float);
  // one block's shared memory; a patch's element offsets are held as int
  if (smem > 232448 || (static_cast<long long>(kLH) * w + kLW) * 9 * coutp > 2147483647LL) {
    return cudaErrorInvalidConfiguration;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      interp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  interp_kernel<T><<<grid, kInterpThreads, smem, s>>>(
      static_cast<const T*>(scratch), static_cast<const T*>(bias), ep, ty, tx, h, w, cout,
      coutp, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x (b, h, w, lda) NHWC with lda = cin rounded up to 8 (zero channels); km
// (kp, np) in f32 and its transpose (np, kp) in bf16, with columns ((3 dy +
// dx) * coutp + c), kp = lda rounded up to 32 (f32) or 64 (bf16), coutp =
// cout rounded up to 8, np = 9 * coutp rounded up to 192, zeros in the
// padding; bias (cout) or null; ep (5, cout) f32 or null; tap tables for
// rows (ylo: 2 x 2h int32, yw: 2 x 2h f32) and columns (xlo: 2 x 2w, xw: 2 x
// 2w); scratch (b*h*w, 9 * coutp); out (b, 2h, 2w, cout). x, km, bias,
// scratch and out are bf16 if bf16 else f32; all contiguous.
extern "C" int istnet_fold_upsample(const void* x, const void* km,
                                    const void* bias, const float* ep,
                                    const int* ylo, const float* yw,
                                    const int* xlo, const float* xw, int b,
                                    int h, int w, int lda, int kp, int cout,
                                    int coutp, int np, void* scratch,
                                    void* out, int bf16, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || lda <= 0 || cout <= 0 || lda % 8 != 0 ||
      kp % (bf16 ? kBK16 : 2 * kBK32) != 0 || kp < lda || coutp % 8 != 0 || coutp < cout ||
      np % kBN32 != 0 || np < 9 * coutp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * h * w, ncols = 9 * coutp;
  cudaError_t err = cudaSuccess;
  const dim3 grid(np / (bf16 ? kBN16 : kBN32), (m + kBM - 1) / kBM);
  if (bf16) {
    err = cudaFuncSetAttribute(gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGemmSmem16);
    if (err != cudaSuccess) return static_cast<int>(err);
    gemm_bf16_kernel<<<grid, kGemmThreads, kGemmSmem16, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(km),
        static_cast<__nv_bfloat16*>(scratch), m, lda, kp, ncols);
  } else {
    err = cudaFuncSetAttribute(gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGemmSmem32);
    if (err != cudaSuccess) return static_cast<int>(err);
    gemm_f32_kernel<<<grid, kGemmThreads, kGemmSmem32, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(km),
        static_cast<float*>(scratch), m, lda, kp, np, ncols);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bf16 ? launch_interp<__nv_bfloat16>(scratch, bias, ep, Taps{ylo, yw}, Taps{xlo, xw}, b,
                                            h, w, cout, coutp, out, s)
             : launch_interp<float>(scratch, bias, ep, Taps{ylo, yw}, Taps{xlo, xw}, b, h, w,
                                    cout, coutp, out, s);
  return static_cast<int>(err);
}
