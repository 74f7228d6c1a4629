// Fused 3-NN + inverse-distance interpolation (a whole PointNet++ FP gather
// stage) for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/three_nn_pallas.py:
// _fp_interp_kernel. For each unknown point u: the 3 known points with the
// smallest d2 in (d2, index) order (a strict-< scan, as
// istnet_tpu/ops/golden.py:three_nn_golden), d2 in the JAX form
// (|u|^2 + |k|^2) - 2 u.k clamped at 0 with every operation rounded on its
// own (no FMA contraction, the plain version's term order); weights
// 1/(sqrt(d2) + 1e-8) normalised over the three; out[u, :] the weighted sum
// of the three feature rows.
//
// What bounds it: the output rows, N x C values written once (33.5 MB of
// the 50 MB a B=32 float32 forward moves at the last stage), and the known
// rows read from L2; and the search, N x M distance tests (~22
// instructions each, three_nn.cuh: ~15 us of issue a B=32 forward over the
// four stages, more than the bytes take at their rate).
// Design: the search is three_nn.cuh's, shared with the FP backward's 3-NN
// kernel (three_nn.cu), so forward and backward pick the same neighbours:
// a block stages its cloud's known set once and each thread searches for
// its own point from shared-memory broadcasts. Then each warp writes its
// points' rows: a point's (idx[3], w[3]) broadcast from the lane that found
// them, lanes along channels with 16-byte loads and stores (4 float32 or 8
// bf16 values a lane), kInFlight points at once; rows that are not 16-byte
// aligned take a scalar instance. The TPU kernel's (TN, M) one-hot
// interpolation matrix and its MXU contraction are replaced by these three
// direct row loads a value.
//
// Types: points f32; features and output f32, or both bf16. The weights
// stay f32 and the weighted sum accumulates in f32 from the exact upcast of
// each bf16 feature, with one rounding to bf16 at the store, as the TPU
// kernel's exact bf16x3 weight split gives (three_nn_pallas.py:134-147).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "three_nn.cuh"

namespace {

using istnet::kBlockThreads;
using istnet::kGroup;
using istnet::kWarpPoints;

// points whose rows a warp gathers at once
constexpr int kInFlightMax = 4;
constexpr int kInFlight = kWarpPoints < kInFlightMax ? kWarpPoints : kInFlightMax;
static_assert(kWarpPoints % kInFlight == 0, "whole steps of points");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float mix(const float (&w)[3], float a, float b, float c) {
  return w[0] * a + w[1] * b + w[2] * c;
}

// out <- w . (r0, r1, r2) for one 16-byte vector of each row.
__device__ __forceinline__ uint4 mix_vec(const float (&w)[3], uint4 r0, uint4 r1,
                                         uint4 r2, float) {
  uint4 o;
  o.x = __float_as_uint(mix(w, __uint_as_float(r0.x), __uint_as_float(r1.x),
                            __uint_as_float(r2.x)));
  o.y = __float_as_uint(mix(w, __uint_as_float(r0.y), __uint_as_float(r1.y),
                            __uint_as_float(r2.y)));
  o.z = __float_as_uint(mix(w, __uint_as_float(r0.z), __uint_as_float(r1.z),
                            __uint_as_float(r2.z)));
  o.w = __float_as_uint(mix(w, __uint_as_float(r0.w), __uint_as_float(r1.w),
                            __uint_as_float(r2.w)));
  return o;
}

__device__ __forceinline__ unsigned mix_pair(const float (&w)[3], unsigned a,
                                             unsigned b, unsigned c) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  const float2 fc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&c));
  const __nv_bfloat162 o = __floats2bfloat162_rn(mix(w, fa.x, fb.x, fc.x),
                                                 mix(w, fa.y, fb.y, fc.y));
  return *reinterpret_cast<const unsigned*>(&o);
}

__device__ __forceinline__ uint4 mix_vec(const float (&w)[3], uint4 r0, uint4 r1,
                                         uint4 r2, __nv_bfloat16) {
  uint4 o;
  o.x = mix_pair(w, r0.x, r1.x, r2.x);
  o.y = mix_pair(w, r0.y, r1.y, r2.y);
  o.z = mix_pair(w, r0.z, r1.z, r2.z);
  o.w = mix_pair(w, r0.w, r1.w, r2.w);
  return o;
}

// One step of a warp's gather: kInFlight points' rows (live ones only),
// lanes along channels; kVec: 16-byte vectors (rows and bases aligned).
template <typename T, bool kVec>
__device__ __forceinline__ void gather_rows(const T* __restrict__ f, int c,
                                            const int (&idx)[kInFlight][3],
                                            const float (&w)[kInFlight][3],
                                            const bool (&live)[kInFlight],
                                            T* (&o)[kInFlight], int lane) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const int nv = c / kPer;
    for (int v = lane; v < nv; v += 32) {
      uint4 r[kInFlight][3];
#pragma unroll
      for (int e = 0; e < kInFlight; ++e) {
        if (!live[e]) continue;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          r[e][x] = reinterpret_cast<const uint4*>(
              f + static_cast<size_t>(idx[e][x]) * c)[v];
        }
      }
#pragma unroll
      for (int e = 0; e < kInFlight; ++e) {
        if (!live[e]) continue;
        reinterpret_cast<uint4*>(o[e])[v] = mix_vec(w[e], r[e][0], r[e][1], r[e][2], T());
      }
    }
  } else {
    for (int ch = lane; ch < c; ch += 32) {
      float r[kInFlight][3];
#pragma unroll
      for (int e = 0; e < kInFlight; ++e) {
        if (!live[e]) continue;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          r[e][x] = to_f32(f[static_cast<size_t>(idx[e][x]) * c + ch]);
        }
      }
#pragma unroll
      for (int e = 0; e < kInFlight; ++e) {
        if (live[e]) store(o[e] + ch, mix(w[e], r[e][0], r[e][1], r[e][2]));
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlockThreads)
fp_interp_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                 const T* __restrict__ feats, int n, int m, int c,
                 T* __restrict__ out) {
  extern __shared__ float4 s_known[];
  const int b = blockIdx.y;
  // the group's point is loaded while the known set is staged
  float3 u;
  istnet::load_point(unknown, n, u);
  istnet::stage_known(known + static_cast<size_t>(b) * m * 3, m, s_known);
  const istnet::Nn3 s = istnet::group_three_nn(s_known, m, u);
  float w[3];
  istnet::nn_weights(s, w);

  // the warp's kWarpPoints points, point p found by lanes [p * kGroup,
  // (p + 1) * kGroup)
  const int lane = threadIdx.x & 31;
  const int warp_first =
      static_cast<int>((blockIdx.x * blockDim.x + (threadIdx.x & ~31u)) / kGroup);
  const T* f = feats + static_cast<size_t>(b) * m * c;
  for (int p = 0; p < kWarpPoints; p += kInFlight) {
    int idx[kInFlight][3];
    float wt[kInFlight][3];
    bool live[kInFlight];
    T* o[kInFlight];
#pragma unroll
    for (int e = 0; e < kInFlight; ++e) {
      const int src = (p + e) * kGroup;
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        idx[e][x] = __shfl_sync(0xffffffffu, s.i[x], src);
        wt[e][x] = __shfl_sync(0xffffffffu, w[x], src);
      }
      const int v = warp_first + p + e;
      live[e] = v < n;
      o[e] = out + (static_cast<size_t>(b) * n + min(v, n - 1)) * c;
    }
    gather_rows<T, kVec>(f, c, idx, wt, live, o, lane);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const float* unknown, const float* known, const void* feats,
                   int b, int n, int m, int c, void* out, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float4);
  const bool vec = static_cast<size_t>(c) * sizeof(T) % 16 == 0 &&
                   aligned16(feats) && aligned16(out);
  auto kernel = vec ? fp_interp_kernel<T, true> : fp_interp_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid = istnet::nn_grid(b, n);
  kernel<<<grid, kBlockThreads, smem, s>>>(unknown, known, static_cast<const T*>(feats),
                                           n, m, c, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// unknown (b, n, 3) and known (b, m, 3) f32, feats (b, m, c) -> out
// (b, n, c), both bf16 if bf16 else f32; all contiguous; 3 <= m <= 8192
// (shared memory holds 16 bytes a point).
extern "C" int istnet_fp_interpolate(const float* unknown, const float* known,
                                     const void* feats, int b, int n, int m,
                                     int c, void* out, int bf16, void* stream) {
  if (m < 3 || m > 8192) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(unknown, known, feats, b, n, m, c, out, s)
           : launch<float>(unknown, known, feats, b, n, m, c, out, s);
  return static_cast<int>(e);
}
