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
// What bounds it: at the production stages the scan is N x M distance
// evaluations (1024 x 512 at the last stage) and the output N x C floats;
// both are small, so latency and occupancy matter more than peak rates.
// Design: one warp per unknown point with the known set in shared memory
// (M <= 512: 6 KB of coordinates plus 2 KB of norms). The search is
// three_nn.cuh's, which the FP backward's 3-NN kernel (three_nn.cu) shares,
// so forward and backward pick the same neighbours. The TPU kernel's
// (TN, M) one-hot interpolation matrix and its MXU contraction are replaced
// by three direct row loads per channel, lanes along channels.
//
// Types: points f32; features and output f32, or both bf16. The weights
// stay f32 and the weighted sum accumulates in f32 from the exact upcast of
// each bf16 feature, with one rounding to bf16 at the store, as the TPU
// kernel's exact bf16x3 weight split gives (three_nn_pallas.py:134-147).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "three_nn.cuh"

namespace {

constexpr int kWarps = 8;  // unknown points per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fp_interp_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                 const T* __restrict__ feats, int n, int m, int c,
                 T* __restrict__ out) {
  extern __shared__ float s_known[];  // 3 * m coordinates, then m norms
  float* s_norm = s_known + 3 * m;
  const int b = blockIdx.y;
  istnet::load_known(known + static_cast<size_t>(b) * m * 3, m, s_known, s_norm);

  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= n) return;  // whole warp leaves together; no barrier follows
  const float* up = unknown + (static_cast<size_t>(b) * n + u) * 3;
  float sel_d[3];
  int sel_i[3];
  istnet::warp_three_nn(s_known, s_norm, m, up[0], up[1], up[2], sel_d, sel_i);

  float w[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) w[r] = 1.0f / (sqrtf(sel_d[r]) + 1e-8f);
  const float norm = (w[0] + w[1]) + w[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) w[r] = w[r] / norm;

  const T* f = feats + static_cast<size_t>(b) * m * c;
  const T* f0 = f + static_cast<size_t>(sel_i[0]) * c;
  const T* f1 = f + static_cast<size_t>(sel_i[1]) * c;
  const T* f2 = f + static_cast<size_t>(sel_i[2]) * c;
  T* o = out + (static_cast<size_t>(b) * n + u) * c;
  for (int ch = lane; ch < c; ch += 32) {
    store(o + ch, w[0] * to_f32(f0[ch]) + w[1] * to_f32(f1[ch]) +
                      w[2] * to_f32(f2[ch]));
  }
}

template <typename T>
cudaError_t launch(const float* unknown, const float* known, const void* feats,
                   int b, int n, int m, int c, void* out, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(4) * m * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fp_interp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  fp_interp_kernel<T><<<grid, kWarps * 32, smem, s>>>(
      unknown, known, static_cast<const T*>(feats), n, m, c,
      static_cast<T*>(out));
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
