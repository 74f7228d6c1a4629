// 3-nearest-neighbour search (distances or weights, and indices) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/three_nn_pallas.py:
// _three_nn_kernel (via three_nn_pallas), which the FP backward (_fpi_bwd)
// runs to rebuild the interpolation weights. For each unknown point: idx
// the 3 nearest known points in (d2, index) order (ties to the lower
// index, a strict <), d2 in the JAX form (|u|^2 + |k|^2) - 2 u.k with every
// operation rounded on its own; then either dist = sqrt(max(d2, 0)), or
// (kWeights) the normalised inverse-distance weights that _fpi_bwd forms
// from those distances (three_nn_pallas.py:207-208), so that the FP
// backward takes idx and weight from one launch. The search is
// three_nn.cuh's, the one the FP interpolation kernel runs, so forward and
// backward pick the same neighbours.
//
// What bounds it: N x M distance tests (16.7 M a B=24 step's four calls of
// one extractor, ~22 instructions each: 7 for d2, 14 for the branch-free
// top-3 insertion, a shared load) and 24 bytes of output per unknown
// point: instruction issue, no memory rate. Design:
// three_nn.cuh's search (the known set staged once a block as float4,
// read by broadcast, a top-3 a thread); the first lane of each group writes
// its points' three values and indices. The TPU kernel padded M to a lane
// multiple with far-away dummy points and ran three masked argmin passes
// over a (TN, M) tile; neither is needed.
#include <cuda_runtime.h>

#include "three_nn.cuh"

namespace {

using istnet::kBlockThreads;
using istnet::kGroup;

template <bool kWeights>
__global__ void __launch_bounds__(kBlockThreads)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                int n, int m, float* __restrict__ val, int* __restrict__ idx) {
  extern __shared__ float4 s_known[];
  const int b = blockIdx.y;
  // the group's point is loaded while the known set is staged
  float3 u;
  const int point = istnet::load_point(unknown, n, u);
  istnet::stage_known(known + static_cast<size_t>(b) * m * 3, m, s_known);
  const istnet::Nn3 s = istnet::group_three_nn(s_known, m, u);
  if (threadIdx.x % kGroup != 0 || point >= n) return;
  float v[3];
  if constexpr (kWeights) {
    istnet::nn_weights(s, v);
  } else {
#pragma unroll
    for (int x = 0; x < 3; ++x) v[x] = sqrtf(s.d[x]);  // clamped at 0
  }
  const size_t row = (static_cast<size_t>(b) * n + point) * 3;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    val[row + x] = v[x];
    idx[row + x] = s.i[x];
  }
}

template <bool kWeights>
cudaError_t launch(const float* unknown, const float* known, int b, int n, int m,
                   float* val, int* idx, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        three_nn_kernel<kWeights>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid = istnet::nn_grid(b, n);
  three_nn_kernel<kWeights><<<grid, kBlockThreads, smem, s>>>(unknown, known, n, m,
                                                               val, idx);
  return cudaGetLastError();
}

}  // namespace

// unknown (b, n, 3) and known (b, m, 3) f32, contiguous -> val (b, n, 3)
// f32 (the distances, or with weights != 0 the normalised inverse-distance
// weights) and idx (b, n, 3) int32; 3 <= m <= 8192 (shared memory holds 16
// bytes a point).
extern "C" int istnet_three_nn(const float* unknown, const float* known, int b,
                               int n, int m, float* val, int* idx, int weights,
                               void* stream) {
  if (m < 3 || m > 8192) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = weights ? launch<true>(unknown, known, b, n, m, val, idx, s)
                                : launch<false>(unknown, known, b, n, m, val, idx, s);
  return static_cast<int>(e);
}
