// 3-nearest-neighbour search (distances and indices) for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/three_nn_pallas.py:
// _three_nn_kernel (via three_nn_pallas), which the FP backward (_fpi_bwd)
// runs to rebuild the interpolation weights. For each unknown point: idx
// the 3 nearest known points in (d2, index) order (ties to the lower
// index, a strict <), dist = sqrt(max(d2, 0)), d2 in the JAX form
// (|u|^2 + |k|^2) - 2 u.k with every operation rounded on its own. The
// search is three_nn.cuh's, the one the FP interpolation kernel runs, so
// forward and backward pick the same neighbours.
//
// What bounds it: N x M distance evaluations per cloud (1024 x 512 at the
// largest stage, ~0.5 G evaluations at B=24 over the four FP stages) and
// 24 bytes of output per unknown point: compute and latency, no memory
// rate. Design: one warp per unknown point, the known set of its cloud in
// shared memory (16 bytes a point: coordinates and squared norm), lanes
// strided over the known points with a private top-3, a warp-wide merge.
// The TPU kernel padded M to a lane multiple with far-away dummy points and
// ran three masked argmin passes over a (TN, M) tile; neither is needed.
#include <cuda_runtime.h>

#include "three_nn.cuh"

namespace {

constexpr int kWarps = 8;  // unknown points per block

__global__ void __launch_bounds__(kWarps * 32)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                int n, int m, float* __restrict__ dist, int* __restrict__ idx) {
  extern __shared__ float s_known[];  // 3 * m coordinates, then m norms
  float* s_norm = s_known + 3 * m;
  const int b = blockIdx.y;
  istnet::load_known(known + static_cast<size_t>(b) * m * 3, m, s_known, s_norm);

  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= n) return;  // whole warp leaves together; no barrier follows
  const size_t row = (static_cast<size_t>(b) * n + u) * 3;
  float sel_d[3];
  int sel_i[3];
  istnet::warp_three_nn(s_known, s_norm, m, unknown[row], unknown[row + 1],
                        unknown[row + 2], sel_d, sel_i);
  if (lane < 3) {
    const float d2 = lane == 0 ? sel_d[0] : (lane == 1 ? sel_d[1] : sel_d[2]);
    dist[row + lane] = sqrtf(d2);  // d2 is clamped at 0 already
    idx[row + lane] = lane == 0 ? sel_i[0] : (lane == 1 ? sel_i[1] : sel_i[2]);
  }
}

}  // namespace

// unknown (b, n, 3) and known (b, m, 3) f32, contiguous -> dist (b, n, 3)
// f32 and idx (b, n, 3) int32; 3 <= m <= 8192 (shared memory holds 16 bytes
// a point).
extern "C" int istnet_three_nn(const float* unknown, const float* known, int b,
                               int n, int m, float* dist, int* idx,
                               void* stream) {
  if (m < 3 || m > 8192) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(4) * m * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        three_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  three_nn_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      unknown, known, n, m, dist, idx);
  return static_cast<int>(cudaGetLastError());
}
