// The FP backward's scatter for Hopper (sm_90a): the transpose of the
// 3-NN interpolation in its features.
//
// The body of the TPU FP backward istnet_tpu/ops/three_nn_pallas.py:
// _fpi_bwd, which runs it as a (B, N, M) interpolation matrix contracted
// with the cotangent right after the 3-NN kernel (three_nn.cu here). For
// each unknown point u and neighbour k, with p = idx[u, k]:
//   feats_bar[p, :] += weight[u, k] * g[u, :]
// The points get no gradient (the reference's ThreeNN is not
// differentiable), so this is the whole backward of the stage.
//
// What bounds it: the cotangent read, (B, N, C) f32 (~25 MB at the last FP
// stage, B=24), and 3 atomic adds per element into the (B, M, C) output.
// Design: one warp per unknown point, lanes along channels (coalesced reads
// of the cotangent row and of the three output rows); each product is
// rounded in f32 and added with one atomic.
//
// Determinism: f32 atomicAdd, so the order in which the unknown points'
// contributions land on a known point changes from run to run (the
// reference's CUDA op does the same); the results agree with the plain
// version's to f32 summation order.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // unknown points per block

__global__ void __launch_bounds__(kWarps * 32)
interp_scatter_kernel(const float* __restrict__ grad, const int* __restrict__ idx,
                      const float* __restrict__ weight, int n, int m, int c,
                      float* __restrict__ feats_bar) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= n) return;
  const size_t row = static_cast<size_t>(b) * n + u;
  const int p0 = idx[row * 3], p1 = idx[row * 3 + 1], p2 = idx[row * 3 + 2];
  const float w0 = weight[row * 3], w1 = weight[row * 3 + 1], w2 = weight[row * 3 + 2];
  const float* g = grad + row * c;
  float* out = feats_bar + static_cast<size_t>(b) * m * c;
  for (int ch = lane; ch < c; ch += 32) {
    const float v = g[ch];
    atomicAdd(out + static_cast<size_t>(p0) * c + ch, __fmul_rn(w0, v));
    atomicAdd(out + static_cast<size_t>(p1) * c + ch, __fmul_rn(w1, v));
    atomicAdd(out + static_cast<size_t>(p2) * c + ch, __fmul_rn(w2, v));
  }
}

}  // namespace

// grad (b, n, c) f32, idx (b, n, 3) int32 with entries in [0, m), weight
// (b, n, 3) f32, all contiguous; feats_bar (b, m, c) f32 must be zeroed by
// the caller.
extern "C" int istnet_interp_scatter(const float* grad, const int* idx,
                                     const float* weight, int b, int n, int m,
                                     int c, float* feats_bar, void* stream) {
  if (b <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  interp_scatter_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, idx, weight, n, m, c, feats_bar);
  return static_cast<int>(cudaGetLastError());
}
