// The FP backward's scatter for Hopper (sm_90a): the transpose of the
// 3-NN interpolation in its features, as an owned, ordered gather.
//
// The body of the TPU FP backward istnet_tpu/ops/three_nn_pallas.py:
// _fpi_bwd, which runs it as a (B, N, M) interpolation matrix contracted
// with the cotangent right after the 3-NN kernel (three_nn.cu here). For
// each unknown point u and neighbour k, with p = idx[u, k]:
//   feats_bar[p, :] += weight[u, k] * g[u, :]
// The points get no gradient (the reference's ThreeNN is not
// differentiable), so this is the whole backward of the stage.
//
// What bounds it: the cotangent read, (B, N, C) (~25 MB in f32 at the last
// FP stage, B=24; half in bf16), and the (B, M, C) f32 write. Design
// (scatter_invert.cuh): the first launch inverts idx, one block a sample,
// into every known point's list of (u, k) pairs in ascending order, cut
// into chunks of 32; the second gathers, one warp a chunk and slice of
// channels, lanes along channels, each product rounded in f32 and added in
// list order, and
// writes every row of feats_bar once: no zero fill, no atomic add into the
// output, the same bits from call to call. The cotangent is read in f32 or
// bf16 (a template instance each) and summed in f32.
#include "scatter_invert.cuh"

#include <climits>
#include <cstdint>

namespace {

using istnet::Keys;
using istnet::Work;

constexpr int kGatherWarps = 4;  // chunks a gather block (8 measured slower)

// Entry e = 3 u + k of a sample names the cotangent row of u (its weight,
// weight[u, k], is placed beside it by the inversion). A code is the global
// row b * n + u.
template <typename T>
struct UnknownRows {
  const T* g;
  const T* g_end;
  int n, c;
  __device__ __forceinline__ int code(int b, int e) const { return b * n + e / 3; }
  __device__ __forceinline__ const T* row(int code) const {
    return g + static_cast<size_t>(code) * c;
  }
  __device__ __forceinline__ const T* end(int) const { return g_end; }
};

template <bool kStaged>
__global__ void __launch_bounds__(istnet::kInvThreads)
interp_invert_kernel(Keys keys, Work w) {
  extern __shared__ int smem[];
  istnet::invert_sample<kStaged>(keys, blockIdx.x, w, smem);
}

template <typename T, int kV4, istnet::Seam kSeam>
__global__ void __launch_bounds__(kGatherWarps * 32)
interp_gather_kernel(UnknownRows<T> rows, Work w, int slices, float* __restrict__ feats_bar) {
  const int item = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int c = item / slices;
  istnet::gather_chunk<T, kV4, kSeam, true>(rows, w, b, c, item - c * slices, slices, rows.c,
                                    feats_bar + static_cast<size_t>(b) * w.rows * rows.c);
}

template <typename T, int kV4, istnet::Seam kSeam>
cudaError_t launch_gather(const UnknownRows<T>& rows, const Work& w, int b, float* feats_bar,
                          cudaStream_t s) {
  const int slices = istnet::gather_slices(rows.c);
  const dim3 grid((w.max_chunks * slices + kGatherWarps - 1) / kGatherWarps, b);
  interp_gather_kernel<T, kV4, kSeam><<<grid, kGatherWarps * 32, 0, s>>>(rows, w, slices,
                                                                         feats_bar);
  return cudaGetLastError();
}

template <typename T, istnet::Seam kSeam>
cudaError_t launch_vectors(const UnknownRows<T>& rows, const Work& w, int b, float* feats_bar,
                           cudaStream_t s) {
  switch (istnet::gather_vectors(rows.c)) {
    case 1: return launch_gather<T, 1, kSeam>(rows, w, b, feats_bar, s);
    case 2: return launch_gather<T, 2, kSeam>(rows, w, b, feats_bar, s);
    case 3: return launch_gather<T, 3, kSeam>(rows, w, b, feats_bar, s);
    default: return launch_gather<T, 4, kSeam>(rows, w, b, feats_bar, s);
  }
}

template <typename T>
cudaError_t launch(const void* grad, const int* idx, const float* weight, int b, int n,
                   int m, int c, float* feats_bar, void* ws, cudaStream_t s) {
  Keys keys{};
  keys.base[0] = keys.base[1] = idx;
  keys.len[0] = 3 * n;
  keys.len[1] = 0;
  keys.weight = weight;
  const T* g = static_cast<const T*>(grad);
  const UnknownRows<T> rows{g, g + static_cast<size_t>(b) * n * c, n, c};
  const Work w = istnet::carve(ws, b, 3 * n, m, c);
  const cudaError_t err =
      istnet::staged(3 * n, m)
          ? istnet::launch_invert<true>(interp_invert_kernel<true>, b, 3 * n, m, s, keys, w)
          : istnet::launch_invert<false>(interp_invert_kernel<false>, b, 3 * n, m, s, keys, w);
  if (err != cudaSuccess) return err;
  switch (istnet::gather_seam(c)) {
    case istnet::kAligned: return launch_vectors<T, istnet::kAligned>(rows, w, b, feats_bar, s);
    case istnet::kShifted: return launch_vectors<T, istnet::kShifted>(rows, w, b, feats_bar, s);
    default: return launch_vectors<T, istnet::kShiftedTail>(rows, w, b, feats_bar, s);
  }
}

bool valid(int b, int n, int m, int c) {
  // codes are b * n + u in an int; entries 3 n
  return b >= 0 && n >= 0 && m >= 1 && c >= 1 && 3LL * b * n < INT_MAX;
}

}  // namespace

// Workspace bytes of istnet_interp_scatter for these shapes, into *bytes.
extern "C" int istnet_interp_scatter_workspace(int b, int n, int m, int c, long long* bytes) {
  if (!valid(b, n, m, c)) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = static_cast<long long>(istnet::work_bytes(b, 3 * n, m, c));
  return static_cast<int>(cudaSuccess);
}

// grad (b, n, c) f32, or bf16 if bf16, starting on a 16-byte boundary;
// idx (b, n, 3) int32 with entries in
// [0, m); weight (b, n, 3) f32; all contiguous. Writes feats_bar (b, m, c)
// f32. ws: ws_bytes >= the workspace bytes (istnet_interp_scatter_workspace).
extern "C" int istnet_interp_scatter(const void* grad, const int* idx, const float* weight,
                                     int b, int n, int m, int c, int bf16, float* feats_bar,
                                     void* ws, long long ws_bytes, void* stream) {
  if (!valid(b, n, m, c)) return static_cast<int>(cudaErrorInvalidValue);
  long long need = 0;
  istnet_interp_scatter_workspace(b, n, m, c, &need);
  if (ws_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(grad) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (b == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(grad, idx, weight, b, n, m, c, feats_bar, ws, s)
           : launch<float>(grad, idx, weight, b, n, m, c, feats_bar, ws, s);
  return static_cast<int>(e);
}
