// The grouping backward's scatter for Hopper (sm_90a): the transpose of
// ball query + group, as an owned, ordered gather.
//
// The body of the TPU grouping backward istnet_tpu/ops/ball_query_pallas.py:
// _bqg_bwd, which runs it as a one-hot (B, M*ns, N) einsum right after the
// index kernel (ball_query.cu here). Per radius r, centroid m and slot s,
// with p = idx_r[m, s] and g = the (3 + C) cotangent row of that slot:
//   points_bar[p, :]     += g                (the points' and features' grads)
//   centroid_bar[m, 0:3] -= g[0:3]           (d(x_p - c_m)/dc_m = -1)
// Pad slots hold the first hit and rows without a hit hold point 0, so their
// cotangents go there, as autodiff through the gather gives.
//
// What bounds it: the cotangent read, (B, M, ns, 3 + C) per radius (~79 MB
// in f32 at SA stage 2, B=24; half in bf16). Design (scatter_invert.cuh):
// the first launch inverts the index maps, one block a sample, into every
// point's list of slots in (radius, centroid, slot) order, cut into chunks
// of 32. The second gathers, one warp a chunk and slice of channels, lanes
// along channels, and writes every row of points_bar once: no zero fill,
// no atomic add into an output, the same bits from call to call; its last
// blocks sum centroid_bar, one warp a centroid row over both radii in fixed
// slot order (lanes along slots, then a butterfly whose partners add the
// same pair, so every lane holds the same bits). Rows are read in f32 or
// bf16 (a template instance each) and summed in f32.
#include "scatter_invert.cuh"

#include <climits>
#include <cstdint>

namespace {

using istnet::Chunk;
using istnet::Keys;
using istnet::Work;

constexpr int kMaxRadii = 2;
constexpr int kMaxNs = 64;
constexpr int kGatherWarps = 4;  // chunks a gather block (8 measured slower)

// Slot rows of a sample: entry e < mns[0] is radius 0's row e, else radius
// 1's row e - mns[0] (mns[r] = M * ns[r]). A code is (global row << 1) | r.
template <typename T>
struct SlotRows {
  const T* g[kMaxRadii];
  const T* g_end[kMaxRadii];
  int mns[kMaxRadii];
  int c;
  __device__ __forceinline__ int code(int b, int e) const {
    return e < mns[0] ? (b * mns[0] + e) << 1 : ((b * mns[1] + (e - mns[0])) << 1) | 1;
  }
  __device__ __forceinline__ const T* row(int code) const {
    return ((code & 1) ? g[1] : g[0]) + static_cast<size_t>(code >> 1) * c;
  }
  __device__ __forceinline__ const T* end(int code) const {
    return (code & 1) ? g_end[1] : g_end[0];
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(istnet::kInvThreads)
group_invert_kernel(Keys keys, Work w) {
  extern __shared__ int smem[];
  istnet::invert_sample<kStaged>(keys, blockIdx.x, w, smem);
}

// Blocks [0, chunk_blocks) of row b: one warp a (chunk, slice) of sample b.
// The others: centroid_bar of sample b, one warp a centroid row.
template <typename T, int kV4, istnet::Seam kSeam>
__global__ void __launch_bounds__(kGatherWarps * 32)
group_gather_kernel(SlotRows<T> rows, Work w, int slices, int chunk_blocks, int nr, int ns0,
                    int ns1, int m, float* __restrict__ points_bar,
                    float* __restrict__ centroid_bar) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x < chunk_blocks) {
    const int item = blockIdx.x * kGatherWarps + warp;
    const int c = item / slices;
    istnet::gather_chunk<T, kV4, kSeam, false>(rows, w, b, c, item - c * slices, slices, rows.c,
                                       points_bar + static_cast<size_t>(b) * w.rows * rows.c);
    return;
  }
  const int j = (blockIdx.x - chunk_blocks) * kGatherWarps + warp;
  if (j >= m) return;
  const int lane = threadIdx.x & 31;
  const size_t gm = static_cast<size_t>(b) * m + j;
  float tx = 0.f, ty = 0.f, tz = 0.f;
  for (int r = 0; r < nr; ++r) {
    const int ns = r ? ns1 : ns0;
    const T* g = (r ? rows.g[1] : rows.g[0]) + gm * ns * rows.c;
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (int s = lane; s < ns; s += 32) {
      const T* v = g + static_cast<size_t>(s) * rows.c;
      sx += istnet::to_f32(v[0]);
      sy += istnet::to_f32(v[1]);
      sz += istnet::to_f32(v[2]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
      sy += __shfl_xor_sync(0xffffffffu, sy, off);
      sz += __shfl_xor_sync(0xffffffffu, sz, off);
    }
    tx += sx, ty += sy, tz += sz;
  }
  if (lane < 3) centroid_bar[gm * 3 + lane] = -(lane == 0 ? tx : lane == 1 ? ty : tz);
}

template <typename T, int kV4, istnet::Seam kSeam>
cudaError_t launch_gather(const SlotRows<T>& rows, const Work& w, int nr, int ns0, int ns1,
                          int b, int m, float* points_bar, float* centroid_bar,
                          cudaStream_t s) {
  const int slices = istnet::gather_slices(rows.c);
  const int chunk_blocks = (w.max_chunks * slices + kGatherWarps - 1) / kGatherWarps;
  const dim3 grid(chunk_blocks + (m + kGatherWarps - 1) / kGatherWarps, b);
  group_gather_kernel<T, kV4, kSeam><<<grid, kGatherWarps * 32, 0, s>>>(
      rows, w, slices, chunk_blocks, nr, ns0, ns1, m, points_bar, centroid_bar);
  return cudaGetLastError();
}

template <typename T, istnet::Seam kSeam>
cudaError_t launch_vectors(const SlotRows<T>& rows, const Work& w, int nr, int ns0, int ns1,
                           int b, int m, float* points_bar, float* centroid_bar,
                           cudaStream_t s) {
  switch (istnet::gather_vectors(rows.c)) {
    case 1: return launch_gather<T, 1, kSeam>(rows, w, nr, ns0, ns1, b, m, points_bar,
                                              centroid_bar, s);
    case 2: return launch_gather<T, 2, kSeam>(rows, w, nr, ns0, ns1, b, m, points_bar,
                                              centroid_bar, s);
    case 3: return launch_gather<T, 3, kSeam>(rows, w, nr, ns0, ns1, b, m, points_bar,
                                              centroid_bar, s);
    default: return launch_gather<T, 4, kSeam>(rows, w, nr, ns0, ns1, b, m, points_bar,
                                               centroid_bar, s);
  }
}

template <typename T>
cudaError_t launch(int nr, const int* const* idx, const void* const* grad, const int* ns,
                   int b, int n, int m, int c, float* points_bar, float* centroid_bar,
                   void* ws, cudaStream_t s) {
  Keys keys{};
  SlotRows<T> rows{};
  for (int r = 0; r < kMaxRadii; ++r) {
    const int k = r < nr ? r : 0;
    keys.base[r] = idx[k];
    keys.len[r] = r < nr ? m * ns[r] : 0;
    rows.g[r] = static_cast<const T*>(grad[k]);
    rows.mns[r] = keys.len[r];
    rows.g_end[r] = rows.g[r] + static_cast<size_t>(b) * m * ns[k] * c;
  }
  rows.c = c;
  const int e = keys.len[0] + keys.len[1];
  const Work w = istnet::carve(ws, b, e, n, c);
  const cudaError_t err =
      istnet::staged(e, n)
          ? istnet::launch_invert<true>(group_invert_kernel<true>, b, e, n, s, keys, w)
          : istnet::launch_invert<false>(group_invert_kernel<false>, b, e, n, s, keys, w);
  if (err != cudaSuccess) return err;
  const int ns1 = nr > 1 ? ns[1] : 0;
  switch (istnet::gather_seam(c)) {
    case istnet::kAligned:
      return launch_vectors<T, istnet::kAligned>(rows, w, nr, ns[0], ns1, b, m, points_bar,
                                                 centroid_bar, s);
    case istnet::kShifted:
      return launch_vectors<T, istnet::kShifted>(rows, w, nr, ns[0], ns1, b, m, points_bar,
                                                 centroid_bar, s);
    default:
      return launch_vectors<T, istnet::kShiftedTail>(rows, w, nr, ns[0], ns1, b, m, points_bar,
                                                     centroid_bar, s);
  }
}

bool valid(int nr, const int* ns, int b, int n, int m, int c) {
  if (nr < 1 || nr > kMaxRadii || c < 3 || b < 0 || n < 1 || m < 0) return false;
  for (int r = 0; r < nr; ++r) {
    if (ns[r] < 1 || ns[r] > kMaxNs) return false;
    // codes are (b * m * ns + slot row) << 1 in an int
    if (2LL * b * m * ns[r] >= INT_MAX) return false;
  }
  return true;
}

}  // namespace

// Workspace bytes of istnet_group_scatter for these shapes, into *bytes.
extern "C" int istnet_group_scatter_workspace(int nr, const int* ns, int b, int n, int m,
                                              int c, long long* bytes) {
  if (!valid(nr, ns, b, n, m, c)) return static_cast<int>(cudaErrorInvalidValue);
  int e = 0;
  for (int r = 0; r < nr; ++r) e += m * ns[r];
  *bytes = static_cast<long long>(istnet::work_bytes(b, e, n, c));
  return static_cast<int>(cudaSuccess);
}

// For each of nr <= 2 radii: idx[r] (b, m, ns[r]) int32 with entries in
// [0, n), grad[r] (b, m, ns[r], c) f32, or bf16 if bf16, starting on a
// 16-byte boundary, ns[r] <= 64; c >= 3
// (the first three channels are relative xyz). Writes points_bar (b, n, c)
// and centroid_bar (b, m, 3), f32. ws: ws_bytes >= the workspace bytes
// (istnet_group_scatter_workspace). All contiguous.
extern "C" int istnet_group_scatter(int nr, const int* const* idx, const void* const* grad,
                                    const int* ns, int b, int n, int m, int c, int bf16,
                                    float* points_bar, float* centroid_bar, void* ws,
                                    long long ws_bytes, void* stream) {
  if (!valid(nr, ns, b, n, m, c)) return static_cast<int>(cudaErrorInvalidValue);
  long long need = 0;
  istnet_group_scatter_workspace(nr, ns, b, n, m, c, &need);
  if (ws_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < nr; ++r) {
    if (reinterpret_cast<uintptr_t>(grad[r]) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  if (b == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(nr, idx, grad, ns, b, n, m, c, points_bar, centroid_bar, ws, s)
           : launch<float>(nr, idx, grad, ns, b, n, m, c, points_bar, centroid_bar, ws, s);
  return static_cast<int>(e);
}
