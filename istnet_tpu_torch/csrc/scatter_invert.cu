// The two scatters' inversion alone (scatter_invert.cuh), so that it can
// be held to its plain version (ops/pointnet2.py: invert_index): keys (b, e)
// int32 in [0, rows) -> order (b, e), each sample's entries by row and then
// by entry, and offsets (b, rows + 1), each row's first position in order
// (CSR form). The scatters run the same inversion in their first launch.
#include "scatter_invert.cuh"

namespace {

using istnet::Chunk;
using istnet::Keys;
using istnet::Work;

template <bool kStaged>
__global__ void __launch_bounds__(istnet::kInvThreads)
invert_kernel(Keys keys, Work w) {
  extern __shared__ int smem[];
  istnet::invert_sample<kStaged>(keys, blockIdx.x, w, smem);
}

// A row's first chunk begins where its list does.
__global__ void offsets_kernel(Work w, int* __restrict__ offsets) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  int* off = offsets + static_cast<size_t>(b) * (w.rows + 1);
  if (c == 0) off[w.rows] = w.e;
  if (c >= w.nchunks[b]) return;
  const Chunk ch = w.chunks[static_cast<size_t>(b) * w.max_chunks + c];
  if (ch.first == c) off[ch.row] = ch.begin;
}

bool valid(int b, int e, int rows) { return b >= 0 && e >= 0 && rows >= 1; }

}  // namespace

// Workspace bytes of istnet_invert_index for these shapes, into *bytes.
extern "C" int istnet_invert_index_workspace(int b, int e, int rows, long long* bytes) {
  if (!valid(b, e, rows)) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = static_cast<long long>(istnet::work_bytes(b, e, rows, 0));
  return static_cast<int>(cudaSuccess);
}

// keys (b, e) int32 in [0, rows); writes order (b, e) and offsets (b, rows +
// 1) int32; ws: ws_bytes >= the workspace bytes. All contiguous.
extern "C" int istnet_invert_index(const int* keys, int b, int e, int rows, int* order,
                                   int* offsets, void* ws, long long ws_bytes,
                                   void* stream) {
  if (!valid(b, e, rows)) return static_cast<int>(cudaErrorInvalidValue);
  long long need = 0;
  istnet_invert_index_workspace(b, e, rows, &need);
  if (ws_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Keys src{};
  src.base[0] = src.base[1] = keys;
  src.len[0] = e;
  src.len[1] = 0;
  Work w = istnet::carve(ws, b, e, rows, 0);
  w.sorted = order;
  const cudaError_t err =
      istnet::staged(e, rows)
          ? istnet::launch_invert<true>(invert_kernel<true>, b, e, rows, s, src, w)
          : istnet::launch_invert<false>(invert_kernel<false>, b, e, rows, s, src, w);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w.max_chunks + 255) / 256, b);
  offsets_kernel<<<grid, 256, 0, s>>>(w, offsets);
  return static_cast<int>(cudaGetLastError());
}
