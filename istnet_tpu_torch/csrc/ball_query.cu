// Multi-radius ball query (neighbour indices) for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/ball_query_pallas.py:
// _ball_query_kernel (via ball_query_multi_pallas), which the grouping
// backward (_bqg_bwd) runs to recompute the neighbour lists. Per radius r
// and centroid c: idx[c, 0 .. ns) = the first ns points with d2 < r^2 in
// index order, padded with the first hit, all 0 when nothing is in radius
// (istnet_tpu/ops/golden.py:ball_query_golden). The query is
// ball_query.cuh's warp_ball_query, the one the grouping kernel and the
// fused SA kernel run, so forward and backward decide every radius test
// alike, bit for bit.
//
// What bounds it: not bytes (~1 MB of lists at the largest stage, B=24,
// M=512, ns 16 + 32) but the scan, a chain of dependent 32-point steps per
// centroid that stops once every list is full; with a small radius it
// runs through all N points. The first version read the cloud from
// device memory, each step waiting on the next chunk's load. Design:
// - the block stages its sample's cloud in shared memory once as
//   (x, y, z, |p|^2), padded to whole steps (ball_query.cuh's stage_cloud,
//   as the grouping kernel stages it), so a point costs one 16-byte shared
//   load, and the staged scan tests two chunks a step with one vote for
//   "any hit";
// - one warp a centroid, 8 centroids of one sample a block: the staging is
//   paid once for 8 scans (a warp taking up to 4 centroids in turn, so that
//   the grid fits on the card at once, measured the same: PERF.md section 6);
// - the lanes store each list as one contiguous run.
// A cloud too large for 48 KB of shared memory (N > 2816) is scanned from
// device memory by the same kernel built without the staging.
// The TPU kernel's triangular-matmul prefix sums and per-slot
// compare-and-count passes existed for Mosaic; the warp ballot ranks the
// hits directly.
#include <cuda_runtime.h>

#include "ball_query.cuh"

namespace {

using istnet::kMaxNs;
using istnet::kMaxRadii;

constexpr int kWarps = 8;  // centroids a block
// dynamic shared memory a block may take without an opt-in (48 KB in all,
// less the static lists): the largest cloud that is staged
constexpr size_t kStagedBytes = 48 * 1024 - sizeof(int) * kWarps * kMaxRadii * kMaxNs;

struct Lists {
  float r2[kMaxRadii];
  int ns[kMaxRadii];
  int* out[kMaxRadii];
  int count;
};

// blockIdx.y is the sample, blockIdx.x a run of kWarps centroids
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int n, int m, Lists lists) {
  extern __shared__ __align__(16) float4 s_cloud[];
  __shared__ int s_idx[kWarps][kMaxRadii][kMaxNs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  if constexpr (kStaged) {
    istnet::stage_cloud<kWarps * 32>(pts, n, s_cloud);
    __syncthreads();
  }
  const int j = blockIdx.x * kWarps + warp;
  if (j >= m) return;  // whole warp leaves together

  const float* cen = new_xyz + (static_cast<size_t>(b) * m + j) * 3;
  int* const idx[kMaxRadii] = {s_idx[warp][0], s_idx[warp][1]};
  int cnt[kMaxRadii];
  istnet::warp_ball_query<kStaged>(s_cloud, pts, n, cen[0], cen[1], cen[2],
                                   lists.r2, lists.ns, lists.count, idx, cnt);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r < lists.count) {
      const int ns = lists.ns[r];
      const int hits = min(cnt[r], ns);
      int* o = lists.out[r] + (static_cast<size_t>(b) * m + j) * ns;
      for (int s = lane; s < ns; s += 32) o[s] = istnet::slot_point(idx[r], hits, s);
    }
  }
}

}  // namespace

// xyz (b, n, 3) and new_xyz (b, m, 3) f32, contiguous. For each of nr <= 2
// radii: r2[r] = r^2 as f32, ns[r] <= 64, out[r] (b, m, ns[r]) int32.
extern "C" int istnet_ball_query(const float* xyz, const float* new_xyz, int b,
                                 int n, int m, int nr, const float* r2,
                                 const int* ns, int* const* out, void* stream) {
  if (nr < 1 || nr > kMaxRadii) return static_cast<int>(cudaErrorInvalidValue);
  Lists lists{};
  lists.count = nr;
  for (int r = 0; r < nr; ++r) {
    if (ns[r] < 1 || ns[r] > kMaxNs) return static_cast<int>(cudaErrorInvalidValue);
    lists.r2[r] = r2[r];
    lists.ns[r] = ns[r];
    lists.out[r] = out[r];
  }
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  const size_t cloud = static_cast<size_t>(istnet::staged_points(n)) * sizeof(float4);
  if (cloud <= kStagedBytes) {
    ball_query_kernel<true><<<grid, kWarps * 32, cloud, s>>>(xyz, new_xyz, n, m, lists);
  } else {
    ball_query_kernel<false><<<grid, kWarps * 32, 0, s>>>(xyz, new_xyz, n, m, lists);
  }
  return static_cast<int>(cudaGetLastError());
}
