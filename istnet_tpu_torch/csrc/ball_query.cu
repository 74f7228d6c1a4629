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
// What bounds it: at most N distance evaluations per centroid (the scan
// stops once every list is full) and ns int32 stores per radius; ~1 MB of
// output at the largest stage (B=24, M=512, ns 16 + 32). Latency, not a
// rate. Design: one warp per centroid, the lists in shared memory, then
// the lanes store each list as one contiguous run. The TPU kernel's
// triangular-matmul prefix sums and per-slot compare-and-count passes
// existed for Mosaic; the warp ballot ranks the hits directly.
#include <cuda_runtime.h>

#include "ball_query.cuh"

namespace {

using istnet::kMaxNs;
using istnet::kMaxRadii;

constexpr int kWarps = 8;  // centroids per block

struct Lists {
  float r2[kMaxRadii];
  int ns[kMaxRadii];
  int* out[kMaxRadii];
  int count;
};

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int n, int m, Lists lists) {
  __shared__ int s_idx[kWarps][kMaxRadii][kMaxNs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= m) return;  // whole warp leaves together

  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float* cen = new_xyz + (static_cast<size_t>(b) * m + j) * 3;
  int* const idx[kMaxRadii] = {s_idx[warp][0], s_idx[warp][1]};
  int cnt[kMaxRadii];
  istnet::warp_ball_query(pts, n, cen[0], cen[1], cen[2], lists.r2, lists.ns,
                          lists.count, idx, cnt);
  __syncwarp();

  for (int r = 0; r < lists.count; ++r) {
    const int ns = lists.ns[r];
    const int hits = min(cnt[r], ns);
    int* o = lists.out[r] + (static_cast<size_t>(b) * m + j) * ns;
    for (int s = lane; s < ns; s += 32) o[s] = istnet::slot_point(idx[r], hits, s);
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
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, n, m, lists);
  return static_cast<int>(cudaGetLastError());
}
