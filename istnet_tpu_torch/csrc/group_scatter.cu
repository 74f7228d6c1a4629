// The grouping backward's scatter for Hopper (sm_90a): the transpose of
// ball query + group.
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
// What bounds it: the cotangent read, (B, M, ns, 3 + C) f32 per radius
// (~100 MB at SA stage 2, B=24), and the atomic adds into points_bar. Design:
// one warp per centroid, lanes along channels, so every slot row is read
// coalesced. Slots that hold the row's first index (its pad slots, or every
// slot of a row without a hit) are summed in a register first, in slot
// order, and land with one atomic; the other slots hold distinct points and
// add with one atomic each. centroid_bar is a plain in-order sum per row,
// over both radii, written once. Accumulation is f32 throughout.
//
// Determinism: points_bar is summed with f32 atomicAdd, so the order in
// which the centroids' rows land on a shared point changes from run to run
// (the reference's CUDA op does the same); its results agree with the
// plain version's to f32 summation order. centroid_bar is deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadii = 2;
constexpr int kMaxNs = 64;
constexpr int kWarps = 8;  // centroids per block

struct Rows {
  const int* idx[kMaxRadii];    // (b, m, ns[r]) int32
  const float* grad[kMaxRadii];  // (b, m, ns[r], c) f32
  int ns[kMaxRadii];
  int count;
};

__global__ void __launch_bounds__(kWarps * 32)
group_scatter_kernel(Rows rows, int n, int m, int c, float* __restrict__ points_bar,
                     float* __restrict__ centroid_bar) {
  __shared__ int s_idx[kWarps][kMaxNs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= m) return;  // whole warp leaves together

  float* pb = points_bar + static_cast<size_t>(b) * n * c;
  float cbar = 0.f;  // lanes 0..2: this centroid's gradient, channel `lane`
  for (int r = 0; r < rows.count; ++r) {
    const int ns = rows.ns[r];
    const size_t row = static_cast<size_t>(b) * m + j;
    for (int s = lane; s < ns; s += 32) s_idx[warp][s] = rows.idx[r][row * ns + s];
    __syncwarp();
    const int first = s_idx[warp][0];
    const float* g = rows.grad[r] + row * ns * c;
    for (int ch = lane; ch < c; ch += 32) {
      float at_first = g[ch];
      float slot_sum = g[ch];
      for (int s = 1; s < ns; ++s) {
        const float v = g[static_cast<size_t>(s) * c + ch];
        slot_sum += v;
        const int p = s_idx[warp][s];
        if (p == first) {
          at_first += v;
        } else {
          atomicAdd(pb + static_cast<size_t>(p) * c + ch, v);
        }
      }
      atomicAdd(pb + static_cast<size_t>(first) * c + ch, at_first);
      if (ch < 3) cbar -= slot_sum;
    }
    __syncwarp();  // s_idx is rewritten for the next radius
  }
  if (lane < 3) centroid_bar[(static_cast<size_t>(b) * m + j) * 3 + lane] = cbar;
}

}  // namespace

// For each of nr <= 2 radii: idx[r] (b, m, ns[r]) int32 with entries in
// [0, n), grad[r] (b, m, ns[r], c) f32, ns[r] <= 64; c >= 3 (the first three
// channels are relative xyz). points_bar (b, n, c) f32 must be zeroed by the
// caller; centroid_bar (b, m, 3) f32 is written. All contiguous.
extern "C" int istnet_group_scatter(int nr, const int* const* idx,
                                    const float* const* grad, const int* ns,
                                    int b, int n, int m, int c,
                                    float* points_bar, float* centroid_bar,
                                    void* stream) {
  if (nr < 1 || nr > kMaxRadii || c < 3) return static_cast<int>(cudaErrorInvalidValue);
  Rows rows{};
  rows.count = nr;
  for (int r = 0; r < nr; ++r) {
    if (ns[r] < 1 || ns[r] > kMaxNs) return static_cast<int>(cudaErrorInvalidValue);
    rows.idx[r] = idx[r];
    rows.grad[r] = grad[r];
    rows.ns[r] = ns[r];
  }
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  group_scatter_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n, m, c, points_bar, centroid_bar);
  return static_cast<int>(cudaGetLastError());
}
