// Multi-radius ball query + grouping for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/ball_query_pallas.py:
// _bq_group_kernel_t (and its untransposed twin _bq_group_kernel, which
// computes the same function). Per radius r and centroid c, the output row
// block is (ns, 3 + C) = [xyz[idx] - c, feats[idx]], where idx holds the
// first ns points with d2 < r^2 in index order, padded with the first hit,
// and point 0 in every slot when nothing is in radius
// (istnet_tpu/ops/golden.py:ball_query_golden). The query is
// ball_query.cuh's warp_ball_query, shared with the fused SA kernel.
//
// Types: xyz and centroids are f32; features f32 or bf16; the output f32 or
// bf16. Every value is formed in f32 (an exact upcast of a bf16 feature, or
// one f32 subtraction) and rounded once at the store, as the TPU kernel's
// out_dtype does (ball_query_pallas.py:513-519), so the bf16 output equals
// the plain version's f32 result cast to bf16.
//
// What bounds it: the stores. The grouped tensor is (B, M, ns, 3 + C) per
// radius, ~100 MB per SA stage at B=32 f32 (half in bf16), against ~1 MB of
// input; the scan is at most N distance evaluations per centroid and
// usually stops early. Design: one warp per centroid; after the query the
// warp writes each radius's (ns, 3 + C) block as one contiguous run, lanes
// along the flattened (slot, channel) axis, so the stores coalesce. The TPU
// kernel's one-hot MXU extraction, triangular-matmul prefix sums and bf16
// hi/mid/lo splits existed for Mosaic; here a direct indexed load is exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ball_query.cuh"

namespace {

using istnet::kMaxNs;
using istnet::kMaxRadii;

constexpr int kWarps = 8;  // centroids per block

struct Radii {
  float r2[kMaxRadii];
  int ns[kMaxRadii];
  void* out[kMaxRadii];
  int count;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TFeat, typename TOut>
__global__ void __launch_bounds__(kWarps * 32)
bq_group_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                const TFeat* __restrict__ feats, int n, int m, int cf,
                Radii radii) {
  __shared__ int s_idx[kWarps][kMaxRadii][kMaxNs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= m) return;  // whole warp leaves together

  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float* cen = new_xyz + (static_cast<size_t>(b) * m + j) * 3;
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  int* const idx[kMaxRadii] = {s_idx[warp][0], s_idx[warp][1]};
  int cnt[kMaxRadii];
  istnet::warp_ball_query(pts, n, cx, cy, cz, radii.r2, radii.ns, radii.count,
                          idx, cnt);
  __syncwarp();

  const int c = 3 + cf;
  for (int r = 0; r < radii.count; ++r) {
    const int ns = radii.ns[r];
    const int hits = min(cnt[r], ns);
    TOut* o = static_cast<TOut*>(radii.out[r]) +
              (static_cast<size_t>(b) * m + j) * ns * c;
    for (int t = lane; t < ns * c; t += 32) {
      const int s = t / c;
      const int ch = t - s * c;
      const int src = istnet::slot_point(idx[r], hits, s);
      float v;
      if (ch < 3) {
        v = pts[3 * src + ch] - (ch == 0 ? cx : (ch == 1 ? cy : cz));
      } else {
        v = to_f32(feats[(static_cast<size_t>(b) * n + src) * cf + (ch - 3)]);
      }
      store(o + t, v);
    }
  }
}

template <typename TFeat, typename TOut>
cudaError_t launch(const float* xyz, const float* new_xyz, const void* feats,
                   int b, int n, int m, int cf, const Radii& radii,
                   cudaStream_t s) {
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  bq_group_kernel<TFeat, TOut><<<grid, kWarps * 32, 0, s>>>(
      xyz, new_xyz, static_cast<const TFeat*>(feats), n, m, cf, radii);
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) and new_xyz (b, m, 3) f32; feats (b, n, cf) or null when
// cf == 0, bf16 if feats_bf16 else f32; all contiguous. For each of nr <= 2
// radii: r2[r] = r^2 as f32, ns[r] <= 64, out[r] (b, m, ns[r], 3 + cf), bf16
// if out_bf16 else f32.
extern "C" int istnet_ball_query_group(const float* xyz, const float* new_xyz,
                                       const void* feats, int feats_bf16,
                                       int b, int n, int m, int cf, int nr,
                                       const float* r2, const int* ns,
                                       void* const* out, int out_bf16,
                                       void* stream) {
  if (nr < 1 || nr > kMaxRadii) return static_cast<int>(cudaErrorInvalidValue);
  Radii radii{};
  radii.count = nr;
  for (int r = 0; r < nr; ++r) {
    if (ns[r] < 1 || ns[r] > kMaxNs) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    radii.r2[r] = r2[r];
    radii.ns[r] = ns[r];
    radii.out[r] = out[r];
  }
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (feats_bf16) {
    e = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(xyz, new_xyz, feats, b, n, m, cf, radii, s)
                 : launch<__nv_bfloat16, float>(xyz, new_xyz, feats, b, n, m, cf, radii, s);
  } else {
    e = out_bf16 ? launch<float, __nv_bfloat16>(xyz, new_xyz, feats, b, n, m, cf, radii, s)
                 : launch<float, float>(xyz, new_xyz, feats, b, n, m, cf, radii, s);
  }
  return static_cast<int>(e);
}
