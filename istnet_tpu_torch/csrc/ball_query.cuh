// The warp-wide ball query shared by the grouping kernel
// (ball_query_group.cu), the fused SA kernel (sa_fused.cu) and the
// neighbour-index kernel (ball_query.cu), so that the grouping's forward
// and its backward's recomputed lists decide every radius test alike.
//
// One warp scans the points of one cloud in index order, 32 at a time, and
// keeps for each radius the first ns indices with d2 < r^2. d2 uses the JAX
// form (|c|^2 + |p|^2) - 2 c.p with every product and sum rounded on its
// own (__fmul_rn/__fadd_rn: no FMA contraction), the term order of the
// plain PyTorch version (ops/pointnet2.py: pairwise_d2), so kernel and
// plain version decide every radius test identically. __ballot_sync marks
// the hits of a 32-point chunk, __popc ranks them (a chunk without a hit
// skips the ranking), and the scan stops once every list is full. The scan
// is a chain (each chunk's ranks need the counts before it): a cloud staged
// in shared memory as (x, y, z, |p|^2) costs one 16-byte load a point;
// from global memory each point is fetched one chunk ahead of its test.
#pragma once

#include <cuda_runtime.h>

namespace istnet {

constexpr int kMaxRadii = 2;
constexpr int kMaxNs = 64;

__device__ __forceinline__ float norm2_rn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// kStaged: the points are read from `cloud`, staged as (x, y, z, |p|^2) in
// shared memory; else from pts (n, 3) f32, and cloud is unused. (cx, cy,
// cz) the centroid. For each radius r < count: idx[r][0 .. min(cnt[r],
// ns[r])) receives the first hits in index order and cnt[r] the number of
// hits seen before the scan stopped (warp-uniform; at least ns[r] when the
// list is full). Call with the whole warp; the caller __syncwarp()s before
// reading idx from other lanes.
template <bool kStaged>
__device__ __forceinline__ void warp_ball_query(
    const float4* cloud, const float* __restrict__ pts, int n,
    float cx, float cy, float cz,
    const float (&r2)[kMaxRadii], const int (&ns)[kMaxRadii], int count,
    int* const (&idx)[kMaxRadii], int (&cnt)[kMaxRadii]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float an = norm2_rn(cx, cy, cz);
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) cnt[r] = 0;
  // from global memory the next chunk's point is loaded before this
  // chunk's is tested: the loads do not wait for the counts, so their
  // latency hides behind the test (same values, same arithmetic, same
  // decisions). Loading the chunk coalesced and handing each lane its
  // point by shuffle measured slower.
  float nx = 0.f, ny = 0.f, nz = 0.f;
  if (!kStaged && lane < n) {
    nx = pts[3 * lane], ny = pts[3 * lane + 1], nz = pts[3 * lane + 2];
  }
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool real = i < n;
    float px = nx, py = ny, pz = nz, bn = 0.f;
    if constexpr (kStaged) {
      if (real) {
        const float4 p = cloud[i];
        px = p.x, py = p.y, pz = p.z, bn = p.w;
      }
    } else {
      if (i + 32 < n) {
        nx = pts[3 * (i + 32)], ny = pts[3 * (i + 32) + 1], nz = pts[3 * (i + 32) + 2];
      }
      if (real) bn = norm2_rn(px, py, pz);
    }
    float d2 = 0.f;
    if (real) {
      const float ab = __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)),
                                 __fmul_rn(cz, pz));
      d2 = fmaxf(__fsub_rn(__fadd_rn(an, bn), __fmul_rn(2.f, ab)), 0.f);
    }
    bool full = true;
#pragma unroll
    for (int r = 0; r < kMaxRadii; ++r) {
      if (r < count) {
        const bool hit = real && d2 < r2[r];
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (mask != 0u) {                   // warp-uniform
          const int rank = cnt[r] + __popc(mask & below);
          if (hit && rank < ns[r]) idx[r][rank] = i;
          cnt[r] += __popc(mask);
        }
        full = full && cnt[r] >= ns[r];
      }
    }
    if (full) break;  // cnt is warp-uniform, so is the exit
  }
}

// The point in slot s of a list with `hits` hits: the hit itself, padded
// with the first hit, point 0 when nothing is in radius.
__device__ __forceinline__ int slot_point(const int* idx, int hits, int s) {
  return s < hits ? idx[s] : (hits > 0 ? idx[0] : 0);
}

}  // namespace istnet
