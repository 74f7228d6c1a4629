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
// plain version decide every radius test identically (d2_rn, one function
// for both scans below). __ballot_sync marks the hits of a 32-point chunk,
// __popc ranks them (a chunk without a hit skips the ranking), and the scan
// stops once every list is full. The scan is a chain (each chunk's ranks
// need the counts before it), so what a chunk costs sets the time:
// - a cloud staged in shared memory as (x, y, z, |p|^2) (stage_cloud)
//   costs one 16-byte load a point; the scan tests kStagedChunks chunks a
//   step and asks once (__any_sync) whether any of them hit any radius, so
//   that a step of misses, most steps of a small radius, costs one vote and
//   no ranking. The staged cloud is padded to whole steps with points no
//   radius test passes, so the step tests no bounds;
// - from global memory each point is fetched one chunk ahead of its test.
#pragma once

#include <cuda_runtime.h>

namespace istnet {

constexpr int kMaxRadii = 2;
constexpr int kMaxNs = 64;
constexpr int kStagedChunks = 2;  // 32-point chunks a step of the staged scan
constexpr int kStagedStep = 32 * kStagedChunks;

__device__ __forceinline__ float norm2_rn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// points of a staged cloud of n: whole steps of the staged scan
__host__ __device__ constexpr int staged_points(int n) {
  return (n + kStagedStep - 1) / kStagedStep * kStagedStep;
}

// Stages the cloud pts (n, 3) f32 as (x, y, z, |p|^2), then pads it to
// staged_points(n) with (0, 0, 0, +inf): d2 = +inf, no radius test passes
// (for finite centroids). Call with the whole block of kThreads threads;
// the caller __syncthreads() before the scan.
template <int kThreads>
__device__ __forceinline__ void stage_cloud(const float* __restrict__ pts, int n,
                                            float4* cloud) {
  const int total = staged_points(n);
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += kThreads) {
    float4 c = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
    if (i < n) {
      const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
      c = make_float4(px, py, pz, norm2_rn(px, py, pz));
    }
    cloud[i] = c;
  }
}

// d2 of point (px, py, pz), |p|^2 = bn, from the centroid (cx, cy, cz),
// |c|^2 = an
__device__ __forceinline__ float d2_rn(float an, float cx, float cy, float cz,
                                       float px, float py, float pz, float bn) {
  const float ab = __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)),
                             __fmul_rn(cz, pz));
  return fmaxf(__fsub_rn(__fadd_rn(an, bn), __fmul_rn(2.f, ab)), 0.f);
}

// Appends the hits of one 32-point chunk (this lane's point i, `hit`) to a
// list of ns slots holding cnt hits so far. Call with the whole warp.
__device__ __forceinline__ void append_chunk(bool hit, int i, unsigned below,
                                             int ns, int* idx, int& cnt) {
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (mask != 0u) {                   // warp-uniform
    const int rank = cnt + __popc(mask & below);
    if (hit && rank < ns) idx[rank] = i;
    cnt += __popc(mask);
  }
}

// kStaged: the points are read from `cloud`, staged by stage_cloud in
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
  if constexpr (kStaged) {
    for (int base = 0; base < n; base += kStagedStep) {
      bool hit[kStagedChunks][kMaxRadii];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kStagedChunks; ++c) {
        const float4 p = cloud[base + 32 * c + lane];
        const float d2 = d2_rn(an, cx, cy, cz, p.x, p.y, p.z, p.w);
#pragma unroll
        for (int r = 0; r < kMaxRadii; ++r) {
          hit[c][r] = r < count && d2 < r2[r];
          any = any || hit[c][r];
        }
      }
      if (!__any_sync(0xffffffffu, any)) continue;  // warp-uniform
      bool full = true;
#pragma unroll
      for (int r = 0; r < kMaxRadii; ++r) {
        if (r < count) {
#pragma unroll
          for (int c = 0; c < kStagedChunks; ++c) {
            append_chunk(hit[c][r], base + 32 * c + lane, below, ns[r], idx[r], cnt[r]);
          }
          full = full && cnt[r] >= ns[r];
        }
      }
      if (full) break;  // cnt is warp-uniform, so is the exit
    }
  } else {
    // the next chunk's point is loaded before this chunk's is tested: the
    // loads do not wait for the counts, so their latency hides behind the
    // test (same values, same arithmetic, same decisions). Loading the
    // chunk coalesced and handing each lane its point by shuffle measured
    // slower.
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (lane < n) {
      nx = pts[3 * lane], ny = pts[3 * lane + 1], nz = pts[3 * lane + 2];
    }
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool real = i < n;
      const float px = nx, py = ny, pz = nz;
      if (i + 32 < n) {
        nx = pts[3 * (i + 32)], ny = pts[3 * (i + 32) + 1], nz = pts[3 * (i + 32) + 2];
      }
      const float d2 = real ? d2_rn(an, cx, cy, cz, px, py, pz, norm2_rn(px, py, pz)) : 0.f;
      bool full = true;
#pragma unroll
      for (int r = 0; r < kMaxRadii; ++r) {
        if (r < count) {
          append_chunk(real && d2 < r2[r], i, below, ns[r], idx[r], cnt[r]);
          full = full && cnt[r] >= ns[r];
        }
      }
      if (full) break;  // cnt is warp-uniform, so is the exit
    }
  }
}

// The point in slot s of a list with `hits` hits: the hit itself, padded
// with the first hit, point 0 when nothing is in radius.
__device__ __forceinline__ int slot_point(const int* idx, int hits, int s) {
  return s < hits ? idx[s] : (hits > 0 ? idx[0] : 0);
}

}  // namespace istnet
