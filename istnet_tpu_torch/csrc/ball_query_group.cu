// Multi-radius ball query + grouping for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/ball_query_pallas.py:
// _bq_group_kernel_t (and its untransposed twin _bq_group_kernel, which
// computes the same function). Per radius r and centroid c, the output row
// block is (ns, 3 + C) = [xyz[idx] - c, feats[idx]], where idx holds the
// first ns points with d2 < r^2 in index order, padded with the first hit,
// and point 0 in every slot when nothing is in radius
// (istnet_tpu/ops/golden.py:ball_query_golden).
//
// Types: xyz and centroids are f32; features f32 or bf16; the output f32 or
// bf16. Every value is formed in f32 (an exact upcast of a bf16 feature, or
// one f32 subtraction) and rounded once at the store, as the TPU kernel's
// out_dtype does (ball_query_pallas.py:513-519), so the bf16 output equals
// the plain version's f32 result cast to bf16.
//
// What bounds it: the stores at SA stages 2-4, the query at stage 1. The
// grouped tensor is (B, M, ns, 3 + C) per radius, ~100 MB per stage at B=32
// f32 (half in bf16), against ~1 MB of input; at stage 1 (C = 0, 9 MB) the
// camera radii fill few lists, so each centroid scans all N points. Design:
// one warp per centroid, 8 a block, the warps of an SM in different phases.
// - The block stages its cloud in shared memory once as (x, y, z, |p|^2),
//   so a 32-point chunk of the query costs one 16-byte shared load a lane.
// - Query: ball_query.cuh's warp_ball_query over the staged cloud, the
//   scan that kernel 8 runs over the same staging and kernel 5 from global
//   memory, so the three kernels keep equal lists (the backward recomputes
//   them with kernel 8).
// - Copy: a radius's (ns, 3 + C) block is one contiguous run. The rows of 3
//   + C elements are not vector-aligned, but the block is (ns * (3 + C) *
//   sizeof(out) % 16 == 0 on the path): the warp assembles `rows` slots at a
//   time in its shared buffer, from 16-byte feature loads (V elements, when
//   C % V == 0) several in flight a lane, then writes the chunk out with
//   16-byte stores. Widths or ns that leave a chunk unaligned take scalar
//   loads and stores on the same route (test shapes such as C = 7).
// - Cloud and buffers fit in 48 KB at every path shape. Where they do not
//   (N > ~2000, or 3 + C > ~1400 in f32, ~2800 in bf16), a second kernel
//   scans global memory and stores element by element.
// The TPU kernel's one-hot MXU extraction, triangular-matmul prefix sums
// and bf16 hi/mid/lo splits existed for Mosaic; a direct indexed load is
// exact here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ball_query.cuh"

namespace {

using istnet::kMaxNs;
using istnet::kMaxRadii;

constexpr int kWarps = 8;                // centroids per block
constexpr int kStageBytes = 4096;        // a warp's copy buffer, about
constexpr int kItemUnroll = 4;           // feature loads in flight a lane
// dynamic shared memory a block may take without an opt-in (48 KB in all,
// less the static lists)
constexpr size_t kDynamicSmem = 48 * 1024 - sizeof(int) * kWarps * kMaxRadii * kMaxNs;

struct Radii {
  float r2[kMaxRadii];
  int ns[kMaxRadii];
  int rows[kMaxRadii];      // slots assembled per chunk
  int vec_out[kMaxRadii];   // every chunk 16-byte aligned: vector stores
  void* out[kMaxRadii];
  int count;
  int stage_elems;          // output elements of one warp's buffer
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// V consecutive features from p (16-byte aligned when V > 1), as f32.
template <typename TFeat, int V>
__device__ __forceinline__ void load_item(const TFeat* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else if constexpr (sizeof(TFeat) == 4) {
    static_assert(V == 4, "f32 items are 16 bytes");
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    static_assert(V == 8, "bf16 items are 16 bytes");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {          // a bf16 is the top half of an f32
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// The radius's (ns, 3 + C) block of one centroid, assembled `rows` slots
// at a time in the warp's buffer `sb`, then stored. V: feature elements a
// load (16 bytes, or 1), 0 when there are no features.
template <typename TFeat, typename TOut, int V>
__device__ __forceinline__ void copy_block(
    TOut* __restrict__ o, TOut* sb, const int* list, int hits, int ns, int rows,
    bool vec, const float4* cloud, const TFeat* __restrict__ fbase, int cf,
    float cx, float cy, float cz) {
  const int lane = threadIdx.x & 31;
  const int c = 3 + cf;
  for (int s0 = 0; s0 < ns; s0 += rows) {
    const int kr = min(rows, ns - s0);
    for (int t = lane; t < 3 * kr; t += 32) {
      const int k = t / 3, ch = t - 3 * k;
      const int src = istnet::slot_point(list, hits, s0 + k);
      const float p = reinterpret_cast<const float*>(cloud + src)[ch];
      store(sb + k * c + ch, p - (ch == 0 ? cx : (ch == 1 ? cy : cz)));
    }
    if constexpr (V > 0) {
      // items of V features along (row, item), a lane's stride 32 items
      const int qpr = cf / V;
      const int dk = 32 / qpr, dq = 32 - dk * qpr;
      const int items = kr * qpr;
      int k = lane / qpr, q = lane - (lane / qpr) * qpr;
      for (int it0 = 0; it0 < items; it0 += 32 * kItemUnroll) {
        float v[kItemUnroll][V];
        int dst[kItemUnroll];
#pragma unroll
        for (int u = 0; u < kItemUnroll; ++u) {
          dst[u] = -1;
          if (it0 + 32 * u + lane < items) {
            const int src = istnet::slot_point(list, hits, s0 + k);
            load_item<TFeat, V>(fbase + static_cast<size_t>(src) * cf + q * V, v[u]);
            dst[u] = k * c + 3 + q * V;
          }
          k += dk;
          q += dq;
          if (q >= qpr) {
            q -= qpr;
            ++k;
          }
        }
#pragma unroll
        for (int u = 0; u < kItemUnroll; ++u) {
          if (dst[u] >= 0) {
#pragma unroll
            for (int e = 0; e < V; ++e) store(sb + dst[u] + e, v[u][e]);
          }
        }
      }
    }
    __syncwarp();
    const int elems = kr * c;
    if (vec) {
      const int nvec = elems * static_cast<int>(sizeof(TOut)) / 16;
      const uint4* from = reinterpret_cast<const uint4*>(sb);
      uint4* to = reinterpret_cast<uint4*>(o + s0 * c);
#pragma unroll 4
      for (int w = lane; w < nvec; w += 32) to[w] = from[w];
    } else {
      for (int t = lane; t < elems; t += 32) o[s0 * c + t] = sb[t];
    }
    __syncwarp();                             // the buffer is free again
  }
}

template <typename TFeat, typename TOut, int V>
__global__ void __launch_bounds__(kWarps * 32)
bq_group_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                const TFeat* __restrict__ feats, int n, int m, int cf,
                Radii radii) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_idx[kWarps][kMaxRadii][kMaxNs];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int j = blockIdx.x * kWarps + warp;
  float4* s_cloud = reinterpret_cast<float4*>(s_dyn);
  TOut* sb = reinterpret_cast<TOut*>(s_dyn + static_cast<size_t>(istnet::staged_points(n)) *
                                                  sizeof(float4)) +
             static_cast<size_t>(warp) * radii.stage_elems;

  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  istnet::stage_cloud<kWarps * 32>(pts, n, s_cloud);
  __syncthreads();
  if (j >= m) return;  // whole warp leaves together

  const float* cen = new_xyz + (static_cast<size_t>(b) * m + j) * 3;
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  int* const idx[kMaxRadii] = {s_idx[warp][0], s_idx[warp][1]};
  int cnt[kMaxRadii];
  istnet::warp_ball_query<true>(s_cloud, pts, n, cx, cy, cz, radii.r2, radii.ns,
                                radii.count, idx, cnt);
  __syncwarp();

  const TFeat* fbase = feats + static_cast<size_t>(b) * n * cf;
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {      // unrolled: cnt and idx stay in registers
    if (r < radii.count) {
      const int ns = radii.ns[r];
      TOut* o = static_cast<TOut*>(radii.out[r]) +
                (static_cast<size_t>(b) * m + j) * ns * (3 + cf);
      copy_block<TFeat, TOut, V>(o, sb, idx[r], min(cnt[r], ns), ns, radii.rows[r],
                                 radii.vec_out[r] != 0, s_cloud, fbase, cf, cx, cy, cz);
    }
  }
}

// A cloud and copy buffers too large for the block's shared memory (N >
// ~2000, or a row of 3 + C > ~1400 in f32, ~2800 in bf16; off the model's
// path): the scan reads global memory and each element is stored straight
// to global memory. A kernel of its own: as a branch of bq_group_kernel it
// cost that kernel registers and spills on the path.
template <typename TFeat, typename TOut>
__global__ void __launch_bounds__(kWarps * 32)
bq_group_global_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
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
  istnet::warp_ball_query<false>(nullptr, pts, n, cx, cy, cz, radii.r2, radii.ns,
                                 radii.count, idx, cnt);
  __syncwarp();

  const TFeat* fbase = feats + static_cast<size_t>(b) * n * cf;
  const int c = 3 + cf;
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r < radii.count) {
      const int ns = radii.ns[r];
      const int hits = min(cnt[r], ns);
      TOut* o = static_cast<TOut*>(radii.out[r]) + (static_cast<size_t>(b) * m + j) * ns * c;
      for (int k = 0; k < ns; ++k) {
        const int src = istnet::slot_point(idx[r], hits, k);
        for (int t = lane; t < c; t += 32) {
          const float v = t < 3 ? pts[3 * src + t] - (t == 0 ? cx : (t == 1 ? cy : cz))
                                : to_f32(fbase[static_cast<size_t>(src) * cf + t - 3]);
          store(o + static_cast<size_t>(k) * c + t, v);
        }
      }
    }
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename TFeat, typename TOut, int V>
cudaError_t launch(const float* xyz, const float* new_xyz, const void* feats,
                   int b, int n, int m, int cf, Radii radii, cudaStream_t s) {
  // per radius: slots a chunk, and whether every chunk is 16-byte aligned
  const int row_bytes = (3 + cf) * static_cast<int>(sizeof(TOut));
  const int align_rows = 16 / gcd(row_bytes, 16);
  int stage_rows = 1;
  for (int r = 0; r < radii.count; ++r) {
    const int ns = radii.ns[r];
    // vector stores need chunks of align_rows rows: wide rows that would
    // overflow the block's shared memory take the scalar ones
    const bool vec = (ns * row_bytes) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(radii.out[r]) % 16 == 0 &&
                     static_cast<size_t>(kWarps) * align_rows * row_bytes <= kDynamicSmem;
    const int fit = kStageBytes / row_bytes;
    int rows = ns;
    if (ns * row_bytes > kStageBytes) {
      rows = vec ? (fit / align_rows > 0 ? fit / align_rows * align_rows : align_rows)
                 : (fit > 0 ? fit : 1);
    }
    radii.rows[r] = rows;
    radii.vec_out[r] = vec ? 1 : 0;
    stage_rows = rows > stage_rows ? rows : stage_rows;
  }
  const int per16 = 16 / static_cast<int>(sizeof(TOut));
  radii.stage_elems = (stage_rows * (3 + cf) + per16 - 1) / per16 * per16;
  const size_t smem = static_cast<size_t>(kWarps) * radii.stage_elems * sizeof(TOut) +
                      static_cast<size_t>(istnet::staged_points(n)) * sizeof(float4);
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  const TFeat* f = static_cast<const TFeat*>(feats);
  if (smem <= kDynamicSmem) {
    bq_group_kernel<TFeat, TOut, V><<<grid, kWarps * 32, smem, s>>>(
        xyz, new_xyz, f, n, m, cf, radii);
  } else {
    bq_group_global_kernel<TFeat, TOut><<<grid, kWarps * 32, 0, s>>>(
        xyz, new_xyz, f, n, m, cf, radii);
  }
  return cudaGetLastError();
}

template <typename TFeat, typename TOut>
cudaError_t launch_items(const float* xyz, const float* new_xyz, const void* feats,
                         int b, int n, int m, int cf, const Radii& radii,
                         cudaStream_t s) {
  constexpr int kV = 16 / static_cast<int>(sizeof(TFeat));
  if (cf == 0) return launch<TFeat, TOut, 0>(xyz, new_xyz, feats, b, n, m, cf, radii, s);
  const bool aligned = cf % kV == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  return aligned ? launch<TFeat, TOut, kV>(xyz, new_xyz, feats, b, n, m, cf, radii, s)
                 : launch<TFeat, TOut, 1>(xyz, new_xyz, feats, b, n, m, cf, radii, s);
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
    e = out_bf16 ? launch_items<__nv_bfloat16, __nv_bfloat16>(xyz, new_xyz, feats, b, n, m, cf, radii, s)
                 : launch_items<__nv_bfloat16, float>(xyz, new_xyz, feats, b, n, m, cf, radii, s);
  } else {
    e = out_bf16 ? launch_items<float, __nv_bfloat16>(xyz, new_xyz, feats, b, n, m, cf, radii, s)
                 : launch_items<float, float>(xyz, new_xyz, feats, b, n, m, cf, radii, s);
  }
  return static_cast<int>(e);
}
