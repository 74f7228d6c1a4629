// The 3-NN search shared by the FP interpolation kernel (fp_interpolate.cu)
// and the 3-NN kernel of the FP backward (three_nn.cu), so that forward and
// backward pick the same neighbours.
//
// For one unknown point u: the 3 known points with the smallest d2 in
// (d2, index) order (a strict-< scan, as istnet_tpu/ops/golden.py:
// three_nn_golden), d2 in the JAX form (|u|^2 + |k|^2) - 2 u.k clamped at 0
// with every operation rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the term order of the plain PyTorch version
// (ops/pointnet2.py: pairwise_d2), so indices and distances come out
// bit-equal to it.
//
// Design. A block stages its cloud's known set once in shared memory as
// float4 (2x, 2y, 2z, |k|^2) (stage_known): doubling is exact, so the dot
// product with 2k is 2 u.k to the bit and the multiply by 2 goes. A group
// of kGroup lanes serves one unknown point: lane j of the group scans the
// known points j, j + kGroup, ... in ascending order, so every lane of a
// warp reads the same few consecutive float4s at a step (a shared-memory
// broadcast), and keeps a sorted top-3 in registers with a strict <, which
// leaves the lower index first among equal distances. The insertion is
// branch-free (3 compares, 10 selects): a warp tests 32 lanes x kUnroll
// pairs a step, and at the known-set sizes of the FP stages (M <= 512, so
// a lane's third distance is still high) some lane almost always inserts,
// so a branch around the insertion would run it for the whole warp anyway,
// after a test that costs as much. The group then merges its lanes' lists
// in log2(kGroup) shuffle rounds of a bitonic merge in (d2, index) order.
// Replaces a warp per point that restaged the known set for every 8 points
// and merged 32 lanes' lists per point.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace istnet {

constexpr int kGroup = 8;           // lanes a point: a power of 2 up to 32
constexpr int kUnroll = 4;          // known points a step of the scan
constexpr int kBlockThreads = 128;  // a block's threads
constexpr int kWarpPoints = 32 / kGroup;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "a group is a power of 2 of lanes of one warp");

__device__ __forceinline__ float nn_norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (d, i) before (bd, bi) in (d2, index) order.
__device__ __forceinline__ bool nn_before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// A sorted top-3: d[r] (the clamped d2) and i[r] of the r-th nearest point.
struct Nn3 {
  float d[3];
  int i[3];
};

// Block-wide: s_known[t] <- (2x, 2y, 2z, |k|^2) of the cloud's (m, 3)
// known points. Ends with a barrier.
__device__ __forceinline__ void stage_known(const float* __restrict__ kn, int m,
                                            float4* s_known) {
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const float x = kn[3 * t], y = kn[3 * t + 1], z = kn[3 * t + 2];
    s_known[t] = make_float4(2.f * x, 2.f * y, 2.f * z, nn_norm2(x, y, z));
  }
  __syncthreads();
}

// d2 before the clamp: (an + |k|^2) - 2 u.k, 2 u.k from the doubled k.
__device__ __forceinline__ float nn_raw(float an, float3 u, float4 q) {
  const float ab2 = __fadd_rn(__fadd_rn(__fmul_rn(u.x, q.x), __fmul_rn(u.y, q.y)),
                              __fmul_rn(u.z, q.z));
  return __fsub_rn(__fadd_rn(an, q.w), ab2);
}

// Insert known point k, at d2 max(raw, 0), into s: after its equals, so
// that a scan in ascending k keeps the lower index first among equals.
__device__ __forceinline__ void nn_insert(Nn3& s, float raw, int k) {
  const float v = fmaxf(raw, 0.f);
  const bool c0 = v < s.d[0], c1 = v < s.d[1], c2 = v < s.d[2];
  s.d[2] = c1 ? s.d[1] : (c2 ? v : s.d[2]);
  s.i[2] = c1 ? s.i[1] : (c2 ? k : s.i[2]);
  s.d[1] = c0 ? s.d[0] : (c1 ? v : s.d[1]);
  s.i[1] = c0 ? s.i[0] : (c1 ? k : s.i[1]);
  s.d[0] = c0 ? v : s.d[0];
  s.i[0] = c0 ? k : s.i[0];
}

// (da, ia), (db, ib) <- the two in (d2, index) order.
__device__ __forceinline__ void nn_exchange(float& da, int& ia, float& db, int& ib) {
  if (nn_before(db, ib, da, ia)) {
    const float td = da; da = db; db = td;
    const int ti = ia; ia = ib; ib = ti;
  }
}

// s <- the first 3 of s and the list of lane (lane ^ off), both sorted; the
// two lanes end with the same list. The smaller of s[x] and other[2 - x]
// are the 3 first of the 6 (a bitonic half-cleaner), then 3 exchanges sort
// them.
__device__ __forceinline__ void nn_merge(Nn3& s, int off) {
  float od[3];
  int oi[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    od[x] = __shfl_xor_sync(0xffffffffu, s.d[x], off);
    oi[x] = __shfl_xor_sync(0xffffffffu, s.i[x], off);
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    if (nn_before(od[2 - x], oi[2 - x], s.d[x], s.i[x])) {
      s.d[x] = od[2 - x];
      s.i[x] = oi[2 - x];
    }
  }
  nn_exchange(s.d[0], s.i[0], s.d[1], s.i[1]);
  nn_exchange(s.d[1], s.i[1], s.d[2], s.i[2]);
  nn_exchange(s.d[0], s.i[0], s.d[1], s.i[1]);
}

// Call with whole warps; m >= 3. s <- the 3 nearest known points of the
// group's point u, the same in every lane of the group.
__device__ __forceinline__ Nn3 group_three_nn(const float4* __restrict__ s_known,
                                              int m, float3 u) {
  const float an = nn_norm2(u.x, u.y, u.z);
  Nn3 s;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    s.d[x] = INFINITY;
    s.i[x] = INT_MAX;
  }
  int k = static_cast<int>(threadIdx.x % kGroup);
  for (; k + (kUnroll - 1) * kGroup < m; k += kUnroll * kGroup) {
    // a step's distances first, then their insertions in ascending k
    float raw[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) raw[t] = nn_raw(an, u, s_known[k + t * kGroup]);
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) nn_insert(s, raw[t], k + t * kGroup);
  }
  for (; k < m; k += kGroup) nn_insert(s, nn_raw(an, u, s_known[k]), k);
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) nn_merge(s, off);
  return s;
}

// The group's point: the block's blockDim.x / kGroup points, a group a
// point; past n the last point is searched again and never stored. Returns
// its index.
__device__ __forceinline__ int load_point(const float* __restrict__ unknown, int n,
                                          float3& u) {
  const int first = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / kGroup);
  const float* p = unknown + (static_cast<size_t>(blockIdx.y) * n + min(first, n - 1)) * 3;
  u = make_float3(p[0], p[1], p[2]);
  return first;
}

// The normalised inverse-distance weights of a top-3, as
// ops/pointnet2.py::three_interpolate_weights forms them from the
// distances: 1 / (sqrt(d2) + 1e-8) over their sum, the sum in the order
// torch.sum of 3 values takes on the card, (w0 + w2) + w1, so that the
// weights come out bit-equal to it there.
__device__ __forceinline__ void nn_weights(const Nn3& s, float (&w)[3]) {
#pragma unroll
  for (int x = 0; x < 3; ++x) w[x] = 1.0f / (sqrtf(s.d[x]) + 1e-8f);
  const float norm = (w[0] + w[2]) + w[1];
#pragma unroll
  for (int x = 0; x < 3; ++x) w[x] = w[x] / norm;
}

// Host side: the grid of n points a cloud over b clouds, kBlockThreads a
// block.
inline dim3 nn_grid(int b, int n) {
  constexpr int per_block = kBlockThreads / kGroup;
  return dim3((n + per_block - 1) / per_block, b);
}

}  // namespace istnet
