// The warp-wide 3-NN search shared by the FP interpolation kernel
// (fp_interpolate.cu) and the 3-NN kernel of the FP backward (three_nn.cu).
//
// For one unknown point u: the 3 known points with the smallest d2 in
// (d2, index) order (a strict-< scan, as istnet_tpu/ops/golden.py:
// three_nn_golden), d2 in the JAX form (|u|^2 + |k|^2) - 2 u.k clamped at 0
// with every operation rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the term order of the plain PyTorch version
// (ops/pointnet2.py: pairwise_d2). The block first stages the known set of
// its cloud in shared memory (load_known); then each lane keeps a sorted
// top-3 of the indices it scans (lane, lane + 32, ...: ascending, so strict
// < keeps the lowest index first among equals), and three warp-wide
// (d2, index) argmin rounds merge the lanes' lists. Both kernels call this
// code, so the forward and the backward pick the same neighbours.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace istnet {

__device__ __forceinline__ float nn_norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (d, i) before (bd, bi) in (d2, index) order.
__device__ __forceinline__ bool nn_before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Block-wide: s_known[0, 3m) <- the cloud's (m, 3) coordinates, s_norm[0, m)
// <- their squared norms. Ends with a barrier.
__device__ __forceinline__ void load_known(const float* __restrict__ kn, int m,
                                           float* s_known, float* s_norm) {
  for (int t = threadIdx.x; t < 3 * m; t += blockDim.x) s_known[t] = kn[t];
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    s_norm[t] = nn_norm2(s_known[3 * t], s_known[3 * t + 1], s_known[3 * t + 2]);
  }
  __syncthreads();
}

// Call with the whole warp; m >= 3. sel_d[r] (the clamped d2) and sel_i[r]
// of the r-th nearest known point, the same in every lane.
__device__ __forceinline__ void warp_three_nn(const float* s_known,
                                              const float* s_norm, int m,
                                              float ux, float uy, float uz,
                                              float (&sel_d)[3], int (&sel_i)[3]) {
  const int lane = threadIdx.x & 31;
  const float an = nn_norm2(ux, uy, uz);
  float d[3] = {INFINITY, INFINITY, INFINITY};
  int id[3] = {INT_MAX, INT_MAX, INT_MAX};
  for (int k = lane; k < m; k += 32) {
    const float ab = __fadd_rn(__fadd_rn(__fmul_rn(ux, s_known[3 * k]),
                                         __fmul_rn(uy, s_known[3 * k + 1])),
                               __fmul_rn(uz, s_known[3 * k + 2]));
    const float d2 = fmaxf(__fsub_rn(__fadd_rn(an, s_norm[k]), __fmul_rn(2.f, ab)), 0.f);
    if (d2 < d[0]) {
      d[2] = d[1]; id[2] = id[1];
      d[1] = d[0]; id[1] = id[0];
      d[0] = d2; id[0] = k;
    } else if (d2 < d[1]) {
      d[2] = d[1]; id[2] = id[1];
      d[1] = d2; id[1] = k;
    } else if (d2 < d[2]) {
      d[2] = d2; id[2] = k;
    }
  }

  // merge: three rounds of a warp-wide argmin over the lanes' list heads
  int head = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float bd = head == 0 ? d[0] : (head == 1 ? d[1] : (head == 2 ? d[2] : INFINITY));
    int bi = head == 0 ? id[0] : (head == 1 ? id[1] : (head == 2 ? id[2] : INT_MAX));
    const int mine = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (nn_before(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    sel_d[r] = bd;
    sel_i[r] = bi;
    if (mine == bi) ++head;  // indices are unique to their lane
  }
}

}  // namespace istnet
