// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/fps_pallas.py:_fps_kernel.
// Contract (istnet_tpu/ops/golden.py:fps_golden): the first index is 0; a
// running min of d2 per point, seeded with 1e10; d2 by direct differences
// ((dx*dx + dy*dy) + dz*dz, each operation rounded, no FMA contraction so
// that it equals the plain PyTorch version bit for bit); each step takes
// the argmax, ties to the lowest index.
//
// What bounds it: the npoint loop is sequential and every step ends in a
// block-wide argmax, so the cost is the latency of npoint reductions and
// barriers, not bytes or FLOPs (a cloud is 12 KB). Design: one block per
// cloud; the cloud sits in shared memory and each thread keeps its points
// and their running minima in registers; a step is one distance update,
// a warp-shuffle argmax over (value, index) pairs, and one cross-warp pass
// by warp 0. B=32 clouds fill only 32 of the 132 SMs; several clouds per
// SM or a cluster per cloud are for a later change.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): larger value, or the same value at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint,
           int* __restrict__ out) {
  extern __shared__ float s_xyz[];  // 3 * n
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_best;

  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  for (int t = threadIdx.x; t < 3 * n; t += kThreads) s_xyz[t] = cloud[t];
  __syncthreads();

  float px[PER], py[PER], pz[PER], mind[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const bool real = i < n;
    px[k] = real ? s_xyz[3 * i] : 0.f;
    py[k] = real ? s_xyz[3 * i + 1] : 0.f;
    pz[k] = real ? s_xyz[3 * i + 2] : 0.f;
    mind[k] = 1e10f;
  }
  if (threadIdx.x == 0) o[0] = 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = s_xyz[3 * last];
    const float ly = s_xyz[3 * last + 1];
    const float lz = s_xyz[3 * last + 2];
    float bv = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n) {
        const float dx = __fsub_rn(px[k], lx);
        const float dy = __fsub_rn(py[k], ly);
        const float dz = __fsub_rn(pz[k], lz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        mind[k] = fminf(mind[k], d2);
        if (better(mind[k], i, bv, bi)) {
          bv = mind[k];
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_val[lane] : -FLT_MAX;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_best = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    last = s_best;
  }
}

}  // namespace

// xyz (b, n, 3) f32 contiguous -> out (b, npoint) int32. n <= 8 * 256.
extern "C" int istnet_fps(const float* xyz, int b, int n, int npoint, int* out,
                          void* stream) {
  const size_t smem = static_cast<size_t>(3) * n * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (n + kThreads - 1) / kThreads;
  if (b <= 0 || npoint <= 0) return static_cast<int>(cudaSuccess);
  if (per <= 1) {
    fps_kernel<1><<<b, kThreads, smem, s>>>(xyz, n, npoint, out);
  } else if (per <= 2) {
    fps_kernel<2><<<b, kThreads, smem, s>>>(xyz, n, npoint, out);
  } else if (per <= 4) {
    fps_kernel<4><<<b, kThreads, smem, s>>>(xyz, n, npoint, out);
  } else if (per <= 8) {
    fps_kernel<8><<<b, kThreads, smem, s>>>(xyz, n, npoint, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
