// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel istnet_tpu/ops/fps_pallas.py:_fps_kernel.
// Contract (istnet_tpu/ops/golden.py:fps_golden): the first index is 0; a
// running min of d2 per point, seeded with 1e10; d2 by direct differences
// ((dx*dx + dy*dy) + dz*dz, each operation rounded, no FMA contraction so
// that it equals the plain PyTorch version bit for bit); each step takes
// the argmax, ties to the lowest index.
//
// What bounds it: the latency of one step. The npoint loop is sequential
// (each step needs the point the step before chose) and a cloud is 12 KB,
// so bytes and FLOPs are far below the card's rates; a forward is 956
// dependent steps. Design, per step:
// - one block a cloud, its threads sized to N (the table in
//   istnet_fps): one warp at N <= 256, so stages 3-4 have no block
//   barrier at all; 2, 4, 8 warps at N <= 512, 1024, 2048, each thread
//   holding 8 points and their running minima in registers; past 2048
//   (no shipped config), 16 warps of 8 or 16 points at N <= 4096, 8192,
//   their cloud copy above the 48 KB of static shared memory;
// - a thread's argmax is a tree over its points (lower index on the left,
//   so ties keep it); the warp's is two redux.sync: the max of the minima's
//   bits (d2 >= 0, so its bits order as unsigned integers), then the min
//   index among the lanes that hold it;
// - across warps, one barrier a step: each warp writes its (bits, index)
//   into a shared array double-buffered by step parity, and every thread
//   reduces the WARPS entries itself (no broadcast, no second barrier);
// - the chosen point's coordinates come from the cloud's copy in shared
//   memory, one 16-byte broadcast load.
// Padding points (index >= n) hold a minimum of 0 and an index above every
// real one, so they never win: when every real minimum is 0, a real point
// ties them at a lower index.
//
// Clouds past 8192 points (fps_stream_kernel) no longer fit in registers:
// 32 warps walk the cloud in global memory (it stays in L2 from step to
// step), each thread its points tid, tid + 1024, ... in ascending order;
// the running minima live in shared memory up to kSharedMinimaMax points
// and in a global workspace of the caller's beyond; the chosen point's
// coordinates come from global memory. The reductions are the ones above.
#include <cuda_runtime.h>

namespace {

// the stream kernel keeps a cloud's minima in shared memory up to this
// many points; ops/fps.py allocates the workspace past it (keep in step)
constexpr int kSharedMinimaMax = 51200;
constexpr int kStreamWarps = 32;
// a block's shared memory on the H100: 227 KB
static_assert(kSharedMinimaMax * sizeof(float) + 2 * kStreamWarps * 8 <=
              227 * 1024, "the stream kernel's minima must fit a block");

template <int WARPS, int PER>
__global__ void __launch_bounds__(WARPS * 32)
fps_kernel(const float* __restrict__ xyz, int n, int npoint,
           int* __restrict__ out) {
  constexpr int kThreads = WARPS * 32;
  extern __shared__ float4 s_pts[];           // n points, w unused
  __shared__ uint2 s_win[2][WARPS];           // (bits, index) per warp

  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float px[PER], py[PER], pz[PER], mind[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * kThreads;
    px[k] = py[k] = pz[k] = 0.f;
    mind[k] = 0.f;                            // padding: never wins
    if (i < n) {
      px[k] = cloud[3 * i];
      py[k] = cloud[3 * i + 1];
      pz[k] = cloud[3 * i + 2];
      mind[k] = 1e10f;
      s_pts[i] = make_float4(px[k], py[k], pz[k], 0.f);
    }
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  float4 last = s_pts[0];
  for (int j = 1; j < npoint; ++j) {
    unsigned cb[PER];
    unsigned ci[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const float dx = __fsub_rn(px[k], last.x);
      const float dy = __fsub_rn(py[k], last.y);
      const float dz = __fsub_rn(pz[k], last.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      mind[k] = fminf(mind[k], d2);
      cb[k] = __float_as_uint(mind[k]);
      ci[k] = static_cast<unsigned>(tid + k * kThreads);
    }
    // the thread's argmax: the right side wins only when strictly larger
#pragma unroll
    for (int step = 1; step < PER; step <<= 1) {
#pragma unroll
      for (int k = 0; k + step < PER; k += 2 * step) {
        const bool right = cb[k + step] > cb[k];
        cb[k] = right ? cb[k + step] : cb[k];
        ci[k] = right ? ci[k + step] : ci[k];
      }
    }
    const unsigned wmax = __reduce_max_sync(0xffffffffu, cb[0]);
    unsigned win = __reduce_min_sync(0xffffffffu,
                                     cb[0] == wmax ? ci[0] : 0xffffffffu);
    if constexpr (WARPS > 1) {
      uint2* slot = s_win[j & 1];
      if (lane == 0) slot[warp] = make_uint2(wmax, win);
      __syncthreads();
      uint2 best = slot[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        const uint2 e = slot[w];
        // warps hold interleaved indices: compare the index on a tie
        if (e.x > best.x || (e.x == best.x && e.y < best.y)) best = e;
      }
      win = best.y;
    }
    if (tid == 0) o[j] = static_cast<int>(win);
    last = s_pts[win];
  }
}

__global__ void __launch_bounds__(kStreamWarps * 32)
fps_stream_kernel(const float* __restrict__ xyz, int n, int npoint,
                  float* __restrict__ work, int* __restrict__ out) {
  constexpr int kThreads = kStreamWarps * 32;
  extern __shared__ float s_min[];             // n minima, or unused
  __shared__ uint2 s_win[2][kStreamWarps];     // (bits, index) per warp

  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* mind = work != nullptr ? work + static_cast<size_t>(blockIdx.x) * n
                                : s_min;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // each minimum is read and written by its own thread only
  for (int i = tid; i < n; i += kThreads) mind[i] = 1e10f;
  if (tid == 0) o[0] = 0;

  float lx = cloud[0], ly = cloud[1], lz = cloud[2];
  for (int j = 1; j < npoint; ++j) {
    // the thread's argmax in ascending index: a later point wins only when
    // strictly larger; a thread without points offers (0, ~0u), which
    // loses every tie
    unsigned bb = 0u, bi = 0xffffffffu;
    for (int i = tid; i < n; i += kThreads) {
      const float dx = __fsub_rn(cloud[3 * i], lx);
      const float dy = __fsub_rn(cloud[3 * i + 1], ly);
      const float dz = __fsub_rn(cloud[3 * i + 2], lz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float m = fminf(mind[i], d2);
      mind[i] = m;
      const unsigned mb = __float_as_uint(m);
      if (mb > bb || bi == 0xffffffffu) {
        bb = mb;
        bi = static_cast<unsigned>(i);
      }
    }
    const unsigned wmax = __reduce_max_sync(0xffffffffu, bb);
    const unsigned wwin = __reduce_min_sync(0xffffffffu,
                                            bb == wmax ? bi : 0xffffffffu);
    uint2* slot = s_win[j & 1];
    if (lane == 0) slot[warp] = make_uint2(wmax, wwin);
    __syncthreads();
    uint2 best = slot[0];
#pragma unroll
    for (int w = 1; w < kStreamWarps; ++w) {
      const uint2 e = slot[w];
      if (e.x > best.x || (e.x == best.x && e.y < best.y)) best = e;
    }
    if (tid == 0) o[j] = static_cast<int>(best.y);
    lx = cloud[3 * best.y];
    ly = cloud[3 * best.y + 1];
    lz = cloud[3 * best.y + 2];
  }
}

// a launch asking for more than 48 KB of dynamic shared memory is refused
// unless the kernel's limit was raised first (on the current device)
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int WARPS, int PER>
cudaError_t launch(const float* xyz, int b, int n, int npoint, int* out,
                   cudaStream_t s) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float4);
  const cudaError_t e = allow_shared(fps_kernel<WARPS, PER>, smem);
  if (e != cudaSuccess) return e;
  fps_kernel<WARPS, PER><<<b, WARPS * 32, smem, s>>>(xyz, n, npoint, out);
  return cudaGetLastError();
}

cudaError_t launch_stream(const float* xyz, int b, int n, int npoint,
                          float* work, int* out, cudaStream_t s) {
  const size_t smem = work != nullptr ? 0 : static_cast<size_t>(n) * sizeof(float);
  const cudaError_t e = allow_shared(fps_stream_kernel, smem);
  if (e != cudaSuccess) return e;
  fps_stream_kernel<<<b, kStreamWarps * 32, smem, s>>>(xyz, n, npoint, work, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) f32 contiguous -> out (b, npoint) int32, any n >= 1.
// Threads a cloud by n: (warps, points a thread); past 8192 points the
// stream kernel, whose minima need `work` (b * n floats) past
// kSharedMinimaMax points and nothing (null) below.
extern "C" int istnet_fps(const float* xyz, int b, int n, int npoint, int* out,
                          float* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((n > kSharedMinimaMax) != (work != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || npoint <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t e;
  if (n <= 128) {
    e = launch<1, 4>(xyz, b, n, npoint, out, s);
  } else if (n <= 256) {
    e = launch<1, 8>(xyz, b, n, npoint, out, s);
  } else if (n <= 512) {
    e = launch<2, 8>(xyz, b, n, npoint, out, s);
  } else if (n <= 1024) {
    e = launch<4, 8>(xyz, b, n, npoint, out, s);
  } else if (n <= 2048) {
    e = launch<8, 8>(xyz, b, n, npoint, out, s);
  } else if (n <= 4096) {
    e = launch<16, 8>(xyz, b, n, npoint, out, s);
  } else if (n <= 8192) {
    e = launch<16, 16>(xyz, b, n, npoint, out, s);
  } else {
    e = launch_stream(xyz, b, n, npoint, work, out, s);
  }
  return static_cast<int>(e);
}
