// Variants of the two backward scatters, for tools/scatter_variants_torch.py
// only (the port never builds or calls them): yardsticks that split a
// scatter's time into its parts, and the atomic rival of the owned, ordered
// gather of istnet_tpu_torch/csrc/scatter_invert.cuh.
//
// - read_flat: every element of the cotangent read once, 16 bytes a thread
//   where the tensor allows it, summed and never stored (a store only under
//   a condition no input meets): the memory rate these bytes can reach.
// - group_read_only: the previous atomic grouping scatter (one warp a
//   centroid, lanes along channels, the row's slots in order) with its
//   atomic adds replaced by register sums, stored under the same condition:
//   its read and its occupancy without its atomics.
// - group_atomic: the rival design: one warp a (centroid, radius, group of
//   16 slots), so the entries spread over 3x more warps; slots holding the
//   row's first hit (its pad slots, or every slot of a row without a hit)
//   summed in registers and added with one atomic, the other slots with one
//   atomic each; centroid_bar by 3 atomics a warp; both outputs zeroed by
//   the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__global__ void read_flat_kernel(const float4* __restrict__ x, long long n4, float* sink) {
  float acc = 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    acc += v.x + v.y + v.z + v.w;
  }
  if (acc == 1234.5f) sink[0] = acc;
}

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
group_read_only_kernel(const int* idx0, const int* idx1, const T* g0, const T* g1, int ns0,
                       int ns1, int m, int c, float* sink) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= m) return;
  const size_t row = static_cast<size_t>(b) * m + j;
  float acc = 0.f;
  for (int r = 0; r < 2; ++r) {
    const int ns = r ? ns1 : ns0;
    const int* idx = (r ? idx1 : idx0) + row * ns;
    const T* g = (r ? g1 : g0) + row * ns * c;
    const int first = idx[0];
    for (int ch = lane; ch < c; ch += 32) {
      float at_first = to_f32(g[ch]), other = 0.f;
      for (int s = 1; s < ns; ++s) {
        const float v = to_f32(g[static_cast<size_t>(s) * c + ch]);
        if (idx[s] == first) at_first += v; else other += v;
      }
      acc += at_first + other;
    }
  }
  if (acc == 1234.5f) sink[0] = acc;
}

constexpr int kGroup = 16;  // slots a warp

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
group_atomic_kernel(const int* idx0, const int* idx1, const T* g0, const T* g1, int ns0,
                    int ns1, int b_count, int n, int m, int c, float* points_bar,
                    float* centroid_bar) {
  const int lane = threadIdx.x & 31;
  const int groups0 = (ns0 + kGroup - 1) / kGroup, groups1 = (ns1 + kGroup - 1) / kGroup;
  const long long item = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5);
  const int per_row = groups0 + groups1;
  if (item >= static_cast<long long>(b_count) * m * per_row) return;
  const int q = static_cast<int>(item % per_row);
  const size_t row = static_cast<size_t>(item / per_row);  // b * m + j
  const int b = static_cast<int>(row / m);
  const int r = q >= groups0;
  const int ns = r ? ns1 : ns0;
  const int s0 = (r ? q - groups0 : q) * kGroup, s1 = min(s0 + kGroup, ns);
  const int* idx = (r ? idx1 : idx0) + row * ns;
  const T* g = (r ? g1 : g0) + row * ns * c;
  float* pb = points_bar + static_cast<size_t>(b) * n * c;
  const int first = idx[0];
  float cbar = 0.f;
  for (int ch = lane; ch < c; ch += 32) {
    float at_first = 0.f, slot_sum = 0.f;
    bool any_first = false;
    for (int s = s0; s < s1; ++s) {
      const float v = to_f32(g[static_cast<size_t>(s) * c + ch]);
      slot_sum += v;
      const int p = idx[s];
      if (p == first) {
        at_first += v;
        any_first = true;
      } else {
        atomicAdd(pb + static_cast<size_t>(p) * c + ch, v);
      }
    }
    if (any_first) atomicAdd(pb + static_cast<size_t>(first) * c + ch, at_first);
    if (ch < 3) cbar = slot_sum;
  }
  if (lane < 3) atomicAdd(centroid_bar + row * 3 + lane, -cbar);
}

}  // namespace

extern "C" int variants_read_flat(const float* x, long long n_floats, float* sink,
                                  void* stream) {
  const long long n4 = n_floats / 4;
  read_flat_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), n4, sink);
  return static_cast<int>(cudaGetLastError());
}

// Two radii: idx[r] (b, m, ns[r]) int32, grad[r] (b, m, ns[r], c) f32 or
// bf16 if bf16.
extern "C" int variants_group_read_only(const int* idx0, const int* idx1, const void* g0,
                                        const void* g1, int ns0, int ns1, int b, int m,
                                        int c, int bf16, float* sink, void* stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    group_read_only_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        idx0, idx1, static_cast<const __nv_bfloat16*>(g0),
        static_cast<const __nv_bfloat16*>(g1), ns0, ns1, m, c, sink);
  } else {
    group_read_only_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        idx0, idx1, static_cast<const float*>(g0), static_cast<const float*>(g1), ns0, ns1,
        m, c, sink);
  }
  return static_cast<int>(cudaGetLastError());
}

// As variants_group_read_only; points_bar (b, n, c) and centroid_bar (b,
// m, 3) f32, zeroed by the caller.
extern "C" int variants_group_atomic(const int* idx0, const int* idx1, const void* g0,
                                     const void* g1, int ns0, int ns1, int b, int n, int m,
                                     int c, int bf16, float* points_bar, float* centroid_bar,
                                     void* stream) {
  const long long items = static_cast<long long>(b) * m *
                          ((ns0 + kGroup - 1) / kGroup + (ns1 + kGroup - 1) / kGroup);
  const int grid = static_cast<int>((items + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    group_atomic_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        idx0, idx1, static_cast<const __nv_bfloat16*>(g0),
        static_cast<const __nv_bfloat16*>(g1), ns0, ns1, b, n, m, c, points_bar,
        centroid_bar);
  } else {
    group_atomic_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        idx0, idx1, static_cast<const float*>(g0), static_cast<const float*>(g1), ns0, ns1,
        b, n, m, c, points_bar, centroid_bar);
  }
  return static_cast<int>(cudaGetLastError());
}
