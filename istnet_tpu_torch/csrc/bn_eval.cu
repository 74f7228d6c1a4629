// Eval BatchNorm and the elementwise op that consumes it, in one pass:
//   y = act(bn(x) [+ r]),  bn(x) = ((x - mean) * invstd) * weight + bias
// over a dense map whose channels are its innermost axis (the channel of an
// element is its memory offset mod C), in bf16 or float32.
//
// Replaces no TPU kernel: the JAX package leaves the eval BatchNorm of
// istnet_tpu/nn/layers.py:151-220 (and the ReLU, residual add or PReLU
// after it) to XLA, which fuses them into the convolution's consumer. In
// PyTorch the same arithmetic ran as about eight launches a BN (a cast to
// float32, four broadcasting passes, the rsqrt of the variance, a cast back,
// then the consumer), each a full pass over the map.
//
// Arithmetic, exactly that of nn/layers.py::BatchNorm and its consumer:
// the BN in float32, each step rounded on its own (__fsub_rn / __fmul_rn /
// __fadd_rn, so that nothing contracts into an FMA), one rounding to the
// input's type (round to nearest even); then, in that type as PyTorch
// computes it, the residual add (float sum, one rounding), ReLU (NaN kept,
// as clamp_min does) or PReLU (the slope rounded to the type, its product
// rounded once). rows (4, C) float32 = [mean, invstd, weight, bias], invstd
// being torch.rsqrt(running_var + eps) as BatchNorm.invstd() gives it.
//
// What bounds it: bytes. x in, r in, y out, at 3.35 TB/s; the arithmetic
// is ~8 operations an element. Design: 16-byte loads and stores, two in
// flight a thread (8 bf16 or 4 float32 values each); the grid fills the
// card once (blocks a SM from the occupancy calculator) and strides over
// the map, the stride a whole number of rows' vectors, so that a thread
// keeps the same channels throughout and holds their four constants in
// registers, loaded once. A map with C off the vector width, or a pointer
// off a 16-byte boundary, takes the scalar kernel (channel = offset mod C
// per element, constants through the read-only cache).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Act { kNone = 0, kRelu = 1, kPrelu = 2, kAddRelu = 3 };

struct F32 {
  using Raw = float;
  static constexpr int kVec = 4;
  __device__ static float load(Raw v) { return v; }
  __device__ static Raw store(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

struct BF16 {
  using Raw = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float load(Raw v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
  __device__ static Raw store(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static float round(float v) { return load(store(v)); }
};

template <class Tr>
union Pack {
  uint4 u;
  typename Tr::Raw e[Tr::kVec];
};

// one element: the BN in float32, rounded to the type, then the consumer
template <class Tr, int ACT>
__device__ __forceinline__ float bn_act(float x, float mean, float invstd, float w, float b,
                                        float r, float slope) {
  float v = Tr::round(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), invstd), w), b));
  if (ACT == kAddRelu) v = Tr::round(__fadd_rn(v, r));
  if (ACT == kRelu || ACT == kAddRelu) v = isnan(v) ? v : fmaxf(v, 0.f);
  if (ACT == kPrelu) v = v >= 0.f ? v : Tr::round(__fmul_rn(slope, v));
  return v;
}

// the vector path: nvec 16-byte vectors, cpr of them a row of C channels;
// the grid's stride in vectors is a multiple of cpr
template <class Tr, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_eval_kernel(const uint4* __restrict__ x, const float* __restrict__ rows,
                   const uint4* __restrict__ res, const float* __restrict__ slope_p,
                   uint4* __restrict__ y, long long nvec, int c, int cpr) {
  constexpr int V = Tr::kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int c0 = static_cast<int>(v % cpr) * V;
  float mean[V], invstd[V], w[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = __ldg(rows + c0 + j);
    invstd[j] = __ldg(rows + c + c0 + j);
    w[j] = __ldg(rows + 2 * c + c0 + j);
    b[j] = __ldg(rows + 3 * c + c0 + j);
  }
  const float slope = ACT == kPrelu ? Tr::round(__ldg(slope_p)) : 0.f;

  auto one = [&](const Pack<Tr>& px, const Pack<Tr>& pr) {
    Pack<Tr> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float rv = ACT == kAddRelu ? Tr::load(pr.e[j]) : 0.f;
      out.e[j] = Tr::store(
          bn_act<Tr, ACT>(Tr::load(px.e[j]), mean[j], invstd[j], w[j], b[j], rv, slope));
    }
    return out;
  };

  for (; v + stride < nvec; v += 2 * stride) {
    Pack<Tr> p0, p1, r0, r1;
    p0.u = __ldg(x + v);
    p1.u = __ldg(x + v + stride);
    if (ACT == kAddRelu) {
      r0.u = __ldg(res + v);
      r1.u = __ldg(res + v + stride);
    }
    y[v] = one(p0, r0).u;
    y[v + stride] = one(p1, r1).u;
  }
  if (v < nvec) {
    Pack<Tr> p0, r0;
    p0.u = __ldg(x + v);
    if (ACT == kAddRelu) r0.u = __ldg(res + v);
    y[v] = one(p0, r0).u;
  }
}

// any C, any alignment: one element a step, its channel its offset mod C
template <class Tr, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_eval_scalar_kernel(const typename Tr::Raw* __restrict__ x, const float* __restrict__ rows,
                          const typename Tr::Raw* __restrict__ res,
                          const float* __restrict__ slope_p, typename Tr::Raw* __restrict__ y,
                          long long n, int c) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const float slope = ACT == kPrelu ? Tr::round(__ldg(slope_p)) : 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int ch = static_cast<int>(i % c);
    const float rv = ACT == kAddRelu ? Tr::load(res[i]) : 0.f;
    y[i] = Tr::store(bn_act<Tr, ACT>(Tr::load(x[i]), __ldg(rows + ch), __ldg(rows + c + ch),
                                     __ldg(rows + 2 * c + ch), __ldg(rows + 3 * c + ch), rv,
                                     slope));
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    counts[dev] = 132;
  }
  return counts[dev];
}

template <class K>
int blocks_per_sm(K kernel) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0) != cudaSuccess ||
      blocks < 1) {
    return 1;
  }
  return blocks;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <class Tr, int ACT>
int launch(const void* x, const float* rows, const void* res, const float* slope, void* y,
           long long n, int c, cudaStream_t s) {
  using Raw = typename Tr::Raw;
  constexpr int V = Tr::kVec;
  const long long fill = static_cast<long long>(sm_count());
  if (c % V == 0 && aligned16(x) && aligned16(y) && (res == nullptr || aligned16(res))) {
    static const int per_sm = blocks_per_sm(bn_eval_kernel<Tr, ACT>);
    const long long nvec = n / V;
    const int cpr = c / V;
    // a multiple of this many blocks keeps the stride a whole number of rows
    const long long unit = cpr / gcd_ll(cpr, kThreads);
    long long blocks = (nvec + 2LL * kThreads - 1) / (2LL * kThreads);
    if (blocks > fill * per_sm) blocks = fill * per_sm;
    blocks = (blocks + unit - 1) / unit * unit;
    bn_eval_kernel<Tr, ACT><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), rows, static_cast<const uint4*>(res), slope,
        static_cast<uint4*>(y), nvec, c, cpr);
  } else {
    static const int per_sm = blocks_per_sm(bn_eval_scalar_kernel<Tr, ACT>);
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > fill * per_sm) blocks = fill * per_sm;
    bn_eval_scalar_kernel<Tr, ACT><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const Raw*>(x), rows, static_cast<const Raw*>(res), slope,
        static_cast<Raw*>(y), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Tr>
int launch_act(const void* x, const float* rows, const void* res, const float* slope, void* y,
               long long n, int c, int act, cudaStream_t s) {
  switch (act) {
    case kNone: return launch<Tr, kNone>(x, rows, nullptr, nullptr, y, n, c, s);
    case kRelu: return launch<Tr, kRelu>(x, rows, nullptr, nullptr, y, n, c, s);
    case kPrelu: return launch<Tr, kPrelu>(x, rows, nullptr, slope, y, n, c, s);
    case kAddRelu: return launch<Tr, kAddRelu>(x, rows, res, nullptr, y, n, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, res, y: n values of bf16 (bf16 != 0) or float32, C innermost; rows
// (4, C) float32; res only with act 3 (residual add + ReLU), slope (one
// float32) only with act 2 (PReLU).
extern "C" int istnet_bn_eval(const void* x, const float* rows, const void* res,
                              const float* slope, void* y, long long n, int c, int act, int bf16,
                              void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || act < kNone || act > kAddRelu ||
      (act == kAddRelu) != (res != nullptr) || (act == kPrelu) != (slope != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_act<BF16>(x, rows, res, slope, y, n, c, act, s)
              : launch_act<F32>(x, rows, res, slope, y, n, c, act, s);
}
