// Fold-upsample conv for Hopper (sm_90a): conv3x3(pad 1) of the x2
// align-corners bilinear upsampling of x, plus bias, with an optional
// eval-BatchNorm + PReLU epilogue.
//
// Replaces the TPU kernel istnet_tpu/ops/fold_upsample_pallas.py:_kernel
// (PSPUpsample's up_2 at eval: (B, 48, 48, 256) -> (B, 96, 96, 64)).
// Epilogue rows ep (5, cout) = [mean, invstd, scale, bias, alpha], applied
// in the order of fold_upsample_pallas.py:96-107: y = conv + b;
// t = (y - mean) * invstd; t = t * scale + bias; out = t >= 0 ? t : alpha*t.
//
// Like the TPU kernel (and the plain version, nn/layers.py:
// conv3x3_on_doubled), it reassociates by linearity: the channel
// contraction runs once per LOW-resolution pixel and tap, and the x2
// interpolation is applied after it. Two stages on one stream:
//   1. y = x (B*h*w, cin) @ km (cin, 9*cout), km[ci, (dy, dx, c)] = k[dy,
//      dx, ci, c]: a tiled f32 GEMM (128 x 64 block tile, 8 x 4 per thread,
//      k-slabs of 8 through shared memory);
//   2. out[b, i, j, c] = bias[c] + sum over taps (dy, dx) of the
//      align-corners lerp of y[b, :, :, dy, dx, c] at doubled-map position
//      (i + dy - 1, j + dx - 1), zero outside [0, 2h) x [0, 2w) (the conv's
//      zero padding); then the epilogue. One thread per output pixel and 64
//      channels, four corner rows of y per tap read as float4s through L1.
// The interpolation taps (lo, hi, w_lo, w_hi per output row and column)
// come from the host, built from the same f64 matrix as the plain version.
//
// What bounds it: the GEMM's FLOPs. 2 * B*h*w * cin * 9*cout = 21.7 GFLOP
// at B=32, on the CUDA cores (f32: no tensor cores under the f32 policy),
// ~0.33 ms at the 67 TFLOP/s peak; y is 170 MB, written once and read
// about once through L2. Convolving the doubled map directly instead costs
// 4x the FLOPs (87 GFLOP) and measured slower than the plain version
// (PERF.md). The TPU kernel kept y in VMEM; here it goes through device
// memory, which at 3.35 TB/s costs ~0.1 ms.
//
// bf16 (the bf16 policy's up_2): x, k, bias, the scratch and the output are
// bf16; the GEMM accumulates exact bf16 products in f32. The kernel rounds
// where the plain bf16 fold rounds: the GEMM output y (stored bf16), the
// row-interpolated map t = S_y (x) y, the column-interpolated output, and
// the bias add; then the epilogue runs in f32, rounds to bf16, and PReLU
// multiplies by the bf16 slope with one more rounding
// (fold_upsample_pallas.py:96-107). The interpolation weights come in
// rounded to bf16, as the plain version casts its matrices to x.dtype
// (w_lo + w_hi != 1 in general). Stage 2 then recomputes, per output
// pixel, the two row-interpolated columns of each of its three column taps
// (6 rows of y each), rounds each to bf16, and sums them with the column
// weights: the same 36 row reads per pixel and channel as the f32 stage.
// The GEMM runs on the CUDA cores, as in f32; tensor cores (mma/wgmma) are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_f32(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
// v rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- stage 1: C (m, n) = A (m, k) @ B (k, n), row-major, f32 sums ----------
constexpr int kBM = 128, kBN = 64, kBK = 8;
constexpr int kTM = 8, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float s_a[kBK][kBM];  // transposed: s_a[kk][row]
  __shared__ __align__(16) float s_b[kBK][kBN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tr = tid / (kBN / kTN);  // 0..15: rows tr*8 .. tr*8+7
  const int tc = tid % (kBN / kTN);  // 0..15: cols tc*4 .. tc*4+3

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // tile loaders: A 128 x 8 (4 per thread), B 8 x 64 (2 per thread)
  const int a_row = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / 32, b_col = (tid % 32) * 2;
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + a_row, kk = k0 + a_k + q;
      s_a[a_k + q][a_row] =
          (r < m && kk < k) ? to_f32(a[static_cast<size_t>(r) * k + kk]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int kk = k0 + b_k, cc = col0 + b_col + q;
      s_b[b_k][b_col + q] =
          (kk < k && cc < n) ? to_f32(b[static_cast<size_t>(kk) * n + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[kk][tr * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[kk][tr * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[kk][tc * kTN]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += av[i] * bw[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + tr * kTM + i;
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int cc = col0 + tc * kTN + j;
      if (cc < n) c[static_cast<size_t>(r) * n + cc] = from_f32(acc[i][j], c);
    }
  }
}

// ---- stage 2: interpolate the 9 tap planes, bias, epilogue ---------------
constexpr int kCO = 64;  // output channels per thread
constexpr int kInterpThreads = 128;

struct Taps {
  const int* lo;   // (2 * out): lo[o], then hi[o]
  const float* w;  // (2 * out): w_lo[o], then w_hi[o]
};

// y (b, h, w, 3, 3, cout); one thread per (output pixel, 64-channel chunk)
__global__ void __launch_bounds__(kInterpThreads)
interp_kernel(const float* __restrict__ y, const float* __restrict__ bias,
              const float* __restrict__ ep, Taps ty, Taps tx, int nb, int h,
              int w, int cout, float* __restrict__ out) {
  const int h2 = 2 * h, w2 = 2 * w;
  const int chunks = (cout + kCO - 1) / kCO;
  const long long t = static_cast<long long>(blockIdx.x) * kInterpThreads + threadIdx.x;
  const long long total = static_cast<long long>(nb) * h2 * w2 * chunks;
  if (t >= total) return;
  const int chunk = static_cast<int>(t % chunks);
  const long long pix = t / chunks;
  const int j = static_cast<int>(pix % w2);
  const int i = static_cast<int>((pix / w2) % h2);
  const int bi = static_cast<int>(pix / (static_cast<long long>(w2) * h2));
  const int co0 = chunk * kCO;
  const int nco = min(kCO, cout - co0);
  const bool vec = (cout % 4 == 0) && nco == kCO;

  float acc[kCO];
#pragma unroll
  for (int q = 0; q < kCO; ++q) acc[q] = 0.f;

  const size_t tap_stride = static_cast<size_t>(cout);      // per (dy, dx)
  const size_t pix_stride = 9 * tap_stride;                   // per low-res px
  const float* yb = y + static_cast<size_t>(bi) * h * w * pix_stride;
  for (int dy = 0; dy < 3; ++dy) {
    const int r = i + dy - 1;
    if (r < 0 || r >= h2) continue;  // zero padding of the doubled map
    const int ylo = ty.lo[r], yhi = ty.lo[h2 + r];
    const float wy0 = ty.w[r], wy1 = ty.w[h2 + r];
    for (int dx = 0; dx < 3; ++dx) {
      const int cc = j + dx - 1;
      if (cc < 0 || cc >= w2) continue;
      const int xlo = tx.lo[cc], xhi = tx.lo[w2 + cc];
      const float wx0 = tx.w[cc], wx1 = tx.w[w2 + cc];
      const size_t tap = (3 * dy + dx) * tap_stride + co0;
      const float* p00 = yb + (static_cast<size_t>(ylo) * w + xlo) * pix_stride + tap;
      const float* p01 = yb + (static_cast<size_t>(ylo) * w + xhi) * pix_stride + tap;
      const float* p10 = yb + (static_cast<size_t>(yhi) * w + xlo) * pix_stride + tap;
      const float* p11 = yb + (static_cast<size_t>(yhi) * w + xhi) * pix_stride + tap;
      const float c00 = wy0 * wx0, c01 = wy0 * wx1, c10 = wy1 * wx0, c11 = wy1 * wx1;
      if (vec) {
#pragma unroll
        for (int q4 = 0; q4 < kCO / 4; ++q4) {
          const float4 v00 = __ldg(reinterpret_cast<const float4*>(p00) + q4);
          const float4 v01 = __ldg(reinterpret_cast<const float4*>(p01) + q4);
          const float4 v10 = __ldg(reinterpret_cast<const float4*>(p10) + q4);
          const float4 v11 = __ldg(reinterpret_cast<const float4*>(p11) + q4);
          acc[4 * q4 + 0] += c00 * v00.x + c01 * v01.x + c10 * v10.x + c11 * v11.x;
          acc[4 * q4 + 1] += c00 * v00.y + c01 * v01.y + c10 * v10.y + c11 * v11.y;
          acc[4 * q4 + 2] += c00 * v00.z + c01 * v01.z + c10 * v10.z + c11 * v11.z;
          acc[4 * q4 + 3] += c00 * v00.w + c01 * v01.w + c10 * v10.w + c11 * v11.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kCO; ++q) {
          if (q < nco) {
            acc[q] += c00 * p00[q] + c01 * p01[q] + c10 * p10[q] + c11 * p11[q];
          }
        }
      }
    }
  }

  float* o = out + static_cast<size_t>(pix) * cout + co0;
#pragma unroll
  for (int q = 0; q < kCO; ++q) {
    if (q < nco) {
      const int co = co0 + q;
      float v = acc[q] + (bias != nullptr ? bias[co] : 0.f);
      if (ep != nullptr) {
        float tt = (v - ep[co]) * ep[cout + co];
        tt = tt * ep[2 * cout + co] + ep[3 * cout + co];
        v = tt >= 0.f ? tt : ep[4 * cout + co] * tt;
      }
      acc[q] = v;
    }
  }
  if (vec) {
#pragma unroll
    for (int q4 = 0; q4 < kCO / 4; ++q4) {
      reinterpret_cast<float4*>(o)[q4] =
          make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kCO; ++q) {
      if (q < nco) o[q] = acc[q];
    }
  }
}

// ---- stage 2, bf16: separable interpolation with the plain fold's roundings
constexpr int kCO16 = 32;  // output channels per thread

// y (b, h, w, 3, 3, cout) bf16; one thread per (output pixel, 32-channel chunk)
__global__ void __launch_bounds__(kInterpThreads)
interp_kernel_bf16(const __nv_bfloat16* __restrict__ y,
                   const __nv_bfloat16* __restrict__ bias,
                   const float* __restrict__ ep, Taps ty, Taps tx, int nb,
                   int h, int w, int cout, __nv_bfloat16* __restrict__ out) {
  const int h2 = 2 * h, w2 = 2 * w;
  const int chunks = (cout + kCO16 - 1) / kCO16;
  const long long t = static_cast<long long>(blockIdx.x) * kInterpThreads + threadIdx.x;
  const long long total = static_cast<long long>(nb) * h2 * w2 * chunks;
  if (t >= total) return;
  const int chunk = static_cast<int>(t % chunks);
  const long long pix = t / chunks;
  const int j = static_cast<int>(pix % w2);
  const int i = static_cast<int>((pix / w2) % h2);
  const int bi = static_cast<int>(pix / (static_cast<long long>(w2) * h2));
  const int co0 = chunk * kCO16;
  const int nco = min(kCO16, cout - co0);
  const bool vec = (cout % 8 == 0) && nco == kCO16;

  float acc[kCO16];
#pragma unroll
  for (int q = 0; q < kCO16; ++q) acc[q] = 0.f;

  const size_t tap_stride = static_cast<size_t>(cout);
  const size_t pix_stride = 9 * tap_stride;
  const __nv_bfloat16* yb = y + static_cast<size_t>(bi) * h * w * pix_stride;
  for (int dx = 0; dx < 3; ++dx) {
    const int cc = j + dx - 1;
    if (cc < 0 || cc >= w2) continue;  // zero padding of the doubled map
    for (int side = 0; side < 2; ++side) {
      const int col = tx.lo[side * w2 + cc];
      const float wx = tx.w[side * w2 + cc];
      if (wx == 0.f) continue;  // hi == lo, or an exact grid point
      // t: the row-interpolated map at (i, col) for column tap dx
      float tv[kCO16];
#pragma unroll
      for (int q = 0; q < kCO16; ++q) tv[q] = 0.f;
      for (int dy = 0; dy < 3; ++dy) {
        const int r = i + dy - 1;
        if (r < 0 || r >= h2) continue;
        for (int rs = 0; rs < 2; ++rs) {
          const int row = ty.lo[rs * h2 + r];
          const float wy = ty.w[rs * h2 + r];
          if (wy == 0.f) continue;
          const __nv_bfloat16* p = yb + (static_cast<size_t>(row) * w + col) * pix_stride +
                                   (3 * dy + dx) * tap_stride + co0;
          if (vec) {
#pragma unroll
            for (int q8 = 0; q8 < kCO16 / 8; ++q8) {
              const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q8);
              const unsigned wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                tv[8 * q8 + 2 * e] += wy * __uint_as_float(wd[e] << 16);
                tv[8 * q8 + 2 * e + 1] += wy * __uint_as_float(wd[e] & 0xffff0000u);
              }
            }
          } else {
#pragma unroll
            for (int q = 0; q < kCO16; ++q) {
              if (q < nco) tv[q] += wy * __bfloat162float(p[q]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCO16; ++q) acc[q] += wx * round_bf16(tv[q]);
    }
  }

  __align__(16) __nv_bfloat16 res[kCO16];
#pragma unroll
  for (int q = 0; q < kCO16; ++q) {
    if (q < nco) {
      const int co = co0 + q;
      float v = round_bf16(acc[q]);
      if (bias != nullptr) v = round_bf16(__fadd_rn(v, __bfloat162float(bias[co])));
      if (ep != nullptr) {
        float tt = __fmul_rn(__fsub_rn(v, ep[co]), ep[cout + co]);
        tt = round_bf16(__fadd_rn(__fmul_rn(tt, ep[2 * cout + co]), ep[3 * cout + co]));
        const float alpha = round_bf16(ep[4 * cout + co]);
        v = tt >= 0.f ? tt : round_bf16(__fmul_rn(alpha, tt));
      }
      res[q] = __float2bfloat16_rn(v);
    }
  }
  __nv_bfloat16* o = out + static_cast<size_t>(pix) * cout + co0;
  if (vec) {
#pragma unroll
    for (int q8 = 0; q8 < kCO16 / 8; ++q8) {
      reinterpret_cast<uint4*>(o)[q8] = reinterpret_cast<const uint4*>(res)[q8];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kCO16; ++q) {
      if (q < nco) o[q] = res[q];
    }
  }
}

}  // namespace

// x (b, h, w, cin) NHWC; km (cin, 9 * cout) with columns (dy, dx, c);
// bias (cout) or null; ep (5, cout) f32 or null; tap tables for rows (ylo:
// 2 x 2h int32, yw: 2 x 2h f32) and columns (xlo: 2 x 2w, xw: 2 x 2w);
// scratch (b*h*w, 9 * cout); out (b, 2h, 2w, cout). x, km, bias, scratch
// and out are bf16 if bf16 else f32; all contiguous.
extern "C" int istnet_fold_upsample(const void* x, const void* km,
                                    const void* bias, const float* ep,
                                    const int* ylo, const float* yw,
                                    const int* xlo, const float* xw, int b,
                                    int h, int w, int cin, int cout,
                                    void* scratch, void* out, int bf16,
                                    void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * h * w, n = 9 * cout;
  const dim3 ggrid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (bf16) {
    gemm_kernel<__nv_bfloat16><<<ggrid, kGemmThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(km),
        static_cast<__nv_bfloat16*>(scratch), m, n, cin);
  } else {
    gemm_kernel<float><<<ggrid, kGemmThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(km),
        static_cast<float*>(scratch), m, n, cin);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_thread = bf16 ? kCO16 : kCO;
  const long long items = static_cast<long long>(b) * 4 * h * w *
                          ((cout + per_thread - 1) / per_thread);
  const int blocks = static_cast<int>((items + kInterpThreads - 1) / kInterpThreads);
  if (bf16) {
    interp_kernel_bf16<<<blocks, kInterpThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(scratch),
        static_cast<const __nv_bfloat16*>(bias), ep, Taps{ylo, yw},
        Taps{xlo, xw}, b, h, w, cout, static_cast<__nv_bfloat16*>(out));
  } else {
    interp_kernel<<<blocks, kInterpThreads, 0, s>>>(
        static_cast<const float*>(scratch), static_cast<const float*>(bias), ep,
        Taps{ylo, yw}, Taps{xlo, xw}, b, h, w, cout, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
