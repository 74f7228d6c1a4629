// Host depth completion of the port: multi-scale morphological depth fill.
//
// The port's own copy of istnet_tpu/native/depth_fill.cpp, the same C ABI
// and the same arithmetic, so that the port's default host fill gives the
// JAX package's default host fill bit for bit. It is a C++ rebuild of the
// reference's hot CPU preprocessing op (reference
// utils/data_utils.py:199-510, the ip_basic pipeline), matching the OpenCV
// call sequence semantically (dilate w/ cross kernels, 5x5 close, 5x5
// median, 9x9 hole fill, 6x masked 5x5 dilation, 5x5 median, 5x5
// bilateral) but fused and vectorization-friendly:
//
// - morphology is SEPARABLE: full-square NxN dilate/erode = 1-D horizontal
//   max/min then 1-D vertical (N+N taps instead of N*N); a cross-kernel
//   dilate is the elementwise max of the two 1-D dilations (the cross is the
//   union of a horizontal and a vertical line). Contiguous row passes
//   autovectorize under -O3 -march=native.
// - the 5x5 median is a shared-column-sort + pruned odd-even-merge
//   selection network (9-CE vertical 5-sort shared by all horizontal
//   shifts + 82-CE merge to rank 12), applied to 64-wide column blocks so
//   every compare-exchange is a SIMD min/max.
// - the bilateral's exp is a degree-6 polynomial exp2 (rel err ~1.5e-7,
//   far inside the 0.01 mm parity budget) that autovectorizes, unlike
//   libm expf.
//
// Exposed via a plain C ABI consumed through ctypes
// (istnet_tpu_torch/native/__init__.py), built at first use.
//
// Border conventions follow OpenCV: dilation ignores out-of-bounds (constant
// -inf border), erosion ignores out-of-bounds (+inf), median uses
// BORDER_REPLICATE, bilateral uses reflect-101.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr float kValid = 0.01f;
constexpr float kNegInf = -1e30f;
constexpr float kPosInf = 1e30f;

struct Buf {
  int h, w;
  std::vector<float> data;
  Buf(int h_, int w_) : h(h_), w(w_), data(static_cast<size_t>(h_) * w_) {}
  float* ptr() { return data.data(); }
  float* row(int y) { return data.data() + static_cast<size_t>(y) * w; }
};

// ---------------------------------------------------------------------------
// separable morphology
// ---------------------------------------------------------------------------

// dst[x] = max over dx in [-r, r] of src[x+dx], OOB = -inf. `pad` is caller
// scratch of length w + 2r.
inline void hmax_row(const float* src, float* dst, int w, int r, float* pad) {
  for (int i = 0; i < r; ++i) pad[i] = kNegInf;
  std::memcpy(pad + r, src, static_cast<size_t>(w) * sizeof(float));
  for (int i = 0; i < r; ++i) pad[r + w + i] = kNegInf;
  std::memcpy(dst, pad, static_cast<size_t>(w) * sizeof(float));
  for (int k = 1; k <= 2 * r; ++k) {
    const float* s = pad + k;
    for (int x = 0; x < w; ++x) dst[x] = std::max(dst[x], s[x]);
  }
}

inline void hmin_row(const float* src, float* dst, int w, int r, float* pad) {
  for (int i = 0; i < r; ++i) pad[i] = kPosInf;
  std::memcpy(pad + r, src, static_cast<size_t>(w) * sizeof(float));
  for (int i = 0; i < r; ++i) pad[r + w + i] = kPosInf;
  std::memcpy(dst, pad, static_cast<size_t>(w) * sizeof(float));
  for (int k = 1; k <= 2 * r; ++k) {
    const float* s = pad + k;
    for (int x = 0; x < w; ++x) dst[x] = std::min(dst[x], s[x]);
  }
}

// dst[y][x] = max over dy in [-r, r] (rows clamped away, i.e. skipped) of
// src[y+dy][x]
void vmax(const float* src, float* dst, int h, int w, int r) {
  for (int y = 0; y < h; ++y) {
    const int y0 = std::max(y - r, 0), y1 = std::min(y + r, h - 1);
    float* d = dst + static_cast<size_t>(y) * w;
    std::memcpy(d, src + static_cast<size_t>(y0) * w,
                static_cast<size_t>(w) * sizeof(float));
    for (int yy = y0 + 1; yy <= y1; ++yy) {
      const float* s = src + static_cast<size_t>(yy) * w;
      for (int x = 0; x < w; ++x) d[x] = std::max(d[x], s[x]);
    }
  }
}

void vmin(const float* src, float* dst, int h, int w, int r) {
  for (int y = 0; y < h; ++y) {
    const int y0 = std::max(y - r, 0), y1 = std::min(y + r, h - 1);
    float* d = dst + static_cast<size_t>(y) * w;
    std::memcpy(d, src + static_cast<size_t>(y0) * w,
                static_cast<size_t>(w) * sizeof(float));
    for (int yy = y0 + 1; yy <= y1; ++yy) {
      const float* s = src + static_cast<size_t>(yy) * w;
      for (int x = 0; x < w; ++x) d[x] = std::min(d[x], s[x]);
    }
  }
}

// full-square (2r+1)^2 dilate: horizontal then vertical
void dilate_full(const float* src, float* dst, int h, int w, int r,
                 Buf& tmp, float* pad) {
  for (int y = 0; y < h; ++y)
    hmax_row(src + static_cast<size_t>(y) * w, tmp.row(y), w, r, pad);
  vmax(tmp.ptr(), dst, h, w, r);
}

void erode_full(const float* src, float* dst, int h, int w, int r,
                Buf& tmp, float* pad) {
  for (int y = 0; y < h; ++y)
    hmin_row(src + static_cast<size_t>(y) * w, tmp.row(y), w, r, pad);
  vmin(tmp.ptr(), dst, h, w, r);
}

// cross kernel (horizontal + vertical line of half-length r) dilate:
// max(1-D horizontal dilate, 1-D vertical dilate)
void dilate_cross(const float* src, float* dst, int h, int w, int r,
                  Buf& tmp, float* pad) {
  for (int y = 0; y < h; ++y)
    hmax_row(src + static_cast<size_t>(y) * w, tmp.row(y), w, r, pad);
  vmax(src, dst, h, w, r);
  const size_t sz = static_cast<size_t>(h) * w;
  const float* t = tmp.ptr();
  for (size_t i = 0; i < sz; ++i) dst[i] = std::max(dst[i], t[i]);
}

// ---------------------------------------------------------------------------
// 5x5 median: shared column sort + pruned odd-even-merge selection network
// ---------------------------------------------------------------------------

// optimal 9-CE 5-element sorting network (device_preprocess.py:_SORT5_CES)
constexpr int kSort5[9][2] = {{0, 1}, {3, 4}, {2, 4}, {2, 3}, {1, 4},
                              {0, 3}, {0, 2}, {1, 3}, {1, 2}};

// 82-CE odd-even merge of five sorted 5-runs pruned to the median (rank 12)
// output at position 14 (device_preprocess.py:_median25_sorted_cols_network;
// tap k = 5*s + r is the rank-r value of the vertical quintuple at
// horizontal shift s-2).
constexpr int kMedianOut = 14;
constexpr int kMerge82[82][2] = {
    {0, 5},   {4, 9},   {4, 5},   {2, 7},   {2, 4},   {7, 5},   {1, 6},
    {3, 8},   {3, 6},   {1, 2},   {3, 4},   {6, 7},   {8, 5},   {10, 15},
    {14, 19}, {14, 15}, {12, 17}, {12, 14}, {17, 15}, {11, 16}, {13, 18},
    {13, 16}, {11, 12}, {13, 14}, {16, 17}, {18, 15}, {0, 10},  {5, 15},
    {5, 10},  {4, 14},  {4, 5},   {14, 10}, {2, 12},  {7, 17},  {7, 12},
    {2, 4},   {7, 5},   {12, 14}, {17, 10}, {1, 11},  {9, 19},  {9, 11},
    {6, 16},  {6, 9},   {16, 11}, {3, 13},  {8, 18},  {8, 13},  {3, 6},
    {8, 9},   {13, 16}, {18, 11}, {1, 2},   {3, 4},   {6, 7},   {8, 5},
    {9, 12},  {13, 14}, {16, 17}, {18, 10}, {11, 15}, {0, 20},  {10, 20},
    {5, 10},  {4, 24},  {14, 24}, {14, 10}, {2, 22},  {15, 22}, {12, 15},
    {7, 12},  {12, 14}, {1, 21},  {11, 21}, {9, 11},  {16, 11}, {3, 23},
    {19, 23}, {13, 19}, {8, 13},  {13, 16}, {13, 14}};

constexpr int kVB = 64;  // column block: CEs become SIMD min/max over kVB

// 5x5 median with replicated borders, bit-identical to any correct median
void median5(const float* src, float* dst, int h, int w) {
  const int wp = w + 4;  // horizontally padded width
  std::vector<float> rr(5 * static_cast<size_t>(wp));  // sorted rank rows
  float* r5[5];
  for (int r = 0; r < 5; ++r) r5[r] = rr.data() + static_cast<size_t>(r) * wp;

  for (int y = 0; y < h; ++y) {
    // 5 source rows (vertically clamped), horizontally edge-padded by 2
    for (int r = 0; r < 5; ++r) {
      const int yy = std::min(std::max(y + r - 2, 0), h - 1);
      const float* s = src + static_cast<size_t>(yy) * w;
      float* d = r5[r];
      d[0] = d[1] = s[0];
      std::memcpy(d + 2, s, static_cast<size_t>(w) * sizeof(float));
      d[w + 2] = d[w + 3] = s[w - 1];
    }
    // vertical 5-sort, shared by all horizontal shifts (border-clamp
    // commutes with the vertical sort)
    for (const auto& ce : kSort5) {
      float* a = r5[ce[0]];
      float* b = r5[ce[1]];
      for (int x = 0; x < wp; ++x) {
        const float lo = std::min(a[x], b[x]);
        const float hi = std::max(a[x], b[x]);
        a[x] = lo;
        b[x] = hi;
      }
    }
    // merge network on 64-wide column blocks
    float* drow = dst + static_cast<size_t>(y) * w;
    for (int x0 = 0; x0 < w; x0 += kVB) {
      const int n = std::min(kVB, w - x0);
      float t[25][kVB];
      for (int s = 0; s < 5; ++s)
        for (int r = 0; r < 5; ++r)
          std::memcpy(t[5 * s + r], r5[r] + x0 + s,
                      static_cast<size_t>(n) * sizeof(float));
      for (const auto& ce : kMerge82) {
        float* a = t[ce[0]];
        float* b = t[ce[1]];
        for (int i = 0; i < n; ++i) {
          const float lo = std::min(a[i], b[i]);
          const float hi = std::max(a[i], b[i]);
          a[i] = lo;
          b[i] = hi;
        }
      }
      std::memcpy(drow + x0, t[kMedianOut],
                  static_cast<size_t>(n) * sizeof(float));
    }
  }
}

// ---------------------------------------------------------------------------
// 5x5 bilateral, sigma_color=0.5, sigma_space=2.0, reflect-101 border
// ---------------------------------------------------------------------------

// exp(x) for x <= 0 via exp2 split + degree-6 Taylor of e^y on
// y = frac * ln2 in [-0.35, 0.35]; rel err ~1.5e-7 — the weights feed a
// normalized average, so output error is orders below the 0.01 mm
// native-vs-cv2 parity budget. Plain float ops + memcpy bit cast so the
// whole bilateral tap loop autovectorizes (libm expf does not).
inline float fast_exp(float x) {
  // underflow guard: below ~-87 the (n+127)<<23 exponent reconstruction
  // goes negative and returns garbage/non-finite weights. Real trigger:
  // depth pixels far beyond max_depth (e.g. 12 m walls) stay large-negative
  // after inversion, making gc*d*d < -88 against valid neighbors. exp(-87)
  // ~ 1.6e-38 — returning 0 is exact to f32.
  if (x < -87.0f) return 0.0f;
  const float t = x * 1.44269504088896341f;  // log2(e)
  const float n = std::floor(t + 0.5f);
  const float y = (t - n) * 0.69314718055994531f;  // frac * ln2
  float p = 1.0f / 720.0f;
  p = p * y + 1.0f / 120.0f;
  p = p * y + 1.0f / 24.0f;
  p = p * y + 1.0f / 6.0f;
  p = p * y + 0.5f;
  p = p * y + 1.0f;
  p = p * y + 1.0f;
  const int e = (static_cast<int>(n) + 127) << 23;
  float s;
  std::memcpy(&s, &e, sizeof(s));
  return p * s;
}

// one bilateral tap over a row. noinline is load-bearing: inlined into the
// k-loop, GCC's vectorizer sees the k-dependent base ("evolution of base is
// not affine") and emits SCALAR vrndscaless code — 7x slower on this stage
// (22 -> 3 ms/frame standalone). As a standalone function the loop
// vectorizes with 64-byte vectors; the 21 calls/row are noise.
__attribute__((noinline)) void bilateral_tap(const float* __restrict__ s,
                   const float* __restrict__ center, float sw, float gc,
                   float* __restrict__ ws, float* __restrict__ vs, int n) {
  for (int x = 0; x < n; ++x) {
    const float v = s[x];
    const float d = v - center[x];
    const float wgt = sw * fast_exp(gc * d * d);
    ws[x] += wgt;
    vs[x] += wgt * v;
  }
}

void bilateral5(const float* src, float* dst, int h, int w,
                float sigma_color, float sigma_space) {
  const int radius = 2;
  float space_w[25];
  int offs[25][2];
  int n_offs = 0;
  const float gs = -0.5f / (sigma_space * sigma_space);
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx) {
      const double r = std::sqrt(static_cast<double>(dy * dy + dx * dx));
      if (r > radius) continue;  // OpenCV uses the disk, not the square
      space_w[n_offs] = std::exp(gs * static_cast<float>(dy * dy + dx * dx));
      offs[n_offs][0] = dy;
      offs[n_offs][1] = dx;
      ++n_offs;
    }
  }
  const float gc = -0.5f / (sigma_color * sigma_color);
  auto reflect = [](int p, int len) {
    if (p < 0) p = -p;
    if (p >= len) p = 2 * len - 2 - p;
    // degenerate lengths (< kernel radius) would re-escape; clamp so the
    // read is always in bounds (dispatch gates such sizes to cv2 anyway)
    return std::min(std::max(p, 0), len - 1);
  };
  const int wp = w + 4;
  std::vector<float> prow(5 * static_cast<size_t>(wp));
  std::vector<float> wsum(w), vsum(w);
  for (int y = 0; y < h; ++y) {
    // 5 reflect-101 padded source rows (reflect() keeps tiny widths in
    // bounds; the w>=5 production case reduces to s[2]/s[1]/s[w-2]/s[w-3])
    for (int r = 0; r < 5; ++r) {
      const int yy = reflect(y + r - 2, h);
      const float* s = src + static_cast<size_t>(yy) * w;
      float* d = prow.data() + static_cast<size_t>(r) * wp;
      d[0] = s[reflect(-2, w)];
      d[1] = s[reflect(-1, w)];
      std::memcpy(d + 2, s, static_cast<size_t>(w) * sizeof(float));
      d[w + 2] = s[reflect(w, w)];
      d[w + 3] = s[reflect(w + 1, w)];
    }
    // __restrict__ locals: s aliases prow (read-only) while ws/vs are
    // written — without the annotation GCC refuses to vectorize the tap
    // loop ("evolution of base is not affine"), a measured 4x on this stage
    const float* __restrict__ center =
        prow.data() + 2 * static_cast<size_t>(wp) + 2;
    float* __restrict__ ws = wsum.data();
    float* __restrict__ vs = vsum.data();
    std::fill(wsum.begin(), wsum.end(), 0.f);
    std::fill(vsum.begin(), vsum.end(), 0.f);
    for (int k = 0; k < n_offs; ++k) {
      const float* s =
          prow.data() + static_cast<size_t>(offs[k][0] + 2) * wp + 2 + offs[k][1];
      bilateral_tap(s, center, space_w[k], gc, ws, vs, w);
    }
    float* drow = dst + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) drow[x] = vs[x] / ws[x];
  }
}

}  // namespace

extern "C" {

// In-place multi-scale depth completion of an (h, w) float32 buffer;
// `pre_scale` converts the caller's units into the pipeline's meters on
// entry and back on exit (fused here so the ctypes wrapper needs zero numpy
// scaling passes — they cost ~9 ms/frame, a third of the total);
// max_depth = 3.0 matches fill_missing (data_utils.py:514-534).
void fill_in_multiscale_scaled(float* depth, int h, int w, float max_depth,
                               float pre_scale) {
  const size_t sz = static_cast<size_t>(h) * w;
  Buf tmp_a(h, w), tmp_b(h, w), band(h, w);
  std::vector<float> pad(static_cast<size_t>(w) + 8);
  float* out = depth;

  if (pre_scale != 1.0f)
    for (size_t i = 0; i < sz; ++i) out[i] *= pre_scale;

  // distance-band masks computed on the raw input
  std::vector<unsigned char> near_m(sz), med_m(sz), far_m(sz);
  for (size_t i = 0; i < sz; ++i) {
    const float v = depth[i];
    near_m[i] = (v > kValid && v <= 1.0f);
    med_m[i] = (v > 1.0f && v <= 2.0f);
    far_m[i] = (v > 2.0f);
  }

  // invert
  for (size_t i = 0; i < sz; ++i)
    if (out[i] > kValid) out[i] = max_depth - out[i];

  // per-band dilations with cross kernels 3/5/7; ALL bands read the original
  // inverted depths (data_utils.py:399-420), results combined far-to-near
  std::vector<float> inv0(out, out + sz);
  struct BandSpec {
    const std::vector<unsigned char>* m;
    int r;
  };
  const BandSpec bands[3] = {{&far_m, 1}, {&med_m, 2}, {&near_m, 3}};
  for (const BandSpec& bd : bands) {
    for (size_t i = 0; i < sz; ++i) band.ptr()[i] = (*bd.m)[i] ? inv0[i] : 0.f;
    dilate_cross(band.ptr(), tmp_a.ptr(), h, w, bd.r, tmp_b, pad.data());
    for (size_t i = 0; i < sz; ++i)
      if (tmp_a.ptr()[i] > kValid) out[i] = tmp_a.ptr()[i];
  }

  // 5x5 closing (dilate then erode)
  dilate_full(out, tmp_a.ptr(), h, w, 2, band, pad.data());
  erode_full(tmp_a.ptr(), tmp_b.ptr(), h, w, 2, band, pad.data());
  std::memcpy(out, tmp_b.ptr(), sz * sizeof(float));

  // median blur on valid pixels
  median5(out, tmp_a.ptr(), h, w);
  for (size_t i = 0; i < sz; ++i)
    if (out[i] > kValid) out[i] = tmp_a.ptr()[i];

  // top mask + 9x9 hole fill (branchless row sweeps so every merge below
  // vectorizes as compare+blend)
  std::vector<int> top_row(w);
  auto compute_top = [&](std::vector<int>& tr) {
    int* __restrict__ t = tr.data();
    for (int x = 0; x < w; ++x) t[x] = -1;
    for (int y = 0; y < h; ++y) {
      const float* __restrict__ row = out + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; ++x)
        t[x] = (t[x] < 0 && row[x] > kValid) ? y : t[x];
    }
    for (int x = 0; x < w; ++x)
      if (t[x] < 0) t[x] = 0;  // empty column: mask stays all-true
  };
  // NOTE: plain pointer (not __restrict__): compute_top rewrites the same
  // memory through its own restrict pointer between the reads below —
  // restrict-qualifying this alias too would be formal UB
  const int* top = top_row.data();
  compute_top(top_row);
  dilate_full(out, tmp_a.ptr(), h, w, 4, band, pad.data());
  for (int y = 0; y < h; ++y) {
    float* __restrict__ o = out + static_cast<size_t>(y) * w;
    const float* __restrict__ t = tmp_a.row(y);
    for (int x = 0; x < w; ++x)
      o[x] = (!(o[x] > kValid) && y >= top[x]) ? t[x] : o[x];
  }

  // recompute top mask, 6x masked 5x5 dilation
  compute_top(top_row);
  for (int it = 0; it < 6; ++it) {
    dilate_full(out, tmp_a.ptr(), h, w, 2, band, pad.data());
    for (int y = 0; y < h; ++y) {
      float* __restrict__ o = out + static_cast<size_t>(y) * w;
      const float* __restrict__ t = tmp_a.row(y);
      for (int x = 0; x < w; ++x)
        o[x] = (o[x] < kValid && y >= top[x]) ? t[x] : o[x];
    }
  }

  // median on valid & top-masked pixels
  median5(out, tmp_a.ptr(), h, w);
  std::vector<unsigned char> valid(sz);
  for (int y = 0; y < h; ++y) {
    float* __restrict__ o = out + static_cast<size_t>(y) * w;
    const float* __restrict__ t = tmp_a.row(y);
    unsigned char* __restrict__ vl = valid.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      vl[x] = (o[x] > kValid && y >= top[x]);
      o[x] = vl[x] ? t[x] : o[x];
    }
  }

  // bilateral on the SAME valid set (the reference reuses the median-step
  // mask for the bilateral write, data_utils.py:315-322)
  bilateral5(out, tmp_a.ptr(), h, w, 0.5f, 2.0f);
  for (size_t i = 0; i < sz; ++i)
    if (valid[i]) out[i] = tmp_a.ptr()[i];

  // invert back + undo the unit scale
  const float post = (pre_scale != 1.0f) ? 1.0f / pre_scale : 1.0f;
  for (size_t i = 0; i < sz; ++i) {
    const float v = out[i];
    out[i] = (v > kValid ? max_depth - v : v) * post;
  }
}

// legacy entry (units already meters)
void fill_in_multiscale(float* depth, int h, int w, float max_depth) {
  fill_in_multiscale_scaled(depth, h, w, max_depth, 1.0f);
}

}  // extern "C"
