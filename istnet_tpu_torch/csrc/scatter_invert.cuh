// The owned, ordered gather shared by the two backward scatters, the
// grouping scatter (group_scatter.cu) and the interpolation scatter
// (interp_scatter.cu). Both compute, per sample,
//   out[p, :] = sum over the entries e that name row p of  w_e * g_e
// (g_e a cotangent row, w_e = 1 for the grouping, the interpolation weight
// for the FP backward), with no atomic add into the output and in one fixed
// order, so that two calls give the same bits.
//
// 1. Inversion (invert_sample, one block a sample, a warp per kInvEntries
//    entries, 8 to 32): the entries' keys (the rows they name) are counted
//    into per-warp histograms over contiguous segments of the entries by
//    shared-memory atomics (a count does not depend on their order). An
//    exclusive scan over (row, warp) turns the counts into positions, and a
//    second walk of the same segments, 32 entries a warp step, places each
//    entry (and its weight, where there is one) at its position plus its
//    rank among the step's lanes of its key: CSR form, every row's entries
//    in ascending entry order (a stable counting sort; no placement by
//    atomics, whose order would not be fixed). The lanes of a step that
//    hold one key find each other by one __ballot_sync a key bit (fixed
//    cost; __match_any_sync took longer the more distinct keys a step held).
//    Every row's list is cut into chunks of at most kChunk entries (an empty
//    row keeps one empty chunk, so that its zeros are written), one
//    descriptor a chunk. Histograms and the placed entries live in shared
//    memory (kStaged, written out coalesced at the end) while they fit in
//    kStagedBytes, else in the workspace.
// 2. Gather (gather_chunk, one warp a chunk and slice of channels): lane j
//    takes the chunk's entry j, then the warp walks the entries in order,
//    each lane summing 4 channels a vector in f32 (bf16 rows are widened
//    exactly). A row of one chunk is written once; a longer row (point 0
//    takes every slot of a centroid without a hit, a first hit its row's
//    pad slots) writes one partial a chunk and slice, and the last of them
//    to arrive (a counter the inversion zeroed) adds the partials in chunk
//    order. So a long list never holds a warp for more than kChunk rows
//    plus that sum.
//
// Workspace sizes follow from the shapes alone (work_bytes), nothing is read
// back to the host and nothing is allocated by data, so the backward can be
// captured in a CUDA graph.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace istnet {

constexpr int kInvWarps = 32;  // most warps of an inversion block
constexpr int kInvThreads = kInvWarps * 32;
constexpr int kInvEntries = 256;  // entries a warp of the inversion at least
constexpr int kChunk = 32;     // entries of a chunk: one a lane
constexpr int kPre = 12;       // warp steps of keys loaded ahead in the walk
constexpr size_t kStagedBytes = 200 * 1024;

// One chunk of a row's list: entries [begin, end) of the sorted array;
// the row's chunks are first .. first + count - 1.
struct Chunk {
  int row, begin, end, first, count;
};

// The keys of a sample, entry e in [0, len[0] + len[1]): e < len[0] reads
// base[0][b * len[0] + e], else base[1][b * len[1] + e - len[0]]. With
// weight (one segment only, laid out as base[0]) each entry's weight is
// placed beside it.
struct Keys {
  const int* base[2];
  int len[2];
  const float* weight;
  __device__ __forceinline__ int at(int b, int e) const {
    return e < len[0] ? base[0][static_cast<size_t>(b) * len[0] + e]
                      : base[1][static_cast<size_t>(b) * len[1] + (e - len[0])];
  }
};

// The workspace of one call, per sample b: sorted[b * e ..] entry ids by
// row then entry (sorted_w their weights, for weighted keys), chunks[b *
// max_chunks ..], nchunks[b], counter[b * rows ..] for the last-arriving
// piece of a row, partial[(b * max_chunks + c) * c_out ..] a chunk's sum
// when its row has more than one, hist[b * kInvWarps * rows ..] the
// unstaged route's histograms.
struct Work {
  int* sorted;
  float* sorted_w;
  Chunk* chunks;
  int* nchunks;
  int* counter;
  float* partial;
  int* hist;
  int e, rows, max_chunks;
};

// Each row takes max(1, ceil(len / kChunk)) chunks: at most rows + ceil(e /
// kChunk) in all.
inline int max_chunks(int e, int rows) { return rows + (e + kChunk - 1) / kChunk; }

// Warps of the inversion block for e entries a sample: one per kInvEntries,
// 8 to kInvWarps.
inline int inv_warps(int e) {
  const int nw = e / kInvEntries;
  return nw < 8 ? 8 : nw > kInvWarps ? kInvWarps : nw;
}

// Shared memory of a staged inversion block: histograms, then the placed
// entries and their weights.
inline size_t staged_bytes(int e, int rows) {
  return sizeof(int) * (static_cast<size_t>(inv_warps(e)) * rows + 2 * static_cast<size_t>(e));
}

inline bool staged(int e, int rows) { return staged_bytes(e, rows) <= kStagedBytes; }

inline size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Bytes of the workspace for b samples of e entries into rows rows of c
// channels; carve() lays it out.
inline size_t work_bytes(int b, int e, int rows, int c) {
  const size_t mc = static_cast<size_t>(max_chunks(e, rows));
  size_t n = 2 * align_up(sizeof(int) * b * static_cast<size_t>(e));
  n += align_up(sizeof(Chunk) * b * mc);
  n += align_up(sizeof(int) * b);
  n += align_up(sizeof(int) * b * static_cast<size_t>(rows));
  n += align_up(sizeof(float) * b * mc * c);
  if (!staged(e, rows)) n += align_up(sizeof(int) * b * kInvWarps * static_cast<size_t>(rows));
  return n;
}

inline Work carve(void* ws, int b, int e, int rows, int c) {
  Work w{};
  w.e = e;
  w.rows = rows;
  w.max_chunks = max_chunks(e, rows);
  const size_t mc = static_cast<size_t>(w.max_chunks);
  char* p = static_cast<char*>(ws);
  w.sorted = reinterpret_cast<int*>(p);
  p += align_up(sizeof(int) * b * static_cast<size_t>(e));
  w.sorted_w = reinterpret_cast<float*>(p);
  p += align_up(sizeof(float) * b * static_cast<size_t>(e));
  w.chunks = reinterpret_cast<Chunk*>(p);
  p += align_up(sizeof(Chunk) * b * mc);
  w.nchunks = reinterpret_cast<int*>(p);
  p += align_up(sizeof(int) * b);
  w.counter = reinterpret_cast<int*>(p);
  p += align_up(sizeof(int) * b * static_cast<size_t>(rows));
  w.partial = reinterpret_cast<float*>(p);
  p += align_up(sizeof(float) * b * mc * c);
  w.hist = staged(e, rows) ? nullptr : reinterpret_cast<int*>(p);
  return w;
}

// Launches the inversion kernel `kernel` (instance kStaged) for b samples
// on s, opting into the shared memory it needs first.
template <bool kStaged, typename Kernel, typename... Args>
cudaError_t launch_invert(Kernel kernel, int grid, int e, int rows, cudaStream_t s,
                          Args... args) {
  size_t smem = 0;
  if (kStaged) {
    smem = staged_bytes(e, rows);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kStagedBytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, inv_warps(e) * 32, smem, s>>>(args...);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The lanes of the warp whose key equals this lane's, keys in [0, 2^nbits);
// with `partial`, only among the lanes that share this lane's `real`.
__device__ __forceinline__ unsigned same_key(int key, int nbits, bool partial, bool real) {
  unsigned same = 0xffffffffu;
  if (partial) {
    const unsigned ones = __ballot_sync(0xffffffffu, real);
    same = real ? ones : ~ones;
  }
  for (int bit = 0; bit < nbits; ++bit) {
    const bool set = (key >> bit) & 1;
    const unsigned ones = __ballot_sync(0xffffffffu, set);
    same &= set ? ones : ~ones;
  }
  return same;
}

// One walk of warp `warp`'s segment [lo, hi) of sample b's entries, 32 a
// step, kPre steps of keys loaded ahead; lanes past hi hold the key `rows`,
// which no entry holds (nbits covers rows - 1; the last, partial step of a
// segment also matches on being real). Counting (kPlace false): my[key] += 1 an entry, by
// shared-memory atomics (a count does not depend on their order). Placing:
// each entry goes to sorted (its weight to sorted_w) at my[key] + its rank
// among the step's lanes of that key, then my[key] moves past them.
template <bool kPlace>
__device__ __forceinline__ void walk_segment(const Keys& keys, int b, int lo, int hi, int rows,
                                             int nbits, int* my, int* sorted, float* sorted_w) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool weighted = kPlace && keys.weight != nullptr;
  for (int base = lo; base < hi; base += 32 * kPre) {
    int key[kPre];
    float wt[kPre];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int e = base + 32 * u + lane;
      key[u] = e < hi ? keys.at(b, e) : rows;
      wt[u] = weighted && e < hi ? keys.weight[static_cast<size_t>(b) * keys.len[0] + e] : 0.f;
    }
    if (!kPlace) {
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        if (key[u] < rows) atomicAdd(my + key[u], 1);
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      if (base + 32 * u >= hi) break;  // warp-uniform
      const bool real = key[u] < rows;
      const unsigned same = same_key(key[u], nbits, base + 32 * u + 32 > hi, real);
      if (real) {
        const int pos = my[key[u]] + __popc(same & below);
        sorted[pos] = base + 32 * u + lane;
        if (weighted) sorted_w[pos] = wt[u];
      }
      __syncwarp();
      if (real && (same & below) == 0) my[key[u]] += __popc(same);
      __syncwarp();
    }
  }
}

// Block-wide exclusive scan of one (x, y) pair a thread; s holds a pair a
// warp. Ends with the block past a barrier.
__device__ __forceinline__ int2 block_exclusive_scan(int2 v, int2* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc.x, off);
    const int y = __shfl_up_sync(0xffffffffu, inc.y, off);
    if (lane >= off) inc.x += x, inc.y += y;
  }
  if (lane == 31) s[warp] = inc;
  __syncthreads();
  int2 base = make_int2(0, 0);
  for (int k = 0; k < warp; ++k) base.x += s[k].x, base.y += s[k].y;
  return make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
}

// Sample b's inversion, by one block of inv_warps(e) warps. `smem` holds
// staged_bytes(e, rows) when kStaged. Writes sorted, chunks, nchunks[b] and
// zeroes counter for the sample; keys must lie in [0, rows).
template <bool kStaged>
__device__ __forceinline__ void invert_sample(const Keys& keys, int b, const Work& w,
                                              int* smem) {
  __shared__ int2 s_scan[kInvWarps];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int rows = w.rows, n_e = w.e;
  const int nbits = 32 - __clz(max(rows - 1, 1));  // bits of the keys
  int* hist = kStaged ? smem : w.hist + static_cast<size_t>(b) * kInvWarps * rows;
  int* out = w.sorted + static_cast<size_t>(b) * n_e;
  float* out_w = w.sorted_w + static_cast<size_t>(b) * n_e;
  int* sorted = kStaged ? smem + nw * rows : out;
  float* sorted_w = kStaged ? reinterpret_cast<float*>(sorted + n_e) : out_w;
  for (int i = tid; i < nw * rows; i += nt) hist[i] = 0;
  __syncthreads();
  const int seg = (n_e + nw - 1) / nw;
  const int lo = min(warp * seg, n_e), hi = min(lo + seg, n_e);
  walk_segment<false>(keys, b, lo, hi, rows, nbits, hist + warp * rows, sorted, sorted_w);
  __syncthreads();

  // rows [r0, r1) of this thread: their lengths, then the block's scan of
  // (entries, chunks) gives each row's first entry and first chunk
  const int per = (rows + nt - 1) / nt;
  const int r0 = min(tid * per, rows), r1 = min(r0 + per, rows);
  int2 tot = make_int2(0, 0);
  for (int p = r0; p < r1; ++p) {
    int len = 0;
    for (int k = 0; k < nw; ++k) len += hist[k * rows + p];
    tot.x += len;
    tot.y += max(1, (len + kChunk - 1) / kChunk);
  }
  const int2 start = block_exclusive_scan(tot, s_scan);
  int at = start.x, c = start.y;
  Chunk* chunks = w.chunks + static_cast<size_t>(b) * w.max_chunks;
  for (int p = r0; p < r1; ++p) {
    const int begin = at;
    for (int k = 0; k < nw; ++k) {
      const int t = hist[k * rows + p];
      hist[k * rows + p] = at;
      at += t;
    }
    const int count = max(1, (at - begin + kChunk - 1) / kChunk);
    for (int j = 0; j < count; ++j) {
      chunks[c + j] = Chunk{p, begin + j * kChunk, min(begin + (j + 1) * kChunk, at), c, count};
    }
    w.counter[static_cast<size_t>(b) * rows + p] = 0;
    c += count;
  }
  if (tid == nt - 1) w.nchunks[b] = c;
  __syncthreads();
  walk_segment<true>(keys, b, lo, hi, rows, nbits, hist + warp * rows, sorted, sorted_w);
  if (kStaged) {
    __syncthreads();
    for (int i = tid; i < n_e; i += nt) out[i] = sorted[i];
    if (keys.weight != nullptr) {
      for (int i = tid; i < n_e; i += nt) out_w[i] = sorted_w[i];
    }
  }
}

// Channels a gather warp takes: 4 a lane and vector, kV4 vectors, at
// most kSliceChannels; a wider row is cut into slices, one warp each.
constexpr int kSliceChannels = 512;
inline int gather_vectors(int c) {
  const int v = ((c < kSliceChannels ? c : kSliceChannels) + 127) / 128;
  return v < 1 ? 1 : v;
}
inline int gather_slices(int c) { return (c + kSliceChannels - 1) / kSliceChannels; }
// How a gather realigns rows of c values, a template flag so that rows
// that need less pay nothing: kAligned, rows of a multiple of 4 values
// start on a vector (the tensor does); kShifted, rows start anywhere;
// kShiftedTail, also lane 31's last vector can need values from the vector
// after it (a row of more than 128 gather_vectors(c) - 4 values, a sliced
// row always).
enum Seam { kAligned, kShifted, kShiftedTail };
inline Seam gather_seam(int c) {
  return c % 4 == 0 ? kAligned : c > 128 * gather_vectors(c) - 4 ? kShiftedTail : kShifted;
}

// 4 consecutive values from p as floats: one 16-byte (f32) or 8-byte
// (bf16) load when p is that aligned and the 4 values end by hi, else
// value by value (a row's last vector may run past the end of its tensor).
__device__ __forceinline__ float4 load4(const float* p, const float* hi) {
  if (p + 4 <= hi) return *reinterpret_cast<const float4*>(p);
  return make_float4(p < hi ? p[0] : 0.f, p + 1 < hi ? p[1] : 0.f, p + 2 < hi ? p[2] : 0.f, 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, const __nv_bfloat16* hi) {
  if (p + 4 <= hi) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);  // little-endian: value 0 low
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(p < hi ? to_f32(p[0]) : 0.f, p + 1 < hi ? to_f32(p[1]) : 0.f,
                     p + 2 < hi ? to_f32(p[2]) : 0.f, 0.f);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

// Slice `slice` of chunk c of sample b, by one warp: the ordered sum of its
// entries' rows into out_b (the sample's (rows, n_ch) output) or, for a row
// of several chunks, into its partial, the last piece to arrive adding the
// partials in chunk order. Src gives, for entry e, code(b, e) (an int naming
// its cotangent row), row(code) (a pointer to its n_ch values of type T)
// and end(code) (the end of that row's tensor); kWeighted multiplies each
// value by the entry's weight, placed beside it by the inversion (product
// and sum rounded on their own, as the plain version's).
//
// Rows are read as aligned vectors of 4 values (lane l, vector v: values
// 4 (32 v + l) - m .. + 3 of the row, m its misalignment), kU rows in flight,
// then realigned by one shuffle from the next lane, so that lane l always
// sums channels 4 (32 v + l) .. + 3: rows of 3 + C = 67, 131, 259 values are
// never 16-byte aligned, and 4-byte loads along channels, the first design,
// issued 4x the load instructions and ran slower.
template <typename T, int kV4, Seam kSeam, bool kWeighted, class Src>
__device__ __forceinline__ void gather_chunk(const Src& src, const Work& w, int b, int c,
                                             int slice, int slices, int n_ch,
                                             float* __restrict__ out_b) {
  constexpr int kU = 2;  // rows in flight (more measured slower: registers)
  const int lane = threadIdx.x & 31;
  if (c >= w.max_chunks) return;
  // both loads in flight together: a descriptor past nchunks[b] is stale
  const int used = w.nchunks[b];
  const Chunk ch = w.chunks[static_cast<size_t>(b) * w.max_chunks + c];
  if (c >= used) return;  // whole warp leaves together
  const int cnt = ch.end - ch.begin;
  const size_t at = static_cast<size_t>(b) * w.e + ch.begin + lane;
  int code = 0;
  float wt = 1.f;
  if (lane < cnt) {
    code = src.code(b, w.sorted[at]);
    if constexpr (kWeighted) wt = w.sorted_w[at];
  }
  const int c0 = kSliceChannels * slice;
  const int nc = min(kSliceChannels, n_ch - c0);  // channels of this slice
  float4 acc[kV4];
#pragma unroll
  for (int v = 0; v < kV4; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < cnt; j0 += kU) {
    float4 x[kU][kV4];
    constexpr bool kTail = kSeam == kShiftedTail;
    float4 tail[kTail ? kU : 1];  // lane 0: the vector after the warp's last, for lane 31
    int mis[kU];
    float wu[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u;
      const int cu = __shfl_sync(0xffffffffu, code, j & 31);
      const T* rp = src.row(cu) + c0;
      const T* hi = src.end(cu);
      wu[u] = kWeighted ? __shfl_sync(0xffffffffu, wt, j & 31) : 1.f;
      const int m = kSeam == kAligned
                        ? 0
                        : static_cast<int>((reinterpret_cast<uintptr_t>(rp) / sizeof(T)) & 3);
      mis[u] = m;
#pragma unroll
      for (int v = 0; v < kV4; ++v) {
        const int q = 4 * (32 * v + lane);
        x[u][v] = (j < cnt && q < nc + m) ? load4(rp - m + q, hi)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if constexpr (kTail) {
        constexpr int kNext = 4 * 32 * kV4;  // the vector after the warp's last
        tail[u] = (lane == 0 && j < cnt && kNext < n_ch - c0 + m)
                      ? load4(rp - m + kNext, hi) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (j0 + u >= cnt) break;  // warp-uniform
      const int m = mis[u];       // warp-uniform
#pragma unroll
      for (int v = 0; v < kV4; ++v) {
        float4 val = x[u][v];
        if (kSeam != kAligned && m != 0) {
          // the values after this lane's: the next lane's, or for lane 31
          // lane 0's of the next vector (of the next slice, after the last)
          float4 nx = shfl4(x[u][v], (lane + 1) & 31);
          if ((v + 1 < kV4 || kTail) && 4 * (32 * v + 31) < nc) {  // warp-uniform
            const float4 wrap = shfl4(v + 1 < kV4 ? x[u][v + 1] : tail[kTail ? u : 0], 0);
            if (lane == 31) nx = wrap;
          }
          const float4 cur = x[u][v];
          val = m == 1 ? make_float4(cur.y, cur.z, cur.w, nx.x)
              : m == 2 ? make_float4(cur.z, cur.w, nx.x, nx.y)
                       : make_float4(cur.w, nx.x, nx.y, nx.z);
        }
        if constexpr (kWeighted) {
          acc[v].x = __fadd_rn(acc[v].x, __fmul_rn(wu[u], val.x));
          acc[v].y = __fadd_rn(acc[v].y, __fmul_rn(wu[u], val.y));
          acc[v].z = __fadd_rn(acc[v].z, __fmul_rn(wu[u], val.z));
          acc[v].w = __fadd_rn(acc[v].w, __fmul_rn(wu[u], val.w));
        } else {
          acc[v].x = __fadd_rn(acc[v].x, val.x);
          acc[v].y = __fadd_rn(acc[v].y, val.y);
          acc[v].z = __fadd_rn(acc[v].z, val.z);
          acc[v].w = __fadd_rn(acc[v].w, val.w);
        }
      }
    }
  }
  float* dst = (ch.count == 1
                    ? out_b + static_cast<size_t>(ch.row) * n_ch
                    : w.partial + (static_cast<size_t>(b) * w.max_chunks + c) * n_ch) + c0;
#pragma unroll
  for (int v = 0; v < kV4; ++v) {
    const int q = 4 * (32 * v + lane);
    if (q < nc) dst[q] = acc[v].x;
    if (q + 1 < nc) dst[q + 1] = acc[v].y;
    if (q + 2 < nc) dst[q + 2] = acc[v].z;
    if (q + 3 < nc) dst[q + 3] = acc[v].w;
  }
  if (ch.count == 1) return;
  // the last of the row's chunks and slices adds the partials in chunk order
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(w.counter + static_cast<size_t>(b) * w.rows + ch.row, 1) ==
           ch.count * slices - 1;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  const float* part = w.partial + (static_cast<size_t>(b) * w.max_chunks + ch.first) * n_ch;
  float* out = out_b + static_cast<size_t>(ch.row) * n_ch;
  for (int k = lane; k < n_ch; k += 32) {
    float s = __ldcg(part + k);
#pragma unroll 4
    for (int q = 1; q < ch.count; ++q) {
      s = __fadd_rn(s, __ldcg(part + static_cast<size_t>(q) * n_ch + k));
    }
    out[k] = s;
  }
}

}  // namespace istnet
