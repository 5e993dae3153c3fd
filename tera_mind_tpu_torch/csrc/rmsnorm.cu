// K1: RMSNorm forward, y = x * rsqrt(mean(x^2, -1) + eps) * w.
//
// Replaces the Pallas kernel tera_mind_tpu/ops/rmsnorm_kernel.py
// (rmsnorm_fused / _kernel).  Bound by memory: each row is read once from
// device memory and written once; the arithmetic is a few operations per
// element.  Two variants, chosen by the caller from C, dtype and pointer
// alignment before the launch (ops/rmsnorm_kernel.py rmsnorm_variant):
//
// vector (C % 8 == 0, C * sizeof(T) <= 2048, x, w, y 16-byte aligned):
//   a row belongs to a group of G lanes, G the smallest power of two that
//   leaves each lane at most kVecMax 16-byte vectors (C = 96 in bf16: 4
//   lanes x 3 vectors, 8 rows a warp; C = 64: 2 lanes x 4).  A lane loads
//   its vectors of x and of w once, into registers, with every load in
//   flight before the first use; the sum of squares is reduced with
//   __shfl_xor_sync inside the group, and y is written from the same
//   registers as 16-byte stores, so x leaves device memory once.  A
//   float32 weight of a bf16 x (the training's master weight) is read as
//   two 16-byte vectors a bf16 vector and rounded to bf16 in the lane's
//   registers, so the call is one launch (a cast would be a launch of its
//   own, which at 2,048 x 512 costs about as much as the norm).
// strided (any other C or pointer: the odd C of the 5D model's gene
//   concats, 485, 741, 997 and 1,253, and of the 81-gene presets, 337,
//   593, 849 and 1,105; the 500-gene presets' 756, 1,012, 1,268 and 1,524,
//   rows over 2 KB; misaligned tensors): one warp a row, 16 warps a block.
//   Rows of up to kRegMaxBytes (2,048 bf16 or 1,024 float32 channels) are
//   held in registers by the word scheme of csrc/rmsnorm_words.cuh: a
//   lane's words_per_lane(C) 16-byte loads (C = 1,524 in bf16: 6 words,
//   24 registers) all in flight, the row's sum of squares from them (each
//   lane's elements in word order, then the shuffle tree), y written from
//   the same registers, so x leaves device memory once.  What bounds it
//   is the instructions a row more than the bytes (a first design that
//   tested each element's channel lost to the two-pass loop it replaced
//   at C <= 593), so:
//   - w lies in shared memory as 16-byte words in x's own layout, one copy
//     for each offset at which a row can start in its first word, so that
//     a word of y is one 16-byte read of w and, in bf16, eight bf16x2
//     multiplies (bf16(bf16(x * bf16(inv)) * w), the TPU kernel's
//     rounding, each product rounded once);
//   - only the two words a row shares with its neighbours test channels:
//     their neighbours' elements are set to 0 for the sum, and their row's
//     elements are stored as the widest aligned 8-, 4- and 2-byte pieces;
//     the words inside the row are whole 16-byte stores;
//   - a grid-stride loop over the rows, two blocks an SM (64 registers;
//     one at 9 words a lane), stages w once a block, each warp's first
//     row loaded before the staging; up to 4 words a lane the next row's
//     words are loaded before a row is reduced; rows of C <= 505 in bf16
//     (253 in float32) take half a warp each, two rows a warp.
//   w may be float32 for a bf16 x (the training's master weight): it is
//   rounded to bf16 as it is staged, as a cast before the call would.
//   Wider rows (none on any path: the edge C = 2,050) keep the first
//   design, a strided pass for the sum of squares and a second that
//   re-reads the row (from L1) and writes y.
//
// Any row count works: the last block masks its missing rows.  Rounding
// follows the TPU kernel: for bf16, inv and w are cast to bf16 and
// y = bf16(bf16(x * bf16(inv)) * bf16(w)); for float, y = w * (x * inv).
//
// Epilogue "modulate" (tmt_rmsnorm_modulate): the DiT block's adaLN
// modulate after its norms, out = r(r(y * r(s + 1)) + sh) on the rounded
// y, with s and sh the per-token scale and shift: (rows, C) views of T
// with their own row strides (chunks of the adaLN dense's (B, N, 7C)
// output, 7C elements a row).  It replaces no Pallas kernel: XLA fuses
// tera_mind_tpu/models/nn.py:127-130 `modulate` after the norm, where
// eager PyTorch runs three passes over the norm's output (the scale's
// + 1 on a strided chunk, the product, the sum), each reading and
// writing a map.  The fold reads s and sh once more and writes nothing
// else.  Every variant takes it: vector reads s and sh as 16-byte vectors
// beside x (their bases and row strides 16-byte aligned, else the call
// takes strided), strided and the wide kernel read them an element at a
// time.  The helper `modulate` (csrc/common.cuh) is K5's: one rounding
// rule, each step rounded to T as PyTorch rounds it, no fused
// multiply-add, so the result is the eager sequence's bits in bf16 and
// float32.

#include <algorithm>

#include "rmsnorm_words.cuh"

namespace {

using namespace rmsnorm_words;

enum : int { kStrided = 0, kVector = 1 };  // ops/rmsnorm_kernel.py

// The epilogue's operands: null scale for none, else scale and shift
// (rows, c) of T with sstride / hstride elements from row to row.
struct Mod {
  const void* scale;
  const void* shift;
  long long sstride;
  long long hstride;
};

template <typename T>
__device__ __forceinline__ float apply(float v, float inv, float wv) {
  if constexpr (sizeof(T) == 2) {
    return round_to<T>(v * round_to<T>(inv)) * wv;
  } else {
    return wv * (v * inv);
  }
}

// ---------------------------------------------------------------------------
// strided variant
// ---------------------------------------------------------------------------

// w[m] as float: w holds T, or float (w_f32) for a bf16 x
template <typename T>
__device__ __forceinline__ float weight_at(const void* w, bool w_f32, int m) {
  return w_f32 ? static_cast<const float*>(w)[m]
               : to_f32(static_cast<const T*>(w)[m]);
}

constexpr int kRowWarps = 16;               // rows in flight a block
constexpr int kRowThreads = 32 * kRowWarps;

// Blocks an SM (__launch_bounds__): two (64 registers a thread), one for
// the widest rows (2,042 to 2,048 bf16 channels, 1,022 to 1,024 float32:
// 9 words a lane), which spill under 64.
__host__ __device__ constexpr int row_blocks_per_sm(int kw) {
  return kw < kMaxWordsPerLane ? 2 : 1;
}

// w lies in shared memory as copies of 16-byte words in x's layout: the
// copy for offset o holds w[m] at position m + o, so that a row whose first
// element lies at position o of its first word finds the weight of its
// word k in word k of that copy.  Rows start at offsets o = ph + r C mod E,
// i.e. at the E / g offsets o = ph mod g + g t (g = gcd(C, E), a power of
// two: 8 offsets for odd C in bf16, 2 for the 8-byte rows of C % 8 == 4),
// and only those copies are staged, copy t for offset ph mod g + g t.
template <typename T> __host__ __device__ constexpr int copy_words(int c) {
  return (c + 2 * (kWordBytes / (int)sizeof(T)) - 2) /
         (kWordBytes / (int)sizeof(T));
}

// g = gcd(C, E): the largest power of two dividing C, at most E
template <typename T> __host__ __device__ constexpr int offset_step(int c) {
  return (c & -c) < kWordBytes / (int)sizeof(T) ? (c & -c)
                                                 : kWordBytes / (int)sizeof(T);
}

template <typename T> __host__ __device__ constexpr int copy_bytes(int c) {
  return kWordBytes * (kWordBytes / (int)sizeof(T)) / offset_step<T>(c) *
         copy_words<T>(c);
}

// y's word from x's word v, the row's inv and w's word wv, in the TPU
// kernel's rounding: for bf16, y = bf16(bf16(x * bf16(inv)) * w) as two
// bf16x2 multiplies a pair (each the correctly rounded product, as the
// float product rounded once is); for float, y = w * (x * inv).
template <typename T>
__device__ __forceinline__ uint4 scale_word(const uint4& v, float inv,
                                            const uint4& wv) {
  uint32_t in[4] = {v.x, v.y, v.z, v.w}, ws[4] = {wv.x, wv.y, wv.z, wv.w};
  uint32_t out[4];
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 inv2 = __float2bfloat162_rn(inv);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const __nv_bfloat162 p = __hmul2(
          __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&in[t]), inv2),
          *reinterpret_cast<const __nv_bfloat162*>(&ws[t]));
      out[t] = *reinterpret_cast<const uint32_t*>(&p);
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      out[t] = __float_as_uint(__uint_as_float(ws[t]) *
                               (__uint_as_float(in[t]) * inv));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// y's word yw through the modulate: the elements whose channel ch0 + j is
// the row's (0 .. c - 1) with s[ch] and h[ch] (the row's scale and shift),
// the others as they are (store_word leaves them out).
template <typename T>
__device__ __forceinline__ uint4 modulate_word(const uint4& yw, const T* s,
                                               const T* h, int ch0, int c) {
  constexpr int E = kWordBytes / sizeof(T);
  float f[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int ch = ch0 + j;
    f[j] = word_elem<T>(yw, j);
    if (ch >= 0 && ch < c)
      f[j] = modulate<T>(f[j], to_f32(s[ch]), to_f32(h[ch]));
  }
  return pack<T>(f);
}

// Row `row`'s words into v, lane `sub` of the row's G (all 0 past the
// last row).
template <typename T, int KW, int G>
__device__ __forceinline__ void load_row(uint4 (&v)[KW], const T* xb,
                                         long long row, long long rows,
                                         int c, int ph, int sub) {
  const Row<T> r(row < rows ? row : 0, c, ph);
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    const int k = sub + G * i;
    v[i] = make_uint4(0, 0, 0, 0);
    if (row < rows && k < r.nw)
      v[i] = load_word<T>(xb, r.k0 + k, r.ch(k, 0), c, ph,
                          ph + rows * (long long)c);
  }
}

// Rows of up to kRegMaxBytes, KW words a lane of the row's G lanes (32,
// or 16 for rows of up to 2 words a lane of a warp, C <= 505 in bf16: two
// rows a warp then share the cost of a row's reduction and of its two
// shared words, which such short rows otherwise pay for few words); w of
// x's type, or float for a bf16 x (w_f32), rounded to T as it is staged.  A
// grid-stride loop over the rows, row_blocks_per_sm blocks an SM, so w is
// staged once a block, and a warp's first rows are loaded before the
// staging, so that their latencies overlap.  Up to 4 words a lane the
// next rows' words are loaded before a row is reduced (4 more registers a
// word; at 5 and 6 words they would spill under the 64 that two blocks
// an SM leave).
template <typename T, int KW, int G, bool MOD>
__global__ void __launch_bounds__(kRowThreads, row_blocks_per_sm(KW))
rmsnorm_rows_kernel(const T* __restrict__ x, const void* __restrict__ w,
                    int w_f32, T* __restrict__ y, long long rows, int c,
                    float eps, int ph, int whole_stores, Mod m) {
  constexpr int E = kWordBytes / sizeof(T);
  constexpr int kRowsPerWarp = 32 / G;
  constexpr bool kPrefetch = KW <= 4;
  extern __shared__ uint4 wsh[];   // (E / g, copy_words(c)) w's copies
  const int sub = threadIdx.x % G;
  const T* xb = x - ph;            // the 16-byte boundaries below x and y
  T* yb = y - ph;
  const long long stride = (long long)gridDim.x * kRowWarps * kRowsPerWarp;
  // the warp's first row (the same in all its lanes: the loop's bound)
  long long base = ((long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5)) *
                   kRowsPerWarp;
  const int slot = (threadIdx.x & 31) / G;
  uint4 v[KW];
  load_row<T, KW, G>(v, xb, base + slot, rows, c, ph, sub);

  const int cw = copy_words<T>(c), g = offset_step<T>(c);
  const int lg = __ffs(g) - 1, o0 = ph & (g - 1);
  for (int i = threadIdx.x; i < (E >> lg) * cw; i += kRowThreads) {
    const int t = i / cw, k = i - t * cw, o = o0 + (t << lg);
    float f[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int m = k * E + j - o;
      f[j] = m >= 0 && m < c ? weight_at<T>(w, w_f32, m) : 0.f;
    }
    wsh[i] = pack<T>(f);
  }
  __syncthreads();

  for (; base < rows; base += stride) {
    const long long row = base + slot;
    uint4 next[kPrefetch ? KW : 1];
    if constexpr (kPrefetch)
      load_row<T, KW, G>(next, xb, row + stride, rows, c, ph, sub);
    const Row<T> r(row < rows ? row : 0, c, ph);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = sub + G * i, ch0 = r.ch(k, 0);
      if (k < r.nw && (ch0 < 0 || ch0 + E > c))
        v[i] = row_part<T>(v[i], ch0, c);   // a word shared with a neighbour
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = word_elem<T>(v[i], j);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)   // every lane: G-lane groups
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / (float)c + eps);
    const uint4* wr = wsh + ((r.off - o0) >> lg) * cw;
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = sub + G * i;
      if (row < rows && k < r.nw) {
        uint4 yw = scale_word<T>(v[i], inv, wr[k]);
        if constexpr (MOD)
          yw = modulate_word<T>(
              yw, static_cast<const T*>(m.scale) + row * m.sstride,
              static_cast<const T*>(m.shift) + row * m.hstride, r.ch(k, 0),
              c);
        store_word<T>(yb, r.k0 + k, r.ch(k, 0), c, whole_stores != 0, yw);
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < KW; ++i) v[i] = next[i];
    } else {
      load_row<T, KW, G>(v, xb, row + stride, rows, c, ph, sub);
    }
  }
}

constexpr int kWideWarps = 8;   // rows a block of the two-pass kernel

// Rows over kRegMaxBytes: one warp a row, a strided pass for the sum of
// squares, a second that re-reads the row (from L1) and writes y.
template <typename T, bool MOD>
__global__ void __launch_bounds__(kWideWarps * 32)
rmsnorm_wide_kernel(const T* __restrict__ x, const void* __restrict__ w,
                    int w_f32, T* __restrict__ y, long long rows, int c,
                    float eps, Mod m) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWideWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * c;
  T* yr = y + row * c;

  float ss = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)c + eps);

  const T* sr = static_cast<const T*>(m.scale) + row * m.sstride;
  const T* hr = static_cast<const T*>(m.shift) + row * m.hstride;
  for (int i = lane; i < c; i += 32) {
    float v = apply<T>(to_f32(xr[i]), inv,
                       round_to<T>(weight_at<T>(w, w_f32, i)));
    if constexpr (MOD)
      v = modulate<T>(round_to<T>(v), to_f32(sr[i]), to_f32(hr[i]));
    yr[i] = from_f32<T>(v);
  }
}

// ---------------------------------------------------------------------------
// vector variant
// ---------------------------------------------------------------------------

constexpr int kVecThreads = 256;
constexpr int kVecMax = 4;        // 16-byte vectors a lane holds
constexpr int kVecMaxBytes = 32 * kVecMax * 16;   // one row, at most

// element j of a 16-byte vector of T, as float (bf16 is the high half of
// a float, element 2i the low half of word i)
template <typename T> __device__ __forceinline__ float elem(const uint4& v,
                                                            int j) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w = word(v, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(word(v, j));
  }
}

// w's 16-byte vector vi in x's type: for WF32 (a float32 weight of a bf16
// x) its two float vectors, each element rounded to bf16 (w.astype(x.dtype)
// of the TPU kernel's order, as a cast before the call rounds it)
template <typename T, bool WF32>
__device__ __forceinline__ uint4 weight_vec(const void* w, int vi) {
  if constexpr (WF32) {
    const float4* wf = static_cast<const float4*>(w) + 2 * vi;
    const float4 a = wf[0], b = wf[1];
    return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                      pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
  } else {
    return static_cast<const uint4*>(w)[vi];
  }
}

// With MOD the row's scale and shift vectors are loaded beside x's, so
// that their latency overlaps the reduction's.
template <typename T, int G, bool WF32, bool MOD>
__global__ void __launch_bounds__(kVecThreads)
rmsnorm_kernel_vec(const T* __restrict__ x, const void* __restrict__ w,
                   T* __restrict__ y, long long rows, int c, float eps,
                   Mod m) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int nvec = c / E;
  const int sub = threadIdx.x % G;   // lane within the row's group
  const long long row =
      (long long)blockIdx.x * (kVecThreads / G) + threadIdx.x / G;
  const bool live = row < rows;      // dead lanes still join the shuffles
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * c);

  const long long lrow = live ? row : 0;
  const uint4* sr = reinterpret_cast<const uint4*>(
      static_cast<const T*>(m.scale) + lrow * m.sstride);
  const uint4* hr = reinterpret_cast<const uint4*>(
      static_cast<const T*>(m.shift) + lrow * m.hstride);

  uint4 xv[kVecMax], wv[kVecMax], sv[MOD ? kVecMax : 1],
      hv[MOD ? kVecMax : 1];
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    const int vi = sub + i * G;
    xv[i] = wv[i] = make_uint4(0, 0, 0, 0);
    if constexpr (MOD) sv[i] = hv[i] = make_uint4(0, 0, 0, 0);
    if (live && vi < nvec) {
      xv[i] = xr[vi];
      wv[i] = weight_vec<T, WF32>(w, vi);
      if constexpr (MOD) {
        sv[i] = sr[vi];
        hv[i] = hr[vi];
      }
    }
  }
  float ss = 0.f;   // zero vectors add nothing
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float v = elem<T>(xv[i], j);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)c + eps);
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(y + row * c);
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    const int vi = sub + i * G;
    if (vi < nvec) {
      float out[E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        out[j] = apply<T>(elem<T>(xv[i], j), inv, elem<T>(wv[i], j));
        if constexpr (MOD)
          out[j] = modulate<T>(round_to<T>(out[j]), elem<T>(sv[i], j),
                               elem<T>(hv[i], j));
      }
      yr[vi] = pack<T>(out);
    }
  }
}

struct Args {
  const void* x;
  const void* w;
  void* y;
  long long rows;
  int c;
  float eps;
  cudaStream_t stream;
  Mod m;   // m.scale null: no epilogue
};

template <typename T, int KW, int G, bool MOD>
int launch_rows_m(const Args& a, bool w_f32) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  constexpr int kRowsPerBlock = kRowWarps * 32 / G;
  const long long blocks = std::min<long long>(
      (a.rows + kRowsPerBlock - 1) / kRowsPerBlock,
      (long long)row_blocks_per_sm(KW) * sms);
  rmsnorm_rows_kernel<T, KW, G, MOD><<<(unsigned)blocks, kRowThreads,
                                       copy_bytes<T>(a.c), a.stream>>>(
      static_cast<const T*>(a.x), a.w, w_f32, static_cast<T*>(a.y), a.rows,
      a.c, a.eps, phase<T>(a.x),
      (reinterpret_cast<uintptr_t>(a.y) - reinterpret_cast<uintptr_t>(a.x))
              % kWordBytes == 0, a.m);
  return (int)cudaGetLastError();
}

template <typename T, int KW, int G>
int launch_rows(const Args& a, bool w_f32) {
  return a.m.scale != nullptr ? launch_rows_m<T, KW, G, true>(a, w_f32)
                              : launch_rows_m<T, KW, G, false>(a, w_f32);
}

// w_f32: w holds float (x's type otherwise)
template <typename T>
int launch_strided(const Args& a, bool w_f32) {
  if ((long long)a.c * sizeof(T) > kRegMaxBytes) {
    const long long blocks = (a.rows + kWideWarps - 1) / kWideWarps;
    if (a.m.scale != nullptr)
      rmsnorm_wide_kernel<T, true><<<(unsigned)blocks, kWideWarps * 32, 0,
                                     a.stream>>>(
          static_cast<const T*>(a.x), a.w, w_f32, static_cast<T*>(a.y),
          a.rows, a.c, a.eps, a.m);
    else
      rmsnorm_wide_kernel<T, false><<<(unsigned)blocks, kWideWarps * 32, 0,
                                      a.stream>>>(
          static_cast<const T*>(a.x), a.w, w_f32, static_cast<T*>(a.y),
          a.rows, a.c, a.eps, a.m);
    return (int)cudaGetLastError();
  }
  switch (words_per_lane<T>(a.c)) {
    case 1:
    case 2:   // short rows: half a warp each
      switch (words_per_lane<T>(a.c, 16)) {
        case 1: return launch_rows<T, 1, 16>(a, w_f32);
        case 2: return launch_rows<T, 2, 16>(a, w_f32);
        case 3: return launch_rows<T, 3, 16>(a, w_f32);
        default: return launch_rows<T, 4, 16>(a, w_f32);
      }
    case 3: return launch_rows<T, 3, 32>(a, w_f32);
    case 4: return launch_rows<T, 4, 32>(a, w_f32);
    case 5: return launch_rows<T, 5, 32>(a, w_f32);
    case 6: return launch_rows<T, 6, 32>(a, w_f32);
    case 7: return launch_rows<T, 7, 32>(a, w_f32);
    case 8: return launch_rows<T, 8, 32>(a, w_f32);
    default: return launch_rows<T, kMaxWordsPerLane, 32>(a, w_f32);
  }
}

template <typename T, int G, bool WF32>
int launch_vec_g(const Args& a) {
  constexpr int rows_per_block = kVecThreads / G;
  const long long blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  if (a.m.scale != nullptr)
    rmsnorm_kernel_vec<T, G, WF32, true><<<(unsigned)blocks, kVecThreads, 0,
                                           a.stream>>>(
        static_cast<const T*>(a.x), a.w, static_cast<T*>(a.y), a.rows, a.c,
        a.eps, a.m);
  else
    rmsnorm_kernel_vec<T, G, WF32, false><<<(unsigned)blocks, kVecThreads,
                                            0, a.stream>>>(
        static_cast<const T*>(a.x), a.w, static_cast<T*>(a.y), a.rows, a.c,
        a.eps, a.m);
  return (int)cudaGetLastError();
}

template <typename T, bool WF32>
int launch_vector(const Args& a) {
  const int nvec = a.c / (16 / (int)sizeof(T));
  int g = 1;
  while (g < 32 && g * kVecMax < nvec) g *= 2;
  switch (g) {
    case 1: return launch_vec_g<T, 1, WF32>(a);
    case 2: return launch_vec_g<T, 2, WF32>(a);
    case 4: return launch_vec_g<T, 4, WF32>(a);
    case 8: return launch_vec_g<T, 8, WF32>(a);
    case 16: return launch_vec_g<T, 16, WF32>(a);
    default: return launch_vec_g<T, 32, WF32>(a);
  }
}

template <typename T>
int launch(const Args& a, int w_dtype, int variant) {
  const bool w_same = w_dtype == (sizeof(T) == 2 ? kBFloat16 : kFloat32);
  // a float32 weight of a bf16 x: both variants round it in the kernel
  const bool w_f32 = sizeof(T) == 2 && w_dtype == kFloat32;
  if (variant == kStrided && (w_same || w_f32))
    return launch_strided<T>(a, w_f32);
  if (variant != kVector || !(w_same || w_f32) || a.c % 8 != 0 ||
      (long long)a.c * sizeof(T) > kVecMaxBytes || !aligned16(a.x) ||
      !aligned16(a.w) || !aligned16(a.y))
    return (int)cudaErrorInvalidValue;
  if (a.m.scale != nullptr &&
      (!aligned16(a.m.scale) || !aligned16(a.m.shift) ||
       a.m.sstride * (long long)sizeof(T) % 16 != 0 ||
       a.m.hstride * (long long)sizeof(T) % 16 != 0))
    return (int)cudaErrorInvalidValue;   // vector reads s, sh by 16 bytes
  if constexpr (sizeof(T) == 2) {
    if (w_f32) return launch_vector<T, true>(a);
  }
  return launch_vector<T, false>(a);
}

}  // namespace

// x, w, y: device pointers, x/y row-major (rows, c) of dtype, w (c,) of
// w_dtype: dtype, or float32 for a bf16 x (rounded to bf16 in the
// kernel); variant: 0 strided, 1 vector (within the limits
// above: a variant that cannot take the call is an error, never a
// fallback).  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_rmsnorm(const void* x, const void* w, void* y,
                           long long rows, int c, float eps, int dtype,
                           int w_dtype, int variant, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, w, y, rows, c, eps, static_cast<cudaStream_t>(stream),
               Mod{nullptr, nullptr, 0, 0}};
  switch (dtype) {
    case kFloat32: return launch<float>(a, w_dtype, variant);
    case kBFloat16: return launch<__nv_bfloat16>(a, w_dtype, variant);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1 with the modulate epilogue: tmt_rmsnorm's arguments, then scale and
// shift, device pointers to (rows, c) of dtype whose rows lie sstride and
// hstride elements apart (at least c: a row's channels are contiguous).
// The vector variant also needs scale and shift 16-byte aligned and their
// row strides whole 16-byte vectors; an error otherwise, never a fallback.
extern "C" int tmt_rmsnorm_modulate(const void* x, const void* w, void* y,
                                    long long rows, int c, float eps,
                                    int dtype, int w_dtype, int variant,
                                    const void* scale, const void* shift,
                                    long long sstride, long long hstride,
                                    void* stream) {
  if (rows <= 0 || c <= 0 || scale == nullptr || shift == nullptr ||
      sstride < c || hstride < c)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, y, rows, c, eps, static_cast<cudaStream_t>(stream),
               Mod{scale, shift, sstride, hstride}};
  switch (dtype) {
    case kFloat32: return launch<float>(a, w_dtype, variant);
    case kBFloat16: return launch<__nv_bfloat16>(a, w_dtype, variant);
    default: return (int)cudaErrorInvalidValue;
  }
}
