// K1b: RMSNorm backward.  For y = w * x * inv, inv = rsqrt(mean(x^2) + eps)
// over each row of C channels and an incoming gradient g:
//   dx = inv * (g w) - inv^3 * x * mean((g w) x)   (per row)
//   dw = sum over rows of g * x * inv               (per channel)
// all in float32, dx rounded once to x's type, dw written as float32.
//
// Replaces the backward rule of the Pallas kernel's custom_vjp,
// tera_mind_tpu/ops/rmsnorm_kernel.py _bwd (XLA maths in the JAX
// package).  Bound by memory: x and g are read, dx written, a few
// operations an element.  Each row kernel reads a row of x and g once
// into registers, recomputes the row's statistics in float32 from them
// (sum of squares and sum of (g w) x), writes dx from the same registers
// and adds its share of dw, g * x * inv, to float sums by channel that
// stay in registers (or, where a lane's channels change from row to row,
// in its warp's row of shared memory) over all the rows its lanes visit
// (a grid-stride loop, so the grid has at most kMaxBlocks blocks).  At
// the end the block sums its rows' dw in a fixed order into its row of
// `partial` (blocks x C floats, allocated by the caller), and
// rmsnorm_bwd_dw_kernel sums `partial` over the blocks: one block per 32
// channels, 8 row groups each taking every 8th block in order, then the 8
// group sums in order.  No float atomics: the same inputs give the same
// dw bit for bit.  Two
// variants, chosen by the caller from C, dtype and pointer alignment
// before the launch (ops/rmsnorm_kernel.py rmsnorm_bwd_variant), as K1's:
//
// vector (C % 8 == 0, C * sizeof(T) <= 2048, x, g, w, dx 16-byte aligned):
//   a row belongs to a group of G lanes, G the smallest power of two that
//   leaves each lane at most kVecMax 16-byte vectors (csrc/rmsnorm.cu's
//   launch_vector); a lane loads its vectors of x and g with every load
//   in flight before the first use, reduces inside the group with
//   __shfl_xor_sync and writes dx as 16-byte stores.  Its channels' w
//   (float) are loaded once into registers, and its channels' dw sums
//   stay there; the block's kVecThreads / G groups meet in shared memory.
// strided (any other C or pointer: the odd C of the gene concats, 337 to
//   1,253, and the 500-gene presets' rows over 2 KB, 1,012 to 1,524): one
//   warp a row, 8 rows in flight a block, w staged once a block in shared
//   memory, and the row read from device memory once, by one of two
//   designs:
//   - C <= 32 * kLaneRowMaxPer = 1,280: lane i holds channels i, i + 32,
//     ... of x and g in registers (bf16 two to a register, so that two
//     blocks fit an SM) and sums its channels' dw in registers.
//   - bf16 rows of 1,281 to 32 * kStridedMaxPer = 2,048 channels: the word
//     scheme of csrc/rmsnorm_words.cuh.  A lane holds words_per_lane(C)
//     16-byte words of x and of g (C = 1,524: 6 each, 48 registers), all
//     loaded before the first use (a warp's first row before the block
//     builds its tables), and writes dx from them: 16-byte stores inside
//     the row, the widest aligned pieces on the two words it shares with
//     its neighbours.  A row's words start at another lane with every row
//     (odd C, or C % 8 != 0), so a lane's channels change from row to row
//     and its dw sums cannot stay in registers: each warp sums its rows'
//     dw in its own row of shared memory, padded as the weight is (one
//     float after every 8 channels, so the lanes' reads and read-add-
//     writes hit 32 banks), with kSlack zero floats before and after: in
//     the two shared words the neighbours' elements of x and g are set to
//     0, so every word runs the same arithmetic with no test an element,
//     those elements reading the slack's weight and adding 0 to the
//     slack's sums.  9 rows of 7.0 KB a block at C = 1,524 (63 KB), 84 KB
//     at 2,048, two blocks an SM.  x and g must share their phase within
//     16 bytes (the wrappers' tensors do); else, and for wider rows or
//     float32 rows over 1,280 channels (none on any path: the edge C =
//     2,050), the first design stays: a second pass over the row for dx
//     (from L1) and the warp's dw summed in its own row of shared memory.
// The grid (ops/rmsnorm_kernel.py bwd_blocks) stops at two blocks an SM,
// so a block's lanes visit many rows and `partial` stays small.

#include "rmsnorm_words.cuh"

namespace {

using namespace rmsnorm_words;

enum : int { kStrided = 0, kVector = 1 };  // ops/rmsnorm_kernel.py

constexpr int kBwdWarps = 8;                  // rows in flight a block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kMaxBlocks = 8 * 132;           // ops/rmsnorm_kernel.py
constexpr int kMaxC = kMaxBlockSmem / (4 * kBwdWarps);   // 7,264
constexpr int kLaneRowMaxPer = 40;            // channels a lane holds
constexpr int kStridedMaxPer = 64;            // bf16: in registers, words
constexpr int kVecThreads = 256;
constexpr int kVecMax = 4;                    // 16-byte vectors a lane holds
constexpr int kVecMaxBytes = 32 * kVecMax * 16;   // one row, at most

// ---------------------------------------------------------------------------
// strided variant
// ---------------------------------------------------------------------------

// The PER channels lane, lane + 32, ... of a row that a lane keeps: floats
// for float rows; for bf16 rows two to a 32-bit register (channels k and
// k + 1 of the lane in the low and high half of word k / 2).
template <typename T, int PER> struct LaneRow {
  float v[PER];
  __device__ __forceinline__ void load(const T* r, int lane, int c) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < c ? to_f32(r[i]) : 0.f;
    }
  }
  __device__ __forceinline__ float operator[](int k) const { return v[k]; }
};

template <int PER> struct LaneRow<__nv_bfloat16, PER> {
  uint32_t v[PER / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* r, int lane,
                                       int c) {
    const unsigned short* b = reinterpret_cast<const unsigned short*>(r);
#pragma unroll
    for (int k = 0; k < PER; k += 2) {
      const int i = lane + 32 * k;
      const uint32_t lo = i < c ? b[i] : 0u, hi = i + 32 < c ? b[i + 32] : 0u;
      v[k / 2] = lo | (hi << 16);
    }
  }
  __device__ __forceinline__ float operator[](int k) const {
    return (k & 1) ? bf16_high(v[k / 2]) : bf16_low(v[k / 2]);
  }
};

// Two blocks an SM for bf16 rows (packed, they fit 128 registers a
// thread); float rows of up to 40 channels a lane take more.
template <typename T, int PER>
__global__ void __launch_bounds__(kBwdThreads, sizeof(T) == 2 ? 2 : 1)
rmsnorm_bwd_strided_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ w, T* __restrict__ dx,
                           float* __restrict__ partial, long long rows,
                           int c, float eps) {
  extern __shared__ float smem[];
  float* ws = smem;               // (c) the weight
  float* sdw = smem + c;          // (kBwdWarps, c) each warp's dw sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < c; i += kBwdThreads) ws[i] = w[i];
  __syncthreads();

  float dw[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) dw[k] = 0.f;
  const long long stride = (long long)gridDim.x * kBwdWarps;
  for (long long row = (long long)blockIdx.x * kBwdWarps + warp; row < rows;
       row += stride) {
    LaneRow<T, PER> xv, gv;
    xv.load(x + row * c, lane, c);
    gv.load(g + row * c, lane, c);
    float ss = 0.f, gwx = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      if (i < c) {
        ss = fmaf(xv[k], xv[k], ss);
        gwx = fmaf(gv[k] * ws[i], xv[k], gwx);
      }
    }
    ss = warp_sum(ss);
    gwx = warp_sum(gwx);
    const float inv = rsqrtf(ss / (float)c + eps);
    const float inv3 = inv * inv * inv;
    const float m = gwx / (float)c;
    T* dr = dx + row * c;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      if (i < c) {
        dr[i] = from_f32<T>(inv * (gv[k] * ws[i]) - inv3 * xv[k] * m);
        dw[k] += gv[k] * xv[k] * inv;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane + 32 * k;
    if (i < c) sdw[warp * c + i] = dw[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kBwdWarps; ++wi) s += sdw[wi * c + i];
    partial[(long long)blockIdx.x * c + i] = s;
  }
}

// bf16 rows of 32 * kLaneRowMaxPer + 1 to 32 * kStridedMaxPer channels, KW
// words of x and of g a lane (the word scheme of csrc/rmsnorm_words.cuh;
// x, g and dx share their phase ph, or dx is written element by element).
// The weight and each warp's dw sums lie in padded rows of shared memory
// with kSlack floats before and after each: a word the row shares with a
// neighbour has the neighbour's elements of x and g set to 0, so every
// word runs the same arithmetic with no test an element, its outside
// elements reading the slack's weight and adding 0 to the slack's dw.
constexpr int kSlack = 16;

template <typename T> __host__ __device__ constexpr int slack_row(int c) {
  return (padded<T>(c) + 2 * kSlack + 3) / 4 * 4;   // whole float4s
}

template <typename T, int KW>
__global__ void __launch_bounds__(kBwdThreads, 2)
rmsnorm_bwd_words_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ w, T* __restrict__ dx,
                         float* __restrict__ partial, long long rows, int c,
                         float eps, int ph, int whole_stores) {
  constexpr int E = kWordBytes / sizeof(T);
  const int cp = slack_row<T>(c);     // floats of a padded row
  extern __shared__ float smem[];
  float* ws = smem + kSlack;          // (cp) the weight
  float* sdw = smem + cp + kSlack;    // (kBwdWarps, cp) each warp's dw sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xb = x - ph;   // the 16-byte boundaries below x, g and dx
  const T* gb = g - ph;
  T* db = dx - ph;
  const long long end = ph + rows * (long long)c;
  const long long stride = (long long)gridDim.x * kBwdWarps;
  // a row's words of x and g (0 past the last row)
  uint4 xv[KW], gv[KW];
  auto load = [&](long long row) {
    const Row<T> r(row < rows ? row : 0, c, ph);
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = lane + 32 * i;
      xv[i] = gv[i] = make_uint4(0, 0, 0, 0);
      if (row < rows && k < r.nw) {
        xv[i] = load_word<T>(xb, r.k0 + k, r.ch(k, 0), c, ph, end);
        gv[i] = load_word<T>(gb, r.k0 + k, r.ch(k, 0), c, ph, end);
      }
    }
  };
  long long row = (long long)blockIdx.x * kBwdWarps + warp;
  load(row);   // before the tables: its latency hides theirs

  float4* z = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < (1 + kBwdWarps) * cp / 4; i += kBwdThreads)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kBwdThreads) ws[padded<T>(i)] = w[i];
  __syncthreads();
  float* mine = sdw + warp * cp;

  for (; row < rows; row += stride) {
    const Row<T> r(row, c, ph);
    // channel ch0 + j of word k lies at ws[k + ch0 + j - (j < off)]
    float ss = 0.f, gwx = 0.f;
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = lane + 32 * i, ch0 = r.ch(k, 0);
      if (k >= r.nw) continue;
      if (ch0 < 0 || ch0 + E > c) {
        xv[i] = row_part<T>(xv[i], ch0, c);
        gv[i] = row_part<T>(gv[i], ch0, c);
      }
      const float* wk = ws + k + ch0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xf = word_elem<T>(xv[i], j);
        ss = fmaf(xf, xf, ss);
        gwx = fmaf(word_elem<T>(gv[i], j) * wk[j - (j < r.off ? 1 : 0)], xf,
                   gwx);
      }
    }
    ss = warp_sum(ss);
    gwx = warp_sum(gwx);
    const float inv = rsqrtf(ss / (float)c + eps);
    const float inv3 = inv * inv * inv;
    const float m = gwx / (float)c;
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = lane + 32 * i, ch0 = r.ch(k, 0);
      if (k < r.nw) {
        const float* wk = ws + k + ch0;
        float* dk = mine + k + ch0;
        float out[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int at = j - (j < r.off ? 1 : 0);
          const float xf = word_elem<T>(xv[i], j);
          const float gf = word_elem<T>(gv[i], j);
          out[j] = inv * (gf * wk[at]) - inv3 * xf * m;
          dk[at] += gf * xf * inv;
        }
        store_word<T>(db, r.k0 + k, ch0, c, whole_stores != 0, pack<T>(out));
      }
    }
    load(row + stride);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kBwdWarps; ++wi) s += sdw[wi * cp + padded<T>(i)];
    partial[(long long)blockIdx.x * c + i] = s;
  }
}

// rows the register designs do not take (above)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ w, T* __restrict__ dx,
                        float* __restrict__ partial, long long rows, int c,
                        float eps) {
  extern __shared__ float sdw[];  // (kBwdWarps, c): each warp's dw sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = sdw + warp * c;
  for (int i = lane; i < c; i += 32) mine[i] = 0.f;

  const long long stride = (long long)gridDim.x * kBwdWarps;
  for (long long row = (long long)blockIdx.x * kBwdWarps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * c;
    const T* gr = g + row * c;
    float ss = 0.f, gwx = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float xv = to_f32(xr[i]);
      ss = fmaf(xv, xv, ss);
      gwx = fmaf(to_f32(gr[i]) * w[i], xv, gwx);
    }
    ss = warp_sum(ss);
    gwx = warp_sum(gwx);
    const float inv = rsqrtf(ss / (float)c + eps);
    const float inv3 = inv * inv * inv;
    const float m = gwx / (float)c;
    T* dr = dx + row * c;
    for (int i = lane; i < c; i += 32) {
      const float xv = to_f32(xr[i]);
      const float gv = to_f32(gr[i]);
      dr[i] = from_f32<T>(inv * (gv * w[i]) - inv3 * xv * m);
      mine[i] += gv * xv * inv;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kBwdWarps; ++wi) s += sdw[wi * c + i];
    partial[(long long)blockIdx.x * c + i] = s;
  }
}

// ---------------------------------------------------------------------------
// vector variant
// ---------------------------------------------------------------------------

// element j of a 16-byte vector of T, as float (bf16 is the high half of
// a float, element 2i the low half of word i), bf16 converted anew at each
// use as in the strided variant
template <typename T> __device__ __forceinline__ float elem(const uint4& v,
                                                            int j) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u = word(v, j >> 1);
    return (j & 1) ? bf16_high(u) : bf16_low(u);
  } else {
    return __uint_as_float(word(v, j));
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kVecThreads, 2)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ partial, long long rows, int c,
                       float eps) {
  constexpr int E = 16 / sizeof(T);     // elements a vector
  constexpr int kGroups = kVecThreads / G;
  extern __shared__ float sdw[];        // (kGroups, c): each group's dw
  const int nvec = c / E;
  const int sub = threadIdx.x % G;      // lane within the row's group
  const int grp = threadIdx.x / G;

  // this lane's channels: vector sub + i G, elements e
  float wv[kVecMax][E], dw[kVecMax][E];
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    const int vi = sub + i * G;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      wv[i][e] = vi < nvec ? w[vi * E + e] : 0.f;
      dw[i][e] = 0.f;
    }
  }
  // the loop runs as often in every lane (dead groups still join the
  // shuffles)
  const long long stride = (long long)gridDim.x * kGroups;
  for (long long row0 = (long long)blockIdx.x * kGroups; row0 < rows;
       row0 += stride) {
    const long long row = row0 + grp;
    const bool live = row < rows;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + (live ? row : 0) * c);
    const uint4* gr =
        reinterpret_cast<const uint4*>(g + (live ? row : 0) * c);
    uint4 xv[kVecMax], gv[kVecMax];
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      const int vi = sub + i * G;
      xv[i] = gv[i] = make_uint4(0, 0, 0, 0);
      if (live && vi < nvec) {
        xv[i] = xr[vi];
        gv[i] = gr[vi];
      }
    }
    float ss = 0.f, gwx = 0.f;   // zero vectors add nothing
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xf = elem<T>(xv[i], e);
        ss = fmaf(xf, xf, ss);
        gwx = fmaf(elem<T>(gv[i], e) * wv[i][e], xf, gwx);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gwx += __shfl_xor_sync(0xffffffffu, gwx, off);
    }
    if (!live) continue;
    const float inv = rsqrtf(ss / (float)c + eps);
    const float inv3 = inv * inv * inv;
    const float m = gwx / (float)c;
    uint4* dr = reinterpret_cast<uint4*>(dx + row * c);
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      const int vi = sub + i * G;
      if (vi < nvec) {
        float out[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xf = elem<T>(xv[i], e), gf = elem<T>(gv[i], e);
          out[e] = inv * (gf * wv[i][e]) - inv3 * xf * m;
          dw[i][e] += gf * xf * inv;
        }
        dr[vi] = pack<T>(out);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    const int vi = sub + i * G;
    if (vi < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) sdw[grp * c + vi * E + e] = dw[i][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kVecThreads) {
    float s = 0.f;
#pragma unroll 4
    for (int r = 0; r < kGroups; ++r) s += sdw[r * c + i];
    partial[(long long)blockIdx.x * c + i] = s;
  }
}

// ---------------------------------------------------------------------------
// the dw reduction over the blocks, and the launchers
// ---------------------------------------------------------------------------

constexpr int kDwGroups = 8;

__global__ void __launch_bounds__(32 * kDwGroups)
rmsnorm_bwd_dw_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int blocks, int c) {
  __shared__ float acc[kDwGroups][33];
  const int cl = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cl;
  float s = 0.f;
  if (col < c)
    for (int b = grp; b < blocks; b += kDwGroups)
      s += partial[(long long)b * c + col];
  acc[grp][cl] = s;
  __syncthreads();
  if (grp == 0 && col < c) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kDwGroups; ++r) t += acc[r][cl];
    dw[col] = t;
  }
}

struct Args {
  const void* x;
  const void* g;
  const float* w;
  void* dx;
  float* partial;
  long long rows;
  int c, blocks;
  float eps;
  cudaStream_t stream;
};

template <typename T, int PER>
int launch_strided_per(const Args& a) {
  rmsnorm_bwd_strided_kernel<T, PER><<<a.blocks, kBwdThreads,
                                       sizeof(float) * (1 + kBwdWarps) * a.c,
                                       a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.w,
      static_cast<T*>(a.dx), a.partial, a.rows, a.c, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int KW>
int launch_words(const Args& a) {
  constexpr int kMaxSmem = (int)sizeof(float) * (1 + kBwdWarps) *
                           slack_row<T>(32 * kStridedMaxPer);
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(rmsnorm_bwd_words_kernel<T, KW>,
                                       kMaxSmem, opted_in);
  if (attr != cudaSuccess) return (int)attr;
  rmsnorm_bwd_words_kernel<T, KW><<<
      a.blocks, kBwdThreads,
      sizeof(float) * (1 + kBwdWarps) * slack_row<T>(a.c), a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.w,
      static_cast<T*>(a.dx), a.partial, a.rows, a.c, a.eps,
      phase<T>(a.x),
      (reinterpret_cast<uintptr_t>(a.dx) - reinterpret_cast<uintptr_t>(a.x))
              % kWordBytes == 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_strided(const Args& a) {
  const int per = (a.c + 31) / 32;
  if (per <= 8) return launch_strided_per<T, 8>(a);
  if (per <= 16) return launch_strided_per<T, 16>(a);
  if (per <= 24) return launch_strided_per<T, 24>(a);
  if (per <= 32) return launch_strided_per<T, 32>(a);
  if (per <= kLaneRowMaxPer) return launch_strided_per<T, kLaneRowMaxPer>(a);
  if constexpr (sizeof(T) == 2) {
    const bool same_phase = (reinterpret_cast<uintptr_t>(a.g) -
                             reinterpret_cast<uintptr_t>(a.x)) %
                                kWordBytes == 0;
    if (per <= kStridedMaxPer && same_phase) {
      switch (words_per_lane<T>(a.c)) {
        case 6: return launch_words<T, 6>(a);
        case 7: return launch_words<T, 7>(a);
        case 8: return launch_words<T, 8>(a);
        default: return launch_words<T, kMaxWordsPerLane>(a);
      }
    }
  }
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(
      rmsnorm_bwd_wide_kernel<T>, (int)(sizeof(float) * kBwdWarps * kMaxC),
      opted_in);
  if (attr != cudaSuccess) return (int)attr;
  rmsnorm_bwd_wide_kernel<T><<<a.blocks, kBwdThreads,
                               sizeof(float) * kBwdWarps * a.c, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.w,
      static_cast<T*>(a.dx), a.partial, a.rows, a.c, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_vec_g(const Args& a) {
  rmsnorm_bwd_vec_kernel<T, G><<<a.blocks, kVecThreads,
                                 sizeof(float) * (kVecThreads / G) * a.c,
                                 a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.w,
      static_cast<T*>(a.dx), a.partial, a.rows, a.c, a.eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vector(const Args& a) {
  const int nvec = a.c / (16 / (int)sizeof(T));
  int g = 1;
  while (g < 32 && g * kVecMax < nvec) g *= 2;
  switch (g) {
    case 1: return launch_vec_g<T, 1>(a);
    case 2: return launch_vec_g<T, 2>(a);
    case 4: return launch_vec_g<T, 4>(a);
    case 8: return launch_vec_g<T, 8>(a);
    case 16: return launch_vec_g<T, 16>(a);
    default: return launch_vec_g<T, 32>(a);
  }
}

template <typename T>
int launch(const Args& a, int variant, float* dw) {
  int err;
  if (variant == kStrided) {
    err = launch_strided<T>(a);
  } else if (variant == kVector && a.c % 8 == 0 &&
             (long long)a.c * sizeof(T) <= kVecMaxBytes && aligned16(a.x) &&
             aligned16(a.g) && aligned16(a.w) && aligned16(a.dx)) {
    err = launch_vector<T>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw_kernel<<<(a.c + 31) / 32, 32 * kDwGroups, 0, a.stream>>>(
      a.partial, dw, a.blocks, a.c);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, dx: device pointers to row-major (rows, c) arrays of one dtype;
// w (c,) and dw (c,) float32; partial: float32 scratch of blocks x c;
// blocks: the row kernel's grid, 1 to kMaxBlocks (the caller sizes
// partial by it); variant: 0 strided, 1 vector (within the limits above:
// a variant that cannot take the call is an error, never a fallback).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int tmt_rmsnorm_bwd(const void* x, const void* g, const void* w,
                               void* dx, void* partial, void* dw,
                               long long rows, int c, int blocks, float eps,
                               int dtype, int variant, void* stream) {
  if (rows <= 0 || c <= 0 || c > kMaxC || blocks <= 0 ||
      blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const Args a{x, g, static_cast<const float*>(w), dx,
               static_cast<float*>(partial), rows, c, blocks, eps,
               static_cast<cudaStream_t>(stream)};
  auto dwf = static_cast<float*>(dw);
  switch (dtype) {
    case kFloat32: return launch<float>(a, variant, dwf);
    case kBFloat16: return launch<__nv_bfloat16>(a, variant, dwf);
    default: return (int)cudaErrorInvalidValue;
  }
}
