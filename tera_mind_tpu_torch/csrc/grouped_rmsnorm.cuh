// The layout that K5 (csrc/grouped_rmsnorm.cu) and K5b
// (csrc/grouped_rmsnorm_bwd.cu) share: a packed row of Z * Ctot elements
// made of S plainly concatenated segments (c_0 .. c_{S-1} channels a
// plane, Ctot their sum), each z-major inside, so that channel j of plane
// z in segment s is element off_s + z c_s + j, off_s = Z (c_0 + ... +
// c_{s-1}).  The weight is the runtime layout (element e reads w[e]) or,
// from_5d, the 5D model's (Ctot,): element (s, z, j) reads w[cum_s + j],
// cum_s = c_0 + ... + c_{s-1}.
//
// Both kernels have the same two variants, chosen by the caller
// (ops/grouped_rmsnorm_kernel.py grouped_variant):
//
// vector (every c_s % 8 == 0, a row of at most kVecMaxBytes, every tensor
//   16-byte aligned): no 16-byte vector straddles a plane, and since rows
//   start on 16 bytes a lane's vectors (sub, sub + G, ... of its row's G
//   lanes) lie at the same places in every row: VecPlan finds each one's
//   plane and weight vector once, before the grid-stride loop over the
//   rows.  A lane sums its vectors' squares into one float a plane
//   (ZMAX compile-time slots: plane_slots(Z), 2, 4 or 8), the
//   sums are reduced over the row's G lanes with __shfl_xor_sync, and each
//   vector is scaled by its own plane's factor.
// staged (any other row), K5: one warp a row (a grid-stride loop over the
//   rows, up to kStagedMaxWarps warps a block, as many as the block's
//   shared memory holds: staged_warps), each warp with two row buffers of
//   shared memory: the next row's 16-byte words (K1's words,
//   csrc/rmsnorm_words.cuh) arrive by cp.async while the warp walks the
//   current one, where element e of the row lies at position off + e of
//   the words.  The warp walks the planes in turn: for plane z, lane l
//   takes channels l, l + 32, ... of each segment's part of the plane, so
//   that the plane of every element is known without a division, the
//   plane's sum is one warp_sum, and the same lanes then scale the same
//   elements in place; the row goes back through the same words.
// staged, K5b: one block a row (rows grid-strided over the blocks), the
//   rows' x and g words double-buffered in shared memory by cp.async as
//   in K5; thread t owns elements t, t + T, ... of every row (at most
//   bwd_ept a thread), so its weights, planes and dw sums stay in
//   registers over all the block's rows; the planes' two sums are
//   reduced over the block through shared memory (two barriers a row).
#pragma once

#include "rmsnorm_words.cuh"

namespace grouped {

using namespace rmsnorm_words;

enum : int { kStaged = 0, kVector = 1 };   // ops/grouped_rmsnorm_kernel.py
// K5's epilogues (ops/grouped_rmsnorm_kernel.py EPILOGUES)
enum : int { kActNone = 0, kActSilu = 1, kActModulateSilu = 2 };

constexpr int kMaxZ = 8;
constexpr int kMaxSegments = 3;
constexpr int kMaxWidth = 12288;          // Z * Ctot, elements a row
constexpr int kThreads = 256;
constexpr int kStagedMaxWarps = 8;        // rows in flight a staged block
constexpr int kStagedBlocks = 4;          // K5 staged's __launch_bounds__:
constexpr int kStagedRegs =               // 64 registers a thread
    65536 / (32 * kStagedMaxWarps * kStagedBlocks);
constexpr int kVecMax = 4;                // 16-byte vectors a lane holds
constexpr int kVecMaxBytes = 32 * kVecMax * 16;   // one row, at most

struct Layout {
  int z, nseg, ctot, width, from_5d;
  int c[kMaxSegments], off[kMaxSegments], cum[kMaxSegments];
};

// The layout of z planes of the segments c[0 .. nseg - 1], or ok = false
// where the kernels do not take it.
inline Layout make_layout(int z, int nseg, const int* c, int from_5d,
                          bool& ok) {
  Layout L{};
  L.z = z;
  L.nseg = nseg;
  L.from_5d = from_5d;
  ok = z >= 1 && z <= kMaxZ && nseg >= 1 && nseg <= kMaxSegments;
  for (int s = 0; ok && s < nseg; ++s) {
    ok = c[s] >= 1;
    L.c[s] = c[s];
    L.cum[s] = L.ctot;
    L.off[s] = z * L.ctot;
    L.ctot += c[s];
  }
  L.width = z * L.ctot;
  ok = ok && L.width <= kMaxWidth;
  return L;
}

// Element e's segment s, plane z and weight index (a division: only where
// it is done once per element, not per row)
__device__ __forceinline__ void locate(const Layout& L, int e, int& z,
                                       int& widx) {
  int s = 0;
  while (s + 1 < L.nseg && e >= L.off[s + 1]) ++s;
  const int rel = e - L.off[s];
  z = rel / L.c[s];
  const int j = rel - z * L.c[s];
  widx = L.from_5d ? L.cum[s] + j : e;
}

// The most 16-byte words a row of w elements of T can touch, at any
// phase.
template <typename T> __host__ __device__ constexpr int staged_words(int w) {
  return (w + 2 * (kWordBytes / (int)sizeof(T)) - 2) /
         (kWordBytes / (int)sizeof(T));
}
__host__ __device__ constexpr int weight_floats(int w) {
  return (w + 3) / 4 * 4;
}
// K5 staged's shared memory: the weight by element (floats, a whole
// number of 16-byte words), then each warp's two row buffers.
template <typename T>
__host__ __device__ constexpr int staged_warp_bytes(int w) {
  return 2 * kWordBytes * staged_words<T>(w);
}
// The warps of a K5 staged block: as many as kMaxBlockSmem holds beside
// the weight, at most kStagedMaxWarps.
template <typename T>
__host__ __device__ constexpr int staged_warps(int w) {
  const int fit = (kMaxBlockSmem - (int)sizeof(float) * weight_floats(w)) /
                  staged_warp_bytes<T>(w);
  return fit < 1 ? 1 : fit > kStagedMaxWarps ? kStagedMaxWarps : fit;
}
template <typename T>
__host__ __device__ constexpr int staged_smem(int w) {
  return (int)sizeof(float) * weight_floats(w) +
         staged_warps<T>(w) * staged_warp_bytes<T>(w);
}
static_assert(staged_smem<float>(kMaxWidth) <= kMaxBlockSmem,
              "a float32 row of kMaxWidth fits one warp of K5");
// The staged blocks an SM holds at once (its 228 KB of shared memory, 1 KB
// of it reserved a block, its 2,048 threads and 65,536 registers at
// `regs` a thread): their grid, so that each warp or block walks many
// rows and a block stages what it keeps once for all of them
// (ops/grouped_rmsnorm_kernel.py blocks_per_sm mirrors this for K5b's
// grid, bwd_blocks).
constexpr int kSmSmem = 233472;
__host__ __device__ constexpr int blocks_per_sm(int smem, int threads,
                                                int regs) {
  const int by_smem = kSmSmem / (smem + 1024);
  const int by_threads = 2048 / threads;
  const int by_regs = 65536 / (threads * regs);
  const int n = by_smem < by_threads ? by_smem : by_threads;
  const int m = n < by_regs ? n : by_regs;
  return m < 1 ? 1 : m;
}

// K5b staged: T threads a row (a multiple of 32, at most kBwdMaxThreads),
// each owning at most bwd_ept(w) elements (8, 16 or 24), which the
// kernel's template covers.
constexpr int kBwdMaxThreads = 512;
__host__ __device__ constexpr int bwd_ept(int w) {
  return w <= 8 * kBwdMaxThreads ? 8 : w <= 16 * kBwdMaxThreads ? 16 : 24;
}
__host__ __device__ constexpr int bwd_threads(int w) {
  return ((w + bwd_ept(w) - 1) / bwd_ept(w) + 31) / 32 * 32;
}
// K5b staged's shared memory: two slots of a row's x and g words (one
// row on its way while the block walks the other), then each warp's two
// sums a plane (kMaxZ planes).
template <typename T>
__host__ __device__ constexpr int bwd_staged_smem(int w) {
  return 2 * 2 * kWordBytes * staged_words<T>(w) +
         (int)sizeof(float) * (bwd_threads(w) / 32) * 2 * kMaxZ;
}
static_assert(bwd_ept(kMaxWidth) * kBwdMaxThreads >= kMaxWidth &&
                  bwd_staged_smem<float>(kMaxWidth) <= kMaxBlockSmem,
              "a float32 row of kMaxWidth fits one block of K5b");

// The vector variant's plane slots for z planes: 2, 4 or 8 (one
// instantiation fewer for Z = 1, which no preset's path runs, at the cost
// of an idle slot)
__host__ __device__ constexpr int plane_slots(int z) {
  return z <= 2 ? 2 : z <= 4 ? 4 : 8;
}

// w's element i as float: w holds T, or float (w_f32) for a bf16 x
template <typename T>
__device__ __forceinline__ float weight_at(const void* w, bool w_f32,
                                           int i) {
  return w_f32 ? static_cast<const float*>(w)[i]
               : to_f32(static_cast<const T*>(w)[i]);
}

// The TPU module's rounding: for bf16 y = bf16(bf16(x * bf16(inv)) * w)
// with w already in bf16; for float y = (x * inv) * w.
template <typename T>
__device__ __forceinline__ float scale(float v, float inv, float wv) {
  if constexpr (sizeof(T) == 2) {
    return round_to<T>(v * round_to<T>(inv)) * wv;
  } else {
    return (v * inv) * wv;
  }
}

// y's 16-byte vector from x's (v), the plane's inv and w's vector (wv, in
// T): for bf16 two bf16x2 multiplies a pair, each correctly rounded.
template <typename T>
__device__ __forceinline__ uint4 scale_vec(const uint4& v, float inv,
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
      out[t] = __float_as_uint((__uint_as_float(in[t]) * inv) *
                               __uint_as_float(ws[t]));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// element j of a 16-byte vector of T as float
template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& v, int j) {
  return word_elem<T>(v, j);
}

// The vector variant's plan of one lane: its vectors sub + i G (i <
// kVecMax), each one's plane (-1 past the row) and weight vector index
// (in 16-byte vectors of T; the caller reads a float weight as two).
struct VecPlan {
  int plane[kVecMax];
  int wvec[kVecMax];
  __device__ __forceinline__ VecPlan(const Layout& L, int sub, int g,
                                     int elems) {
    const int nvec = L.width / elems;
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      const int vi = sub + i * g;
      plane[i] = -1;
      wvec[i] = 0;
      if (vi < nvec) {
        int z, widx;
        locate(L, vi * elems, z, widx);
        plane[i] = z;
        wvec[i] = widx / elems;
      }
    }
  }
};

// v[p] for a runtime p < ZMAX, without local memory
template <int ZMAX>
__device__ __forceinline__ float pick(const float (&v)[ZMAX], int p) {
  float r = v[0];
#pragma unroll
  for (int zz = 1; zz < ZMAX; ++zz) r = p == zz ? v[zz] : r;
  return r;
}

// v[p] += a for a runtime p (no slot for p < 0)
template <int ZMAX>
__device__ __forceinline__ void add_to(float (&v)[ZMAX], int p, float a) {
#pragma unroll
  for (int zz = 0; zz < ZMAX; ++zz) v[zz] += p == zz ? a : 0.f;
}

// PyTorch's CUDA SiLU (its ActivationSiluKernel.cu: x / (1 + exp(-x)) in
// float, compiled without fast math): expf and an IEEE division, each
// rounded as there.
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// What the epilogue reads: kActModulateSilu's scale and shift, (B, C) of
// T with `stride` elements from one batch's row to the next, batch b
// covering rows b * rpb .. b * rpb + rpb - 1 of x.
struct Epi {
  int act;
  const void* scale;
  const void* shift;
  long long stride;
  long long rpb;
};

// The lanes of a row's group in the vector variant: the smallest power of
// two up to 32 that leaves each lane at most kVecMax vectors (K1's rule)
inline int vector_group(int nvec) {
  int g = 1;
  while (g < 32 && g * kVecMax < nvec) g *= 2;
  return g;
}

}  // namespace grouped
