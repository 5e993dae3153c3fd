// Building blocks of K2's and K2b's tensor_core_tiled variants
// (csrc/attention.cu, csrc/attention_bwd.cu): bf16 q, k, v, g of one
// batch index streamed through shared memory in row tiles by 16-byte
// cp.async, products on mma.sync m16n8k16 (bf16 in, f32 out).  A block
// has kWarps = 16 warps: the f32 rows of logits fill most of its shared
// memory, so one block runs on an SM, and 16 warps rather than 8 took a
// quarter off K2's time at (512, 512, 128) on an H100 (measured with
// scripts/profile_attention.py), by hiding more of each ldmatrix -> mma
// chain and of the barriers between tiles.  Rows of bf16 tiles are padded by 16 bytes and rows
// of f32 tiles by 16 bytes, so that ldmatrix hits 8 distinct bank groups.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tl {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;        // bf16 row padding (16 bytes)
constexpr int kSPad = 4;       // f32 row padding (16 bytes)
constexpr int kMaxPer = 512 / 32;   // a row's values a lane holds (N <= 512)

// Rows r0 .. r0 + rows - 1 of one batch index's (n, d) bf16 array into
// shared memory rows of ld elements by 16-byte cp.async; rows at or past
// n are zeroed (the caller commits the group).
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0,
                                      int rows, int n, int d, int ld) {
  // thread t copies the 16-byte vectors t, t + kThreads, ...: row r,
  // vector c, stepped without an integer division per vector (the
  // division a vector cost K2 7 % and K2b's dq pass 11 % of their time at
  // (512, 512, 128) on an H100, scripts/profile_attention.py)
  const int vpr = d / 8;
  const int dr = kThreads / vpr, dc = kThreads - dr * vpr;
  int r = threadIdx.x / vpr, c = threadIdx.x - r * vpr;
  for (; r < rows; r += dr, c += dc) {
    if (c >= vpr) {
      c -= vpr;
      ++r;
      if (r >= rows) break;
    }
    if (r0 + r < n)
      cp_async16(dst + r * ld + 8 * c, src + (size_t)(r0 + r) * d + 8 * c);
    else
      zero16(dst + r * ld + 8 * c);
  }
}

// body(t, buf) for the tiles t = 0 .. tiles - 1 of a stream, tile t in
// ring buffer buf = t % stages; issue(t, buf) starts tile t's copies.
// Tile 0 must be issued and committed by the caller.  With two stages
// tile t + 1 is in flight while tile t is used; the block synchronises
// before and after each body, so a buffer is refilled only after every
// warp is done with it, and the ring is free when the stream returns.
template <typename Issue, typename Body>
__device__ __forceinline__ void stream_tiles(int tiles, int stages,
                                             Issue issue, Body body) {
  for (int t = 0; t < tiles; ++t) {
    const bool ahead = stages > 1 && t + 1 < tiles;
    if (ahead) {
      issue(t + 1, (t + 1) % stages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(t, t % stages);
    __syncthreads();
    if (stages == 1 && t + 1 < tiles) {
      issue(t + 1, 0);
      cp_async_commit();
    }
  }
}

template <int NT> __device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// acc[j] += a b^T over k in [0, kn) for the 16 rows at a and the 8 rows
// 8j .. 8j + 7 at b, j < nt (<= NT): both row-major in shared memory
// (rows of lda, ldb), bf16 through ldmatrix (pairs of 8-row tiles by .x4,
// an odd last one by .x2).  Each 16-wide step loads all its fragments
// before its first mma (the asm is volatile, so source order is issue
// order).
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        int kn, int nt, int lane) {
  const bf16* pa = a + (lane & 15) * lda + (lane >> 4) * 8;
  const bf16* pb =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t af[4], bf[NT][2];
    ldmatrix_x4(af, pa + k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j + 1 < nt) {
        uint32_t b4[4];
        ldmatrix_x4(b4, pb + 8 * j * ldb + k0);
        bf[j][0] = b4[0];
        bf[j][1] = b4[1];
        if (j + 1 < NT) {
          bf[j + 1][0] = b4[2];
          bf[j + 1][1] = b4[3];
        }
      } else if (j < nt) {
        ldmatrix_x2(bf[j], pb + 8 * j * ldb + k0);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) mma_bf16_16816(acc[j], af, bf[j][0], bf[j][1]);
  }
}

// acc[j] += A b over k in [0, kn) for the 16 rows at ah and the 64
// columns at b (16-column groups while 16j < cols): A row-major with rows
// of lda, b row-major (k rows of ldb) through ldmatrix.trans.  kSplit: A
// is the split pair ah + al of a float32 operand, the hi and then the lo
// product of each 16-wide step into the same accumulators.  B's 16-column
// groups are loaded one at a time (4 registers live, not 16).
template <bool kSplit>
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const bf16* ah,
                                       const bf16* al, int lda, const bf16* b,
                                       int ldb, int kn, int cols, int lane) {
  const int ao = (lane & 15) * lda + (lane >> 4) * 8;
  const bf16* pb =
      b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t hi[4], lo[4];
    ldmatrix_x4(hi, ah + ao + k0);
    if constexpr (kSplit) ldmatrix_x4(lo, al + ao + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (16 * j < cols) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, pb + k0 * ldb + 16 * j);
        mma_bf16_16816(acc[2 * j], hi, bf[0], bf[1]);
        mma_bf16_16816(acc[2 * j + 1], hi, bf[2], bf[3]);
        if constexpr (kSplit) {
          mma_bf16_16816(acc[2 * j], lo, bf[0], bf[1]);
          mma_bf16_16816(acc[2 * j + 1], lo, bf[2], bf[3]);
        }
      }
    }
  }
}

// The accumulators of mma_ab (rows rb + lane/4 and + 8, columns cb + 8j +
// 2 (lane % 4), + 1, below d) times mul, rounded once to bf16, into out
// (rows of d elements); rows at or past `valid` are not stored.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4],
                                           bf16* __restrict__ out, int rb,
                                           int cb, int valid, int d,
                                           float mul, int lane) {
  const int row = rb + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = cb + 8 * j + 2 * (lane & 3);
    if (cb + 8 * j < d) {
      if (row < valid)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * d + c) =
            pack_bf16x2(acc[j][0] * mul, acc[j][1] * mul);
      if (row + 8 < valid)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * d + c) =
            pack_bf16x2(acc[j][2] * mul, acc[j][3] * mul);
    }
  }
}

// The first nt accumulator tiles x[j] of mma_abt (rows row + lane/4 and
// + 8, columns col0 + 8j + 2 (lane % 4), + 1) as split bf16 pairs into the
// rows of ld at hi and lo.
template <int NT>
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int ld,
                                            int row, int col0,
                                            const float (&x)[NT][4], int nt,
                                            int lane) {
  const int at0 = (row + (lane >> 2)) * ld + col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int at = at0 + 8 * j;
      uint32_t h, l;
      split_bf16x2(x[j][0], x[j][1], h, l);
      *reinterpret_cast<uint32_t*>(hi + at) = h;
      *reinterpret_cast<uint32_t*>(lo + at) = l;
      split_bf16x2(x[j][2], x[j][3], h, l);
      *reinterpret_cast<uint32_t*>(hi + at + 8 * ld) = h;
      *reinterpret_cast<uint32_t*>(lo + at + 8 * ld) = l;
    }
  }
}

// Logits of one mma_abt unit (rows row + lane/4 and + 8, keys col0 + 8j +
// 2 (lane % 4), + 1) times scale into f32 rows of ld at s; keys at or
// past n get -inf.  fmul_rn: the backward recomputes p from the same
// rounded product.
template <int NT>
__device__ __forceinline__ void store_logits(float* s, int ld, int row,
                                             int col0, const float (&x)[NT][4],
                                             int nt, int n, float scale,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v;
        v.x = col < n ? __fmul_rn(x[j][2 * h], scale) : -INFINITY;
        v.y = col + 1 < n ? __fmul_rn(x[j][2 * h + 1], scale) : -INFINITY;
        *reinterpret_cast<float2*>(s + (size_t)(row + (lane >> 2) + 8 * h) *
                                           ld + col) = v;
      }
    }
  }
}

// One f32 row of `ns` values at `row` into x[] (lane holds columns lane +
// 32 i; -inf past ns), its max m, x = exp(x - m), and their sum l.
__device__ __forceinline__ void row_exp(const float* row, int ns, int lane,
                                        float (&x)[kMaxPer], float& m,
                                        float& l) {
  m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int j = lane + 32 * i;
    x[i] = j < ns ? row[j] : -INFINITY;
    m = fmaxf(m, x[i]);
  }
  m = warp_max(m);
  l = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    x[i] = expf(x[i] - m);
    l += x[i];
  }
  l = warp_sum(l);
}

}  // namespace tl
