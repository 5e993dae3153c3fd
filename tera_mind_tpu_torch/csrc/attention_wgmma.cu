// K2, variant wgmma: windowed attention forward on Hopper's warpgroup
// tensor-core instruction, fed by the Tensor Memory Accelerator.
//
// The function is csrc/attention.cu's (tera_mind_tpu/ops/
// attention_kernel.py::_attn_kernel): f32 logits s = (q.k^T) * scale, an
// exact softmax (row max m, exp(s - m), row sum l, p = exp(s - m) / l),
// p rounded to bf16 once after it is normalised, p.v summed in f32 and
// rounded once.  Bound: the bytes at every path shape (N / 2 operations a
// byte, 16-256, under the 295 of the H100's bf16 peak); the mma.sync
// variants (csrc/attention.cu) reach 10-33 % of it.  What this design does about that:
//
// - Loads: TMA.  q, k, v each have a 3-D tensor map (D, N, B) with the
//   128-byte swizzle; a box is 64 columns (a 128-byte slab) x rows of ONE
//   batch index, so rows past N (N = 32, 100, ...) and columns past D
//   (D = 48) arrive as zeros instead of the next index's.
// - Products: wgmma.mma_async m64nNk16 f32.bf16.bf16.  q.k^T: A = q and
//   B = K both K-major in shared memory (row-major K is the K-major B of
//   q.k^T), N = a key tile (128 keys, 64 at D = 512).  p.v: A = p from
//   registers (the f32 logits' accumulator fragment is the bf16 A
//   fragment of the next product, two logits a register), B = V MN-major
//   (row-major V is keys x D with D contiguous: the transpose bit, 8-key
//   groups 1,024 bytes apart, slabs a tile's slab apart), N = 64 or 128
//   columns a pass.  m64n64 steps read both operands from shared memory
//   at its full rate and ran the first design at a third of the bound;
//   the wider steps halve the instructions.
// - Warps: warpgroup 0 produces (one thread issues every TMA load;
//   setmaxnreg lowers it to 40 registers), warpgroups 1-2 consume.  For
//   D <= 256 a unit is 128 query rows of one batch index, 64 a consumer,
//   each with all of D; for D = 512 a unit is 64 rows, both consumers
//   compute the same logits and each accumulates half of D's slabs.  Both
//   read every K and V tile of the unit.  ptxas holds each thread to 168
//   registers (384 threads), so O is accumulated in passes of at most
//   128 columns (64 floats a thread), V loaded a pass at a time, and p
//   (bf16, kept in registers) reused by every pass.
// - Exact softmax against registers: up to 256 keys a row's logits stay
//   in registers (N / 2 floats a thread), and the softmax is the plain
//   version's: row max and sum over all keys with quad shuffles.  At N >
//   256 (D <= 128) the keys go one tile a chunk: a first pass over K
//   keeps each row's max and its sum (the sum rescaled when the max
//   grows, p never), a second recomputes each tile's logits and forms
//   p = exp(s - m) / l with the final m and l; one more q.k^T instead of
//   128 KB of f32 logits in shared memory, which would leave no room for
//   the ring.  The division is a reciprocal rounded once per row and a
//   correction (q = e r, q + (e - q l) r, with fma: the IEEE quotient),
//   three instructions an element where div.rn took about ten.
// - Pipeline: q (up to 64 KB) and a ring of four 32 KB slots under full
//   and empty mbarriers: a K tile takes as many slots as its slabs fill
//   (two at D = 256), a V tile one slot a p.v pass.  Persistent blocks,
//   one an SM, walk the units (the rows of one batch index adjacent, so
//   their K and V meet in L2); the producer loads the next unit's q as
//   soon as both consumers finish their last q.k^T, and its K as the ring
//   frees, while the consumers still run this unit's softmax and p.v.
// - Stores: each consumer warp stages its 16 rows of a 64-column slab of
//   O in shared memory (rows padded to 144 bytes, no bank conflicts) and
//   writes whole 128-byte row pieces as 16-byte stores; rows past N and
//   columns past D skipped.  Storing the accumulator pairs straight to
//   device memory (4 bytes a store) took longer than the products.
//
// Host side: the three tensor maps are encoded per call
// (cuTensorMapEncodeTiled through hopper::encode_tiled).

#include <math.h>

#include <algorithm>

#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;          // warpgroup 0 produces, 1-2 consume

struct Args {
  int n, d, rtiles, units;   // rtiles: units a batch index
  float scale;
};

// d (+)= a b, m64nNk16: q.k^T with A (64 x 16) and B (N keys x 16) both
// K-major in shared memory (scale_d = 0 ignores d's old value); p.v with
// A (64 x 16 bf16) from registers and B (16 keys x N columns) MN-major,
// the transpose bit set.
template <int N> struct Ss;
template <int N> struct Rs;

template <> struct Ss<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Ss<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Rs<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Rs<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The ring as the consumers walk it: slot it % stages, its phase parity
// (it / stages) & 1; each consumer warp arrives once on a slot's empty
// barrier when its products from the slot are done.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int slot_bytes, stages, it;

  __device__ __forceinline__ uint32_t wait() {
    const int s = it % stages;
    mbar_wait(full + s, (it / stages) & 1);
    return smem_addr(base + s * slot_bytes);
  }
  __device__ __forceinline__ int slot() const { return it % stages; }
};

// s[t] = q k_t^T for this chunk's key tiles t < nt_here (tiles of the
// ring, in order), each tile's slabs kslabs a slot: per slot its slabs x
// four k16 steps into the tile's KT / 2 accumulators; a slot is released
// once the next slot's products are issued and its own are done.
template <int KT, int NT>
__device__ __forceinline__ void qk_chunk(float (&s)[NT][KT / 2],
                                         int nt_here, uint32_t q_base,
                                         int q_slab_bytes, int slabs,
                                         int kslabs, Ring& r, int lane) {
  int prev = -1;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt_here) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[t][i] = 0.f;
      for (int s0 = 0; s0 < slabs; s0 += kslabs) {
        const uint32_t kb = r.wait();
        wgmma_fence();
        for (int sl = s0; sl < min(slabs, s0 + kslabs); ++sl) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Ss<KT>::mma(s[t],
                        sw128_desc(q_base + sl * q_slab_bytes + 32 * kk),
                        sw128_desc(kb + (sl - s0) * KT * 128 + 32 * kk), 1);
        }
        wgmma_commit();
        fence_operands(s[t]);
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(r.empty + prev);
        }
        prev = r.slot();
        ++r.it;
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_operands(s[t]);
  if (lane == 0) mbar_arrive(r.empty + prev);
}

// o += p v_t for this chunk's tiles t < nt_here, one pass of NH slabs:
// one m64n(64 NH)k16 a step of 16 keys (steps past n skipped), B the
// consumer's slabs of the pass at slot + slab_off slabs (slabs KT x 128
// bytes apart); p[t][4 kk .. 4 kk + 3] is the A fragment of step kk.
template <int KT, int NT, int NH>
__device__ __forceinline__ void pv_chunk(float (&o)[NH * 32],
                                         const uint32_t (&p)[NT][KT / 4],
                                         int nt_here, int key0, int n,
                                         int slab_off, Ring& r, int lane) {
  int prev = -1;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt_here) {
      const uint32_t vb = r.wait() + slab_off * KT * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (key0 + t * KT + 16 * kk < n) {
          const uint32_t a[4] = {p[t][4 * kk], p[t][4 * kk + 1],
                                 p[t][4 * kk + 2], p[t][4 * kk + 3]};
          Rs<64 * NH>::mma(o, a, sw128_mn_desc(vb + 2048 * kk, KT * 128));
        }
      }
      wgmma_commit();
      fence_operands(o);
      if (prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(r.empty + prev);
      }
      prev = r.slot();
      ++r.it;
    }
  }
  wgmma_wait<0>();
  fence_operands(o);
  if (lane == 0) mbar_arrive(r.empty + prev);
}

// Thread (g = lane / 4, c4 = lane % 4) of a consumer warp holds, of each
// key tile t, keys KT t + 8 j + 2 c4 and + 1 (j < KT / 8) of its rows g
// (s[t][4 j], s[t][4 j + 1]) and g + 8 (s[t][4 j + 2], s[t][4 j + 3]).
// The logits times scale; keys at or past n (from key0) set to -inf where
// the chunk has any.
template <int KT, int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][KT / 2], int key0,
                                           int n, float scale, int c4) {
  const bool ragged = key0 + NT * KT > n;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int key = key0 + KT * t + 8 * (i >> 2) + 2 * c4 + (i & 1);
      s[t][i] = ragged && key >= n ? -INFINITY : s[t][i] * scale;
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the row maxima of a chunk's logits: rows g (lo) and g + 8 (hi)
template <int KT, int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][KT / 2],
                                        float& lo, float& hi) {
  lo = hi = -INFINITY;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      if (i & 2)
        hi = fmaxf(hi, s[t][i]);
      else
        lo = fmaxf(lo, s[t][i]);
    }
  lo = quad_max(lo);
  hi = quad_max(hi);
}

// s = exp(s - m) in place; the rows' sums of it
template <int KT, int NT>
__device__ __forceinline__ void row_exp(float (&s)[NT][KT / 2], float m_lo,
                                        float m_hi, float& l_lo,
                                        float& l_hi) {
  l_lo = l_hi = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      s[t][i] = expf(s[t][i] - ((i & 2) ? m_hi : m_lo));
      if (i & 2)
        l_hi += s[t][i];
      else
        l_lo += s[t][i];
    }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
}

// e / l rounded to nearest, as IEEE division gives it, from r = 1 / l
// rounded to nearest: q = e r is within an ulp of e / l, its remainder
// e - q l is exact (one fma), and q + rem r rounds to e / l (Markstein's
// correction), three instructions in place of a division each
__device__ __forceinline__ float div_by(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// p = e / l rounded once to bf16, as the A fragments of p.v: step kk of
// tile t is {rows g, g + 8} x {keys 16 kk + 2 c4 (+1), + 8}, i.e. the
// accumulator pairs 8 kk + 2 i, + 1 for i < 4
template <int KT, int NT>
__device__ __forceinline__ void to_p(const float (&e)[NT][KT / 2],
                                     float l_lo, float l_hi,
                                     uint32_t (&p)[NT][KT / 4]) {
  const float r_lo = __frcp_rn(l_lo), r_hi = __frcp_rn(l_hi);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) {
      const float l = (i & 1) ? l_hi : l_lo, r = (i & 1) ? r_hi : r_lo;
      p[t][i] = pack_bf16x2(div_by(e[t][2 * i], l, r),
                            div_by(e[t][2 * i + 1], l, r));
    }
}

// This warp's 16 rows of a pass's O (rows row0.., columns col0 + 64 h +
// 8 j + 2 c4 and + 1 for slabs h < nslabs) rounded once to bf16: each
// slab staged in the warp's shared rows, then written as 16-byte stores
// of whole 128-byte row pieces; rows at or past n, columns at or past d
// skipped.
template <int NH>
__device__ __forceinline__ void store_o(const float (&o)[NH * 32],
                                        unsigned char* stage,
                                        __nv_bfloat16* __restrict__ out,
                                        long long base, int row0, int col0,
                                        int nslabs, int n, int d, int lane) {
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (h >= nslabs) break;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * h + jj, col = 8 * jj + 2 * c4;
      *reinterpret_cast<uint32_t*>(stage + g * wg::kStageRow + 2 * col) =
          pack_bf16x2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * wg::kStageRow +
                                   2 * col) =
          pack_bf16x2(o[4 * j + 2], o[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = lane + 32 * i, rr = idx >> 3, c = idx & 7;
      const int row = row0 + rr, col = col0 + 64 * h + 8 * c;
      if (row < n && col < d)
        *reinterpret_cast<uint4*>(out + base + (long long)row * d + col) =
            *reinterpret_cast<const uint4*>(stage + rr * wg::kStageRow +
                                            16 * c);
    }
    __syncwarp();
  }
}

// KT: keys a tile; NT: key tiles a chunk; NH: slabs a p.v pass; MULTI:
// several chunks (two passes over K)
template <int KT, int NT, int NH, bool MULTI>
__global__ void __launch_bounds__(kThreads, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out, Args a) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the descriptors need 1,024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const wg::Layout L = wg::layout(a.n, a.d);
  unsigned char* qs = smem;
  unsigned char* ring = smem + L.q_bytes;
  unsigned char* staging = ring + wg::kStages * wg::kSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + wg::kStageBytes);
  uint64_t* empty = full + wg::kStages;
  uint64_t* q_full = empty + wg::kStages;
  uint64_t* q_empty = q_full + 1;
  const int wgi = threadIdx.x >> 7;
  const int q_slab_bytes = L.rows * 128;
  const int tile_slab = KT * 128;   // bytes of one slab of a K or V tile

  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    for (int s = 0; s < wg::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, wg::kConsumerWarps);   // one arrival a warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, wg::kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread keeps q and the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0, ui = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++ui) {
        const int b = u / a.rtiles, r0 = (u - b * a.rtiles) * L.rows;
        mbar_wait(q_empty, (ui & 1) ^ 1);
        mbar_expect_tx(q_full, L.q_bytes);
        for (int s = 0; s < L.slabs; ++s)
          tma_load_3d(qs + s * q_slab_bytes, &qmap, q_full, s * wg::kSlab,
                      r0, b);
        // a slot of K tile t: slabs kc kslabs .. of it; of V tile t in pass
        // ps (kc < 0): each consumer's slabs of the pass, consumer c's
        // h-th at position c nh + h
        auto load = [&](const CUtensorMap* m, int t, int kc, int ps) {
          const int slot = it % wg::kStages;
          mbar_wait(empty + slot, ((it / wg::kStages) & 1) ^ 1);
          unsigned char* dst = ring + slot * wg::kSlot;
          int first[2] = {kc * L.kslabs, 0};
          int count[2] = {min(L.kslabs, L.slabs - kc * L.kslabs), 0};
          if (ps >= 0) {
            const int in_pass = min(L.nh, L.per - ps * L.nh);
            for (int c = 0; c < 2; ++c) {
              first[c] = (L.dsplit ? c * L.per : 0) + ps * L.nh;
              count[c] = L.dsplit || c == 0 ? in_pass : 0;
            }
          }
          mbar_expect_tx(full + slot, (count[0] + count[1]) * tile_slab);
          for (int c = 0; c < 2; ++c)
            for (int h = 0; h < count[c]; ++h)
              tma_load_3d(dst + (ps >= 0 ? c * L.nh + h : h) * tile_slab, m,
                          full + slot, (first[c] + h) * wg::kSlab, t * KT,
                          b);
          ++it;
        };
        auto load_k = [&](int t) {
          for (int kc = 0; kc * L.kslabs < L.slabs; ++kc)
            load(&kmap, t, kc, -1);
        };
        if constexpr (MULTI)
          for (int t = 0; t < L.tiles; ++t) load_k(t);
        for (int c = 0; c < L.chunks; ++c) {
          const int t0 = c * NT, t1 = min(L.tiles, t0 + NT);
          for (int t = t0; t < t1; ++t) load_k(t);
          for (int ps = 0; ps < L.passes; ++ps)
            for (int t = t0; t < t1; ++t) load(&vmap, t, 0, ps);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wgi - 1, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, c4 = lane & 3;
    const uint32_t q_base = smem_addr(qs) + (L.dsplit ? 0 : cw * 64 * 128);
    const int slab0 = L.dsplit ? cw * L.per : 0;
    const int slab_off = L.dsplit ? cw * L.nh : 0;
    unsigned char* stage =
        staging + (cw * 4 + warp) * 16 * wg::kStageRow;
    Ring r{ring, full, empty, wg::kSlot, wg::kStages, 0};
    int ui = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++ui) {
      const int b = u / a.rtiles;
      const int row0 =
          (u - b * a.rtiles) * L.rows + (L.dsplit ? 0 : cw * 64);
      const long long base = (long long)b * a.n * a.d;
      mbar_wait(q_full, ui & 1);
      float s[NT][KT / 2];
      uint32_t p[NT][KT / 4];
      float o[NH * 32];
      if constexpr (!MULTI) {
        qk_chunk<KT, NT>(s, L.tiles, q_base, q_slab_bytes, L.slabs,
                         L.kslabs, r, lane);
        if (lane == 0) mbar_arrive(q_empty);
        float m_lo, m_hi, l_lo, l_hi;
        scale_mask<KT, NT>(s, 0, a.n, a.scale, c4);
        row_max<KT, NT>(s, m_lo, m_hi);
        row_exp<KT, NT>(s, m_lo, m_hi, l_lo, l_hi);
        to_p<KT, NT>(s, l_lo, l_hi, p);
        for (int ps = 0; ps < L.passes; ++ps) {
#pragma unroll
          for (int i = 0; i < NH * 32; ++i) o[i] = 0.f;
          pv_chunk<KT, NT, NH>(o, p, L.tiles, 0, a.n, slab_off, r, lane);
          store_o<NH>(o, stage, out, base, row0 + 16 * warp,
                      (slab0 + ps * NH) * wg::kSlab,
                      min(NH, L.per - ps * NH), a.n, a.d, lane);
        }
      } else {
        // pass 1: each row's max over all keys and its sum, the sum
        // rescaled when the max grows
        float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
        for (int c = 0; c < L.chunks; ++c) {
          const int nt_here = min(NT, L.tiles - c * NT);
          qk_chunk<KT, NT>(s, nt_here, q_base, q_slab_bytes, L.slabs,
                           L.kslabs, r, lane);
          scale_mask<KT, NT>(s, c * NT * KT, a.n, a.scale, c4);
          float cm_lo, cm_hi, cl_lo, cl_hi;
          row_max<KT, NT>(s, cm_lo, cm_hi);
          cm_lo = fmaxf(cm_lo, m_lo);
          cm_hi = fmaxf(cm_hi, m_hi);
          row_exp<KT, NT>(s, cm_lo, cm_hi, cl_lo, cl_hi);
          l_lo = l_lo * expf(m_lo - cm_lo) + cl_lo;
          l_hi = l_hi * expf(m_hi - cm_hi) + cl_hi;
          m_lo = cm_lo;
          m_hi = cm_hi;
        }
        // pass 2: the logits again, p = exp(s - m) / l with the final m
        // and l, o += p v chunk by chunk (one pass over D: per <= 2)
#pragma unroll
        for (int i = 0; i < NH * 32; ++i) o[i] = 0.f;
        for (int c = 0; c < L.chunks; ++c) {
          const int nt_here = min(NT, L.tiles - c * NT);
          qk_chunk<KT, NT>(s, nt_here, q_base, q_slab_bytes, L.slabs,
                           L.kslabs, r, lane);
          if (c == L.chunks - 1 && lane == 0) mbar_arrive(q_empty);
          scale_mask<KT, NT>(s, c * NT * KT, a.n, a.scale, c4);
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int i = 0; i < KT / 2; ++i)
              s[t][i] = expf(s[t][i] - ((i & 2) ? m_hi : m_lo));
          to_p<KT, NT>(s, l_lo, l_hi, p);
          pv_chunk<KT, NT, NH>(o, p, nt_here, c * NT * KT, a.n, slab_off, r,
                               lane);
        }
        store_o<NH>(o, stage, out, base, row0 + 16 * warp,
                    slab0 * wg::kSlab, L.per, a.n, a.d, lane);
      }
    }
  }
}

// a bf16 (D, N, B) tensor map of one of q, k, v: boxes of 64 columns x
// `rows` rows of one batch index
bool qkv_map(CUtensorMap* m, const void* base, int b, int n, int d,
             int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {wg::kSlab, (cuuint32_t)rows, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims,
                  strides, box);
}

template <int KT, int NT, int NH, bool MULTI>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, void* o, const Args& a, int smem,
           int grid, cudaStream_t st) {
  static std::atomic<int> smem_state[kMaxDevices];
  auto kernel = attention_wgmma_kernel<KT, NT, NH, MULTI>;
  const cudaError_t err = smem_opt_in(kernel, kMaxBlockSmem, smem_state);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), a);
  return (int)cudaGetLastError();
}

}  // namespace

int attention_wgmma(const void* q, const void* k, const void* v, void* o,
                    int b, int n, int d, float scale, cudaStream_t stream) {
  if (b <= 0 || !wg::takes(n, d)) return (int)cudaErrorInvalidValue;
  const wg::Layout L = wg::layout(n, d);
  if (L.smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!qkv_map(&qm, q, b, n, d, L.rows) ||
      !qkv_map(&km, k, b, n, d, L.kt) || !qkv_map(&vm, v, b, n, d, L.kt))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int rtiles = (n + L.rows - 1) / L.rows;
  const long long units = (long long)b * rtiles;
  if (units > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Args a{n, d, rtiles, (int)units, scale};
  const int grid = (int)std::min<long long>(units, sms);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(qm, km, vm, o, a, L.smem, grid, stream);
  };
  if (L.dsplit) {   // kt 64, nh 2, one chunk of up to 4 tiles
    switch (L.nt) {
      case 1: return go(launch<64, 1, 2, false>);
      case 2: return go(launch<64, 2, 2, false>);
      default: return go(launch<64, 4, 2, false>);
    }
  }
  if (L.chunks > 1)   // kt 128, one tile a chunk
    return L.nh == 1 ? go(launch<128, 1, 1, true>)
                     : go(launch<128, 1, 2, true>);
  if (L.nt == 1)
    return L.nh == 1 ? go(launch<128, 1, 1, false>)
                     : go(launch<128, 1, 2, false>);
  return L.nh == 1 ? go(launch<128, 2, 1, false>)
                   : go(launch<128, 2, 2, false>);
}
