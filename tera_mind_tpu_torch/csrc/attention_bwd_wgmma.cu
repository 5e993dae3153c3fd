// K2b, variant wgmma: the windowed attention backward on Hopper's
// warpgroup tensor-core instruction, fed by the Tensor Memory Accelerator.
//
// The function is csrc/attention_bwd.cu's (the custom_vjp rule _bwd of
// tera_mind_tpu/ops/attention_kernel.py): p = softmax(q k^T * scale)
// recomputed in float32 and never rounded, dv = p^T g, dp = g v^T, ds =
// p (dp - rowsum(dp p)), dq = ds k * scale, dk = ds^T q * scale, each
// output rounded once.  q k^T and g v^T are single bf16 products; every
// product with p or ds takes the split pair hi = bf16(x), lo = bf16(x -
// hi) as two wgmma into one float32 accumulator (one bf16 rounding of p
// and ds changes 37-44 % of the outputs).  Each dq, dk and dv row is
// summed inside one warpgroup in a fixed order, with no atomics: two runs
// give the same bits.  Bound: the bytes (7 B N D bf16) at N <= 128, the
// operations (10 B N^2 D) at N = 512; the mma.sync variants reach 5-23 %
// of it.  Three designs, chosen by N and D (wgb::layout):
//
// fused (N <= 128): one pass, no statistics.  A unit is 128 tile rows:
//   all rows of one batch index (N > 64) or 64 rows of each of two; each
//   of the two consumer warpgroups takes 64 of them as queries and, in
//   the second half, as keys.
//   1. s = q k^T and dp = g v^T for its 64 query rows over the unit's
//      keys (128, or its own batch index's 64), m64n128 (m64n64) steps
//      with q, k, g, v K-major from shared memory, both in registers;
//   2. the exact softmax, D = rowsum(dp p) and ds = p (dp - D) in f32
//      registers, written to shared memory as split pairs p hi, p lo,
//      ds hi, ds lo: rows of 64 keys in the 128-byte swizzle that TMA
//      writes, which is at once the K-major layout of ds as the A of
//      ds k and the MN-major layout of p^T and ds^T as the A of p^T g
//      and ds^T q (the transpose bit: no tile is transposed);
//   3. per 128-column half of D: dq = ds k (its query rows, k MN-major),
//      dv = p^T g and dk = ds^T q (its 64 keys, summed over the unit's
//      queries), each m64n128, hi then lo at each 16-row step, A and B
//      from shared memory, then stored.
//   q, k, v and g are read from device memory once (the bound's bytes);
//   k, g, q come a second time for step 3, from the L2, a batch index's
//   256 KB at (., 128, 256) having just been read.  20 N^2 D operations
//   against the bound's 10: the split doubles the three last products.
//
// two-pass (128 < N <= 512, D <= 256): p of a batch index (1 MB at N =
//   512) does not fit, so a dq kernel writes each row's statistics
//   (row max m, row sum l, D = rowsum(dp p)) to `stats`, and a dk/dv
//   kernel recomputes p^T and ds^T from them.
//   dq: a unit is 128 query rows (64 a consumer) and one 128-column half
//   of dq; q and g stay in shared memory, K and V stream in 64-key
//   slabs.  A first sweep keeps each row's max, its sum and D's sum, both
//   rescaled when the max grows; a second recomputes s and dp (the same
//   sums, bit for bit), forms p = exp(s - m) / l and ds, and adds ds k,
//   ds from registers (the accumulator fragment of s is the A fragment of
//   the next product), k MN-major.  dk/dv: a unit is 128 keys (64 a
//   consumer), one half of D and one output; k (and v for dk) stay, q
//   and g stream in 64-query slabs: s^T = k q^T (and dp^T = v g^T), p^T
//   and ds^T from the statistics, then dv += p^T g or dk += ds^T q from
//   registers.  More units than one a row block (halves, outputs) keep
//   the 132 SMs busy at B = 128; q k^T and g v^T are computed four times
//   (26 N^2 D operations at D = 128), which the operation bound of N =
//   512 pays for in full.  At D = 128 a ring slot holds a whole 64-row
//   tile, so ds k (p^T g, ds^T q) reads its B from the slot of the
//   logits, one m64n128 step, and the first sweep runs over 128 keys.
//
// blocked (128 < N <= 512, D > 256, such as the edge (2, 512, 512)): q
//   and g of 128 rows and both D's slabs would fill 256 KB, and a batch
//   index's dozen row blocks leave the SMs idle at small B.  So the fused
//   steps run on units of 128 query rows (block i) x 128 keys (block j):
//   a first launch writes each row's max, sum and sum of e dp over block
//   j's keys; a second combines a row's blocks in order, forms p and ds
//   from them, and writes float32 partials: dq of i over j's keys, dv and
//   dk of j over i's queries (B x N x D each, one set a block); a third
//   sums the partials in block order and rounds once.  No recompute
//   beyond the first launch's logits, B nb^2 units (times the halves of
//   D a block can take at small B), and determinism without atomics.
//
// Both: warpgroup 0 produces (one thread issues every TMA load, under
// full and empty mbarriers of a ring; setmaxnreg lowers it to 40
// registers), warpgroups 1-2 consume; persistent blocks, one an SM, walk
// the units in order, a batch index's adjacent.  A TMA box is 64 columns
// x 64 rows of ONE batch index, so rows past N (N = 32, 100, ...) arrive
// as zeros.  ptxas holds each of 384 threads to 168 registers: the fused
// design's logits and dp take 128 floats a thread, every accumulator of
// an output 64 (128 columns).  Stores: each warp stages its 16 rows of a
// 64-column slab in shared memory (rows padded to 144 bytes) and writes
// whole 128-byte row pieces as 16-byte stores.
//
// Host side: four tensor maps (q, k, v, g) encoded per call
// (cuTensorMapEncodeTiled through hopper::encode_tiled).  The two-pass
// kernels are compiled in csrc/attention_bwd_wgmma_2pass.cu, beside this
// file (the build runs one nvcc a source), their shared pieces in
// csrc/attention_bwd_wgmma_device.cuh.

#include "attention_bwd_wgmma_device.cuh"

namespace {

// ---------------------------------------------------------------------------
// fused design (N <= 128), and its blocked form (N > 128, D > 256)
// ---------------------------------------------------------------------------

enum : int { kFused = 0, kBlockStats = 1, kBlockTile = 2 };

// Where the blocked design keeps its scratch (float32, in `scratch`): each
// (batch index, 128-key block) pair's row statistics (max, sum, sum of e
// dp over the block's keys), then partial dq (one a key block) and
// partial dk and dv (one a query block), each (B, N, D).
struct Scratch {
  float *pstats, *pdq, *pdk, *pdv;
  long long part;   // floats of one partial set: nb x B x N x D

  __host__ __device__ Scratch(float* base, int b, int n, int d) {
    const int nb = (n + 127) / 128;
    const long long ps = ((long long)b * nb * n * 3 + 3) / 4 * 4;
    part = (long long)nb * b * n * d;
    pstats = base;
    pdq = base + ps;
    pdk = pdq + part;
    pdv = pdk + part;
  }
};

// This warp's 16 rows (row0 ..) of a 64-column slab of a float32 partial
// (accumulator blocks j0 .. j0 + 7), as it is: rows at or past n skipped
template <int N>
__device__ __forceinline__ void store_part(const float (&o)[N], int j0,
                                           float* __restrict__ out,
                                           long long base, int row0,
                                           int col0, int n, int d,
                                           int lane) {
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + jj, col = col0 + 8 * jj + 2 * c4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < n)
        *reinterpret_cast<float2*>(out + base + (long long)row * d + col) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
}

// NK: keys of a consumer's logits, 128 (128 rows of one batch index a
// unit) or 64 (fused only: 64 rows of two).  MODE kFused: a unit is a
// batch index's N <= 128 rows (or two), its outputs whole.  The blocked
// design (N > 128, D > 256) runs the same steps on a unit of 128 query
// rows (block i) x 128 keys (block j) of one batch index: kBlockStats
// writes the rows' statistics over block j's keys and stops after step
// 1; kBlockTile forms p and ds with the statistics of all of j's blocks
// combined, and writes float32 partials: dq of rows i over keys j (one
// set a j), dv and dk of keys j over queries i (one set an i), which
// attention_bwd_reduce_kernel sums in block order.
template <int NK, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap gmap,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, float* __restrict__ scratch,
                           Args a) {
  constexpr int BPU = NK == 128 ? 1 : 2;
  static_assert(MODE == kFused || NK == 128, "blocks are 128 x 128");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const wgb::Layout L = wgb::layout(a.n, a.d);
  const int arr = L.split_bytes / 4;      // one of the four split arrays
  unsigned char* split = smem;            // p hi, p lo, ds hi, ds lo
  unsigned char* ring = split + L.split_bytes;
  unsigned char* staging = ring + L.stages * L.slot;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + wgb::kStageBytes);
  uint64_t* empty = full + L.stages;
  const int wgi = threadIdx.x >> 7;
  const int nb = MODE == kFused ? 1 : (a.n + 127) / 128;
  const int per = L.halves / a.hsplit;    // halves of D a unit
  // unit u: ub = u / hsplit (its rows and keys), h0 = (u % hsplit) per;
  // blocked: ub = (b nb + i) nb + j, a batch index's blocks adjacent
  auto decode = [&](int u, int& b0, int& qb, int& kb, int& h0) {
    const int ub = u / a.hsplit;
    h0 = (u - ub * a.hsplit) * per;
    if (MODE == kFused) {
      b0 = ub * BPU;
      qb = kb = 0;
    } else {
      b0 = ub / (nb * nb);
      qb = (ub / nb) % nb;
      kb = ub % nb;
    }
  };

  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&gmap);
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, wgb::kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: per unit, slabs c of [q, k] and [g, v], then per
    //      half of D the slab pairs of k, g and q ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      Filler f{ring, full, empty, L.slot, L.stages, 0};
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        int b0, qb, kb, h0;
        decode(u, b0, qb, kb, h0);
        // a slot: slab c0 of m0's 128 tile rows from row r0, then slab c1
        // of m1's from r1; tile rows 64 j .. are rows r + 64 j .. of
        // batch index b0 (BPU 1) or rows 0 .. of batch index b0 + j
        auto load = [&](const CUtensorMap* m0, int c0, int r0,
                        const CUtensorMap* m1, int c1, int r1) {
          uint64_t* bar;
          unsigned char* dst = f.next(L.slot, bar);
          for (int part = 0; part < 2; ++part)
            for (int j = 0; j < 2; ++j)
              tma_load_3d(dst + part * kTile + j * kBox, part ? m1 : m0, bar,
                          (part ? c1 : c0) * wgb::kSlab,
                          BPU == 1 ? (part ? r1 : r0) + 64 * j : 0,
                          b0 + (BPU == 1 ? 0 : j));
        };
        const int qr = 128 * qb, kr = 128 * kb;
        for (int c = 0; c < L.slabs; ++c) {
          load(&qmap, c, qr, &kmap, c, kr);
          load(&gmap, c, qr, &vmap, c, kr);
        }
        if (MODE != kBlockStats)
          for (int h = h0; h < h0 + per; ++h) {
            load(&kmap, 2 * h, kr, &kmap, 2 * h + 1, kr);
            load(&gmap, 2 * h, qr, &gmap, 2 * h + 1, qr);
            load(&qmap, 2 * h, qr, &qmap, 2 * h + 1, qr);
          }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wgi - 1, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const uint32_t p_hi = smem_addr(split), p_lo = p_hi + arr;
  const uint32_t ds_hi = p_hi + 2 * arr, ds_lo = p_hi + 3 * arr;
  const int row_off = 64 * cw;                    // its tile rows
  const int key_off = BPU == 1 ? 0 : 64 * cw;     // its logits' key rows
  const int q_off = BPU == 1 ? 0 : 64 * cw;       // the queries of its keys
  const int key_slab = BPU == 1 ? cw : 0;         // its keys' p / ds slab
  const int row0 = BPU == 1 ? 64 * cw : 0;        // its first row in the
                                                  // block (or batch index)
  unsigned char* stage =
      staging + (cw * 4 + warp) * 16 * wgb::kStageRow;
  const Scratch sc(scratch, a.b, a.n, a.d);
  Ring r{ring, full, empty, L.slot, L.stages, 0, -1, 0};

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    int b0, qb, kb, h0;
    decode(u, b0, qb, kb, h0);
    const int bq = b0 + (BPU == 1 ? 0 : cw);      // its batch index
    const bool live_b = bq < a.b;
    const long long base = (long long)bq * a.n * a.d;
    const int q0 = 128 * qb, k0 = 128 * kb;       // the blocks' first rows
    // k16 steps over the unit's keys (dq) and queries (dv, dk)
    const int ksteps = (min(a.n - k0, 128) + 15) >> 4;
    const int qsteps = (min(a.n - q0, 128) + 15) >> 4;

    // 1. s = q k^T and dp = g v^T over D's slabs
    float s[NK / 2], dp[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < L.slabs; ++c) {
      uint32_t sl = r.wait();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Ss<NK, 0, 0>::mma(s, sw128_desc(sl + row_off * 128 + 32 * kk),
                          sw128_desc(sl + kTile + key_off * 128 + 32 * kk));
      wgmma_commit();
      fence_operands(s);
      r.issued(lane);
      sl = r.wait();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Ss<NK, 0, 0>::mma(dp, sw128_desc(sl + row_off * 128 + 32 * kk),
                          sw128_desc(sl + kTile + key_off * 128 + 32 * kk));
      wgmma_commit();
      fence_operands(dp);
      r.issued(lane);
    }
    r.finish(lane);
    fence_operands(s);
    fence_operands(dp);

    // 2. the exact softmax of rows g (lo) and g + 8 (hi), D, ds; rows
    //    past N (or of a batch index past B) zero
    const int qr = q0 + row0 + 16 * warp + g;     // its rows qr, qr + 8
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      s[i] = k0 + acc_col(i, c4) < a.n ? __fmul_rn(s[i], a.scale)
                                       : -INFINITY;
      if (i & 2)
        m_hi = fmaxf(m_hi, s[i]);
      else
        m_lo = fmaxf(m_lo, s[i]);
    }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);
    float l_lo, l_hi, r_lo, r_hi, d_lo, d_hi;
    if (MODE == kBlockTile) {
      // the row's statistics over every key block, combined in block
      // order: m the max, l and D's sum rescaled to it (fmaf)
      const float* ps = sc.pstats + (long long)bq * nb * a.n * 3;
      float mm[2] = {-INFINITY, -INFINITY}, ll[2] = {0.f, 0.f},
            ee[2] = {0.f, 0.f};
      for (int j = 0; j < nb; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (qr + 8 * h < a.n)
            mm[h] = fmaxf(mm[h], ps[((long long)j * a.n + qr + 8 * h) * 3]);
      for (int j = 0; j < nb; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (qr + 8 * h < a.n) {
            const float* st = ps + ((long long)j * a.n + qr + 8 * h) * 3;
            const float f = expf(st[0] - mm[h]);
            ll[h] = fmaf(st[1], f, ll[h]);
            ee[h] = fmaf(st[2], f, ee[h]);
          }
      m_lo = mm[0];
      m_hi = mm[1];
      l_lo = qr < a.n ? ll[0] : 1.f;
      l_hi = qr + 8 < a.n ? ll[1] : 1.f;
      d_lo = ee[0] / l_lo;
      d_hi = ee[1] / l_hi;
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
      s[i] = expf(s[i] - ((i & 2) ? m_hi : m_lo));
    if (MODE == kBlockStats) {
      // the rows' max, sum of e and sum of e dp over this key block
      float e_lo = 0.f, e_hi = 0.f;
      l_lo = l_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        if (i & 2) {
          l_hi += s[i];
          e_hi = fmaf(s[i], dp[i], e_hi);
        } else {
          l_lo += s[i];
          e_lo = fmaf(s[i], dp[i], e_lo);
        }
      }
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
      e_lo = quad_sum(e_lo);
      e_hi = quad_sum(e_hi);
      if (c4 == 0) {
        float* ps = sc.pstats + (((long long)bq * nb + kb) * a.n) * 3;
        if (qr < a.n) {
          ps[qr * 3] = m_lo;
          ps[qr * 3 + 1] = l_lo;
          ps[qr * 3 + 2] = e_lo;
        }
        if (qr + 8 < a.n) {
          ps[(qr + 8) * 3] = m_hi;
          ps[(qr + 8) * 3 + 1] = l_hi;
          ps[(qr + 8) * 3 + 2] = e_hi;
        }
      }
      continue;
    }
    if (MODE == kFused) {
      l_lo = l_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        if (i & 2)
          l_hi += s[i];
        else
          l_lo += s[i];
      }
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
    }
    r_lo = __frcp_rn(l_lo);
    r_hi = __frcp_rn(l_hi);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
      s[i] = (i & 2) ? div_by(s[i], l_hi, r_hi) : div_by(s[i], l_lo, r_lo);
    if (MODE == kFused) {
      d_lo = d_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        if (i & 2)
          d_hi = fmaf(dp[i], s[i], d_hi);
        else
          d_lo = fmaf(dp[i], s[i], d_lo);
      }
      d_lo = quad_sum(d_lo);
      d_hi = quad_sum(d_hi);
    }
    const bool live_lo = live_b && qr < a.n, live_hi = live_b && qr + 8 < a.n;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      const bool live = (i & 2) ? live_hi : live_lo;
      dp[i] = live ? s[i] * (dp[i] - ((i & 2) ? d_hi : d_lo)) : 0.f;
      s[i] = live ? s[i] : 0.f;
    }
    // the other consumer is done reading the last unit's pairs (BPU 1)
    if (BPU == 1) named_sync(1, 256);
    {
      const int tr = row_off + 16 * warp + g;     // and tr + 8; tr % 8 == g
      unsigned char* sp = split;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        const int off = (j >> 3) * kTile + tr * 128 +
                        (((j & 7) ^ g) << 4) + 4 * c4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi, lo;
          split_bf16x2(s[4 * j + 2 * h], s[4 * j + 2 * h + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sp + off + h * 1024) = hi;
          *reinterpret_cast<uint32_t*>(sp + arr + off + h * 1024) = lo;
          split_bf16x2(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sp + 2 * arr + off + h * 1024) = hi;
          *reinterpret_cast<uint32_t*>(sp + 3 * arr + off + h * 1024) = lo;
        }
      }
    }
    fence_async_smem();
    if (BPU == 1)
      named_sync(1, 256);
    else
      named_sync(2 + cw, 128);

    // 3. per half of D (the unit's): dq = ds k, dv = p^T g, dk = ds^T q
    const int out_row = row0 + 16 * warp;   // the warp's first output row
    for (int h = h0; h < h0 + per; ++h) {
      float o[64];
      // dq: its query rows, over the keys of its logits
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      uint32_t sl = r.wait();
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint32_t at = (kk >> 2) * kTile + row_off * 128 + 32 * (kk & 3);
        const uint64_t bd = sw128_mn_desc(sl + key_off * 128 + 2048 * kk,
                                          kTile);
        Ss<128, 0, 1>::mma(o, sw128_desc(ds_hi + at), bd);
        Ss<128, 0, 1>::mma(o, sw128_desc(ds_lo + at), bd);
      }
      wgmma_commit();
      fence_operands(o);
      r.issued(lane);
      r.finish(lane);
      fence_operands(o);
      if (MODE == kBlockTile) {
        const long long pb = ((long long)kb * a.b + bq) * a.n * a.d;
        store_part(o, 0, sc.pdq, pb, q0 + out_row, 128 * h, a.n, a.d, lane);
        store_part(o, 8, sc.pdq, pb, q0 + out_row, 128 * h + 64, a.n, a.d,
                   lane);
      } else if (live_b) {
        store_slab(o, 0, stage, dq, base, out_row, 128 * h, a.n, a.d,
                   a.scale, lane);
        store_slab(o, 8, stage, dq, base, out_row, 128 * h + 64, a.n, a.d,
                   a.scale, lane);
      }
      // dv = p^T g, then dk = ds^T q: its keys, over their queries
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const uint32_t ah = which ? ds_hi : p_hi, al = which ? ds_lo : p_lo;
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] = 0.f;
        sl = r.wait();
        wgmma_fence();
        for (int kk = 0; kk < qsteps; ++kk) {
          const uint32_t at = key_slab * kTile + q_off * 128 + 2048 * kk;
          const uint64_t bd = sw128_mn_desc(sl + q_off * 128 + 2048 * kk,
                                            kTile);
          Ss<128, 1, 1>::mma(o, sw128_mn_desc(ah + at, kTile), bd);
          Ss<128, 1, 1>::mma(o, sw128_mn_desc(al + at, kTile), bd);
        }
        wgmma_commit();
        fence_operands(o);
        r.issued(lane);
        r.finish(lane);
        fence_operands(o);
        if (MODE == kBlockTile) {
          float* part = which ? sc.pdk : sc.pdv;
          const long long pb = ((long long)qb * a.b + bq) * a.n * a.d;
          store_part(o, 0, part, pb, k0 + out_row, 128 * h, a.n, a.d, lane);
          store_part(o, 8, part, pb, k0 + out_row, 128 * h + 64, a.n, a.d,
                     lane);
        } else if (live_b) {
          bf16* out = which ? dk : dv;
          const float mul = which ? a.scale : 1.f;
          store_slab(o, 0, stage, out, base, out_row, 128 * h, a.n, a.d,
                     mul, lane);
          store_slab(o, 8, stage, out, base, out_row, 128 * h + 64, a.n,
                     a.d, mul, lane);
        }
      }
    }
  }
}

// The blocked design's outputs: dq the sum of its key blocks' partials,
// dk and dv of their query blocks' partials, each in block order, times
// scale (dq, dk), rounded once to bf16; four elements a thread a step
__global__ void __launch_bounds__(256)
attention_bwd_reduce_kernel(const float* __restrict__ scratch,
                            bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, Args a) {
  const Scratch sc(const_cast<float*>(scratch), a.b, a.n, a.d);
  const int nb = (a.n + 127) / 128;
  const long long elems = (long long)a.b * a.n * a.d;
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < elems; i += 4LL * gridDim.x * blockDim.x) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float* part = t == 0 ? sc.pdq : t == 1 ? sc.pdk : sc.pdv;
      float4 acc = *reinterpret_cast<const float4*>(part + i);
      for (int x = 1; x < nb; ++x) {
        const float4 v = *reinterpret_cast<const float4*>(
            part + x * elems + i);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      const float mul = t == 2 ? 1.f : a.scale;
      bf16* out = t == 0 ? dq : t == 1 ? dk : dv;
      *reinterpret_cast<uint2*>(out + i) =
          make_uint2(pack_bf16x2(acc.x * mul, acc.y * mul),
                     pack_bf16x2(acc.z * mul, acc.w * mul));
    }
  }
}

}  // namespace

int attention_bwd_wgmma(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        float* stats, int b, int n, int d, float scale,
                        cudaStream_t stream) {
  if (b <= 0 || !wgb::takes(n, d)) return (int)cudaErrorInvalidValue;
  const wgb::Layout L = wgb::layout(n, d);
  if (L.smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, gm;
  if (!map64(&qm, q, b, n, d) || !map64(&km, k, b, n, d) ||
      !map64(&vm, v, b, n, d) || !map64(&gm, g, b, n, d))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  auto grid = [&](long long units) {
    return (int)std::min<long long>(units, sms);
  };
  bf16* dqt = static_cast<bf16*>(dq);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  if (L.fused && !L.blocked) {
    const long long ub = L.bpu == 1 ? b : (b + 1) / 2;
    const int hsplit = wgb::fused_hsplit(ub, L.halves, sms);
    const long long units = ub * hsplit;
    if (units > 2147483647LL) return (int)cudaErrorInvalidValue;
    const Args a{b, n, d, (int)units, scale, hsplit};
    int err;
    if (L.bpu == 1) {
      static std::atomic<int> state[kMaxDevices];
      auto kernel = attention_bwd_fused_kernel<128, kFused>;
      if ((err = opt_in(kernel, state)) != 0) return err;
      kernel<<<grid(units), kThreads, L.smem, stream>>>(qm, km, vm, gm, dqt,
                                                        dkt, dvt, stats, a);
    } else {
      static std::atomic<int> state[kMaxDevices];
      auto kernel = attention_bwd_fused_kernel<64, kFused>;
      if ((err = opt_in(kernel, state)) != 0) return err;
      kernel<<<grid(units), kThreads, L.smem, stream>>>(qm, km, vm, gm, dqt,
                                                        dkt, dvt, stats, a);
    }
    return (int)cudaGetLastError();
  }
  if (L.blocked) {
    // the blocks' statistics, the blocks' partials, their sums
    const long long ub = (long long)b * L.tiles * L.tiles;
    const int hsplit = wgb::fused_hsplit(ub, L.halves, sms);
    if (ub * hsplit > 2147483647LL) return (int)cudaErrorInvalidValue;
    static std::atomic<int> st_state[kMaxDevices], tile_state[kMaxDevices];
    auto st_kernel = attention_bwd_fused_kernel<128, kBlockStats>;
    auto tile_kernel = attention_bwd_fused_kernel<128, kBlockTile>;
    int err = opt_in(st_kernel, st_state);
    if (err != 0) return err;
    err = opt_in(tile_kernel, tile_state);
    if (err != 0) return err;
    const Args as{b, n, d, (int)ub, scale, 1};
    st_kernel<<<grid(ub), kThreads, L.smem, stream>>>(qm, km, vm, gm, dqt,
                                                      dkt, dvt, stats, as);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const Args at{b, n, d, (int)(ub * hsplit), scale, hsplit};
    tile_kernel<<<grid(at.units), kThreads, L.smem, stream>>>(
        qm, km, vm, gm, dqt, dkt, dvt, stats, at);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const long long quads = (long long)b * n * d / 4;
    const int blocks = (int)std::min<long long>((quads + 255) / 256,
                                                8LL * sms);
    attention_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(
        stats, dqt, dkt, dvt, Args{b, n, d, 0, scale, 1});
    return (int)cudaGetLastError();
  }
  return attention_bwd_wgmma_two_pass(qm, km, vm, gm, dq, dk, dv, stats, b, n,
                                      d, scale, stream);
}
