// K2b, variant wgmma, its two-pass design (128 < N <= 512, D <= 256):
// a dq kernel and a dk/dv kernel (the design in the header of
// csrc/attention_bwd_wgmma.cu), compiled apart from the fused design so
// that the build's nvcc processes run side by side.

#include "attention_bwd_wgmma_device.cuh"

namespace {

// ---------------------------------------------------------------------------
// two-pass design (128 < N <= 512, D <= 256)
// ---------------------------------------------------------------------------

// Rows g (lo) and g + 8 (hi) of a 64 x N tile: x = s * scale, -inf at
// keys (columns) at or past n from key0
template <int N>
__device__ __forceinline__ void scale_keys(float (&x)[N], int key0, int n,
                                           float scale, int c4) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = key0 + acc_col(i, c4) < n ? __fmul_rn(x[i], scale) : -INFINITY;
}

// x = the 64 held rows at `held` (row offset applied) times NK ring rows,
// transposed, K-major both, over D's slabs: NK = 64, a 64-row tile whose
// slot holds SPS slabs (SPS 2: the whole tile at D = 128); NK = 128, 128
// rows of one slab a slot.  Issued without a wait (Ring::release_run).
// Returns the address of the last slot (SPS 2: the tile's only one).
template <int NK, int SPS>
__device__ __forceinline__ uint32_t logits(float (&x)[NK / 2], uint32_t held,
                                           int slabs, Ring& r) {
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) x[i] = 0.f;
  uint32_t sl = 0;
  for (int c0 = 0; c0 < slabs; c0 += SPS) {
    sl = r.wait();
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < SPS; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Ss<NK, 0, 0>::mma(x, sw128_desc(held + (c0 + cc) * kTile + 32 * kk),
                          sw128_desc(sl + cc * kBox + 32 * kk));
    wgmma_commit();
    fence_operands(x);
    r.next();
  }
  return sl;
}

// o += (hi + lo) b over a 64-row tile of b (steps past n from row0
// skipped), the split pair from registers, b MN-major: WIDE, one m64n128
// step from the two slabs of the slot at `sl`; else two m64n64 steps, one
// from each of the next two ring slots (o's first and second 32 floats).
// Issued without a wait.
template <bool WIDE>
__device__ __forceinline__ void split_product(float (&o)[64],
                                              const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16],
                                              int row0, int n, uint32_t sl,
                                              Ring& r) {
#pragma unroll
  for (int part = 0; part < (WIDE ? 1 : 2); ++part) {
    if (!WIDE) sl = r.wait();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (row0 + 16 * kk < n) {
        const uint64_t bd = sw128_mn_desc(sl + 2048 * kk, kBox);
        const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                                hi[4 * kk + 3]};
        const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                                lo[4 * kk + 3]};
        if constexpr (WIDE) {
          rs128(o, ah, bd);
          rs128(o, al, bd);
        } else if (part == 0) {
          rs64<0>(o, ah, bd);
          rs64<0>(o, al, bd);
        } else {
          rs64<32>(o, ah, bd);
          rs64<32>(o, al, bd);
        }
      }
    }
    wgmma_commit();
    fence_operands(o);
    if (!WIDE) r.next();
  }
}

__device__ __forceinline__ void to_split(const float (&x)[32],
                                         uint32_t (&hi)[16],
                                         uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    split_bf16x2(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// the block's shared memory: the held tiles (two tensors, slabs x 128
// rows each), the ring, the statistics (dk/dv), the staging and the
// barriers
struct TwoPassSmem {
  unsigned char *held, *ring, *staging;
  float4* stats;
  uint64_t *full, *empty, *held_full, *held_empty;

  __device__ TwoPassSmem(unsigned char* smem_raw, const wgb::Layout& L) {
    held = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    ring = held + L.held;
    stats = reinterpret_cast<float4*>(ring + L.stages * L.slot);
    staging = ring + L.stages * L.slot + wgb::kStatsBytes;
    full = reinterpret_cast<uint64_t*>(staging + wgb::kStageBytes);
    empty = full + L.stages;
    held_full = empty + L.stages;
    held_empty = held_full + 1;
  }

  __device__ void init(const wgb::Layout& L) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, wgb::kConsumerWarps);
    }
    mbar_init(held_full, 1);
    mbar_init(held_empty, wgb::kConsumerWarps);
    mbar_fence_init();
  }
};

// The producer's loads of one unit: the held tiles (tensors m0 and, when
// two, m1: all slabs of 128 rows from row0), then tiles of 64 rows, each
// in ring slots of L.sps slabs.
struct TwoPassLoads {
  TwoPassSmem& S;
  Filler& f;
  const wgb::Layout& L;
  int b;

  __device__ void held(const CUtensorMap* m0, const CUtensorMap* m1,
                       int row0, int ui) {
    mbar_wait(S.held_empty, (ui & 1) ^ 1);
    mbar_expect_tx(S.held_full, (m1 ? 2 : 1) * L.slabs * kTile);
    for (int t = 0; t < (m1 ? 2 : 1); ++t)
      for (int c = 0; c < L.slabs; ++c)
        for (int j = 0; j < 2; ++j)
          tma_load_3d(S.held + (t * L.slabs + c) * kTile + j * kBox,
                      t ? m1 : m0, S.held_full, c * wgb::kSlab,
                      row0 + 64 * j, b);
  }
  // slabs c0 .. c0 + count - 1 of the 64-row tile t, L.sps a slot
  __device__ void tile(const CUtensorMap* m, int t, int c0, int count) {
    for (int c = c0; c < c0 + count; c += L.sps) {
      uint64_t* bar;
      unsigned char* dst = f.next(L.sps * kBox, bar);
      for (int cc = 0; cc < L.sps; ++cc)
        tma_load_3d(dst + cc * kBox, m, bar, (c + cc) * wgb::kSlab, 64 * t,
                    b);
    }
  }
};

// dq kernel: unit (b, 128-row block rb, half h), h fastest.  WIDE (D =
// 128): a slot holds a whole 64-key tile, and ds k reads the k tile of
// its logits' slot; else a slot holds one slab and the half's two k
// slabs come again after the tile's K and V.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap gmap,
                              bf16* __restrict__ dq,
                              float* __restrict__ stats, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const wgb::Layout L = wgb::layout(a.n, a.d);
  TwoPassSmem S(smem_raw, L);
  const int wgi = threadIdx.x >> 7;
  const int rblocks = (a.n + 127) / 128;
  const int per_b = rblocks * L.halves;

  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&gmap);
    S.init(L);
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: q and g of the unit's rows, then K and V by key
    //      tile, twice (the second sweep with the half's k slabs when
    //      not WIDE) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      Filler f{S.ring, S.full, S.empty, L.slot, L.stages, 0};
      int ui = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++ui) {
        const int b = u / per_b, rb = (u - b * per_b) / L.halves;
        const int h = u - b * per_b - rb * L.halves;
        TwoPassLoads ld{S, f, L, b};
        ld.held(&qmap, &gmap, 128 * rb, ui);
        if (WIDE)   // sweep 1: 128 keys of one slab a slot
          for (int t = 0; t < L.tiles; t += 2)
            for (int m = 0; m < 2; ++m)
              for (int c = 0; c < L.slabs; ++c) {
                uint64_t* bar;
                unsigned char* dst = f.next(L.slot, bar);
                for (int j = 0; j < 2; ++j)
                  tma_load_3d(dst + j * kBox, m ? &vmap : &kmap, bar,
                              c * wgb::kSlab, 64 * (t + j), b);
              }
        for (int sweep = WIDE ? 1 : 0; sweep < 2; ++sweep)
          for (int t = 0; t < L.tiles; ++t) {
            ld.tile(&kmap, t, 0, L.slabs);
            ld.tile(&vmap, t, 0, L.slabs);
            if (!WIDE && sweep) {
              ld.tile(&kmap, t, 2 * h, 1);
              ld.tile(&kmap, t, 2 * h + 1, 1);
            }
          }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wgi - 1, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  unsigned char* stage =
      S.staging + (cw * 4 + warp) * 16 * wgb::kStageRow;
  const uint32_t qh = smem_addr(S.held) + 64 * cw * 128;
  const uint32_t gh = qh + L.slabs * kTile;
  Ring r{S.ring, S.full, S.empty, L.slot, L.stages, 0, -1, 0};
  int ui = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++ui) {
    const int b = u / per_b, rb = (u - b * per_b) / L.halves;
    const int h = u - b * per_b - rb * L.halves;
    const int row = 128 * rb + 64 * cw + 16 * warp + g;   // and row + 8
    mbar_wait(S.held_full, ui & 1);
    float s[32], dp[32];

    // sweep 1: each row's max m, sum l and D's sum e dp, both sums
    // rescaled when the max grows; WIDE in tiles of 128 keys (m64n128)
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    float e_lo = 0.f, e_hi = 0.f;
    auto stats_tile = [&](auto& ts, auto& tdp, int key0) {
      constexpr int NX = sizeof(ts) / sizeof(float);
      scale_keys(ts, key0, a.n, a.scale, c4);
      float tm_lo = m_lo, tm_hi = m_hi;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (i & 2)
          tm_hi = fmaxf(tm_hi, ts[i]);
        else
          tm_lo = fmaxf(tm_lo, ts[i]);
      }
      tm_lo = quad_max(tm_lo);
      tm_hi = quad_max(tm_hi);
      float sl_lo = 0.f, sl_hi = 0.f, se_lo = 0.f, se_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float e = expf(ts[i] - ((i & 2) ? tm_hi : tm_lo));
        if (i & 2) {
          sl_hi += e;
          se_hi = fmaf(e, tdp[i], se_hi);
        } else {
          sl_lo += e;
          se_lo = fmaf(e, tdp[i], se_lo);
        }
      }
      sl_lo = quad_sum(sl_lo);
      sl_hi = quad_sum(sl_hi);
      se_lo = quad_sum(se_lo);
      se_hi = quad_sum(se_hi);
      const float f_lo = expf(m_lo - tm_lo), f_hi = expf(m_hi - tm_hi);
      l_lo = fmaf(l_lo, f_lo, sl_lo);
      l_hi = fmaf(l_hi, f_hi, sl_hi);
      e_lo = fmaf(e_lo, f_lo, se_lo);
      e_hi = fmaf(e_hi, f_hi, se_hi);
      m_lo = tm_lo;
      m_hi = tm_hi;
    };
    if constexpr (WIDE) {
      for (int t = 0; t < L.tiles; t += 2) {
        float ws[64], wdp[64];
        logits<128, 1>(ws, qh, L.slabs, r);
        logits<128, 1>(wdp, gh, L.slabs, r);
        r.release_run(lane);
        fence_operands(ws);
        fence_operands(wdp);
        stats_tile(ws, wdp, 64 * t);
      }
    } else {
      for (int t = 0; t < L.tiles; ++t) {
        logits<64, 1>(s, qh, L.slabs, r);
        logits<64, 1>(dp, gh, L.slabs, r);
        r.release_run(lane);
        fence_operands(s);
        fence_operands(dp);
        stats_tile(s, dp, 64 * t);
      }
    }
    const float d_lo = e_lo / l_lo, d_hi = e_hi / l_hi;
    const float r_lo = __frcp_rn(l_lo), r_hi = __frcp_rn(l_hi);
    if (h == 0 && c4 == 0) {
      if (row < a.n) {
        float* st = stats + ((long long)b * a.n + row) * 3;
        st[0] = m_lo;
        st[1] = l_lo;
        st[2] = d_lo;
      }
      if (row + 8 < a.n) {
        float* st = stats + ((long long)b * a.n + row + 8) * 3;
        st[0] = m_hi;
        st[1] = l_hi;
        st[2] = d_hi;
      }
    }

    // sweep 2: s and dp again, p = exp(s - m) / l, ds = p (dp - D), and
    // dq += ds k over the half's 128 columns
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    for (int t = 0; t < L.tiles; ++t) {
      const uint32_t sk = logits<64, WIDE ? 2 : 1>(s, qh, L.slabs, r);
      logits<64, WIDE ? 2 : 1>(dp, gh, L.slabs, r);
      if (WIDE)
        wgmma_wait<0>();   // the K and V slots stay for ds k
      else
        r.release_run(lane);
      fence_operands(s);
      fence_operands(dp);
      scale_keys(s, 64 * t, a.n, a.scale, c4);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi_row = i & 2;
        const bool live = (hi_row ? row + 8 : row) < a.n;
        const float p = hi_row
            ? div_by(expf(s[i] - m_hi), l_hi, r_hi)
            : div_by(expf(s[i] - m_lo), l_lo, r_lo);
        s[i] = live ? p * (dp[i] - (hi_row ? d_hi : d_lo)) : 0.f;
      }
      uint32_t hi[16], lo[16];
      to_split(s, hi, lo);
      split_product<WIDE>(o, hi, lo, 64 * t, a.n, sk, r);
      r.release_run(lane);
      fence_operands(o);
    }
    if (lane == 0) mbar_arrive(S.held_empty);
    const long long base = (long long)b * a.n * a.d;
    store_slab(o, 0, stage, dq, base, row - g, 128 * h, a.n, a.d, a.scale,
               lane);
    store_slab(o, 8, stage, dq, base, row - g, 128 * h + 64, a.n, a.d,
               a.scale, lane);
  }
}

// dk/dv kernel: unit (b, 128-key block kb, half h, output: 0 dv, 1 dk),
// the output fastest.  WIDE: a slot holds a whole 64-query tile of q or
// g, and dv = p^T g or dk = ds^T q reads it; else one slab a slot and the
// half's two B slabs come again.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap gmap,
                                const float* __restrict__ stats,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                Args a) {
  extern __shared__ unsigned char smem_raw[];
  const wgb::Layout L = wgb::layout(a.n, a.d);
  TwoPassSmem S(smem_raw, L);
  const int wgi = threadIdx.x >> 7;
  const int kblocks = (a.n + 127) / 128;
  const int per_b = kblocks * L.halves * 2;

  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&gmap);
    S.init(L);
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: k (and v) of the unit's keys, then per query tile
    //      q (and g: dk's dp^T, WIDE dv's B), then the output's B slabs
    //      when not WIDE ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      Filler f{S.ring, S.full, S.empty, L.slot, L.stages, 0};
      int ui = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++ui) {
        const int b = u / per_b, rem = u - b * per_b;
        const int kb = rem / (2 * L.halves);
        const int h = (rem >> 1) % L.halves, is_dk = rem & 1;
        TwoPassLoads ld{S, f, L, b};
        ld.held(&kmap, is_dk ? &vmap : nullptr, 128 * kb, ui);
        for (int t = 0; t < L.tiles; ++t) {
          ld.tile(&qmap, t, 0, L.slabs);
          if (WIDE || is_dk) ld.tile(&gmap, t, 0, L.slabs);
          if (!WIDE) {
            ld.tile(is_dk ? &qmap : &gmap, t, 2 * h, 1);
            ld.tile(is_dk ? &qmap : &gmap, t, 2 * h + 1, 1);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wgi - 1, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  unsigned char* stage =
      S.staging + (cw * 4 + warp) * 16 * wgb::kStageRow;
  const uint32_t kh = smem_addr(S.held) + 64 * cw * 128;
  const uint32_t vh = kh + L.slabs * kTile;
  Ring r{S.ring, S.full, S.empty, L.slot, L.stages, 0, -1, 0};
  int ui = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++ui) {
    const int b = u / per_b, rem = u - b * per_b;
    const int kb = rem / (2 * L.halves);
    const int h = (rem >> 1) % L.halves, is_dk = rem & 1;
    const int key = 128 * kb + 64 * cw + 16 * warp + g;   // and key + 8
    // the batch index's statistics as (m, l, 1 / l, D), once both
    // consumers are done with the last unit's
    named_sync(1, 256);
    for (int i = threadIdx.x - 128; i < a.n; i += 256) {
      const float* st = stats + ((long long)b * a.n + i) * 3;
      const float l = st[1];
      S.stats[i] = make_float4(st[0], l, __frcp_rn(l), st[2]);
    }
    named_sync(1, 256);
    mbar_wait(S.held_full, ui & 1);
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    for (int t = 0; t < L.tiles; ++t) {
      // s^T = k q^T (and dp^T = v g^T) of its 64 keys x the tile's queries
      float s[32], dp[32];
      const uint32_t sq = logits<64, WIDE ? 2 : 1>(s, kh, L.slabs, r);
      uint32_t sg = 0;
      if (is_dk) {
        sg = logits<64, WIDE ? 2 : 1>(dp, vh, L.slabs, r);
      } else if (WIDE) {
        sg = r.wait();   // dv's B
        r.next();
      }
      if (WIDE)
        wgmma_wait<0>();   // the q and g slots stay for the product
      else
        r.release_run(lane);
      fence_operands(s);
      if (is_dk) fence_operands(dp);
      // p^T = exp(s^T * scale - m) / l and ds^T = p^T (dp^T - D) with
      // each query's statistics; zero at queries past n
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 64 * t + 8 * j + 2 * c4 + e;
          const bool live = qi < a.n;
          const float4 st = S.stats[live ? qi : 0];   // m, l, 1 / l, D
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * j + 2 * hr + e;
            const float p =
                div_by(expf(__fmul_rn(s[i], a.scale) - st.x), st.y, st.z);
            s[i] = !live ? 0.f : is_dk ? p * (dp[i] - st.w) : p;
          }
        }
      }
      uint32_t hi[16], lo[16];
      to_split(s, hi, lo);
      split_product<WIDE>(o, hi, lo, 64 * t, a.n, is_dk ? sq : sg, r);
      r.release_run(lane);
      fence_operands(o);
    }
    if (lane == 0) mbar_arrive(S.held_empty);
    const long long base = (long long)b * a.n * a.d;
    bf16* out = is_dk ? dk : dv;
    const float mul = is_dk ? a.scale : 1.f;
    store_slab(o, 0, stage, out, base, key - g, 128 * h, a.n, a.d, mul,
               lane);
    store_slab(o, 8, stage, out, base, key - g, 128 * h + 64, a.n, a.d, mul,
               lane);
  }
}

}  // namespace

int attention_bwd_wgmma_two_pass(const CUtensorMap& qm, const CUtensorMap& km,
                                 const CUtensorMap& vm, const CUtensorMap& gm,
                                 void* dq, void* dk, void* dv, float* stats,
                                 int b, int n, int d, float scale,
                                 cudaStream_t stream) {
  const wgb::Layout L = wgb::layout(n, d);
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  auto grid = [&](long long units) {
    return (int)std::min<long long>(units, sms);
  };
  bf16* dqt = static_cast<bf16*>(dq);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  const long long blocks = (long long)b * ((n + 127) / 128);
  if (blocks * L.halves * 2 > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Args aq{b, n, d, (int)(blocks * L.halves), scale, 1};
  const Args ak{b, n, d, (int)(blocks * L.halves * 2), scale, 1};
  auto two_pass = [&](auto dq_kernel, auto kv_kernel,
                      std::atomic<int> (&dq_state)[kMaxDevices],
                      std::atomic<int> (&kv_state)[kMaxDevices]) {
    int err = opt_in(dq_kernel, dq_state);
    if (err != 0) return err;
    err = opt_in(kv_kernel, kv_state);
    if (err != 0) return err;
    dq_kernel<<<grid(aq.units), kThreads, L.smem, stream>>>(qm, km, vm, gm,
                                                            dqt, stats, aq);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    kv_kernel<<<grid(ak.units), kThreads, L.smem, stream>>>(
        qm, km, vm, gm, stats, dkt, dvt, ak);
    return (int)cudaGetLastError();
  };
  if (L.sps == 2) {
    static std::atomic<int> dq_state[kMaxDevices], kv_state[kMaxDevices];
    return two_pass(attention_bwd_dq_wgmma_kernel<true>,
                    attention_bwd_dkdv_wgmma_kernel<true>, dq_state,
                    kv_state);
  }
  static std::atomic<int> dq_state[kMaxDevices], kv_state[kMaxDevices];
  return two_pass(attention_bwd_dq_wgmma_kernel<false>,
                  attention_bwd_dkdv_wgmma_kernel<false>, dq_state, kv_state);
}
