// K2b: windowed attention backward.  For o = softmax(q k^T * scale) v per
// batch index (q, k, v of shape (B, N, D), N <= 512, D <= 512) and an
// incoming gradient g of o's shape, in float32 throughout:
//   p  = softmax(q k^T * scale)          (recomputed, never rounded)
//   dv = p^T g        dp = g v^T         ds = p * (dp - rowsum(dp * p))
//   dq = ds k * scale                    dk = ds^T q * scale
// with one rounding of dq, dk, dv to the inputs' type.
//
// Replaces the backward rule of the Pallas kernel's custom_vjp,
// tera_mind_tpu/ops/attention_kernel.py _bwd (XLA maths in the JAX
// package).  At the training shapes (N = 128, D = 256 and N = 32,
// D = 512, bf16) it does 10 N^2 D operations a batch index against 14 N D
// bytes, 90 operations a byte at N = 128: under the H100's 295 for bf16,
// so bound by memory on paper.
//
// The N x N probabilities of one batch index (1 MB at N = 512) do not
// fit in shared memory beside q, k, v and g, so every variant runs two
// passes that each recompute their tile of p from q, k and per-row
// statistics: a dq pass over query tiles, which also writes each row's
// max m, sum l and D = rowsum(dp * p) to `stats` (B x N x 3 floats,
// allocated by the caller), then a dk/dv pass over key tiles that reads
// them.  Each dq, dk and dv row is summed inside one block in a fixed
// order, with no float atomics: two runs give the same bits.  Three
// variants, chosen by the caller from dtype, shape and alignment before
// the launch (ops/attention_kernel.py attention_bwd_variant):
//
// tensor_core (bf16; D % 16 == 0, N <= 128, 16-byte aligned q, k, v, g,
//   dq, dk, dv, and both passes' shared memory, bwd_tc_layout, within
//   227 KB).  Blocks of 8 warps take kTcRows = 64 rows of one batch index
//   (all N when N < 64), two blocks a batch index at N = 128, so that
//   (128, 128, 256) fills the 132 SMs.  q, k, v, g are copied into shared
//   memory as bf16 with 16-byte cp.async (two groups: the operands of the
//   first product arrive first), rows padded by 16 bytes so that ldmatrix
//   hits 8 distinct bank groups, as in K2's forward.
//   dq pass (attention_bwd_tc_dq_kernel): the block holds 64 query rows
//     of q and g and all of k and v (203 KB at N = 128, D = 256).  Warps w
//     and w + 4 take the same 16 query rows and one half of the keys each,
//     so a warp keeps 16 x 64 logits and 16 x 64 dp = g v^T in f32
//     registers (32 each), both by mma.sync m16n8k16 on the bf16 inputs;
//     the row max, the row sum and D of the two halves meet in shared
//     memory; ds goes to shared memory (over q and g) as a split pair,
//     and the 8 warps share the 64 x D output in 32 x 64 tiles:
//     dq = ds k * scale with k read through ldmatrix.trans.
//   dk/dv pass (attention_bwd_tc_dkdv_kernel): the block holds 64 key rows
//     of k and v and all of q and g.  It computes the transposed tiles
//     directly, s^T = k q^T and dp^T = v g^T (warps w and w + 4: the same
//     16 keys, one half of the queries each), p^T = exp(s^T * scale - m) / l
//     and ds^T = p^T (dp^T - D) from the dq pass's statistics, so no tile
//     is transposed in shared memory; p^T and ds^T go to shared memory
//     (over k and v) as split pairs, and the 8 warps share the 2 x 64 x D
//     outputs: dv = p^T g and dk = ds^T q * scale, q and g read through
//     ldmatrix.trans.  Its logits sum the same bf16 products over the same
//     16-wide chunks of D as the dq pass, with the operands of each mma
//     swapped, so its p may differ from the dq pass's by float32 ulps
//     (the hardware does not promise the same order inside an mma); both
//     stay far inside the gate that chip_smoke.py holds each output to.
//   Why p and ds are split: q k^T and g v^T multiply bf16 inputs, so bf16
//   mma operands lose nothing there.  But p and ds are float32 in the
//   JAX rule, and rounding them once to bf16 as mma operands changes 37-44
//   % of dq, dk and dv elements (a CPU emulation of this kernel's sums at
//   (8, 128, 256) and (8, 32, 512), randn and peaked inputs, against the
//   f32 formula, outputs rounded to bf16), far outside the K2 gate (at
//   most 1 % not bit-equal).  Every product with p or ds therefore takes
//   x = hi + lo, hi = bf16(x), lo = bf16(x - hi), as two mma.sync into
//   one f32 accumulator: the same emulation leaves 0.18-0.27 % of the
//   elements differing, by at most half a bf16 spacing at max |ref|
//   (tests/test_torch_kernels_bwd.py holds both on the CPU; chip_smoke.py
//   prints the card's share).  Do not drop the lo half: that is the 37-44
//   % above.
//   The split adds 6 N^2 D operations to the rule's 10, and the dk/dv
//   pass recomputes q k^T and g v^T: 20 N^2 D in all, 43 us at (512,
//   128, 256) at the bf16 peak, under the 70 us byte bound.
//
// tensor_core_tiled (bf16; D % 16 == 0, N <= 512, D <= 512, all seven
//   pointers 16-byte aligned: every such call that tensor_core refuses
//   because N > 128 or its shared memory would pass 227 KB).  The same
//   two passes and the same split pairs as tensor_core, with q, k, v and
//   g streamed through a ring of row tiles (csrc/attention_tiled.cuh)
//   instead of held whole; blocks of 16 warps.
//   dq pass (attention_bwd_tiled_dq_kernel): r query rows of one batch
//     index (64 for D <= 256 where they fit, else 32).  The q tile and K
//     tile by tile give the rows' f32 logits s = (q k^T) * scale, then the
//     g tile and V tile by tile their dp = g v^T, both r x N in shared
//     memory (each warp 16 rows x 8 nt keys of a tile on mma.sync); then
//     one warp a row: the exact softmax p = exp(s - m) / l in f32, D =
//     rowsum(dp * p), ds = p (dp - D) written over the row's logits as the
//     split pair (hi in the first N bf16 of the row, lo in the next N), m,
//     l and D to `stats`; then dq = ds k * scale over K streamed again,
//     each warp one 16 x 64 tile of dq in f32 registers.  Shared
//     memory (dq_tiled_layout): 2 x r x (round(N, kt) + 4) floats, r x (D +
//     8) bf16 and `stages` K / V tiles of kt rows, kt the largest of 128,
//     64, 32 that fits twice, else once: 210,432 bytes at (512, 128) (r
//     32), 200,704 at (256, 256) (r 64, kt 32), 231,936 at (512, 512).
//   dk/dv pass (attention_bwd_tiled_dkdv_kernel): kr key rows of k and v
//     (kr = 64 at D = 128 and 256, 32 at 512), q and g streamed in query
//     tiles of qt rows with the tile's m, l, D from `stats`: s^T = k q^T
//     and dp^T = v g^T of 16 keys x 8 nt queries a warp, p^T and ds^T
//     recomputed as the dq pass computes them (zero past N) and written to
//     shared memory as split pairs, then dv += p^T g and dk += ds^T q with
//     q and g through ldmatrix.trans, each warp up to two 16 x 64 tiles
//     of dv and dk in f32 registers across the query tiles.  Shared memory
//     (kv_tiled_layout): 156,416 bytes at D = 256 (qt 32, two stages).
//   Each dq, dk, dv row is summed inside one block in a fixed order.
//
// wgmma (bf16; N <= 512 and D = 128, 256, 384 or 512; all seven pointers
//   16-byte aligned): Hopper's warpgroup products fed by TMA, in
//   csrc/attention_bwd_wgmma.cu (its header there), with the same split
//   pairs and row sums kept inside one block (or summed in a fixed order);
//   one fused pass at N <= 128, the dq / dk-dv passes with `stats` above
//   at N > 128, D <= 256, 128 x 128 blocks with float32 partials in
//   `stats` (sized by the caller) above that.  Every path shape and the
//   edge (2, 512, 512) take it; tensor_core and tensor_core_tiled take
//   the bf16 calls it refuses and any forced call.
//
// cuda_core (float32, and bf16 with D % 16 != 0 or misaligned pointers),
//   f32 fmaf chains on CUDA cores:
// attention_bwd_dq_kernel, one block per batch index and kQT query rows:
//   q and g rows in shared memory (float); K, then V, staged in chunks
//   of kKC rows; the rows' logits and dp = g v^T kept whole in shared
//   memory; the softmax (row max m, sum l) and D = rowsum(dp * p) per
//   row, one warp a row; ds overwrites dp; dq = ds k * scale accumulated
//   in registers over K staged once more.  It writes m, l and D of its
//   rows to `stats`.
// attention_bwd_dkdv_kernel, one block per batch index and kKT key rows:
//   k and v rows in shared memory; for every chunk of kQC query rows
//   (q and g staged), p and ds of the tile recomputed from the chunk's
//   m, l and D, then dv += p^T g and dk += ds^T q accumulated in
//   registers.  Logits and dp are summed in the same order as in the dq
//   pass, so p and ds equal that pass's bit for bit.

#include <math.h>

#include "attention_bwd_wgmma.cuh"
#include "attention_tiled.cuh"

namespace {

enum : int { kCudaCore = 0, kTensorCore = 1, kTensorCoreTiled = 2,
             kWgmma = 3 };
// (ops/attention_kernel.py VARIANTS)

constexpr int kMaxN = 512;
constexpr int kMaxD = 512;
constexpr int kThreads = 256;
constexpr int kDPT = kMaxD / kThreads;   // output columns a thread

// dq pass
constexpr int kQT = 16;                  // query rows a block
constexpr int kKC = 32;                  // key / value rows a chunk
constexpr int kGroups = kThreads / kKC;  // row groups in the dot pass
constexpr int kRowsPer = kQT / kGroups;  // rows a thread there

constexpr size_t dq_smem(int n, int d) {
  return sizeof(float) * (2 * (size_t)kQT * d + 2 * (size_t)kQT * n +
                          (size_t)kKC * (d + 1));
}

// dk / dv pass
constexpr int kKT = 16;                  // key rows a block
constexpr int kQC = 32;                  // query rows a chunk
constexpr int kPairGroups = kThreads / kQC;     // key groups a chunk
constexpr int kKeysPer = kKT / kPairGroups;     // keys a thread there

constexpr size_t dkdv_smem(int d) {
  return sizeof(float) * (2 * (size_t)kKT * d + 2 * (size_t)kQC * (d + 1) +
                          2 * (size_t)kKT * kQC);
}

static_assert(dq_smem(kMaxN, kMaxD) <= (size_t)kMaxBlockSmem &&
                  dkdv_smem(kMaxD) <= (size_t)kMaxBlockSmem,
              "the largest shape must fit a block's shared memory");

// out[i][j0 + j] = (rows[i] . src[j0 + j]) * mul for the kQT rows held in
// shared memory against every row of src, staged kKC rows at a time in
// cs (rows padded by one word).  Thread (jl, ig) takes key jl of a chunk
// against rows ig, ig + kGroups, ...; a warp shares ig, so the row reads
// are broadcasts.  The dot runs fmaf(row, src, acc) over e in order.
template <typename T>
__device__ void rows_dot(const T* __restrict__ src, const float* rows,
                         float* out, float* cs, int n, int d, float mul) {
  const int tid = threadIdx.x;
  const int jl = tid % kKC, ig = tid / kKC;
  const int ld = d + 1;
  for (int j0 = 0; j0 < n; j0 += kKC) {
    const int nk = min(kKC, n - j0);
    __syncthreads();
    for (int idx = tid; idx < nk * d; idx += kThreads) {
      const int j = idx / d;
      cs[j * ld + (idx - j * d)] = to_f32(src[(long long)j0 * d + idx]);
    }
    __syncthreads();
    if (jl < nk) {
      float acc[kRowsPer];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) acc[r] = 0.f;
      const float* sr = cs + jl * ld;
      for (int e = 0; e < d; ++e) {
        const float sv = sr[e];
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r)
          acc[r] = fmaf(rows[(ig + r * kGroups) * d + e], sv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r)
        out[(ig + r * kGroups) * n + j0 + jl] = acc[r] * mul;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        T* __restrict__ dq, float* __restrict__ stats,
                        int n, int d, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // (kQT, d)
  float* gs = qs + kQT * d;      // (kQT, d)
  float* ps = gs + kQT * d;      // (kQT, n) logits, then p
  float* ds = ps + kQT * n;      // (kQT, n) dp, then ds
  float* cs = ds + kQT * n;      // (kKC, d + 1) K or V chunk
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * n * d;
  const int i0 = blockIdx.y * kQT;
  const int nq = min(kQT, n - i0);

  for (int idx = tid; idx < kQT * d; idx += kThreads) {
    const bool live = idx / d < nq;
    const long long at = base + (long long)i0 * d + idx;
    qs[idx] = live ? to_f32(q[at]) : 0.f;
    gs[idx] = live ? to_f32(g[at]) : 0.f;
  }
  rows_dot<T>(k + base, qs, ps, cs, n, d, scale);   // logits
  rows_dot<T>(v + base, gs, ds, cs, n, d, 1.f);     // dp
  __syncthreads();

  // per row, one warp a row: softmax, D = rowsum(dp * p), ds
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < nq; i += kThreads / 32) {
    float* pr = ps + i * n;
    float* dr = ds + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float ev = expf(pr[j] - m);
      pr[j] = ev;
      l += ev;
    }
    l = warp_sum(l);
    float dsum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = pr[j] / l;
      pr[j] = p;
      dsum = fmaf(dr[j], p, dsum);
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < n; j += 32) dr[j] = pr[j] * (dr[j] - dsum);
    if (lane == 0) {
      float* st = stats + ((long long)blockIdx.x * n + i0 + i) * 3;
      st[0] = m;
      st[1] = l;
      st[2] = dsum;
    }
  }

  // dq = ds k * scale, float accumulation in registers
  float acc[kQT][kDPT];
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int c = 0; c < kDPT; ++c) acc[i][c] = 0.f;
  const int ld = d + 1;
  for (int j0 = 0; j0 < n; j0 += kKC) {
    const int nk = min(kKC, n - j0);
    __syncthreads();
    for (int idx = tid; idx < nk * d; idx += kThreads) {
      const int j = idx / d;
      cs[j * ld + (idx - j * d)] = to_f32(k[base + (long long)j0 * d + idx]);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* kr = cs + j * ld;
      float kv[kDPT];
#pragma unroll
      for (int c = 0; c < kDPT; ++c) {
        const int e = tid + c * kThreads;
        kv[c] = e < d ? kr[e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const float s = i < nq ? ds[i * n + j0 + j] : 0.f;
#pragma unroll
        for (int c = 0; c < kDPT; ++c) acc[i][c] = fmaf(s, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
    if (i >= nq) break;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) {
      const int e = tid + c * kThreads;
      if (e < d)
        dq[base + (long long)(i0 + i) * d + e] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ stats,
                          T* __restrict__ dk, T* __restrict__ dv, int n,
                          int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;              // (kKT, d)
  float* vs = ks + kKT * d;      // (kKT, d)
  float* qc = vs + kKT * d;      // (kQC, d + 1) query chunk
  float* gc = qc + kQC * ld;     // (kQC, d + 1) gradient chunk
  float* pt = gc + kQC * ld;     // (kKT, kQC) p
  float* dt = pt + kKT * kQC;    // (kKT, kQC) ds
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * n * d;
  const int j0 = blockIdx.y * kKT;
  const int nkeys = min(kKT, n - j0);

  for (int idx = tid; idx < kKT * d; idx += kThreads) {
    const bool live = idx / d < nkeys;
    const long long at = base + (long long)j0 * d + idx;
    ks[idx] = live ? to_f32(k[at]) : 0.f;
    vs[idx] = live ? to_f32(v[at]) : 0.f;
  }

  float adk[kKT][kDPT], adv[kKT][kDPT];
#pragma unroll
  for (int r = 0; r < kKT; ++r)
#pragma unroll
    for (int c = 0; c < kDPT; ++c) adk[r][c] = adv[r][c] = 0.f;

  // thread (il, jg) computes query il of a chunk against keys jg,
  // jg + kPairGroups, ...; a warp shares jg, so key reads are broadcasts
  const int il = tid % kQC, jg = tid / kQC;
  for (int q0 = 0; q0 < n; q0 += kQC) {
    const int nq = min(kQC, n - q0);
    __syncthreads();
    for (int idx = tid; idx < nq * d; idx += kThreads) {
      const int i = idx / d;
      const long long at = base + (long long)q0 * d + idx;
      qc[i * ld + (idx - i * d)] = to_f32(q[at]);
      gc[i * ld + (idx - i * d)] = to_f32(g[at]);
    }
    __syncthreads();
    {
      float s[kKeysPer], dp[kKeysPer];
#pragma unroll
      for (int r = 0; r < kKeysPer; ++r) s[r] = dp[r] = 0.f;
      if (il < nq) {
        const float* qr = qc + il * ld;
        const float* gr = gc + il * ld;
        for (int e = 0; e < d; ++e) {
          const float qv = qr[e], gv = gr[e];
#pragma unroll
          for (int r = 0; r < kKeysPer; ++r) {
            const int j = jg + r * kPairGroups;
            s[r] = fmaf(qv, ks[j * d + e], s[r]);
            dp[r] = fmaf(gv, vs[j * d + e], dp[r]);
          }
        }
      }
      float m = 0.f, l = 1.f, dsum = 0.f;
      if (il < nq) {
        const float* st = stats + ((long long)blockIdx.x * n + q0 + il) * 3;
        m = st[0];
        l = st[1];
        dsum = st[2];
      }
#pragma unroll
      for (int r = 0; r < kKeysPer; ++r) {
        const int j = jg + r * kPairGroups;
        float p = 0.f, dsv = 0.f;
        if (il < nq && j < nkeys) {
          // rounded before the subtract, as the dq pass stores it
          p = expf(__fmul_rn(s[r], scale) - m) / l;
          dsv = p * (dp[r] - dsum);
        }
        pt[j * kQC + il] = p;
        dt[j * kQC + il] = dsv;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kDPT; ++c) {
      const int e = tid + c * kThreads;
      if (e >= d) break;
      for (int i = 0; i < nq; ++i) {
        const float gv = gc[i * ld + e], qv = qc[i * ld + e];
#pragma unroll
        for (int r = 0; r < kKT; ++r) {
          adv[r][c] = fmaf(pt[r * kQC + i], gv, adv[r][c]);
          adk[r][c] = fmaf(dt[r * kQC + i], qv, adk[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kKT; ++r) {
    if (r >= nkeys) break;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) {
      const int e = tid + c * kThreads;
      if (e < d) {
        const long long at = base + (long long)(j0 + r) * d + e;
        dk[at] = from_f32<T>(adk[r][c] * scale);
        dv[at] = from_f32<T>(adv[r][c]);
      }
    }
  }
}

template <typename T>
int launch_cuda_core(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv,
                     float* stats, int b, int n, int d, float scale,
                     cudaStream_t stream) {
  static std::atomic<int> dq_opt[kMaxDevices], dkdv_opt[kMaxDevices];
  cudaError_t err = smem_opt_in(attention_bwd_dq_kernel<T>,
                                (int)dq_smem(kMaxN, kMaxD), dq_opt);
  if (err != cudaSuccess) return (int)err;
  err = smem_opt_in(attention_bwd_dkdv_kernel<T>, (int)dkdv_smem(kMaxD),
                    dkdv_opt);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  attention_bwd_dq_kernel<T><<<dim3(b, (n + kQT - 1) / kQT), kThreads,
                               dq_smem(n, d), stream>>>(
      qt, kt, vt, gt, static_cast<T*>(dq), stats, n, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<T><<<dim3(b, (n + kKT - 1) / kKT), kThreads,
                                 dkdv_smem(d), stream>>>(
      qt, kt, vt, gt, stats, static_cast<T*>(dk), static_cast<T*>(dv), n, d,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor_core variant (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxN = 128;
constexpr int kTcRows = 64;                // rows of a block's tile
constexpr int kHalfGroups = kTcMaxN / 32;  // 16-column groups of a half
constexpr int kHalfTiles = 2 * kHalfGroups;  // its 8-column mma tiles
constexpr int kPad = 8;                    // bf16 row padding (16 bytes)

// Shared-memory layouts of the two passes, offsets in bf16 elements.  np
// = N rounded up to 16; rt = min(kTcRows, np), the rows of a block's
// tile; q, k, v, g rows of ld = D + kPad, p and ds rows of ldp = np +
// kPad.  dq pass: the q and g tiles (rt rows), k and v (np rows); ds (hi
// and lo, rt rows each) over the q and g tiles when it fits there, else
// after v; then the two halves' row max, sum and D (3 x 2 x kTcRows
// floats).  dk/dv pass: q and g (np rows), the k and v tiles (rt rows);
// p^T and ds^T (hi and lo each, rt rows) over the k and v tiles, running
// past them when larger; then m, l and D of the np queries (3 x np
// floats).
struct BwdTcLayout {
  int np, rt, ld, ldp;
  size_t dq_g, dq_k, dq_v, dq_ds, dq_red, dq_bytes;
  size_t kv_g, kv_k, kv_v, kv_p, kv_stats, kv_bytes;
};

__host__ __device__ constexpr BwdTcLayout bwd_tc_layout(int n, int d) {
  const int np = (n + 15) & ~15;
  const int rt = np < kTcRows ? np : kTcRows;
  const size_t ld = d + kPad, ldp = np + kPad;
  const size_t tile = rt * ld, full = np * ld, ds = 2 * rt * ldp;
  const bool ds_in_qg = ds <= 2 * tile;
  const size_t dq_ds = ds_in_qg ? 0 : 2 * tile + 2 * full;
  const size_t dq_red = ds_in_qg ? 2 * tile + 2 * full : dq_ds + ds;
  const size_t kv_p = 2 * full;
  const size_t kv_stats = kv_p + (2 * ds > 2 * tile ? 2 * ds : 2 * tile);
  return BwdTcLayout{np, rt, (int)ld, (int)ldp,
                     tile, 2 * tile, 2 * tile + full, dq_ds, dq_red,
                     2 * dq_red + sizeof(float) * 6 * kTcRows,
                     full, 2 * full, 2 * full + tile, kv_p, kv_stats,
                     2 * kv_stats + sizeof(float) * 3 * np};
}

constexpr bool tc_takes(int n, int d) {
  return n <= kTcMaxN && d % 16 == 0 && d <= kMaxD &&
         bwd_tc_layout(n, d).dq_bytes <= (size_t)kMaxBlockSmem &&
         bwd_tc_layout(n, d).kv_bytes <= (size_t)kMaxBlockSmem;
}

static_assert(tc_takes(128, 256) && tc_takes(32, 512) && tc_takes(100, 48) &&
                  bwd_tc_layout(128, 256).dq_bytes == 204288 &&
                  bwd_tc_layout(128, 256).kv_bytes == 206336,
              "the training shapes must take the tensor-core variant");

// Rows r0 .. r0 + nrows - 1 of one batch index's (n, d) array into shared
// memory rows of ld elements by 16-byte cp.async; rows at or past n are
// zeroed.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int nrows, int n, int d,
                                           int ld) {
  const int vpr = d / 8;
  for (int idx = threadIdx.x; idx < nrows * vpr; idx += kTcThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    if (r0 + r < n)
      cp_async16(dst + r * ld + c, src + (size_t)(r0 + r) * d + c);
    else
      zero16(dst + r * ld + c);
  }
}

// The 16-row groups [first, first + count) of np rows that half h of a
// warp pair takes: the first ceil(groups / 2), then the rest.
__device__ __forceinline__ void half_groups(int np, int h, int& first,
                                            int& count) {
  const int ng = np / 16, lo = (ng + 1) / 2;
  first = h ? lo : 0;
  count = h ? ng - lo : lo;
}

__device__ __forceinline__ void zero_tiles(float (&x)[kHalfTiles][4]) {
#pragma unroll
  for (int j = 0; j < kHalfTiles; ++j)
    x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// acc[2j + h] += a b^T over d for the 16 rows at a and rows 16j + 8h ..
// 16j + 8h + 7 at b (j < groups), both in shared memory with rows of ld:
// bf16 operands through ldmatrix, mma.sync into float accumulators.  The
// asm of both is volatile, so the compiler issues them in source order:
// each 16-wide step loads all its fragments before its first mma, so the
// loads are in flight together.
__device__ __forceinline__ void rows_by_rows(float (&acc)[kHalfTiles][4],
                                             const bf16* a, const bf16* b,
                                             int groups, int d, int ld,
                                             int lane) {
  const bf16* pa = a + (lane & 15) * ld + (lane >> 4) * 8;
  const bf16* pb =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < d; k0 += 16) {
    uint32_t af[4], bf[kHalfGroups][4];
    ldmatrix_x4(af, pa + k0);
#pragma unroll
    for (int j = 0; j < kHalfGroups; ++j)
      if (j < groups) ldmatrix_x4(bf[j], pb + 16 * j * ld + k0);
#pragma unroll
    for (int j = 0; j < kHalfGroups; ++j) {
      if (j < groups) {
        mma_bf16_16816(acc[2 * j], af, bf[j][0], bf[j][1]);
        mma_bf16_16816(acc[2 * j + 1], af, bf[j][2], bf[j][3]);
      }
    }
  }
}

// The first `tiles` accumulator tiles x[j] (rows row + g and row + g + 8,
// columns col0 + 8j + 2c, +1) as split bf16 pairs into the rows of ldp
// at hi and lo.
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int ldp,
                                            int row, int col0,
                                            const float (&x)[kHalfTiles][4],
                                            int tiles, int lane) {
  const int at0 = (row + (lane >> 2)) * ldp + col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kHalfTiles; ++j) {
    if (j < tiles) {
      const int at = at0 + 8 * j;
      uint32_t h, l;
      split_bf16x2(x[j][0], x[j][1], h, l);
      *reinterpret_cast<uint32_t*>(hi + at) = h;
      *reinterpret_cast<uint32_t*>(lo + at) = l;
      split_bf16x2(x[j][2], x[j][3], h, l);
      *reinterpret_cast<uint32_t*>(hi + at + 8 * ldp) = h;
      *reinterpret_cast<uint32_t*>(lo + at + 8 * ldp) = l;
    }
  }
}

// One 32 x 64 tile (rows rb.., columns cb..) of out = (ah + al) b * mul,
// summed over the kn rows of b: ah, al rows of lda and b rows of ldb in
// shared memory, b read through ldmatrix.trans; for each 16-row step the
// hi and then the lo product go into one float accumulator.  A step loads
// all its fragments first, then issues every hi product and then every
// lo product, so no mma waits on the one before it (the asm is volatile:
// source order is issue order).  Rows of the tile at or past `rows` are
// not computed, rows at or past `valid` not stored; out has rows of d
// elements.
__device__ __forceinline__ void split_tile(const bf16* ah, const bf16* al,
                                           int lda, const bf16* b, int ldb,
                                           int rb, int cb, int rows, int kn,
                                           int d, float mul,
                                           bf16* __restrict__ out, int valid,
                                           int lane) {
  const bool two = rb + 16 < rows;
  float acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
  const int ao = (rb + (lane & 15)) * lda + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + cb +
                   (lane >> 4) * 8;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t af[2][2][4], bf[4][4];   // af[row half][hi, lo]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 0 || two) {
        ldmatrix_x4(af[h][0], ah + ao + 16 * h * lda + k0);
        ldmatrix_x4(af[h][1], al + ao + 16 * h * lda + k0);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (cb + 16 * j < d) ldmatrix_x4_trans(bf[j], pb + k0 * ldb + 16 * j);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 0 || two) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (cb + 16 * j < d) {
              mma_bf16_16816(acc[h][2 * j], af[h][part], bf[j][0], bf[j][1]);
              mma_bf16_16816(acc[h][2 * j + 1], af[h][part], bf[j][2],
                             bf[j][3]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !two) break;
    const int row = rb + 16 * h + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb + 8 * j + 2 * (lane & 3);
      if (cb + 8 * j < d) {
        if (row < valid)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * d + c) =
              pack_bf16x2(acc[h][j][0] * mul, acc[h][j][1] * mul);
        if (row + 8 < valid)
          *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * d + c) =
              pack_bf16x2(acc[h][j][2] * mul, acc[h][j][3] * mul);
      }
    }
  }
}

__device__ __forceinline__ void quad_max(float (&v)[2]) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    v[0] = fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
    v[1] = fmaxf(v[1], __shfl_xor_sync(0xffffffffu, v[1], off));
  }
}

__device__ __forceinline__ void quad_sum(float (&v)[2]) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    v[1] += __shfl_xor_sync(0xffffffffu, v[1], off);
  }
}

// Row values v (rows row, row + 8) of this half of a warp pair into
// red[half][.]; after the caller's __syncthreads, both halves' values of
// a row are red[row] and red[kTcRows + row].
__device__ __forceinline__ void publish(float* red, const float (&v)[2],
                                        int half, int row, bool write) {
  if (write) {
    red[half * kTcRows + row] = v[0];
    red[half * kTcRows + row + 8] = v[1];
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
attention_bwd_tc_dq_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ g, bf16* __restrict__ dq,
                           float* __restrict__ stats, int n, int d,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdTcLayout L = bwd_tc_layout(n, d);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + L.dq_g;
  bf16* ks = qs + L.dq_k;
  bf16* vs = qs + L.dq_v;
  bf16* dsh = qs + L.dq_ds;
  bf16* dsl = dsh + (size_t)L.rt * L.ldp;
  float* red_m = reinterpret_cast<float*>(qs + L.dq_red);
  float* red_l = red_m + 2 * kTcRows;
  float* red_d = red_l + 2 * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (L.np + L.rt - 1) / L.rt;
  const int bi = blockIdx.x / tiles;           // the batch index
  const int i0 = (blockIdx.x - bi * tiles) * L.rt;  // its first query row
  const int rows = min(L.rt, L.np - i0);
  const size_t base = (size_t)bi * n * d;

  // 1. the q tile and k (group 0), then the g tile and v (group 1)
  stage_rows(qs, q + base, i0, rows, n, d, L.ld);
  stage_rows(ks, k + base, 0, L.np, n, d, L.ld);
  cp_async_commit();
  stage_rows(gs, g + base, i0, rows, n, d, L.ld);
  stage_rows(vs, v + base, 0, L.np, n, d, L.ld);
  cp_async_commit();

  // 2. warps w and w + 4: rows r0.. r0 + 15, the first or second half of
  //    the keys; logits s and dp = g v^T in registers
  const int r0 = 16 * (warp & 3), half = warp >> 2;
  const int row = r0 + (lane >> 2);            // and row + 8
  const bool live = r0 < rows;
  int kg0, nkg;
  half_groups(L.np, half, kg0, nkg);
  float s[kHalfTiles][4], dp[kHalfTiles][4];
  zero_tiles(s);
  zero_tiles(dp);
  cp_async_wait<1>();
  __syncthreads();
  if (live)
    rows_by_rows(s, qs + r0 * L.ld, ks + 16 * kg0 * L.ld, nkg, d, L.ld,
                 lane);
  cp_async_wait<0>();
  __syncthreads();
  if (live)
    rows_by_rows(dp, gs + r0 * L.ld, vs + 16 * kg0 * L.ld, nkg, d, L.ld,
                 lane);

  // 3. the exact softmax of rows row (elements 0, 1) and row + 8 (2, 3):
  //    a half's keys of a row lie in the 4 lanes of a quad, and the two
  //    halves meet in shared memory; then D = rowsum(dp * p), the same
  //    way, and ds = p * (dp - D)
  const int key0 = 16 * kg0 + 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kHalfTiles; ++j) {
    if (j < 2 * nkg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + (e & 1);
        s[j][e] = key < n ? __fmul_rn(s[j][e], scale) : -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    }
  }
  quad_max(m);
  const bool writer = live && (lane & 3) == 0;
  publish(red_m, m, half, row, writer);
  __syncthreads();   // also: every warp is done with q and g
  float l[2] = {0.f, 0.f};
  if (live) {
    m[0] = fmaxf(red_m[row], red_m[kTcRows + row]);
    m[1] = fmaxf(red_m[row + 8], red_m[kTcRows + row + 8]);
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j) {
      if (j < 2 * nkg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }
    }
  }
  quad_sum(l);
  publish(red_l, l, half, row, writer);
  __syncthreads();
  float dsum[2] = {0.f, 0.f};
  if (live) {
    l[0] = red_l[row] + red_l[kTcRows + row];
    l[1] = red_l[row + 8] + red_l[kTcRows + row + 8];
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j) {
      if (j < 2 * nkg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] /= l[e >> 1];
          dsum[e >> 1] = fmaf(dp[j][e], s[j][e], dsum[e >> 1]);
        }
      }
    }
  }
  quad_sum(dsum);
  publish(red_d, dsum, half, row, writer);
  __syncthreads();
  if (live) {
    dsum[0] = red_d[row] + red_d[kTcRows + row];
    dsum[1] = red_d[row + 8] + red_d[kTcRows + row + 8];
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - dsum[e >> 1]);
    store_split(dsh, dsl, L.ldp, r0, 16 * kg0, dp, 2 * nkg, lane);
    if (half == 0 && (lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (i0 + row + 8 * h < n) {
          float* st = stats + ((size_t)bi * n + i0 + row + 8 * h) * 3;
          st[0] = m[h];
          st[1] = l[h];
          st[2] = dsum[h];
        }
      }
    }
  }
  __syncthreads();

  // 4. dq = ds k * scale in 32 x 64 tiles over the 8 warps
  const int n_ct = (d + 63) / 64, n_tiles = ((rows + 31) / 32) * n_ct;
  for (int t = warp; t < n_tiles; t += kTcWarps)
    split_tile(dsh, dsl, L.ldp, ks, L.ld, (t / n_ct) * 32, (t % n_ct) * 64,
               rows, L.np, d, scale, dq + base + (size_t)i0 * d, n - i0,
               lane);
}

__global__ void __launch_bounds__(kTcThreads, 1)
attention_bwd_tc_dkdv_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ stats,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int n, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdTcLayout L = bwd_tc_layout(n, d);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + L.kv_g;
  bf16* ks = qs + L.kv_k;
  bf16* vs = qs + L.kv_v;
  const size_t pe = (size_t)L.rt * L.ldp;
  bf16* pth = qs + L.kv_p;
  bf16* ptl = pth + pe;
  bf16* dsh = ptl + pe;
  bf16* dsl = dsh + pe;
  float* sm = reinterpret_cast<float*>(qs + L.kv_stats);
  float* sl = sm + L.np;
  float* sd = sl + L.np;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (L.np + L.rt - 1) / L.rt;
  const int bi = blockIdx.x / tiles;           // the batch index
  const int j0 = (blockIdx.x - bi * tiles) * L.rt;  // its first key row
  const int rows = min(L.rt, L.np - j0);
  const size_t base = (size_t)bi * n * d;

  // 1. the k tile and q (group 0), then the v tile and g (group 1); the
  //    dq pass's statistics of every query
  stage_rows(ks, k + base, j0, rows, n, d, L.ld);
  stage_rows(qs, q + base, 0, L.np, n, d, L.ld);
  cp_async_commit();
  stage_rows(vs, v + base, j0, rows, n, d, L.ld);
  stage_rows(gs, g + base, 0, L.np, n, d, L.ld);
  cp_async_commit();
  for (int i = threadIdx.x; i < L.np; i += kTcThreads) {
    const bool in = i < n;
    const float* st = stats + ((size_t)bi * n + (in ? i : 0)) * 3;
    sm[i] = in ? st[0] : 0.f;
    sl[i] = in ? st[1] : 1.f;
    sd[i] = in ? st[2] : 0.f;
  }

  // 2. warps w and w + 4: key rows r0.. r0 + 15 of the tile, the first or
  //    second half of the queries; s^T = k q^T and dp^T = v g^T
  const int r0 = 16 * (warp & 3), half = warp >> 2;
  const bool live = r0 < rows;
  int qg0, nqg;
  half_groups(L.np, half, qg0, nqg);
  float s[kHalfTiles][4], dp[kHalfTiles][4];
  zero_tiles(s);
  zero_tiles(dp);
  cp_async_wait<1>();
  __syncthreads();
  if (live)
    rows_by_rows(s, ks + r0 * L.ld, qs + 16 * qg0 * L.ld, nqg, d, L.ld,
                 lane);
  cp_async_wait<0>();
  __syncthreads();
  if (live)
    rows_by_rows(dp, vs + r0 * L.ld, gs + 16 * qg0 * L.ld, nqg, d, L.ld,
                 lane);

  // 3. p^T and ds^T of key j0 + r0 + g (+ 8 for elements 2, 3) and query
  //    16 qg0 + 8j + 2c (+ 1 for elements 1, 3), as the dq pass computes
  //    them; zero past n
  const int q0 = 16 * qg0 + 2 * (lane & 3);
  const int key = j0 + r0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kHalfTiles; ++j) {
    if (j < 2 * nqg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 8 * j + (e & 1);
        float p = 0.f, ds = 0.f;
        if (qi < n && key + 8 * (e >> 1) < n) {
          p = expf(__fmul_rn(s[j][e], scale) - sm[qi]) / sl[qi];
          ds = p * (dp[j][e] - sd[qi]);
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }
  }
  __syncthreads();   // every warp is done with the k and v tiles
  if (live) {
    store_split(pth, ptl, L.ldp, r0, 16 * qg0, s, 2 * nqg, lane);
    store_split(dsh, dsl, L.ldp, r0, 16 * qg0, dp, 2 * nqg, lane);
  }
  __syncthreads();

  // 4. dv = p^T g and dk = ds^T q * scale in 32 x 64 tiles over the warps
  const int n_ct = (d + 63) / 64, per = ((rows + 31) / 32) * n_ct;
  for (int t = warp; t < 2 * per; t += kTcWarps) {
    const bool dk_tile = t >= per;
    const int u = dk_tile ? t - per : t;
    split_tile(dk_tile ? dsh : pth, dk_tile ? dsl : ptl, L.ldp,
               dk_tile ? qs : gs, L.ld, (u / n_ct) * 32, (u % n_ct) * 64,
               rows, L.np, d, dk_tile ? scale : 1.f,
               (dk_tile ? dk : dv) + base + (size_t)j0 * d, n - j0, lane);
  }
}

int launch_tensor_core(const void* q, const void* k, const void* v,
                       const void* g, void* dq, void* dk, void* dv,
                       float* stats, int b, int n, int d, float scale,
                       cudaStream_t stream) {
  static std::atomic<int> dq_opt[kMaxDevices], dkdv_opt[kMaxDevices];
  cudaError_t err =
      smem_opt_in(attention_bwd_tc_dq_kernel, kMaxBlockSmem, dq_opt);
  if (err != cudaSuccess) return (int)err;
  err = smem_opt_in(attention_bwd_tc_dkdv_kernel, kMaxBlockSmem, dkdv_opt);
  if (err != cudaSuccess) return (int)err;
  const BwdTcLayout L = bwd_tc_layout(n, d);
  const int blocks = b * ((L.np + L.rt - 1) / L.rt);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  attention_bwd_tc_dq_kernel<<<blocks, kTcThreads, L.dq_bytes, stream>>>(
      qt, kt, vt, gt, static_cast<bf16*>(dq), stats, n, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_tc_dkdv_kernel<<<blocks, kTcThreads, L.kv_bytes, stream>>>(
      qt, kt, vt, gt, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n, d, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor_core_tiled variant (bf16)
// ---------------------------------------------------------------------------

constexpr int kTlMaxNt = 2;     // 8-column mma tiles of a warp's logit unit
constexpr int kTlSlots = 2;     // dv / dk tiles a warp keeps (dk/dv pass)

// dq pass, byte offsets: the f32 logits of the block's r query rows at 0
// and their dp = g v^T at dp (ns = N rounded up to kt columns, rows
// of lds = ns + 4 floats; ds overwrites the logits in place as the split
// pair, hi in the first ns bf16 of a row and lo in the next ns, rows of 2
// lds), the q tile, later the g tile (rows of ldq = D + 8 bf16) at a, and
// `stages` K or V tiles of kt rows from ring on.  nt: 8-key mma tiles of
// a warp's unit of 16 rows (16 units a tile).
struct DqTiledLayout {
  int r, kt, stages, ns, lds, ldq, nt;
  size_t dp, a, ring, tile, bytes;
};

__host__ __device__ constexpr DqTiledLayout dq_tiled_make(int n, int d, int r,
                                                         int kt, int stages) {
  const int ns = (n + kt - 1) / kt * kt;
  const int lds = ns + tl::kSPad, ldq = d + tl::kPad;
  const size_t dp = (size_t)4 * r * lds;
  const size_t a = 2 * dp;
  const size_t ring = a + (size_t)2 * r * ldq;
  const size_t tile = (size_t)2 * kt * ldq;
  const int nt0 = (r / 16) * (kt / 8) / tl::kWarps;
  const int nt = nt0 < 1 ? 1 : nt0 > kTlMaxNt ? kTlMaxNt : nt0;
  return DqTiledLayout{r, kt, stages, ns, lds, ldq, nt,
                       dp, a, ring, tile, ring + stages * tile};
}

// r = 64 query rows where D <= 256 and they fit, else 32 (the dq pass's
// 16 x 64 tiles, r / 16 x ceil(D / 64) of them, one a warp); then the
// largest K / V tile that fits twice, else once.
__host__ __device__ constexpr DqTiledLayout dq_tiled_layout(int n, int d) {
  for (int r = d <= 256 ? 64 : 32; r >= 32; r /= 2)
    for (int stages = 2; stages >= 1; --stages)
      for (int kt = 128; kt >= 32; kt /= 2) {
        const DqTiledLayout L = dq_tiled_make(n, d, r, kt, stages);
        if (L.bytes <= (size_t)kMaxBlockSmem) return L;
      }
  return dq_tiled_make(n, d, 32, 32, 1);
}

// dk/dv pass, byte offsets: the block's kr key rows of k at 0 and of v at
// v (rows of ldq), `stages` stages from ring on, each a q tile and a g
// tile of qt rows and the m, l, D of those qt queries (f32, at stats
// within the stage), then p^T and ds^T of the key tile, hi and lo each
// (kr rows of ldp = qt + 8 bf16), from split on.  kr = 16 x (16 / ceil(D
// / 64)), at most 64: the block's 16 x 64 tiles of dv and dk, at most 32,
// kTlSlots to a warp, stay in f32 registers (at most 64 a thread) across
// the query tiles.
struct KvTiledLayout {
  int kr, qt, stages, ldq, ldp, nt;
  size_t v, ring, stage, stats, split, bytes;
};

__host__ __device__ constexpr KvTiledLayout kv_tiled_make(int d, int qt,
                                                         int stages) {
  const int kr0 = 16 * (tl::kWarps / ((d + 63) / 64));
  const int kr = kr0 > 64 ? 64 : kr0;
  const int ldq = d + tl::kPad, ldp = qt + tl::kPad;
  const size_t v = (size_t)2 * kr * ldq;
  const size_t ring = 2 * v;
  const size_t stats = (size_t)4 * qt * ldq;
  const size_t stage = stats + (size_t)4 * 3 * qt;
  const size_t split = ring + stages * stage;
  const int nt0 = (kr / 16) * (qt / 8) / tl::kWarps;
  const int nt = nt0 < 1 ? 1 : nt0 > kTlMaxNt ? kTlMaxNt : nt0;
  return KvTiledLayout{kr, qt, stages, ldq, ldp, nt, v, ring, stage, stats,
                       split, split + (size_t)2 * 4 * kr * ldp};
}

__host__ __device__ constexpr KvTiledLayout kv_tiled_layout(int d) {
  for (int stages = 2; stages >= 1; --stages)
    for (int qt = 64; qt >= 32; qt /= 2) {
      const KvTiledLayout L = kv_tiled_make(d, qt, stages);
      if (L.bytes <= (size_t)kMaxBlockSmem) return L;
    }
  return kv_tiled_make(d, 32, 1);
}

constexpr bool tiled_takes(int n, int d) {
  return n >= 1 && n <= kMaxN && d >= 16 && d % 16 == 0 && d <= kMaxD &&
         dq_tiled_layout(n, d).bytes <= (size_t)kMaxBlockSmem &&
         kv_tiled_layout(d).bytes <= (size_t)kMaxBlockSmem;
}

static_assert(tiled_takes(512, 128) && tiled_takes(128, 512) &&
                  tiled_takes(256, 256) && tiled_takes(512, 512) &&
                  dq_tiled_layout(512, 128).bytes == 210432 &&
                  dq_tiled_layout(512, 512).bytes == 231936 &&
                  dq_tiled_layout(256, 256).r == 64 &&
                  dq_tiled_layout(256, 256).bytes == 200704 &&
                  kv_tiled_layout(256).bytes == 156416 &&
                  kv_tiled_layout(512).kr == 32 &&
                  kv_tiled_layout(512).qt == 32,
              "every N <= 512, D <= 512 must fit (see the header)");

__global__ void __launch_bounds__(tl::kThreads, 1)
attention_bwd_tiled_dq_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ g,
                              bf16* __restrict__ dq,
                              float* __restrict__ stats, int n, int d,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DqTiledLayout L = dq_tiled_layout(n, d);
  float* ss = reinterpret_cast<float*>(smem_raw);
  float* dps = reinterpret_cast<float*>(smem_raw + L.dp);
  bf16* dsh = reinterpret_cast<bf16*>(smem_raw);   // rows of 2 lds
  bf16* dsl = dsh + L.ns;
  bf16* as = reinterpret_cast<bf16*>(smem_raw + L.a);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L.ring);
  const int tile_el = L.kt * L.ldq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rtiles = (n + L.r - 1) / L.r;
  const int bi = blockIdx.x / rtiles;                  // the batch index
  const int i0 = (blockIdx.x - bi * rtiles) * L.r;   // its first row
  const size_t base = (size_t)bi * n * d;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int tiles = L.ns / L.kt;
  const int cu = L.kt / (8 * L.nt);
  const int units = (L.r / 16) * cu;
  auto issue_k = [&](int t, int buf) {
    tl::stage(ring + buf * tile_el, kb, t * L.kt, L.kt, n, d, L.ldq);
  };
  auto issue_v = [&](int t, int buf) {
    tl::stage(ring + buf * tile_el, vb, t * L.kt, L.kt, n, d, L.ldq);
  };

  // 1. logits q k^T * scale (-inf past N), then dp = g v^T, each over its
  //    stream of tiles; a warp takes 16 rows x 8 nt keys of a tile
  for (int pass = 0; pass < 2; ++pass) {
    tl::stage(as, (pass ? g : q) + base, i0, L.r, n, d, L.ldq);
    tl::stage(ring, pass ? vb : kb, 0, L.kt, n, d, L.ldq);
    cp_async_commit();
    auto body = [&](int t, int buf) {
      for (int u = warp; u < units; u += tl::kWarps) {
        const int rg = u / cu, c0 = (u - rg * cu) * 8 * L.nt;
        float x[kTlMaxNt][4];
        tl::zero(x);
        tl::mma_abt(x, as + rg * 16 * L.ldq, L.ldq,
                    ring + buf * tile_el + c0 * L.ldq, L.ldq, d, L.nt, lane);
        if (pass)
          tl::store_logits(dps, L.lds, rg * 16, t * L.kt + c0, x, L.nt,
                           L.ns, 1.f, lane);
        else
          tl::store_logits(ss, L.lds, rg * 16, t * L.kt + c0, x, L.nt, n,
                           scale, lane);
      }
    };
    if (pass)
      tl::stream_tiles(tiles, L.stages, issue_v, body);
    else
      tl::stream_tiles(tiles, L.stages, issue_k, body);
  }

  // 2. K's first tile in flight; per row (one warp a row): the exact
  //    softmax p = exp(s - m) / l in f32 (never rounded), D = rowsum(dp *
  //    p), ds = p * (dp - D) over the logits as the split pair; m, l, D to
  //    stats for the dk/dv pass
  tl::stage(ring, kb, 0, L.kt, n, d, L.ldq);
  cp_async_commit();
  for (int i = warp; i < L.r; i += tl::kWarps) {
    float x[tl::kMaxPer], y[tl::kMaxPer], m, l;
    tl::row_exp(ss + (size_t)i * L.lds, L.ns, lane, x, m, l);
    const float* dr = dps + (size_t)i * L.lds;
    float dsum = 0.f;
#pragma unroll
    for (int c = 0; c < tl::kMaxPer; ++c) {
      const int j = lane + 32 * c;
      y[c] = j < L.ns ? dr[j] : 0.f;
      x[c] /= l;
      dsum = fmaf(y[c], x[c], dsum);
    }
    dsum = warp_sum(dsum);
    __syncwarp();   // the whole row is read before ds overwrites it
    bf16* hi = dsh + (size_t)i * 2 * L.lds;
    bf16* lo = dsl + (size_t)i * 2 * L.lds;
#pragma unroll
    for (int c = 0; c < tl::kMaxPer; ++c) {
      const int j = lane + 32 * c;
      if (j < L.ns) {
        const float ds = x[c] * (y[c] - dsum);
        const bf16 h = __float2bfloat16_rn(ds);
        hi[j] = h;
        lo[j] = __float2bfloat16_rn(ds - __bfloat162float(h));
      }
    }
    if (lane == 0 && i0 + i < n) {
      float* st = stats + ((size_t)bi * n + i0 + i) * 3;
      st[0] = m;
      st[1] = l;
      st[2] = dsum;
    }
  }

  // 3. dq = ds k * scale, K streamed again; warp w keeps one 16 x 64 tile
  //    of dq in f32 registers across the tiles
  const int nct = (d + 63) / 64;
  const bool owns = warp < (L.r / 16) * nct;
  const int rb = (warp / nct) * 16, cb = (warp % nct) * 64;
  float acc[8][4];
  tl::zero(acc);
  tl::stream_tiles(tiles, L.stages, issue_k, [&](int t, int buf) {
    if (owns) {
      const size_t at = (size_t)rb * 2 * L.lds + t * L.kt;
      tl::mma_ab<true>(acc, dsh + at, dsl + at, 2 * L.lds,
                       ring + buf * tile_el + cb, L.ldq, L.kt, d - cb, lane);
    }
  });
  if (owns)
    tl::store_rows(acc, dq + base + (size_t)i0 * d, rb, cb, n - i0, d, scale,
                   lane);
}

__global__ void __launch_bounds__(tl::kThreads, 1)
attention_bwd_tiled_dkdv_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ g,
                                const float* __restrict__ stats,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int n, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const KvTiledLayout L = kv_tiled_layout(d);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + L.v);
  unsigned char* ring = smem_raw + L.ring;
  const int pe = L.kr * L.ldp;
  bf16* pth = reinterpret_cast<bf16*>(smem_raw + L.split);
  bf16* ptl = pth + pe;
  bf16* dsh = ptl + pe;
  bf16* dsl = dsh + pe;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ktiles = (n + L.kr - 1) / L.kr;
  const int bi = blockIdx.x / ktiles;                 // the batch index
  const int j0 = (blockIdx.x - bi * ktiles) * L.kr;   // its first key row
  const size_t base = (size_t)bi * n * d;
  const int tiles = (n + L.qt - 1) / L.qt;
  const int qtile_el = L.qt * L.ldq;

  // the q and g tiles of query tile t and its m, l, D (0, 1, 0 past N)
  auto issue = [&](int t, int buf) {
    unsigned char* st = ring + buf * L.stage;
    bf16* qs = reinterpret_cast<bf16*>(st);
    tl::stage(qs, q + base, t * L.qt, L.qt, n, d, L.ldq);
    tl::stage(qs + qtile_el, g + base, t * L.qt, L.qt, n, d, L.ldq);
    float* sm = reinterpret_cast<float*>(st + L.stats);
    for (int i = threadIdx.x; i < L.qt; i += tl::kThreads) {
      const int qi = t * L.qt + i;
      const bool in = qi < n;
      const float* src = stats + ((size_t)bi * n + (in ? qi : 0)) * 3;
      sm[i] = in ? src[0] : 0.f;
      sm[L.qt + i] = in ? src[1] : 1.f;
      sm[2 * L.qt + i] = in ? src[2] : 0.f;
    }
  };
  tl::stage(ks, k + base, j0, L.kr, n, d, L.ldq);
  tl::stage(vs, v + base, j0, L.kr, n, d, L.ldq);
  issue(0, 0);
  cp_async_commit();

  const int cu = L.qt / (8 * L.nt);
  const int units = (L.kr / 16) * cu;     // logit units of a query tile
  const int nct = (d + 63) / 64;
  const int per = (L.kr / 16) * nct;      // 16 x 64 tiles of dv (and dk)
  float acc[kTlSlots][8][4];              // tiles warp, warp + 16
#pragma unroll
  for (int w = 0; w < kTlSlots; ++w) tl::zero(acc[w]);
  tl::stream_tiles(tiles, L.stages, issue, [&](int t, int buf) {
    unsigned char* st = ring + buf * L.stage;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* gs = qs + qtile_el;
    const float* sm = reinterpret_cast<const float*>(st + L.stats);
    // s^T = k q^T and dp^T = v g^T of 16 keys x 8 nt queries a unit;
    // p^T = exp(s^T * scale - m) / l and ds^T = p^T (dp^T - D) with the dq
    // pass's statistics, zero past N, as split pairs into shared memory
    for (int u = warp; u < units; u += tl::kWarps) {
      const int rg = u / cu, c0 = (u - rg * cu) * 8 * L.nt;
      float s[kTlMaxNt][4], dp[kTlMaxNt][4];
      tl::zero(s);
      tl::zero(dp);
      tl::mma_abt(s, ks + rg * 16 * L.ldq, L.ldq, qs + c0 * L.ldq, L.ldq, d,
                  L.nt, lane);
      tl::mma_abt(dp, vs + rg * 16 * L.ldq, L.ldq, gs + c0 * L.ldq, L.ldq,
                  d, L.nt, lane);
      const int key = j0 + rg * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kTlMaxNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c0 + 8 * j + 2 * (lane & 3) + (e & 1);
          float p = 0.f, ds = 0.f;
          if (j < L.nt && t * L.qt + qi < n && key + 8 * (e >> 1) < n) {
            p = expf(__fmul_rn(s[j][e], scale) - sm[qi]) / sm[L.qt + qi];
            ds = p * (dp[j][e] - sm[2 * L.qt + qi]);
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }
      }
      tl::store_split(pth, ptl, L.ldp, rg * 16, c0, s, L.nt, lane);
      tl::store_split(dsh, dsl, L.ldp, rg * 16, c0, dp, L.nt, lane);
    }
    __syncthreads();
    // dv += p^T g and dk += ds^T q over the tile's queries
#pragma unroll
    for (int w = 0; w < kTlSlots; ++w) {
      const int u = warp + tl::kWarps * w;
      if (u < 2 * per) {
        const bool is_dk = u >= per;
        const int uu = is_dk ? u - per : u;
        const int at = (uu / nct) * 16 * L.ldp, cb = (uu % nct) * 64;
        tl::mma_ab<true>(acc[w], (is_dk ? dsh : pth) + at,
                         (is_dk ? dsl : ptl) + at, L.ldp,
                         (is_dk ? qs : gs) + cb, L.ldq, L.qt, d - cb, lane);
      }
    }
  });
#pragma unroll
  for (int w = 0; w < kTlSlots; ++w) {
    const int u = warp + tl::kWarps * w;
    if (u < 2 * per) {
      const bool is_dk = u >= per;
      const int uu = is_dk ? u - per : u;
      tl::store_rows(acc[w], (is_dk ? dk : dv) + base + (size_t)j0 * d,
                     (uu / nct) * 16, (uu % nct) * 64, n - j0, d,
                     is_dk ? scale : 1.f, lane);
    }
  }
}

int launch_tiled(const void* q, const void* k, const void* v, const void* g,
                 void* dq, void* dk, void* dv, float* stats, int b, int n,
                 int d, float scale, cudaStream_t stream) {
  static std::atomic<int> dq_opt[kMaxDevices], dkdv_opt[kMaxDevices];
  cudaError_t err =
      smem_opt_in(attention_bwd_tiled_dq_kernel, kMaxBlockSmem, dq_opt);
  if (err != cudaSuccess) return (int)err;
  err = smem_opt_in(attention_bwd_tiled_dkdv_kernel, kMaxBlockSmem, dkdv_opt);
  if (err != cudaSuccess) return (int)err;
  const DqTiledLayout Lq = dq_tiled_layout(n, d);
  const KvTiledLayout Lk = kv_tiled_layout(d);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  attention_bwd_tiled_dq_kernel<<<b * ((n + Lq.r - 1) / Lq.r), tl::kThreads,
                                  Lq.bytes, stream>>>(
      qt, kt, vt, gt, static_cast<bf16*>(dq), stats, n, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_tiled_dkdv_kernel<<<b * ((n + Lk.kr - 1) / Lk.kr),
                                    tl::kThreads, Lk.bytes, stream>>>(
      qt, kt, vt, gt, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: device pointers to contiguous (b, n, d) arrays of
// one dtype; stats: float32 scratch of b x n x 3 (row max, row sum, D)
// that the dq pass writes and the dk/dv pass reads (wgmma:
// wgb::scratch_floats(b, n, d), more at N > 128 with D > 256); variant:
// 0 cuda_core,
// 1 tensor_core, 2 tensor_core_tiled, 3 wgmma (the last three bf16 only,
// within the limits in the header of this file).  A variant that cannot
// take the call is an error, never a fallback.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int tmt_window_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* g,
                                        void* dq, void* dk, void* dv,
                                        void* stats, int b, int n, int d,
                                        float scale, int dtype, int variant,
                                        void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || n > kMaxN || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  if (variant == kTensorCore || variant == kTensorCoreTiled ||
      variant == kWgmma) {
    const bool takes = variant == kTensorCore ? tc_takes(n, d)
                       : variant == kWgmma    ? wgb::takes(n, d)
                                              : tiled_takes(n, d);
    if (dtype != kBFloat16 || !takes || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(g) || !aligned16(dq) || !aligned16(dk) ||
        !aligned16(dv))
      return (int)cudaErrorInvalidValue;
    if (variant == kWgmma)
      return attention_bwd_wgmma(q, k, v, g, dq, dk, dv, st, b, n, d, scale,
                                 s);
    return variant == kTensorCore
               ? launch_tensor_core(q, k, v, g, dq, dk, dv, st, b, n, d,
                                    scale, s)
               : launch_tiled(q, k, v, g, dq, dk, dv, st, b, n, d, scale, s);
  }
  if (variant != kCudaCore) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_cuda_core<float>(q, k, v, g, dq, dk, dv, st, b, n, d,
                                     scale, s);
    case kBFloat16:
      return launch_cuda_core<bf16>(q, k, v, g, dq, dk, dv, st, b, n, d,
                                    scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
