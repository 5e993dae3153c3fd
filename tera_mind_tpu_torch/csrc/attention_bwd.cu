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
// so bound by memory on paper; this first version computes on CUDA cores
// in float32 and is bound by its shared-memory traffic instead.
//
// The N x N probabilities of one batch index (1 MB at N = 512) do not
// fit in shared memory beside q, k, v and g, so two passes each
// recompute their tile of p from q, k and per-row statistics:
//
// attention_bwd_dq_kernel, one block per batch index and kQT query rows:
//   q and g rows in shared memory (float); K, then V, staged in chunks
//   of kKC rows; the rows' logits and dp = g v^T kept whole in shared
//   memory; the softmax (row max m, sum l) and D = rowsum(dp * p) per
//   row, one warp a row; ds overwrites dp; dq = ds k * scale accumulated
//   in registers over K staged once more.  It writes m, l and D of its
//   rows to `stats` (B x N x 3 floats, allocated by the caller).
// attention_bwd_dkdv_kernel, one block per batch index and kKT key rows:
//   k and v rows in shared memory; for every chunk of kQC query rows
//   (q and g staged), p and ds of the tile recomputed from the chunk's
//   m, l and D, then dv += p^T g and dk += ds^T q accumulated in
//   registers.  Logits and dp are summed in the same order as in the dq
//   pass, so p and ds equal that pass's bit for bit.
// Each dk and dv row is summed over all query rows inside one block, in
// order, and no float atomics are used: the result is deterministic.

#include <math.h>

#include "common.cuh"

namespace {

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
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, float* stats, int b, int n, int d,
           float scale, cudaStream_t stream) {
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

}  // namespace

// q, k, v, g, dq, dk, dv: device pointers to contiguous (b, n, d) arrays of
// one dtype; stats: float32 scratch of b x n x 3 (row max, row sum, D)
// that the dq pass writes and the dk/dv pass reads.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int tmt_window_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* g,
                                        void* dq, void* dk, void* dv,
                                        void* stats, int b, int n, int d,
                                        float scale, int dtype,
                                        void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || n > kMaxN || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, v, g, dq, dk, dv, st, b, n, d, scale, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, b, n, d,
                                   scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
