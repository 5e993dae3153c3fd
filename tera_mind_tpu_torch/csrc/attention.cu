// K2: windowed attention forward, o = softmax(q k^T * scale) v per batch
// index, for q, k, v of shape (B, N, D) with N <= 512 and D <= 512.
//
// Replaces the Pallas kernel tera_mind_tpu/ops/attention_kernel.py
// (fused_attention / _attn_kernel), which keeps q, k, v and the N x N
// logits of one batch index in VMEM.  At N = 128, D = 256 in bf16 that is
// more than a Hopper block's 227 KB of shared memory, so here one block
// takes one batch index and a tile of kQT query rows:
//   1. the q tile goes to shared memory (float);
//   2. K is staged in chunks of kKC rows (float, rows padded by one word
//      so the threads of a warp, one key each, hit distinct banks) and the
//      block's full rows of f32 logits are kept in shared memory;
//   3. each row is max-subtracted, exponentiated and normalised, and p is
//      rounded to the input type, as the TPU kernel does before its p.v
//      product (no online rescaling: at N <= 512 the whole row fits);
//   4. V is staged in the same chunks and p.v is accumulated in float
//      registers, each thread owning one or two output columns.
// The work is 4*N*N*D operations per batch index on CUDA cores; this
// first version uses no tensor cores, so it is bound by the float FMA and
// shared-memory rate rather than by device memory (q, k, v are read from
// L2 once per query tile).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;                    // query rows per block
constexpr int kKC = 64;                    // key/value rows per chunk
constexpr int kGroups = kThreads / kKC;    // row groups in the logit pass
constexpr int kRowsPer = kQT / kGroups;    // rows per thread there
constexpr int kMaxN = 512;
constexpr int kMaxD = 512;
constexpr int kDPT = kMaxD / kThreads;     // output columns per thread

size_t smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)kQT * d + (size_t)kQT * n +
                          (size_t)kKC * (d + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n, int d,
                 float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // (kQT, d)
  float* ps = qs + kQT * d;      // (kQT, n) logits, then probabilities
  float* cs = ps + kQT * n;      // (kKC, d + 1) K or V chunk
  const int ld = d + 1;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * n * d;
  const int i0 = blockIdx.y * kQT;
  const int nq = min(kQT, n - i0);

  for (int idx = tid; idx < kQT * d; idx += kThreads) {
    const int i = idx / d;
    qs[idx] = i < nq ? to_f32(q[base + (long long)i0 * d + idx]) : 0.f;
  }

  // logits: thread (jl, ig) computes key jl of the chunk against rows
  // ig, ig + kGroups, ...; a warp shares ig, so q reads are broadcasts
  const int jl = tid % kKC;
  const int ig = tid / kKC;
  for (int j0 = 0; j0 < n; j0 += kKC) {
    const int nk = min(kKC, n - j0);
    __syncthreads();
    for (int idx = tid; idx < nk * d; idx += kThreads) {
      const int j = idx / d;
      cs[j * ld + (idx - j * d)] = to_f32(k[base + (long long)j0 * d + idx]);
    }
    __syncthreads();
    if (jl < nk) {
      float acc[kRowsPer];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) acc[r] = 0.f;
      const float* kr = cs + jl * ld;
      for (int e = 0; e < d; ++e) {
        const float kv = kr[e];
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r)
          acc[r] = fmaf(qs[(ig + r * kGroups) * d + e], kv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r)
        ps[(ig + r * kGroups) * n + j0 + jl] = acc[r] * scale;
    }
  }
  __syncthreads();

  // softmax over each full row, one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < nq; i += kThreads / 32) {
    float* pr = ps + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float ev = expf(pr[j] - m);
      pr[j] = ev;
      s += ev;
    }
    s = warp_sum(s);
    for (int j = lane; j < n; j += 32) pr[j] = round_to<T>(pr[j] / s);
  }

  // p.v with float accumulation in registers
  float acc[kQT][kDPT];
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int c = 0; c < kDPT; ++c) acc[i][c] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kKC) {
    const int nk = min(kKC, n - j0);
    __syncthreads();
    for (int idx = tid; idx < nk * d; idx += kThreads) {
      const int j = idx / d;
      cs[j * ld + (idx - j * d)] = to_f32(v[base + (long long)j0 * d + idx]);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* vr = cs + j * ld;
      float vv[kDPT];
#pragma unroll
      for (int c = 0; c < kDPT; ++c) {
        const int e = tid + c * kThreads;
        vv[c] = e < d ? vr[e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const float p = i < nq ? ps[i * n + j0 + j] : 0.f;
#pragma unroll
        for (int c = 0; c < kDPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
    if (i >= nq) break;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) {
      const int e = tid + c * kThreads;
      if (e < d) o[base + (long long)(i0 + i) * d + e] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int n, int d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, (n + kQT - 1) / kQT);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers to contiguous (b, n, d) arrays of one dtype.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_window_attention(const void* q, const void* k,
                                    const void* v, void* o, int b, int n,
                                    int d, float scale, int dtype,
                                    void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || n > kMaxN || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(q, k, v, o, b, n, d, scale, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, o, b, n, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
