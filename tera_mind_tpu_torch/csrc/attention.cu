// K2: windowed attention forward, o = softmax(q k^T * scale) v per batch
// index, for q, k, v of shape (B, N, D) with N <= 512 and D <= 512.
//
// Replaces the Pallas kernel tera_mind_tpu/ops/attention_kernel.py
// (fused_attention / _attn_kernel), which keeps q, k, v and the N x N
// logits of one batch index in VMEM.  Every variant keeps the TPU's
// rounding: f32 logits q.k^T * scale, an exact softmax (row max, exp,
// divide by the row sum), p rounded to the input type after it is
// normalised, f32 accumulation of p.v and one rounding of the output.
//
// Four variants, chosen by the caller from dtype, shape and alignment
// before the launch (ops/attention_kernel.py attention_variant):
//
// wgmma (bf16; csrc/attention_wgmma.cu): Hopper's warpgroup products fed
//   by TMA, a producer warp and two consumer warpgroups, persistent
//   blocks; the main path's and every preset's shapes (wg::takes: D % 16
//   == 0, D <= 256 or D = 512, N <= 512, D <= 128 over 256 keys).  The
//   three below stay, reachable by a forced variant, and take the calls
//   wgmma does not (the edge N = D = 512 takes tensor_core_tiled).
//
// tensor_core (bf16; D % 16 == 0, N <= 128, 16-byte aligned pointers,
//   3 * round16(N) * (D + 8) * 2 bytes of shared memory, plus
//   round16(N) * (round16(N) + 8) * 2 when round16(N) > D, within 227 KB).
//   At N = 128 the work is N / 2 = 64 operations per byte, far under the
//   H100's 295 for bf16, so it is bound by the bytes it moves.  One block
//   of 8 warps takes one batch index, so K and V leave device memory once:
//   1. q and k, then v, are copied into shared memory as bf16 with 16-byte
//      cp.async (two groups, so v arrives while q.k^T runs); rows are
//      padded by 16 bytes so that ldmatrix hits 8 distinct bank groups;
//   2. each warp takes 16 query rows and computes their logits with
//      mma.sync m16n8k16 (bf16 in, f32 out), keeping all N of them in
//      registers (N / 2 floats a thread); the softmax runs on those
//      registers with quad shuffles, and p = bf16(exp(s - m) / sum)
//      overwrites q in shared memory (or goes after v when it does not
//      fit there);
//   3. the N x D output is cut into 32 x 64 tiles that the 8 warps share,
//      so no warp holds more than 64 f32 accumulators: p.v by mma.sync
//      with V read through ldmatrix.trans, rounded once to bf16, staged in
//      k's buffer and written out as 16-byte stores.
//   At (324, 128, 256) a block holds 198 KB (one block an SM, 2.5 waves
//   over 132 SMs); at (324, 32, 512) 97.5 KB (two blocks an SM).
//
// tensor_core_tiled (bf16; D % 16 == 0, N <= 512, D <= 512, 16-byte
//   aligned pointers: every such call that tensor_core refuses because
//   N > 128 or its shared memory would pass 227 KB, such as (B, 128, 512)
//   at patch 128, (B, 512, 128) at 16 RNA slices, (B, 256, 256) at 8).  At
//   (512, 512, 128) the work is 128 operations a byte, under the 295 of
//   the H100's bf16 peak: bound by bytes on paper, by the tensor cores'
//   mma.sync rate in practice.  A block of 16 warps takes one batch index
//   and r query rows (64 for D <= 256, 32 above: at most one 16-row tile
//   of the output a warp); K and V are streamed through a ring of kt-row
//   tiles (csrc/attention_tiled.cuh), so neither has to fit whole:
//   1. the q tile (bf16) and K tile by tile by 16-byte cp.async, the next
//      tile in flight while one is used (two stages where they fit); each
//      warp takes 16 rows x 8 nt keys of a tile on mma.sync m16n8k16 and
//      writes s = (q.k^T) * scale to the block's r x N f32 logits in
//      shared memory (-inf past N), so q.k^T runs once;
//   2. the exact softmax, one warp a row, over the whole row: the max of
//      all N logits, the sum of exp(s - m), p = exp(s - m) / l rounded
//      once to bf16 and written over the row's logits in place (no
//      online rescaling, which would round an unnormalised p);
//   3. V tile by tile: warp w keeps one 16 x 64 tile of o in f32
//      registers across the tiles, p.v by mma.sync with V through
//      ldmatrix.trans; one rounding of o, stored from the registers.
//   Shared memory (tiled_layout): r x (round(N, kt) + 4) floats of logits,
//   r x (D + 8) bf16 of q and `stages` x kt x (D + 8) bf16 of K or V, the
//   largest kt of 128, 64, 32 that fits twice, else once: 219,136 bytes at
//   (512, 128) (kt 128), 199,680 at (512, 256) (kt 32), 232,448 at (512,
//   512) (r 32, kt 64), one block an SM.
//
// cuda_core (float32, and bf16 with D % 16 != 0 or misaligned pointers):
//   one block takes one batch index and a tile of kQT query rows;
//   the q tile goes to shared memory (float), K and V are staged in
//   chunks of kKC rows (float, rows padded by one word), the block's full
//   rows of f32 logits stay in shared memory for the softmax, and p.v is
//   accumulated in float registers.  At N = D = 512 it needs 192 KB.

#include <math.h>

#include "attention_tiled.cuh"
#include "attention_wgmma.cuh"

namespace {

enum : int { kCudaCore = 0, kTensorCore = 1, kTensorCoreTiled = 2,
             kWgmma = 3 };
// (ops/attention_kernel.py VARIANTS)

constexpr int kMaxN = 512;
constexpr int kMaxD = 512;

// ---------------------------------------------------------------------------
// cuda_core variant
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kQT = 16;                    // query rows per block
constexpr int kKC = 64;                    // key/value rows per chunk
constexpr int kGroups = kThreads / kKC;    // row groups in the logit pass
constexpr int kRowsPer = kQT / kGroups;    // rows per thread there
constexpr int kDPT = kMaxD / kThreads;     // output columns per thread

constexpr size_t smem_bytes(int n, int d) {
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
int launch_cuda_core(const void* q, const void* k, const void* v, void* o,
                     int b, int n, int d, float scale, cudaStream_t stream) {
  // the shared-memory limit is raised once per instantiation and device,
  // for the largest shape
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(
      attention_kernel<T>, (int)smem_bytes(kMaxN, kMaxD), opted_in);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b, (n + kQT - 1) / kQT);
  attention_kernel<T><<<grid, kThreads, smem_bytes(n, d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, d, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor_core variant (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxN = 128;          // a warp's 16 x N logits: N/2 floats
constexpr int kTcMaxKT = kTcMaxN / 8; //   a thread, in kTcMaxKT 8-key tiles
constexpr int kPad = 8;               // bf16 row padding (16 bytes)

// Shared-memory layout, in bf16 elements: q, k, v tiles of np rows of
// ld = d + kPad, and p (np rows of ldp = np + kPad) over q when it fits
// there, else after v.
struct TcLayout {
  int np, ld, ldp;
  size_t k, v, p, bytes;
};

__host__ __device__ constexpr TcLayout tc_layout(int n, int d) {
  const int np = (n + 15) & ~15;
  const size_t tile = (size_t)np * (d + kPad);
  const size_t pe = (size_t)np * (np + kPad);
  const bool p_in_q = pe <= tile;
  return TcLayout{np, d + kPad, np + kPad, tile, 2 * tile,
                  p_in_q ? 0 : 3 * tile,
                  2 * (3 * tile + (p_in_q ? 0 : pe))};
}

constexpr bool tc_takes(int n, int d) {
  return n <= kTcMaxN && d % 16 == 0 && d <= kMaxD &&
         tc_layout(n, d).bytes <= (size_t)kMaxBlockSmem;
}

static_assert(tc_takes(128, 256) && tc_takes(32, 512) &&
                  tc_layout(128, 256).bytes == 202752,
              "main-path shapes must take the tensor-core variant");

__global__ void __launch_bounds__(kTcThreads, 2)
attention_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int n,
                    int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcLayout L = tc_layout(n, d);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + L.k;
  bf16* vs = qs + L.v;
  bf16* ps = qs + L.p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;  // fragment row, column pair
  const size_t base = (size_t)blockIdx.x * n * d;
  const int vpr = d / 8;                   // 16-byte vectors a row

  // 1. q and k (group 0), then v (group 1); rows n..np-1 are zero
  for (int idx = tid; idx < L.np * vpr; idx += kTcThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    if (r < n) {
      cp_async16(qs + r * L.ld + c, q + base + (size_t)r * d + c);
      cp_async16(ks + r * L.ld + c, k + base + (size_t)r * d + c);
    } else {
      zero16(qs + r * L.ld + c);
      zero16(ks + r * L.ld + c);
    }
  }
  cp_async_commit();
  for (int idx = tid; idx < L.np * vpr; idx += kTcThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    if (r < n)
      cp_async16(vs + r * L.ld + c, v + base + (size_t)r * d + c);
    else
      zero16(vs + r * L.ld + c);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 2. logits of rows r0..r0+15 against every key, in registers:
  //    s[j] is the 16 x 8 tile of keys 8j..8j+7
  const int r0 = 16 * warp;
  const bool has_rows = r0 < L.np;
  float s[kTcMaxKT][4];
#pragma unroll
  for (int j = 0; j < kTcMaxKT; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if (has_rows) {
    const bf16* qa = qs + (r0 + (lane & 15)) * L.ld + (lane >> 4) * 8;
    const bf16* kb = ks + ((lane & 7) + ((lane >> 4) << 3)) * L.ld +
                     ((lane >> 3) & 1) * 8;
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + k0);
#pragma unroll
      for (int j = 0; j < kTcMaxKT / 2; ++j) {
        if (16 * j < L.np) {
          uint32_t b[4];
          ldmatrix_x4(b, kb + 16 * j * L.ld + k0);
          mma_bf16_16816(s[2 * j], a, b[0], b[1]);
          mma_bf16_16816(s[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
    // exact softmax of rows g (elements 0, 1) and g + 8 (2, 3); a row's
    // keys are spread over the 4 lanes of a quad
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTcMaxKT; ++j) {
      if (8 * j < L.np) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * c4 + (e & 1);
          s[j][e] = key < n ? s[j][e] * scale : -INFINITY;
        }
        m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
        m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
    }
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kTcMaxKT; ++j) {
      if (8 * j < L.np) {
        s[j][0] = expf(s[j][0] - m_lo);
        s[j][1] = expf(s[j][1] - m_lo);
        s[j][2] = expf(s[j][2] - m_hi);
        s[j][3] = expf(s[j][3] - m_hi);
        l_lo += s[j][0] + s[j][1];
        l_hi += s[j][2] + s[j][3];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
#pragma unroll
    for (int j = 0; j < kTcMaxKT; ++j) {
      s[j][0] /= l_lo;
      s[j][1] /= l_lo;
      s[j][2] /= l_hi;
      s[j][3] /= l_hi;
    }
  }
  __syncthreads();  // every warp is done with q before p overwrites it
  if (has_rows) {
    uint32_t* lo = reinterpret_cast<uint32_t*>(ps + (r0 + g) * L.ldp +
                                               2 * c4);
    uint32_t* hi = reinterpret_cast<uint32_t*>(ps + (r0 + g + 8) * L.ldp +
                                               2 * c4);
#pragma unroll
    for (int j = 0; j < kTcMaxKT; ++j) {
      if (8 * j < L.np) {
        lo[4 * j] = pack_bf16x2(s[j][0], s[j][1]);
        hi[4 * j] = pack_bf16x2(s[j][2], s[j][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. o = p v in 32 x 64 tiles (two 16-row halves x eight 8-column
  //    tiles), staged as bf16 in k's buffer
  const int n_ct = (d + 63) / 64;
  const int n_tiles = ((L.np + 31) / 32) * n_ct;
  for (int t = warp; t < n_tiles; t += kTcWarps) {
    const int rb = (t / n_ct) * 32, cb = (t % n_ct) * 64;
    const bool two = rb + 16 < L.np;
    float acc[2][8][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
    const bf16* pa = ps + (rb + (lane & 15)) * L.ldp + (lane >> 4) * 8;
    const bf16* vb = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.ld + cb +
                     (lane >> 4) * 8;
    for (int k0 = 0; k0 < L.np; k0 += 16) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, pa + k0);
      if (two) ldmatrix_x4(a1, pa + 16 * L.ldp + k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cb + 16 * j < d) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + k0 * L.ld + 16 * j);
          mma_bf16_16816(acc[0][2 * j], a0, b[0], b[1]);
          mma_bf16_16816(acc[0][2 * j + 1], a0, b[2], b[3]);
          if (two) {
            mma_bf16_16816(acc[1][2 * j], a1, b[0], b[1]);
            mma_bf16_16816(acc[1][2 * j + 1], a1, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
      const int row = rb + 16 * h + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cb + 8 * j + 2 * c4;
        if (cb + 8 * j < d) {
          *reinterpret_cast<uint32_t*>(ks + row * L.ld + c) =
              pack_bf16x2(acc[h][j][0], acc[h][j][1]);
          *reinterpret_cast<uint32_t*>(ks + (row + 8) * L.ld + c) =
              pack_bf16x2(acc[h][j][2], acc[h][j][3]);
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * vpr; idx += kTcThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    *reinterpret_cast<uint4*>(o + base + (size_t)r * d + c) =
        *reinterpret_cast<const uint4*>(ks + r * L.ld + c);
  }
}

int launch_tensor_core(const void* q, const void* k, const void* v, void* o,
                       int b, int n, int d, float scale,
                       cudaStream_t stream) {
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr =
      smem_opt_in(attention_kernel_tc, kMaxBlockSmem, opted_in);
  if (attr != cudaSuccess) return (int)attr;
  attention_kernel_tc<<<b, kTcThreads, tc_layout(n, d).bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), n, d, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor_core_tiled variant (bf16)
// ---------------------------------------------------------------------------

constexpr int kTlMaxNt = 4;   // 8-key mma tiles of a warp's logit unit

// Shared-memory layout, byte offsets: the f32 logits of the block's r
// query rows (ns = N rounded up to kt columns, rows of lds = ns + 4
// floats; p overwrites them in place as bf16, rows of 2 lds), the q tile
// (r rows of ldq = D + 8 bf16) at q, and `stages` K or V tiles of kt
// rows of ldq from ring on.  nt: the 8-key mma tiles of a warp's unit of
// 16 query rows in the logit pass (16 units a K tile).
struct TiledLayout {
  int r, kt, stages, ns, lds, ldq, nt;
  size_t q, ring, tile, bytes;
};

__host__ __device__ constexpr TiledLayout tiled_make(int n, int d, int r,
                                                     int kt, int stages) {
  const int ns = (n + kt - 1) / kt * kt;
  const int lds = ns + tl::kSPad, ldq = d + tl::kPad;
  const size_t q = (size_t)4 * r * lds;
  const size_t ring = q + (size_t)2 * r * ldq;
  const size_t tile = (size_t)2 * kt * ldq;
  const int nt0 = (r / 16) * (kt / 8) / tl::kWarps;
  const int nt = nt0 < 1 ? 1 : nt0 > kTlMaxNt ? kTlMaxNt : nt0;
  return TiledLayout{r, kt, stages, ns, lds, ldq, nt,
                     q, ring, tile, ring + stages * tile};
}

// r = 64 query rows a block for D <= 256, 32 above (the p.v pass's 16 x 64
// output tiles, r / 16 x ceil(D / 64) of them, one a warp); the largest
// K / V tile that fits twice, else once.
__host__ __device__ constexpr TiledLayout tiled_layout(int n, int d) {
  const int r = d <= 256 ? 64 : 32;
  for (int stages = 2; stages >= 1; --stages)
    for (int kt = 128; kt >= 32; kt /= 2) {
      const TiledLayout L = tiled_make(n, d, r, kt, stages);
      if (L.bytes <= (size_t)kMaxBlockSmem) return L;
    }
  return tiled_make(n, d, r, 32, 1);
}

constexpr bool tiled_takes(int n, int d) {
  return n >= 1 && n <= kMaxN && d >= 16 && d % 16 == 0 && d <= kMaxD &&
         tiled_layout(n, d).bytes <= (size_t)kMaxBlockSmem;
}

static_assert(tiled_takes(512, 128) && tiled_takes(128, 512) &&
                  tiled_takes(256, 256) && tiled_takes(512, 512) &&
                  tiled_layout(512, 128).bytes == 219136 &&
                  tiled_layout(512, 512).bytes == 232448 &&
                  tiled_layout(512, 256).kt == 32,
              "every N <= 512, D <= 512 must fit (see the header)");

__global__ void __launch_bounds__(tl::kThreads, 1)
attention_kernel_tiled(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int n, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledLayout L = tiled_layout(n, d);
  float* ss = reinterpret_cast<float*>(smem_raw);
  bf16* ps = reinterpret_cast<bf16*>(smem_raw);   // rows of 2 lds
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + L.q);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L.ring);
  const int tile_el = L.kt * L.ldq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rtiles = (n + L.r - 1) / L.r;
  const int bi = blockIdx.x / rtiles;                // the batch index
  const int i0 = (blockIdx.x - bi * rtiles) * L.r;   // its first query row
  const size_t base = (size_t)bi * n * d;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int tiles = L.ns / L.kt;

  // 1. logits q k^T * scale of the r rows, K streamed tile by tile; a
  //    warp takes 16 rows x 8 nt keys of a tile
  tl::stage(qs, q + base, i0, L.r, n, d, L.ldq);
  tl::stage(ring, kb, 0, L.kt, n, d, L.ldq);
  cp_async_commit();
  const int cu = L.kt / (8 * L.nt);
  const int units = (L.r / 16) * cu;
  tl::stream_tiles(
      tiles, L.stages,
      [&](int t, int buf) {
        tl::stage(ring + buf * tile_el, kb, t * L.kt, L.kt, n, d, L.ldq);
      },
      [&](int t, int buf) {
        for (int u = warp; u < units; u += tl::kWarps) {
          const int rg = u / cu, c0 = (u - rg * cu) * 8 * L.nt;
          float s[kTlMaxNt][4];
          tl::zero(s);
          tl::mma_abt(s, qs + rg * 16 * L.ldq, L.ldq,
                      ring + buf * tile_el + c0 * L.ldq, L.ldq, d, L.nt,
                      lane);
          tl::store_logits(ss, L.lds, rg * 16, t * L.kt + c0, s, L.nt, n,
                           scale, lane);
        }
      });

  // 2. V's first tile in flight; the exact softmax of each row (one warp
  //    a row): max over all N keys, sum of exp(s - m), p = exp(s - m) / l
  //    rounded once to bf16, written over the row's logits
  tl::stage(ring, vb, 0, L.kt, n, d, L.ldq);
  cp_async_commit();
  for (int i = warp; i < L.r; i += tl::kWarps) {
    float x[tl::kMaxPer], m, l;
    tl::row_exp(ss + (size_t)i * L.lds, L.ns, lane, x, m, l);
    __syncwarp();   // the whole row is read before bf16 p overwrites it
    bf16* pr = ps + (size_t)i * 2 * L.lds;
#pragma unroll
    for (int c = 0; c < tl::kMaxPer; ++c) {
      const int j = lane + 32 * c;
      if (j < L.ns) pr[j] = __float2bfloat16_rn(x[c] / l);
    }
  }

  // 3. o = p v, V streamed tile by tile; warp w keeps one 16 x 64 output
  //    tile in f32 registers across the tiles (at D = 128 half the warps:
  //    narrower tiles, one a warp, were slower, as each reloads p)
  const int nct = (d + 63) / 64;
  const bool owns = warp < (L.r / 16) * nct;
  const int rb = (warp / nct) * 16, cb = (warp % nct) * 64;
  float acc[8][4];
  tl::zero(acc);
  tl::stream_tiles(
      tiles, L.stages,
      [&](int t, int buf) {
        tl::stage(ring + buf * tile_el, vb, t * L.kt, L.kt, n, d, L.ldq);
      },
      [&](int t, int buf) {
        if (owns)
          tl::mma_ab<false>(acc, ps + (size_t)rb * 2 * L.lds + t * L.kt,
                            nullptr, 2 * L.lds, ring + buf * tile_el + cb,
                            L.ldq, L.kt, d - cb, lane);
      });
  if (owns)
    tl::store_rows(acc, o + base + (size_t)i0 * d, rb, cb, n - i0, d, 1.f,
                   lane);
}

int launch_tiled(const void* q, const void* k, const void* v, void* o, int b,
                 int n, int d, float scale, cudaStream_t stream) {
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr =
      smem_opt_in(attention_kernel_tiled, kMaxBlockSmem, opted_in);
  if (attr != cudaSuccess) return (int)attr;
  const TiledLayout L = tiled_layout(n, d);
  attention_kernel_tiled<<<b * ((n + L.r - 1) / L.r), tl::kThreads, L.bytes,
                           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), n, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers to contiguous (b, n, d) arrays of one dtype;
// variant: 0 cuda_core, 1 tensor_core, 2 tensor_core_tiled, 3 wgmma (the
// last three bf16 only, within the limits in the header of this file).  A variant that cannot take the call is an
// error, never a fallback.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int tmt_window_attention(const void* q, const void* k,
                                    const void* v, void* o, int b, int n,
                                    int d, float scale, int dtype,
                                    int variant, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || n > kMaxN || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != kBFloat16 || !wg::takes(n, d) || !aligned16(q) ||
        !aligned16(k) || !aligned16(v) || !aligned16(o))
      return (int)cudaErrorInvalidValue;
    return attention_wgmma(q, k, v, o, b, n, d, scale, s);
  }
  if (variant == kTensorCore || variant == kTensorCoreTiled) {
    const bool takes = variant == kTensorCore ? tc_takes(n, d)
                                              : tiled_takes(n, d);
    if (dtype != kBFloat16 || !takes || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(o))
      return (int)cudaErrorInvalidValue;
    return variant == kTensorCore
               ? launch_tensor_core(q, k, v, o, b, n, d, scale, s)
               : launch_tiled(q, k, v, o, b, n, d, scale, s);
  }
  if (variant != kCudaCore) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_cuda_core<float>(q, k, v, o, b, n, d, scale, s);
    case kBFloat16:
      return launch_cuda_core<bf16>(q, k, v, o, b, n, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
