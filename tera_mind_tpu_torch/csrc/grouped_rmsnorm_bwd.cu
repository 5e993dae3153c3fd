// K5b: the packed model's GroupedRMSNorm backward.  For y = (x * inv_z) *
// w over each row's plane z (layout: csrc/grouped_rmsnorm.cuh) and an
// incoming gradient g, with gw = g * w:
//   m_z = mean over plane z's Ctot channels of gw * x
//   dx = inv_z * gw - inv_z^3 * x * m_z      (per element)
//   dw = sum over rows of g * x * inv_z      (per element; from_5d also
//                                             over the Z planes into Ctot)
// all in float32 from x, g and the float32 weight, each plane's statistics
// recomputed, dx rounded once to x's type, dw written as float32.
//
// Replaces no Pallas kernel: the gradient of XLA's fusion of
// tera_mind_tpu/models/unet_packed.py:85-108 (jax.grad of the module; the
// JAX package has no custom_vjp for it), which eager PyTorch's autograd
// runs as dozens of launches.  Bound by memory: x and g read once, dx
// written once.  As K1b (csrc/rmsnorm_bwd.cu) does for K1, each row is
// read once into registers (vector) or shared memory (staged), its
// planes' two sums taken from there, dx written from there, and each
// element's share of dw added to float sums that stay on the SM over all
// the rows a block visits (a grid-stride loop, the grid capped by the
// caller, ops/grouped_rmsnorm_kernel.py bwd_blocks).  vector: a lane's
// channels are the same in every row, so their weight and dw sums stay in
// registers.  staged: a block a row, the next row's x and g words on
// their way by cp.async into the other of two buffers while the block
// walks the current one; thread t owns elements t, t + T, ... of every
// row, so its weights and dw sums stay in registers too, and the planes'
// two sums are reduced over the block's warps through shared memory (two
// barriers a row).  At the end each block writes its dw by element into its row of
// `partial` (blocks x Z Ctot floats) and grouped_bwd_dw_kernel sums the
// blocks (and, from_5d, the planes) in a fixed order: no float atomics, so
// the same inputs give the same dx and dw bit for bit.  Rows of up to
// kMaxWidth (12,288) elements, above K1b's 7,264: the 16-RNA-slice
// preset's packed rows reach 8,840.

#include <algorithm>

#include "grouped_rmsnorm.cuh"

namespace {

using namespace grouped;

constexpr int kMaxBlocks = 8 * 132;   // ops/grouped_rmsnorm_kernel.py

template <typename T, int G, int ZMAX>
__global__ void __launch_bounds__(kThreads, 2)
grouped_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ partial, long long rows,
                       Layout L, float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kGroups = kThreads / G;
  extern __shared__ float sdw[];   // (kGroups, width): each group's dw
  const int sub = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int nvec = L.width / E;
  const VecPlan plan(L, sub, G, E);
  float wf[kVecMax][E], dw[kVecMax][E];
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      wf[i][e] = plan.plane[i] >= 0 ? w[plan.wvec[i] * E + e] : 0.f;
      dw[i][e] = 0.f;
    }
  }
  const long long stride = (long long)gridDim.x * kGroups;
  for (long long row0 = (long long)blockIdx.x * kGroups; row0 < rows;
       row0 += stride) {
    const long long row = row0 + grp;
    const bool live = row < rows;
    const long long at = (live ? row : 0) * L.width;
    const uint4* xr = reinterpret_cast<const uint4*>(x + at);
    const uint4* gr = reinterpret_cast<const uint4*>(g + at);
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
    float ss[ZMAX], gwx[ZMAX];
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) ss[zz] = gwx[zz] = 0.f;
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xf = vec_elem<T>(xv[i], e);
        a = fmaf(xf, xf, a);
        b = fmaf(vec_elem<T>(gv[i], e) * wf[i][e], xf, b);
      }
      add_to<ZMAX>(ss, plan.plane[i], a);
      add_to<ZMAX>(gwx, plan.plane[i], b);
    }
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        ss[zz] += __shfl_xor_sync(0xffffffffu, ss[zz], o);
        gwx[zz] += __shfl_xor_sync(0xffffffffu, gwx[zz], o);
      }
      ss[zz] = rsqrtf(ss[zz] / (float)L.ctot + eps);   // now inv
      gwx[zz] = gwx[zz] / (float)L.ctot;               // now m
    }
    if (!live) continue;
    uint4* dr = reinterpret_cast<uint4*>(dx + row * L.width);
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      if (plan.plane[i] < 0) continue;
      const float inv = pick<ZMAX>(ss, plan.plane[i]);
      const float m = pick<ZMAX>(gwx, plan.plane[i]);
      const float inv3 = inv * inv * inv;
      float out[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xf = vec_elem<T>(xv[i], e), gf = vec_elem<T>(gv[i], e);
        out[e] = inv * (gf * wf[i][e]) - inv3 * xf * m;
        dw[i][e] += gf * xf * inv;
      }
      dr[sub + i * G] = pack<T>(out);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    if (plan.plane[i] < 0) continue;
    const int e0 = (sub + i * G) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) sdw[grp * L.width + e0 + e] = dw[i][e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L.width; e += kThreads) {
    float s = 0.f;
#pragma unroll 4
    for (int r = 0; r < kGroups; ++r) s += sdw[r * L.width + e];
    partial[(long long)blockIdx.x * L.width + e] = s;
  }
}

// Issue the loads of one row's words into buf (thread t's words t, t + T,
// ...): a word inside the tensor by cp.async, one that reaches outside it
// element by element (rmsnorm_words.cuh load_word) at once.
template <typename T>
__device__ __forceinline__ void stage_row(uint4* buf, const T* base,
                                          const Row<T>& r, int width,
                                          int ph, long long end) {
  constexpr int E = kWordBytes / sizeof(T);
  const uint4* words = reinterpret_cast<const uint4*>(base);
  for (int k = threadIdx.x; k < r.nw; k += blockDim.x) {
    const long long kw = r.k0 + k;
    if (kw * E >= ph && kw * E + E <= end)
      cp_async16(buf + k, words + kw);
    else
      buf[k] = load_word<T>(base, kw, r.ch(k, 0), width, ph, end);
  }
}

template <typename T, int EPT, int ZMAX>
__global__ void __launch_bounds__(kBwdMaxThreads, EPT == 8 ? 2 : 1)
grouped_bwd_staged_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ w, T* __restrict__ dx,
                          float* __restrict__ partial, long long rows,
                          Layout L, float eps, int phx, int phg) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int nw = staged_words<T>(L.width);
  extern __shared__ uint4 smem4[];
  uint4* xbufs = smem4;                  // two slots of the row's x words
  uint4* gbufs = smem4 + 2 * nw;         // and of its g words
  float* red = reinterpret_cast<float*>(smem4 + 4 * nw);  // (warps, kMaxZ,
                                                          //  2) sums
  const T* xb = x - phx;   // the 16-byte boundaries below x and g
  const T* gb = g - phg;
  const long long xend = phx + rows * (long long)L.width;
  const long long gend = phg + rows * (long long)L.width;
  long long row = blockIdx.x;
  if (row < rows) {   // the first row's words, in flight from the start
    stage_row<T>(xbufs, xb, Row<T>(row, L.width, phx), L.width, phx, xend);
    stage_row<T>(gbufs, gb, Row<T>(row, L.width, phg), L.width, phg, gend);
  }
  cp_async_commit();
  // this thread's elements e_k = tid + k T: plane (-1 past the row),
  // weight and dw sum, the same in every row
  int plane[EPT];
  float wf[EPT], dw[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = tid + k * nthr;
    plane[k] = -1;
    wf[k] = dw[k] = 0.f;
    if (e < L.width) {
      int z, widx;
      locate(L, e, z, widx);
      plane[k] = z;
      wf[k] = w[widx];
    }
  }

  for (int slot = 0; row < rows; row += gridDim.x, slot ^= 1) {
    cp_async_wait<0>();
    __syncthreads();   // the row's words from every thread; the other
                       // slot and `red` free again
    const long long next = row + gridDim.x;
    if (next < rows) {
      stage_row<T>(xbufs + (slot ^ 1) * nw, xb, Row<T>(next, L.width, phx),
                   L.width, phx, xend);
      stage_row<T>(gbufs + (slot ^ 1) * nw, gb, Row<T>(next, L.width, phg),
                   L.width, phg, gend);
    }
    cp_async_commit();
    const T* xe = reinterpret_cast<const T*>(xbufs + slot * nw) +
                  Row<T>(row, L.width, phx).off;   // the row's element e
    const T* ge = reinterpret_cast<const T*>(gbufs + slot * nw) +
                  Row<T>(row, L.width, phg).off;
    float a[ZMAX], b[ZMAX];
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) a[zz] = b[zz] = 0.f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (plane[k] < 0) continue;
      const int e = tid + k * nthr;
      const float xf = to_f32(xe[e]);
      add_to<ZMAX>(a, plane[k], xf * xf);
      add_to<ZMAX>(b, plane[k], to_f32(ge[e]) * wf[k] * xf);
    }
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) {
      a[zz] = warp_sum(a[zz]);
      b[zz] = warp_sum(b[zz]);
    }
    if (lane == 0) {
#pragma unroll
      for (int zz = 0; zz < ZMAX; ++zz) {
        red[(warp * kMaxZ + zz) * 2] = a[zz];
        red[(warp * kMaxZ + zz) * 2 + 1] = b[zz];
      }
    }
    __syncthreads();
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) {
      float sa = 0.f, sb = 0.f;
      for (int wi = 0; wi < nwarps; ++wi) {
        const float2 p =
            *reinterpret_cast<const float2*>(red + (wi * kMaxZ + zz) * 2);
        sa += p.x;
        sb += p.y;
      }
      a[zz] = rsqrtf(sa / (float)L.ctot + eps);   // now inv
      b[zz] = sb / (float)L.ctot;                 // now m
    }
    T* dr = dx + row * L.width;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (plane[k] < 0) continue;
      const int e = tid + k * nthr;
      const float inv = pick<ZMAX>(a, plane[k]), m = pick<ZMAX>(b, plane[k]);
      const float xf = to_f32(xe[e]), gf = to_f32(ge[e]);
      dw[k] += gf * xf * inv;
      dr[e] = from_f32<T>(inv * (gf * wf[k]) - inv * inv * inv * xf * m);
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k)
    if (plane[k] >= 0)
      partial[(long long)blockIdx.x * L.width + tid + k * nthr] = dw[k];
}

constexpr int kDwGroups = 32;

// dw[k] = the sum over the blocks' rows of `partial` (and, from_5d, over
// the planes' elements of channel k): one block per 32 channels, 32 row
// groups each taking every 32nd block in order, then the 32 group sums in
// order.
__global__ void __launch_bounds__(32 * kDwGroups)
grouped_bwd_dw_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int blocks, Layout L) {
  __shared__ float acc[kDwGroups][33];
  const int cl = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + cl;
  const int n_out = L.from_5d ? L.ctot : L.width;
  float s = 0.f;
  if (k < n_out) {
    int base = k, step = 0, planes = 1;
    if (L.from_5d) {
      int sg = 0;
      while (sg + 1 < L.nseg && k >= L.cum[sg + 1]) ++sg;
      base = L.off[sg] + k - L.cum[sg];
      step = L.c[sg];
      planes = L.z;
    }
#pragma unroll 4
    for (int b = grp; b < blocks; b += kDwGroups) {
      const float* p = partial + (long long)b * L.width + base;
      for (int zz = 0; zz < planes; ++zz) s += p[zz * step];
    }
  }
  acc[grp][cl] = s;
  __syncthreads();
  if (grp == 0 && k < n_out) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < kDwGroups; ++r) tot += acc[r][cl];
    dw[k] = tot;
  }
}

struct Args {
  const void* x;
  const void* g;
  const float* w;
  void* dx;
  float* partial;
  long long rows;
  int blocks;
  Layout L;
  float eps;
  cudaStream_t stream;
};

template <typename T, int G, int ZMAX>
int launch_vec(const Args& a) {
  grouped_bwd_vec_kernel<T, G, ZMAX><<<
      a.blocks, kThreads, sizeof(float) * (kThreads / G) * a.L.width,
      a.stream>>>(static_cast<const T*>(a.x), static_cast<const T*>(a.g),
                  a.w, static_cast<T*>(a.dx), a.partial, a.rows, a.L, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_vec_z(const Args& a) {
  switch (plane_slots(a.L.z)) {
    case 2: return launch_vec<T, G, 2>(a);
    case 4: return launch_vec<T, G, 4>(a);
    default: return launch_vec<T, G, 8>(a);
  }
}

template <typename T>
int launch_vector(const Args& a) {
  switch (vector_group(a.L.width / (16 / (int)sizeof(T)))) {
    case 1: return launch_vec_z<T, 1>(a);
    case 2: return launch_vec_z<T, 2>(a);
    case 4: return launch_vec_z<T, 4>(a);
    case 8: return launch_vec_z<T, 8>(a);
    case 16: return launch_vec_z<T, 16>(a);
    default: return launch_vec_z<T, 32>(a);
  }
}

template <typename T, int EPT, int ZMAX>
int launch_staged_z(const Args& a) {
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(grouped_bwd_staged_kernel<T, EPT, ZMAX>,
                                       kMaxBlockSmem, opted_in);
  if (attr != cudaSuccess) return (int)attr;
  grouped_bwd_staged_kernel<T, EPT, ZMAX><<<
      a.blocks, bwd_threads(a.L.width), bwd_staged_smem<T>(a.L.width),
      a.stream>>>(static_cast<const T*>(a.x), static_cast<const T*>(a.g),
                  a.w, static_cast<T*>(a.dx), a.partial, a.rows, a.L, a.eps,
                  phase<T>(a.x), phase<T>(a.g));
  return (int)cudaGetLastError();
}

template <typename T, int EPT>
int launch_staged_ept(const Args& a) {
  switch (plane_slots(a.L.z)) {
    case 2: return launch_staged_z<T, EPT, 2>(a);
    case 4: return launch_staged_z<T, EPT, 4>(a);
    default: return launch_staged_z<T, EPT, 8>(a);
  }
}

template <typename T>
int launch_staged(const Args& a) {
  switch (bwd_ept(a.L.width)) {
    case 8: return launch_staged_ept<T, 8>(a);
    case 16: return launch_staged_ept<T, 16>(a);
    default: return launch_staged_ept<T, 24>(a);
  }
}

template <typename T>
int launch(const Args& a, int variant, float* dw) {
  int err;
  if (variant == kStaged) {
    err = launch_staged<T>(a);
  } else {
    bool vec = variant == kVector &&
               (long long)a.L.width * sizeof(T) <= kVecMaxBytes &&
               aligned16(a.x) && aligned16(a.g) && aligned16(a.w) &&
               aligned16(a.dx);
    for (int s = 0; s < a.L.nseg; ++s) vec = vec && a.L.c[s] % 8 == 0;
    if (!vec) return (int)cudaErrorInvalidValue;
    err = launch_vector<T>(a);
  }
  if (err != cudaSuccess) return err;
  const int n_out = a.L.from_5d ? a.L.ctot : a.L.width;
  grouped_bwd_dw_kernel<<<(n_out + 31) / 32, 32 * kDwGroups, 0, a.stream>>>(
      a.partial, dw, a.blocks, a.L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, dx: device pointers to row-major (rows, z * Ctot) arrays of one
// dtype; w float32 (z * Ctot,) or, from_5d, (Ctot,), and dw float32 of the
// same length; partial: float32 scratch of blocks x z Ctot; blocks: the
// row kernel's grid, 1 to kMaxBlocks (the caller sizes partial by it);
// nseg 1 to 3 segments c0, c1, c2 (the unused ones 0), z 1 to 8 planes;
// variant: 0 staged, 1 vector (within the limits above: a variant that
// cannot take the call is an error, never a fallback).  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int tmt_grouped_rmsnorm_bwd(const void* x, const void* g,
                                       const void* w, void* dx,
                                       void* partial, void* dw,
                                       long long rows, int z, int nseg,
                                       int c0, int c1, int c2, int blocks,
                                       float eps, int dtype, int from_5d,
                                       int variant, void* stream) {
  const int c[kMaxSegments] = {c0, c1, c2};
  bool ok = false;
  const Layout L = make_layout(z, nseg, c, from_5d, ok);
  if (!ok || rows <= 0 || blocks <= 0 || blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const Args a{x, g, static_cast<const float*>(w), dx,
               static_cast<float*>(partial), rows, blocks, L, eps,
               static_cast<cudaStream_t>(stream)};
  auto dwf = static_cast<float*>(dw);
  switch (dtype) {
    case kFloat32: return launch<float>(a, variant, dwf);
    case kBFloat16: return launch<__nv_bfloat16>(a, variant, dwf);
    default: return (int)cudaErrorInvalidValue;
  }
}
