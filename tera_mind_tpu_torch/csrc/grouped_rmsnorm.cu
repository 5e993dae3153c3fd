// K5: the packed model's GroupedRMSNorm forward.  For each row and plane
// z of a packed (rows, Z * Ctot) map of S concatenated segments (layout:
// csrc/grouped_rmsnorm.cuh),
//   inv_z = rsqrt(sum over plane z's Ctot channels of x^2 / Ctot + eps)
//   y = (x * inv_z) * w          (bf16: inv_z, then each product rounded)
// with the statistics in float32.
//
// Replaces no Pallas kernel: the JAX package's GroupedRMSNorm
// (tera_mind_tpu/models/unet_packed.py:85-108) is XLA's fusion of masked
// full-width reductions and one elementwise output on the TPU, which eager
// PyTorch runs as 8-14 launches a call (a norm, a square and adds per
// segment, the scaling per segment, a cat).  Bound by memory: x read once
// and y written once, a few operations an element.  The design keeps x in
// registers (vector) or shared memory (staged) between the statistics and
// the output, so x leaves device memory once, and reads the weight once a
// block, in its own layout: a float32 master weight of a bf16 x is rounded
// to bf16 as it is read, and the 5D model's (Ctot,) weight is indexed per
// element (from_5d), so a call is one launch with no cast or gather before
// it.  Variants (chosen by ops/grouped_rmsnorm_kernel.py grouped_variant):
//
// vector: the row in registers, G lanes a row (K1's rule: at most kVecMax
//   16-byte vectors a lane), every load in flight before the first use,
//   each lane's vectors' planes and weight vectors found once (VecPlan) and
//   the weight held in registers over a grid-stride loop, one float sum a
//   plane reduced by __shfl_xor_sync over the group, 16-byte stores.
// staged: a warp a row, the row's 16-byte words staged in the warp's
//   buffer of shared memory, the planes walked in turn
//   (csrc/grouped_rmsnorm.cuh), y written in place and stored back through
//   the same words (the two words a row shares with its neighbours as the
//   widest aligned pieces of its own elements).  The weight lies in shared
//   memory by element, rounded to x's type, once a block.

#include <algorithm>

#include "grouped_rmsnorm.cuh"

namespace {

using namespace grouped;

// w's 16-byte vector vi in x's type: for WF32 (a float32 weight of a bf16
// x) its two float vectors, each element rounded to bf16
template <typename T, bool WF32>
__device__ __forceinline__ uint4 weight_vec(const void* w, int vi) {
  if constexpr (WF32) {
    const float4* wf = static_cast<const float4*>(w) + 2 * vi;
    const float4 a = wf[0], b = wf[1];
    return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                      pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
  } else {
    return static_cast<const uint4*>(w)[vi];
  }
}

template <typename T, int G, int ZMAX, bool WF32>
__global__ void __launch_bounds__(kThreads, 4)
grouped_vec_kernel(const T* __restrict__ x, const void* __restrict__ w,
                   T* __restrict__ y, long long rows, Layout L, float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kRows = kThreads / G;   // rows a block holds at a time
  const int sub = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int nvec = L.width / E;
  const VecPlan plan(L, sub, G, E);
  uint4 wv[kVecMax];
#pragma unroll
  for (int i = 0; i < kVecMax; ++i)
    wv[i] = plan.plane[i] >= 0 ? weight_vec<T, WF32>(w, plan.wvec[i])
                               : make_uint4(0, 0, 0, 0);

  // the loop's bound is the same in every lane of the block (dead rows
  // still join the shuffles)
  const long long stride = (long long)gridDim.x * kRows;
  for (long long row0 = (long long)blockIdx.x * kRows; row0 < rows;
       row0 += stride) {
    const long long row = row0 + grp;
    const bool live = row < rows;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + (live ? row : 0) * L.width);
    uint4 xv[kVecMax];
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      const int vi = sub + i * G;
      xv[i] = live && vi < nvec ? xr[vi] : make_uint4(0, 0, 0, 0);
    }
    float ss[ZMAX];
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) ss[zz] = 0.f;
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = vec_elem<T>(xv[i], j);
        s = fmaf(f, f, s);
      }
      add_to<ZMAX>(ss, plan.plane[i], s);
    }
#pragma unroll
    for (int zz = 0; zz < ZMAX; ++zz) {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        ss[zz] += __shfl_xor_sync(0xffffffffu, ss[zz], o);
      ss[zz] = rsqrtf(ss[zz] / (float)L.ctot + eps);   // now inv
    }
    if (!live) continue;
    uint4* yr = reinterpret_cast<uint4*>(y + row * L.width);
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      if (plan.plane[i] >= 0)
        yr[sub + i * G] =
            scale_vec<T>(xv[i], pick<ZMAX>(ss, plan.plane[i]), wv[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kStagedMaxWarps)
grouped_staged_kernel(const T* __restrict__ x, const void* __restrict__ w,
                      int w_f32, T* __restrict__ y, long long rows, Layout L,
                      float eps, int ph, int whole_stores) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ uint4 smem4[];
  float* wsh = reinterpret_cast<float*>(smem4);            // (width)
  uint4* buf = smem4 + weight_floats(L.width) / 4 +
               warp * staged_words<T>(L.width);            // this warp's
  const T* xb = x - ph;    // the 16-byte boundaries below x and y
  T* yb = y - ph;
  const long long end = ph + rows * (long long)L.width;
  for (int e = threadIdx.x; e < L.width; e += blockDim.x) {
    int z, widx;
    locate(L, e, z, widx);
    wsh[e] = round_to<T>(weight_at<T>(w, w_f32 != 0, widx));
  }
  __syncthreads();

  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += (long long)gridDim.x * warps) {
    const Row<T> r(row, L.width, ph);
    for (int k = lane; k < r.nw; k += 32)
      buf[k] = load_word<T>(xb, r.k0 + k, r.ch(k, 0), L.width, ph, end);
    __syncwarp();
    T* el = reinterpret_cast<T*>(buf) + r.off;   // the row's element e
    for (int z = 0; z < L.z; ++z) {
      float ss = 0.f;
      for (int s = 0; s < L.nseg; ++s) {
        const T* p = el + L.off[s] + z * L.c[s];
        for (int j = lane; j < L.c[s]; j += 32) {
          const float v = to_f32(p[j]);
          ss = fmaf(v, v, ss);
        }
      }
      const float inv = rsqrtf(warp_sum(ss) / (float)L.ctot + eps);
      for (int s = 0; s < L.nseg; ++s) {
        const int base = L.off[s] + z * L.c[s];
        for (int j = lane; j < L.c[s]; j += 32)
          el[base + j] = from_f32<T>(
              scale<T>(to_f32(el[base + j]), inv, wsh[base + j]));
      }
    }
    __syncwarp();
    for (int k = lane; k < r.nw; k += 32)
      store_word<T>(yb, r.k0 + k, r.ch(k, 0), L.width, whole_stores != 0,
                    buf[k]);
    __syncwarp();   // the next row's words overwrite buf
  }
}

struct Args {
  const void* x;
  const void* w;
  void* y;
  long long rows;
  Layout L;
  float eps;
  cudaStream_t stream;
};

template <typename T, int G, int ZMAX, bool WF32>
int launch_vec(const Args& a) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  constexpr int kRows = kThreads / G;
  const long long blocks = std::min<long long>((a.rows + kRows - 1) / kRows,
                                               8LL * sms);
  grouped_vec_kernel<T, G, ZMAX, WF32><<<(unsigned)blocks, kThreads, 0,
                                         a.stream>>>(
      static_cast<const T*>(a.x), a.w, static_cast<T*>(a.y), a.rows, a.L,
      a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int G, bool WF32>
int launch_vec_z(const Args& a) {
  switch (plane_slots(a.L.z)) {
    case 2: return launch_vec<T, G, 2, WF32>(a);
    case 4: return launch_vec<T, G, 4, WF32>(a);
    default: return launch_vec<T, G, 8, WF32>(a);
  }
}

template <typename T, bool WF32>
int launch_vector(const Args& a) {
  switch (vector_group(a.L.width / (16 / (int)sizeof(T)))) {
    case 1: return launch_vec_z<T, 1, WF32>(a);
    case 2: return launch_vec_z<T, 2, WF32>(a);
    case 4: return launch_vec_z<T, 4, WF32>(a);
    case 8: return launch_vec_z<T, 8, WF32>(a);
    case 16: return launch_vec_z<T, 16, WF32>(a);
    default: return launch_vec_z<T, 32, WF32>(a);
  }
}

template <typename T>
int launch_staged(const Args& a, bool w_f32) {
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(grouped_staged_kernel<T>,
                                       kMaxBlockSmem, opted_in);
  if (attr != cudaSuccess) return (int)attr;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int warps = staged_warps<T>(a.L.width, false);
  const long long blocks = std::min<long long>(
      (a.rows + warps - 1) / warps,
      (long long)staged_blocks_per_sm<T>(a.L.width, false) * sms);
  grouped_staged_kernel<T><<<(unsigned)blocks, 32 * warps,
                             staged_smem<T>(a.L.width, false), a.stream>>>(
      static_cast<const T*>(a.x), a.w, w_f32, static_cast<T*>(a.y), a.rows,
      a.L, a.eps, phase<T>(a.x),
      (reinterpret_cast<uintptr_t>(a.y) - reinterpret_cast<uintptr_t>(a.x))
              % kWordBytes == 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int w_dtype, int variant) {
  const bool w_same = w_dtype == (sizeof(T) == 2 ? kBFloat16 : kFloat32);
  const bool w_f32 = sizeof(T) == 2 && w_dtype == kFloat32;
  if (!w_same && !w_f32) return (int)cudaErrorInvalidValue;
  if (variant == kStaged) return launch_staged<T>(a, w_f32);
  bool vec = variant == kVector &&
             (long long)a.L.width * sizeof(T) <= kVecMaxBytes &&
             aligned16(a.x) && aligned16(a.w) && aligned16(a.y);
  for (int s = 0; s < a.L.nseg; ++s) vec = vec && a.L.c[s] % 8 == 0;
  if (!vec) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (w_f32) return launch_vector<T, true>(a);
  }
  return launch_vector<T, false>(a);
}

}  // namespace

// x, y: device pointers to row-major (rows, z * (c0 + .. + c_{nseg-1}))
// arrays of dtype; w: (z * Ctot,) or, from_5d, (Ctot,) of w_dtype (dtype,
// or float32 for a bf16 x, rounded to bf16 in the kernel); nseg 1 to 3
// segments c0, c1, c2 (the unused ones 0), z 1 to 8 planes; variant: 0
// staged, 1 vector (within the limits above: a variant that cannot take
// the call is an error, never a fallback).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int tmt_grouped_rmsnorm(const void* x, const void* w, void* y,
                                   long long rows, int z, int nseg, int c0,
                                   int c1, int c2, float eps, int dtype,
                                   int w_dtype, int from_5d, int variant,
                                   void* stream) {
  const int c[kMaxSegments] = {c0, c1, c2};
  bool ok = false;
  const Layout L = make_layout(z, nseg, c, from_5d, ok);
  if (!ok || rows <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, w, y, rows, L, eps, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kFloat32: return launch<float>(a, w_dtype, variant);
    case kBFloat16: return launch<__nv_bfloat16>(a, w_dtype, variant);
    default: return (int)cudaErrorInvalidValue;
  }
}
