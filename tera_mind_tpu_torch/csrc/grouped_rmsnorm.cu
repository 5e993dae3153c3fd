// K5: the packed model's GroupedRMSNorm forward and its consumer.  For
// each row and plane z of a packed (rows, Z * Ctot) map of S concatenated
// segments (layout: csrc/grouped_rmsnorm.cuh),
//   inv_z = rsqrt(sum over plane z's Ctot channels of x^2 / Ctot + eps)
//   y = (x * inv_z) * w          (bf16: inv_z, then each product rounded)
// with the statistics in float32, x first made x + bias (rounded to x's
// type) where the caller passes a per-element bias (a ResBlock's out_norm
// reads in_conv's product without its bias, which this prologue adds),
// then the epilogue the caller names
// (grouped_rmsnorm.cuh `epilogue`): none, SiLU(y) (a ResBlock's in_norm,
// the UNet's out_norm) or SiLU(y * (1 + scale[b, c]) + shift[b, c]) (a
// ResBlock's out_norm with its adaLN scale and shift, one segment of C
// channels, b the row's batch), each op rounded where PyTorch's eager
// sequence rounds.
//
// Replaces no Pallas kernel: the JAX package's GroupedRMSNorm
// (tera_mind_tpu/models/unet_packed.py:85-108) is XLA's fusion of masked
// full-width reductions and one elementwise output on the TPU, which eager
// PyTorch runs as 8-14 launches a call (a norm, a square and adds per
// segment, the scaling per segment, a cat), and the SiLU and modulate
// after it (unet_packed.py:269-290, 518-519) one to three more passes over
// the whole map.  Bound by memory: x read once and the output written
// once (the epilogue's scale and shift are (B, C)), a few operations an
// element (the SiLU's exp and division are the most).  The design keeps x
// in registers (vector) or shared memory (staged) between the statistics
// and the output, so x leaves device memory once, and applies the
// epilogue before the store, and reads the weight once a block, in its
// own layout: a float32 master weight of a bf16 x is rounded to bf16 as
// it is read, and the 5D model's (Ctot,) weight is indexed per element
// (from_5d), so a call is one launch with no cast or gather before it.
// The conv bias before it (unet_packed.py:132-133, :226) is a prologue
// here: it saves the eager pass that reads and writes the conv's output
// to add it (PyTorch adds a cuDNN conv's bias as a broadcast add after
// the convolution).
// Variants (chosen by ops/grouped_rmsnorm_kernel.py grouped_variant):
//
// vector: the row in registers, G lanes a row (K1's rule: at most kVecMax
//   16-byte vectors a lane), every load in flight before the first use,
//   each lane's vectors' planes found once (VecPlan), the row's weight
//   vectors in shared memory once a block (the registers go to the row and
//   the epilogue), a grid-stride loop, one float sum a plane reduced by
//   __shfl_xor_sync over the group, the epilogue (a template parameter;
//   bf16 only) on each 16-byte vector, 16-byte stores.
// staged: a warp a row, the row's 16-byte words staged by cp.async in one
//   of the warp's two buffers of shared memory while it walks the row
//   before (the first row's words in flight while the block stages the
//   weight), the planes walked in turn (csrc/grouped_rmsnorm.cuh), y
//   written in place and stored back through the same words (the two
//   words a row shares with its neighbours as the widest aligned pieces
//   of its own elements).  The weight lies in shared memory by element,
//   rounded to x's type, once a block.

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

// x + b of two 16-byte vectors of T, each sum rounded once to T (bf16x2
// adds, or float adds), as PyTorch's add of two tensors of T rounds it
template <typename T>
__device__ __forceinline__ uint4 add_vec(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  uint32_t out[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 r =
          __hadd2_rn(*reinterpret_cast<const __nv_bfloat162*>(&x[t]),
                     *reinterpret_cast<const __nv_bfloat162*>(&y[t]));
      out[t] = *reinterpret_cast<const uint32_t*>(&r);
    } else {
      out[t] = __float_as_uint(
          __fadd_rn(__uint_as_float(x[t]), __uint_as_float(y[t])));
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The modulate of a 16-byte vector of bf16: y * (1 + s) + sh by bf16x2
// adds and multiplies.  Each rounds the exact result once, which is what
// PyTorch's float op then rounding to bf16 gives for bf16 operands: a
// product of two is exact in float, and so is a sum unless one term is
// below 2^-15 of the other, when both give the larger (bf16 holds 8 bits).
// The _rn forms keep the compiler from contracting the product and the
// sum into one fused multiply-add, which would round once for both.
__device__ __forceinline__ uint4 modulate_bf16_vec(const uint4& yv,
                                                   const uint4& sv,
                                                   const uint4& hv) {
  const uint32_t y[4] = {yv.x, yv.y, yv.z, yv.w},
                 s[4] = {sv.x, sv.y, sv.z, sv.w},
                 h[4] = {hv.x, hv.y, hv.z, hv.w};
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  uint32_t out[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const __nv_bfloat162 m = __hadd2_rn(
        one, *reinterpret_cast<const __nv_bfloat162*>(&s[t]));
    const __nv_bfloat162 r = __hadd2_rn(
        __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&y[t]), m),
        *reinterpret_cast<const __nv_bfloat162*>(&h[t]));
    out[t] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// A 16-byte vector of bf16 y through the epilogue ACT: with
// kActModulateSilu its scale and shift vectors sv, hv (the same channels
// of the row's batch) first, then the SiLU, each element rounded to bf16
// (the epilogues are compiled for bf16 vectors only; float32 rows with
// one take the staged variant).
template <int ACT>
__device__ __forceinline__ uint4 epilogue_vec(uint4 yv, const uint4& sv,
                                              const uint4& hv) {
  using T = __nv_bfloat16;
  if constexpr (ACT == kActModulateSilu) yv = modulate_bf16_vec(yv, sv, hv);
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = silu(vec_elem<T>(yv, j));
  return pack<T>(o);
}

template <typename T, int G, int ZMAX, bool WF32, int ACT>
__global__ void __launch_bounds__(kThreads, 4)
grouped_vec_kernel(const T* __restrict__ x, const void* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ y,
                   long long rows, Layout L, float eps, Epi epi) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kRows = kThreads / G;   // rows a block holds at a time
  const int sub = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int nvec = L.width / E;
  const VecPlan plan(L, sub, G, E);
  // the row's weight vectors in shared memory (the lanes' registers go to
  // the row and the epilogue), in x's type, once a block
  // (and the bias's, by element, where there is one)
  __shared__ uint4 wsm[32 * kVecMax];
  __shared__ uint4 bsm[32 * kVecMax];
  for (int vi = threadIdx.x; vi < nvec; vi += kThreads) {
    int z, widx;
    locate(L, vi * E, z, widx);
    wsm[vi] = weight_vec<T, WF32>(w, widx / E);
    if (bias != nullptr) bsm[vi] = reinterpret_cast<const uint4*>(bias)[vi];
  }
  int cvec[kVecMax];   // modulate (one segment): each vector's channels
#pragma unroll
  for (int i = 0; i < kVecMax; ++i)
    cvec[i] = plan.plane[i] >= 0
                  ? ((sub + i * G) * E - plan.plane[i] * L.c[0]) / E : 0;
  __syncthreads();

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
    if (bias != nullptr) {   // the prologue: x + bias, rounded to T
#pragma unroll
      for (int i = 0; i < kVecMax; ++i)
        if (plan.plane[i] >= 0) xv[i] = add_vec<T>(xv[i], bsm[sub + i * G]);
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
    const long long b = ACT == kActModulateSilu ? row / epi.rpb : 0;
    const uint4* sr = reinterpret_cast<const uint4*>(
        static_cast<const T*>(epi.scale) + b * epi.stride);
    const uint4* hr = reinterpret_cast<const uint4*>(
        static_cast<const T*>(epi.shift) + b * epi.stride);
#pragma unroll
    for (int i = 0; i < kVecMax; ++i) {
      if (plan.plane[i] < 0) continue;
      uint4 out = scale_vec<T>(xv[i], pick<ZMAX>(ss, plan.plane[i]),
                               wsm[sub + i * G]);
      if constexpr (ACT != kActNone) {
        uint4 sv = make_uint4(0, 0, 0, 0), hv = sv;
        if constexpr (ACT == kActModulateSilu) {
          sv = __ldg(sr + cvec[i]);
          hv = __ldg(hr + cvec[i]);
        }
        out = epilogue_vec<ACT>(out, sv, hv);
      }
      yr[sub + i * G] = out;
    }
  }
}

// Issue the loads of one row's words into buf (lane's words k = lane,
// lane + 32, ...): a word inside the tensor by cp.async, one that reaches
// outside it element by element (rmsnorm_words.cuh load_word) at once.
template <typename T>
__device__ __forceinline__ void stage_row(uint4* buf, const T* base,
                                          const Row<T>& r, int lane,
                                          int width, int ph,
                                          long long end) {
  constexpr int E = kWordBytes / sizeof(T);
  const uint4* words = reinterpret_cast<const uint4*>(base);
  for (int k = lane; k < r.nw; k += 32) {
    const long long kw = r.k0 + k;
    if (kw * E >= ph && kw * E + E <= end)
      cp_async16(buf + k, words + kw);
    else
      buf[k] = load_word<T>(base, kw, r.ch(k, 0), width, ph, end);
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(32 * kStagedMaxWarps, kStagedBlocks)
grouped_staged_kernel(const T* __restrict__ x, const void* __restrict__ w,
                      int w_f32, const T* __restrict__ bias,
                      T* __restrict__ y, long long rows, Layout L,
                      float eps, int ph, int whole_stores, Epi epi) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = staged_words<T>(L.width);
  extern __shared__ uint4 smem4[];
  float* wsh = reinterpret_cast<float*>(smem4);            // (width)
  uint4* bufs = smem4 + weight_floats(L.width) / 4 +
                warp * 2 * nw;                             // this warp's
  const T* xb = x - ph;    // the 16-byte boundaries below x and y
  T* yb = y - ph;
  const long long end = ph + rows * (long long)L.width;
  const long long stride = (long long)gridDim.x * warps;
  long long row = (long long)blockIdx.x * warps + warp;
  // the first row's words are in flight while the block stages the weight
  if (row < rows)
    stage_row<T>(bufs, xb, Row<T>(row, L.width, ph), lane, L.width, ph,
                 end);
  cp_async_commit();
  // the weight by element, segment by segment and plane by plane: no
  // division an element, and loads the compiler can batch
  for (int s = 0; s < L.nseg; ++s) {
    const int c = L.c[s], off = L.off[s], cum = L.cum[s];
    for (int z = 0; z < L.z; ++z) {
      for (int j = threadIdx.x; j < c; j += blockDim.x) {
        const int e = off + z * c + j;
        wsh[e] = round_to<T>(
            weight_at<T>(w, w_f32 != 0, L.from_5d ? cum + j : e));
      }
    }
  }
  __syncthreads();

  for (int slot = 0; row < rows; row += stride, slot ^= 1) {
    uint4* buf = bufs + slot * nw;
    if (row + stride < rows)   // the next row's words, into the other one
      stage_row<T>(bufs + (slot ^ 1) * nw, xb,
                   Row<T>(row + stride, L.width, ph), lane, L.width, ph,
                   end);
    cp_async_commit();
    cp_async_wait<1>();   // every group but the newest: this row's words
    __syncwarp();
    const Row<T> r(row, L.width, ph);
    T* el = reinterpret_cast<T*>(buf) + r.off;   // the row's element e
    const long long b = ACT == kActModulateSilu ? row / epi.rpb : 0;
    const T* sb = static_cast<const T*>(epi.scale) + b * epi.stride;
    const T* hb = static_cast<const T*>(epi.shift) + b * epi.stride;
    for (int z = 0; z < L.z; ++z) {
      float ss = 0.f;
      for (int s = 0; s < L.nseg; ++s) {
        const int base = L.off[s] + z * L.c[s];
        T* p = el + base;
#pragma unroll 4
        for (int j = lane; j < L.c[s]; j += 32) {
          float v = to_f32(p[j]);
          if (bias != nullptr) {   // the prologue, written back in place:
            v = round_to<T>(__fadd_rn(v, to_f32(__ldg(bias + base + j))));
            p[j] = from_f32<T>(v);   // this lane scales it below
          }
          ss = fmaf(v, v, ss);
        }
      }
      const float inv = rsqrtf(warp_sum(ss) / (float)L.ctot + eps);
      for (int s = 0; s < L.nseg; ++s) {
        const int base = L.off[s] + z * L.c[s];
#pragma unroll 4   // independent elements: their SiLUs overlap
        for (int j = lane; j < L.c[s]; j += 32) {
          float v = round_to<T>(
              scale<T>(to_f32(el[base + j]), inv, wsh[base + j]));
          if constexpr (ACT == kActModulateSilu)   // one segment: j is
            v = modulate<T>(v, to_f32(sb[j]), to_f32(hb[j]));   // the channel
          if constexpr (ACT != kActNone) v = silu(v);
          el[base + j] = from_f32<T>(v);
        }
      }
    }
    __syncwarp();
    for (int k = lane; k < r.nw; k += 32)
      store_word<T>(yb, r.k0 + k, r.ch(k, 0), L.width, whole_stores != 0,
                    buf[k]);
    __syncwarp();   // the row after next is staged into buf
  }
}

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* y;
  long long rows;
  Layout L;
  float eps;
  Epi epi;
  cudaStream_t stream;
};

template <typename T, int G, int ZMAX, bool WF32, int ACT>
int launch_vec(const Args& a) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  constexpr int kRows = kThreads / G;
  const long long blocks = std::min<long long>((a.rows + kRows - 1) / kRows,
                                               8LL * sms);
  grouped_vec_kernel<T, G, ZMAX, WF32, ACT><<<(unsigned)blocks, kThreads, 0,
                                              a.stream>>>(
      static_cast<const T*>(a.x), a.w, static_cast<const T*>(a.bias),
      static_cast<T*>(a.y), a.rows, a.L, a.eps, a.epi);
  return (int)cudaGetLastError();
}

template <typename T, int G, bool WF32, int ACT>
int launch_vec_z(const Args& a) {
  switch (plane_slots(a.L.z)) {
    case 2: return launch_vec<T, G, 2, WF32, ACT>(a);
    case 4: return launch_vec<T, G, 4, WF32, ACT>(a);
    default: return launch_vec<T, G, 8, WF32, ACT>(a);
  }
}

template <typename T, bool WF32, int ACT>
int launch_vector(const Args& a) {
  switch (vector_group(a.L.width / (16 / (int)sizeof(T)))) {
    case 1: return launch_vec_z<T, 1, WF32, ACT>(a);
    case 2: return launch_vec_z<T, 2, WF32, ACT>(a);
    case 4: return launch_vec_z<T, 4, WF32, ACT>(a);
    case 8: return launch_vec_z<T, 8, WF32, ACT>(a);
    case 16: return launch_vec_z<T, 16, WF32, ACT>(a);
    default: return launch_vec_z<T, 32, WF32, ACT>(a);
  }
}

template <typename T, int ACT>
int launch_staged(const Args& a, bool w_f32) {
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(grouped_staged_kernel<T, ACT>,
                                       kMaxBlockSmem, opted_in);
  if (attr != cudaSuccess) return (int)attr;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int warps = staged_warps<T>(a.L.width);
  const int smem = staged_smem<T>(a.L.width);
  const long long blocks = std::min<long long>(
      (a.rows + warps - 1) / warps,
      (long long)blocks_per_sm(smem, 32 * warps, kStagedRegs) * sms);
  grouped_staged_kernel<T, ACT><<<(unsigned)blocks, 32 * warps, smem,
                                  a.stream>>>(
      static_cast<const T*>(a.x), a.w, w_f32, static_cast<const T*>(a.bias),
      static_cast<T*>(a.y), a.rows, a.L, a.eps, phase<T>(a.x),
      (reinterpret_cast<uintptr_t>(a.y) - reinterpret_cast<uintptr_t>(a.x))
              % kWordBytes == 0,
      a.epi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int w_dtype, int variant) {
  const bool w_same = w_dtype == (sizeof(T) == 2 ? kBFloat16 : kFloat32);
  const bool w_f32 = sizeof(T) == 2 && w_dtype == kFloat32;
  if (!w_same && !w_f32) return (int)cudaErrorInvalidValue;
  const bool mod = a.epi.act == kActModulateSilu;
  if (mod && (a.L.nseg != 1 || a.epi.rpb <= 0 || a.epi.stride < 0 ||
              a.epi.scale == nullptr || a.epi.shift == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.bias != nullptr && a.L.nseg != 1)   // a conv's bias: one segment
    return (int)cudaErrorInvalidValue;
  if (variant == kStaged) {
    switch (a.epi.act) {
      case kActNone: return launch_staged<T, kActNone>(a, w_f32);
      case kActSilu: return launch_staged<T, kActSilu>(a, w_f32);
      default: return launch_staged<T, kActModulateSilu>(a, w_f32);
    }
  }
  bool vec = variant == kVector &&
             (long long)a.L.width * sizeof(T) <= kVecMaxBytes &&
             aligned16(a.x) && aligned16(a.w) && aligned16(a.y) &&
             aligned16(a.bias);
  for (int s = 0; s < a.L.nseg; ++s) vec = vec && a.L.c[s] % 8 == 0;
  if (mod)
    vec = vec && aligned16(a.epi.scale) && aligned16(a.epi.shift) &&
          a.epi.stride * (long long)sizeof(T) % 16 == 0;
  if (!vec) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    // a float32 weight of a bf16 x (training's, which runs no epilogue)
    // only without one: refused otherwise (the caller rounds it to bf16)
    if (w_f32) {
      if (a.epi.act != kActNone) return (int)cudaErrorInvalidValue;
      return launch_vector<T, true, kActNone>(a);
    }
    switch (a.epi.act) {
      case kActNone: return launch_vector<T, false, kActNone>(a);
      case kActSilu: return launch_vector<T, false, kActSilu>(a);
      default: return launch_vector<T, false, kActModulateSilu>(a);
    }
  } else {   // float32 epilogues take the staged variant
    if (a.epi.act != kActNone) return (int)cudaErrorInvalidValue;
    return launch_vector<T, false, kActNone>(a);
  }
}

}  // namespace

// x, y: device pointers to row-major (rows, z * (c0 + .. + c_{nseg-1}))
// arrays of dtype; w: (z * Ctot,) or, from_5d, (Ctot,) of w_dtype (dtype,
// or float32 for a bf16 x, rounded to bf16 in the kernel); nseg 1 to 3
// segments c0, c1, c2 (the unused ones 0), z 1 to 8 planes; variant: 0
// staged, 1 vector (within the limits above: a variant that cannot take
// the call is an error, never a fallback); act: 0 none, 1 SiLU, 2 the
// modulate and SiLU, which takes one segment and scale, shift: (B, c0) of
// dtype, `stride` elements from one batch to the next (the vector variant:
// both 16-byte aligned, stride a whole number of 16 bytes), batch b
// covering rows b * rows_per_batch .. (b + 1) * rows_per_batch - 1;
// bias: null, or (z * c0,) of dtype added to x before the norm (one
// segment; the vector variant: 16-byte aligned).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_grouped_rmsnorm(const void* x, const void* w,
                                   const void* bias, void* y,
                                   long long rows, int z, int nseg, int c0,
                                   int c1, int c2, float eps, int dtype,
                                   int w_dtype, int from_5d, int variant,
                                   int act, const void* scale,
                                   const void* shift, long long stride,
                                   long long rows_per_batch, void* stream) {
  const int c[kMaxSegments] = {c0, c1, c2};
  bool ok = false;
  const Layout L = make_layout(z, nseg, c, from_5d, ok);
  if (!ok || rows <= 0 || act < kActNone || act > kActModulateSilu)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, y, rows, L, eps,
               Epi{act, scale, shift, stride, rows_per_batch},
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kFloat32: return launch<float>(a, w_dtype, variant);
    case kBFloat16: return launch<__nv_bfloat16>(a, w_dtype, variant);
    default: return (int)cudaErrorInvalidValue;
  }
}
