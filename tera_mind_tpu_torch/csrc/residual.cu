// K6: the packed ResBlock's residual sum with its convs' biases.  For a
// packed (rows, W) map,
//   out = r(r(h + b_h) + s),   s = r(c + b_c)  or  s = x
// where h is out_conv's product without its bias, b_h that bias (W,), and
// s the skip path: skip_conv's bias-free product c with its bias b_c
// (skip "conv"), or the block's input x (skip "x", after _up2 / _down2
// where the block resamples); r rounds to the tensors' type (bf16 or
// float32).  That is the eager sequence bit for bit: PyTorch adds a cuDNN
// conv's bias as a broadcast add after the convolution, then the block
// returns (x + h).to(dt), each add rounding once in float.
//
// Replaces no Pallas kernel: on the TPU XLA fuses the conv bias adds
// (tera_mind_tpu/models/unet_packed.py:132-133, :226) and the residual
// sum (:299) into the convolutions' output fusion.  Eager PyTorch runs
// them as up to four passes over the map (two or three broadcast bias
// adds, then the sum), each reading and writing it.  Bound by memory: h
// and s read once, out written once, the biases (W,) once; a few adds an
// element.  The design reads each 16-byte vector once: the flat vector
// index walks the map with a grid stride that is a whole number of rows,
// so each thread's column, and with it its bias vectors, stays the same
// from row to row and is read once into registers; each thread keeps
// kUnroll rows' loads in flight before the first sum.  One launch, no
// atomics, no shared memory.
//
// Variants (chosen by ops/residual_kernel.py residual_variant):
// vector: W * sizeof(T) a multiple of 16 and every tensor 16-byte aligned:
//   16-byte loads and stores (bf16x2 adds, __hadd2_rn, or float adds).
// scalar: any other width or alignment: the same walk an element a time.

#include <algorithm>

#include "common.cuh"

namespace {

enum : int { kScalar = 0, kVector = 1 };   // ops/residual_kernel.py VARIANTS
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;   // __launch_bounds__: 64 registers a thread
constexpr int kUnroll = 4;        // rows' loads in flight a thread

// a + b of two 16-byte vectors of T, each sum rounded once to T
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

// a + b of two elements of T, rounded once to T
template <typename T> __device__ __forceinline__ T add_el(T a, T b) {
  return from_f32<T>(__fadd_rn(to_f32(a), to_f32(b)));
}

// U is uint4 (vector: 16-byte vectors of T) or T (scalar: elements); n
// units in all, w units a row, stride a whole number of rows
template <typename T, typename U, bool SKIP_BIAS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
residual_kernel(const U* __restrict__ h, const U* __restrict__ bh,
                const U* __restrict__ s, const U* __restrict__ bs,
                U* __restrict__ out, long long n, int w, long long stride) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= stride) return;   // past the last whole row of threads
  const int col = (int)(t % w);
  const U b_h = bh[col];
  U b_s{};
  if constexpr (SKIP_BIAS) b_s = bs[col];
  for (long long i0 = t; i0 < n; i0 += kUnroll * stride) {
    U hv[kUnroll], sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < n) {
        hv[u] = h[i];
        sv[u] = s[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i >= n) continue;
      if constexpr (sizeof(U) == 16) {
        U sk = sv[u];
        if constexpr (SKIP_BIAS) sk = add_vec<T>(sk, b_s);
        out[i] = add_vec<T>(sk, add_vec<T>(hv[u], b_h));
      } else {
        U sk = sv[u];
        if constexpr (SKIP_BIAS) sk = add_el<T>(sk, b_s);
        out[i] = add_el<T>(sk, add_el<T>(hv[u], b_h));
      }
    }
  }
}

template <typename T, typename U, bool SKIP_BIAS>
int launch(const void* h, const void* bh, const void* s, const void* bs,
           void* out, long long rows, int w, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const long long n = rows * w;
  const long long blocks = std::min<long long>(
      (n + kThreads - 1) / kThreads, (long long)kBlocksPerSm * sms);
  const long long stride = blocks * kThreads / w * w;
  if (stride == 0) return (int)cudaErrorInvalidValue;   // a row too wide
  residual_kernel<T, U, SKIP_BIAS><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      static_cast<const U*>(h), static_cast<const U*>(bh),
      static_cast<const U*>(s), static_cast<const U*>(bs),
      static_cast<U*>(out), n, w, stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* h, const void* bh, const void* s, const void* bs,
             void* out, long long rows, int width, int variant,
             cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  if (variant == kVector) {
    if (width % E != 0 || !aligned16(h) || !aligned16(bh) || !aligned16(s) ||
        !aligned16(bs) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    return bs != nullptr
               ? launch<T, uint4, true>(h, bh, s, bs, out, rows, width / E,
                                        stream)
               : launch<T, uint4, false>(h, bh, s, bs, out, rows, width / E,
                                         stream);
  }
  if (variant != kScalar) return (int)cudaErrorInvalidValue;
  return bs != nullptr
             ? launch<T, T, true>(h, bh, s, bs, out, rows, width, stream)
             : launch<T, T, false>(h, bh, s, bs, out, rows, width, stream);
}

}  // namespace

// h, s, out: device pointers to row-major (rows, width) arrays of dtype;
// bh: (width,) of dtype; bs: (width,) of dtype, or null where s is the
// block's input (no skip conv); variant: 0 scalar, 1 vector (width * the
// element size a multiple of 16 bytes and every pointer 16-byte aligned:
// a variant that cannot take the call is an error, never a fallback).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_residual(const void* h, const void* bh, const void* s,
                            const void* bs, void* out, long long rows,
                            int width, int dtype, int variant,
                            void* stream) {
  if (rows <= 0 || width <= 0 || h == nullptr || bh == nullptr ||
      s == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_t<float>(h, bh, s, bs, out, rows, width, variant, st);
    case kBFloat16:
      return launch_t<__nv_bfloat16>(h, bh, s, bs, out, rows, width, variant,
                                     st);
    default: return (int)cudaErrorInvalidValue;
  }
}
