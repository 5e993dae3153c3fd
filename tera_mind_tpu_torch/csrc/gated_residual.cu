// K7: the DiT block's gated residual.  For a (rows, C) token map,
//   out = r(x + r(g * y))
// where x is the block's residual stream (contiguous), g the per-token
// gate (a (rows, C) view of T whose rows lie gstride elements apart: a
// chunk of the adaLN dense's (B, N, 7C) output, 7C a row), y the output
// of the block's attention or MLP (contiguous), and r rounds to the
// tensors' type (bf16 or float32).  That is the eager `xt + gate * y` bit
// for bit: PyTorch's product and sum each compute in float and round once
// to T; the _rn forms keep nvcc from contracting them into one fused
// multiply-add.
//
// Replaces no Pallas kernel: on the TPU XLA fuses
// tera_mind_tpu/models/attention.py:196-202 (`xt + gate * attn(...)`,
// `xt + gate * mlp(...)`) into the output fusion of the dense before it.
// Eager PyTorch runs it as two passes over the map (the product, then the
// sum), each reading two maps and writing one.  Bound by memory: x, g and
// y read once, out written once; two operations an element.  The walk is
// K6's (csrc/residual.cu): the flat index over the (rows, C / E) units
// (E elements a 16-byte vector, or 1) steps by a grid stride of whole
// rows, so each thread keeps one column and its row advances by the rows
// a stride covers, which finds g's unit at row * gstride + col without a
// division in the loop; each thread keeps kUnroll rows' loads in flight
// before the first product.  One launch, no atomics, no shared memory; a
// new tensor out (the packed UNet still reads the block's input as a
// skip).
//
// Variants (chosen by ops/gated_residual_kernel.py gated_variant):
// vector: C * sizeof(T) and gstride * sizeof(T) multiples of 16 and every
//   pointer 16-byte aligned: 16-byte loads and stores (bf16x2 products and
//   sums, __hmul2_rn / __hadd2_rn, or float ones).
// scalar: any other width, stride or alignment: the same walk an element
//   a time.

#include <algorithm>

#include "common.cuh"

namespace {

enum : int { kScalar = 0, kVector = 1 };   // ops/gated_residual_kernel.py
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;   // __launch_bounds__: 64 registers a thread
constexpr int kUnroll = 4;        // rows' loads in flight a thread

// x + g * y of 16-byte vectors of T, the product and the sum each rounded
// once to T
template <typename T>
__device__ __forceinline__ uint4 gated_vec(const uint4& xv, const uint4& gv,
                                           const uint4& yv) {
  const uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w},
                 g[4] = {gv.x, gv.y, gv.z, gv.w},
                 y[4] = {yv.x, yv.y, yv.z, yv.w};
  uint32_t out[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 r = __hadd2_rn(
          *reinterpret_cast<const __nv_bfloat162*>(&x[t]),
          __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&g[t]),
                     *reinterpret_cast<const __nv_bfloat162*>(&y[t])));
      out[t] = *reinterpret_cast<const uint32_t*>(&r);
    } else {
      out[t] = __float_as_uint(__fadd_rn(
          __uint_as_float(x[t]),
          __fmul_rn(__uint_as_float(g[t]), __uint_as_float(y[t]))));
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// x + g * y of elements of T, the product and the sum each rounded once
template <typename T>
__device__ __forceinline__ T gated_el(T x, T g, T y) {
  return from_f32<T>(
      __fadd_rn(to_f32(x), round_to<T>(__fmul_rn(to_f32(g), to_f32(y)))));
}

// U is uint4 (vector: 16-byte vectors of T) or T (scalar: elements); w
// units a row, gstride units from one row of g to the next, rstride rows
// a grid stride (each thread one column)
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gated_residual_kernel(const U* __restrict__ x, const U* __restrict__ g,
                      const U* __restrict__ y, U* __restrict__ out,
                      long long rows, int w, long long gstride,
                      long long rstride) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rstride * w) return;   // past the last whole row of threads
  const int col = (int)(t % w);
  for (long long r0 = t / w; r0 < rows; r0 += kUnroll * rstride) {
    U xv[kUnroll], gv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * rstride;
      if (r < rows) {
        xv[u] = x[r * w + col];
        gv[u] = g[r * gstride + col];
        yv[u] = y[r * w + col];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * rstride;
      if (r >= rows) continue;
      if constexpr (sizeof(U) == 16)
        out[r * w + col] = gated_vec<T>(xv[u], gv[u], yv[u]);
      else
        out[r * w + col] = gated_el<T>(xv[u], gv[u], yv[u]);
    }
  }
}

template <typename T, typename U>
int launch(const void* x, const void* g, const void* y, void* out,
           long long rows, int w, long long gstride, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const long long n = rows * w;
  const long long blocks = std::min<long long>(
      (n + kThreads - 1) / kThreads, (long long)kBlocksPerSm * sms);
  const long long rstride = blocks * kThreads / w;
  if (rstride == 0) return (int)cudaErrorInvalidValue;   // a row too wide
  gated_residual_kernel<T, U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<const U*>(g),
      static_cast<const U*>(y), static_cast<U*>(out), rows, w, gstride,
      rstride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* g, const void* y, void* out,
             long long rows, int c, long long gstride, int variant,
             cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  if (variant == kVector) {
    if (c % E != 0 || gstride % E != 0 || !aligned16(x) || !aligned16(g) ||
        !aligned16(y) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    return launch<T, uint4>(x, g, y, out, rows, c / E, gstride / E, stream);
  }
  if (variant != kScalar) return (int)cudaErrorInvalidValue;
  return launch<T, T>(x, g, y, out, rows, c, gstride, stream);
}

}  // namespace

// x, y, out: device pointers to row-major (rows, c) arrays of dtype; g:
// (rows, c) of dtype whose rows lie gstride (>= c) elements apart;
// variant: 0 scalar, 1 vector (c and gstride whole 16-byte vectors and
// every pointer 16-byte aligned: a variant that cannot take the call is
// an error, never a fallback).  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int tmt_gated_residual(const void* x, const void* g,
                                  const void* y, void* out, long long rows,
                                  int c, long long gstride, int dtype,
                                  int variant, void* stream) {
  if (rows <= 0 || c <= 0 || gstride < c || x == nullptr || g == nullptr ||
      y == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_t<float>(x, g, y, out, rows, c, gstride, variant, st);
    case kBFloat16:
      return launch_t<__nv_bfloat16>(x, g, y, out, rows, c, gstride, variant,
                                     st);
    default: return (int)cudaErrorInvalidValue;
  }
}
