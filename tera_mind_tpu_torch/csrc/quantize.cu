// K4: symmetric per-tensor int8 quantization of an activation, the input
// side of every int8 convolution (K3) and int8 dense product.
//
// tera_mind_tpu/ops/quant.py::quantize_tensor (:41-45) and the a_scale
// branch of quant_conv2d and quant_dense (:84-87, :120-123):
//   s = max(amax(|x|) / 127, 1e-8)       (dynamic; static: s = a_scale)
//   q = clip(round_half_even(x / s), -127, 127) as int8,
// in float32, with IEEE division (__fdiv_rn) and rintf, the rounding of
// jnp.round, so the result is the plain version's (ops/quant_kernel.py
// quantize_plain) bit for bit.  A NaN propagates as in JAX: a NaN in x
// makes the dynamic amax and s NaN, and a NaN x / s becomes q = 0, as
// XLA's float-to-int convert makes it (so a NaN input gives NaN outputs
// downstream, never quietly finite ones).  XLA fuses these passes on the TPU; in
// plain PyTorch they are a reduction and four elementwise passes.
//
// Two entry points:
// - tmt_absmax: amax(|x|) over the whole tensor.  Each block reduces its
//   grid-stride share by the maximum of the bits of |x|, which order as
//   unsigned integers with every NaN above +Inf (so a NaN wins, as it
//   does in jnp.max), a warp reduction and one atomicMax: the result does
//   not depend on the order, so it is deterministic.  The entry point
//   zeroes the word first (cudaMemsetAsync on the same stream).
// - tmt_quantize: q as rows of cols_pad bytes (cols_pad a multiple of 8,
//   the pad columns 0): the K-contiguous layout that K3 (cols_pad % 16 ==
//   0) or torch._int_mm (% 8 == 0) reads.  Variant dynamic reads the amax
//   word and writes s to scale_out (one thread); static reads a_scale.
//   Each thread writes 8 bytes of one row from 8 inputs, read as one or
//   two 16-byte loads where the row allows (cols % 8 == 0 and x 16-byte
//   aligned), else one element at a time.
//
// Bound: bytes, one read of x (2 bytes an element in bf16) and one write
// of q (1 byte), plus one more read of x for the dynamic abs-max.

#include <algorithm>

#include "common.cuh"

namespace {

enum : int { kDynamic = 0, kStatic = 1 };   // ops/quant_kernel.py

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8 * 132;

// The bits of |v|: the sign cleared, a NaN kept a NaN.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, long long n,
              unsigned int* __restrict__ amax) {
  constexpr int kVec = 16 / sizeof(T);
  unsigned m = 0u;   // the bits of max |x|
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (aligned16(x)) {
    const long long nv = n / kVec;
    for (long long i = first; i < nv; i += stride) {
      const uint4 v = reinterpret_cast<const uint4*>(x)[i];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) m = max(m, abs_bits(to_f32(e[j])));
    }
    done = nv * kVec;
  }
  for (long long i = done + first; i < n; i += stride)
    m = max(m, abs_bits(to_f32(x[i])));
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned part[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? part[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(amax, m);
  }
}

__device__ __forceinline__ uint32_t q4(const float (&f)[8], int o, float s) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float n = rintf(__fdiv_rn(f[o + j], s));
    const float v = isnan(n) ? 0.f : fminf(fmaxf(n, -127.f), 127.f);
    r |= (uint32_t)(uint8_t)(int8_t)(int)v << (8 * j);
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                const void* __restrict__ scale_src,
                float* __restrict__ scale_out, long long rows, int cols,
                int cols_pad, int variant) {
  float s;
  if (variant == kDynamic) {
    const float amax =
        __uint_as_float(*static_cast<const unsigned int*>(scale_src));
    const float d = __fdiv_rn(amax, 127.f);
    s = isnan(d) ? d : fmaxf(d, 1e-8f);   // jnp.maximum keeps a NaN
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  } else {
    s = *static_cast<const float*>(scale_src);
  }
  const bool vec = cols % 8 == 0 && aligned16(x);
  const int groups = cols_pad / 8;   // 8 output bytes a thread
  const long long total = rows * groups;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += stride) {
    const long long r = i / groups;
    const int c0 = (int)(i - r * groups) * 8;
    const T* xr = x + r * cols + c0;
    float f[8];
    if (vec && c0 < cols) {
      if constexpr (sizeof(T) == 2) {
        const uint4 v = *reinterpret_cast<const uint4*>(xr);
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = to_f32(e[j]);
      } else {
        const uint4 v0 = reinterpret_cast<const uint4*>(xr)[0];
        const uint4 v1 = reinterpret_cast<const uint4*>(xr)[1];
        const float* e0 = reinterpret_cast<const float*>(&v0);
        const float* e1 = reinterpret_cast<const float*>(&v1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[j] = e0[j];
          f[4 + j] = e1[j];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = c0 + j < cols ? to_f32(xr[j]) : 0.f;   // pad: 0 / s = 0
    }
    *reinterpret_cast<uint2*>(q + r * cols_pad + c0) =
        make_uint2(q4(f, 0, s), q4(f, 4, s));
  }
}

unsigned blocks_for(long long work) {
  return (unsigned)std::min<long long>((work + kThreads - 1) / kThreads,
                                       kMaxBlocks);
}

}  // namespace

// x: n contiguous elements (dtype 0 float32, 1 bf16); amax: one 4-byte
// word, zeroed here, then the bits of amax(|x|) as a float.
extern "C" int tmt_absmax(const void* x, long long n, int dtype, void* amax,
                          void* stream) {
  if (n <= 0 || x == nullptr || amax == nullptr)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  auto* out = static_cast<unsigned int*>(amax);
  switch (dtype) {
    case kFloat32:
      absmax_kernel<<<blocks_for(n / 4 + 1), kThreads, 0, st>>>(
          static_cast<const float*>(x), n, out);
      break;
    case kBFloat16:
      absmax_kernel<<<blocks_for(n / 8 + 1), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), n, out);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: (rows, cols) contiguous (dtype 0 float32, 1 bf16); q: (rows,
// cols_pad) int8, 8-byte aligned, cols <= cols_pad, cols_pad % 8 == 0.
// variant 0 (dynamic): scale_src is tmt_absmax's word, s goes to
// scale_out (one float); variant 1 (static): scale_src is a_scale (one
// float), scale_out is not written.
extern "C" int tmt_quantize(const void* x, void* q, const void* scale_src,
                            void* scale_out, long long rows, int cols,
                            int cols_pad, int dtype, int variant,
                            void* stream) {
  if (rows <= 0 || cols <= 0 || cols_pad < cols || cols_pad % 8 != 0 ||
      x == nullptr || q == nullptr || scale_src == nullptr ||
      (reinterpret_cast<uintptr_t>(q) & 7) != 0 ||
      (variant != kDynamic && variant != kStatic) ||
      (variant == kDynamic && scale_out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(rows * (cols_pad / 8));
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(scale_out);
  switch (dtype) {
    case kFloat32:
      quantize_kernel<<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), qo, scale_src, so, rows, cols,
          cols_pad, variant);
      break;
    case kBFloat16:
      quantize_kernel<<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), qo, scale_src, so, rows,
          cols, cols_pad, variant);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
