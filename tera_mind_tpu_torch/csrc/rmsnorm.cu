// K1: RMSNorm forward, y = x * rsqrt(mean(x^2, -1) + eps) * w.
//
// Replaces the Pallas kernel tera_mind_tpu/ops/rmsnorm_kernel.py
// (rmsnorm_fused / _kernel).  Bound by memory: each row is read once from
// device memory and written once; the arithmetic is a few operations per
// element.  Two variants, chosen by the caller from C, dtype and pointer
// alignment before the launch (ops/rmsnorm_kernel.py rmsnorm_variant):
//
// vector (C % 8 == 0, C * sizeof(T) <= 2048, x, w, y 16-byte aligned):
//   a row belongs to a group of G lanes, G the smallest power of two that
//   leaves each lane at most kVecMax 16-byte vectors (C = 96 in bf16: 4
//   lanes x 3 vectors, 8 rows a warp; C = 64: 2 lanes x 4).  A lane loads
//   its vectors of x and of w once, into registers, with every load in
//   flight before the first use; the sum of squares is reduced with
//   __shfl_xor_sync inside the group, and y is written from the same
//   registers as 16-byte stores, so x leaves device memory once.
// strided (any C, any alignment): one warp a row, a strided pass for the
//   sum of squares (warp-shuffle reduction) and a second that re-reads
//   the row (from L1) and writes the product.
//
// Any row count works: the last block masks its missing rows.  Rounding
// follows the TPU kernel: for bf16, inv and w are cast to bf16 and
// y = bf16(bf16(x * bf16(inv)) * bf16(w)); for float, y = w * (x * inv).

#include "common.cuh"

namespace {

enum : int { kStrided = 0, kVector = 1 };  // ops/rmsnorm_kernel.py

constexpr int kRowsPerBlock = 8;  // strided: one warp per row

template <typename T>
__device__ __forceinline__ float apply(float v, float inv, float wv) {
  if constexpr (sizeof(T) == 2) {
    return round_to<T>(v * round_to<T>(inv)) * wv;
  } else {
    return wv * (v * inv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, long long rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * c;
  T* yr = y + row * c;

  float ss = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)c + eps);

  for (int i = lane; i < c; i += 32)
    yr[i] = from_f32<T>(apply<T>(to_f32(xr[i]), inv, to_f32(w[i])));
}

constexpr int kVecThreads = 256;
constexpr int kVecMax = 4;        // 16-byte vectors a lane holds
constexpr int kVecMaxBytes = 32 * kVecMax * 16;   // one row, at most

// element j of a 16-byte vector of T, as float (bf16 is the high half of
// a float, element 2i the low half of word i)
template <typename T> __device__ __forceinline__ float elem(const uint4& v,
                                                            int j) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w = word(v, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(word(v, j));
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kVecThreads)
rmsnorm_kernel_vec(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, long long rows, int c, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int nvec = c / E;
  const int sub = threadIdx.x % G;   // lane within the row's group
  const long long row =
      (long long)blockIdx.x * (kVecThreads / G) + threadIdx.x / G;
  const bool live = row < rows;      // dead lanes still join the shuffles
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * c);
  const uint4* wr = reinterpret_cast<const uint4*>(w);

  uint4 xv[kVecMax], wv[kVecMax];
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    const int vi = sub + i * G;
    xv[i] = wv[i] = make_uint4(0, 0, 0, 0);
    if (live && vi < nvec) {
      xv[i] = xr[vi];
      wv[i] = wr[vi];
    }
  }
  float ss = 0.f;   // zero vectors add nothing
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float v = elem<T>(xv[i], j);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)c + eps);
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(y + row * c);
#pragma unroll
  for (int i = 0; i < kVecMax; ++i) {
    const int vi = sub + i * G;
    if (vi < nvec) {
      float out[E];
#pragma unroll
      for (int j = 0; j < E; ++j)
        out[j] = apply<T>(elem<T>(xv[i], j), inv, elem<T>(wv[i], j));
      yr[vi] = pack<T>(out);
    }
  }
}

template <typename T>
int launch_strided(const void* x, const void* w, void* y, long long rows,
                   int c, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<(unsigned)blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), rows, c, eps);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_vec_g(const void* x, const void* w, void* y, long long rows,
                 int c, float eps, cudaStream_t stream) {
  constexpr int rows_per_block = kVecThreads / G;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel_vec<T, G><<<(unsigned)blocks, kVecThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), rows, c, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vector(const void* x, const void* w, void* y, long long rows,
                  int c, float eps, cudaStream_t stream) {
  const int nvec = c / (16 / (int)sizeof(T));
  int g = 1;
  while (g < 32 && g * kVecMax < nvec) g *= 2;
  switch (g) {
    case 1: return launch_vec_g<T, 1>(x, w, y, rows, c, eps, stream);
    case 2: return launch_vec_g<T, 2>(x, w, y, rows, c, eps, stream);
    case 4: return launch_vec_g<T, 4>(x, w, y, rows, c, eps, stream);
    case 8: return launch_vec_g<T, 8>(x, w, y, rows, c, eps, stream);
    case 16: return launch_vec_g<T, 16>(x, w, y, rows, c, eps, stream);
    default: return launch_vec_g<T, 32>(x, w, y, rows, c, eps, stream);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int c,
           float eps, int variant, cudaStream_t stream) {
  if (variant == kStrided)
    return launch_strided<T>(x, w, y, rows, c, eps, stream);
  if (variant != kVector || c % 8 != 0 ||
      (long long)c * sizeof(T) > kVecMaxBytes || !aligned16(x) ||
      !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  return launch_vector<T>(x, w, y, rows, c, eps, stream);
}

}  // namespace

// x, w, y: device pointers, x/y row-major (rows, c), w (c,), all of one
// dtype; variant: 0 strided, 1 vector (within the limits above: a variant
// that cannot take the call is an error, never a fallback).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_rmsnorm(const void* x, const void* w, void* y,
                           long long rows, int c, float eps, int dtype,
                           int variant, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(x, w, y, rows, c, eps, variant, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, y, rows, c, eps, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
