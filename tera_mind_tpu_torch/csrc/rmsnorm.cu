// K1: RMSNorm forward, y = x * rsqrt(mean(x^2, -1) + eps) * w.
//
// Replaces the Pallas kernel tera_mind_tpu/ops/rmsnorm_kernel.py
// (rmsnorm_fused / _kernel).  Bound by memory: each row is read once from
// device memory and written once; the arithmetic is a few operations per
// element.  One warp owns one row: a strided pass accumulates the sum of
// squares in float (warp-shuffle reduction), a second pass re-reads the
// row (from L1, a row is at most a few KB) and writes the product.  Any
// row count and any channel count work: the last block masks its missing
// rows, and the strided loops cover a C that is not a multiple of 32.
//
// Rounding follows the TPU kernel: for bf16, inv and w are cast to bf16
// and y = bf16(bf16(x * bf16(inv)) * bf16(w)); for float, y = w * (x * inv).

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row

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

  for (int i = lane; i < c; i += 32) {
    const float v = to_f32(xr[i]);
    const float wv = to_f32(w[i]);
    if constexpr (sizeof(T) == 2) {
      yr[i] = from_f32<T>(round_to<T>(v * round_to<T>(inv)) * wv);
    } else {
      yr[i] = from_f32<T>(wv * (v * inv));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int c,
           float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<(unsigned)blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), rows, c, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, w, y: device pointers, x/y row-major (rows, c), w (c,), all of one
// dtype.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_rmsnorm(const void* x, const void* w, void* y,
                           long long rows, int c, float eps, int dtype,
                           void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(x, w, y, rows, c, eps, s);
    case kBFloat16: return launch<__nv_bfloat16>(x, w, y, rows, c, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
