// Shared helpers for the port's kernels: element conversion between the
// storage type (float or bf16) and the float arithmetic type, warp
// reductions, and the Hopper data-movement and tensor-core instructions
// (16-byte cp.async, ldmatrix, mma.sync m16n8k16 bf16) in inline PTX.
#pragma once

#include <stdint.h>

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (ops/_build.py DTYPES)
enum : int { kFloat32 = 0, kBFloat16 = 1 };

// shared memory one block may use on an H100 (227 KB)
constexpr int kMaxBlockSmem = 232448;

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once per device,
// at the kernel's first launch on it (so before any CUDA graph capture
// there), and keep the result: later launches make no other runtime call
// than cudaGetDevice.  `state[dev]` is 0 until set, then the error + 1.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes,
                        std::atomic<int> (&state)[kMaxDevices]) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int s = state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    s = 1 + (int)cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    state[dev].store(s, std::memory_order_release);
  }
  return (cudaError_t)(s - 1);
}

// The SMs of the current device (read once per device), or 0 on an error.
inline int sm_count() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  int n = cache[dev].load(std::memory_order_acquire);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cache[dev].store(n, std::memory_order_release);
  }
  return n;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T and back: the value a multiply in T would produce
// (the product of two bf16 values is exact in float, so one rounding of
// the float product equals the correctly rounded bf16 product).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The adaLN modulate, y * (1 + s) + sh, of K5's epilogue
// (csrc/grouped_rmsnorm.cu) and K1's (csrc/rmsnorm.cu): y a value of T,
// each of 1 + s, the product and the sum rounded to T as PyTorch's
// elementwise ops round them (in float, then to T).  The _rn forms keep
// nvcc from contracting the product and the sum into one fused
// multiply-add, which would round once for both.
template <typename T>
__device__ __forceinline__ float modulate(float y, float s, float sh) {
  const float m = round_to<T>(__fadd_rn(1.0f, s));
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(y, m)), sh));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory that bypasses L1; the data
// arrives after cp_async_wait<n>() once at most n later groups are open.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Without .trans lane t gets (row t/4, cols
// 2(t%4), 2(t%4)+1) of each matrix, with .trans (rows 2(t%4), 2(t%4)+1,
// col t/4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices; lanes 0-15 give the row addresses (lane l: row
// l % 8 of matrix l / 8), the other lanes' addresses are not read.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column-major fragment) and a 16x8 float accumulator.  With g = lane/4
// and c = lane%4: a = {A[g][2c..], A[g+8][2c..], A[g][2c+8..],
// A[g+8][2c+8..]}, b = {B[2c..][g], B[2c+8..][g]}, d = {D[g][2c],
// D[g][2c+1], D[g+8][2c], D[g+8][2c+1]}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed low-first, as a 32-bit store
// writes them to consecutive addresses.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats a, b as bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi_a,
// b - hi_b), each packed as pack_bf16x2 packs: hi + lo carries 16
// significant bits of each float where hi alone carries 8 (the
// subtraction is exact).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

// 16 zero bytes at p (16-byte aligned shared or device memory)
__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
}

// 32-bit word i of a 16-byte vector
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes of T from 16 / sizeof(T) floats, each rounded to T
template <typename T> __device__ __forceinline__ uint4
pack(const float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  } else {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
}
