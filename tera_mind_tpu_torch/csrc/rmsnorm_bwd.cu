// K1b: RMSNorm backward.  For y = w * x * inv, inv = rsqrt(mean(x^2) + eps)
// over each row of C channels and an incoming gradient g:
//   dx = inv * (g w) - inv^3 * x * mean((g w) x)   (per row)
//   dw = sum over rows of g * x * inv               (per channel)
// all in float32, dx rounded once to x's type, dw written as float32.
//
// Replaces the backward rule of the Pallas kernel's custom_vjp,
// tera_mind_tpu/ops/rmsnorm_kernel.py _bwd (XLA maths in the JAX
// package).  Bound by memory: x and g are read, dx written, a few
// operations an element.  Two kernels, launched by one entry point:
//
// rmsnorm_bwd_kernel: one warp a row (any C, any alignment) and a
//   grid-stride loop over rows, so the grid has at most kMaxBlocks
//   blocks.  A warp recomputes the row's statistics in float32 (sum of
//   squares and sum of (g w) x, warp-shuffle reductions) and writes dx in
//   a second pass over the row (from L1).  Its share of dw, g * x * inv,
//   goes into the warp's own row of shared memory; the block then sums
//   its warps' rows in a fixed order into its row of `partial`
//   (blocks x C floats, allocated by the caller).
// rmsnorm_bwd_dw_kernel: one block per 32 channels sums `partial` over
//   the blocks, 8 row groups each taking every 8th block in order, then
//   the 8 group sums in order.
// No float atomics: the same inputs give the same dw bit for bit.

#include "common.cuh"

namespace {

constexpr int kBwdWarps = 8;                  // rows in flight a block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kMaxBlocks = 8 * 132;           // ops/rmsnorm_kernel.py
constexpr int kMaxC = kMaxBlockSmem / (4 * kBwdWarps);   // 7,264

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ w, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int c,
                   float eps) {
  extern __shared__ float sdw[];  // (kBwdWarps, c): each warp's dw sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = sdw + warp * c;
  for (int i = lane; i < c; i += 32) mine[i] = 0.f;

  const long long stride = (long long)gridDim.x * kBwdWarps;
  for (long long row = (long long)blockIdx.x * kBwdWarps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * c;
    const T* gr = g + row * c;
    float ss = 0.f, gwx = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float xv = to_f32(xr[i]);
      ss = fmaf(xv, xv, ss);
      gwx = fmaf(to_f32(gr[i]) * w[i], xv, gwx);
    }
    ss = warp_sum(ss);
    gwx = warp_sum(gwx);
    const float inv = rsqrtf(ss / (float)c + eps);
    const float inv3 = inv * inv * inv;
    const float m = gwx / (float)c;
    T* dr = dx + row * c;
    for (int i = lane; i < c; i += 32) {
      const float xv = to_f32(xr[i]);
      const float gv = to_f32(gr[i]);
      dr[i] = from_f32<T>(inv * (gv * w[i]) - inv3 * xv * m);
      mine[i] += gv * xv * inv;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kBwdWarps; ++wi) s += sdw[wi * c + i];
    partial[(long long)blockIdx.x * c + i] = s;
  }
}

constexpr int kDwGroups = 8;

__global__ void __launch_bounds__(32 * kDwGroups)
rmsnorm_bwd_dw_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int blocks, int c) {
  __shared__ float acc[kDwGroups][33];
  const int cl = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cl;
  float s = 0.f;
  if (col < c)
    for (int b = grp; b < blocks; b += kDwGroups)
      s += partial[(long long)b * c + col];
  acc[grp][cl] = s;
  __syncthreads();
  if (grp == 0 && col < c) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kDwGroups; ++r) t += acc[r][cl];
    dw[col] = t;
  }
}

template <typename T>
int launch(const void* x, const void* g, const float* w, void* dx,
           float* partial, float* dw, long long rows, int c, int blocks,
           float eps, cudaStream_t stream) {
  static std::atomic<int> opted_in[kMaxDevices];
  const cudaError_t attr = smem_opt_in(
      rmsnorm_bwd_kernel<T>, (int)(sizeof(float) * kBwdWarps * kMaxC),
      opted_in);
  if (attr != cudaSuccess) return (int)attr;
  rmsnorm_bwd_kernel<T><<<blocks, kBwdThreads,
                          sizeof(float) * kBwdWarps * c, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w,
      static_cast<T*>(dx), partial, rows, c, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_dw_kernel<<<(c + 31) / 32, 32 * kDwGroups, 0, stream>>>(
      partial, dw, blocks, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, dx: device pointers to row-major (rows, c) arrays of one dtype;
// w (c,) and dw (c,) float32; partial: float32 scratch of blocks x c;
// blocks: the row kernel's grid, 1 to kMaxBlocks (the caller sizes
// partial by it).  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int tmt_rmsnorm_bwd(const void* x, const void* g, const void* w,
                               void* dx, void* partial, void* dw,
                               long long rows, int c, int blocks, float eps,
                               int dtype, void* stream) {
  if (rows <= 0 || c <= 0 || c > kMaxC || blocks <= 0 ||
      blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto pf = static_cast<float*>(partial);
  auto dwf = static_cast<float*>(dw);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, g, wf, dx, pf, dwf, rows, c, blocks, eps, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, g, wf, dx, pf, dwf, rows, c, blocks,
                                   eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
