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
// downstream, never quietly finite ones).  XLA fuses these passes on the
// TPU; in plain PyTorch they are a reduction and four elementwise passes.
//
// Bound: bytes, one read of x (2 bytes an element in bf16) and one write
// of q (1 byte).  The design:
// - Dynamic is one cooperative launch of co-resident blocks (at most
//   kBlocksPerSM an SM): pass 1 reduces |x| by the maximum of its bits,
//   which order as unsigned integers with every NaN above +Inf (so a NaN
//   wins, as it does in jnp.max; bf16 two at a time), 4 16-byte loads in
//   flight a thread;
//   each block writes its maximum to its own word of `partials` (no word
//   to zero, no memset, no atomics: the result does not depend on the
//   order); a grid barrier (cooperative_groups); every block then reduces
//   the partials itself and pass 2 quantizes.  Pass 2 walks the tensor
//   backwards, so it starts on the bytes pass 1 read last, still in the
//   50 MB L2; a tensor that fits there is read from device memory once.
// - Static is pass 2 alone, an ordinary launch.
// - Pass 2 maps a thread to a row segment: 16 output bytes where cols_pad
//   % 16 == 0 (K3's rows, one 16-byte store), else 8 (torch._int_mm's
//   rows, one 8-byte store).  A row that starts off a 16-byte boundary (C
//   = 229, 970, 1,482, 1,994 in bf16) is still read in 16-byte loads,
//   realigned by funnel shifts; only a row's last, partial segment goes
//   element by element.  Two segments' loads are in flight a thread.
//
// Entry point tmt_quantize: q as rows of cols_pad bytes (cols_pad a
// multiple of 8, the pad columns 0).  Dynamic writes s to scale_out and
// the bits of amax(|x|) to amax_out (both one word); static reads
// a_scale.

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum : int { kDynamic = 0, kStatic = 1 };   // ops/quant_kernel.py

constexpr int kThreads = 512;
constexpr int kBlocksPerSM = 2;   // ops/quant_kernel.py K4_BLOCKS_PER_SM
constexpr int kStaticBlocksPerSM = 4;
constexpr int kUnroll = 4;        // pass 1's 16-byte loads in flight

// The bits of |v|: the sign cleared, a NaN kept a NaN.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// the maximum of m over the block, in every thread
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* part) {
  m = __reduce_max_sync(0xffffffffu, m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();   // an earlier call's readers are done with part
  if (lane == 0) part[warp] = m;
  __syncthreads();
  m = lane < kThreads / 32 ? part[lane] : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

// pass 1: this thread's share of max |x| over n elements, as the bits of
// a float.  bf16 keeps two 16-bit magnitudes a word (max.u16x2): a bf16's
// float bits are its own shifted up 16, so they order the same way.
template <typename T>
__device__ __forceinline__ unsigned absmax_pass(const T* __restrict__ x,
                                                long long n) {
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);
  constexpr unsigned kMask = kBF16 ? 0x7fff7fffu : 0x7fffffffu;
  unsigned m = 0u;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (aligned16(x)) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const long long nv = n / kVec;
    for (long long i = first; i < nv; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = i + u * stride < nv ? xv[i + u * stride]
                                   : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          m = kBF16 ? __vmaxu2(m, w[j] & kMask) : max(m, w[j] & kMask);
      }
    }
    done = nv * kVec;
  }
  if (kBF16) m = max(m & 0xffffu, m >> 16) << 16;
  for (long long i = done + first; i < n; i += stride)
    m = max(m, abs_bits(to_f32(x[i])));
  return m;
}

// out[i] = the 32 bits at byte offset 4 * K + sh / 8 of w
template <int K, int N>
__device__ __forceinline__ void shift_words(const uint32_t (&w)[N + 4],
                                            uint32_t (&out)[N], int sh) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = __funnelshift_r(w[i + K], w[i + K + 1], sh);
}

// N contiguous elements from p (aligned to its element) as floats, read
// in 16-byte aligned loads of the span around them and realigned.  The
// extra load past the span is made only when p is misaligned, and then
// its 16 bytes hold the span's last byte: it stays inside the tensor's
// 16-byte-aligned allocation.
template <typename T, int N>
__device__ __forceinline__ void load_span(const T* __restrict__ p,
                                          float (&f)[N]) {
  constexpr int kWords = N * (int)sizeof(T) / 4;   // 4, 8 or 16
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* base = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int mis = (int)(a & 15);
  uint32_t w[kWords + 4];
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    const uint4 v = base[i];
    w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z,
    w[4 * i + 3] = v.w;
  }
  uint4 tail = make_uint4(0, 0, 0, 0);
  if (mis) tail = base[kWords / 4];
  w[kWords] = tail.x, w[kWords + 1] = tail.y, w[kWords + 2] = tail.z,
  w[kWords + 3] = tail.w;
  uint32_t o[kWords];
  const int sh = 8 * (mis & 3);
  switch (mis >> 2) {
    case 0: shift_words<0, kWords>(w, o, sh); break;
    case 1: shift_words<1, kWords>(w, o, sh); break;
    case 2: shift_words<2, kWords>(w, o, sh); break;
    default: shift_words<3, kWords>(w, o, sh); break;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 2) {   // bf16: the low half first
      f[2 * i] = __uint_as_float(o[i] << 16);
      f[2 * i + 1] = __uint_as_float(o[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(o[i]);
    }
  }
}

// clip(round_half_even(x / s), -127, 127) and a NaN quotient to 0;
// __float2int_rn rounds half to even and saturates +-Inf
__device__ __forceinline__ int q1(float x, float s) {
  const float q = __fdiv_rn(x, s);
  return isnan(q) ? 0 : min(max(__float2int_rn(q), -127), 127);
}

// four quantized values, element j in byte j
__device__ __forceinline__ uint32_t q4(const float* f, float s) {
  const uint32_t lo = __byte_perm(q1(f[0], s), q1(f[1], s), 0x0040);
  const uint32_t hi = __byte_perm(q1(f[2], s), q1(f[3], s), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// pass 2's segment i: SEG inputs of one row (0 in the pad) as floats
template <typename T, int SEG>
__device__ __forceinline__ void load_segment(const T* __restrict__ x, int i,
                                             int segs, int cols,
                                             float (&f)[SEG]) {
  const int r = i / segs;
  const int c0 = (i - r * segs) * SEG;
  const T* xr = x + (long long)r * cols + c0;
  if (c0 + SEG <= cols) {
    load_span<T, SEG>(xr, f);
  } else {   // the row's tail, element by element
#pragma unroll
    for (int j = 0; j < SEG; ++j)
      f[j] = c0 + j < cols ? to_f32(xr[j]) : 0.f;   // pad: 0 / s = 0
  }
}

template <int SEG>
__device__ __forceinline__ void store_segment(int8_t* __restrict__ q, int i,
                                              int segs, int cols_pad,
                                              const float (&f)[SEG],
                                              float s) {
  const int r = i / segs;
  int8_t* dst = q + (long long)r * cols_pad + (i - r * segs) * SEG;
  if constexpr (SEG == 16) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(q4(f, s), q4(f + 4, s), q4(f + 8, s), q4(f + 12, s));
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(q4(f, s), q4(f + 4, s));
  }
}

template <typename T, int SEG, bool kDyn>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                const float* __restrict__ a_scale,
                float* __restrict__ scale_out,
                unsigned* __restrict__ amax_out,
                unsigned* __restrict__ partials, long long rows, int cols,
                int cols_pad) {
  __shared__ unsigned part[kThreads / 32];
  float s;
  if constexpr (kDyn) {
    unsigned m = block_max(absmax_pass(x, rows * cols), part);
    if (threadIdx.x == 0) partials[blockIdx.x] = m;
    cg::this_grid().sync();
    m = 0u;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
      m = max(m, __ldcg(partials + i));
    m = block_max(m, part);
    const float d = __fdiv_rn(__uint_as_float(m), 127.f);
    s = isnan(d) ? d : fmaxf(d, 1e-8f);   // jnp.maximum keeps a NaN
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *amax_out = m;
      *scale_out = s;
    }
  } else {
    s = *a_scale;
  }
  // pass 2, backwards; the entry point keeps rows * segs below 2^31
  const int segs = cols_pad / SEG;
  const int stride = gridDim.x * kThreads;
  const int first = (int)(rows * segs) - 1 - (blockIdx.x * kThreads +
                                               (int)threadIdx.x);
  for (int i = first; i >= 0; i -= 2 * stride) {
    float f0[SEG], f1[SEG];
    const bool two = i - stride >= 0;
    load_segment<T, SEG>(x, i, segs, cols, f0);
    if (two) load_segment<T, SEG>(x, i - stride, segs, cols, f1);
    store_segment<SEG>(q, i, segs, cols_pad, f0, s);
    if (two) store_segment<SEG>(q, i - stride, segs, cols_pad, f1, s);
  }
}

template <typename T, int SEG>
int launch(const T* x, int8_t* q, const float* a_scale, float* scale_out,
           unsigned* amax_out, unsigned* partials, int capacity,
           long long rows, int cols, int cols_pad, int variant,
           cudaStream_t st) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const long long items = rows * (cols_pad / SEG);
  const long long want = (items + kThreads - 1) / kThreads;
  if (variant == kStatic) {
    const unsigned grid = (unsigned)std::min<long long>(
        want, (long long)kStaticBlocksPerSM * sms);
    quantize_kernel<T, SEG, false><<<grid, kThreads, 0, st>>>(
        x, q, a_scale, scale_out, amax_out, partials, rows, cols, cols_pad);
    return (int)cudaGetLastError();
  }
  auto kernel = quantize_kernel<T, SEG, true>;
  static std::atomic<int> occupancy[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int occ = occupancy[dev].load(std::memory_order_acquire);
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (occ <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    occupancy[dev].store(occ, std::memory_order_release);
  }
  const long long vec_work = (rows * cols / (16 / sizeof(T)) +
                              (long long)kUnroll * kThreads - 1) /
                             ((long long)kUnroll * kThreads);
  const long long blocks =
      std::min<long long>(std::max(want, vec_work),
                          (long long)std::min(occ, kBlocksPerSM) * sms);
  if (blocks > capacity) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)std::max<long long>(blocks, 1));
  void* args[] = {&x, &q, &a_scale, &scale_out, &amax_out, &partials,
                  &rows, &cols, &cols_pad};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                    dim3(kThreads), args, 0, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch_seg(const void* x, void* q, const void* a_scale, void* scale_out,
               void* amax_out, void* partials, int capacity, long long rows,
               int cols, int cols_pad, int variant, cudaStream_t st) {
  auto* xt = static_cast<const T*>(x);
  auto* qo = static_cast<int8_t*>(q);
  auto* as = static_cast<const float*>(a_scale);
  auto* so = static_cast<float*>(scale_out);
  auto* ao = static_cast<unsigned*>(amax_out);
  auto* pa = static_cast<unsigned*>(partials);
  return cols_pad % 16 == 0
             ? launch<T, 16>(xt, qo, as, so, ao, pa, capacity, rows, cols,
                             cols_pad, variant, st)
             : launch<T, 8>(xt, qo, as, so, ao, pa, capacity, rows, cols,
                            cols_pad, variant, st);
}

}  // namespace

// x: (rows, cols) contiguous (dtype 0 float32, 1 bf16); q: (rows,
// cols_pad) int8, cols <= cols_pad, cols_pad % 8 == 0, q aligned to 16
// bytes (cols_pad % 16 == 0) or 8.  variant 0 (dynamic): a_scale null;
// scale_out (one float), amax_out (one word) and partials (capacity
// words, at least the grid: kBlocksPerSM an SM) required.  variant 1
// (static): a_scale (one float) required, the rest null.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_quantize(const void* x, void* q, const void* a_scale,
                            void* scale_out, void* amax_out, void* partials,
                            int capacity, long long rows, int cols,
                            int cols_pad, int dtype, int variant,
                            void* stream) {
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  if (rows <= 0 || cols <= 0 || cols_pad < cols || cols_pad % 8 != 0 ||
      rows * (cols_pad / 8) > 2147483647LL ||
      x == nullptr || q == nullptr || (qa & 7) != 0 ||
      (cols_pad % 16 == 0 && (qa & 15) != 0) ||
      (variant == kDynamic &&
       (a_scale || !scale_out || !amax_out || !partials || capacity < 1)) ||
      (variant == kStatic && !a_scale) ||
      (variant != kDynamic && variant != kStatic))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_seg<float>(x, q, a_scale, scale_out, amax_out, partials,
                               capacity, rows, cols, cols_pad, variant, st);
    case kBFloat16:
      return launch_seg<__nv_bfloat16>(x, q, a_scale, scale_out, amax_out,
                                       partials, capacity, rows, cols,
                                       cols_pad, variant, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
