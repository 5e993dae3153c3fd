// K3: int8 implicit-GEMM convolution with a dequantizing epilogue.
//
// y[b, oh, ow, co] = bf16(f32(acc) * scale[co] + bias[co]), where
// acc = sum over taps (r, s) and input channels ci of
// x[b, oh + r - kh/2, ow + s - kw/2, ci] * w[co, r, s, ci] in int32, and
// taps outside the image read 0.  x is the NHWC int8 activation that K4
// (csrc/quantize.cu) writes, with its channels zero-padded to a multiple
// of 16; w is the int8 weight (Co, kh, kw, Ci_pad), K-contiguous, padded
// the same way; scale[co] = __fmul_rn(s_x, s_w[co]) is formed here from
// the activation scale s_x (a device scalar) and the weight scales s_w,
// the one f32 product JAX's dequantize rounds; bias is f32.  This is
// tera_mind_tpu/ops/quant.py::quant_conv2d (:58), whose
// lax.conv_general_dilated int8 x int8 -> int32 product and dequantize
// (:94-101) XLA runs on the TPU; PyTorch has no int8 convolution.  Zero
// padding is exact because quantization maps 0 to 0.  The dequantize uses
// __fmul_rn and __fadd_rn, so nvcc cannot contract them into one FMA: the
// result is the plain version's (ops/quant_kernel.py quant_conv_plain)
// bit for bit.  int32 cannot overflow: 127^2 * 9 * 2,512 < 2^31 at the
// widest input of the main path; the entry point refuses a call whose
// kh * kw * Ci_pad could.
//
// Bound: at the main path's shapes it does 2 * M * Co * kh * kw * Ci
// operations on M * Ci + Co * kh * kw * Ci bytes in and 2 * M * Co out,
// hundreds of operations a byte, so the int8 tensor cores (1,979 TOPS on
// an H100 SXM) bound it.
//
// Two variants, chosen by ops/quant_kernel.py::k3_plan's shape rule and
// passed in with the plan (csrc/quant_conv.cuh):
// - wgmma (csrc/quant_conv_wgmma.cu): Hopper's wgmma s8 fed by TMA,
//   where a 128-pixel M tile is whole image rows (every main-path
//   shape);
// - mma_sync (this file, PR 10's kernel): mma.sync m16n8k32 s8 (the
//   Ampere-style warp instruction), a 128 x 128 output tile a block of 8
//   warps (each 64 x 32), k tiles of 64 bytes (one tap, 64 input
//   channels) in a 3-stage cp.async ring with an XOR swizzle, so the
//   ldmatrix reads of a 64-byte row hit 8 distinct 16-byte bank groups;
//   the epilogue writes each thread's two adjacent outputs straight to
//   device memory.  It takes any shape.
// Each writes bf16 or float32 (dequantized) or int32 (the raw sums, for
// the checks).

#include "common.cuh"
#include "quant_conv.cuh"

namespace {

constexpr int kBM = 128;        // output pixels a block
constexpr int kBN = 128;        // output channels a block
constexpr int kBK = 64;         // k bytes a stage (one tap, 64 channels)
constexpr int kStages = 3;
constexpr int kThreads = 256;   // 8 warps: 2 (pixels) x 4 (channels)
constexpr int kTileBytes = kBM * kBK;
constexpr int kSmem = kStages * 2 * kTileBytes;   // 48 KB
constexpr int kCiAlign = 16;    // Ci_pad multiple (16-byte loads)
constexpr long long kMaxSum = 2147483647LL;

static_assert(kBM == kBN && kThreads == 2 * kBM,
              "each thread copies two rows of A and two of B a stage");
static_assert(kSmem == 49152, "48 KB: no opt-in above the default limit");

// byte offset of 16-byte chunk c (0..3) of row r of a 64-byte-row tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// 16-byte cp.async that writes zeros instead when !valid (src-size 0)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// d += a b for a 16x32 s8 A (row), a 32x8 s8 B (col), s32 accumulators.
// The fragments hold the same bytes as mma m16n8k16 bf16's, so ldmatrix
// b16 loads them: a = {A[g][4c..], A[g+8][4c..], A[g][16+4c..],
// A[g+8][16+4c..]}, b = {B[4c..][g], B[16+4c..][g]}, d = {D[g][2c],
// D[g][2c+1], D[g+8][2c], D[g+8][2c+1]} (g = lane/4, c = lane%4).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename OutT> struct Store;
template <> struct Store<float> {
  __device__ static void pair(float* p, int a, int b, float sa, float sb,
                              float ba, float bb) {
    *reinterpret_cast<float2*>(p) =
        make_float2(__fadd_rn(__fmul_rn(__int2float_rn(a), sa), ba),
                    __fadd_rn(__fmul_rn(__int2float_rn(b), sb), bb));
  }
};
template <> struct Store<__nv_bfloat16> {
  __device__ static void pair(__nv_bfloat16* p, int a, int b, float sa,
                              float sb, float ba, float bb) {
    *reinterpret_cast<uint32_t*>(p) =
        pack_bf16x2(__fadd_rn(__fmul_rn(__int2float_rn(a), sa), ba),
                    __fadd_rn(__fmul_rn(__int2float_rn(b), sb), bb));
  }
};
template <> struct Store<int> {
  __device__ static void pair(int* p, int a, int b, float, float, float,
                              float) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
quant_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, OutT* __restrict__ y,
                  ConvShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int m_total = s.b * s.h * s.w;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kc = (s.ci + kBK - 1) / kBK;          // k tiles a tap
  const int ktiles = s.kh * s.kw * kc;
  const size_t wrow = (size_t)s.kh * s.kw * s.ci;  // a weight row's bytes

  // this thread's rows (tid / 4 and tid / 4 + 64) and 16-byte chunk of
  // each A and B tile
  const int lc = tid & 3;
  int ab[2], aoh[2], aow[2];
  bool aok[2], bok[2];
  const int8_t* bsrc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + 64 * i;
    const int m = m0 + row;
    aok[i] = m < m_total;
    const int mm = aok[i] ? m : 0;
    aow[i] = mm % s.w;
    const int t = mm / s.w;
    aoh[i] = t % s.h;
    ab[i] = t / s.h;
    const int n = n0 + row;
    bok[i] = n < s.co;
    bsrc[i] = w + (size_t)(bok[i] ? n : 0) * wrow;
  }

  auto load = [&](int kt, int stage) {
    const int tap = kt / kc;
    const int c0 = (kt - tap * kc) * kBK + lc * 16;
    const int r = tap / s.kw, q = tap - r * s.kw;
    const bool cin = c0 < s.ci;
    unsigned char* sa = smem + stage * 2 * kTileBytes;
    unsigned char* sb = sa + kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 64 * i;
      const int ih = aoh[i] + r - s.kh / 2, iw = aow[i] + q - s.kw / 2;
      const bool ok = aok[i] && cin && ih >= 0 && ih < s.h && iw >= 0 &&
                      iw < s.w;
      const int8_t* src =
          ok ? x + (((size_t)ab[i] * s.h + ih) * s.w + iw) * s.ci + c0 : x;
      cp_async16_zfill(sa + swz(row, lc), src, ok);
      const bool okb = bok[i] && cin;
      cp_async16_zfill(sb + swz(row, lc),
                       okb ? bsrc[i] + (size_t)tap * s.ci + c0 : w, okb);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt is in; every warp is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load(nk, nk % kStages);
    cp_async_commit();
    const unsigned char* sa = smem + (kt % kStages) * 2 * kTileBytes;
    const unsigned char* sb = sa + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {   // two k32 steps a 64-byte tile
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], sa + swz(wm + 16 * mi + (lane & 15),
                                    2 * kk + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r4[4];
        ldmatrix_x4(r4, sb + swz(wn + 16 * nj + (lane & 7) +
                                     ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)));
        b[2 * nj][0] = r4[0];
        b[2 * nj][1] = r4[1];
        b[2 * nj + 1][0] = r4[2];
        b[2 * nj + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8_16832(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: rows g and g + 8 of each 16 x 8 tile, two channels each
  const float sxv = sx ? *sx : 1.f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn + 8 * ni + 2 * c4;
    if (n >= s.co) continue;   // Co % 8 == 0: n + 1 < Co as well
    const float sa = sw ? __fmul_rn(sxv, sw[n]) : 0.f;
    const float sb = sw ? __fmul_rn(sxv, sw[n + 1]) : 0.f;
    // without a bias add -0.f, which leaves every float as it is
    const float ba = bias ? bias[n] : -0.f, bb = bias ? bias[n + 1] : -0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wm + 16 * mi + g + 8 * hf;
        if (m >= m_total) continue;
        Store<OutT>::pair(y + (size_t)m * s.co + n, acc[mi][ni][2 * hf],
                          acc[mi][ni][2 * hf + 1], sa, sb, ba, bb);
      }
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const float* sx, const float* sw,
           const float* bias, void* y, const ConvShape& s,
           cudaStream_t stream) {
  const long long m = (long long)s.b * s.h * s.w;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((s.co + kBN - 1) / kBN));
  quant_conv_kernel<OutT><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), sx, sw,
      bias, static_cast<OutT*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, h, w, ci) int8, w: (co, kh, kw, ci) int8, both contiguous and
// 16-byte aligned with ci % 16 == 0 (zero-padded channels); y: (b, h, w,
// co), contiguous, 16-byte aligned, co % 8 == 0; kh and kw odd, padding
// (kh - 1) / 2 and (kw - 1) / 2 (SAME).  out_dtype 0 (f32) or 1 (bf16):
// sw (co,) f32 required, sx one f32 or null (1), bias (co,) f32 or null;
// out_dtype 2 (int32): the raw sums, sx, sw and bias null.  variant 0
// (wgmma) runs the plan (box_w, box_h, box_b, bn, grid) of
// ops/quant_kernel.py::k3_plan and refuses one that does not fit the
// shape; variant 1 (mma_sync) takes any shape
// and ignores the plan.  A call outside these limits is an error, never
// a fallback.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tmt_quant_conv(const void* x, const void* w, const void* sx,
                              const void* sw, const void* bias, void* y,
                              int b, int h, int wd, int ci, int co, int kh,
                              int kw, int out_dtype, int variant, int box_w,
                              int box_h, int box_b, int bn, int grid,
                              void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 ||
      ci % kCiAlign != 0 || co % 8 != 0 || kh <= 0 || kw <= 0 ||
      kh % 2 == 0 || kw % 2 == 0 || (long long)b * h * wd > 2147483647LL ||
      127LL * 127LL * kh * kw * ci > kMaxSum || !aligned16(x) ||
      !aligned16(w) || !aligned16(y) || out_dtype < kOutF32 ||
      out_dtype > kOutI32 ||
      (out_dtype == kOutI32 ? sx || sw || bias : !sw))
    return (int)cudaErrorInvalidValue;
  const ConvShape s{b, h, wd, ci, co, kh, kw};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fw = static_cast<const float*>(sw);
  const auto* fb = static_cast<const float*>(bias);
  if (variant == kWgmma)
    return quant_conv_wgmma(x, w, fx, fw, fb, y, s,
                            ConvPlan{box_w, box_h, box_b, bn, grid},
                            out_dtype, st);
  if (variant != kMmaSync) return (int)cudaErrorInvalidValue;
  switch (out_dtype) {
    case kOutF32: return launch<float>(x, w, fx, fw, fb, y, s, st);
    case kOutBF16:
      return launch<__nv_bfloat16>(x, w, fx, fw, fb, y, s, st);
    default: return launch<int>(x, w, nullptr, nullptr, nullptr, y, s, st);
  }
}
