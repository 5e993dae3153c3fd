// K3, variant wgmma: the int8 implicit-GEMM convolution on Hopper's
// warpgroup tensor-core instruction, fed by the Tensor Memory Accelerator.
//
// The function is csrc/quant_conv.cu's (tera_mind_tpu/ops/quant.py::
// quant_conv2d, :58): int32 sums of the SAME convolution of int8 x
// (B, H, W, Ci_pad) and w (Co, kh, kw, Ci_pad), then f32(acc) *
// __fmul_rn(s_x, s_w[co]) + bias[co] by __fmul_rn and __fadd_rn, or the
// raw sums, bit for bit the plain version's (ops/quant_kernel.py
// quant_conv_plain).  Bound: at the main path's shapes the int8 tensor
// cores (1,979 TOPS on an H100 SXM); PR 10's mma_sync variant reached
// 20-26 % of them.  What this design does about it:
//
// - Products: wgmma.mma_async m64nBNk32 s32.s8.s8, BN = 128 or 256
//   output channels, A and B both K-major in shared memory with the
//   128-byte swizzle (the only layout 8-bit wgmma takes, and the one
//   both operands have: x is NHWC, w is (Co, kh, kw, Ci_pad)).  A stage
//   is one tap x 128 input channels: four k32 steps a barrier.
// - Loads: TMA.  x has a 4-D tensor map (Ci_pad, W, H, B) whose box
//   (128 B, W, bh, bb) is one M tile of 128 output pixels in whole image
//   rows; the tap's shift (r - kh/2, s - kw/2) moves the box's start,
//   and the hardware fills coordinates outside the tensor with zeros:
//   SAME padding, the ragged last channel chunk and a last tile past B
//   cost nothing (quantization maps 0 to 0).  w has a 3-D map (Ci_pad,
//   kh*kw, Co), box (128 B, 1, BN).  cuTensorMapEncodeTiled, a driver
//   function, is reached through cudaGetDriverEntryPoint[ByVersion]: the
//   library links no -lcuda.  The mbarrier, TMA, wgmma and tensor-map
//   helpers are csrc/hopper.cuh's, shared with K2's wgmma variant.
// - Rows of x and w that start off the 128-byte lines (Ci_pad % 128 !=
//   0) load about half as fast; ops/quant_kernel.py::conv_align pads the
//   deep concats to 128 channels.
// - Pipeline: a 192 KB ring (4 stages at BN = 256, 6 at 128) under full
//   and empty mbarriers; warpgroup 0 is the producer (one thread issues
//   the loads, setmaxnreg lowers it to 40 registers), warpgroups 1-2 the
//   consumers (64 pixel rows each, raised to 232), one wgmma group kept
//   in flight.  One block an SM walks a persistent tile schedule
//   (output-channel tiles fastest, so a wave shares its A tiles in L2);
//   each tile runs all its k chunks (splitting K lost at every main-path
//   shape of the 8 x 8 level, PERF.md).
// - Epilogue: s_x * s_w[co] formed here (so ops/quant.py launches no
//   elementwise product), each warp's 16 rows staged through shared
//   memory 32 channels at a time and written with 16-byte stores.
//
// Host side (the wrapper): the plan (box, BN, grid) from
// ops/quant_kernel.py::k3_plan.

#include <atomic>

#include "hopper.cuh"
#include "quant_conv.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;        // output pixels a tile (2 x 64 rows)
constexpr int kBK = 128;        // k bytes a stage (one 128-byte row)
constexpr int kThreads = 384;   // warpgroup 0 produces, 1-2 consume
constexpr int kConsumers = 256;
constexpr int kRingBytes = 192 * 1024;
constexpr int kEpiCols = 32;                    // channels a staged piece
constexpr int kEpiStride = kEpiCols * 4 + 16;   // bytes a staged row
constexpr int kEpiWarp = 16 * kEpiStride;       // a consumer warp's rows
constexpr int kEpiBytes = (kConsumers / 32) * kEpiWarp;

template <int BN> struct Cfg {
  static constexpr int kStageA = kBM * kBK;
  static constexpr int kStageB = BN * kBK;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kStages = kRingBytes / kStage;
  static constexpr int kBarOff = kStages * kStage + kEpiBytes;
  static constexpr int kSmem = 1024 + kBarOff + 2 * kStages * 8;
};
static_assert(Cfg<256>::kStages == 4 && Cfg<128>::kStages == 6,
              "ops/quant_kernel.py k3_plan's stages");
static_assert(Cfg<256>::kSmem <= kMaxBlockSmem &&
                  Cfg<128>::kSmem <= kMaxBlockSmem,
              "the ring and the staging fit an H100 block");

struct Args {
  int h, w, co, kh, kw;
  int ci_chunks, k_chunks, m_tiles, n_tiles, units;
  long long m_total;   // b * h * w
};

// ---- wgmma s8 (the mbarrier, TMA and descriptor helpers: hopper.cuh) ----

template <int BN> struct Wgmma;

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---- epilogue -----------------------------------------------------------

template <typename OutT> struct Out {   // dequantized: f32 or bf16
  static constexpr bool kDequant = true;
  __device__ static float value(int v, float s, float b) {
    return __fadd_rn(__fmul_rn(__int2float_rn(v), s), b);
  }
  __device__ static void put(unsigned char* p, int a, int b, float sa,
                             float sb, float ba, float bb) {
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(p) =
          make_float2(value(a, sa, ba), value(b, sb, bb));
    } else {
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16x2(value(a, sa, ba), value(b, sb, bb));
    }
  }
};
template <> struct Out<int> {           // the raw int32 sums
  static constexpr bool kDequant = false;
  __device__ static void put(unsigned char* p, int a, int b, float, float,
                             float, float) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
  }
};

// Write a consumer warp's 16 x BN tile (rows m0.., channels n0..): each
// piece of 32 channels goes to the warp's staging rows, then out in
// 16-byte stores, rows past m_total and channels past co skipped.
// Thread (g, c4) holds, for each 8-channel group j, channels 8j + 2c4
// and + 1 of rows g (acc[4j], acc[4j + 1]) and g + 8 (acc[4j + 2..3]).
template <int BN, typename OutT>
__device__ __forceinline__ void store_tile(
    OutT* __restrict__ y, const int (&acc)[BN / 2], unsigned char* buf,
    long long m0, int n0, float sxv, const float* __restrict__ sw,
    const float* __restrict__ bias, int lane, const Args& a) {
  constexpr int kSize = sizeof(OutT);
  constexpr int kChunks = kEpiCols * kSize / 16;   // 16 B a staged row
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int p = 0; p < BN / kEpiCols; ++p) {
    const int nb = n0 + p * kEpiCols;
    if (nb >= a.co) continue;   // the same for the whole warp
#pragma unroll
    for (int jj = 0; jj < kEpiCols / 8; ++jj) {
      const int j = p * (kEpiCols / 8) + jj;
      const int col = 8 * jj + 2 * c4, n = nb + col;
      // without a bias add -0.f, which leaves every float as it is
      float s0 = 0.f, s1 = 0.f, b0 = -0.f, b1 = -0.f;
      if (Out<OutT>::kDequant && n < a.co) {   // co % 8 == 0: n + 1 too
        s0 = __fmul_rn(sxv, sw[n]);
        s1 = __fmul_rn(sxv, sw[n + 1]);
        if (bias) {
          b0 = bias[n];
          b1 = bias[n + 1];
        }
      }
      Out<OutT>::put(buf + g * kEpiStride + col * kSize, acc[4 * j],
                     acc[4 * j + 1], s0, s1, b0, b1);
      Out<OutT>::put(buf + (g + 8) * kEpiStride + col * kSize,
                     acc[4 * j + 2], acc[4 * j + 3], s0, s1, b0, b1);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 16 * kChunks / 32; ++t) {
      const int idx = lane + 32 * t, row = idx / kChunks;
      const int n = nb + (idx % kChunks) * (16 / kSize);
      const long long m = m0 + row;
      if (m < a.m_total && n < a.co)
        *reinterpret_cast<uint4*>(y + m * a.co + n) =
            *reinterpret_cast<const uint4*>(buf + row * kEpiStride +
                                            (idx % kChunks) * 16);
    }
    __syncwarp();
  }
}

struct Tile {
  int mt, nt;
};
__device__ __forceinline__ Tile tile_of(int u, const Args& a) {
  const int mt = u / a.n_tiles;
  return Tile{mt, u - mt * a.n_tiles};
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
quant_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw,
                        const float* __restrict__ bias, OutT* __restrict__ y,
                        Args a) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the descriptors need 1,024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    prefetch_map(&xmap);
    prefetch_map(&wmap);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);   // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int hw = a.h * a.w;
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const Tile t = tile_of(u, a);
        const long long m0 = (long long)t.mt * kBM;
        const int b0 = (int)(m0 / hw);
        const int h0 = (int)(m0 - (long long)b0 * hw) / a.w;
        for (int c = 0; c < a.k_chunks; ++c, ++it) {
          const int s = it % C::kStages;
          mbar_wait(empty + s, ((it / C::kStages) & 1) ^ 1);
          unsigned char* st = smem + s * C::kStage;
          mbar_expect_tx(full + s, C::kStage);
          const int tap = c / a.ci_chunks, cc = c - tap * a.ci_chunks;
          const int r = tap / a.kw, q = tap - r * a.kw;
          tma_load_4d(st, &xmap, full + s, cc * kBK, q - a.kw / 2,
                      h0 + r - a.kh / 2, b0);
          tma_load_3d(st + C::kStageA, &wmap, full + s, cc * kBK, tap,
                      t.nt * BN);
        }
      }
    }
  } else {
    // ---- consumers: 64 pixel rows x BN channels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const float sxv = sx ? *sx : 1.f;
    unsigned char* buf =
        smem + C::kStages * C::kStage + (cw * 4 + warp) * kEpiWarp;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int it = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Tile t = tile_of(u, a);
      int prev = 0;
      for (int i = 0; i < a.k_chunks; ++i, ++it) {
        const int s = it % C::kStages;
        mbar_wait(full + s, (it / C::kStages) & 1);
        const uint32_t sa = smem_addr(smem + s * C::kStage) + cw * 64 * kBK;
        const uint32_t sb = smem_addr(smem + s * C::kStage + C::kStageA);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          Wgmma<BN>::mma(acc, sw128_desc(sa + 32 * kk),
                         sw128_desc(sb + 32 * kk), i > 0 || kk > 0);
        wgmma_commit();
        fence_operands(acc);
        if (i > 0) {   // the previous chunk's products are done
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + prev);

      const long long m0 = (long long)t.mt * kBM + cw * 64 + warp * 16;
      const int n0 = t.nt * BN;
      store_tile<BN, OutT>(y, acc, buf, m0, n0, sxv, sw, bias, lane, a);
    }
  }
}

// ---- host side ----------------------------------------------------------

// an int8 tensor map of `rank` dims (innermost first) with the 128-byte
// swizzle and zeros outside the tensor
bool make_map(CUtensorMap* m, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  return hopper::make_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rank, dims,
                          strides, box);
}

template <int BN, typename OutT>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const float* sx,
           const float* sw, const float* bias, void* y, const Args& a,
           int grid, cudaStream_t st) {
  static std::atomic<int> smem_state[kMaxDevices];
  auto kernel = quant_conv_wgmma_kernel<BN, OutT>;
  const cudaError_t err = smem_opt_in(kernel, Cfg<BN>::kSmem, smem_state);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, Cfg<BN>::kSmem, st>>>(
      xm, wm, sx, sw, bias, static_cast<OutT*>(y), a);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_bn(int bn, const CUtensorMap& xm, const CUtensorMap& wm,
              const float* sx, const float* sw, const float* bias, void* y,
              const Args& a, int grid, cudaStream_t st) {
  return bn == 256 ? launch<256, OutT>(xm, wm, sx, sw, bias, y, a, grid, st)
                   : launch<128, OutT>(xm, wm, sx, sw, bias, y, a, grid, st);
}

}  // namespace

int quant_conv_wgmma(const void* x, const void* w, const float* sx,
                     const float* sw, const float* bias, void* y,
                     const ConvShape& s, const ConvPlan& p,
                     int out_dtype, cudaStream_t stream) {
  const bool rows_fit = p.box_b == 1 ? p.box_h > 0 && s.h % p.box_h == 0
                                     : p.box_h == s.h && p.box_b > 1;
  const int ci_chunks = (s.ci + kBK - 1) / kBK;
  const int k_chunks = s.kh * s.kw * ci_chunks;
  const long long m_total = (long long)s.b * s.h * s.w;
  const long long m_tiles = (m_total + kBM - 1) / kBM;
  const long long n_tiles = (s.co + p.bn - 1) / p.bn;
  if (p.box_w != s.w || p.box_w * p.box_h * p.box_b != kBM || !rows_fit ||
      (p.bn != 128 && p.bn != 256) || p.grid < 1 ||
      m_tiles * n_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args a{s.h,          s.w,          s.co,
               s.kh,         s.kw,         ci_chunks,
               k_chunks,     (int)m_tiles, (int)n_tiles,
               (int)(m_tiles * n_tiles), m_total};
  CUtensorMap xm, wm;
  const cuuint64_t xdim[4] = {(cuuint64_t)s.ci, (cuuint64_t)s.w,
                              (cuuint64_t)s.h, (cuuint64_t)s.b};
  const cuuint64_t xstr[3] = {(cuuint64_t)s.ci, (cuuint64_t)s.w * s.ci,
                              (cuuint64_t)s.h * s.w * s.ci};
  const cuuint32_t xbox[4] = {kBK, (cuuint32_t)p.box_w, (cuuint32_t)p.box_h,
                              (cuuint32_t)p.box_b};
  const cuuint64_t wdim[3] = {(cuuint64_t)s.ci, (cuuint64_t)s.kh * s.kw,
                              (cuuint64_t)s.co};
  const cuuint64_t wstr[2] = {(cuuint64_t)s.ci,
                              (cuuint64_t)s.kh * s.kw * s.ci};
  const cuuint32_t wbox[3] = {kBK, 1, (cuuint32_t)p.bn};
  if (!make_map(&xm, x, 4, xdim, xstr, xbox) ||
      !make_map(&wm, w, 3, wdim, wstr, wbox))
    return (int)cudaErrorInvalidValue;
  switch (out_dtype) {
    case kOutF32:
      return launch_bn<float>(p.bn, xm, wm, sx, sw, bias, y, a, p.grid,
                              stream);
    case kOutBF16:
      return launch_bn<__nv_bfloat16>(p.bn, xm, wm, sx, sw, bias, y, a,
                                      p.grid, stream);
    case kOutI32:
      return launch_bn<int>(p.bn, xm, wm, sx, sw, bias, y, a, p.grid,
                            stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
