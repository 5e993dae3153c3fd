// K2b wgmma's device pieces shared by its two sources
// (csrc/attention_bwd_wgmma.cu: the fused and blocked designs and the
// entry; csrc/attention_bwd_wgmma_2pass.cu: the two-pass design), compiled
// apart so that the build's nvcc processes run side by side: the wgmma
// steps, the ring as both sides walk it, the quad reductions, the
// IEEE-quotient division, the staged output store, the tensor maps.
#pragma once

#include <math.h>

#include <algorithm>

#include "attention_bwd_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;             // warpgroup 0 produces, 1-2 consume
constexpr int kTile = 128 * 128;          // a 64-column slab of 128 rows
constexpr int kBox = wgb::kBoxRows * 128; // a TMA box: 64 rows x 128 bytes

struct Args {
  int b, n, d, units;
  float scale;
  int hsplit;   // fused: blocks sharing a unit's halves of D (each
                // recomputing its logits), so that a small B fills the SMs
};

// ---- wgmma m64nNk16, f32 += bf16 x bf16 ------------------------------------

// A and B from shared memory; TA / TB: that operand MN-major (a 128-byte
// row holds 64 of its M or N elements for one k), else K-major
template <int N, int TA, int TB> struct Ss;

template <int TA, int TB> struct Ss<64, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Ss<128, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// A (64 x 16 bf16) from registers, B (16 x 64) MN-major in shared memory;
// the accumulator is d[OFF .. OFF + 31]
template <int OFF, int N>
__device__ __forceinline__ void rs64(float (&d)[N], const uint32_t (&a)[4],
                                     uint64_t db) {
  static_assert(OFF + 32 <= N, "the accumulator's range");
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, "
    "%8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, "
    "%24, %25, %26, %27, %28, %29, %30, %31"
    "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
    : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A (64 x 16 bf16) from registers, B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void rs128(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, "
    "%8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, "
    "%24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, "
    "%40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, "
    "%56, %57, %58, %59, %60, %61, %62, %63"
    "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the ring, as the consumers walk it ------------------------------------

// Slot it % stages, phase parity (it / stages) & 1.  Each consumer warp
// arrives once on a slot's empty barrier when the products that read it
// are done: after the products of the next slot are issued (wait<1>), or
// at the end of a run of slots (wait<0>); or (next, release_run) every
// slot of a run of products issued without a wait, at its end.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int slot_bytes, stages, it, prev, run0;

  __device__ __forceinline__ uint32_t wait() {
    const int s = it % stages;
    mbar_wait(full + s, (it / stages) & 1);
    return smem_addr(base + s * slot_bytes);
  }
  // after the commit of the products of the slot wait() returned
  __device__ __forceinline__ void issued(int lane) {
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + prev);
    }
    prev = it % stages;
    ++it;
  }
  __device__ __forceinline__ void finish(int lane) {
    wgmma_wait<0>();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    prev = -1;
  }
  __device__ __forceinline__ void next() { ++it; }
  __device__ __forceinline__ void release_run(int lane) {
    wgmma_wait<0>();
    if (lane == 0)
      for (int j = run0; j < it; ++j) mbar_arrive(empty + j % stages);
    run0 = it;
  }
};

// the producer's side: wait until slot it is free, expect `bytes` on it
struct Filler {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int slot_bytes, stages, it;

  __device__ __forceinline__ unsigned char* next(int bytes, uint64_t*& bar) {
    const int s = it % stages;
    mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
    bar = full + s;
    mbar_expect_tx(bar, bytes);
    ++it;
    return base + s * slot_bytes;
  }
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// e / l rounded to nearest, as IEEE division gives it, from r = 1 / l
// rounded to nearest (Markstein's correction, as K2 wgmma forms p)
__device__ __forceinline__ float div_by(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// Thread (g = lane / 4, c4 = lane % 4) of a consumer warp holds, of an
// m64nN accumulator, columns 8 j + 2 c4 and + 1 (j < N / 8) of its rows g
// (x[4 j], x[4 j + 1]) and g + 8 (x[4 j + 2], x[4 j + 3]); the A fragment
// of k16 step kk of the next product is registers 4 kk .. 4 kk + 3 of the
// packed pairs, pair i = (x[2 i], x[2 i + 1]).
__device__ __forceinline__ int acc_col(int i, int c4) {
  return 8 * (i >> 2) + 2 * c4 + (i & 1);
}

// This warp's 16 rows (row0 ..) of one 64-column slab of an output
// (columns col0 ..; accumulator blocks j0 .. j0 + 7) times mul, rounded
// once to bf16: staged in the warp's shared rows, then written as
// 16-byte stores of whole 128-byte row pieces; rows at or past n skipped.
template <int N>
__device__ __forceinline__ void store_slab(const float (&o)[N], int j0,
                                           unsigned char* stage,
                                           bf16* __restrict__ out,
                                           long long base, int row0,
                                           int col0, int n, int d, float mul,
                                           int lane) {
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + jj, col = 8 * jj + 2 * c4;
    *reinterpret_cast<uint32_t*>(stage + g * wgb::kStageRow + 2 * col) =
        pack_bf16x2(o[4 * j] * mul, o[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * wgb::kStageRow +
                                 2 * col) =
        pack_bf16x2(o[4 * j + 2] * mul, o[4 * j + 3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, rr = idx >> 3, c = idx & 7;
    const int row = row0 + rr, col = col0 + 8 * c;
    if (row < n && col < d)
      *reinterpret_cast<uint4*>(out + base + (long long)row * d + col) =
          *reinterpret_cast<const uint4*>(stage + rr * wgb::kStageRow +
                                          16 * c);
  }
  __syncwarp();
}

// a bf16 (D, N, B) tensor map: boxes of 64 columns x 64 rows of one batch
// index
bool map64(CUtensorMap* m, const void* base, int b, int n, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {wgb::kSlab, wgb::kBoxRows, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims,
                  strides, box);
}

template <typename Kernel>
int opt_in(Kernel kernel, std::atomic<int> (&state)[kMaxDevices]) {
  return (int)smem_opt_in(kernel, kMaxBlockSmem, state);
}

}  // namespace

// The two-pass design (N > 128, D <= 256; csrc/attention_bwd_wgmma_2pass.cu)
// on the call's tensor maps; the entry's contract (attention_bwd_wgmma)
int attention_bwd_wgmma_two_pass(const CUtensorMap& qm, const CUtensorMap& km,
                                 const CUtensorMap& vm, const CUtensorMap& gm,
                                 void* dq, void* dk, void* dv, float* stats,
                                 int b, int n, int d, float scale,
                                 cudaStream_t stream);
