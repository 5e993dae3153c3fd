// K2's wgmma variant (csrc/attention_wgmma.cu): the calls it takes, its
// shared-memory plan, and its launcher, which the entry point
// tmt_window_attention (csrc/attention.cu) calls.  ops/attention_kernel.py
// ::wgmma_layout mirrors wg_layout.
#pragma once

#include <cuda_runtime.h>

namespace wg {

constexpr int kSlab = 64;           // D columns a 128-byte swizzled slab
constexpr int kSlot = 32 * 1024;    // a ring slot
constexpr int kStages = 4;          // ring slots: 128 KB
constexpr int kConsumerWarps = 8;
constexpr int kStageRow = 64 * 2 + 16;   // a staged output row, padded
constexpr int kStageBytes = kConsumerWarps * 16 * kStageRow;

struct Layout {
  int slabs;    // 64-column slabs of D, ceil(D / 64)
  bool dsplit;  // D = 512: both consumers take the same 64 rows, each
                // half of D's slabs; else each its own 64 rows, all of D
  int rows;     // query rows a unit: 128, or 64 when dsplit
  int kt;       // keys a K or V tile: 128, or 64 when dsplit
  int per;      // slabs a consumer accumulates
  int nh;       // slabs a p.v pass (the O accumulator: 64 x 64 nh f32)
  int passes;   // p.v passes, ceil(per / nh); V is loaded a pass at a time
  int tiles;    // key tiles, ceil(N / kt)
  int nt;       // key tiles a chunk (their logits in registers)
  int chunks;   // ceil(tiles / nt); more than one: two passes over K
  int kslabs;   // slabs of a K tile a 32 KB slot holds (a V slot holds
                // one pass's slabs of a tile: nh, twice when dsplit)
  int q_bytes;  // the unit's q tile
  int smem;     // dynamic shared memory, 1,024 bytes of alignment slack,
                // the output staging and the barriers included
};

__host__ __device__ constexpr Layout layout(int n, int d) {
  const int slabs = (d + kSlab - 1) / kSlab;
  const bool dsplit = d > 256;
  const int rows = dsplit ? 64 : 128;
  const int kt = dsplit ? 64 : 128;
  const int per = dsplit ? slabs / 2 : slabs;
  const int nh = per == 1 ? 1 : 2;
  const int passes = (per + nh - 1) / nh;
  const int tiles = (n + kt - 1) / kt;
  // up to 256 keys a row's logits stay in registers (128 a thread); past
  // that one tile a chunk, O living across the chunks
  const int nt = tiles * kt <= 256 ? tiles : 1;
  const int chunks = (tiles + nt - 1) / nt;
  const int q_bytes = slabs * rows * 128;
  return Layout{slabs, dsplit, rows, kt, per, nh, passes, tiles, nt, chunks,
                kSlot / (kt * 128), q_bytes,
                1024 + q_bytes + kStages * kSlot + kStageBytes +
                    (2 * kStages + 2) * 8};
}

// bf16, D % 16 == 0, 16 <= D <= 256 or D = 512, N <= 512, and over 256
// keys (O then lives across the chunks of keys) D <= 128; 16-byte aligned
// pointers (checked by the entry point)
__host__ __device__ constexpr bool takes(int n, int d) {
  return n >= 1 && n <= 512 && d >= 16 && d % 16 == 0 &&
         (d <= 256 || d == 512) && (n <= 256 || d <= 128);
}

}  // namespace wg

// Launch the wgmma variant on contiguous bf16 (b, n, d) q, k, v, o;
// cudaErrorInvalidValue for a call it does not take (wg::takes) or whose
// tensor maps cannot be encoded, else cudaGetLastError() after the launch.
int attention_wgmma(const void* q, const void* k, const void* v, void* o,
                    int b, int n, int d, float scale, cudaStream_t stream);
