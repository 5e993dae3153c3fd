// K2b's wgmma variant (csrc/attention_bwd_wgmma.cu): the calls it takes,
// its two designs' shared-memory plans, and its launcher, which the entry
// point tmt_window_attention_bwd (csrc/attention_bwd.cu) calls.
// ops/attention_kernel.py::wgmma_bwd_takes and wgmma_bwd_layout mirror
// takes() and layout().
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace wgb {

constexpr int kSlab = 64;                 // D columns a 128-byte slab
constexpr int kBoxRows = 64;              // rows of a TMA box (one batch
                                          // index's rows, zeros past N)
constexpr int kConsumerWarps = 8;         // warpgroups 1-2
constexpr int kStageRow = 64 * 2 + 16;    // a staged output row, padded
constexpr int kStageBytes = kConsumerWarps * 16 * kStageRow;
constexpr int kBarrierBytes = 512;
constexpr int kMaxFusedN = 128;           // the fused design's keys
constexpr int kMaxStages = 16;
constexpr int kStatsBytes = 512 * 16;     // a batch index's statistics as
                                          // (m, l, 1 / l, D), two-pass

// fused (N <= 128): one pass a unit.  A unit is 128 tile rows: all rows
// of one batch index (N > 64, bpu 1) or 64 rows of each of two (bpu 2);
// consumer warpgroup c takes tile rows 64 c .. 64 c + 63 as queries and
// as keys.  p and ds of the unit stay in shared memory as split pairs,
// four arrays (p hi, p lo, ds hi, ds lo) of ks 64-key slabs of 128 rows;
// q, k, v and g stream through a ring of slots of two 64-column slabs of
// 128 rows.
// blocked (128 < N <= 512, D > 256): the fused steps on units of 128
// query rows x 128 keys of a batch index (the fused plan at bpu 1), each
// row's statistics from a first launch over the same units, float32
// partial outputs a block, and a launch that sums them.
// two-pass (128 < N <= 512, D <= 256): a dq kernel over units of 128
// query rows (64 a consumer) and one 128-column half of D, q and g held
// whole (2 slabs x 128 rows each), K and V streamed in 64-key slabs; then
// a dk/dv kernel over units of 128 keys, one half of D and one output (dv
// or dk), k (and for dk v) held whole, q and g streamed in 64-query
// slabs, the batch index's statistics staged as (m, l, 1 / l, D).
struct Layout {
  bool fused;     // the fused plan (also the blocked design's)
  bool blocked;   // N > 128 with D > 256: 128 x 128 blocks
  int slabs;      // ceil(D / 64)
  int halves;     // 128-column halves of D: passes (fused) or units
  // fused
  int bpu;        // batch indices a unit: 1 (N > 64) or 2
  int nk;         // keys a consumer's logits span: 128 or 64
  int ks;         // 64-key slabs of a p / ds array (nk / 64)
  int split_bytes;  // the four arrays
  // both
  int slot;       // bytes of a ring slot
  int stages;     // ring slots
  int held;       // bytes of the tiles held for a unit (two-pass)
  int tiles;      // two-pass: 64-row tiles of N (key or query tiles);
                  // blocked: 128-row blocks of N; fused: 1
  int sps;        // two-pass: 64-column slabs of a tile a slot, 2 at D =
                  // 128 (a whole tile), else 1
  int smem;       // dynamic shared memory, 1,024 bytes of alignment slack,
                  // the output staging and the barriers included
};

__host__ __device__ constexpr Layout layout(int n, int d) {
  const int slabs = (d + kSlab - 1) / kSlab;
  const int halves = (slabs + 1) / 2;
  const int fixed = 1024 + kStageBytes + kBarrierBytes;
  if (n <= kMaxFusedN || d > 256) {
    const bool blocked = n > kMaxFusedN;
    const int bpu = n > 64 ? 1 : 2;
    const int nk = bpu == 1 ? 128 : 64;
    const int ks = nk / 64;
    const int split = 4 * ks * 128 * 128;
    const int slot = 2 * 128 * 128;
    int stages = (kMaxBlockSmem - fixed - split) / slot;
    stages = stages > 4 ? 4 : stages;
    return Layout{true, blocked, slabs, halves, bpu, nk, ks, split, slot,
                  stages, 0, blocked ? (n + 127) / 128 : 1, 2,
                  fixed + split + stages * slot};
  }
  const int held = 2 * slabs * 128 * 128;
  const int sps = slabs == 2 ? 2 : 1;
  const int slot = sps * kBoxRows * 128;
  int stages = (kMaxBlockSmem - fixed - held - kStatsBytes) / slot;
  stages = stages > kMaxStages ? kMaxStages : stages;
  return Layout{false, false, slabs, halves, 1, 64, 1, 0, slot, stages,
                held,
                (n + 63) / 64, sps,
                fixed + held + kStatsBytes + stages * slot};
}

// fused: how many blocks share a unit's 128-column halves of D, each
// taking halves / hsplit of them after computing the unit's logits: the
// largest power of two dividing the halves with units x hsplit <= sms (a
// small B, such as (32, 128, 512), fills the SMs; B >= sms splits none)
__host__ __device__ constexpr int fused_hsplit(long long units, int halves,
                                               int sms) {
  int h = 1;
  while (halves % (2 * h) == 0 && units * 2 * h <= sms) h *= 2;
  return h;
}

// bf16 with N <= 512 and D = 128, 256, 384 or 512, every 128-column half
// of D whole (16-byte aligned pointers, checked by the entry point): the
// fused design at N <= 128, the two-pass one for N > 128 at D <= 256,
// the blocked one above
__host__ __device__ constexpr bool takes(int n, int d) {
  return n >= 1 && n <= 512 && d >= 128 && d <= 512 && d % 128 == 0 &&
         layout(n, d).stages >= 2;
}

// floats of the scratch a call needs (`stats`): the two-pass design's
// (B, N, 3) statistics; the blocked design's per-block statistics and
// three sets of float32 partials (csrc/attention_bwd_wgmma.cu Scratch)
__host__ __device__ constexpr long long scratch_floats(int b, int n, int d) {
  return !layout(n, d).blocked
             ? (long long)b * n * 3
             : ((long long)b * ((n + 127) / 128) * n * 3 + 3) / 4 * 4 +
                   3LL * ((n + 127) / 128) * b * n * d;
}

static_assert(takes(128, 256) && takes(32, 512) && takes(128, 512) &&
                  takes(64, 512) && takes(256, 256) && takes(512, 128) &&
                  takes(512, 512) && !takes(513, 128) && !takes(100, 48) &&
                  layout(512, 512).blocked && layout(512, 512).tiles == 4 &&
                  !layout(512, 256).blocked && !layout(128, 512).blocked &&
                  layout(128, 256).stages == 2 &&
                  layout(32, 512).stages == 4 &&
                  layout(512, 128).stages == 8 &&
                  layout(512, 128).sps == 2 && layout(256, 256).sps == 1 &&
                  layout(256, 256).stages == 8 &&
                  layout(128, 256).smem == 216576 &&
                  layout(256, 256).smem == 224768 &&
                  layout(512, 128).smem == 224768 &&
                  layout(512, 128).stages >= 2 * 2 &&
                  layout(256, 256).stages >= 2 * 4,
              "the path shapes' plans (ops/attention_kernel.py mirrors)");
static_assert(fused_hsplit(32, 4, 132) == 4 && fused_hsplit(64, 2, 132) == 2 &&
                  fused_hsplit(128, 4, 132) == 1 &&
                  fused_hsplit(256, 4, 132) == 1,
              "the halves split at (32, 128, 512) and (64, 128, 256) only");

}  // namespace wgb

// Launch the wgmma variant on contiguous bf16 (b, n, d) q, k, v, g and
// dq, dk, dv; stats (b x n x 3 float32: row max, row sum, D) is written
// and read by the two-pass design only.  cudaErrorInvalidValue for a call
// it does not take (wgb::takes) or whose tensor maps cannot be encoded,
// else cudaGetLastError() after the launches.
int attention_bwd_wgmma(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        float* stats, int b, int n, int d, float scale,
                        cudaStream_t stream);
