"""K2: windowed attention forward, ``softmax(q k^T * scale) v``.

Replaces the Pallas TPU kernel ``tera_mind_tpu/ops/attention_kernel.py``
(``fused_attention``, ``_attn_kernel``).  q, k, v are ``(B, N, D)`` with
batch, heads and the 2x2 spatial windows folded into B; on the flagship
path N is 128 or 32 and D is 256 or 512, in bf16.  The model's scale is
``1 / head_dim`` (not 1/sqrt), passed by the caller.

Every variant keeps the TPU kernel's rounding: f32 logits, the exact
softmax (max-subtract, exp, divide by the row sum), p rounded to v's dtype
after it is normalised, f32 accumulation of p.v, one rounding of the
output.  ``attention_variant`` picks the variant from dtype, shape and
alignment before the launch (``csrc/attention.cu`` holds the designs):

- ``wgmma`` (``csrc/attention_wgmma.cu``, ``sm_90a``): bf16 with D % 16 ==
  0, D <= 256 or D = 512, N <= 512 (over 256 with D <= 128), 16-byte
  aligned q, k, v, o: every path shape, the main path's three among them.
  Hopper's own instructions: a producer warp keeps TMA loads of q and of
  K / V tiles in flight under mbarriers, two consumer warpgroups run
  ``wgmma`` (q.k^T from shared memory, p.v with p from registers) and the
  exact softmax in registers (two passes over K at N > 256), persistent
  blocks walk the batch indices.  ``wgmma_layout`` mirrors its plan.
- ``tensor_core``: bf16 with D % 16 == 0, N <= 128, 16-byte aligned
  q, k, v, and ``tc_smem_bytes(N, D)`` within a block's 227 KB.  One block
  per batch index keeps q, k, v in shared memory as bf16, computes q.k^T
  and p.v with ``mma.sync`` on the tensor cores and the softmax in
  registers.  The main-path shapes took it until ``wgmma``; it stays
  reachable by a forced ``variant=`` and takes any bf16 call ``wgmma``
  does not where it fits.
- ``tensor_core_tiled``: every other bf16 call with D % 16 == 0, N <= 512,
  D <= 512 and aligned q, k, v: N > 128, or N <= 128 with q, k, v over
  227 KB (``tiled_smem_bytes`` always fits); since ``wgmma`` those it
  does not take (256 < D < 512, or N > 256 with D > 128, such as the edge
  (2, 512, 512)) and any forced call.  A block takes 64 query rows (32
  for D > 256), streams K and then V through shared memory in row tiles,
  computes q.k^T and p.v with
  ``mma.sync`` and keeps the rows' f32 logits in shared memory for an
  exact softmax over all N keys, p written back over them as bf16.
- ``cuda_core``: float32, and bf16 with D not a multiple of 16 or
  misaligned pointers.  Float arithmetic on CUDA cores, 16 query rows per
  block, logits in shared memory.

K2b, the backward (``csrc/attention_bwd.cu``), replaces the TPU kernel's
``custom_vjp`` rule ``_bwd``: p recomputed in float32 and never rounded,
float32 sums, one rounding of dq, dk, dv; a dq pass over query tiles
that also writes each row's softmax statistics, then a dk/dv pass over
key tiles, each dq, dk and dv row summed inside one block
(deterministic).  ``attention_bwd_variant`` picks its variant:

- ``wgmma`` (``csrc/attention_bwd_wgmma.cu``, ``sm_90a``): bf16 with N
  <= 512 and D = 128, 256, 384 or 512, the seven tensors 16-byte
  aligned: every path shape and the edge (2, 512, 512).  Hopper's own instructions:
  a producer warp keeps TMA loads in flight under mbarriers, two consumer
  warpgroups run ``wgmma``, persistent blocks walk the batch indices.  At
  N <= 128 one fused pass: s and dp in registers, p and ds to shared
  memory as split pairs, then dq = ds k, dv = p^T g and dk = ds^T q from
  shared memory (no statistics); at N > 128 with D <= 256 a dq kernel
  (two sweeps over K and V: the rows' statistics, then dq) and a dk/dv
  kernel; at N > 128 with D > 256 the fused steps on 128 x 128 blocks
  with float32 partials, summed in block order by a last launch.
  ``wgmma_bwd_layout`` mirrors its plan.
- ``tensor_core``: bf16 with D % 16 == 0, N <= 128, q, k, v, g and the
  three gradients 16-byte aligned, and both passes' shared memory
  (``bwd_tc_smem_bytes``) within 227 KB.  q k^T and g v^T by ``mma.sync``
  on the bf16 inputs; every product with p or ds as two ``mma.sync`` on
  the split pair hi = bf16(x), lo = bf16(x - hi) into one f32
  accumulator, which keeps the f32 rule's rounding (a single bf16 operand
  changes 37-44 % of the outputs).  The training shapes took it until
  ``wgmma``; it stays reachable by a forced ``variant=`` and takes the
  bf16 calls ``wgmma`` refuses where it fits.
- ``tensor_core_tiled``: every other bf16 call with D % 16 == 0, N <= 512,
  D <= 512 and the seven tensors aligned (``bwd_tiled_smem_bytes`` always
  fits), such as N > 128 at D = 64.  The same passes, statistics and
  split pairs, with q, k, v, g streamed in row tiles: the dq pass holds 64
  or 32 query rows' f32 logits and dp = g v^T in shared memory, the dk/dv
  pass a tile of key rows and the query tiles of q and g in turn.
- ``cuda_core``: float32, and bf16 with D not a multiple of 16 or
  misaligned tensors; f32 ``fmaf`` on CUDA cores.
``window_attention`` dispatches as ``rmsnorm`` does: the raw K2 launch
without a gradient to record, :class:`AttentionFunction` (K2 and K2b, or
the plain versions on the CPU) with one.
"""

from __future__ import annotations

import sys

import torch

from . import _build

MAX_N = 512
MAX_D = 512
TC_MAX_N = 128
SMEM_LIMIT = 232_448       # bytes of shared memory a block may use (H100)
VARIANTS = ("cuda_core", "tensor_core", "tensor_core_tiled", "wgmma")
# (csrc/attention.cu codes; K2b, csrc/attention_bwd.cu, has the same four)
BWD_VARIANTS = VARIANTS

TC_ROWS = 64               # csrc/attention_bwd.cu kTcRows: a K2b block's rows

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)
bwd = _build.Counters(BWD_VARIANTS)   # K2b's (csrc/attention_bwd.cu)


def reset_launches() -> None:
    """Set K2's and K2b's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])
    _build.reset_launches(bwd)


def _calc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def tc_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the tensor-core variant (``tc_layout`` in
    csrc/attention.cu): q, k, v tiles of round16(N) rows of D + 8 bf16,
    and p (round16(N) rows of round16(N) + 8) over q when it fits."""
    np_ = (n + 15) // 16 * 16
    tile = np_ * (d + 8)
    p = np_ * (np_ + 8)
    return 2 * (3 * tile + (0 if p <= tile else p))


def tiled_layout(n: int, d: int) -> tuple[int, int, int, int]:
    """(query rows a block, K / V tile rows, stages, bytes) of K2's
    tiled variant (``tiled_layout`` in csrc/attention.cu): r = 64 rows
    (32 for D > 256) of f32 logits padded to round(N, kt) + 4, the q tile
    and ``stages`` K or V tiles of kt rows, rows of D + 8 bf16; the largest
    kt of 128, 64, 32 that fits twice, else once."""
    r = 64 if d <= 256 else 32
    for stages in (2, 1):
        for kt in (128, 64, 32):
            ns = -(-n // kt) * kt
            nbytes = (4 * r * (ns + 4) + 2 * r * (d + 8)
                      + stages * 2 * kt * (d + 8))
            if nbytes <= SMEM_LIMIT:
                return r, kt, stages, nbytes
    return r, kt, stages, nbytes


def tiled_smem_bytes(n: int, d: int) -> int:
    """Shared memory of K2's tensor_core_tiled variant."""
    return tiled_layout(n, d)[3]


WG_SLOT = 32 * 1024        # csrc/attention_wgmma.cuh wg::kSlot
WG_STAGES = 4              # wg::kStages: ring slots
WG_STAGE_BYTES = 8 * 16 * (64 * 2 + 16)   # wg::kStageBytes: 16 output
#                            rows of 64 columns a consumer warp, padded


def wgmma_takes(n: int, d: int) -> bool:
    """The (N, D) of a bf16 call K2's ``wgmma`` variant takes
    (``wg::takes``): D % 16 == 0 and 16 <= D <= 256 or D = 512, N <= 512,
    and D <= 128 over 256 keys (where O lives across the chunks of
    keys)."""
    return (1 <= n <= MAX_N and 16 <= d <= MAX_D and d % 16 == 0
            and (d <= 256 or d == 512) and (n <= 256 or d <= 128))


def wgmma_layout(n: int, d: int) -> dict:
    """K2 ``wgmma``'s plan (``wg::layout`` in csrc/attention_wgmma.cuh):
    64-column slabs of D; for D = 512 both consumer warpgroups take the
    same 64 query rows and half the slabs each (``dsplit``), else 64 rows
    each of a 128-row unit; key tiles of ``kt`` keys (128, 64 at D = 512),
    ``nt`` of them a chunk whose logits stay in registers (all of N up to
    256 keys, else one tile, with a first pass over K for the rows' max
    and sum); p.v in ``passes`` of ``nh`` slabs, V loaded a pass at a
    time; ``kslabs`` slabs of a K tile a 32 KB ring slot (4 slots); the q
    tile; and the dynamic shared memory with 1,024 bytes of alignment
    slack, the output staging and the barriers."""
    slabs = -(-d // 64)
    dsplit = d > 256
    rows = 64 if dsplit else 128
    kt = 64 if dsplit else 128
    per = slabs // 2 if dsplit else slabs
    nh = 1 if per == 1 else 2
    passes = -(-per // nh)
    tiles = -(-n // kt)
    nt = tiles if tiles * kt <= 256 else 1
    chunks = -(-tiles // nt)
    q_bytes = slabs * rows * 128
    return dict(slabs=slabs, dsplit=dsplit, rows=rows, kt=kt, per=per,
                nh=nh, passes=passes, tiles=tiles, nt=nt, chunks=chunks,
                kslabs=WG_SLOT // (kt * 128), q_bytes=q_bytes,
                smem=(1024 + q_bytes + WG_STAGES * WG_SLOT + WG_STAGE_BYTES
                      + (2 * WG_STAGES + 2) * 8))


def _takes_tensor_cores(n: int, d: int, dtype: torch.dtype,
                        aligned: bool) -> bool:
    return (dtype == torch.bfloat16 and aligned and 1 <= n <= MAX_N
            and d % 16 == 0 and 16 <= d <= MAX_D)


def attention_variant(n: int, d: int, dtype: torch.dtype,
                      aligned: bool) -> str:
    """The variant a CUDA call with these N, D, dtype and pointer
    alignment (all 16-byte aligned or not) launches."""
    if not _takes_tensor_cores(n, d, dtype, aligned):
        return "cuda_core"
    if wgmma_takes(n, d):
        return "wgmma"
    return replaced_variant(n, d)


def replaced_variant(n: int, d: int) -> str:
    """The ``mma.sync`` variant a bf16 call with aligned tensors took
    before ``wgmma`` (and takes where ``wgmma`` does not):
    ``tensor_core`` for N <= 128 where q, k, v fit, else
    ``tensor_core_tiled``."""
    if n <= TC_MAX_N and tc_smem_bytes(n, d) <= SMEM_LIMIT:
        return "tensor_core"
    return "tensor_core_tiled"


def bwd_tc_smem_bytes(n: int, d: int) -> tuple[int, int]:
    """Shared memory of K2b's tensor-core passes (``bwd_tc_layout`` in
    csrc/attention_bwd.cu), (dq pass, dk/dv pass).  np = round16(N) and
    rt = min(64, np) rows a block; q, k, v, g rows of D + 8 bf16, p and
    ds rows of np + 8.  dq: q and g tiles (rt rows), k and v (np rows),
    ds hi and lo (rt rows) over q and g when np <= D, else after v, and
    3 x 2 x 64 floats.  dk/dv: q and g (np rows), the k and v tiles,
    p^T and ds^T (hi and lo, rt rows each) over them or past them, and
    3 x np floats."""
    np_ = (n + 15) // 16 * 16
    rt = min(TC_ROWS, np_)
    tile, full, ds = rt * (d + 8), np_ * (d + 8), 2 * rt * (np_ + 8)
    dq = 2 * tile + 2 * full + (0 if ds <= 2 * tile else ds)
    kv = 2 * full + max(2 * ds, 2 * tile)
    return 2 * dq + 4 * 6 * TC_ROWS, 2 * kv + 4 * 3 * np_


def dq_tiled_layout(n: int, d: int) -> tuple[int, int, int, int]:
    """(query rows a block, K / V tile rows, stages, bytes) of K2b's tiled
    dq pass (``dq_tiled_layout`` in csrc/attention_bwd.cu): the f32 logits
    and dp of r query rows padded to round(N, kt) + 4, one q or g tile and
    ``stages`` K or V tiles of kt rows, rows of D + 8 bf16; r = 64 for D
    <= 256 where it fits, else 32."""
    for r in ((64, 32) if d <= 256 else (32,)):
        for stages in (2, 1):
            for kt in (128, 64, 32):
                ns = -(-n // kt) * kt
                nbytes = (2 * 4 * r * (ns + 4) + 2 * r * (d + 8)
                          + stages * 2 * kt * (d + 8))
                if nbytes <= SMEM_LIMIT:
                    return r, kt, stages, nbytes
    return r, kt, stages, nbytes


def kv_tiled_layout(d: int) -> tuple[int, int, int, int]:
    """(key rows a block, query tile rows, stages, bytes) of K2b's tiled
    dk/dv pass (``kv_tiled_layout``): kr = 16 x (16 // ceil(D / 64))
    rows of k and v (at most 64), ``stages`` stages of a q and a g tile of
    qt rows and their 3 x qt f32 statistics, and p^T, ds^T as split pairs
    (kr rows of qt + 8 bf16 each, four arrays)."""
    kr = min(64, 16 * (16 // -(-d // 64)))
    for stages in (2, 1):
        for qt in (64, 32):
            nbytes = (4 * kr * (d + 8) + stages * (4 * qt * (d + 8) + 12 * qt)
                      + 8 * kr * (qt + 8))
            if nbytes <= SMEM_LIMIT:
                return kr, qt, stages, nbytes
    return kr, qt, stages, nbytes


def bwd_tiled_smem_bytes(n: int, d: int) -> tuple[int, int]:
    """Shared memory of K2b's tensor_core_tiled passes, (dq, dk/dv)."""
    return dq_tiled_layout(n, d)[3], kv_tiled_layout(d)[3]


WGB_STAGE_BYTES = 8 * 16 * (64 * 2 + 16)   # wgb::kStageBytes
WGB_FIXED = 1024 + WGB_STAGE_BYTES + 512     # alignment, staging, barriers
WGB_MAX_FUSED_N = 128      # wgb::kMaxFusedN
WGB_MAX_STAGES = 16        # wgb::kMaxStages (two-pass ring slots)
WGB_STATS_BYTES = 512 * 16   # wgb::kStatsBytes: (m, l, 1 / l, D) of N rows


def wgmma_bwd_layout(n: int, d: int) -> dict:
    """K2b ``wgmma``'s plan (``wgb::layout`` in
    csrc/attention_bwd_wgmma.cuh).  ``fused`` (N <= 128): a unit is 128
    tile rows, one batch index (``bpu`` 1, N > 64) or 64 rows of two
    (``bpu`` 2); the split pairs of p and ds in four arrays of ``ks``
    64-key slabs of 128 rows (``split_bytes``); a ring of ``stages`` slots
    of two 64-column slabs of 128 rows (32 KB), up to 4.  ``blocked`` (N >
    128 with D > 256): the fused plan at ``bpu`` 1 on units of 128 query
    rows x 128 keys, ``tiles`` 128-row blocks of N.  Two-pass (N > 128, D
    <= 256): q and g (dq kernel) or k and v (dk/dv kernel) of 128 rows held
    whole (``held``), slots of ``sps`` slabs of 64 rows x 64 columns (a
    whole 64-row tile at D = 128, else one slab), up to 16, and a batch
    index's statistics (8 KB); 64-row ``tiles`` of N.  ``halves``:
    128-column halves of D.  ``smem``: the dynamic shared memory with
    1,024 bytes of alignment slack, the output staging and 512 bytes of
    barriers."""
    slabs = -(-d // 64)
    halves = -(-slabs // 2)
    if n <= WGB_MAX_FUSED_N or d > 256:
        blocked = n > WGB_MAX_FUSED_N
        bpu = 1 if n > 64 else 2
        ks = 2 if bpu == 1 else 1
        split = 4 * ks * 128 * 128
        slot = 2 * 128 * 128
        stages = min(4, (SMEM_LIMIT - WGB_FIXED - split) // slot)
        return dict(fused=True, blocked=blocked, slabs=slabs, halves=halves,
                    bpu=bpu, nk=64 * ks, ks=ks, split_bytes=split,
                    slot=slot, stages=stages, held=0,
                    tiles=-(-n // 128) if blocked else 1, sps=2,
                    smem=WGB_FIXED + split + stages * slot)
    held = 2 * slabs * 128 * 128
    sps = 2 if slabs == 2 else 1
    slot = sps * 64 * 128
    stages = min(WGB_MAX_STAGES,
                 (SMEM_LIMIT - WGB_FIXED - held - WGB_STATS_BYTES) // slot)
    return dict(fused=False, blocked=False, slabs=slabs, halves=halves,
                bpu=1, nk=64, ks=1, split_bytes=0, slot=slot, stages=stages,
                held=held,
                tiles=-(-n // 64), sps=sps,
                smem=WGB_FIXED + held + WGB_STATS_BYTES + stages * slot)


def wgmma_bwd_hsplit(b: int, n: int, d: int, sms: int = 132) -> int:
    """Blocks that share a fused (or blocked) unit's 128-column halves of
    D (``wgb::fused_hsplit``): the largest power of two dividing the
    halves with units x it <= the card's SMs (132 on an H100), each block
    recomputing the unit's logits; 1 for the two-pass design."""
    lay = wgmma_bwd_layout(n, d)
    if not lay["fused"]:
        return 1
    units = (b * lay["tiles"] ** 2 if lay["blocked"]
             else b if lay["bpu"] == 1 else -(-b // 2))
    h = 1
    while lay["halves"] % (2 * h) == 0 and units * 2 * h <= sms:
        h *= 2
    return h


def wgmma_bwd_takes(n: int, d: int) -> bool:
    """The (N, D) of a bf16 call K2b's ``wgmma`` variant takes
    (``wgb::takes``): N <= 512 and D = 128, 256, 384 or 512 (fused at N <=
    128, two-pass at N > 128 with D <= 256, blocked above), with a ring of
    at least two slots."""
    return (1 <= n <= MAX_N and 128 <= d <= MAX_D and d % 128 == 0
            and wgmma_bwd_layout(n, d)["stages"] >= 2)


def wgmma_bwd_scratch_floats(b: int, n: int, d: int) -> int:
    """Float32 scratch of a ``wgmma`` call (``wgb::scratch_floats``): the
    (B, N, 3) statistics, or at N > 128 with D > 256 (blocked) each (batch
    index, key block) pair's row statistics, padded to 16 bytes, and
    three sets of float32 partials, one a 128-row block, of (B, N, D)."""
    if not wgmma_bwd_layout(n, d)["blocked"]:
        return b * n * 3
    nb = -(-n // 128)
    return -(-(b * nb * n * 3) // 4) * 4 + 3 * nb * b * n * d


def replaced_bwd_variant(n: int, d: int) -> str:
    """The ``mma.sync`` variant a bf16 call with aligned tensors took
    before K2b ``wgmma`` (and takes where ``wgmma`` does not):
    ``tensor_core`` for N <= 128 where both passes fit, else
    ``tensor_core_tiled``."""
    if n <= TC_MAX_N and max(bwd_tc_smem_bytes(n, d)) <= SMEM_LIMIT:
        return "tensor_core"
    return "tensor_core_tiled"


def attention_bwd_variant(n: int, d: int, dtype: torch.dtype,
                          aligned: bool) -> str:
    """The K2b variant a CUDA call with these N, D, dtype and pointer
    alignment (q, k, v, g, dq, dk, dv all 16-byte aligned or not)
    launches."""
    if not _takes_tensor_cores(n, d, dtype, aligned):
        return "cuda_core"
    if wgmma_bwd_takes(n, d):
        return "wgmma"
    return replaced_bwd_variant(n, d)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 logits and softmax, p rounded to v's
    dtype, f32 accumulation of p.v, output in q's dtype."""
    f = _calc_dtype(q.dtype)
    logits = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.to(f), v.to(f)).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2b, the JAX rule ``_bwd`` term for term:
    (dq, dk, dv) in the inputs' dtypes, computed in float32 with p
    recomputed and not rounded."""
    f = _calc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(f) for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be equal (B, N, D)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    _, n, d = q.shape
    if n > MAX_N or d > MAX_D:
        raise ValueError(f"{name}: N={n}, D={d} above the kernel's limits "
                         f"N<={MAX_N}, D<={MAX_D}")


def _forced(variant: str | None, rule: str, name: str,
            variants: tuple = VARIANTS) -> str:
    """The variant to launch: the shape rule's, or ``variant`` (the C
    entry point refuses one that cannot take the call)."""
    if variant is None:
        return rule
    if variant not in variants:
        raise ValueError(f"{name}: no variant {variant!r}")
    return variant


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, variant: str | None = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors of shape (B, N, D) and one dtype, in the
    variant the shape rule names or in ``variant`` (a timing of the
    variant a shape used to take).  Raises when autograd would need a
    backward (``_build.autograd_required``)."""
    _build.refuse_autograd("window_attention", q, k, v)
    _check_qkv("window_attention", q, k, v)
    b, n, d = q.shape
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    if b == 0:
        return o
    code = _build.dtype_code(q, "window_attention")
    variant = _forced(variant, attention_variant(
        n, d, q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v, o))),
        "window_attention")
    err = _build.lib().tmt_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, d,
        scale, code, VARIANTS.index(variant), _build.stream_ptr(q))
    _build.check(err, f"tmt_window_attention ({variant})")
    _build.count_launch(sys.modules[__name__], variant)
    return o


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, scale: float,
                       variant: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2b on CUDA tensors of shape (B, N, D) and one dtype:
    (dq, dk, dv), in the shape rule's variant or in ``variant``.  g,
    which reaches the backward through the window fold's reshapes and
    transposes, is made contiguous first."""
    _check_qkv("window_attention_bwd", q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"window_attention_bwd: g {tuple(g.shape)} "
                         f"{g.dtype} is not q's {tuple(q.shape)} {q.dtype}")
    b, n, d = q.shape
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if b == 0:
        return dq, dk, dv
    code = _build.dtype_code(q, "window_attention_bwd")
    variant = _forced(variant, attention_bwd_variant(
        n, d, q.dtype,
        all(t.data_ptr() % 16 == 0 for t in (q, k, v, g, dq, dk, dv))),
        "window_attention_bwd", BWD_VARIANTS)
    # the dq pass's (B, N, 3) statistics, or wgmma's scratch
    stats = torch.empty(
        wgmma_bwd_scratch_floats(b, n, d) if variant == "wgmma"
        else b * n * 3, device=q.device, dtype=torch.float32)
    err = _build.lib().tmt_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, n, d, scale, code, BWD_VARIANTS.index(variant),
        _build.stream_ptr(q))
    _build.check(err, f"tmt_window_attention_bwd ({variant})")
    _build.count_launch(bwd, variant)
    return dq, dk, dv


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"window_attention: no path for device {q.device}")
    return q.device.type


class AttentionFunction(torch.autograd.Function):
    """K2 forward and K2b backward on CUDA tensors; the plain forward and
    the plain ``_bwd`` formula on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if _device_type(q) == "cuda":
            return attention_cuda(q, k, v, scale)
        return attention_plain(q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bwd_fn = attention_bwd_cuda if q.device.type == "cuda" \
            else attention_bwd_plain
        grads = bwd_fn(q, k, v, g.to(q.dtype), ctx.scale)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """K2 for CUDA tensors, the plain version for CPU tensors; through
    :class:`AttentionFunction` (K2b or the plain backward) when autograd
    has a gradient to record."""
    dev = _device_type(q)
    if _build.autograd_required(q, k, v):
        return AttentionFunction.apply(q, k, v, scale)
    if dev == "cuda":
        return attention_cuda(q, k, v, scale)
    return attention_plain(q, k, v, scale)
