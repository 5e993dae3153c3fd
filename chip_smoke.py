#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printed on its own line with elapsed seconds:
  1. the card (nvidia-smi name and power limit; compute capability 9.0);
  2. build the CUDA kernels (plain nvcc into a .so, loaded with ctypes);
  3. hold each kernel against its plain PyTorch version at every main
     path shape in bf16 (and each variant at edge shapes; the large
     random inputs of phases 3-5, 18 and 19 are drawn on the card from
     seeds of the phase's generator), and time the
     kernel, the plain version and one PyTorch library call doing the
     same function (a yardstick only: the port never calls it) on the
     device (CUDA graph replay), beside the card's bound for the work;
     K1 also at the extraction's (3,664, 64) in float32; K2 takes
     ``wgmma`` at every path shape, and each row also holds the
     ``mma.sync`` variant the shape took before (forced) against the plain
     version; K5 (``grouped_rmsnorm``, the packed model's GroupedRMSNorm)
     at every (rows, segments, Z) of the block-major chain
     (``scripts/kernel_shapes.py``; bf16 bit-equal to its plain version
     but on planes whose inv_z lies within ``K5_BOUNDARY`` of a bf16
     rounding boundary, there K1's gate; f32 1e-5), each also with the
     epilogue its launches take there (the SiLU, or the adaLN modulate
     and the SiLU: against the plain sequence off those planes and
     against the plain epilogue on K5's own norm everywhere, within
     ``K5_MAX_ULP``) and timed so, one single-segment norm beside
     ``F.rms_norm``, and at ``K5_EDGE`` (each also with the SiLU, one
     segment also with the modulate at one row a batch, one at a
     misaligned start, each single segment also with a conv's bias), with
     the C entry point's refusals; each ``out_norm`` row (the modulate)
     with in_conv's bias as K5's prologue, as the chain launches it; K6
     (``residual``, the packed ResBlock's residual sum with out_conv's
     and skip_conv's biases) at every (rows, width, skip) of the
     block-major chain, bf16 and float32 bit-equal to its plain version
     (the eager bias adds and sum), timed beside its byte bound and the
     plain sequence (no library call computes it), and at ``K6_EDGE``
     (widths not a multiple of 8, misaligned, zero rows, float32) with
     the wrapper's and the C entry point's refusals; the folded
     ResBlock bit-equal to the eager one on the card at main-path
     widths; K1 with the DiT blocks' adaLN modulate (``rmsnorm_modulate``)
     and K7 (``gated_residual``, the DiT block's ``xt + gate * y``) at
     every (rows, C) of the block-major chain, bf16 and float32, on the
     DiT block's layout (scale, shift and gate strided chunks of a
     (rows, 7C) adaLN output): K7 bit-equal to its plain version, K1's
     modulate bit-equal to the plain modulate of its own norm (which is
     K1's, within K1's gate of the plain norm); timed beside their byte
     bound, the plain sequence, K1 then the eager modulate, and for K7
     ``torch.addcmul``; at ``DIT_EDGE`` with the wrappers' and the C
     entry points' refusals; the folded DiT block bit-equal to the eager
     one on the card at the chain's widths and token counts;
  4. the backward kernels K1b and K2b, each variant (K1b ``vector`` and
     ``strided``, K2b ``wgmma``, ``tensor_core``, ``tensor_core_tiled``
     and ``cuda_core``) against its plain
     version at every shape of a training step (``scripts/kernel_shapes.py
     --train``) in bf16 and f32 and at edge shapes, randn and peaked for
     K2b (``wgmma`` at every training shape, each row also holding the
     ``mma.sync`` variant the shape took before, forced, against the plain
     version), each run twice for bit-equal results, and timed against their
     bound, their plain version and a library yardstick (PyTorch autograd
     through ``F.rms_norm`` or SDPA); the C entry points' refusal of a
     variant that cannot take a call; then the autograd guard: each raw
     forward launcher refuses a CUDA input that requires grad under grad
     mode and runs under ``torch.no_grad()``, and each dispatcher records
     its backward (one forward and one backward launch, finite
     gradients); K5b at every shape of a packed training microbatch (K5
     forward there with the float32 5D weight) and at ``K5_EDGE``, bf16
     and f32, both weight layouts, twice for bit-equal dx and dw;
  5. int8: K3 (``quant_conv``) in both variants (``wgmma``, the one
     every main-path shape takes, and PR 10's ``mma_sync``) bit-equal to
     its plain version in int32, bf16 and f32, with each shape's plan
     (``ops/quant_kernel.py::k3_plan``: TMA box, BN, grid) logged,
     and K4 (``quantize``, one launch) bit-equal (int8 values, scale,
     abs-max) dynamic and static, at every int8 shape of the main path
     (``scripts/kernel_shapes.py --quant int8``) and at edge shapes (a
     deep concat at B = 2, Ci = 18 with Co = 24 in 3x3 and 1x1, 105
     rows of a 5x7 image, which only ``mma_sync`` takes; K4: ties that
     round to even, a saturating outlier, f32, a NaN, a tensor at a
     2-byte offset), each timed against its bound and its plain version
     (K3's two variants beside cuDNN's bf16 convolution of the same
     shape, the time int8 has to beat; each kernel's sum over a 2x2
     step); the C entry points' refusals; then the small chain in int8
     (prequantized, DiT denses too) on the card against the CPU and
     against the card's f32 chain, and int8_static calibrated on the
     card, at tests/test_quant.py's chain gates; prequant bit-equal to
     dynamic on one UNet call on the card;
  6. the port on a small input on the card (float32, kernels on) against
     the same code on the CPU (plain versions), for the 5D model; the
     packed model (its weights packed from the 5D model's) on the card
     against the CPU, against the 5D model and with ``packed_attn``;
  7. resume on the card: the small packed chain spilled every step
     through ``StateCheckpoint('grid')`` and resumed from its epoch-1
     spill, against the uninterrupted chain;
  8. streaming and the tile-major step on the small f32 input on the
     card: a 3x3 grid in 2x2 windows (edge windows shifted inward),
     streamed tile-major and block-major against the in-memory run of
     the same step, the in-memory tile-major step against the
     block-major one, K = 2 against K = 1, the worker pipeline against
     one sequential sweep, memmapped against in-memory state, a streamed
     run resumed from its epoch-1 spill, and bf16 transfers against f32;
  9. the main path: ``cli.generate.build`` with its defaults (the packed
     model) at the full width of the 638850 preset (2x2 tiles of 256^2 px
     x 100 channels, 5 DDIM steps, bf16, block-major, window_chunk -1,
     which the memory planner resolves to the whole block and one
     z-window a call), one warm-up step that plans, then one timed chain
     with the kernels' launch counters (total and per variant) set to 0
     just before it; then the same with ``--quant int8`` and ``--quant
     int8_static`` (its build calibrates on the 2x2 block, timed with the
     build), each with exact K3 and K4 launches by
     variant (75 wgmma and 117 dynamic or static a UNet call), tiles/s
     beside the bf16 chain's and int8's output against bf16's
     (informative); then the 5D model (``--no_packed``, 5 steps since PR
     16) on the same weights and the tile-major step (``--tile_major``,
     window_chunk 5; 5 steps since PR 13); a shallower chain's tiles/s
     is a 15-step equivalent;
 10. the planner at full width: its plan, the measured peak of its probe
     and the budget for 2x2, 4x4, 8x8 and 16x16 grids;
 11. whole-brain streaming: ``cli.generate.main`` with ``--stream`` at
     its defaults (2x2-tile windows, K 1, f32 transfers, 3 windows in
     flight, 4 GB of device gene cache, window_chunk 5) on a 4x4 grid,
     2 steps, with the counters set to 0 just before it; then a 2-step
     run of the same grid with ``TMT_STREAM_TIMING`` for its per-phase
     seconds;
 12. training, small: one accumulated f32 train step of a narrow model on
     the card against the CPU from the same weights, batch and draws
     (loss 1e-4, gradients 2e-3 of each leaf's max);
 13. training at full width: ``cli.train``'s builder on the 638850 preset
     (``--synthetic --batch 32``: accum 2, 128 patches a microbatch, bf16
     compute, f32 params, dropout 0.1), the 5D model, then ``--packed``,
     4 steps each with the counters set to 0 just before ``fit``: finite
     losses, changed parameters, exact K1 / K1b / K2 / K2b launches a
     step (K1b and K2b by variant), samples/s, data wait, peak memory;
     save -> restore bit-equal;
     ``cli.generate`` (1x1 grid, 2 steps) from the 5D run's checkpoint;
 14. gene-gene attention extraction: ``cli.attn --calc_attn --synthetic
     --pathway ROI --roi 0`` (16x16 tiles) from the 5D training run's
     checkpoint, with the counters set to 0 just before it: 256 float16
     tiles, exactly 1,024 K1 launches (4 a tile, all ``vector``), the
     ensemble's rows summing to 1; two tiles recomputed on the CPU
     (attention 1e-5, stored tiles within one float16 spacing); tiles/s;
 15. evaluation: the full-width bf16 packed and int8 chains' 2x2 outputs as
     two tile stores, ``python -m tera_mind_tpu_torch.cli.evaluate`` as a
     subprocess (PyTorch's default TF32 flags) with ``--features pool``,
     card against ``--device cpu`` (psnr / ssim / ms_ssim 1e-5 relative,
     pool_fid and statistics equal), then ``--features inception`` and
     ``--features torchscript`` on a traced random-weight InceptionV3,
     card and CPU (d_fid 1e-4 relative); int8's PSNR/SSIM against bf16;
 16. the baselines: for patch-dm and sinf, a narrow f32 model's forward
     (1e-4 of the output's max) and one accumulated train step (phase
     12's gates) on the card against the CPU; then ``cli.train``'s
     builder at full width with ``--method patch-dm`` and ``--method
     sinf`` (float32 compute outside the RNA tower, as JAX's promotions
     give), 3 steps each with the counters set to 0 just
     before ``fit``:
     finite losses, changed parameters, exactly 4 K1 and 4 K1b launches a
     step (the RNA tower's gene block) and no K2 or K2b, save -> restore
     bit-equal; ``cli.generate --no_packed`` (1x1 grid, 2 steps) from the
     patch-dm checkpoint; the refusals where the JAX package fails (sinf
     generation, a packed baseline);
 17. generation over several ranks (``torch.distributed``, one rank a
     process): 2 ranks sharing the card over gloo (strips staged through
     pinned host memory), or with more cards up to 4 ranks over NCCL,
     one card each, the backend required to be the one
     ``parallel/mesh.py``'s rule gives; each rank's planner budget
     (``TMT_HBM_BYTES``) the card's memory over the ranks sharing it.
     Small f32 checks on the card, each rank against the same work in
     one process (``SMALL_ATOL``): the halo exchange of position-encoding
     blocks bit-equal, one sharded block-major step of the small packed
     model on an (N, 1) mesh, band streaming K = 1 and K = 2; then
     ``mp_demo --device cuda --band`` over 2 ranks.  Full width:
     ``cli.generate.main`` over 2 ranks in memory (2x2 tiles, 5 steps,
     the weights, noise and genes of phase 9's packed chain), the union
     of the rank blocks against phase 9's output by ``CHAIN_GATES``, each
     rank's K1 and K2 launches required (``scripts/kernel_shapes.py
     --ranks 2``), tiles/s per rank and in all, the halo's bytes and
     seconds an exchange, each rank's peak device memory; then
     ``--stream`` over 2 ranks on the 4x4 grid, 2 steps, against phase
     11's 2-step one-process run; with two cards or more, ``--stream``
     through every card in one process (``devices=``);
 18. data-parallel training over ranks (``cli.train`` and ``Trainer``
     with a ``('dp',)`` mesh of ranks; 2 ranks sharing the card over gloo,
     or a card a rank over NCCL, the backend required to be the rule's):
     K1, K1b, K2 and K2b against their plain versions at a rank's
     training shapes (``scripts/kernel_shapes.py --train --ranks N``),
     each variant required and timed beside its bound; ``mp_demo
     --train_only`` (the tiny f32 model, 3 steps, the clip by global
     norm triggering) over the ranks against ``train_ref`` in one
     process on the card (2e-5), the replicas' parameters and Adam
     moments bit-equal after every step; the 5D model at full width
     (global batch 32 in 2 microbatches, dropout 0) for 3 steps over the
     ranks against one process on the same weights, batches and draws
     (``DP_LOSS_ATOL``), the parameters bit-equal across ranks after
     every step, each rank's K1 / K1b / K2 / K2b launches (and K1b's and
     K2b's by variant) the one-process step's, samples/s in all and a
     rank, the all-reduce's bytes and seconds a step, each rank's peak
     memory; ``cli.train.main --synthetic --max_steps 2`` over the ranks
     with the preset's dropout: one checkpoint, written by rank 0, a
     finite loss, the parameters equal across ranks;
 19. the other published presets (``PRESETS``: 609882's 500 genes;
     609889 with the 81-gene M2H panel at patch 128; patch 32, one stain
     and 16 RNA slices): K1, K1b, K2, K2b, K3 and K4 at every shape of
     this phase's runs that phases 3-5 do not check
     (``scripts/kernel_shapes.py``'s predictions), by their per-shape
     checks and timings, the variant each shape's rule names required
     (K2 and K2b ``wgmma`` at (B, 128, 512), (B, 512, 128) and, from the
     8-RNA-slice preset of ``PRESET_KERNELS_ONLY``, (B, 256, 256), the
     ``tensor_core_tiled`` variant each took before checked forced);
     each preset's small f32 chain (5D card vs CPU, packed vs 5D,
     ``SMALL_ATOL``); then at full width, each with the counters set to
     0 just before it and its launches by kernel and variant required to
     be kernel_shapes.py's prediction: the 609882 packed bf16 chain over
     2x2 tiles (``PRESET_CHAIN_STEPS``, 5) and its int8 chain (2
     steps); ``cli.train``'s
     builder with ``--synthetic`` for 2 steps on 609882 (5D, batch 32),
     on 609889 at patch 128 with ``--to_hbr`` (5D, batch 8: 8
     microbatches, peak memory under 40 GiB) and on
     ``609889_32_81_DAPI_16`` (``--packed``), the last two followed by
     ``cli.generate --ckpt_pth`` from their checkpoints over 2x2 tiles for
     2 steps (the 16-slice one ``--no_packed``), none of whose K2 or K2b
     launches may be ``cuda_core``; tiles/s or samples/s,
     peak device memory, finite outputs;
 20. a ``{"kernels": [...]}`` line, then the card line, then the result.

Any failure raises and exits non-zero.  Needs one CUDA card; imports
nothing of JAX.  ``python3 chip_smoke.py --ranks`` runs phases 17 and
18 alone, with the phase 9 and 11 runs phase 17 is held against, for a
machine of several cards; ``--dp`` runs phase 18 alone; ``--presets``
phase 19 alone;
``python3 chip_smoke.py --int8`` runs phase 5 and phase 9's int8 and
int8_static chains with the bf16 packed chain they are compared with,
for a call that tunes the int8 kernels; ``--attention`` runs K2 and K2b
at phase 3's and 4's shapes, K2b at a data-parallel rank's, the
refusals and phase 19's K2 and K2b shapes, each row also timed in the
variant its shape took before (K2 and K2b ``wgmma`` beside the forced
``tensor_core`` or ``tensor_core_tiled``),
and K2's host cost a call, for a call that tunes the attention kernels;
``--norms`` runs K1 and K1b at phase 3's, 4's and 19's shapes (K1 also
at phase 4's strided shapes and at ``K1_F32_WEIGHT_SMALL`` with the
float32 weight), their edge shapes and the refusals, for a call that
tunes the norm kernels; ``--grouped`` runs K5, K6 and K5b at phase 3's,
4's and 19's shapes and edges, the folded ResBlock against the eager
one, and the autograd guard; ``--dit`` runs K1's modulate and K7 at
phase 3's and 19's shapes and edges and the folded DiT block against the
eager one.  Every packed path's K5, K5b and K6
launches (by variant, K5's by epilogue and prologue) are required to be
``scripts/kernel_shapes.py``'s: K5 57 a UNet call (29 with the SiLU, 28
with the bias, the modulate and the SiLU), K6 28 a UNet call on every
bf16 or float32 packed generation path (0 on int8, the 5D model,
training and the baselines), 88 + 88 K5 / K5b a training microbatch (no
epilogue or prologue: autograd records the eager ones).  Every
generation path's K1 launches by epilogue and K7 launches by variant are
required too: 12 K1 with the modulate and 12 K7 a UNet call wherever a
DiT block runs (packed, int8, 5D, tile-major, streamed, ranks), none in
training, the extraction and the baselines.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
H100_F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores
H100_L2_BYTES = 50 * 2 ** 20


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    """A check that stays under ``python -O`` (unlike assert)."""
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def device_ms(fn, arg_sets, calls: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn(*args)``: after a warm-up call on each set,
    ``calls`` calls cycling over ``arg_sets`` are captured in one CUDA
    graph, and its ``reps`` replays are timed between two CUDA events.
    The host's cost per call (wrapper, ctypes, allocator) is spent at
    capture, so it cannot bound the time; the device-side gap between
    two graph nodes (about a microsecond) stays in it.  A call of more
    than a millisecond (a second pass over the sets, timed) is timed over
    one pass of the sets and 2 replays: a graph of 100 such calls takes
    seconds and gains no precision."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for args in arg_sets:
        fn(*args)
    start.record()
    for args in arg_sets:
        fn(*args)
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > len(arg_sets):
        calls, reps = 1, 2
    n = max(calls, len(arg_sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def input_sets(tensors: tuple, nbytes: int) -> list:
    """``tensors`` and copies of them, enough that one pass over the sets
    moves twice the L2's bytes: each call then finds its inputs in device
    memory, as the bound counts them, and not in the L2."""
    k = max(1, math.ceil(2 * H100_L2_BYTES / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(k - 1)]


def variant_of(mod, fn, *args, **kwargs):
    """(fn(*args, **kwargs), the variant of ``mod``'s kernel that the call
    launched; ``mod`` a wrapper module or its ``bwd`` counters)."""
    before = dict(mod.launches_by_variant)
    out = fn(*args, **kwargs)
    moved = [k for k, v in mod.launches_by_variant.items() if v != before[k]]
    require(len(moved) == 1, f"{getattr(mod, '__name__', mod)}: launches "
            f"{moved}")
    return out, moved[0]


def bound(nbytes: float, flops: float, flop_rate: float):
    """(bound_ms, bound_by): the larger of bytes/bandwidth and ops/peak."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_work(kernel: str, shape, itemsize: int = 2,
                batches: int = 0, bias: bool = False) -> tuple:
    """(bytes, operations, the peak rate of their type) of one launch of
    K1, K1m (K1 with the modulate), K1b, K2, K2b, K5, K5b, K6 or K7 at
    ``shape`` (K5: (rows, segments, Z); K6: (rows, width, skip); K1m, K7:
    (rows, C)): each input read once and each output written once (K1b's
    and K5b's dw and weight in float32; K5 with the modulate epilogue
    also its (``batches``, C) scale and shift, with ``bias`` its (Z*C,)
    bias; K6 its biases; K1m x, its per-token scale and shift and the
    weight; K7 x, the gate and y)."""
    if kernel == "K7":
        rows, c = shape
        return itemsize * 4 * rows * c, 2 * rows * c, H100_F32_FLOP_PER_S
    if kernel == "K1m":
        rows, c = shape
        return (itemsize * (4 * rows * c + c), 7 * rows * c,
                H100_F32_FLOP_PER_S)
    if kernel == "K6":
        rows, width, skip = shape
        conv = skip == "conv"
        return (itemsize * (3 * rows * width + (1 + conv) * width),
                (2 + conv) * rows * width, H100_F32_FLOP_PER_S)
    if kernel in ("K5", "K5b"):
        rows, segments, z = shape
        width = z * sum(segments)
        if kernel == "K5":
            return (itemsize * (2 * rows * width + (1 + bias) * width
                                + 2 * batches * segments[0]),
                    (4 + bias) * rows * width, H100_F32_FLOP_PER_S)
        return (3 * rows * width * itemsize + 2 * 4 * width,
                10 * rows * width, H100_F32_FLOP_PER_S)
    if kernel in ("K1", "K1b"):
        n, c = shape
        if kernel == "K1":
            return itemsize * (2 * n * c + c), 4 * n * c, H100_F32_FLOP_PER_S
        return 3 * n * c * itemsize + 2 * 4 * c, 10 * n * c, \
            H100_F32_FLOP_PER_S
    b, n, d = shape
    rate = H100_BF16_FLOP_PER_S if itemsize == 2 else H100_F32_FLOP_PER_S
    if kernel == "K2":
        return 4 * b * n * d * itemsize, 4 * b * n * n * d, rate
    return 7 * b * n * d * itemsize, 10 * b * n * n * d, rate


def kernel_shapes():
    """``scripts/kernel_shapes.py`` as a module (loaded once)."""
    import importlib.util
    mod = sys.modules.get("kernel_shapes")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "kernel_shapes", Path(__file__).resolve().parent / "scripts"
            / "kernel_shapes.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["kernel_shapes"] = mod
        spec.loader.exec_module(mod)
    return mod


def ulp_err(out, ref) -> float:
    """Largest |out - ref| in units of the bf16 spacing at |ref|."""
    import torch
    r = ref.float().abs().clamp_min(2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(r)) - 7)
    return float(((out.float() - ref.float()).abs() / spacing).max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# (rows, C) that the main path gives K1: level-0 ResBlock in_norm (81
# patches x 2 z x 64 x 64 voxels, 64 + 32 channels), mid_res0.in_norm
# (512 + 229), the deepest decoder concat (512 + 512 + 229, collage batch
# of 64 patches) and the gene-token q_norm (81 x 229 rows of 64); then
# one shape for each lane group G of the vector variant that the main
# path reaches and the shapes above miss (C = 96 is G = 4, C = 64 is
# G = 2): the encoder's q_norm at head dim 256 (324 x 128 rows, G = 8),
# the middle block's norms of 512 channels (G = 16) and dec_3_res.in_norm
# (512 + 384, collage batch of 64 patches, G = 32); last the 5D chain's
# other two strided shapes, the gene concats 256 + 229 and 768 + 229.
K1_SHAPES = [(663_552, 96), (10_368, 741), (8_192, 1253), (18_549, 64),
             (41_472, 256), (10_368, 512), (32_768, 896), (32_768, 256),
             (10_368, 485), (8_192, 997)]
# (B, N, D) that the main path gives K2: encoder and collage decoder at
# resolution 16, and the middle block.
K2_SHAPES = [(324, 128, 256), (256, 128, 256), (324, 32, 512)]
# The packed model's K1 and K2 shapes on the other generation paths
# (scripts/kernel_shapes.py --patches P --chunk 5): the tile-major step
# (one tile's 5x5 patches, 5 z-windows a call) and the streamed 2x2-tile
# windows (9x9 patches, 5 z-windows a call: the main path's rows and
# batches x 5, up to 1,620 K2 blocks); a rank's 1x2-tile block of the 2x2
# grid in memory over 2 ranks (5x9 patches, one z-window a call;
# scripts/kernel_shapes.py --ranks 2; its band-parallel windows are the
# streamed ones)
PATH_SHAPES = {
    "tile_major": ([(40_960, 256), (64_000, 256), (16_000, 512),
                    (28_625, 64)],
                   [(320, 128, 256), (500, 128, 256), (500, 32, 512)]),
    "stream": ([(163_840, 256), (207_360, 256), (51_840, 512),
                (92_745, 64)],
               [(1_280, 128, 256), (1_620, 128, 256), (1_620, 32, 512)]),
    "rank": ([(16_384, 256), (23_040, 256), (5_760, 512), (10_305, 64)],
             [(128, 128, 256), (180, 128, 256), (180, 32, 512)]),
}
# The (rows, C) that cli.attn's extraction gives K1 in float32: the gene
# block's q-norm on 16 patches x 229 gene tokens of 64 features, 4 launches
# a tile (scripts/kernel_shapes.py --attn)
ATTN_K1_SHAPE = (3_664, 64)
# K1 with training's float32 weight at the smallest path shapes, where a
# cast before a vector launch was a second launch: a data-parallel rank's
# (2,048, 512) (scripts/kernel_shapes.py --train --ranks 2, 16 samples a
# microbatch) and patch-128 training's (2,592, 256) (--mouse 609889
# --patch 128 --to_hbr --train --batch 8); timed by ``--norms``
K1_F32_WEIGHT_SMALL = [((2048, 512), "dp rank train"),
                       ((2592, 256), "patch 128 train")]
# shapes off the main path that the wrappers accept: ragged rows and
# channels, ragged query tiles and key chunks, the largest shared-memory
# footprint (N = D = 512), the vector variant at one 16-byte vector a row
# (C = 8) and at a row that leaves lanes of its group unequal (C = 264),
# the strided variant's rows at the register limit (C = 2,047 and 2,048
# in bf16; in float32 they take the second read, as C = 2,050 does) and a
# 500-gene row (C = 1,524) whose x starts one element past 16 bytes (the
# third number: elements of offset); correctness only
K1_EDGE = [(7, 1), (13, 33), (1029, 2050), (1000, 8), (517, 264),
           (129, 1524, 1), (65, 2047), (65, 2048)]
K2_EDGE = [(5, 100, 48), (3, 17, 130), (2, 512, 512)]
K1_MAX_ULP = 4.0   # bf16 spacings at |ref|: the f32 sum of squares runs in
                   # another order, so bf16(inv) may round one step apart
                   # (2^-8 relative), which two rounded multiplies carry
                   # into y as up to 3 spacings
# K2 in bf16: two correct versions differ only where an f32 sum in another
# order moves a rounding (of p or of the output) by one step, in a few
# outputs per thousand.  Faults a bf16 kernel could have (p left unrounded
# or truncated, a truncated output, a wrong scale, ignored logits) change
# a third or more of them.  tests/test_torch_ops.py holds this check to
# both on the CPU.
K2_MAX_SPACINGS = 2.0   # max |o - ref| in bf16 spacings at max |ref|
K2_MAX_SHARE = 1e-2     # share of outputs that are not bit-equal
K2_LOGIT_STD = 3.0      # the peaked inputs: q.k * scale of std ~3, where
                        # the path's randn inputs give an almost flat
                        # softmax (logit std 1/sqrt(D))


def k2_agreement(out, ref):
    """(max |out - ref|, the same in bf16 spacings at max |ref|, share of
    outputs that differ at all)."""
    import torch
    d = (out.float() - ref.float()).abs()
    top = ref.float().abs().max().clamp_min(2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return (float(d.max()), float(d.max() / spacing),
            float((d > 0).float().mean()))


def card_generator(g, device):
    """A generator on ``device`` seeded by a draw of the CPU generator
    ``g``: a large input drawn with it costs no host time and no copy (at
    100 M samples a second, the host's randn took most of phases 3-5 and
    19), and stays fixed by ``g``'s seed."""
    import torch
    seed = int(torch.randint(2 ** 62, (), generator=g))
    return torch.Generator(device=device).manual_seed(seed)


def randn(g, *shape, device):
    """float32 randn of ``shape`` on ``device``: from ``g`` on the CPU,
    from :func:`card_generator` on the card."""
    import torch
    if torch.device(device).type == "cpu":
        return torch.randn(*shape, generator=g)
    return torch.randn(*shape, generator=card_generator(g, device),
                       device=device)


def k2_inputs(g, b, n, d, dtype, device, peaked):
    """q, k, v from randn; ``peaked`` scales q and k so that the logits
    q.k/d have std ``K2_LOGIT_STD``."""
    sig = (K2_LOGIT_STD * d ** 0.5) ** 0.5 if peaked else 1.0
    return tuple((s * randn(g, b, n, d, device=device)).to(device, dtype)
                 for s in (sig, sig, 1.0))


def require_k2(out, ref, what: str):
    import torch
    err, spacings, share = k2_agreement(out, ref)
    require(bool(torch.isfinite(out.float()).all()),
            f"K2 {what}: output not finite")
    require(spacings <= K2_MAX_SPACINGS and share <= K2_MAX_SHARE,
            f"K2 {what}: max_abs_err {err} = {spacings} bf16 spacings, "
            f"{share} of outputs differ")
    return err, spacings, share


def time_k1(k1, x, w, n, c) -> dict:
    """Device times of K1 and its plain version with ``w`` as the path
    passes it (bf16 in generation, the float32 master weight in
    training), and of ``F.rms_norm`` with the weight in x's dtype (its
    fused kernel takes one dtype)."""
    import torch.nn.functional as F
    sets = input_sets((x, w), 2 * x.numel() * x.element_size())
    lib_sets = [(a, b.to(a.dtype)) for a, b in sets]
    bms, by = bound(*kernel_work("K1", (n, c), x.element_size()))
    return dict(ms=device_ms(k1.rmsnorm_cuda, sets),
                plain_ms=device_ms(k1.rmsnorm_plain, sets),
                library_ms=device_ms(
                    lambda a, b: F.rms_norm(a, (c,), b, 1e-6), lib_sets),
                bound_ms=bms, bound_by=by)


# Time each K2 / K2b row also in the variant its shape took before the
# rule's (``--attention`` only: the full smoke adds no timings for it)
FORCED_TIMINGS = False


def before_ms(fn, sets, replaced) -> dict:
    """``{"before": v, "before_ms": t}``: with ``FORCED_TIMINGS``, at a
    shape whose variant replaced an older one (``replaced``: for K2
    ``wgmma`` the ``mma.sync`` variant ``replaced_variant`` names, for K2
    and K2b ``tensor_core_tiled`` ``cuda_core``), the device time of
    ``fn`` forced onto it; else {}."""
    if not FORCED_TIMINGS or replaced is None:
        return {}
    return {"before": replaced, "before_ms": device_ms(
        lambda *a: fn(*a, variant=replaced), sets)}


def replaced_by(k2, variant: str, n: int, d: int, bwd: bool = False):
    """The K2 (``bwd``: K2b) variant a bf16 shape that takes
    ``variant`` took before it, or None."""
    if variant == "wgmma":
        return (k2.replaced_bwd_variant if bwd else k2.replaced_variant)(
            n, d)
    return "cuda_core" if variant == "tensor_core_tiled" else None


def time_k2(k2, q, k, v, scale, b, n, d) -> dict:
    import torch.nn.functional as F
    sets = input_sets((q, k, v), 4 * q.numel() * q.element_size())
    bms, by = bound(*kernel_work("K2", (b, n, d), q.element_size()))
    variant = k2.attention_variant(n, d, q.dtype, True)
    return dict(ms=device_ms(lambda *a: k2.attention_cuda(*a, scale), sets),
                **before_ms(lambda *a, variant: k2.attention_cuda(
                    *a, scale, variant=variant), sets,
                    replaced_by(k2, variant, n, d)),
                plain_ms=device_ms(lambda *a: k2.attention_plain(*a, scale),
                                   sets),
                library_ms=device_ms(lambda *a: F.scaled_dot_product_attention(
                    *a, scale=scale), sets),
                bound_ms=bms, bound_by=by)


def timing_text(t: dict, lib: str) -> str:
    """A row's times; ``lib`` names the library call (none where
    ``library_ms`` is None: no PyTorch call computes the function)."""
    before = (f" ({t['before']} {t['before_ms']:.4f} ms)"
              if "before_ms" in t else "")
    lib = ("no library call" if t["library_ms"] is None
           else f"{lib} {t['library_ms']:.4f} ms")
    return (f"kernel {t['ms']:.4f} ms{before}, plain {t['plain_ms']:.4f} ms,"
            f" {lib}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f} % of it)")


def k1_agrees(x, w, what):
    """K1 against its plain version: (out, ref, error, variant), the error
    in bf16 ulps for a bf16 x (gate K1_MAX_ULP), else absolute (1e-5)."""
    import torch

    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    out, variant = variant_of(k1, k1.rmsnorm_cuda, x, w)
    ref = k1.rmsnorm_plain(x, w)
    require(bool(torch.isfinite(out.float()).all()),
            f"K1 {what}: output not finite")
    bf = x.dtype == torch.bfloat16
    err = ulp_err(out, ref) if bf else float((out - ref).abs().max())
    require(err <= (K1_MAX_ULP if bf else 1e-5),
            f"K1 {what} {x.dtype} ({variant}): {err}")
    return out, ref, err, variant


def k1_row(g, device, n, c, path, w_dtype=None) -> dict:
    """K1 at (n, c): bf16 against its plain version, the variant the shape
    rule names required, and float32 on 4,096 of the rows; timed.  The
    weight in bf16, as generation casts it, or in ``w_dtype`` (training's
    float32 master weight)."""
    import torch

    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    bf16 = torch.bfloat16
    x = randn(g, n, c, device=device).to(bf16)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, w_dtype or bf16)
    out, ref, err_ulp, variant = k1_agrees(x, w, f"{n}x{c}")
    err = float((out.float() - ref.float()).abs().max())
    want = k1.rmsnorm_variant(c, x.element_size(), True)
    require(variant == want, f"K1 {n}x{c} took {variant}, not {want}")
    # f32 input: the same variant's float instantiation
    _, _, errf, _ = k1_agrees(x[:4096].float(), w.float(), f"{n}x{c}")
    t = time_k1(k1, x, w, n, c)
    wt = "" if w.dtype == bf16 else f", weight {str(w.dtype)[6:]}"
    log(f"K1 rmsnorm ({n}, {c}) bf16{wt} [{variant}, {path}]: max_abs_err "
        f"{err:.3g} ({err_ulp:.2f} bf16 ulp, tol {K1_MAX_ULP}), f32 err "
        f"{errf:.3g}; " + timing_text(t, "F.rms_norm"))
    return dict(shape=[n, c], path=path, variant=variant, max_abs_err=err,
                max_ulp=err_ulp, weight=str(w.dtype)[6:], **t)


def k2_row(g, device, b, n, d, path) -> dict:
    """K2 at (b, n, d): bf16 against its plain version on randn and on
    peaked inputs (the variant the shape rule names required: ``wgmma``
    at every path shape, ``tensor_core_tiled`` at the edge (2, 512, 512)),
    the variant a ``wgmma`` shape took before (``tensor_core`` or
    ``tensor_core_tiled``, forced) against it too, float32 on 8 of the
    batch; timed (with ``FORCED_TIMINGS`` also in the variant it
    replaced)."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    bf16 = torch.bfloat16
    scale = 1.0 / d
    errs = []
    want = k2.attention_variant(n, d, bf16, True)
    for peaked in (False, True):
        q, k, v = k2_inputs(g, b, n, d, bf16, device, peaked)
        out, variant = variant_of(k2, k2.attention_cuda, q, k, v, scale)
        torch.cuda.synchronize()
        ref = k2.attention_plain(q, k, v, scale)
        errs.append(require_k2(out, ref, f"{b}x{n}x{d} "
                               f"{'peaked' if peaked else 'randn'}"))
        require(variant == want, f"K2 {b}x{n}x{d} bf16 took {variant}, "
                f"not {want}")
    old = k2.replaced_variant(n, d) if want == "wgmma" else None
    if old:
        out, _ = variant_of(k2, k2.attention_cuda, q, k, v, scale,
                            variant=old)
        require_k2(out, ref, f"{b}x{n}x{d} peaked, forced {old}")
    err = max(e[0] for e in errs)
    qf, kf, vf = (t[:8].float() for t in (q, k, v))
    outf, variant_f = variant_of(k2, k2.attention_cuda, qf, kf, vf, scale)
    errf = float((outf - k2.attention_plain(qf, kf, vf, scale)).abs().max())
    require(errf <= 1e-5, f"K2 {b}x{n}x{d} f32 ({variant_f}): {errf}")
    q, k, v = k2_inputs(g, b, n, d, bf16, device, False)
    t = time_k2(k2, q, k, v, scale, b, n, d)
    agree = "; ".join(f"{kind}: max_abs_err {e:.3g} = {sp:.2f} "
                      f"spacings, {sh:.2e} differ"
                      for kind, (e, sp, sh) in zip(("randn", "peaked"), errs))
    forced = f", forced {old} agrees" if old else ""
    log(f"K2 window_attention ({b}, {n}, {d}) bf16 [{variant}, {path}]: "
        f"{agree} (tol {K2_MAX_SPACINGS} spacings, {K2_MAX_SHARE}){forced};"
        f" f32 [{variant_f}] err {errf:.3g}; " + timing_text(t, "SDPA"))
    return dict(shape=[b, n, d], path=path, variant=variant,
                max_abs_err=err, **t)


def offset_rows(g, device, n, c, dt, offset=0):
    """randn (n, c) in ``dt`` on ``device``, a contiguous tensor whose
    storage starts ``offset`` elements past the allocation's start (16
    bytes when offset is 0)."""
    import torch
    base = torch.randn(n * c + offset, generator=g).to(device, dt)
    x = base[offset:].view(n, c)
    require(x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0),
            f"({n}, {c}) at offset {offset}: not as placed")
    return x


def check_k1_edges(g, device) -> None:
    """K1 against its plain version at the edge shapes, bf16 and float32,
    and on a misaligned (4096, 96): the strided variant required."""
    import torch
    seen = []
    for n, c, *off in K1_EDGE:
        for dt in (torch.bfloat16, torch.float32):
            x = offset_rows(g, device, n, c, dt, *off)
            w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, dt)
            where = f" at offset {off[0]}" if off else ""
            seen.append(f"({n}, {c}){where} {str(dt)[6:]} "
                        f"{k1_agrees(x, w, 'edge' + where)[3]}")
    # a contiguous tensor whose storage starts one element off 16 bytes
    for dt in (torch.bfloat16, torch.float32):
        x = offset_rows(g, device, 4096, 96, dt, 1)
        w = (1 + 0.1 * torch.randn(96, generator=g)).to(device, dt)
        variant = k1_agrees(x, w, "misaligned")[3]
        require(variant == "strided", f"K1 misaligned took {variant}")
        seen.append(f"(4096, 96) {str(dt)[6:]} misaligned {variant}")
    log(f"K1 edge shapes agree: {'; '.join(seen)}")


def check_kernels(device) -> dict:
    """Each kernel against its plain version at every shape of the main
    path and of the tile-major and streaming paths (bf16 and f32) and at
    the edge shapes, with device times at the paths' shapes.  Returns
    {name: [row per path shape]}."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    g = torch.Generator(device="cpu").manual_seed(0)
    bf16 = torch.bfloat16
    rows = {"rmsnorm": [k1_row(g, device, n, c, "block_major")
                        for n, c in K1_SHAPES]}
    check_k1_edges(g, device)

    rows["window_attention"] = [k2_row(g, device, b, n, d, "block_major")
                                for b, n, d in K2_SHAPES]
    seen = []
    for b, n, d in K2_EDGE:
        for peaked in (False, True):
            q, k, v = k2_inputs(g, b, n, d, bf16, device, peaked)
            out, variant = variant_of(k2, k2.attention_cuda, q, k, v, 1.0 / d)
            require_k2(out, k2.attention_plain(q, k, v, 1.0 / d),
                       f"edge {b}x{n}x{d} ({variant})")
            q, k, v = (t.float() for t in (q, k, v))
            outf, variant_f = variant_of(k2, k2.attention_cuda, q, k, v,
                                         1.0 / d)
            err = float((outf - k2.attention_plain(q, k, v, 1.0 / d))
                        .abs().max())
            require(err <= 1e-5, f"K2 edge {b}x{n}x{d} f32: {err}")
        seen.append(f"({b}, {n}, {d}) bf16 {variant}, f32 {variant_f}")
    log(f"K2 edge shapes agree (randn and peaked): {'; '.join(seen)}")
    for path, (k1_shapes, k2_shapes) in PATH_SHAPES.items():
        rows["rmsnorm"] += [k1_row(g, device, n, c, path)
                            for n, c in k1_shapes]
        rows["window_attention"] += [k2_row(g, device, b, n, d, path)
                                     for b, n, d in k2_shapes]
    # the extraction's q-norm, float32 (its only dtype there)
    n, c = ATTN_K1_SHAPE
    x = torch.randn(n, c, generator=g).to(device)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(device)
    _, _, err, variant = k1_agrees(x, w, f"{n}x{c}")
    require(variant == "vector", f"K1 {n}x{c} f32 took {variant}")
    t = time_k1(k1, x, w, n, c)
    log(f"K1 rmsnorm ({n}, {c}) f32 [{variant}, attn]: max_abs_err {err:.3g}"
        " (tol 1e-05); " + timing_text(t, "F.rms_norm"))
    rows["rmsnorm"].append(dict(shape=[n, c], path="attn", dtype="float32",
                                variant=variant, max_abs_err=err, **t))
    return rows


# ---------------------------------------------------------------------------
# phase 4: the backward kernels K1b and K2b against their plain versions
# ---------------------------------------------------------------------------

# (rows, C) and (B, N, D) of one training step of cli.train's defaults
# (scripts/kernel_shapes.py --train: batch 32, 2 microbatches of 128
# patches, both decoders); the packed model's K1 shapes are the first
# four.  K1b and K2b take these shapes as often as K1 and K2 do.
TRAIN_K1_SHAPES = [
    (65_536, 256), (16_384, 256), (16_384, 512), (29_312, 64),
    (262_144, 128), (1_048_576, 64), (262_144, 64), (65_536, 128),
    (4_096, 512), (1_048_576, 96), (16_384, 741), (4_096, 1253),
    (262_144, 160), (16_384, 1253), (65_536, 512), (262_144, 256),
    (1_048_576, 160), (262_144, 192), (65_536, 384), (16_384, 485),
    (4_096, 997), (16_384, 896), (16_384, 640), (65_536, 448),
    (65_536, 320), (262_144, 224), (16_384, 997), (65_536, 896),
    (65_536, 640), (262_144, 448), (262_144, 320), (1_048_576, 128),
    (1_048_576, 224)]
TRAIN_K2_SHAPES = [(512, 128, 256), (128, 128, 256), (512, 32, 512)]
# K1 (and K1b), K2 (and K2b) and K5 (and K5b) launches a training step
# (the baselines: K1 in the RNA tower's gene block only, its q_norm and
# norm2 at (29,312, 64), two a microbatch; no K2; K5 in the packed model's
# 28 ResBlocks and output norm only: 13 encoder and middle ResBlocks, 15
# decoder ones and the output norm, the decoder's twice (collage and
# original patches), 88 a microbatch; no K6 and no K7: autograd records,
# so the ResBlocks run their eager bias adds and sum and the DiT blocks
# their eager modulate and gated residual, and every K1 launch is
# without the epilogue)
TRAIN_LAUNCHES = {
    "5d": {"rmsnorm": 252, "window_attention": 18, "grouped_rmsnorm": 0,
           "residual": 0, "gated_residual": 0},
    "packed": {"rmsnorm": 76, "window_attention": 18,
               "grouped_rmsnorm": 176, "residual": 0, "gated_residual": 0},
    "patch-dm": {"rmsnorm": 4, "window_attention": 0, "grouped_rmsnorm": 0,
                 "residual": 0, "gated_residual": 0},
    "sinf": {"rmsnorm": 4, "window_attention": 0, "grouped_rmsnorm": 0,
             "residual": 0, "gated_residual": 0}}
# the kernels a training step counts, forward and backward (K6, K7 none)
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "window_attention",
                 "window_attention_bwd", "grouped_rmsnorm",
                 "grouped_rmsnorm_bwd", "residual", "gated_residual")
# K1b and K2b launches a training step by variant (scripts/kernel_shapes.py
# --train): the odd C of the gene concats take K1b strided
TRAIN_BWD_VARIANTS = {
    "5d": {"rmsnorm_bwd": {"strided": 18, "vector": 234},
           "window_attention_bwd": {"cuda_core": 0, "tensor_core": 0,
                                    "tensor_core_tiled": 0, "wgmma": 18},
           "grouped_rmsnorm_bwd": {"staged": 0, "vector": 0}},
    "packed": {"rmsnorm_bwd": {"strided": 0, "vector": 76},
               "window_attention_bwd": {"cuda_core": 0, "tensor_core": 0,
                                        "tensor_core_tiled": 0,
                                        "wgmma": 18},
               "grouped_rmsnorm_bwd": {"staged": 26, "vector": 150}},
    **{m: {"rmsnorm_bwd": {"strided": 0, "vector": 4},
           "window_attention_bwd": {"cuda_core": 0, "tensor_core": 0,
                                    "tensor_core_tiled": 0, "wgmma": 0},
           "grouped_rmsnorm_bwd": {"staged": 0, "vector": 0}}
       for m in ("patch-dm", "sinf")}}
# edge shapes: ragged and odd C, odd row counts, C = 741 and 1,253 (K1b
# strided), C = 8, 264 and 1,024 (vector with one 16-byte vector a row,
# unequal lanes, 32 lanes a row; 1,024 is strided in f32), 2,047 and
# 2,048 (the strided variant's words at its register limit in bf16) and
# 2,050 (a row wider than its registers), and C = 1,524 with x and g
# starting one element past 16 bytes (the third number); N = 17, 100, 512
# and D = 48, 130, 512 (K2b tensor_core at (5, 100, 48), with N not a
# multiple of 16; cuda_core at D = 130; wgmma at N = D = 512, its blocked
# design, tensor_core_tiled before); K2b wgmma at ragged N and odd B: fused
# at (7, 100, 256) (the last unit's rows past N zero-filled), two-pass at
# (3, 200, 128) (a 128-row block and a 128-key sweep tile past N)
K1B_EDGE = [(7, 33), (13, 100), (1029, 741), (517, 1253), (3, 8),
            (517, 264), (1000, 1024), (33, 2050), (129, 1524, 1),
            (65, 2047), (65, 2048)]
K2B_EDGE = [(5, 100, 48), (3, 17, 130), (2, 512, 512), (7, 100, 256),
            (3, 200, 128)]
# Tolerances, set before the first chip run.  Kernel and plain version
# compute the same float32 formula from the same inputs and differ only
# in the order of their sums.  float32 dx, dq, dk, dv: within 1e-5 of the
# output's max |ref| (sums of up to 1,253 products, or 512 keys, in
# another order move each by a few float32 ulps of the largest terms).
# float32 dw: within 1e-4 of its max |ref|, since it sums up to 10^6 rows
# per channel in another order (per-block partials, then the blocks).
# bf16 dx, dq, dk, dv: the K2 forward's gate (2 bf16 spacings at the
# output's max |ref|, at most 1 % of elements not bit-equal): a sum in
# another order moves a rounding by one step in a few outputs per
# thousand.
BWD_F32_TOL = 1e-5
BWD_DW_TOL = 1e-4


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref|."""
    r = ref.float()
    return float((out.float() - r).abs().max()
                 / r.abs().max().clamp_min(2.0 ** -126))


def require_bwd(out, ref, what: str) -> tuple:
    """The gate of one backward output: float32 within BWD_F32_TOL of
    max |ref|, bf16 by the K2 forward's gate; returns (max |error|, bf16
    spacings at max |ref|, share of outputs not bit-equal), the last two
    0 for float32."""
    import torch
    require(bool(torch.isfinite(out.float()).all()),
            f"{what}: output not finite")
    if out.dtype == torch.float32:
        err = rel_err(out, ref)
        require(err <= BWD_F32_TOL, f"{what}: {err} of max |ref|")
        return float((out.float() - ref.float()).abs().max()), 0.0, 0.0
    return require_k2(out, ref, what)


def time_k1b(k1, x, g, w) -> dict:
    """Device times of K1b, its plain version and the library yardstick:
    ``F.rms_norm``'s forward and ``autograd.grad`` in one graph less its
    forward alone (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    n, c = x.shape
    sets = input_sets((x, g, w), 3 * x.numel() * x.element_size())
    # the weight in x's dtype: F.rms_norm's fused kernel takes one dtype
    lib_sets = [(a.detach().requires_grad_(), b,
                 cw.to(a.dtype).requires_grad_()) for a, b, cw in sets]

    def lib_fwd_bwd(a, b, cw):
        return torch.autograd.grad(F.rms_norm(a, (c,), cw, 1e-6), (a, cw), b)

    lib = (device_ms(lib_fwd_bwd, lib_sets) - device_ms(
        lambda a, b, cw: F.rms_norm(a, (c,), cw, 1e-6), lib_sets))
    bms, by = bound(*kernel_work("K1b", (n, c), x.element_size()))
    return dict(ms=device_ms(k1.rmsnorm_bwd_cuda, sets),
                plain_ms=device_ms(k1.rmsnorm_bwd_plain, sets),
                library_ms=lib, bound_ms=bms, bound_by=by)


def time_k2b(k2, q, k, v, g, scale) -> dict:
    """Device times of K2b, its plain version and the library yardstick:
    SDPA's (``scale=1/D``) forward and ``autograd.grad`` in one graph less
    its forward alone (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    b, n, d = q.shape
    sets = input_sets((q, k, v, g), 4 * q.numel() * q.element_size())
    lib_sets = [tuple(t.detach().requires_grad_() for t in s[:3]) + (s[3],)
                for s in sets]

    def sdpa(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, scale=scale)

    lib = (device_ms(lambda a, b_, c, gg: torch.autograd.grad(
        sdpa(a, b_, c), (a, b_, c), gg), lib_sets)
        - device_ms(lambda a, b_, c, gg: sdpa(a, b_, c), lib_sets))
    bms, by = bound(*kernel_work("K2b", (b, n, d), q.element_size()))
    variant = k2.attention_bwd_variant(n, d, q.dtype, True)
    return dict(ms=device_ms(lambda *a: k2.attention_bwd_cuda(*a, scale),
                             sets),
                **before_ms(lambda *a, variant: k2.attention_bwd_cuda(
                    *a, scale, variant=variant), sets,
                    replaced_by(k2, variant, n, d, bwd=True)),
                plain_ms=device_ms(
                    lambda *a: k2.attention_bwd_plain(*a, scale), sets),
                library_ms=lib, bound_ms=bms, bound_by=by)


def k1b_inputs(gen, device, n, c, dt):
    """x, g in ``dt`` and the float32 weight that training passes."""
    import torch
    x = randn(gen, n, c, device=device).to(dt)
    g = randn(gen, n, c, device=device).to(dt)
    w = (1 + 0.1 * torch.randn(c, generator=gen)).to(device)
    return x, g, w


def k1b_agrees(x, g, w, what, want=None):
    """K1b against its plain version, run twice for bit-equal outputs, the
    variant (the shape rule's, or ``want``) required: ((max |dx error|,
    spacings, share), dw's error over max |ref|, variant)."""
    import torch

    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    (dx, dw), variant = variant_of(k1.bwd, k1.rmsnorm_bwd_cuda, x, g, w)
    dx2, dw2 = k1.rmsnorm_bwd_cuda(x, g, w)
    torch.cuda.synchronize()
    if want is None:
        want = k1.rmsnorm_bwd_variant(x.shape[-1], x.element_size(), True)
    require(variant == want,
            f"K1b {what} {x.dtype} took {variant}, not {want}")
    require(torch.equal(dw, dw2) and torch.equal(dx, dx2),
            f"K1b {what} ({variant}): two runs differ")
    rx, rw = k1.rmsnorm_bwd_plain(x, g, w)
    err = require_bwd(dx, rx, f"K1b {what} ({variant}) dx {x.dtype}")
    dw_err = rel_err(dw, rw)
    require(dw.dtype == torch.float32 and dw_err <= BWD_DW_TOL,
            f"K1b {what} ({variant}) dw: {dw_err} of max |ref|")
    return err, dw_err, variant


def k1b_row(gen, device, n, c, path) -> dict:
    """K1b at (n, c): bf16, and float32 on 4,096 of the rows, each by
    :func:`k1b_agrees`; timed."""
    import torch

    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    x, g, w = k1b_inputs(gen, device, n, c, torch.bfloat16)
    (err, sp, sh), dw_err, variant = k1b_agrees(x, g, w, f"{n}x{c}")
    xf, gf = x[:4096].float(), g[:4096].float()
    (errf, _, _), dwf, variant_f = k1b_agrees(xf, gf, w, f"{n}x{c}")
    t = time_k1b(k1, x, g, w)
    log(f"K1b rmsnorm_bwd ({n}, {c}) bf16 [{variant}, {path}]: dx "
        f"max_abs_err {err:.3g} = {sp:.2f} spacings, {sh:.2e} differ, dw "
        f"{dw_err:.2e} of max; f32 [{variant_f}] dx {errf:.3g}, dw "
        f"{dwf:.2e}; deterministic; " + timing_text(t, "F.rms_norm bwd"))
    return dict(shape=[n, c], path=path, variant=variant, max_abs_err=err,
                dw_rel_err=dw_err, **t)


def k2b_agrees(gen, device, b, n, d, dt, peaked, what, forced=None):
    """K2b against its plain version on fresh inputs, run twice for
    bit-equal outputs, the shape rule's variant required (or ``forced``
    launched): (the worst of dq, dk, dv's (max |error|, spacings, share),
    variant)."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    q, k, v = k2_inputs(gen, b, n, d, dt, device, peaked)
    g = randn(gen, b, n, d, device=device).to(dt)
    out, variant = variant_of(k2.bwd, k2.attention_bwd_cuda, q, k, v, g,
                              1.0 / d, variant=forced)
    out2 = k2.attention_bwd_cuda(q, k, v, g, 1.0 / d, variant=forced)
    torch.cuda.synchronize()
    want = forced or k2.attention_bwd_variant(n, d, dt, True)
    require(variant == want, f"K2b {what} {dt} took {variant}, not {want}")
    require(all(torch.equal(a, c) for a, c in zip(out, out2)),
            f"K2b {what} ({variant}): two runs differ")
    ref = k2.attention_bwd_plain(q, k, v, g, 1.0 / d)
    gates = [require_bwd(o, r, f"K2b {what} ({variant}) {name} {dt}")
             for o, r, name in zip(out, ref, ("dq", "dk", "dv"))]
    return tuple(max(e) for e in zip(*gates)), variant


def k2b_row(gen, device, b, n, d, path) -> dict:
    """K2b at (b, n, d): bf16 on randn and on peaked inputs (the rule's
    variant required: ``wgmma`` at every path shape), the variant a
    ``wgmma`` shape took before (``tensor_core`` or ``tensor_core_tiled``,
    forced) on peaked inputs, float32 on 8 of the batch, each by
    :func:`k2b_agrees`; timed (with ``FORCED_TIMINGS`` also in the variant
    it replaced)."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    bf16 = torch.bfloat16
    errs = [k2b_agrees(gen, device, b, n, d, bf16, peaked, f"{b}x{n}x{d}")
            for peaked in (False, True)]
    variant = errs[0][1]
    old = k2.replaced_bwd_variant(n, d) if variant == "wgmma" else None
    if old:
        k2b_agrees(gen, device, b, n, d, bf16, True, f"{b}x{n}x{d} forced",
                   forced=old)
    (errf, _, _), variant_f = k2b_agrees(gen, device, 8, n, d, torch.float32,
                                         False, f"8x{n}x{d}")
    q, k, v = k2_inputs(gen, b, n, d, bf16, device, False)
    g = randn(gen, b, n, d, device=device).to(bf16)
    t = time_k2b(k2, q, k, v, g, 1.0 / d)
    agree = "; ".join(f"{kind}: max_abs_err {e:.3g} = {sp:.2f} "
                      f"spacings, {sh:.2e} differ"
                      for kind, ((e, sp, sh), _) in zip(
                          ("randn", "peaked"), errs))
    forced = f", forced {old} agrees" if old else ""
    log(f"K2b window_attention_bwd ({b}, {n}, {d}) bf16 [{variant}, {path}]:"
        f" dq, dk, dv {agree} (tol {K2_MAX_SPACINGS} spacings, "
        f"{K2_MAX_SHARE}){forced}; f32 [{variant_f}] {errf:.3g}; "
        "deterministic; " + timing_text(t, "SDPA bwd"))
    return dict(shape=[b, n, d], path=path, variant=variant,
                max_abs_err=max(e[0][0] for e in errs),
                max_share=max(e[0][2] for e in errs), **t)


def check_k1b_edges(gen, device) -> None:
    """K1b against its plain version at the edge shapes, bf16 and
    float32 (x and g placed at the shape's offset), and with only x
    misaligned at (4096, 96) and (129, 1,524): the strided variant
    required, each run twice for bit-equal outputs."""
    import torch
    seen = []
    for n, c, *off in K1B_EDGE:
        got = []
        where = f" at offset {off[0]}" if off else ""
        for dt in (torch.bfloat16, torch.float32):
            x, g = (offset_rows(gen, device, n, c, dt, *off)
                    for _ in range(2))
            w = (1 + 0.1 * torch.randn(c, generator=gen)).to(device)
            got.append(k1b_agrees(x, g, w, f"edge {n}x{c}{where}")[2])
        seen.append(f"({n}, {c}){where} bf16 {got[0]}, f32 {got[1]}")
    for n, c in ((4096, 96), (129, 1524)):
        for dt in (torch.bfloat16, torch.float32):
            x = offset_rows(gen, device, n, c, dt, 1)
            _, g, w = k1b_inputs(gen, device, n, c, dt)
            k1b_agrees(x, g, w, f"misaligned x {n}x{c}", want="strided")
    log(f"K1b edge shapes agree, bf16 and f32, deterministic: "
        f"{'; '.join(seen)}; (4096, 96) and (129, 1524) with x alone "
        "misaligned strided")


def check_backward_kernels(device) -> dict:
    """Each variant of K1b and K2b against its plain version at every
    training-step shape (bf16, and float32 on a slice of the rows or
    batch) and at the edge shapes (both dtypes, randn and peaked for K2b,
    a misaligned tensor for K1b), each run twice for bit-equal outputs;
    the variant each call takes is required; device times at the
    training shapes.  Returns {name: [row per training shape]}."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(2)
    bf16 = torch.bfloat16
    rows = {"rmsnorm_bwd": [k1b_row(gen, device, n, c, "train")
                            for n, c in TRAIN_K1_SHAPES]}
    check_k1b_edges(gen, device)

    rows["window_attention_bwd"] = [k2b_row(gen, device, b, n, d, "train")
                                    for b, n, d in TRAIN_K2_SHAPES]
    seen = []
    for b, n, d in K2B_EDGE:
        got = {}
        for dt in (bf16, torch.float32):
            for peaked in (False, True):
                got[dt] = k2b_agrees(gen, device, b, n, d, dt, peaked,
                                     f"edge {b}x{n}x{d}")[1]
        seen.append(f"({b}, {n}, {d}) bf16 {got[bf16]}, f32 "
                    f"{got[torch.float32]}")
    log("K2b edge shapes agree, bf16 and f32, randn and peaked, "
        f"deterministic: {'; '.join(seen)}")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4, continued: K5 and K5b, the packed model's GroupedRMSNorm
# ---------------------------------------------------------------------------

# K5 in bf16 against its plain version: both round inv_z to bf16, then
# each of the two products, so where they round inv_z alike their outputs
# are bit-equal (within K5_MAX_ULP = 1 spacing at |ref|).  Their float32
# sums of squares run in other orders, so where a plane's float64 inv_z
# lies within K5_BOUNDARY (relative) of a bf16 rounding boundary the two
# may round it one step apart (2^-8 relative), which the two rounded
# products carry into y as up to K1_MAX_ULP spacings: those planes, a few
# % of them, are held to K1's gate and counted.  K5 with an epilogue (the
# SiLU, or the adaLN modulate and the SiLU) rounds where the plain
# sequence rounds: off those planes it is held to the plain sequence
# within K5_MAX_ULP, and everywhere within K5_MAX_ULP of the plain
# epilogue applied to K5's own norm, so what follows from a near plane is
# what follows from K5's y there (the modulate's sum can cancel, so a
# spacing of y may be many of the output's).
K5_MAX_ULP = 1.0
K5_BOUNDARY = 1e-4
# edge shapes (rows, segments, Z[, element offset of x]): an odd segment at
# a misaligned start, the 229-gene segment at 1 and 2 RNA-slice planes, Z
# = 3 (a plane group of idle warps), Z = 4 and 8 at the widest preset rows
# (638850 at 8 RNA slices: 5,012; 609889_32_81_DAPI_16: 8,840), a row of
# one 16-byte vector, ragged row counts, one segment at a misaligned start
# (the modulate in the staged variant); K5 with the float32 weight of
# training and from_5d, K5b both ways; K5 with the SiLU epilogue at each,
# and with the modulate (rows per batch of 1) at each single segment
K5_EDGE = [(129, (16, 8, 7), 2, 1), (7, (8,), 2), (333, (229,), 1),
           (1000, (64, 32), 1), (517, (5, 3), 3), (1031, (512, 512, 229), 4),
           (257, (512, 512, 81), 8), (4097, (512, 229), 2),
           (65, (128, 64, 32), 2, 3), (97, (40,), 2, 5)]
# the single-segment K5 row timed beside F.rms_norm on its (rows * Z, C)
# view (the 5D (C,) weight, no epilogue: the same function)
K5_RMS_NORM_ROW = (262144, (64,), 2)


def k5_shapes(train: bool = False, conf=None, acts: bool = False) -> list:
    """The (rows, segments, Z) that the block-major chain's UNet call
    (``train``: a packed training microbatch) gives K5, largest first
    (``scripts/kernel_shapes.py``); ``acts``: (rows, segments, Z,
    epilogue, B, prologue), each shape with the epilogue its launches
    take, the batches of the modulate's scale and shift (0 without it)
    and whether it adds a conv's bias first (``bias`` or ``none``)."""
    from collections import Counter
    ks = kernel_shapes()
    k5, k5_act = Counter(), Counter()
    if train:
        ks.train_shapes(True, conf=conf, k5=k5, k5_act=k5_act)
    else:
        ks.per_call_shapes(conf=conf, k5=k5, k5_act=k5_act)
    return sorted(k5_act if acts else k5,
                  key=lambda s: -s[0] * s[2] * sum(s[1]))


def k5_boundary(x, z, segs, eps=1e-6):
    """(rows, Z * Ctot) bool: the elements of planes whose float64 inv_z
    lies within K5_BOUNDARY of a bf16 rounding boundary."""
    import torch

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    plane, _ = k5.element_planes(z, segs, False)
    plane = plane.to(x.device)
    x2 = x.reshape(-1, x.shape[-1])
    ss = torch.zeros(x2.shape[0], z, dtype=torch.float64, device=x.device)
    for i in range(0, x2.shape[0], 65536):   # float64 rows in chunks
        xd = x2[i:i + 65536].double()
        ss[i:i + 65536].index_add_(1, plane, xd * xd)
    inv = torch.rsqrt(ss / sum(segs) + eps)
    near = ((inv * (1 - K5_BOUNDARY)).to(torch.bfloat16)
            != (inv * (1 + K5_BOUNDARY)).to(torch.bfloat16))
    return near[:, plane], int(near.sum())


def spacings(out, ref):
    """|out - ref| elementwise in bf16 spacings at |ref|, as (rows,
    width)."""
    import torch
    r = ref.float().abs().clamp_min(2.0 ** -126)
    sp = (out.float() - ref.float()).abs() / torch.exp2(
        torch.floor(torch.log2(r)) - 7)
    return sp.reshape(-1, out.shape[-1])


def k5_agrees(x, w, z, segs, from_5d, what, want=None, bias=None):
    """K5 (with the prologue's ``bias``, where given) against its plain
    version: (out, ref, error, variant, planes near a rounding boundary);
    bf16: within K5_MAX_ULP spacings at |ref|, K1_MAX_ULP on the planes of
    :func:`k5_boundary` (of ``x + bias``); float32 within 1e-5.  The
    variant the rule names (or ``want``) required."""
    import torch

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    out, variant = variant_of(k5, k5.grouped_rmsnorm_cuda, x, w, z, segs,
                              from_5d=from_5d, bias=bias)
    ref = k5.grouped_rmsnorm_act_plain(x, w, z, segs, from_5d=from_5d,
                                       bias=bias)
    require(bool(torch.isfinite(out.float()).all()),
            f"K5 {what}: output not finite")
    if want is None:
        want = k5.grouped_variant(z, segs, x.element_size(), True)
    require(variant == want, f"K5 {what} {x.dtype} took {variant}, not "
            f"{want}")
    if x.dtype != torch.bfloat16:
        err = float((out - ref).abs().max())
        require(err <= 1e-5, f"K5 {what} {x.dtype} ({variant}): {err}")
        return out, ref, err, variant, 0
    near, n_near = k5_boundary(x if bias is None else x + bias, z, segs)
    sp = spacings(out, ref)
    far_err = float(sp[~near].max()) if bool((~near).any()) else 0.0
    near_err = float(sp[near].max()) if n_near else 0.0
    require(far_err <= K5_MAX_ULP and near_err <= K1_MAX_ULP,
            f"K5 {what} bf16 ({variant}): {far_err} spacings (tol "
            f"{K5_MAX_ULP}), {near_err} on {n_near} planes near a rounding "
            f"boundary (tol {K1_MAX_ULP})")
    return out, ref, max(far_err, near_err), variant, n_near


def k5_act_agrees(x, w, z, segs, from_5d, act, scale, shift, what,
                  want=None, bias=None):
    """K5 with the epilogue ``act`` (and the prologue's ``bias``, where
    given) against ``grouped_rmsnorm_act_plain`` (the eager bias add, the
    norm's plain version, then the eager modulate and SiLU): (out, ref,
    spacings off the near planes, spacings from the plain epilogue on
    K5's own norm, variant); bf16 both within K5_MAX_ULP (see
    K5_MAX_ULP); float32 within 1e-5 of the plain sequence.  The variant
    the rule names (or ``want``) required."""
    import torch

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    kw = dict(from_5d=from_5d, act=act, scale=scale, shift=shift,
              bias=bias)
    out, variant = variant_of(k5, k5.grouped_rmsnorm_cuda, x, w, z, segs,
                              **kw)
    ref = k5.grouped_rmsnorm_act_plain(x, w, z, segs, **kw)
    require(bool(torch.isfinite(out.float()).all()),
            f"K5 {act} {what}: output not finite")
    if want is None:   # x and the weight are aligned; the others?
        aligned = (scale is None or (
            scale.stride(0) * x.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (scale, shift)))) \
            and (bias is None or bias.data_ptr() % 16 == 0)
        want = k5.grouped_variant(z, segs, x.element_size(), aligned, act)
    require(variant == want, f"K5 {act} {what} {x.dtype} took {variant}, "
            f"not {want}")
    if x.dtype != torch.bfloat16:
        err = float((out - ref).abs().max())
        require(err <= 1e-5, f"K5 {act} {what} {x.dtype} ({variant}): "
                f"{err}")
        return out, ref, err, 0.0, variant
    near, _ = k5_boundary(x if bias is None else x + bias, z, segs)
    sp = spacings(out, ref)
    far_err = float(sp[~near].max()) if bool((~near).any()) else 0.0
    own = k5.act_plain(k5.grouped_rmsnorm_cuda(x, w, z, segs,
                                               from_5d=from_5d, bias=bias),
                       act, z, scale, shift)
    comp_err = float(spacings(out, own).max())
    require(far_err <= K5_MAX_ULP and comp_err <= K5_MAX_ULP,
            f"K5 {act} {what} bf16 ({variant}): {far_err} spacings from "
            f"the plain sequence off the near planes, {comp_err} from the "
            f"plain epilogue on K5's norm (tol {K5_MAX_ULP})")
    return out, ref, far_err, comp_err, variant


def k5_inputs(g, device, n, segs, z, dt, from_5d, w_dtype=None,
              offset=0):
    """x (n, Z * Ctot) in ``dt`` (``offset`` elements past 16 bytes) and
    the weight of its layout in ``w_dtype`` (default x's)."""
    import torch

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    width = z * sum(segs)
    x = randn(g, n * width + offset, device=device).to(dt)[offset:]
    w = (1 + 0.1 * torch.randn(k5.weight_len(z, segs, from_5d),
                               generator=g)).to(device, w_dtype or dt)
    return x.view(n, width), w


def k5_bias(g, device, x, on: bool = True):
    """A prologue's bias for x: (width,) of x's dtype, a conv bias's
    spread (0.5 a standard normal), or None where ``on`` is false."""
    if not on:
        return None
    return (0.5 * randn(g, x.shape[-1], device=device)).to(x.dtype)


def k5_epilogue_inputs(g, device, x, c, act, batches):
    """(x as (B, rows / B, width), scale, shift) for ``act``: with the
    modulate, the two (B, C) halves of one (B, 2C) adaLN projection, as
    the ResBlock passes them (views with a row stride of 2C)."""
    if act != "modulate_silu":
        return x, None, None
    emb = (0.5 * randn(g, batches, 2 * c, device=device)).to(x.dtype)
    scale, shift = emb.chunk(2, dim=-1)
    return x.view(batches, -1, x.shape[-1]), scale, shift


def time_k5(x, w, z, segs, from_5d, act="none", scale=None,
            shift=None, bias=None) -> dict:
    """Device times of K5 (with its prologue's ``bias`` and its epilogue
    ``act``) and its plain version (the plain sequence), and with one
    segment, the 5D weight (``from_5d``), no bias and no epilogue of
    ``F.rms_norm`` over the (rows * Z, Ctot) view, the same function in
    one PyTorch call; else no library call computes it."""
    import torch.nn.functional as F

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    n = x.numel() // x.shape[-1]
    kw = dict(from_5d=from_5d, act=act, scale=scale, shift=shift,
              bias=bias)
    sets = input_sets((x, w), 2 * x.numel() * x.element_size())
    bms, by = bound(*kernel_work(
        "K5", (n, segs, z), x.element_size(),
        scale.shape[0] if scale is not None else 0, bias is not None))
    lib = None
    if len(segs) == 1 and from_5d and act == "none" and bias is None:
        lib = device_ms(lambda a, b: F.rms_norm(
            a.view(-1, segs[0]), (segs[0],), b, 1e-6),
            [(a, b.to(a.dtype)) for a, b in sets])
    return dict(ms=device_ms(lambda a, b: k5.grouped_rmsnorm_cuda(
        a, b, z, segs, **kw), sets),
        plain_ms=device_ms(lambda a, b: k5.grouped_rmsnorm_act_plain(
            a, b, z, segs, **kw), sets),
        library_ms=lib, bound_ms=bms, bound_by=by)


def k5_row(g, device, n, segs, z, path, from_5d=False, w_dtype=None,
           timed=True, act="none", batches=0, prologue="none") -> dict:
    """K5 at (n, segments, Z): the norm (with a conv's bias added first
    where ``prologue`` is ``bias``) in bf16 against its plain version (the
    weight in bf16 as generation passes it, or ``w_dtype``) and, with
    ``act``, K5 with that epilogue against the plain sequence (the
    modulate's scale and shift of ``batches`` batches), each by
    :func:`k5_agrees` / :func:`k5_act_agrees`, float32 on 4,096 of the
    rows (whole batches); timed with the prologue and the epilogue."""
    import torch
    bf16 = torch.bfloat16
    x, w = k5_inputs(g, device, n, segs, z, bf16, from_5d, w_dtype)
    bias = k5_bias(g, device, x, prologue == "bias")
    out, ref, err_ulp, variant, n_near = k5_agrees(
        x, w, z, segs, from_5d, f"{n}x{segs}x{z}", bias=bias)
    err = float((out.float() - ref.float()).abs().max())
    same = float((out != ref).float().mean())
    require(act != "modulate_silu" or batches > 0 and n % batches == 0,
            f"K5 modulate at {n} rows: {batches} batches")
    xa, scale, shift = k5_epilogue_inputs(g, device, x, segs[0], act,
                                          batches)
    comp = None
    if act != "none":
        out, ref, err_ulp, comp, variant = k5_act_agrees(
            xa, w, z, segs, from_5d, act, scale, shift, f"{n}x{segs}x{z}",
            bias=bias)
        err = float((out.float() - ref.float()).abs().max())
        same = float((out != ref).float().mean())
    if scale is None:
        xf, sf, hf = x[:4096].float(), None, None
    else:   # whole batches
        nb = max(1, 4096 // (n // batches))
        xf, sf, hf = xa[:nb].float(), scale[:nb].float(), shift[:nb].float()
    bf = None if bias is None else bias.float()
    if act == "none":
        _, _, errf, variant_f, _ = k5_agrees(xf, w.float(), z, segs,
                                             from_5d, f"{n}x{segs}x{z}",
                                             bias=bf)
    else:
        _, _, errf, _, variant_f = k5_act_agrees(
            xf, w.float(), z, segs, from_5d, act, sf, hf, f"{n}x{segs}x{z}",
            bias=bf)
    t = time_k5(xa, w, z, segs, from_5d, act, scale, shift,
                bias) if timed else {}
    if t and act != "none" and variant == "staged":   # the norm alone too
        t["norm_ms"] = time_k5(x, w, z, segs, from_5d)["ms"]
    wt = "" if w.dtype == bf16 else f", weight {str(w.dtype)[6:]}"
    lib = "; " + timing_text(t, "F.rms_norm") if t else ""
    if "norm_ms" in t:
        lib += f"; the norm alone {t['norm_ms']:.4f} ms"
    epi = ("" if bias is None else " with the bias") + (
        "" if act == "none" else f" + {act}"
        + (f" ({batches} batches)" if scale is not None else ""))
    log(f"K5 grouped_rmsnorm ({n}, {segs}, z {z}){epi} bf16{wt}"
        f"{' from_5d' if from_5d else ''} [{variant}, {path}]: max_abs_err "
        f"{err:.3g} ({err_ulp:.2f} bf16 ulp"
        + ("" if comp is None else
           f" off the near planes, {comp:.2f} from the plain epilogue on "
           "K5's norm")
        + f"; {n_near} planes near a "
        f"rounding boundary), {same:.2e} of outputs not bit-equal; f32 "
        f"[{variant_f}] err {errf:.3g}" + lib)
    return dict(shape=[n, list(segs), z], act=act, prologue=prologue,
                path=path, variant=variant, max_abs_err=err, max_ulp=err_ulp,
                epilogue_ulp=comp, near_planes=n_near, not_bit_equal=same,
                weight=str(w.dtype)[6:], from_5d=from_5d, **t)


def check_k5_edges(g, device) -> None:
    """K5 against its plain version at ``K5_EDGE``, bf16 and float32, the
    runtime weight and the 5D one (a float32 weight of the bf16 x), with
    the SiLU epilogue at each and the modulate at each single segment
    (rows per batch of 1), each single segment also with a conv's bias
    (the prologue) before the SiLU and before the modulate; the C entry
    point's refusal of ``vector`` for an odd segment and a misaligned x,
    of the modulate on two segments and a misaligned scale in ``vector``,
    of a bias on two segments and a misaligned bias in ``vector``, and of
    an unknown variant or epilogue; the wrapper's refusal of a
    multi-segment bias before any launch."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    seen = []
    for n, segs, z, *off in K5_EDGE:
        got = []
        want = "staged" if off else None
        for dt, from_5d, w_dt in ((torch.bfloat16, False, None),
                                  (torch.bfloat16, True, torch.float32),
                                  (torch.float32, True, None)):
            x, w = k5_inputs(g, device, n, segs, z, dt, from_5d, w_dt,
                             *off)
            got.append(k5_agrees(x, w, z, segs, from_5d,
                                 f"edge {n}x{segs}x{z}", want)[3])
            for act in ("silu", "modulate_silu")[:1 + (len(segs) == 1)]:
                xa, scale, shift = k5_epilogue_inputs(g, device, x, segs[0],
                                                      act, n)
                for bias in (None, k5_bias(g, device, x))[
                        :1 + (len(segs) == 1)]:
                    got.append(k5_act_agrees(
                        xa, w, z, segs, from_5d, act, scale, shift,
                        f"edge {n}x{segs}x{z}", want, bias)[4]
                        + ("+bias" if bias is not None else ""))
        seen.append(f"({n}, {segs}, z {z})"
                    + (f" at offset {off[0]}" if off else "")
                    + f" {'/'.join(got)}")
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    t = torch.zeros(64 * 64 + 8, device=device, dtype=torch.bfloat16)
    vec = k5.VARIANTS.index("vector")
    mod = k5.EPILOGUES.index("modulate_silu")
    for what, segs, off, variant, act, s_off, b_off in (
            ("odd segment", (16, 8, 7), 0, vec, 0, 0, None),
            ("misaligned", (16, 16), 1, vec, 0, 0, None),
            ("unknown variant", (16, 16), 0, 7, 0, 0, None),
            ("unknown epilogue", (16, 16), 0, vec, 3, 0, None),
            ("the modulate on two segments", (16, 16), 0, vec, mod, 0, None),
            ("a misaligned scale in vector", (16,), 0, vec, mod, 1, None),
            ("a bias on two segments", (16, 16), 0, vec, 0, 0, 0),
            ("a misaligned bias in vector", (16,), 0, vec, mod, 0, 1)):
        a = t[off:off + 64 * 2 * sum(segs)]
        sc = t[s_off:]
        err = lib.tmt_grouped_rmsnorm(
            a.data_ptr(), a.data_ptr(),
            None if b_off is None else t[b_off:].data_ptr(),
            a.data_ptr(), 64, 2, len(segs),
            *k5._segment_args(tuple(segs)), 1e-6, 1, 1, 0, variant, act,
            sc.data_ptr(), sc.data_ptr(), 16, 1, stream)
        require(err != 0, f"tmt_grouped_rmsnorm took {what}")
    before = k5.launches
    x2 = t[:64 * 32].view(64, 32)
    try:
        k5.grouped_rmsnorm_cuda(x2, x2[0], 2, (8, 8), bias=x2[1])
        refused = None
    except ValueError as err:
        refused = str(err)
    require(refused is not None and k5.launches == before,
            f"grouped_rmsnorm_cuda took a bias on two segments: {refused}")
    log(f"K5 edge shapes agree (bf16, bf16 with a float32 from_5d weight, "
        f"f32; each also with the SiLU, one segment also with the "
        f"modulate, each of those also with a bias): {'; '.join(seen)}; "
        "the entry point refuses vector on an odd segment and a "
        "misaligned x, the modulate on two segments and a misaligned "
        "scale in vector, a bias on two segments and a misaligned bias in "
        "vector, an unknown variant and epilogue; the wrapper refuses a "
        f"multi-segment bias before any launch ({refused})")


def check_grouped_kernels(device) -> dict:
    """Phase 3's K5: every (rows, segments, Z) of the block-major chain
    with each epilogue its launches take, bf16 with the bf16 weight,
    timed; one single-segment norm beside ``F.rms_norm``; the edges."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(5)
    rows = [k5_row(g, device, n, segs, z, "block_major", act=act,
                   batches=b, prologue=pro)
            for n, segs, z, act, b, pro in k5_shapes(acts=True)]
    n, segs, z = K5_RMS_NORM_ROW
    rows.append(k5_row(g, device, n, segs, z, "rms_norm_yardstick",
                       from_5d=True))
    check_k5_edges(g, device)
    return {"grouped_rmsnorm": rows}


def time_k5b(x, g, w, z, segs, from_5d) -> dict:
    """Device times of K5b, its plain version and, with one segment and
    ``from_5d``, ``F.rms_norm``'s forward and ``autograd.grad`` over the
    (rows * Z, Ctot) view less its forward alone."""
    import torch
    import torch.nn.functional as F

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    n = x.shape[0]
    sets = input_sets((x, g, w), 3 * x.numel() * x.element_size())
    lib = None
    if len(segs) == 1 and from_5d:
        c = segs[0]
        lib_sets = [(a.detach().view(-1, c).requires_grad_(),
                     b.view(-1, c), cw.to(a.dtype).requires_grad_())
                    for a, b, cw in sets]

        def lib_fwd_bwd(a, b, cw):
            return torch.autograd.grad(F.rms_norm(a, (c,), cw, 1e-6),
                                       (a, cw), b)

        lib = (device_ms(lib_fwd_bwd, lib_sets) - device_ms(
            lambda a, b, cw: F.rms_norm(a, (c,), cw, 1e-6), lib_sets))
    bms, by = bound(*kernel_work("K5b", (n, segs, z), x.element_size()))
    return dict(ms=device_ms(lambda a, b, cw: k5.grouped_rmsnorm_bwd_cuda(
        a, b, cw, z, segs, from_5d=from_5d), sets),
        plain_ms=device_ms(lambda a, b, cw: k5.grouped_rmsnorm_bwd_plain(
            a, b, cw, z, segs, from_5d=from_5d), sets),
        library_ms=lib, bound_ms=bms, bound_by=by)


def k5b_agrees(x, g, w, z, segs, from_5d, what, want=None):
    """K5b against its plain version, run twice for bit-equal outputs, the
    variant (the rule's, or ``want``) required: ((max |dx error|,
    spacings, share), dw's error over max |ref|, variant)."""
    import torch

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    (dx, dw), variant = variant_of(k5.bwd, k5.grouped_rmsnorm_bwd_cuda, x, g,
                                   w, z, segs, from_5d=from_5d)
    dx2, dw2 = k5.grouped_rmsnorm_bwd_cuda(x, g, w, z, segs,
                                           from_5d=from_5d)
    torch.cuda.synchronize()
    if want is None:
        want = k5.grouped_variant(z, segs, x.element_size(), True)
    require(variant == want,
            f"K5b {what} {x.dtype} took {variant}, not {want}")
    require(torch.equal(dw, dw2) and torch.equal(dx, dx2),
            f"K5b {what} ({variant}): two runs differ")
    rx, rw = k5.grouped_rmsnorm_bwd_plain(x, g, w, z, segs, from_5d=from_5d)
    err = require_bwd(dx, rx, f"K5b {what} ({variant}) dx {x.dtype}")
    dw_err = rel_err(dw, rw)
    require(dw.dtype == torch.float32 and dw_err <= BWD_DW_TOL,
            f"K5b {what} ({variant}) dw: {dw_err} of max |ref|")
    return err, dw_err, variant


def k5b_row(gen, device, n, segs, z, path, timed=True) -> dict:
    """A packed training shape (the 5D weight, float32): K5 forward with
    it against its plain version (bf16), then K5b bf16, and float32 on
    4,096 of the rows, each by :func:`k5b_agrees`; K5b timed."""
    import torch
    bf16 = torch.bfloat16
    x, w = k5_inputs(gen, device, n, segs, z, bf16, True, torch.float32)
    _, _, fwd_ulp, fwd_variant, _ = k5_agrees(x, w, z, segs, True,
                                              f"train {n}x{segs}x{z}")
    g = randn(gen, n, x.shape[1], device=device).to(bf16)
    (err, sp, sh), dw_err, variant = k5b_agrees(x, g, w, z, segs, True,
                                                f"{n}x{segs}x{z}")
    (errf, _, _), dwf, variant_f = k5b_agrees(
        x[:4096].float(), g[:4096].float(), w, z, segs, True,
        f"{n}x{segs}x{z}")
    t = time_k5b(x, g, w, z, segs, True) if timed else {}
    lib = "; " + timing_text(t, "F.rms_norm bwd") if t else ""
    log(f"K5b grouped_rmsnorm_bwd ({n}, {segs}, z {z}) bf16 [{variant}, "
        f"{path}]: K5 forward [{fwd_variant}] {fwd_ulp:.2f} ulp; dx "
        f"max_abs_err {err:.3g} = {sp:.2f} spacings, {sh:.2e} differ, dw "
        f"{dw_err:.2e} of max; f32 [{variant_f}] dx {errf:.3g}, dw "
        f"{dwf:.2e}; deterministic" + lib)
    return dict(shape=[n, list(segs), z], path=path, variant=variant,
                max_abs_err=err, dw_rel_err=dw_err, **t)


def check_grouped_bwd(device) -> dict:
    """Phase 4's K5b: every (rows, segments, Z) of a packed training
    microbatch (with K5 forward on the float32 5D weight), timed; the
    edges in bf16 and float32, twice each for bit-equal results."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(6)
    rows = [k5b_row(gen, device, n, segs, z, "train")
            for n, segs, z in k5_shapes(train=True)]
    seen = []
    for n, segs, z, *off in K5_EDGE:
        got = []
        for dt in (torch.bfloat16, torch.float32):
            x, w = k5_inputs(gen, device, n, segs, z, dt, True,
                             torch.float32, *off)
            g = randn(gen, n, x.shape[1], device=device).to(dt)
            got.append(k5b_agrees(x, g, w, z, segs, True,
                                  f"edge {n}x{segs}x{z}",
                                  "staged" if off else None)[2])
            x, w = k5_inputs(gen, device, n, segs, z, dt, False,
                             torch.float32, *off)
            k5b_agrees(x, g, w, z, segs, False, f"edge {n}x{segs}x{z}",
                       "staged" if off else None)
        seen.append(f"({n}, {segs}, z {z})"
                    + (f" at offset {off[0]}" if off else "")
                    + f" bf16 {got[0]}, f32 {got[1]}")
    log("K5b edge shapes agree, bf16 and f32, both weight layouts, "
        f"deterministic: {'; '.join(seen)}")
    return {"grouped_rmsnorm_bwd": rows}


# ---------------------------------------------------------------------------
# phase 3, continued: K6, the packed ResBlock's residual sum and conv biases
# ---------------------------------------------------------------------------

# K6 and its plain version (the eager bias adds, then the sum) round the
# same adds once each in the same order, so they agree bit for bit, bf16
# and float32 alike.
# edge shapes (rows, width, skip[, element offset of h]): widths that are
# not a multiple of 8 (scalar), Z = 1 of the narrowest ResBlock (64), a
# misaligned h (scalar), zero rows, one row, ragged row counts, and the
# widest rows of the presets (Z = 8 x 512)
K6_EDGE = [(129, 100, "conv"), (77, 100, "x"), (1000, 64, "conv"),
           (333, 256, "x", 1), (513, 128, "conv", 3), (0, 256, "conv"),
           (1, 1024, "x"), (4097, 520, "conv"), (257, 4096, "conv")]


def k6_shapes(conf=None) -> list:
    """The (rows, width, skip) that the block-major chain's UNet call
    gives K6, largest first (``scripts/kernel_shapes.py``)."""
    from collections import Counter
    k6 = Counter()
    kernel_shapes().per_call_shapes(conf=conf, k6=k6)
    return sorted(k6, key=lambda s: (-s[0] * s[1], s[2]))


def k6_inputs(g, device, n, width, skip, dt, offset=0):
    """(h (n, width) ``offset`` elements past 16 bytes, its bias, s, the
    skip conv's bias or None) in ``dt``: products of a standard normal's
    spread, biases half of it."""
    h = randn(g, n * width + offset, device=device).to(dt)[offset:]
    hb = (0.5 * randn(g, width, device=device)).to(dt)
    sb = (0.5 * randn(g, width, device=device)).to(dt) \
        if skip == "conv" else None
    return (h.view(n, width), hb, randn(g, n, width, device=device).to(dt),
            sb)


def k6_agrees(h, hb, s, sb, what, want=None):
    """K6 against ``residual_plain``: bit-equal (bf16 and float32), the
    variant the rule names (or ``want``) required; returns the variant."""
    import torch

    from tera_mind_tpu_torch.ops import residual_kernel as k6
    out, variant = variant_of(k6, k6.residual_cuda, h, hb, s, sb)
    ref = k6.residual_plain(h, hb, s, sb)
    if want is None:
        want = k6.residual_variant(h.shape[-1], h.element_size(), all(
            t.data_ptr() % 16 == 0 for t in (h, hb, s) + (
                () if sb is None else (sb,))))
    require(variant == want, f"K6 {what} {h.dtype} took {variant}, not "
            f"{want}")
    require(out.dtype == ref.dtype and torch.equal(out, ref),
            f"K6 {what} {h.dtype} ({variant}): not bit-equal to the plain "
            f"sequence, max |d| "
            f"{float((out.float() - ref.float()).abs().max())}")
    return variant


def time_k6(h, hb, s, sb) -> dict:
    """Device times of K6 and its plain sequence (CUDA graph replays, h
    and s copied past the L2) beside its bound; no single PyTorch call
    computes it."""
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    n, width = h.shape
    sets = input_sets((h, s), 2 * h.numel() * h.element_size())
    bms, by = bound(*kernel_work("K6", (n, width, k6.skip_kind(sb)),
                                 h.element_size()))
    return dict(ms=device_ms(lambda a, b: k6.residual_cuda(a, hb, b, sb),
                             sets),
                plain_ms=device_ms(lambda a, b: k6.residual_plain(a, hb, b,
                                                                  sb), sets),
                library_ms=None, bound_ms=bms, bound_by=by)


def k6_row(g, device, n, width, skip, path, timed=True) -> dict:
    """K6 at (n, width, skip) in bf16 and float32, each bit-equal to its
    plain version; timed in bf16."""
    import torch
    h, hb, s, sb = k6_inputs(g, device, n, width, skip, torch.bfloat16)
    variant = k6_agrees(h, hb, s, sb, f"({n}, {width}, {skip})")
    variant_f = k6_agrees(*(None if t is None else t.float()
                            for t in (h, hb, s, sb)),
                          f"({n}, {width}, {skip})")
    t = time_k6(h, hb, s, sb) if timed else {}
    log(f"K6 residual ({n}, {width}, skip {skip}) bf16 [{variant}, {path}]"
        f": bit-equal to the plain sequence; f32 [{variant_f}] bit-equal"
        + ("; " + timing_text(t, "-") if t else ""))
    return dict(shape=[n, width, skip], path=path, variant=variant,
                max_abs_err=0.0, **t)


def check_k6_edges(g, device) -> None:
    """K6 bit-equal to its plain version at ``K6_EDGE``, bf16 and float32
    (zero rows: no launch, an empty output); the wrapper's refusals before
    any launch (h and s of two shapes, a bias of another width or dtype,
    an input that requires grad under grad mode: the raw launcher, which
    runs it under ``torch.no_grad()``); the dispatcher under autograd (no
    launch: the plain sequence, recorded); the C entry point's refusals
    (``vector`` at a width that is not a multiple of 16 bytes and on a
    misaligned tensor, an unknown variant and dtype, no rows)."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    seen = []
    for n, width, skip, *off in K6_EDGE:
        got = []
        for dt in (torch.bfloat16, torch.float32):
            h, hb, s, sb = k6_inputs(g, device, n, width, skip, dt, *off)
            if n == 0:
                before = k6.launches
                out = k6.residual_cuda(h, hb, s, sb)
                require(out.shape == h.shape and k6.launches == before,
                        "K6 at zero rows launched or changed the shape")
                got.append("no launch")
                continue
            got.append(k6_agrees(h, hb, s, sb, f"edge ({n}, {width}, {skip})",
                                 "scalar" if off else None))
        seen.append(f"({n}, {width}, {skip})"
                    + (f" at offset {off[0]}" if off else "")
                    + f" {'/'.join(got)}")
    h, hb, s, sb = k6_inputs(g, device, 64, 128, "conv", torch.bfloat16)
    before = k6.launches
    refused = {}
    for what, args in (("s of another shape", (h, hb, s[:32], sb)),
                       ("a bias of another width", (h, hb[:64], s, sb)),
                       ("a float32 bias", (h, hb, s, sb.float())),
                       ("a float32 s", (h, hb, s.float(), sb))):
        try:
            k6.residual_cuda(*args)
        except ValueError as err:
            refused[what] = str(err)[:50]
    hg = h.detach().requires_grad_(True)
    try:
        k6.residual_cuda(hg, hb, s, sb)
    except RuntimeError as err:
        refused["an input that requires grad"] = str(err)[:50]
    require(len(refused) == 5 and k6.launches == before,
            f"K6 wrapper took a call it must refuse: {refused}")
    with torch.no_grad():
        require(torch.equal(k6.residual_cuda(hg, hb, s, sb),
                            k6.residual_plain(h, hb, s, sb)),
                "K6 under no_grad differs from its plain version")
    out = k6.residual(hg, hb, s, sb)
    grad, = torch.autograd.grad(out.float().sum(), hg)
    require(k6.launches == before + 1 and out.grad_fn is not None
            and bool((grad == 1).all()),
            "K6's dispatcher under autograd: "
            f"{k6.launches - before - 1} launches, grad_fn {out.grad_fn}")
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    t = torch.zeros(64 * 128 + 8, device=device, dtype=torch.bfloat16)
    vec = k6.VARIANTS.index("vector")
    errs = {}
    for what, off, width, rows, dtype, variant in (
            ("vector at width 100", 0, 100, 64, 1, vec),
            ("vector misaligned", 1, 128, 32, 1, vec),
            ("unknown variant", 0, 128, 32, 1, 7),
            ("unknown dtype", 0, 128, 32, 5, vec),
            ("no rows", 0, 128, 0, 1, vec)):
        a = t[off:].data_ptr()
        errs[what] = lib.tmt_residual(a, a, a, a, a, rows, width, dtype,
                                      variant, stream)
    torch.cuda.synchronize()
    require(all(e != 0 for e in errs.values()),
            f"tmt_residual took a call it must refuse: {errs}")
    log(f"K6 edge shapes bit-equal (bf16/f32): {'; '.join(seen)}; the "
        f"wrapper refuses {refused}; the dispatcher under autograd runs "
        f"the plain sequence; the entry point refuses (error codes) {errs}")


def check_fold_route(device) -> dict:
    """The folded ResBlock (K5 adds in_conv's bias, one K6 launch adds
    out_conv's and skip_conv's and the residual) against the same block
    with ``fold = False`` (cuDNN's convs with their biases, the eager
    adds) on the same input on the card: bit-equal in bf16 at main-path
    widths (a concat input with a skip conv at 64^2 x 81 patches, a down
    block, an up block, the 5D parameters' ``Conv3DAsPacked``), and in
    float32; each folded call exactly one K6 launch and one K5 launch
    with the bias."""
    import torch

    from tera_mind_tpu_torch.models.nn import channels_last_, init_weights
    from tera_mind_tpu_torch.models.unet_packed import PackedResBlock
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    conf = kernel_shapes().preset_conf().make_model_conf()
    emb_c, z = conf.embed_channels, conf.z_size
    g = torch.Generator(device="cpu").manual_seed(23)
    out = {}
    for what, cin, cout, kw, b, hw, dt in (
            ("concat + skip conv", 96, 64, dict(in_segments=(64, 32)), 81,
             64, torch.bfloat16),
            ("down", 64, 64, dict(down=True), 81, 64, torch.bfloat16),
            ("up", 256, 256, dict(up=True), 64, 16, torch.bfloat16),
            ("from_5d + skip conv", 96, 64,
             dict(in_segments=(64, 32), from_5d=True), 16, 32,
             torch.bfloat16),
            ("float32 + skip conv", 96, 64, dict(in_segments=(64, 32)), 16,
             32, torch.float32)):
        blk = PackedResBlock(cin, cout, z, emb_c, use_zero_module=False,
                             **kw)
        blk = channels_last_(init_weights(blk, 7).to(device, dt)).eval()
        with torch.no_grad():
            for p in blk.parameters():   # biases and norms off their init
                if p.dim() == 1:
                    p.add_(0.1 * randn(g, *p.shape, device=device).to(dt))
        x = randn(g, b, hw, hw, z * cin, device=device).to(dt)
        emb = randn(g, b, emb_c, device=device).to(dt)
        with torch.inference_mode():
            before = (k6.launches, k5.launches_by_prologue["bias"])
            folded = blk(x, emb)
            got = (k6.launches - before[0],
                   k5.launches_by_prologue["bias"] - before[1])
            blk.fold = False
            eager = blk(x, emb)
        torch.cuda.synchronize()
        require(got == (1, 1), f"fold route {what}: {got[0]} K6 and "
                f"{got[1]} K5 launches with the bias, not 1 and 1")
        require(torch.equal(folded, eager), f"fold route {what} {dt}: not "
                "bit-equal to the eager sequence, max |d| "
                f"{float((folded.float() - eager.float()).abs().max())}")
        out[what] = list(folded.shape)
    log(f"the folded ResBlock is bit-equal to the eager one on the card: "
        f"{out}")
    return out


def check_residual_kernels(device) -> dict:
    """Phase 3's K6: every (rows, width, skip) of the block-major chain,
    bf16 and float32 bit-equal, timed; the edges and refusals; the folded
    ResBlock against the eager one."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(6)
    rows = [k6_row(g, device, n, width, skip, "block_major")
            for n, width, skip in k6_shapes()]
    check_k6_edges(g, device)
    check_fold_route(device)
    return {"residual": rows}


# ---------------------------------------------------------------------------
# phase 3, continued: K1's modulate epilogue and K7, the DiT block's fold
# ---------------------------------------------------------------------------

# K1 with the modulate and K7 round each step where the eager ops do, so:
# K7 is bit-equal to its plain version (x + gate * y), bf16 and float32;
# K1's modulate is bit-equal to the plain modulate applied to K1's own norm
# (the same launch with a zero scale and shift, whose norm must be K1's
# without the epilogue, bit for bit, and within K1's gate of the plain
# norm).  Against the whole plain sequence the norm's statistics, summed
# in another order, move a few outputs by a rounding step, as K1's own do.
# edge shapes (rows, C[, element offset of x and of the adaLN output, or
# (0, k): the adaLN output alone k elements off]): a C that is not a
# multiple of 8 (K1 strided, K7 scalar), C = 33 (half-warp rows), a row
# wider than K1's registers (the wide kernel), one row, zero rows, both
# bases misaligned, the adaLN output alone misaligned (K1 strided, K7
# scalar on an aligned x)
DIT_EDGE = [(77, 100), (129, 33), (33, 2050), (1, 256), (0, 256),
            (333, 256, 1), (513, 512, 0, 3), (4097, 64)]


def dit_shapes(conf=None, packed: bool = True) -> list:
    """The (rows, C) that the block-major chain's UNet call gives K1's
    modulate and K7 (the same), largest first
    (``scripts/kernel_shapes.py``)."""
    from collections import Counter
    k7 = Counter()
    kernel_shapes().per_call_shapes(packed, conf=conf, k7=k7)
    return sorted(k7, key=lambda s: -s[0] * s[1])


def dit_inputs(g, device, n, c, dt, offsets=(0, 0)):
    """(x (n, c), the adaLN output (n, 7c), y (n, c), the norm's weight)
    in ``dt``; x and the adaLN output ``offsets`` elements past 16 bytes.
    The adaLN output is what the DiT block chunks: shift, scale and gate
    are its first three (n, c) column blocks."""
    import torch
    x = randn(g, n * c + offsets[0], device=device).to(dt)[offsets[0]:]
    ada = (0.5 * randn(g, n * 7 * c + offsets[1], device=device)).to(dt)
    ada = ada[offsets[1]:].view(n, 7 * c)
    y = randn(g, n, c, device=device).to(dt)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, dt)
    return x.view(n, c), ada, y, w


def chunks(ada, c):
    """(shift, scale, gate): the adaLN output's views as the DiT block
    takes them (``chunk(7, -1)``)."""
    return ada[:, :c], ada[:, c:2 * c], ada[:, 2 * c:3 * c]


def zeros_like_layout(t):
    """Zeros with t's shape, strides, storage offset and so its 16-byte
    phase (a new allocation starts on 16 bytes, as t's storage does)."""
    import torch
    base = torch.zeros(t.untyped_storage().nbytes() // t.element_size(),
                       device=t.device, dtype=t.dtype)
    return base.as_strided(t.shape, t.stride(), t.storage_offset())


def k1m_agrees(x, w, ada, what, want=None) -> tuple:
    """K1 with the modulate on x and the adaLN output's scale and shift:
    (the largest |out - the whole plain sequence|, its variant).  Required:
    the variant the rule names (or ``want``); out bit-equal to the plain
    modulate of the launch's own norm (the same launch on zero scale and
    shift); that norm bit-equal to K1's without the epilogue where both
    take one variant, and within K1's gate of the plain norm."""
    import torch

    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    c = x.shape[-1]
    shift, scale, _ = chunks(ada, c)
    out, variant = variant_of(k1, k1.rmsnorm_modulate_cuda, x, w, scale,
                              shift)
    zero = zeros_like_layout(ada)
    zshift, zscale, _ = chunks(zero, c)
    y0, v0 = variant_of(k1, k1.rmsnorm_modulate_cuda, x, w, zscale, zshift)
    if want is None:
        item = x.element_size()
        want = k1.rmsnorm_modulate_variant(
            c, item, x.data_ptr() % 16 == 0,
            ada.data_ptr() % 16 == 0 and 7 * c * item % 16 == 0)
    tag = f"K1 modulate {what} {x.dtype}"
    require(variant == want == v0, f"{tag} took {variant} ({v0} on zero "
            f"scale), not {want}")
    require(out.dtype == x.dtype and torch.equal(
        out, k1.modulate_plain(y0, scale, shift)),
        f"{tag} ({variant}): not bit-equal to the plain modulate of its "
        f"own norm")
    plain_norm = k1.rmsnorm_plain(x, w)
    bf = x.dtype == torch.bfloat16
    err = ulp_err(y0, plain_norm) if bf else float(
        (y0 - plain_norm).abs().max())
    require(err <= (K1_MAX_ULP if bf else 1e-5),
            f"{tag} ({variant}): its norm is {err} from the plain norm")
    y1, v1 = variant_of(k1, k1.rmsnorm_cuda, x, w)
    require(v1 != variant or torch.equal(y0, y1),
            f"{tag} ({variant}): its norm differs from K1's own")
    ref = k1.rmsnorm_modulate_plain(x, w, scale, shift)
    return float((out.float() - ref.float()).abs().max()), variant


def k7_agrees(x, ada, y, what, want=None) -> str:
    """K7 on x, the adaLN output's gate and y against
    ``gated_residual_plain``: bit-equal, the variant the rule names (or
    ``want``) required; returns the variant."""
    import torch

    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    c = x.shape[-1]
    gate = chunks(ada, c)[2]
    out, variant = variant_of(k7, k7.gated_residual_cuda, x, gate, y)
    ref = k7.gated_residual_plain(x, gate, y)
    if want is None:
        want = k7.gated_variant(c, 7 * c, x.element_size(), all(
            t.data_ptr() % 16 == 0 for t in (x, gate, y)))
    require(variant == want, f"K7 {what} {x.dtype} took {variant}, not "
            f"{want}")
    require(out.dtype == ref.dtype and torch.equal(out, ref),
            f"K7 {what} {x.dtype} ({variant}): not bit-equal to the plain "
            f"sequence, max |d| "
            f"{float((out.float() - ref.float()).abs().max())}")
    return variant


def time_dit(x, w, ada, y) -> tuple:
    """Device times (CUDA graph replays, inputs copied past the L2) of K1
    with the modulate beside its plain sequence, the sequence the path
    ran before (K1, then the eager modulate: ``eager_ms``) and its bound
    (no single PyTorch call computes it), and of K7 beside its plain
    sequence, ``torch.addcmul`` (x + gate * y in one call, rounded once)
    and its bound."""
    import torch

    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    n, c = x.shape
    item = x.element_size()
    # what a call reads: x, y and three of the adaLN output's seven
    # chunks at most
    sets = input_sets((x, ada, y), 3 * x.numel() * item)

    def mod(fn):
        return lambda a, d, _: fn(a, w, d[:, c:2 * c], d[:, :c])

    def gated(fn):
        return lambda a, d, b: fn(a, d[:, 2 * c:3 * c], b)
    bms, by = bound(*kernel_work("K1m", (n, c), item))
    t1 = dict(ms=device_ms(mod(k1.rmsnorm_modulate_cuda), sets),
              plain_ms=device_ms(mod(k1.rmsnorm_modulate_plain), sets),
              eager_ms=device_ms(mod(lambda a, b, s, h: k1.modulate_plain(
                  k1.rmsnorm_cuda(a, b), s, h)), sets),
              library_ms=None, bound_ms=bms, bound_by=by)
    bms, by = bound(*kernel_work("K7", (n, c), item))
    t7 = dict(ms=device_ms(gated(k7.gated_residual_cuda), sets),
              plain_ms=device_ms(gated(k7.gated_residual_plain), sets),
              library_ms=device_ms(gated(torch.addcmul), sets),
              bound_ms=bms, bound_by=by)
    return t1, t7


def dit_row(g, device, n, c, path, timed=True) -> tuple:
    """K1 with the modulate and K7 at (n, c) in bf16 and float32 (the
    DiT block's layout: scale, shift and gate chunks of an (n, 7c)
    adaLN output), each held as ``k1m_agrees`` and ``k7_agrees`` hold
    it; timed in bf16.  Returns (K1 modulate's row, K7's row)."""
    import torch
    x, ada, y, w = dit_inputs(g, device, n, c, torch.bfloat16)
    err, v1 = k1m_agrees(x, w, ada, f"({n}, {c})")
    v7 = k7_agrees(x, ada, y, f"({n}, {c})")
    errf, v1f = k1m_agrees(x.float(), w.float(), ada.float(),
                           f"({n}, {c})")
    v7f = k7_agrees(x.float(), ada.float(), y.float(), f"({n}, {c})")
    t1, t7 = time_dit(x, w, ada, y) if timed else ({}, {})
    log(f"K1 modulate ({n}, {c}) bf16 [{v1}, {path}]: bit-equal to the "
        f"plain modulate of its norm, {err:.3g} from the whole plain "
        f"sequence; f32 [{v1f}] {errf:.3g}"
        + (f"; {timing_text(t1, '-')}; K1 + eager modulate "
           f"{t1['eager_ms']:.4f} ms" if t1 else ""))
    log(f"K7 gated_residual ({n}, {c}) bf16 [{v7}, {path}]: bit-equal to "
        f"the plain sequence; f32 [{v7f}] bit-equal"
        + ("; " + timing_text(t7, "torch.addcmul") if t7 else ""))
    return (dict(shape=[n, c], path=path, variant=v1, max_abs_err=err,
                 **t1),
            dict(shape=[n, c], path=path, variant=v7, max_abs_err=0.0,
                 **t7))


def check_dit_edges(g, device) -> None:
    """K1's modulate and K7 at ``DIT_EDGE``, bf16 and float32, held as
    ``dit_row`` holds them (zero rows: no launch, an empty output); the
    wrappers' refusals before any launch (a scale, shift or gate of
    another shape or dtype, channels not contiguous, rows not one stride
    apart, an input that requires grad under grad mode); the
    dispatchers under autograd (no launch: the eager sequence, recorded);
    the C entry points' refusals (``vector`` at a C, stride or base it
    cannot take, strides under C, an unknown variant or dtype, no
    rows)."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    seen = []
    for n, c, *off in DIT_EDGE:
        offsets = (off[0], off[-1]) if off else (0, 0)
        got = []
        for dt in (torch.bfloat16, torch.float32):
            x, ada, y, w = dit_inputs(g, device, n, c, dt, offsets)
            shift, scale, gate = chunks(ada, c)
            if n == 0:
                before = (k1.launches, k7.launches)
                o1 = k1.rmsnorm_modulate_cuda(x, w, scale, shift)
                o7 = k7.gated_residual_cuda(x, gate, y)
                require(o1.shape == o7.shape == x.shape
                        and (k1.launches, k7.launches) == before,
                        "K1 modulate or K7 at zero rows launched or changed "
                        "the shape")
                got.append("no launch")
                continue
            _, v1 = k1m_agrees(x, w, ada, f"edge ({n}, {c}) {offsets}")
            v7 = k7_agrees(x, ada, y, f"edge ({n}, {c}) {offsets}")
            got.append(f"{v1}+{v7}")
        seen.append(f"({n}, {c})" + (f" at offsets {offsets}" if off
                                     else "") + f" {'/'.join(got)}")
    x, ada, y, w = dit_inputs(g, device, 64, 128, torch.bfloat16)
    shift, scale, gate = chunks(ada, 128)
    before = (k1.launches, k7.launches)
    refused = {}
    for what, fn, args in (
            ("K1: a scale of another shape", k1.rmsnorm_modulate_cuda,
             (x, w, scale[:32], shift)),
            ("K1: a float32 shift", k1.rmsnorm_modulate_cuda,
             (x, w, scale, shift.float())),
            ("K1: channels not contiguous", k1.rmsnorm_modulate_cuda,
             (x, w, ada[:, :256:2], shift)),
            ("K1: rows not one stride apart", k1.rmsnorm_modulate_cuda,
             (x.view(8, 8, 128), w, ada.view(8, 8, 896)[:, :, :128]
              .transpose(0, 1), shift.view(8, 8, 128))),
            ("K7: a gate of another shape", k7.gated_residual_cuda,
             (x, gate[:32], y)),
            ("K7: a float32 y", k7.gated_residual_cuda,
             (x, gate, y.float())),
            ("K7: gate channels not contiguous", k7.gated_residual_cuda,
             (x, ada[:, :256:2], y))):
        try:
            fn(*args)
        except ValueError as err:
            refused[what] = str(err)[:50]
    xg = x.detach().requires_grad_(True)
    for what, fn, args in (("K1: x requires grad", k1.rmsnorm_modulate_cuda,
                            (xg, w, scale, shift)),
                           ("K7: x requires grad", k7.gated_residual_cuda,
                            (xg, gate, y))):
        try:
            fn(*args)
        except RuntimeError as err:
            refused[what] = str(err)[:50]
    require(len(refused) == 9 and (k1.launches, k7.launches) == before,
            f"K1 modulate / K7 wrappers took a call they must refuse: "
            f"{refused}")
    # under autograd the dispatchers run the eager sequence: K1 through
    # its Function (one K1 launch without the epilogue), no K7
    mod_before = k1.launches_by_epilogue["modulate"]
    o1 = k1.rmsnorm_modulate(xg, w, scale, shift)
    o7 = k7.gated_residual(xg, gate, y)
    gx, = torch.autograd.grad((o1.float().sum() + o7.float().sum()), xg)
    require(k7.launches == before[1] and k1.launches == before[0] + 1
            and k1.launches_by_epilogue["modulate"] == mod_before
            and o1.grad_fn is not None and o7.grad_fn is not None
            and bool(torch.isfinite(gx.float()).all()),
            "the DiT dispatchers under autograd: K1 "
            f"{k1.launches - before[0]} launches, K7 "
            f"{k7.launches - before[1]}")
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    t = torch.zeros(64 * 7 * 128 + 8, device=device, dtype=torch.bfloat16)
    vec1, vec7 = k1.VARIANTS.index("vector"), k7.VARIANTS.index("vector")
    errs = {}
    a, m = t.data_ptr(), t[1:].data_ptr()
    for what, xp, sp, c, rows, ss, dtype, variant in (
            ("K1 vector, scale misaligned", a, m, 128, 32, 896, 1, vec1),
            ("K1 vector, a stride not of 16 bytes", a, a, 128, 32, 900, 1,
             vec1),
            ("K1 scale stride under C", a, a, 128, 32, 64, 1, 0),
            ("K1 unknown variant", a, a, 128, 32, 896, 1, 7),
            ("K1 no rows", a, a, 128, 0, 896, 1, vec1)):
        errs[what] = lib.tmt_rmsnorm_modulate(
            xp, a, a, rows, c, 1e-6, dtype, dtype, variant, sp, sp, ss, ss,
            stream)
    for what, xp, c, rows, gs, dtype, variant in (
            ("K7 vector at C 100", a, 100, 32, 700, 1, vec7),
            ("K7 vector misaligned", m, 128, 32, 896, 1, vec7),
            ("K7 vector, a stride not of 16 bytes", a, 128, 32, 900, 1,
             vec7),
            ("K7 gate stride under C", a, 128, 32, 64, 1, 0),
            ("K7 unknown dtype", a, 128, 32, 896, 5, vec7),
            ("K7 no rows", a, 128, 0, 896, 1, vec7)):
        errs[what] = lib.tmt_gated_residual(xp, a, a, a, rows, c, gs, dtype,
                                            variant, stream)
    torch.cuda.synchronize()
    require(all(e != 0 for e in errs.values()),
            f"tmt_rmsnorm_modulate / tmt_gated_residual took a call they "
            f"must refuse: {errs}")
    log(f"K1 modulate / K7 edge shapes (bf16/f32): {'; '.join(seen)}; the "
        f"wrappers refuse {refused}; the dispatchers under autograd run "
        f"the eager sequence; the entry points refuse (error codes) {errs}")


def dit_block_widths(conf=None, packed: bool = True) -> list:
    """[(hidden C, cond channels, heads, patches, z, side)] of the DiT
    blocks one block-major UNet call runs, each kind once (built on the
    meta device; its resolution from the K7 rows it records)."""
    import torch

    from tera_mind_tpu_torch.models.attention import DiTBlock
    ks = kernel_shapes()
    conf = (conf or ks.preset_conf()).make_model_conf()
    with torch.device("meta"):
        model = ks.make_packed_model(conf) if packed else conf.make_model()
    return sorted({(m.hidden_size, m.adaLN.in_features,
                    m.attn.num_heads) for m in model.modules()
                   if isinstance(m, DiTBlock)})


def check_dit_route(device) -> dict:
    """The DiT block with its fold (each norm's modulate in K1, each
    gated residual one K7 launch) against the same block's eager sequence
    (K1, then the eager modulate; the eager ``x + gate * y``: the
    dispatchers' plain versions, which the block ran before) on the same
    input on the card: bit-equal in bf16 at the 638850 chain's widths and
    token counts (5D and packed token order), and in float32; each folded
    call exactly two K1 launches with the modulate and two K7 launches,
    the eager one none."""
    import torch

    from tera_mind_tpu_torch.models import attention as attn_mod
    from tera_mind_tpu_torch.models.attention import DiTBlock
    from tera_mind_tpu_torch.models.nn import init_weights
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    conf = kernel_shapes().preset_conf().make_model_conf()
    z = conf.z_size
    g = torch.Generator(device="cpu").manual_seed(24)
    widths = dit_block_widths()
    out = {}
    cases = []
    for c, cond, heads in widths:
        side = 16 if c == min(w[0] for w in widths) else 8
        for b in (81, 64):
            cases.append((f"C {c} 5D x {b}", c, cond, heads, b, side,
                          False, torch.bfloat16))
    c, cond, heads = widths[0]
    cases += [(f"C {c} packed tokens", c, cond, heads, 81, 16, True,
               torch.bfloat16),
              (f"C {c} float32", c, cond, heads, 4, 16, False,
               torch.float32)]
    eager = (lambda x, w, s, h, eps: k1.modulate_plain(
        k1.rmsnorm(x, w, eps), s, h), k7.gated_residual_plain)
    for what, c, cond, heads, b, side, packed, dt in cases:
        blk = DiTBlock(c, cond, heads, n_win=2, packed_tokens=packed)
        blk = init_weights(blk, 7).to(device, dt).eval()
        with torch.no_grad():
            for p in blk.parameters():   # the adaLN zero init and norms off
                p.add_(0.05 * randn(g, *p.shape, device=device).to(dt))
        shape = ((b, side, side, z * c) if packed else (b, z, side, side, c))
        cshape = ((b, side, side, z * cond) if packed
                  else (b, z, side, side, cond))
        x = randn(g, *shape, device=device).to(dt)
        cnd = randn(g, *cshape, device=device).to(dt)
        with torch.inference_mode():
            before = (k1.launches_by_epilogue["modulate"], k7.launches)
            folded = blk(x, cnd, z)
            got = (k1.launches_by_epilogue["modulate"] - before[0],
                   k7.launches - before[1])
            saved = attn_mod.rmsnorm_modulate, attn_mod.gated_residual
            attn_mod.rmsnorm_modulate, attn_mod.gated_residual = eager
            try:
                before = (k1.launches_by_epilogue["modulate"], k7.launches)
                ref = blk(x, cnd, z)
                got_eager = (k1.launches_by_epilogue["modulate"] - before[0],
                             k7.launches - before[1])
            finally:
                attn_mod.rmsnorm_modulate, attn_mod.gated_residual = saved
        torch.cuda.synchronize()
        require(got == (2, 2) and got_eager == (0, 0),
                f"DiT route {what}: {got} K1 modulate and K7 launches "
                f"folded, {got_eager} eager; expected (2, 2) and (0, 0)")
        require(torch.equal(folded, ref), f"DiT route {what}: not "
                "bit-equal to the eager sequence, max |d| "
                f"{float((folded.float() - ref.float()).abs().max())}")
        out[what] = list(folded.shape)
    log(f"the folded DiT block is bit-equal to the eager one on the card: "
        f"{out}")
    return out


def check_dit_kernels(device) -> dict:
    """Phase 3's K1 modulate and K7: every (rows, C) of the block-major
    chain, bf16 and float32, timed; the edges and refusals; the folded
    DiT block against the eager one."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(21)
    pairs = [dit_row(g, device, n, c, "block_major")
             for n, c in dit_shapes()]
    check_dit_edges(g, device)
    check_dit_route(device)
    return {"rmsnorm_modulate": [p[0] for p in pairs],
            "gated_residual": [p[1] for p in pairs]}


def check_variant_refusal(device) -> None:
    """The attention kernels' and the backward kernels' C entry points
    refuse a variant that cannot take the call (an error code, no
    launch): K2b ``tensor_core`` on float32, on N = 256 and on a
    misaligned gradient, an unknown variant; K2 and K2b
    ``tensor_core_tiled`` on float32, at D = 72 and on a misaligned
    tensor; K2 ``wgmma`` on float32, at D = 72, on a misaligned tensor,
    at (512, 256) and (64, 384) (outside ``wgmma_takes``); K2b ``wgmma``
    on float32, on a misaligned tensor, at D = 64 and (256, 192) (outside
    ``wgmma_bwd_takes``); K1 and K1b ``vector`` on C = 741
    and on a misaligned x, K1 ``vector`` and ``strided`` with a bf16
    weight for a float32 x and ``vector`` with a float32 weight one
    element off 16 bytes, an unknown variant of each.  K1 ``vector`` takes
    a float32 weight of a bf16 x."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    tc, cc = k2.VARIANTS.index("tensor_core"), k2.VARIANTS.index("cuda_core")
    tiled = k2.VARIANTS.index("tensor_core_tiled")
    wgmma = k2.VARIANTS.index("wgmma")

    def k2b(dtype, n, variant, offset=0, d=64):
        t = torch.zeros(4 * n * d + 8, device=device, dtype=dtype)
        a = t[offset:offset + 4 * n * d]
        stats = torch.empty(4 * n * 3, device=device)
        return lib.tmt_window_attention_bwd(
            *(a.data_ptr(),) * 7, stats.data_ptr(), 4, n, d, 1 / d,
            _build.DTYPES[dtype], variant, stream)

    def k2(dtype, n, variant, offset=0, d=64):
        t = torch.zeros(4 * n * d + 8, device=device, dtype=dtype)
        a = t[offset:offset + 4 * n * d]
        o = torch.empty(4 * n * d, device=device, dtype=dtype)
        return lib.tmt_window_attention(
            *(a.data_ptr(),) * 3, o.data_ptr(), 4, n, d, 1 / d,
            _build.DTYPES[dtype], variant, stream)

    bf16 = torch.bfloat16
    require(k2b(bf16, 32, tc) == 0 and k2b(torch.float32, 32, cc) == 0
            and k2b(bf16, 256, tiled) == 0 and k2(bf16, 256, tiled) == 0
            and k2(bf16, 256, wgmma) == 0 and k2(bf16, 32, wgmma, d=512) == 0
            and k2(bf16, 512, wgmma, d=128) == 0
            and k2b(bf16, 32, wgmma, d=512) == 0
            and k2b(bf16, 128, wgmma, d=256) == 0
            and k2b(bf16, 512, wgmma, d=128) == 0,
            "K2 / K2b entry refused calls its variants take")
    refused = {"tensor_core on float32": k2b(torch.float32, 32, tc),
               "tensor_core at N = 256": k2b(bf16, 256, tc),
               "tensor_core misaligned": k2b(bf16, 32, tc, offset=1),
               "variant 7": k2b(bf16, 32, 7),
               **{f"{name} tensor_core_tiled {why}": fn(*args)
                  for name, fn in (("K2", k2), ("K2b", k2b))
                  for why, args in (
                      ("on float32", (torch.float32, 256, tiled)),
                      ("at D = 72", (bf16, 256, tiled, 0, 72)),
                      ("misaligned", (bf16, 256, tiled, 1)))},
               **{f"K2 wgmma {why}": k2(*args) for why, args in (
                   ("on float32", (torch.float32, 128, wgmma)),
                   ("at D = 72", (bf16, 128, wgmma, 0, 72)),
                   ("misaligned", (bf16, 128, wgmma, 1)),
                   ("at (512, 256)", (bf16, 512, wgmma, 0, 256)),
                   ("at (64, 384)", (bf16, 64, wgmma, 0, 384)))},
               **{f"K2b wgmma {why}": k2b(*args) for why, args in (
                   ("on float32", (torch.float32, 128, wgmma, 0, 128)),
                   ("misaligned", (bf16, 128, wgmma, 1, 128)),
                   ("at D = 64", (bf16, 128, wgmma, 0, 64)),
                   ("at (256, 192)", (bf16, 256, wgmma, 0, 192)))}}
    vec, strided = k1.VARIANTS.index("vector"), k1.VARIANTS.index("strided")

    def k1b(c, variant, offset=0):
        t = torch.zeros(64 * c + 8, device=device, dtype=bf16)
        x = t[offset:offset + 64 * c]
        w = torch.ones(c, device=device)
        partial = torch.empty(8, c, device=device)
        return lib.tmt_rmsnorm_bwd(
            x.data_ptr(), x.data_ptr(), w.data_ptr(), x.data_ptr(),
            partial.data_ptr(), w.data_ptr(), 64, c, 8, 1e-6,
            _build.DTYPES[bf16], variant, stream)

    def k1(c, variant, dtype=bf16, w_dtype=bf16, offset=0, w_offset=0):
        t = torch.zeros(64 * c + 8, device=device, dtype=dtype)
        x = t[offset:offset + 64 * c]
        w = torch.ones(c + 8, device=device, dtype=w_dtype)[
            w_offset:w_offset + c]
        y = torch.empty(64 * c, device=device, dtype=dtype)
        return lib.tmt_rmsnorm(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 64, c, 1e-6,
            _build.DTYPES[dtype], _build.DTYPES[w_dtype], variant, stream)

    f32 = torch.float32
    require(k1b(96, vec) == 0 and k1b(741, strided) == 0
            and k1b(1524, strided) == 0,
            "K1b entry refused calls its variants take")
    require(k1(96, vec) == 0 and k1(96, vec, f32, f32) == 0
            and k1(96, vec, w_dtype=f32) == 0
            and k1(512, vec, w_dtype=f32) == 0
            and k1(741, strided) == 0 and k1(741, strided, w_dtype=f32) == 0
            and k1(1524, strided, w_dtype=f32) == 0,
            "K1 entry refused calls its variants take")
    refused.update({"K1b vector at C = 741": k1b(741, vec),
                    "K1b vector misaligned": k1b(96, vec, offset=1),
                    "K1b variant 7": k1b(96, 7),
                    "K1 vector at C = 741": k1(741, vec),
                    "K1 vector misaligned": k1(96, vec, offset=1),
                    "K1 vector, float32 weight off 16 bytes": k1(
                        96, vec, w_dtype=f32, w_offset=1),
                    "K1 vector, float32 x, bf16 weight": k1(96, vec, f32),
                    "K1 strided, float32 x, bf16 weight": k1(741, strided,
                                                             f32),
                    "K1 variant 7": k1(96, 7)})
    torch.cuda.synchronize()
    require(all(err != 0 for err in refused.values()),
            f"entry points took calls their variant cannot: {refused}")
    log(f"K1, K2, K1b and K2b entry points refuse (error codes): "
        f"{refused}")


# ---------------------------------------------------------------------------
# phase 4, continued: the raw launchers' autograd guard, the Functions
# ---------------------------------------------------------------------------

def check_autograd_guard(device) -> None:
    """Each raw forward launcher (``rmsnorm_cuda``, ``attention_cuda``,
    ``grouped_rmsnorm_cuda``) raises before the launch on a CUDA input
    that requires grad while grad mode is on, and runs the same call under
    ``torch.no_grad()``; the dispatchers (``rmsnorm``,
    ``window_attention``, ``grouped_rmsnorm_act``) record a backward
    instead: one forward and one backward kernel launch, finite
    gradients, and a float32 dw for a float32 weight."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(256, 96, generator=g).to(device, torch.bfloat16)
    w = torch.ones(96, device=device)
    q, k, v = (torch.randn(4, 32, 64, generator=g).to(device, torch.bfloat16)
               for _ in range(3))
    xg = torch.randn(256, 2 * 101, generator=g).to(device, torch.bfloat16)
    wg = torch.ones(101, device=device)     # the 5D float32 weight
    grouped = {"z": 2, "segments": (64, 37), "from_5d": True}
    cases = (("rmsnorm", k1, k1.rmsnorm_cuda, k1.rmsnorm, (x, w)),
             ("window_attention", k2, k2.attention_cuda, k2.window_attention,
              (q, k, v, 1.0 / 64)),
             ("grouped_rmsnorm", k5,
              lambda a, b: k5.grouped_rmsnorm_cuda(a, b, **grouped),
              lambda a, b: k5.grouped_rmsnorm_act(a, b, **grouped),
              (xg, wg)))
    for name, mod, raw, dispatch, args in cases:
        args = [a.detach().requires_grad_(True) if torch.is_tensor(a) else a
                for a in args]
        before = (mod.launches, mod.bwd.launches)
        refused = None
        try:
            raw(*args)
        except RuntimeError as err:
            refused = str(err)
        require(refused is not None and ("K1b and K2b" in refused
                                         or "K5b" in refused),
                f"{name} ran on an input that requires grad: {refused}")
        require((mod.launches, mod.bwd.launches) == before,
                f"{name} launched before refusing")
        with torch.no_grad():
            out = raw(*args)
        torch.cuda.synchronize()
        require(mod.launches == before[0] + 1 and out.grad_fn is None
                and bool(torch.isfinite(out.float()).all()),
                f"{name} under no_grad: launches {mod.launches - before[0]}")
        out = dispatch(*args)
        tensors = [a for a in args if torch.is_tensor(a)]
        grads = torch.autograd.grad(out.float().square().sum(), tensors)
        torch.cuda.synchronize()
        require((mod.launches, mod.bwd.launches)
                == (before[0] + 2, before[1] + 1),
                f"{name} dispatcher: forward launches "
                f"{mod.launches - before[0] - 1}, backward "
                f"{mod.bwd.launches - before[1]}; expected 1 and 1")
        require(all(bool(torch.isfinite(gr.float()).all()) for gr in grads),
                f"{name} dispatcher: gradients not finite")
        require(all(gr.dtype == a.dtype for gr, a in zip(grads, tensors)),
                f"{name} dispatcher: gradient dtypes "
                f"{[gr.dtype for gr in grads]}")
        log(f"{name}: raw launcher refused under grad mode "
            f"({refused[:60]}...), ran under no_grad; the dispatcher "
            "recorded its backward (1 forward + 1 backward launch, finite "
            "gradients)")


# ---------------------------------------------------------------------------
# phase 5: int8: K3 and K4 against their plain versions, timed, the C
# entry points' refusals, and small int8 chains
# ---------------------------------------------------------------------------

H100_INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core peak

# K3's (x (B, H, W, Ci), w (Co, kh, kw)) and K4's (rows, C, multiple) on
# the int8 main path, the same for int8 and int8_static
# (scripts/kernel_shapes.py --quant int8: one UNet call of 81 patches,
# collage decoder; 75 K3 launches, 117 K4 and 42 torch._int_mm a call)
K3_SHAPES = [
    ((81, 64, 64, 128), (128, 3, 3)), ((81, 64, 64, 192), (128, 1, 1)),
    ((81, 64, 64, 192), (128, 3, 3)), ((64, 64, 64, 128), (128, 3, 3)),
    ((64, 64, 64, 256), (256, 3, 3)), ((64, 64, 64, 320), (128, 1, 1)),
    ((64, 64, 64, 320), (128, 3, 3)), ((64, 64, 64, 448), (128, 1, 1)),
    ((64, 64, 64, 448), (128, 3, 3)), ((81, 32, 32, 128), (128, 3, 3)),
    ((81, 32, 32, 256), (256, 3, 3)), ((81, 32, 32, 384), (256, 1, 1)),
    ((81, 32, 32, 384), (256, 3, 3)), ((64, 32, 32, 256), (256, 3, 3)),
    ((64, 32, 32, 512), (256, 1, 1)), ((64, 32, 32, 512), (256, 3, 3)),
    ((64, 32, 32, 512), (512, 3, 3)), ((64, 32, 32, 640), (256, 1, 1)),
    ((64, 32, 32, 640), (256, 3, 3)), ((64, 32, 32, 896), (256, 1, 1)),
    ((64, 32, 32, 896), (256, 3, 3)), ((81, 16, 16, 256), (256, 3, 3)),
    ((81, 16, 16, 512), (512, 3, 3)), ((81, 16, 16, 768), (512, 1, 1)),
    ((81, 16, 16, 768), (512, 3, 3)), ((64, 16, 16, 512), (512, 3, 3)),
    ((64, 16, 16, 1024), (512, 1, 1)), ((64, 16, 16, 1024), (512, 3, 3)),
    ((64, 16, 16, 1024), (1024, 3, 3)), ((64, 16, 16, 1280), (512, 1, 1)),
    ((64, 16, 16, 1280), (512, 3, 3)), ((64, 16, 16, 1792), (512, 1, 1)),
    ((64, 16, 16, 1792), (512, 3, 3)), ((81, 8, 8, 512), (512, 3, 3)),
    ((81, 8, 8, 970), (1024, 1, 1)), ((81, 8, 8, 970), (1024, 3, 3)),
    ((81, 8, 8, 1024), (1024, 3, 3)), ((81, 8, 8, 1482), (1024, 1, 1)),
    ((81, 8, 8, 1482), (1024, 3, 3)), ((64, 8, 8, 1024), (1024, 3, 3)),
    ((64, 8, 8, 1994), (1024, 1, 1)), ((64, 8, 8, 1994), (1024, 3, 3)),
    ((64, 8, 8, 2506), (1024, 1, 1)), ((64, 8, 8, 2506), (1024, 3, 3))]
K4_SHAPES = [
    (331776, 128, 16), (331776, 192, 16), (262144, 128, 16),
    (262144, 256, 16), (262144, 320, 16), (262144, 448, 16),
    (82944, 128, 16), (82944, 256, 16), (82944, 384, 16), (65536, 256, 16),
    (65536, 512, 16), (65536, 640, 16), (65536, 896, 16), (41472, 128, 8),
    (41472, 256, 8), (41472, 1024, 8), (32768, 128, 8), (32768, 256, 8),
    (32768, 1024, 8), (20736, 256, 16), (20736, 512, 16), (20736, 768, 16),
    (16384, 512, 16), (16384, 1024, 16), (16384, 1280, 16),
    (16384, 1792, 16), (10368, 229, 8), (10368, 512, 8), (10368, 2048, 8),
    (5184, 512, 16), (5184, 970, 128), (5184, 1024, 16), (5184, 1482, 128),
    (4096, 1024, 16), (4096, 1994, 128), (4096, 2506, 128)]
# shapes off the main path: a deep concat input at B = 2, a ragged Ci
# (18, padded to 32) with Co = 24 at B = 1, 3x3 and 1x1, and 105 output
# rows (not a multiple of the 128-row tile) with H != W
K3_EDGE = [((2, 8, 8, 970), (1024, 3, 3)), ((1, 8, 8, 18), (24, 3, 3)),
           ((1, 8, 8, 18), (24, 1, 1)), ((3, 5, 7, 40), (16, 3, 3))]
# launches of K3 and K4, by variant, in a 2x2 chain of 125 UNet calls
# (5 steps, int8 and int8_static)
# (scripts/kernel_shapes.py --quant: every K3 shape takes wgmma; K4 is one
# launch a quantize, the dynamic abs-max included)
QUANT_LAUNCHES = {
    "int8": {"quant_conv": {"wgmma": 75 * 125, "mma_sync": 0},
             "quantize": {"dynamic": 117 * 125, "static": 0}},
    "int8_static": {"quant_conv": {"wgmma": 75 * 125, "mma_sync": 0},
                    "quantize": {"dynamic": 0, "static": 117 * 125}}}
# tests/test_quant.py's chain gates (mean |d|, correlation, mean shift,
# relative std shift), here for int8 against f32 chains and, set before the
# first chip run of them, for the card's int8 chain against the CPU's: the
# int8 chain is not continuous (a rounding decision that an f32 sum in
# another order moves changes an activation by a whole step), and a CPU
# rehearsal that moved every weight by 1e-6 of itself changed the small
# int8 chain by 0.0155 mean |d| (1.26 max), as much as int8 against f32
# (0.019), so a tolerance on the max would not separate right from wrong
CHAIN_GATES = {"mean": 0.03, "corr": 0.99, "mean_shift": 0.01,
               "std_rel": 0.02}


def k3_inputs(g, x_shape, w_shape, device, align=None):
    """Random int8 x and w with their channels zero-padded as K4 writes
    them and prequantize_params stores them (``conv_align``, or
    ``align``), positive f32 weight scales, an f32 bias and a positive
    activation scale (a scalar)."""
    import torch

    from tera_mind_tpu_torch.ops import quant_kernel as qk
    b, h, w, ci = x_shape
    co, kh, kw = w_shape
    cip = qk.round_up(ci, align or qk.conv_align(ci))
    xq, wq = (torch.randint(-127, 128, shape, dtype=torch.int8,
                            device=device,
                            generator=card_generator(g, device))
              for shape in ((b, h, w, cip), (co, kh, kw, cip)))
    xq[..., ci:] = 0
    wq[..., ci:] = 0
    scale = torch.rand(co, generator=g) * 1e-4 + 1e-6
    bias = torch.randn(co, generator=g)
    sx = torch.rand((), generator=g) * 1e-2 + 1e-4
    return tuple(t.to(device) for t in (xq, wq, scale, bias, sx))


def max_abs_diff(got, want) -> float:
    """The largest |got - want| (0.0 for empty tensors), in float64, so
    int32 sums and int8 values subtract exactly; a NaN against a NaN
    counts as 0."""
    import torch
    if got.numel() == 0:
        return 0.0
    g, w = got.to(torch.float64), want.to(torch.float64)
    d = torch.where(torch.isnan(g) & torch.isnan(w), 0.0, (g - w).abs())
    return float(d.max())


def k3_agrees(qk, xq, wq, scale, bias, what: str, variant: str,
              sx=None) -> float:
    """K3's ``variant`` bit-equal to its plain version: the int32 sums and
    the bf16 and float32 dequantized outputs (``sx`` the activation scale,
    None for 1); returns the largest |difference| over the outputs (0)."""
    import torch
    errs = []
    for out_dtype in (torch.int32, torch.bfloat16, torch.float32):
        args = (xq, wq) + ((None, None) if out_dtype == torch.int32
                           else (scale, bias))
        kw = {} if out_dtype == torch.int32 else {"x_scale": sx}
        (got, seen) = variant_of(qk.k3, qk.quant_conv_cuda, *args,
                                 out_dtype, variant=variant, **kw)
        torch.cuda.synchronize()
        want = qk.quant_conv_plain(*args, out_dtype, **kw)
        require(seen == variant, f"K3 {what}: launched {seen}, not "
                f"{variant}")
        require(got.dtype == out_dtype and torch.equal(got, want),
                f"K3 {variant} {what} {out_dtype}: "
                f"{int((got != want).sum())} outputs differ")
        errs.append(max_abs_diff(got, want))
    return max(errs)


def time_k3(qk, xq, wq, scale, bias, sx, x_shape, w_shape) -> dict:
    """Device times of K3 (bf16 out) in each variant that takes the shape
    (``ms``: the variant the plan picks), its plain version and the
    yardstick: cuDNN's bf16 convolution of the same shape, channels-last
    (not the same function: the time int8 has to beat), beside K3's
    bound."""
    import torch
    import torch.nn.functional as F
    b, h, w, ci = x_shape
    co, kh, kw = w_shape
    cip = xq.shape[-1]
    sets = input_sets((xq, wq, scale, bias, sx), xq.numel() + wq.numel())
    xb = torch.randn(b, ci, h, w, device=xq.device, dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last)
    wb = torch.randn(co, ci, kh, kw, device=xq.device, dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last)
    bb = torch.randn(co, device=xq.device, dtype=torch.bfloat16)
    lib_sets = input_sets((xb, wb, bb), 2 * (xb.numel() + wb.numel()))
    ops = 2 * b * h * w * co * kh * kw * ci
    nbytes = b * h * w * (cip + 2 * co) + co * kh * kw * cip + 8 * co + 4
    bms, by = bound(nbytes, ops, H100_INT8_OPS_PER_S)
    variants = [v for v in qk.CONV_VARIANTS
                if v == "mma_sync" or qk.conv_variant(h, w) == v]
    by_variant = {v: device_ms(lambda x_, w_, s_, b_, sx_, v=v:
                               qk.quant_conv_cuda(x_, w_, s_, b_,
                                                  x_scale=sx_, variant=v),
                               sets) for v in variants}
    return dict(ms=by_variant[qk.conv_variant(h, w)],
                variant_ms=by_variant,
                plain_ms=device_ms(lambda x_, w_, s_, b_, sx_:
                                   qk.quant_conv_plain(x_, w_, s_, b_,
                                                       x_scale=sx_), sets),
                library_ms=None,
                bf16_conv_ms=device_ms(lambda x_, w_, b_: F.conv2d(
                    x_, w_, b_, padding=(kh // 2, kw // 2)), lib_sets),
                bound_ms=bms, bound_by=by, tops=ops)


def same(a, b) -> bool:
    """Bit-equal values, a NaN equal to a NaN (the plain version's NaN
    and the kernel's may differ in payload)."""
    import torch
    return a.shape == b.shape and bool(torch.all(
        (a == b) | (torch.isnan(a) & torch.isnan(b))))


def k4_agrees(qk, x, a_scale, multiple, what: str) -> tuple:
    """K4 bit-equal to its plain version (int8 values, pad, scale, and
    the abs-max when dynamic); returns the variant launched and the
    largest |difference| of the int8 values and of the scale."""
    import torch
    (q, s, amax), variant = variant_of(qk.k4, qk.quantize_cuda, x, a_scale,
                                       multiple)
    torch.cuda.synchronize()
    qp, sp, ap = qk.quantize_plain(x, a_scale, multiple)
    require(q.shape == qp.shape and torch.equal(q, qp),
            f"K4 {what} ({variant}): {int((q != qp).sum())} of "
            f"{q.numel()} int8 values differ")
    require(same(s, sp), f"K4 {what} ({variant}): scale "
            f"{float(s)} vs {float(sp)}")
    require((amax is None) == (ap is None)
            and (amax is None or same(amax, ap)),
            f"K4 {what} ({variant}): abs-max {amax} vs {ap}")
    return variant, max(max_abs_diff(q, qp), max_abs_diff(s, sp))


def time_k4(qk, x, a_scale, multiple) -> dict:
    """Device times of K4 (the abs-max and the quantize when dynamic) and
    its plain version, beside its byte bound (x read once, q written
    once)."""
    rows, cols = x.shape
    sets = input_sets((x,), x.numel() * x.element_size())
    nbytes = rows * cols * x.element_size() + rows * qk.round_up(
        cols, multiple) + 4
    bms, by = bound(nbytes, 3 * rows * cols, H100_F32_FLOP_PER_S)
    return dict(ms=device_ms(lambda a: qk.quantize_cuda(a, a_scale,
                                                        multiple), sets),
                plain_ms=device_ms(lambda a: qk.quantize_plain(
                    a, a_scale, multiple), sets),
                library_ms=None, bound_ms=bms, bound_by=by)


def k4_tie_inputs(device):
    """bf16 rows holding every half-way value (k + 1/2) * 2^-3 for k in
    -127..126 and the abs-max 127 * 2^-3, so the dynamic scale is 2^-3
    exactly and each x / s is a tie that rounds to even; and the same rows
    with an outlier of 40, which saturates at the static scale 2^-3."""
    import torch
    ties = (torch.arange(-127, 127, dtype=torch.float32) + 0.5) * 0.125
    row = torch.cat([ties, torch.tensor([127 * 0.125]),
                     torch.zeros(970 - 255)])
    x = row.repeat(256, 1)[:, torch.randperm(970, generator=torch.Generator(
        ).manual_seed(5))]
    outlier = x.clone()
    outlier[7, 3] = 40.0
    return x.to(device, torch.bfloat16), outlier.to(device, torch.bfloat16)


def k3_row(g, device, x_shape, w_shape, sms: int,
           path: str = "int8") -> dict:
    """K3 at one shape: the plan (``wgmma`` required, the rule of every
    generation shape), both variants bit-equal to the plain version, and
    timed beside cuDNN's bf16 conv of the shape and the bound."""
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    xq, wq, scale, bias, sx = k3_inputs(g, x_shape, w_shape, device)
    plan = qk.k3_plan(x_shape, w_shape, sms)
    require(plan.variant == "wgmma", f"K3 {x_shape} {w_shape}: the "
            f"plan takes {plan.variant}, not wgmma")
    err = max(k3_agrees(qk, xq, wq, scale, bias, f"{x_shape} {w_shape}",
                        v, sx) for v in qk.CONV_VARIANTS)
    t = time_k3(qk, xq, wq, scale, bias, sx, x_shape, w_shape)
    tops = t.pop("tops") / t["ms"] / 1e9
    vms = t["variant_ms"]
    log(f"K3 quant_conv x {x_shape} w {w_shape} [{path}]: plan "
        f"{plan.variant} box {plan.box} BN {plan.bn} grid {plan.grid}; "
        f"bit-equal (int32, bf16, f32; wgmma and mma_sync); wgmma "
        f"{vms['wgmma']:.4f} ms ({tops:.0f} TOPS), mma_sync "
        f"{vms['mma_sync']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN "
        f"bf16 {t['bf16_conv_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f} % of it)")
    return dict(shape=[list(x_shape), list(w_shape)], path=path,
                plan=plan._asdict(), max_abs_err=err, tops=tops, **t)


def k4_row(g, device, r: int, c: int, m: int, path: str = "int8") -> dict:
    """K4 at (r, c) -> multiple m, bf16: bit-equal to its plain version
    dynamic and static, both timed beside the bound."""
    import torch

    from tera_mind_tpu_torch.ops import quant_kernel as qk
    x = randn(g, r, c, device=device).to(torch.bfloat16)
    a_scale = (x.float().abs().amax() / 100).reshape(())
    seen, errs = zip(*[k4_agrees(qk, x, a, m, f"({r}, {c}, {m})")
                       for a in (None, a_scale)])
    t = {v: time_k4(qk, x, a, m) for v, a in (("dynamic", None),
                                               ("static", a_scale))}
    log(f"K4 quantize ({r}, {c}) bf16 -> multiple {m} [{path}]: bit-equal "
        f"({', '.join(seen)}); dynamic {t['dynamic']['ms']:.4f} ms "
        f"(plain {t['dynamic']['plain_ms']:.4f}), static "
        f"{t['static']['ms']:.4f} ms (plain "
        f"{t['static']['plain_ms']:.4f}), bound "
        f"{t['dynamic']['bound_ms']:.4f} ms ({t['dynamic']['bound_by']}"
        f", {100 * t['dynamic']['bound_ms'] / t['dynamic']['ms']:.1f} "
        f"% of it dynamic)")
    return dict(shape=[r, c, m], path=path, max_abs_err=max(errs),
                **t["dynamic"], static_ms=t["static"]["ms"],
                static_plain_ms=t["static"]["plain_ms"])


def check_int8_kernels(device) -> dict:
    """K3 and K4 against their plain versions at every main-path int8
    shape and at edge shapes, timed; the C entry points' refusals.
    Returns {name: [row per main-path shape]}."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import quant_kernel as qk

    g = torch.Generator(device="cpu").manual_seed(3)
    rows = {"quant_conv": [], "quantize": []}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for x_shape, w_shape in K3_SHAPES:
        rows["quant_conv"].append(k3_row(g, device, x_shape, w_shape, sms))
    # the edge shapes, and the deep concat once more with its channels
    # padded to 16 only (976: rows off the 128-byte lines)
    for x_shape, w_shape, align in ([(x, w, None) for x, w in K3_EDGE]
                                    + [(K3_EDGE[0][0], K3_EDGE[0][1], 16)]):
        xq, wq, scale, bias, sx = k3_inputs(g, x_shape, w_shape, device,
                                            align)
        takes = [v for v in qk.CONV_VARIANTS if v == "mma_sync"
                 or qk.conv_variant(*x_shape[1:3]) == v]
        for v in takes:
            k3_agrees(qk, xq, wq, scale, bias, f"edge {x_shape} {w_shape} "
                      f"Ci_pad {xq.shape[-1]}", v, sx)
        log(f"K3 edge x {x_shape} w {w_shape} Ci_pad {xq.shape[-1]} "
            f"bit-equal in {takes} (plan "
            f"{qk.k3_plan(xq.shape, wq.shape, sms)})")

    # the C entry point refuses a misaligned x, a ragged Ci_pad or Co, an
    # even kernel, a sum that could overflow, a wrong dtype code or
    # variant, a wgmma plan that does not fit the shape, a scale where the
    # int32 output takes none
    lib, stream = _build.lib(), torch.cuda.current_stream().cuda_stream
    xq, wq, scale, bias, sx = k3_inputs(g, (2, 8, 8, 32), (16, 3, 3),
                                        device)
    base = torch.zeros(xq.numel() + 16, dtype=torch.int8, device=device)
    y = torch.empty(2, 8, 8, 16, dtype=torch.bfloat16, device=device)
    plan = qk.k3_plan(xq.shape, wq.shape, sms)

    def k3_call(x=xq, ci=32, co=16, kh=3, wd=8, out=1, variant=0,
                box=plan.box, bn=plan.bn, grid=1, sw=scale):
        return lib.tmt_quant_conv(
            x.data_ptr(), wq.data_ptr(), sx.data_ptr(),
            None if sw is None else sw.data_ptr(), bias.data_ptr(),
            y.data_ptr(), 2, 8, wd, ci, co, kh, kh, out, variant, *box, bn,
            grid, stream)
    require(k3_call() == 0 and k3_call(variant=1) == 0,
            "K3 entry refused a call it takes")
    refused = {"misaligned x": k3_call(x=base[1:1 + xq.numel()]),
               "Ci_pad 24": k3_call(ci=24), "Co 12": k3_call(co=12),
               "2x2 kernel": k3_call(kh=2), "overflow": k3_call(ci=16_000),
               "out dtype 3": k3_call(out=3),
               "int32 with a scale": k3_call(out=2),
               "no scale": k3_call(sw=None), "variant 5": k3_call(variant=5),
               "wgmma on W 7": k3_call(wd=7), "BN 64": k3_call(bn=64),
               "box (8, 4, 4)": k3_call(box=(8, 4, 4)),
               "grid 0": k3_call(grid=0)}
    refused["K4 multiple 4"] = lib.tmt_quantize(
        bias.data_ptr(), base.data_ptr(), scale.data_ptr(), None, None,
        None, 0, 4, 4, 4, 0, 1, stream)
    refused["K4 dynamic without partials"] = lib.tmt_quantize(
        bias.data_ptr(), base.data_ptr(), None, scale.data_ptr(),
        scale.data_ptr(), None, 0, 4, 4, 8, 0, 0, stream)
    torch.cuda.synchronize()
    require(all(err != 0 for err in refused.values()),
            f"K3/K4 entry points took calls they cannot: {refused}")
    log(f"K3 and K4 entry points refuse (error codes): {refused}")
    raised = None
    try:
        qk.quant_conv_cuda(base[1:1 + xq.numel()].view(xq.shape), wq, scale,
                           bias)
    except RuntimeError as err:
        raised = str(err)
    require(raised is not None, "K3 wrapper ran a misaligned input")
    raised = None
    try:
        qk.quant_conv_cuda(*k3_inputs(g, (3, 5, 7, 40), (16, 3, 3),
                                      device)[:4], variant="wgmma")
    except ValueError as err:
        raised = str(err)
    require(raised is not None, "K3 wrapper ran wgmma on a 5x7 image")

    rows["quantize"] = [k4_row(g, device, r, c, m) for r, c, m in K4_SHAPES]
    ties, outlier = k4_tie_inputs(device)
    for x, what in ((ties, "ties"), (outlier, "ties + outlier")):
        for a in (None, torch.tensor(0.125, device=device)):
            for m in (8, 16):
                k4_agrees(qk, x, a, m, what)
    q, s, _ = qk.quantize_cuda(ties, None, 16)
    require(float(s) == 0.125 and int(q[..., :970].abs().max()) == 127,
            f"K4 ties: scale {float(s)}")
    q, _, _ = qk.quantize_cuda(outlier, torch.tensor(0.125, device=device))
    require(int(q[7, 3]) == 127, "K4 static outlier did not saturate")
    f32 = torch.randn(999, 229, generator=g).to(device)
    for a in (None, torch.tensor(0.01, device=device)):
        k4_agrees(qk, f32, a, 8, "(999, 229) f32")
    nan = torch.randn(64, 229, generator=g).to(device, torch.bfloat16)
    nan[5, 17] = float("nan")
    for a in (None, torch.tensor(0.01, device=device)):
        k4_agrees(qk, nan, a, 8, "(64, 229) bf16 with a NaN")
    q, s, amax = qk.quantize_cuda(nan, None, 8)
    require(bool(torch.isnan(s)) and bool(torch.isnan(amax))
            and not q.any(), f"K4 NaN: scale {float(s)}, abs-max "
            f"{float(amax)}, {int(q.count_nonzero())} nonzero int8 values")
    q, _, _ = qk.quantize_cuda(nan, torch.tensor(0.01, device=device), 8)
    require(int(q[5, 17]) == 0 and q.any(), "K4 static NaN: not 0")
    # a tensor whose first element is off the 16-byte boundary: pass 1
    # reads it element by element, pass 2 realigns every row
    odd = torch.randn(1 + 333 * 70, generator=g).to(device, torch.bfloat16)
    for a in (None, torch.tensor(0.01, device=device)):
        for m in (8, 16):
            k4_agrees(qk, odd[1:].view(333, 70), a, m,
                      "(333, 70) bf16 at a 2-byte offset")
    log("K4 bit-equal on ties (round half to even), a saturating outlier "
        "(static), 8 and 16 multiples, f32 (999, 229), a NaN (dynamic: "
        "NaN scale and abs-max, q = 0; static: q = 0 where x is NaN) and a "
        "tensor at a 2-byte offset")
    return rows


def chain_gate_stats(a, b) -> dict:
    """tests/test_quant.py's chain statistics of b against a."""
    import numpy as np
    return {"mean": float(np.abs(a - b).mean()),
            "max": float(np.abs(a - b).max()),
            "corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
            "mean_shift": float(abs(a.mean() - b.mean())),
            "std_rel": float(abs(a.std() - b.std()) / a.std())}


def require_chain_gates(a, b, what: str) -> dict:
    st = chain_gate_stats(a, b)
    require(st["mean"] < CHAIN_GATES["mean"]
            and st["corr"] > CHAIN_GATES["corr"]
            and st["mean_shift"] < CHAIN_GATES["mean_shift"]
            and st["std_rel"] < CHAIN_GATES["std_rel"],
            f"{what}: {st} outside the chain gates {CHAIN_GATES}")
    log(f"{what}: mean |d| {st['mean']:.4g} (max {st['max']:.4g}), corr "
        f"{st['corr']:.5f}, mean shift {st['mean_shift']:.4g}, std shift "
        f"{st['std_rel']:.4g} (gates {CHAIN_GATES})")
    return st


def check_small_int8(device) -> dict:
    """The small chain in int8 (prequantized, DiT denses too) on the card
    against the same chain on the CPU (plain versions) and against the
    card's f32 chain; prequant bit-equal to dynamic on one UNet call on
    the card; int8_static calibrated on the card within the gates."""
    import copy

    import numpy as np
    import torch

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.models.nn import channels_last_, init_weights
    from tera_mind_tpu_torch.models.unet_packed import (make_packed_model,
                                                        pack_unet_params)
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    from tera_mind_tpu_torch.ops.quant import (calibrate_generator,
                                               prequantize_params)

    mconf, gconf, gene = small_setup()
    tree = pack_unet_params(export_params(init_weights(
        mconf.make_model(), seed=3)), mconf)
    qtree = prequantize_params(tree, attn=True)

    def packed(t, **kw):
        return load_jax_params(make_packed_model(mconf, **kw), t).eval()

    exact = packed(tree)
    dyn = packed(tree, quant="int8", quant_attn=True)
    pre = packed(qtree, quant="int8", prequant=True, quant_attn=True)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 32, 32, 2), np.float32))
    rna = torch.from_numpy(rng.integers(0, 3, (9, 2, 2, 24)).astype(
        np.float32))
    args = [a.to(device) for a in (x, torch.tensor([700]), rna)]
    before = qk.k3.launches
    with torch.inference_mode():
        a, _ = copy.deepcopy(dyn).to(device)(*args, 3, 3)
        b, _ = copy.deepcopy(pre).to(device)(*args, 3, 3)
    torch.cuda.synchronize()
    require(qk.k3.launches > before, "the small int8 model launched no K3")
    require(torch.equal(a, b), "prequant differs from dynamic on the card: "
            f"max |d| {float((a - b).abs().max())}")
    log("small int8 UNet call on the card: prequant bit-equal to dynamic")

    out = {"f32": small_chain(exact, device, gconf, gene),
           "int8": small_chain(pre, device, gconf, gene),
           "int8_cpu": small_chain(pre, torch.device("cpu"), gconf, gene)}
    card = channels_last_(copy.deepcopy(pre).to(device))
    gen = small_gen(card, device, gconf)
    stree = calibrate_generator(gen, card, qtree, gene, steps=3, row0=1,
                                col0=1, grid_w=16)
    static = packed(stree, quant="int8", prequant=True, static_act=True,
                    quant_attn=True)
    out["int8_static"] = small_chain(static, device, gconf, gene)
    return {"int8 card vs CPU": require_chain_gates(
                out["int8_cpu"], out["int8"], "small int8 chain, card vs CPU"),
            "int8 vs f32": require_chain_gates(
                out["f32"], out["int8"], "small int8 chain vs f32, card"),
            "int8_static vs f32": require_chain_gates(
                out["f32"], out["int8_static"],
                "small int8_static chain vs f32, card")}


# ---------------------------------------------------------------------------
# phases 6 and 7: the port on a small input, card against CPU, and resume
# ---------------------------------------------------------------------------

SMALL_ATOL = 2e-3  # f32 on both sides (cuDNN TF32 off); conv algorithms
                   # and kernel sums reassociate, and the DDIM update at
                   # the largest t scales eps errors by sqrt(1/abar - 1)
# The spill is float16: rounding moves each state value by up to 2^-11 of
# it (2e-3 at |x| < 4, the state's range after one step), and the two
# steps left carry that into the output scaled by up to 1/sqrt(abar) of
# the remaining timesteps (under 2 here) plus the model's response; a
# resume from the wrong step or state moves outputs by 0.1 or more.
RESUME_ATOL = 1e-2


def small_setup():
    """The CPU tests' narrow config: (model config, generator config,
    gene grid of 2x2 tiles)."""
    import numpy as np

    from tera_mind_tpu_torch.models.unet import TeraUNetConfig
    from tera_mind_tpu_torch.parallel.generator import GeneratorConfig

    mconf = TeraUNetConfig(image_size=32, in_channels=2, out_channels=2,
                           model_channels=8, embed_channels=32,
                           num_res_blocks=1, attention_resolutions=(8,),
                           rna_num=6, gn_sz=2, use_zero_module=False)
    gconf = GeneratorConfig(tile=64, patch=32, gn_blk=16, snum=4,
                            n_slices=4, stains=1, gdim=6, window_chunk=1)
    gene = np.random.default_rng(9).integers(
        0, 3, (2, 2, gconf.gsz, gconf.gsz, gconf.z_pad, gconf.gdim)
    ).astype(np.uint8)
    return mconf, gconf, gene


def small_gen(model, device, gconf):
    """A generator of ``model`` on ``device`` (a copy on the card unless
    it is there already) with the small chain's 3-step schedule."""
    import copy

    from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                       SamplerConfig)
    from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
    from tera_mind_tpu_torch.models.nn import channels_last_
    from tera_mind_tpu_torch.parallel.generator import TeraGenerator

    if device.type == "cuda" and next(model.parameters()).device != device:
        model = channels_last_(copy.deepcopy(model).to(device))
    sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                               SamplerConfig(patch_size=32, gn_sz=2))
    return TeraGenerator(
        sampler, lambda xp, tm, rp, p1, p2: model(
            xp, tm, rp, p1, p2, decode_original=False),
        gconf, device=device)


def small_chain(model, device, gconf, gene, **run_kw):
    """The 2x2-tile, 3-step block-major chain of ``model`` on ``device``."""
    import numpy as np

    out = small_gen(model, device, gconf).run(
        gene, row0=1, col0=1, grid_w=16, progress=False, block_major=True,
        **run_kw)
    require(out.shape == (128, 128, 4) and bool(np.isfinite(out).all()),
            f"small chain output {out.shape} not finite or misshapen")
    return out


def check_small_chain(device) -> dict:
    """The small chain of the 5D model (every weight random) and of the
    packed model on the same weights: card against CPU for both, packed
    against 5D and ``packed_attn`` against not on the card, each within
    ``SMALL_ATOL``; returns the max abs differences and the packed
    model's card output."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.models.nn import init_weights
    from tera_mind_tpu_torch.models.unet_packed import (make_packed_model,
                                                        pack_unet_params)

    mconf, gconf, gene = small_setup()
    model5 = init_weights(mconf.make_model(), seed=3).eval()
    packed_tree = pack_unet_params(export_params(model5), mconf)
    packed, packed_attn = (
        load_jax_params(make_packed_model(mconf, packed_attn=pa),
                        packed_tree).eval() for pa in (False, True))
    cpu = torch.device("cpu")
    out = {"5d_cpu": small_chain(model5, cpu, gconf, gene),
           "5d": small_chain(model5, device, gconf, gene),
           "packed_cpu": small_chain(packed, cpu, gconf, gene),
           "packed": small_chain(packed, device, gconf, gene),
           "packed_attn": small_chain(packed_attn, device, gconf, gene)}
    errs = {}
    for name, (a, b) in {"5d card vs CPU": ("5d", "5d_cpu"),
                         "packed card vs CPU": ("packed", "packed_cpu"),
                         "packed vs 5d on the card": ("packed", "5d"),
                         "packed_attn vs packed on the card":
                             ("packed_attn", "packed")}.items():
        errs[name] = float(np.abs(out[a] - out[b]).max())
        require(errs[name] <= SMALL_ATOL, f"small chain {name}: "
                f"{errs[name]} > {SMALL_ATOL}")
    return dict(errs=errs, packed=packed, out=out["packed"])


def check_resume(device, packed, want) -> float:
    """The small packed chain on the card, spilled every step into a
    temporary directory and resumed from its epoch-1 spill (two steps
    left), against the uninterrupted chain ``want``."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from tera_mind_tpu_torch.data.tilestore import StateCheckpoint

    class KeepAll(StateCheckpoint):
        """Keeps every spill, so epoch 1's outlives the run."""

        def prune(self, keep_t):
            pass

    _, gconf, gene = small_setup()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spilled = small_chain(packed, device, gconf, gene,
                              checkpoint=KeepAll(tmp / "run", "grid"),
                              checkpoint_every=1)
        require(sorted(p.name for p in tmp.iterdir()) == ["run_1", "run_2"],
                f"spills {sorted(p.name for p in tmp.iterdir())}")
        shutil.copytree(tmp / "run_1", tmp / "resume_1")
        resumed = small_chain(packed, device, gconf, gene,
                              checkpoint=StateCheckpoint(tmp / "resume",
                                                         "grid"))
    require(bool(np.array_equal(spilled, want)),
            "spilling changed the chain's result")
    err = float(np.abs(resumed - want).max())
    require(err <= RESUME_ATOL, f"resume from epoch 1: {err} > {RESUME_ATOL}")
    log(f"resume: mean |resumed - uninterrupted| "
        f"{float(np.abs(resumed - want).mean()):.3g}")
    return err


# ---------------------------------------------------------------------------
# phase 8: streaming and the tile-major step, small, on the card
# ---------------------------------------------------------------------------

STREAM_BF16_MAX = 0.05    # bf16 transfers against f32, the JAX package's
STREAM_BF16_MEAN = 5e-3   # bounds (tests/test_streaming.py)


def small_field_gene(gconf, rows: int, cols: int, seed: int = 11):
    """Per-tile gene bins cut from one field, so neighbours' overlapping
    bins agree (block-major and K > 1 windows need it)."""
    import numpy as np
    nb, hb = gconf.tile // gconf.gn_blk, gconf.pad // gconf.gn_blk
    field = np.random.default_rng(seed).integers(
        0, 3, (rows * nb + 2 * hb, cols * nb + 2 * hb, gconf.z_pad,
               gconf.gdim)).astype(np.uint8)
    return np.stack([np.stack([field[r * nb:r * nb + nb + 2 * hb,
                                     c * nb:c * nb + nb + 2 * hb]
                               for c in range(cols)]) for r in range(rows)])


def check_small_streaming(device, packed) -> dict:
    """The small packed model in f32 on a 3x3 grid (2x2 windows, so edge
    windows shift inward): streamed against in-memory runs, and each
    streaming option against the plain sweep; returns the differences."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from tera_mind_tpu_torch.data.tilestore import StateCheckpoint
    from tera_mind_tpu_torch.parallel.streaming import (StreamConfig,
                                                        StreamingGenerator)

    class KeepAll(StateCheckpoint):
        def prune(self, keep_t):
            pass

    _, gconf, _ = small_setup()
    gene = small_field_gene(gconf, 3, 3)
    gen = small_gen(packed, device, gconf)

    def run(**kw):
        return gen.run(gene, row0=1, col0=1, grid_w=16, progress=False,
                       **kw)

    def stream(**kw):
        ck = kw.pop("checkpoint", None)
        st = StreamingGenerator(gen, StreamConfig(
            progress=False, **kw)).run(3, 3, gene, row0=1, col0=1,
                                       grid_w=16, checkpoint=ck)
        out = st.read.float().numpy()
        require(out.shape == (192, 192, 4) and bool(np.isfinite(out).all()),
                f"small stream {kw}: {out.shape} not finite or misshapen")
        return out

    tile, block = run(block_major=False), run(block_major=True)
    s_block = stream(block_major=True)
    errs = {"in-memory tile-major vs block-major": (tile, block),
            "stream tile-major vs in-memory": (stream(), tile),
            "stream block-major vs in-memory": (s_block, block),
            "stream K=2 vs K=1": (stream(block_major=True,
                                        steps_per_window=2), s_block),
            "stream pipeline off vs on": (stream(block_major=True,
                                                 pipeline=False), s_block)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        errs["stream memmap vs in-memory"] = (
            stream(block_major=True, memmap_dir=str(tmp / "mm")), s_block)
        spilled = stream(block_major=True, checkpoint_every=1,
                         checkpoint=KeepAll(tmp / "run", "grid"))
        require(bool(np.array_equal(spilled, s_block)),
                "spilling changed the streamed result")
        shutil.copytree(tmp / "run_1", tmp / "resume_1")
        resumed = stream(block_major=True,
                         checkpoint=StateCheckpoint(tmp / "resume", "grid"))
    out = {}
    for name, (a, b) in errs.items():
        out[name] = float(np.abs(a - b).max())
        require(out[name] <= SMALL_ATOL,
                f"small {name}: {out[name]} > {SMALL_ATOL}")
    out["stream resume from epoch 1"] = float(np.abs(resumed - s_block).max())
    require(out["stream resume from epoch 1"] <= RESUME_ATOL,
            f"streamed resume: {out['stream resume from epoch 1']}")
    # bf16 transfers against f32: gated at the JAX test's bounds on the
    # JAX test's toy model and data; on the small UNet the mean is gated
    # and the max printed (the JAX package's own max there is 0.0700, over
    # 0.05 at 9 of 147,456 values, tests/test_torch_streaming.py)
    d = np.abs(stream(block_major=True, transfer_dtype="bfloat16") - s_block)
    out["stream bf16 vs f32 transfers, small UNet, max"] = float(d.max())
    out["stream bf16 vs f32 transfers, small UNet, mean"] = float(d.mean())
    require(d.mean() < STREAM_BF16_MEAN,
            f"bf16 transfers, small UNet: mean |d| {d.mean()}")
    d = toy_bf16_gap(device)
    out["stream bf16 vs f32 transfers, toy model, max"] = float(d.max())
    out["stream bf16 vs f32 transfers, toy model, mean"] = float(d.mean())
    require(d.max() < STREAM_BF16_MAX and d.mean() < STREAM_BF16_MEAN,
            f"bf16 transfers, toy model: max |d| {d.max()}, mean {d.mean()}")
    return out


def toy_model(xp, tm, rp, p1, p2):
    """tests/test_streaming.py's stand-in model: eps from the patch and
    its gene conditioning, decoded through the collage."""
    from tera_mind_tpu_torch.ops.collage import to_collage
    g = rp.mean(dim=(1, 2, 3))
    eps = 0.1 * xp + 0.01 * g[:, None, None, None]
    return to_collage(eps[:, None], p1, p2)[:, 0], eps


def toy_bf16_gap(device):
    """|bf16-transfer stream - f32 stream| of tests/test_streaming.py's
    bf16 test (toy model, 2x2 tiles of 64^2 px x 8 channels, 3 steps)."""
    import numpy as np

    from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                       SamplerConfig)
    from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
    from tera_mind_tpu_torch.parallel.generator import (GeneratorConfig,
                                                        TeraGenerator)
    from tera_mind_tpu_torch.parallel.streaming import (StreamConfig,
                                                        StreamingGenerator)

    gconf = GeneratorConfig(tile=64, patch=32, gn_blk=16, snum=4,
                            n_slices=4, stains=2, gdim=8)
    gen = TeraGenerator(DiffusionSampler(
        spaced_schedule("linear", 1000, "ddim3"),
        SamplerConfig(patch_size=32, gn_sz=2)), toy_model, gconf,
        device=device)
    gene = (np.random.default_rng(17).random(
        (2, 2, gconf.gsz, gconf.gsz, gconf.z_pad, gconf.gdim))
        < 0.05).astype(np.uint8)
    f32, b16 = (StreamingGenerator(gen, StreamConfig(
        progress=False, transfer_dtype=dt)).run(
            2, 2, gene, row0=1, col0=1).read.float().numpy()
        for dt in ("float32", "bfloat16"))
    require(bool(np.isfinite(b16).all()), "toy bf16 stream not finite")
    return np.abs(b16 - f32)


# ---------------------------------------------------------------------------
# phases 9 to 11: the main path
# ---------------------------------------------------------------------------

def start_card_sampler() -> subprocess.Popen:
    """nvidia-smi sampling SM clock, power draw and temperature every
    500 ms, to show whether the card held its clocks during the chain."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "500"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def stop_card_sampler(proc: subprocess.Popen) -> str:
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:      # "[N/A]" fields on some drivers
            continue
    if not rows:
        return "card clocks not sampled"
    sm, pw, temp = zip(*rows)
    return (f"SM clock {min(sm):.0f}-{max(sm):.0f} MHz, power draw up to "
            f"{max(pw):.0f} W, temperature up to {max(temp):.0f} C "
            f"({len(rows)} samples)")


GRID = 2          # 2x2 tiles of 256^2 px x 100 channels
STEPS = 15        # DDIM steps (eta 0) of a tile: every tiles/s is per
                  # 15-step tile, whatever depth a chain runs
MAIN_STEPS = 5    # depth of the packed and int8 chains and of phase 17's
                  # ranks in memory: cut from 15 to keep the run well
                  # inside its cap
TILE_MAJOR_STEPS = 5   # the tile-major chain's depth, cut to keep the
                       # whole run near 850 s (PR 13)
# DDIM steps of each full-width chain of phase 9: the 5D and int8_static
# chains were cut from 15 to 5 steps to make room for phase 19 (their
# tiles/s stay a 15-step equivalent; their outputs are checked by
# require_output, and int8_static's calibration runs over its 5 steps)
# The streamed 4x4 chain's depth, cut from 15 to 5 steps in turn to keep
# the run well inside its cap (its tiles/s stays a 15-step equivalent),
# then to 2, the depth of the timing run after it
STREAM_STEPS = 2
CHAIN_STEPS = {"packed": MAIN_STEPS, "int8": MAIN_STEPS, "int8_static": 5,
               "5d": 5,
               "tile_major": TILE_MAJOR_STEPS, "stream": STREAM_STEPS}


# launches per chain: K1 norms, K2 attentions, K5 grouped norms, K6
# residual sums and K7 gated residuals per UNet call x UNet calls.  The
# packed model's 57
# ResBlock and output norms (28 ResBlocks' in_norm and out_norm, and
# out_norm) are GroupedRMSNorm, K5, so K1 runs only in the 6 DiT blocks
# (norm1, norm2, q_norm, k_norm) and the gene-gene block (q_norm, norm2);
# each of the 28 ResBlocks ends in one K6 launch where its convs are bf16
# (not int8); the 5D model has no GroupedRMSNorm and no K6.  Each DiT
# block's norm1 and norm2 take K1's modulate and its two sub-layers end
# in K7 on every path, int8 and the 5D model included: 12 a call.  Block-major
# 2x2: 25 z-windows x 5 steps = 125 calls; tile-major 2x2 at window_chunk
# 5: 4 tiles x 5 calls x 5 steps = 100; streamed 4x4 in 2x2 windows at
# window_chunk 5: 4 windows x 5 calls x 2 steps = 40.
CHAIN_LAUNCHES = {
    "packed": {"rmsnorm": 26 * 125, "window_attention": 6 * 125,
               "grouped_rmsnorm": 57 * 125, "residual": 28 * 125,
               "gated_residual": 12 * 125},
    "int8": {"rmsnorm": 26 * 125, "window_attention": 6 * 125,
             "grouped_rmsnorm": 57 * 125, "residual": 0,
             "gated_residual": 12 * 125},
    "int8_static": {"rmsnorm": 26 * 125, "window_attention": 6 * 125,
                    "grouped_rmsnorm": 57 * 125, "residual": 0,
                    "gated_residual": 12 * 125},
    "5d": {"rmsnorm": 83 * 125, "window_attention": 6 * 125,
           "grouped_rmsnorm": 0, "residual": 0, "gated_residual": 12 * 125},
    "tile_major": {"rmsnorm": 26 * 100, "window_attention": 6 * 100,
                   "grouped_rmsnorm": 57 * 100, "residual": 28 * 100,
                   "gated_residual": 12 * 100},
    "stream": {"rmsnorm": 26 * 40, "window_attention": 6 * 40,
               "grouped_rmsnorm": 57 * 40, "residual": 28 * 40,
               "gated_residual": 12 * 40}}
STREAM_GRID = 4   # 4x4 tiles: four 2x2-tile windows a step


def per_call_counts(model) -> tuple:
    """(K1 norms, of them with C % 8 == 0, K2 attentions, K5 grouped norms
    by variant, K5 by epilogue, K5 by prologue, K6 by variant, K7 by
    variant) per UNet call of a bf16 chain.  K1 runs in every RMSNorm itself; its
    GroupedRMSNorm subclass runs K5, each once a call (the collage
    decoder alone): a ResBlock's in_norm with the SiLU, its out_norm with
    the modulate and the SiLU where it has the adaLN projection, the
    UNet's out_norm with the SiLU; each ResBlock whose convs are not int8
    folds (``PackedResBlock.plain_convs``): its out_norm adds in_conv's
    bias, and one K6 launch ends it.  Each DiT block's norm1 and norm2
    launch K1 with the modulate, and each of its two sub-layers ends in
    one K7 launch (its gate a chunk of the (rows, 7C) adaLN output)."""
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.models.attention import CrossAttention, DiTBlock
    from tera_mind_tpu_torch.models.nn import RMSNorm
    from tera_mind_tpu_torch.models.unet_packed import (GroupedRMSNorm,
                                                        PackedResBlock)
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    norms = [m.weight.numel() for m in model.modules()
             if type(m) is RMSNorm]
    grouped = dict.fromkeys(k5.VARIANTS, 0)
    for m in model.modules():
        if isinstance(m, GroupedRMSNorm):
            grouped[k5.grouped_variant(m.z, m.segments, 2, True)] += 1
    epilogues = dict.fromkeys(k5.EPILOGUES, 0)
    prologues = dict.fromkeys(k5.PROLOGUES, 0)
    residual = dict.fromkeys(k6.VARIANTS, 0)
    if sum(grouped.values()):
        blocks = [m for m in model.modules() if isinstance(m, PackedResBlock)]
        mod = sum(hasattr(m, "emb_proj") for m in blocks)
        epilogues.update(silu=sum(grouped.values()) - mod,
                         modulate_silu=mod)
        folded = [m for m in blocks if m.plain_convs()]
        prologues.update(none=sum(grouped.values()) - len(folded),
                         bias=len(folded))
        for m in folded:
            residual[k6.residual_variant(m.out_norm.weight.numel()
                                         * (m.z if m.out_norm.from_5d
                                            else 1), 2, True)] += 1
    gated = dict.fromkeys(k7.VARIANTS, 0)
    for m in model.modules():
        if isinstance(m, DiTBlock):
            c = m.hidden_size
            gated[k7.gated_variant(c, 7 * c, 2, True)] += 2
    return (len(norms), sum(c % 8 == 0 for c in norms),
            sum(isinstance(m, CrossAttention) for m in model.modules()),
            grouped, epilogues, prologues, residual, gated)


def expected_launches(counts: tuple, calls: int) -> tuple:
    """(launches, launches by variant) of ``calls`` UNet calls: every
    attention shape of the 638850 paths takes the variant the rule names
    for the main path's (``K2_SHAPES``, one variant: ``wgmma``)."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    (n_norm, n_vec, n_attn, grouped, epilogues, prologues, residual,
     gated) = counts
    n_mod = sum(gated.values())   # a K1 modulate launch for each K7
    k2_variant, = {k2.attention_variant(n, d, torch.bfloat16, True)
                   for _, n, d in K2_SHAPES}
    return ({"rmsnorm": n_norm * calls, "window_attention": n_attn * calls,
             "grouped_rmsnorm": sum(grouped.values()) * calls,
             "residual": sum(residual.values()) * calls,
             "gated_residual": n_mod * calls},
            {"rmsnorm": {"strided": (n_norm - n_vec) * calls,
                         "vector": n_vec * calls},
             "rmsnorm_epilogue": {"none": (n_norm - n_mod) * calls,
                                  "modulate": n_mod * calls},
             "window_attention": {v: n_attn * calls if v == k2_variant
                                  else 0 for v in k2.VARIANTS},
             "grouped_rmsnorm": {v: n * calls for v, n in grouped.items()},
             "grouped_rmsnorm_epilogue": {e: n * calls
                                          for e, n in epilogues.items()},
             "grouped_rmsnorm_prologue": {p: n * calls
                                          for p, n in prologues.items()},
             "residual": {v: n * calls for v, n in residual.items()},
             "gated_residual": {v: n * calls for v, n in gated.items()}})


def read_launches() -> tuple:
    """(launches of K1, K2, K5, K6 and K7; by variant, K1's by epilogue
    and K5's by epilogue and prologue)."""
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    return ({"rmsnorm": k1.launches, "window_attention": k2.launches,
             "grouped_rmsnorm": k5.launches, "residual": k6.launches,
             "gated_residual": k7.launches},
            {"rmsnorm": dict(k1.launches_by_variant),
             "rmsnorm_epilogue": dict(k1.launches_by_epilogue),
             "window_attention": dict(k2.launches_by_variant),
             "grouped_rmsnorm": dict(k5.launches_by_variant),
             "grouped_rmsnorm_epilogue": dict(k5.launches_by_epilogue),
             "grouped_rmsnorm_prologue": dict(k5.launches_by_prologue),
             "residual": dict(k6.launches_by_variant),
             "gated_residual": dict(k7.launches_by_variant)})


def reset_launches() -> None:
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    k1.reset_launches()
    k2.reset_launches()
    k5.reset_launches()
    k6.reset_launches()
    k7.reset_launches()
    qk.reset_launches()


def read_quant_launches() -> dict:
    """K3's and K4's launches by variant."""
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    return {"quant_conv": dict(qk.k3.launches_by_variant),
            "quantize": dict(qk.k4.launches_by_variant)}


def require_output(out, shape) -> None:
    import numpy as np
    require(out.shape == shape, f"shape {out.shape}, expected {shape}")
    require(bool(np.isfinite(out).all()), "non-finite output")
    require(out.min() >= -1.0 and out.max() <= 1.0,
            f"output outside [-1, 1]: [{out.min()}, {out.max()}]")
    log(f"output {out.shape} in [{out.min():.4f}, {out.max():.4f}], "
        f"mean {out.mean():.4f}, std {out.std():.4f}")


def run_main_path(device, path: str = "packed") -> dict:
    """``cli.generate.build`` with its defaults (path "packed"),
    ``--no_packed`` ("5d"), ``--tile_major`` ("tile_major"), ``--quant
    int8`` or ``--quant int8_static`` (its build calibrates), one warm-up
    step (which plans the block-major step's memory), then the timed chain
    with the launch counters set to 0 just before it and read just after
    it."""
    import torch

    from tera_mind_tpu_torch.cli import generate

    tile_major = path == "tile_major"
    steps = CHAIN_STEPS[path]
    flags = {"packed": [], "5d": ["--no_packed"],
             "tile_major": ["--tile_major"], "int8": ["--quant", "int8"],
             "int8_static": ["--quant", "int8_static"]}[path]
    args = generate.parse_args(["--synthetic", "--hnm", str(GRID),
                                "--wnm", str(GRID), "--tot_epoch",
                                str(steps), "--device", str(device)] + flags)
    t0 = time.perf_counter()
    gen, model, gene, (row0, col0) = generate.build(args)
    build_s = time.perf_counter() - t0

    state0 = torch.as_tensor(gen.init_state(GRID, GRID, row0=row0,
                                            col0=col0), device=device)
    t0 = time.perf_counter()
    gen.compile_step(GRID, GRID, block_major=not tile_major)(
        state0, torch.as_tensor(gene, device=device), steps - 1)
    torch.cuda.synchronize()
    log(f"warm-up step: {time.perf_counter() - t0:.2f} s")
    if tile_major:
        require(gen.conf.window_chunk == 5,
                f"--tile_major window_chunk {gen.conf.window_chunk}, not 5")
    else:
        # the planner picks the whole 2x2 block (81 patches a z-window,
        # nearest TMT_TARGET_PATCHES) and one z-window a call
        require((gen.conf.strip_rows, gen.conf.window_chunk) == (0, 1),
                f"planned strip_rows {gen.conf.strip_rows}, window_chunk "
                f"{gen.conf.window_chunk}; expected 0 and 1")
        probe = gen.plan_probe
        log(f"planner [{path}]: strip_rows 0, window_chunk 1; probe peak "
            f"{probe['need'] / 2 ** 30:.2f} GiB of a "
            f"{probe['budget'] / 2 ** 30:.2f} GiB budget")
    counts = per_call_counts(model)
    calls = gen.conf.n_win // gen._wchunk() * steps * (
        GRID * GRID if tile_major else 1)
    want, want_variants = expected_launches(counts, calls)
    n_buf = sum(b.numel() for b in model.buffers())
    log(f"main path [{path}]: 638850 {type(model).__name__} "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params "
        f"bf16 + {n_buf / 1e6:.1f}M int8 weights and f32 scales, "
        f"{counts[0]} K1 RMSNorm ({counts[1]} with C % 8 == 0) + "
        f"{counts[2]} CrossAttention per UNet call, {calls} UNet calls per "
        f"chain; built in {build_s:.1f} s")

    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    smi_proc = start_card_sampler()
    try:
        reset_launches()
        t0 = time.perf_counter()
        out = gen.run(gene, row0=row0, col0=col0, grid_w=416,
                      block_major=not tile_major, progress=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        card = stop_card_sampler(smi_proc)
    got, got_variants = read_launches()
    quant = read_quant_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = GRID * GRID * steps / STEPS / secs
    log(f"chain [{path}]: {GRID}x{GRID} tiles x {steps} steps in "
        f"{secs:.2f} s = {rate:.5f} tiles/s (a tile {STEPS} steps); peak "
        f"device memory {peak:.2f} GiB ({before:.2f} GiB allocated before "
        f"the chain); launches {got} (expected {want}), by "
        f"variant {got_variants} (expected {want_variants}); {card}")

    require_output(out, (GRID * 256, GRID * 256, 100))
    require(got == want, f"launches {got}, expected {want}")
    require(want == CHAIN_LAUNCHES[path],
            f"per-chain launch counts {want} differ from the {path} "
            f"model's {CHAIN_LAUNCHES[path]}")
    require(got_variants == want_variants,
            f"launches by variant {got_variants}, expected {want_variants}")
    want_quant = QUANT_LAUNCHES.get(path, {
        "quant_conv": {"wgmma": 0, "mma_sync": 0},
        "quantize": {"dynamic": 0, "static": 0}})
    log(f"int8 launches [{path}]: {quant} (expected {want_quant})")
    require(quant == want_quant,
            f"K3/K4 launches {quant}, expected {want_quant}")
    return dict(launches=got, variants=got_variants, seconds=secs,
                tiles_per_s=rate, peak_gib=peak, out=out,
                gen=gen, counts=counts, quant_launches=quant,
                build_s=build_s)


def check_planner(gen) -> list:
    """``auto_plan`` of the full-width packed generator for square grids:
    its plan, the measured peak of its probe and the budget; the 2x2 plan
    must be the whole block with one z-window a call."""
    import dataclasses

    rows = []
    for g in (2, 4, 8, 16):
        gen.conf = dataclasses.replace(gen.conf, strip_rows=0,
                                       window_chunk=-1)
        t0 = time.perf_counter()
        plan = gen.auto_plan(g, g, verbose=False)
        probe = gen.plan_probe
        rows.append(dict(grid=g, **plan, need_gib=probe["need"] / 2 ** 30,
                         budget_gib=probe["budget"] / 2 ** 30,
                         seconds=time.perf_counter() - t0))
        log(f"planner {g}x{g}: {plan}; probe peak "
            f"{rows[-1]['need_gib']:.2f} GiB of a "
            f"{rows[-1]['budget_gib']:.2f} GiB budget "
            f"({rows[-1]['seconds']:.1f} s)")
    require(rows[0]["tile_major"] is False and rows[0]["strip_rows"] == 0
            and rows[0]["window_chunk"] == 1,
            f"2x2 plan {rows[0]}, expected the whole block, window_chunk 1")
    return rows


def peak_rss_gib() -> float:
    """This process's peak resident set so far, GiB (``ru_maxrss``)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


class Tee:
    """Writes to standard output and keeps a copy."""

    def __init__(self):
        import io
        self.copy = io.StringIO()

    def write(self, text):
        sys.__stdout__.write(text)
        return self.copy.write(text)

    def flush(self):
        sys.__stdout__.flush()


def run_stream_path(device, counts: tuple) -> dict:
    """``cli.generate.main --stream`` at its defaults on a 4x4 grid,
    ``STREAM_STEPS`` steps, with the launch counters set to 0 just before
    it, then a 2-step run of the same grid under ``TMT_STREAM_TIMING``."""
    import contextlib
    import re
    import tempfile

    import torch

    from tera_mind_tpu_torch.cli import generate

    g = STREAM_GRID
    rss_before = peak_rss_gib()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--stream", "--hnm", str(g), "--wnm", str(g),
                "--tot_epoch", str(STREAM_STEPS), "--device", str(device),
                "--out_dir", f"{tmp}/tiles"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tee = Tee()
        smi_proc = start_card_sampler()
        try:
            reset_launches()
            with contextlib.redirect_stdout(tee):
                out = generate.main(argv)
            torch.cuda.synchronize()
        finally:
            card = stop_card_sampler(smi_proc)
        got, got_variants = read_launches()
        n_tiles = len(list(Path(tmp, "tiles").glob("*.npy")))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rss = peak_rss_gib()
    text = tee.copy.getvalue()
    done = re.search(r"in ([0-9.]+) s;", text)
    auto = re.search(r"window_chunk auto -> (\d+)", text)
    require(done is not None and auto is not None,
            "the streamed run printed no run time or window_chunk")
    secs, wc = float(done.group(1)), int(auto.group(1))
    calls = 25 // wc * (g // 2) ** 2 * STREAM_STEPS
    want, want_variants = expected_launches(counts, calls)
    rate = g * g * STREAM_STEPS / STEPS / secs
    log(f"chain [stream]: {g}x{g} tiles x {STREAM_STEPS} steps in {secs:.2f}"
        f" s = {rate:.5f} tiles/s (a tile {STEPS} steps; window_chunk {wc}, "
        f"{calls} UNet calls); peak device memory {peak:.2f} GiB, the "
        "process's peak "
        f"host RSS {rss:.2f} GiB ({rss_before:.2f} GiB before the chain); "
        f"launches {got} (expected {want}), by variant "
        f"{got_variants} (expected {want_variants}); {card}")
    require_output(out, (g * 256, g * 256, 100))
    require(n_tiles == g * g, f"{n_tiles} tiles exported, not {g * g}")
    require(got == want, f"launches {got}, expected {want}")
    require(want == CHAIN_LAUNCHES["stream"],
            f"per-chain launch counts {want} differ from "
            f"{CHAIN_LAUNCHES['stream']}")
    require(got_variants == want_variants,
            f"launches by variant {got_variants}, expected {want_variants}")

    timing, out2 = stream_timing_run(device)
    return dict(launches=got, variants=got_variants, seconds=secs,
                tiles_per_s=rate, peak_gib=peak, host_rss_gib=rss,
                host_rss_before_gib=rss_before, window_chunk=wc,
                timing=timing, out=out, out2=out2)


def stream_timing_run(device) -> tuple:
    """The per-phase breakdown of ``--stream`` on the 4x4 grid: one
    sequential sweep, 2 steps, under ``TMT_STREAM_TIMING``; returns (the
    phase seconds, the output), the output being phase 17's reference
    for the band-parallel run."""
    import os

    from tera_mind_tpu_torch.cli import generate

    g = STREAM_GRID
    args = generate.parse_args(["--synthetic", "--stream", "--hnm", str(g),
                                "--wnm", str(g), "--tot_epoch",
                                str(RANK_STREAM_STEPS), "--device",
                                str(device)])
    gen, _, gene, (row0, col0) = generate.build(args)
    sgen = generate.make_streamer(args, gen)
    os.environ["TMT_STREAM_TIMING"] = "1"
    try:
        t0 = time.perf_counter()
        out = sgen.run(g, g, gene, row0=row0, col0=col0, grid_w=416)
        timed_s = time.perf_counter() - t0
    finally:
        del os.environ["TMT_STREAM_TIMING"]
    timing = dict(sgen.timing, seconds=timed_s)
    log(f"stream timing, {g}x{g} x {RANK_STREAM_STEPS} steps, one worker: "
        + ", ".join(f"{k} {v:.3f} s" if k != "n" else f"{v} windows"
                    for k, v in timing.items()))
    return timing, out.read.float().numpy()


# ---------------------------------------------------------------------------
# phases 12 and 13: training
# ---------------------------------------------------------------------------

TRAIN_LOSS_ATOL = 1e-4   # the small f32 train step, card vs CPU: the loss,
TRAIN_GRAD_TOL = 2e-3    # and each gradient leaf within this share of its
                         # max |CPU grad| (cuDNN TF32 off; conv algorithms
                         # and kernel sums reassociate, as the small chains)
TRAIN_STEPS = 4          # full-width steps a model (cut from 8)
TRAIN_TIMED_FROM = 3     # samples/s and data wait over steps 3..4


def small_train_config(**kw):
    """tests/test_harness.py's narrow training config, float32, no
    dropout."""
    from tera_mind_tpu_torch.config import TrainConfig
    return TrainConfig(image_size=32, net_ch=8, embed_channels=32,
                       rna_num=16, rna_slices=4, stain="all", batch_size=2,
                       accum_batches=2, lr=1e-3, compute_dtype="float32",
                       train_crop=64, dropout=0.0, **kw)


def check_small_train_step(device, method: str = "ours") -> dict:
    """One accumulated f32 train step of the narrow config of ``method``'s
    model on the card and on the CPU from the same weights (every leaf
    perturbed, so all get a gradient), batch and draws (noise, t, block
    origin): the loss within TRAIN_LOSS_ATOL and every gradient leaf
    within TRAIN_GRAD_TOL of its max |CPU grad|; returns the largest
    differences.  A baseline's conv biases whose channels reach only a
    GroupNorm of one channel a group have a gradient of 0 but for
    rounding: where the CPU's leaf is below 1e-6 of the largest gradient,
    the card's must be too (tests/test_torch_baselines.py's rule)."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.training.harness import Trainer

    conf = small_train_config(method=method)
    cpu = Trainer(conf, device="cpu")
    cpu.init_state()
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in cpu.model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
    card = Trainer(conf, device=device)
    load_jax_params(card.model, export_params(cpu.model))
    crop, gh = conf.train_crop, conf.train_crop // 16 + conf.gn_sz
    batch = {"image": rng.standard_normal(
        (4, crop, crop, conf.in_channels)).clip(-1, 1).astype(np.float32),
        "rna": rng.integers(0, 3, (4, gh, gh, 4 * conf.rna_num)
                            ).astype(np.float32)}
    pad = crop + conf.image_size
    draws = [(rng.integers(0, 1000, 2), rng.standard_normal(
        (2, pad, pad, conf.in_channels)).astype(np.float32),
        tuple(int(v) for v in rng.integers(0, 2, 2))) for _ in range(2)]

    def on(tr):
        return [(torch.as_tensor(t, device=tr.device),
                 torch.as_tensor(n, device=tr.device), blk)
                for t, n, blk in draws]

    loss_c, grads_c = cpu.loss_and_grads(cpu.shape_batch(batch), on(cpu))
    loss_g, grads_g = card.loss_and_grads(card.shape_batch(batch), on(card))
    out = {"loss": abs(float(loss_g) - float(loss_c)), "grad": 0.0,
           "vanishing": []}
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_c.values())
    for name, gc in grads_c.items():
        top = float(gc.abs().max())
        d = float((grads_g[name].cpu() - gc).abs().max())
        if method != "ours" and top <= floor:
            require(name.endswith("_conv.bias")
                    and float(grads_g[name].abs().max()) <= floor,
                    f"small train step [{method}] grad {name}: CPU {top}, "
                    f"card {float(grads_g[name].abs().max())}, floor "
                    f"{floor}")
            out["vanishing"].append(name)
            continue
        require(d <= TRAIN_GRAD_TOL * max(top, 1e-12),
                f"small train step grad {name}: {d} of max {top}")
        out["grad"] = max(out["grad"], d / max(top, 1e-12))
    require(out["loss"] <= TRAIN_LOSS_ATOL,
            f"small train step loss: card {float(loss_g)}, CPU "
            f"{float(loss_c)}")
    log(f"small f32 train step [{method}], card vs CPU: loss "
        f"{float(loss_g):.6f} vs {float(loss_c):.6f} (|d| "
        f"{out['loss']:.3g}, tol {TRAIN_LOSS_ATOL}); gradients within "
        f"{out['grad']:.3g} of each leaf's max (tol {TRAIN_GRAD_TOL}), "
        f"{len(grads_c)} leaves"
        + (f", {len(out['vanishing'])} vanishing below {floor:.3g} on both"
           if method != "ours" else ""))
    return out


def read_train_launches() -> tuple:
    """(launches of K1, K1b, K2, K2b, K5, K5b, K6, K7; K1b's, K2b's and
    K5b's by variant).  Requires every K1 launch to be without the
    epilogue."""
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    require(k1.launches_by_epilogue["modulate"] == 0,
            f"training launched K1 with the modulate "
            f"{k1.launches_by_epilogue}")
    return ({"rmsnorm": k1.launches, "rmsnorm_bwd": k1.bwd.launches,
             "window_attention": k2.launches,
             "window_attention_bwd": k2.bwd.launches,
             "grouped_rmsnorm": k5.launches,
             "grouped_rmsnorm_bwd": k5.bwd.launches,
             "residual": k6.launches, "gated_residual": k7.launches},
            {"rmsnorm_bwd": dict(k1.bwd.launches_by_variant),
             "window_attention_bwd": dict(k2.bwd.launches_by_variant),
             "grouped_rmsnorm_bwd": dict(k5.bwd.launches_by_variant)})


def run_training(device, path: str, tmp: Path,
                 steps: int = TRAIN_STEPS) -> dict:
    """``cli.train``'s own builder on the 638850 preset at full width
    (``--synthetic --batch 32``: accum 2, 128 patches of 64^2 a
    microbatch; bf16 compute, f32 params, dropout 0.1, lr 2e-5, grad clip
    1), the 5D model, ``--packed``, or a baseline (``--method patch-dm``
    or ``sinf``: float32 compute but in the RNA tower, as JAX's modules
    without ``dtype=`` promote to their float32 params), for ``steps``
    steps with the launch counters set to 0 just before ``fit``; then save
    -> restore on the card (bit-equal) and, for the 5D model and
    patch-dm, ``cli.generate`` on a 1x1 grid for 2 steps from the
    checkpoint the trainer wrote (patch-dm with ``--no_packed``)."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.cli import generate
    from tera_mind_tpu_torch.cli import train as train_cli
    from tera_mind_tpu_torch.training.harness import Trainer

    extra = {"5d": [], "packed": ["--packed"]}.get(path, ["--method", path])
    args = train_cli.parse_args(
        ["--synthetic", "--batch", "32", "--max_steps", str(steps),
         "--device", str(device)] + extra)
    t0 = time.perf_counter()
    conf, ds, trainer, _ = train_cli.build(args)
    conf.base_dir = str(tmp / path)
    require((conf.batch_size_effective, conf.accum_batches, conf.dropout,
             conf.lr, conf.grad_clip, conf.compute_dtype, conf.remat)
            == (64, 2, 0.1, 2e-5, 1.0, "bfloat16", False),
            f"cli.train preset {conf}")
    state = trainer.init_state()
    require(all(p.dtype == torch.float32 for p in trainer.model.parameters()),
            "training parameters are not float32")
    before = {n: p.detach().clone() for n, p in state.params.items()}
    n_params = sum(p.numel() for p in state.params.values())
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = peak_rss_gib()
    smi_proc = start_card_sampler()
    try:
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.fit(train_cli.epoch_batches(
            ds, conf.batch_size_effective), max_steps=steps,
            state=state, log_every=1, metrics=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        card = stop_card_sampler(smi_proc)
    got, got_variants = read_train_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rss = peak_rss_gib()
    want_step = TRAIN_LAUNCHES[path]
    want = {k: want_step[k.removesuffix("_bwd")] * steps for k in got}
    want_variants = {k: {v: n * steps for v, n in by.items()}
                     for k, by in TRAIN_BWD_VARIANTS[path].items()}
    timed = trainer.log[TRAIN_TIMED_FROM - 1:]
    data_s = sum(r["data_s"] for r in timed)
    step_s = sum(r["step_s"] for r in timed)
    rate = conf.batch_size_effective * len(timed) / (data_s + step_s)
    losses = [r["loss"] for r in trainer.log]
    changed = max(float((state.params[n].detach() - p).abs().max())
                  for n, p in before.items())
    log(f"training [{path}]: {n_params / 1e6:.1f}M f32 params, built in "
        f"{build_s:.1f} s; {steps} steps of 64 samples in {secs:.2f} "
        f"s; steps {TRAIN_TIMED_FROM}-{steps}: {rate:.2f} samples/s, "
        f"{step_s / len(timed):.3f} s a step on the device, data wait "
        f"{100 * data_s / (data_s + step_s):.1f} %; losses "
        f"{[round(v, 4) for v in losses]}; peak device memory {peak:.2f} "
        f"GiB, the process's peak host RSS {rss:.2f} GiB ({rss_before:.2f} "
        f"before); launches {got} (expected {want}), backward by variant "
        f"{got_variants} (expected {want_variants}); {card}")
    require(all(np.isfinite(losses)) and len(losses) == steps,
            f"training losses {losses}")
    require(changed > 0, "training left the parameters unchanged")
    require(got == want, f"training launches {got}, expected {want}")
    require(got_variants == want_variants,
            f"training backward launches by variant {got_variants}, "
            f"expected {want_variants}")
    # where autograd records, K5 runs no epilogue (the eager one follows)
    # and no prologue (the ResBlocks run their eager bias adds)
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    epi = dict(k5.launches_by_epilogue)
    require(epi == {e: want["grouped_rmsnorm"] if e == "none" else 0
                    for e in k5.EPILOGUES},
            f"training K5 launches by epilogue {epi}")
    pro = dict(k5.launches_by_prologue)
    require(pro == {"none": want["grouped_rmsnorm"], "bias": 0},
            f"training K5 launches by prologue {pro}")

    # save -> restore on the card, bit for bit
    trainer.save(state)
    again = Trainer(conf, device=device).restore()
    require(again is not None and again.step == state.step
            and again.opt_state.count == state.opt_state.count,
            "restore found no checkpoint or another step")
    for n, p in state.params.items():
        require(torch.equal(again.params[n], p)
                and torch.equal(again.opt_state.mu[n], state.opt_state.mu[n])
                and torch.equal(again.opt_state.nu[n], state.opt_state.nu[n]),
                f"restore is not bit-equal at {n}")
    log(f"training [{path}]: save -> restore bit-equal at step {state.step}")
    out = dict(samples_per_s=rate, step_s=step_s / len(timed),
               data_wait_pct=100 * data_s / (data_s + step_s),
               seconds=secs, peak_gib=peak, host_rss_gib=rss,
               launches=got, launches_per_step=want_step,
               launches_by_variant=got_variants, losses=losses,
               params_m=n_params / 1e6)
    del trainer, again, state, before
    torch.cuda.empty_cache()
    out["ckpt"] = Path(conf.logdir) / "ckpt"
    if path in ("5d", "patch-dm"):
        t0 = time.perf_counter()
        gen_out = generate.main([
            "--ckpt_pth", str(out["ckpt"]), "--hnm", "1", "--wnm", "1",
            "--tot_epoch", "2", "--synthetic", "--device", str(device),
            "--out_dir", str(tmp / f"gen_tiles_{path}")]
            + (["--no_packed"] if path == "patch-dm" else []))
        require_output(gen_out, (256, 256, 100))
        out["generate_s"] = time.perf_counter() - t0
        log(f"cli.generate from the trained {path} checkpoint: 1x1 grid, 2 "
            f"steps in {out['generate_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 14-15: gene-gene attention extraction and tile evaluation
# ---------------------------------------------------------------------------

ATTN_ROI_SIDE = 16       # ROI 0 of the 638850 preset: 16 x 16 tiles
ATTN_K1_PER_TILE = 4     # one q-norm per z-group: 3 sliding pairs + all z
ATTN_TILE_SHAPE = (4, 16, 16, 8)   # z-groups, bins, bins, 2 x 4 genes
ATTN_TOL = 1e-5          # attention stacks, card vs CPU (float32)
EVAL_REL_TOL = 1e-5      # psnr / ssim / ms_ssim, card vs CPU
EVAL_DFID_REL_TOL = 1e-4  # Inception d-FID: card vs CPU, port vs export


def run_attn(device, ckpt: Path, tmp: Path) -> dict:
    """``cli.attn --calc_attn --synthetic --pathway ROI --roi 0`` on the
    card from the 5D training phase's checkpoint, with the launch counters
    set to 0 just before it: 256 float16 tiles, exactly 4 K1 launches a
    tile (all ``vector``), the ensemble's rows summing to 1; then two of
    the tiles recomputed with the CLI's own loader and tile function on
    the CPU (``--device cpu``) against the card's."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.cli import attn as attn_cli
    from tera_mind_tpu_torch.data.tilestore import TileStore

    out_dir = tmp / "attn"
    argv = ["--calc_attn", "--synthetic", "--mouse", "638850", "--pathway",
            "ROI", "--roi", "0", "--ckpt_pth", str(ckpt), "--out_dir",
            str(out_dir)]
    reset_launches()
    t0 = time.perf_counter()
    rec = attn_cli.main(argv + ["--device", str(device)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, got_variants = read_launches()
    n_tiles = ATTN_ROI_SIDE ** 2
    want = {"rmsnorm": n_tiles * ATTN_K1_PER_TILE, "window_attention": 0,
            "grouped_rmsnorm": 0, "residual": 0, "gated_residual": 0}
    log(f"attn [ROI 0, {n_tiles} tiles]: {secs:.2f} s = {n_tiles / secs:.3f}"
        f" tiles/s ({rec['seconds']:.2f} s in the tile loop = "
        f"{n_tiles / rec['seconds']:.3f} tiles/s; the rest builds the "
        f"synthetic gene field and loads the weights); launches {got} "
        f"(expected {want}), by variant {got_variants}")
    require(got == want, f"attn launches {got}, expected {want}")
    require(got_variants["rmsnorm"] == {"strided": 0,
                                        "vector": want["rmsnorm"]},
            f"attn K1 variants {got_variants['rmsnorm']}")

    store = TileStore(out_dir)
    names = [n for n in store.names() if n[0].isdigit()]
    require(len(names) == n_tiles and names == sorted(rec["names"]),
            f"attn store holds {len(names)} tiles, expected {n_tiles}")
    for n in names:
        tile = store.read(n)
        require(tile.dtype == np.float16 and tile.shape == ATTN_TILE_SHAPE
                and bool(np.isfinite(tile).all()),
                f"attn tile {n}: {tile.dtype} {tile.shape}")
    ens = np.load(out_dir / "attn_ensemble.npy")
    row_err = float(np.abs(ens.sum(-1) - 1).max())
    require(ens.shape == (229, 229) and row_err <= 1e-5,
            f"attn_ensemble {ens.shape}, rows off 1 by {row_err}")

    conf, glst, gene = rec["conf"], rec["glst"], rec["gene"]
    cpu = torch.device("cpu")
    ext_cpu = attn_cli.load_extractor(
        attn_cli.parse_args(argv + ["--device", "cpu"]), conf, cpu)
    errs = []
    for r, c in ((0, 0), (ATTN_ROI_SIDE - 1, ATTN_ROI_SIDE - 2)):
        stack = gene[r, c]
        tile_cpu, attn_cpu = attn_cli.attn_tile(ext_cpu, stack, conf, glst,
                                                cpu)
        _, attn_card = attn_cli.attn_tile(rec["extractor"], stack, conf,
                                          glst, device)
        err = float(np.abs(attn_card - attn_cpu).max())
        stored = store.read(rec["names"][r * ATTN_ROI_SIDE + c])
        gap = np.abs(stored.astype(np.float32) - tile_cpu.astype(np.float32))
        spacings = float((gap / np.spacing(np.abs(tile_cpu))
                          .astype(np.float32)).max())
        errs.append(dict(tile=[r, c], attn_max_abs_err=err,
                         tile_f16_spacings=spacings))
        require(err <= ATTN_TOL, f"attn tile ({r}, {c}): attention card vs "
                f"CPU {err} > {ATTN_TOL}")
        require(spacings <= 1.0, f"attn tile ({r}, {c}): stored tile "
                f"{spacings} float16 spacings from the CPU's")
    log(f"attn: {names[0]} .. {names[-1]} tiles {ATTN_TILE_SHAPE} float16, "
        f"genes {glst.tolist()}; ensemble rows sum to 1 within {row_err:.2g};"
        f" card vs CPU: {errs}")
    return dict(seconds=secs, loop_seconds=rec["seconds"],
                tiles=n_tiles, tiles_per_s=n_tiles / secs,
                launches=got, variants=got_variants, cpu_check=errs,
                ensemble_row_err=row_err)


def write_tiles(out, root: Path) -> Path:
    """A (GRID*256, GRID*256, channels) chain output as float16 tiles in a
    ``TileStore``, named as ``cli.generate`` names them."""
    import numpy as np

    from tera_mind_tpu_torch.data.tilestore import TileStore, tile_name
    store = TileStore(root).create()
    for r in range(GRID):
        for c in range(GRID):
            h0, w0 = 256 + 256 * r, 256 + 256 * c
            store.write(tile_name(h0, h0 + 256, w0, w0 + 256),
                        out[256 * r:256 * (r + 1), 256 * c:256 * (c + 1)]
                        .astype(np.float16))
    return root


def random_inception(path: Path) -> None:
    """The port's InceptionV3 (FID variant) with seeded random weights and
    non-trivial BatchNorm statistics, traced to ``path`` (torchscript)."""
    import torch

    from tera_mind_tpu_torch.metrics.inception import InceptionV3Features
    torch.manual_seed(0)
    m = InceptionV3Features()
    with torch.no_grad():
        for mod in m.modules():
            # He-normal convs keep the activations' scale through the 94
            # layers (PyTorch's default init shrinks them until every
            # input gives the same features)
            if isinstance(mod, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(mod.weight,
                                              nonlinearity="relu")
            if isinstance(mod, torch.nn.BatchNorm2d):
                torch.nn.init.normal_(mod.weight, 1.0, 0.1)
                torch.nn.init.normal_(mod.bias, 0.0, 0.05)
                mod.running_mean.normal_(0.0, 0.05)
                mod.running_var.uniform_(0.6, 1.4)
    torch.jit.trace(m.eval(), torch.zeros(1, 3, 299, 299)).save(str(path))


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def run_evaluate(device, outs: dict, tmp: Path, int8_stats: dict) -> dict:
    """``python -m tera_mind_tpu_torch.cli.evaluate`` as a subprocess (so
    PyTorch's default TF32 flags apply) on the full-width int8 chain's 2x2
    tiles against the bf16 packed chain's: ``--features pool`` on the card
    and on the CPU (psnr / ssim / ms_ssim within 1e-5 relative, pool_fid
    and the intensity statistics equal), then ``--features inception`` and
    ``--features torchscript`` on a traced random-weight InceptionV3, card
    and CPU (every d_fid within 1e-4 relative of the card's inception
    one)."""
    gen_dir = write_tiles(outs["int8"], tmp / "eval_int8")
    real_dir = write_tiles(outs["packed"], tmp / "eval_bf16")
    root = Path(__file__).resolve().parent

    def evaluate(*flags) -> dict:
        """The CLI on the card and with ``--device cpu`` at once (two
        processes): {device: report}."""
        runs = {}
        for dev in (str(device), "cpu"):
            report = tmp / f"eval_report_{dev.replace(':', '')}.json"
            cmd = [sys.executable, "-m", "tera_mind_tpu_torch.cli.evaluate",
                   "--gen_dir", str(gen_dir), "--real_dir", str(real_dir),
                   "--report", str(report), "--device", dev, *flags]
            runs[dev] = (report, subprocess.Popen(
                cmd, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        t0 = time.perf_counter()
        errs = {}
        try:
            for dev, (_, proc) in runs.items():
                errs[dev] = proc.communicate(timeout=600)[1]
        finally:
            for _, proc in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        secs = time.perf_counter() - t0
        reps = {}
        for dev, (report, proc) in runs.items():
            require(proc.returncode == 0, f"cli.evaluate {flags} --device "
                    f"{dev}: exit {proc.returncode}: {errs[dev][-3000:]}")
            reps[dev] = rep = json.loads(report.read_text())
            log(f"cli.evaluate {' '.join(flags)} --device {dev} (the pair "
                f"in {secs:.1f} s): " + json.dumps(
                    {k: v for k, v in rep.items()
                     if k not in ("gen_dir", "pool_fid_note")}))
        return reps

    card = str(device)
    reports = {"pool": evaluate("--features", "pool")}
    a, b = reports["pool"][card], reports["pool"]["cpu"]
    require(set(a) == set(b) and {"psnr", "ssim", "ms_ssim"} <= set(a),
            f"evaluate keys {sorted(a)} vs {sorted(b)}")
    errs = {k: rel(a[k], b[k]) for k in ("psnr", "ssim", "ms_ssim")}
    require(all(e <= EVAL_REL_TOL for e in errs.values()),
            f"evaluate card vs CPU: relative errors {errs}")
    for k in ("pool_fid", "gen_mean", "gen_std", "n_tiles", "n_paired"):
        require(a[k] == b[k], f"evaluate {k}: card {a[k]} vs CPU {b[k]}")

    weights = tmp / "inception_random.pt"
    t0 = time.perf_counter()
    random_inception(weights)
    log(f"traced a random-weight InceptionV3 in "
        f"{time.perf_counter() - t0:.1f} s")
    dfid = {}
    for feat in ("inception", "torchscript"):
        reports[feat] = evaluate("--features", feat, "--feature_weights",
                                 str(weights))
        for d, rep in reports[feat].items():
            dfid[f"{feat}/{d}"] = rep["d_fid"]
    ref = dfid[f"inception/{card}"]
    dfid_errs = {k: rel(v, ref) for k, v in dfid.items()}
    require(all(e <= EVAL_DFID_REL_TOL for e in dfid_errs.values()),
            f"Inception d_fid {dfid}: relative to the card's inception run "
            f"{dfid_errs} > {EVAL_DFID_REL_TOL}")
    log(f"evaluate card vs CPU: psnr/ssim/ms_ssim relative errors {errs} "
        f"(tol {EVAL_REL_TOL}), pool_fid and statistics equal; d_fid "
        f"{dfid}, relative to inception/{card} {dfid_errs} (tol "
        f"{EVAL_DFID_REL_TOL})")
    log(f"int8 vs bf16 (channel 0 of the full-width 2x2 chains, "
        f"informative): PSNR {a['psnr']:.4f} dB, SSIM {a['ssim']:.5f}, "
        f"MS-SSIM {a['ms_ssim']:.5f}; mean |d| over all channels "
        f"{int8_stats['mean']:.4g}")
    return dict(card=a, cpu=b, rel_errs=errs, d_fid=dfid,
                d_fid_rel_errs=dfid_errs,
                int8_vs_bf16={k: a[k] for k in ("psnr", "ssim", "ms_ssim")})


# ---------------------------------------------------------------------------
# phase 16: the baselines (patch-dm, sinf) on the card
# ---------------------------------------------------------------------------

BASELINE_FWD_TOL = 1e-4   # small f32 forward, card vs CPU, of |CPU out| max
BASELINES = ("patch-dm", "sinf")
BASELINE_STEPS = 3        # each baseline's full-width fit (cut from 8 to
                          # make room for phase 19; timed from
                          # TRAIN_TIMED_FROM)


def check_small_baseline(device, method: str) -> dict:
    """``method``'s narrow model (small_train_config, float32) with
    perturbed random weights: both outputs of one forward (2 blocks of
    2x2 patches) on the card against the CPU within BASELINE_FWD_TOL of
    the output's max, then one accumulated train step at phase 12's
    gates."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.models.nn import init_weights

    mconf = small_train_config(method=method).make_model_conf()
    cpu = init_weights(mconf.make_model(torch.float32), 3).eval()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
    card = load_jax_params(mconf.make_model(torch.float32),
                           export_params(cpu)).to(device).eval()
    x = rng.standard_normal((8, 32, 32, 4)).astype(np.float32)
    t = rng.integers(0, 1000, 2)
    rna = rng.integers(0, 3, (8, 2, 2, 64)).astype(np.float32)
    errs = {}
    with torch.no_grad():
        want = cpu(*(torch.as_tensor(a) for a in (x, t, rna)), 2, 2)
        got = card(*(torch.as_tensor(a, device=device)
                     for a in (x, t, rna)), 2, 2)
    for name, g, w in zip(("collage", "patches"), got, want):
        top = float(w.abs().max())
        errs[name] = float((g.cpu() - w).abs().max()) / top
        require(bool(torch.isfinite(g).all())
                and errs[name] <= BASELINE_FWD_TOL,
                f"small {method} forward {name}: {errs[name]} of max {top}")
    log(f"small f32 {method} forward, card vs CPU: {errs} of the output's "
        f"max (tol {BASELINE_FWD_TOL})")
    return {"forward": errs, "train_step": check_small_train_step(
        device, method)}


def check_baseline_refusals(device, ckpts: dict) -> None:
    """Where the JAX package fails for a baseline, the port refuses on the
    card too: ``cli.generate`` from the sinf checkpoint (SinfNet takes no
    ``decode_original``), from the patch-dm one without ``--no_packed``
    (no packed layout), and ``cli.train --method patch-dm --packed``."""
    from tera_mind_tpu_torch.cli import generate
    from tera_mind_tpu_torch.cli import train as train_cli

    def refused(fn, exc, words: str) -> str:
        try:
            fn()
        except exc as e:
            require(words in str(e), f"refusal without {words!r}: {e}")
            return str(e).splitlines()[0]
        raise SmokeFailure(f"no refusal ({words})")

    base = ["--hnm", "1", "--wnm", "1", "--synthetic", "--device",
            str(device)]
    msgs = [
        refused(lambda: generate.build(generate.parse_args(
            ["--ckpt_pth", str(ckpts["sinf"]), "--no_packed", *base])),
            SystemExit, "decode_original"),
        refused(lambda: generate.build(generate.parse_args(
            ["--ckpt_pth", str(ckpts["patch-dm"]), *base])),
            SystemExit, "--no_packed"),
        refused(lambda: train_cli.build(train_cli.parse_args(
            ["--synthetic", "--method", "patch-dm", "--packed", "--device",
             str(device)])), ValueError, "packed layout")]
    log(f"baseline refusals on the card, as JAX fails: {msgs}")


# ---------------------------------------------------------------------------
# phase 17: generation over several ranks on the card
# ---------------------------------------------------------------------------

RANK_GRID = 2             # in memory: 2x2 tiles over a (2, 1) mesh
RANK_STREAM_STEPS = 2     # depth of the band-parallel 4x4 chain
RANK_TIMEOUT_S = 600      # a rank process's wall clock
RANK_GROUP_TIMEOUT_S = 300   # a wait on another rank
# each rank's launches (scripts/kernel_shapes.py --ranks 2 [--stream
# --steps 2]): in memory a 1x2-tile block, 45 patches a z-window, 125 UNet
# calls (MAIN_STEPS) + the planner's probe; streamed a 2x4-tile band, two
# 2x2 windows of 5 z-windows a call, 2 steps
RANK_LAUNCHES = {
    "memory": {"rmsnorm": 26 * 126, "window_attention": 6 * 126,
               "grouped_rmsnorm": 57 * 126, "residual": 28 * 126,
               "gated_residual": 12 * 126},
    "stream": {"rmsnorm": 26 * 20, "window_attention": 6 * 20,
               "grouped_rmsnorm": 57 * 20, "residual": 28 * 20,
               "gated_residual": 12 * 20}}


def rank_count() -> tuple:
    """(ranks of the band-parallel and small runs, cards): 2 ranks on a
    single card, else one a card, at most 4."""
    import torch
    cards = torch.cuda.device_count()
    return (2 if cards == 1 else min(4, cards)), cards


def rank_worker(kind: str, rank: str, n: str, port: str, tmp: str,
                *argv) -> None:
    """What one rank process of phase 17 runs (``python -c``, see
    :func:`spawn_ranks`); its results go to ``{tmp}/{kind}_{rank}.json``
    (and ``.npy``)."""
    import os

    import numpy as np
    import torch

    rank, n = int(rank), int(n)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from tera_mind_tpu_torch.parallel import band, halo, mesh
    res = {"rank": rank, "pid": os.getpid()}
    if kind in ("dp", "dp_cli"):
        res.update(dp_rank_worker(kind, rank, n, port, tmp, argv))
    elif kind == "small":
        device = mesh.multihost_init(f"127.0.0.1:{port}", n, rank,
                                     device="cuda",
                                     timeout_s=RANK_GROUP_TIMEOUT_S)
        try:
            res.update(small_rank_checks(device, n))
        except BaseException:
            mesh.shutdown(barrier=False)
            raise
        mesh.shutdown()
    else:                      # cli.generate.main as a user runs it
        from tera_mind_tpu_torch.cli import generate
        device = mesh.rank_device("cuda", rank)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        halo.reset_stats()
        band.reset_stats()
        tee = Tee()
        import contextlib
        with contextlib.redirect_stdout(tee):
            out = generate.main(list(argv) + [
                "--coordinator", f"127.0.0.1:{port}", "--num_processes",
                str(n), "--process_id", str(rank), "--device", "cuda",
                "--dist_timeout", str(RANK_GROUP_TIMEOUT_S)])
        import re
        done = re.search(r"in ([0-9.]+) s;", tee.copy.getvalue())
        got, variants = read_launches()
        np.save(Path(tmp) / f"{kind}_{rank}.npy", out)
        res.update(launches=got, variants=variants, device=str(device),
                   seconds=float(done.group(1)), shape=list(out.shape),
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
                   halo=dict(halo.stats), strips=dict(band.stats))
    Path(tmp, f"{kind}_{rank}.json").write_text(json.dumps(res))


def small_rank_checks(device, n: int) -> dict:
    """A rank's small f32 checks on the card, each against the same
    computation in one process on this rank's device: the halo exchange
    of position-encoding blocks (bit-equal), one sharded block-major step
    of the small packed model on an (n, 1) mesh and band streaming K = 1
    and K = 2 (``SMALL_ATOL``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.models.nn import init_weights
    from tera_mind_tpu_torch.models.unet_packed import (make_packed_model,
                                                        pack_unet_params)
    from tera_mind_tpu_torch.parallel import band, halo, mesh
    from tera_mind_tpu_torch.parallel.generator import TeraGenerator
    from tera_mind_tpu_torch.parallel.streaming import (StreamConfig,
                                                        StreamingGenerator)

    rank = dist.get_rank()
    cards = torch.cuda.device_count()
    want_backend = mesh.choose_backend("cuda", n, cards)
    require(dist.get_backend() == want_backend,
            f"backend {dist.get_backend()}, the rule gives {want_backend}")
    route = ("nccl" if want_backend == "nccl" else
             "gloo_staged" if device.type == "cuda" else "gloo")
    out = {"backend": dist.get_backend(), "device": str(device), "errs": {}}
    # the halo: every value encodes its position in the whole image
    h, w, ch, pad = 40, 24, 6, 8
    shapes = [(2, 2)] if n == 4 else [(n, 1), (1, n)]
    for shape in shapes:
        m = mesh.make_mesh(("gr", "gc"), shape, device=device)
        r, c = m.coords
        for dt in (torch.float32, torch.bfloat16):
            y, x, z = torch.meshgrid(torch.arange(shape[0] * h),
                                     torch.arange(shape[1] * w),
                                     torch.arange(ch), indexing="ij")
            img = ((y * 64 + x + z / 8) / 64).to(device, dt)
            halo.reset_stats()
            got = halo.exchange_halo_2d(
                img[r * h:(r + 1) * h, c * w:(c + 1) * w].contiguous(), pad,
                m)
            want = halo.pad_halo_single(img, pad)[
                r * h:(r + 1) * h + 2 * pad, c * w:(c + 1) * w + 2 * pad]
            require(torch.equal(got, want), f"rank {rank}: halo {shape} "
                    f"{dt} differs from the whole image's pad")
            require(halo.stats["by_route"][route] == 1,
                    f"halo route {halo.stats['by_route']}, expected {route}")
            require(halo.stats["bytes"] == halo.exchange_bytes(
                (h, w, ch), pad, dt.itemsize, m.coords, shape),
                f"halo bytes {halo.stats['bytes']}")
    out["halo"] = {"shapes": [list(s) for s in shapes], "route": route}
    # the small packed model of phase 6, f32
    mconf, gconf, _ = small_setup()
    model5 = init_weights(mconf.make_model(), seed=3).eval()
    packed = load_jax_params(make_packed_model(mconf), pack_unet_params(
        export_params(model5), mconf)).eval()
    one = small_gen(packed, device, gconf)
    # one sharded block-major step on an (n, 1) mesh of n x 2 tiles
    rows, cols = n, 2
    gene = small_field_gene(gconf, rows, cols)
    state = one.init_state(rows, cols, row0=1, col0=1, grid_w=16)
    want = one.compile_step(rows, cols, block_major=True)(
        torch.as_tensor(state, device=device),
        torch.as_tensor(gene, device=device), 2).cpu().numpy()
    m = mesh.make_mesh(("gr", "gc"), (n, 1), device=device)
    sh = TeraGenerator(one.sampler, one.model_fn, gconf, mesh=m)
    r0, c0, lr, lc = sh.local_block(rows, cols)
    t = gconf.tile
    got = sh.compile_step(rows, cols, block_major=True)(
        torch.as_tensor(state[r0 * t:(r0 + lr) * t], device=device),
        torch.as_tensor(gene[r0:r0 + lr], device=device), 2).cpu().numpy()
    out["errs"]["sharded block-major step vs one process"] = err = float(
        np.abs(got - want[r0 * t:(r0 + lr) * t]).max())
    require(err <= SMALL_ATOL, f"rank {rank}: sharded step {err}")
    # band streaming over n bands of an (n + 1) x 3 grid, K = 1 and 2
    rows, cols = n + 1, 3
    gene = small_field_gene(gconf, rows, cols)
    b0, nb = band.band_partition(rows, n, rank)
    for k in (1, 2):
        sc = StreamConfig(progress=False, block_major=True,
                          steps_per_window=k)
        whole = StreamingGenerator(one, sc).run(
            rows, cols, gene, row0=1, col0=1, grid_w=16).read.float().numpy()
        ex = band.StripExchange(gconf.pad + gconf.patch * (k - 1),
                                cols * t, gconf.channels, device=device)
        got = StreamingGenerator(one, sc).run(
            nb, cols, lambda r, c: gene[b0 + r, c], row0=1 + b0, col0=1,
            grid_w=16, strip_exchange=ex, rows_above=b0,
            rows_below=rows - b0 - nb).read.float().numpy()
        key = f"band streaming K={k} vs one process"
        out["errs"][key] = err = float(
            np.abs(got - whole[b0 * t:(b0 + nb) * t]).max())
        require(err <= SMALL_ATOL, f"rank {rank}: {key} {err}")
    return out


def spawn_ranks(n: int, kind: str, tmp, *argv, module: str = None,
                env: dict = None) -> list:
    """Start ``n`` rank processes at once (``rank_worker`` of this script,
    or ``python -m module`` with ``argv`` and the rank's flags), wait for
    all of them and return their outputs; a rank that fails or outlives
    ``RANK_TIMEOUT_S`` fails the phase, and every rank still running is
    killed."""
    import os

    from tera_mind_tpu_torch.parallel.mesh import free_port

    port = free_port()
    here = str(Path(__file__).resolve().parent)
    procs = []
    for r in range(n):
        if module is None:
            cmd = [sys.executable, "-c",
                   f"import sys; sys.path.insert(0, {here!r}); "
                   "import chip_smoke; "
                   "chip_smoke.rank_worker(*sys.argv[1:])",
                   kind, str(r), str(n), str(port), str(tmp), *argv]
        else:
            cmd = [sys.executable, "-m", module, *argv, "--coordinator",
                   f"127.0.0.1:{port}", "--num_processes", str(n),
                   "--process_id", str(r)]
        log_file = open(Path(tmp, f"{kind}_{r}.log"), "w+")
        procs.append((subprocess.Popen(
            cmd, cwd=here, env={**os.environ, **(env or {})},
            stdout=log_file, stderr=subprocess.STDOUT, text=True), log_file))
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [r for r, (p, _) in enumerate(procs)
                      if p.poll() not in (None, 0)]
            require(not failed and time.perf_counter() < deadline,
                    f"{kind}: rank {failed[0]} of {n} exited "
                    f"{procs[failed[0]][0].returncode}" if failed else
                    f"{kind}: a rank outlived {RANK_TIMEOUT_S} s")
            time.sleep(0.2)
        outs = []
        for r, (p, f) in enumerate(procs):
            f.seek(0)
            outs.append(f.read())
            require(p.returncode == 0, f"{kind}: rank {r} of {n} exited "
                    f"{p.returncode}:\n{outs[-1][-4000:]}")
        return outs
    except SmokeFailure as e:
        tails = []
        for r, (p, f) in enumerate(procs):
            f.seek(0)
            tails.append(f"--- rank {r}:\n{f.read()[-3000:]}")
        raise SmokeFailure(f"{e}\n" + "\n".join(tails)) from None
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()


def run_ranks(device, packed_out, stream_ref, counts) -> dict:
    """Phase 17: the backend and devices, the small f32 checks and
    ``mp_demo --band`` over ranks on the card, then ``cli.generate`` over
    2 ranks at full width in memory (against phase 9's chain) and with
    ``--stream`` on the 4x4 grid (against the one-process run of the same
    depth), per-rank launches required, and ``--stream`` through every
    card in one process where there are two."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from tera_mind_tpu_torch.cli import generate
    from tera_mind_tpu_torch.parallel.mesh import choose_backend

    t_phase = time.perf_counter()
    n, cards = rank_count()
    backend = choose_backend("cuda", n, cards)
    total = torch.cuda.get_device_properties(0).total_memory
    per_card = -(-n // cards)      # ranks sharing one card
    env = {"TMT_HBM_BYTES": str(total // per_card)}
    log(f"phase 17: {n} ranks on {cards} card(s), backend {backend} by the "
        f"rule; rank i on cuda:{{i % {cards}}}; each rank's planner budget "
        f"TMT_HBM_BYTES {total // per_card / 2 ** 30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    res = {"ranks": n, "cards": cards, "backend": backend}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(n, "small", tmp, env=env)
        small = [json.loads(Path(tmp, f"small_{r}.json").read_text())
                 for r in range(n)]
        for s in small:
            require(s["backend"] == backend, f"rank {s['rank']} backend "
                    f"{s['backend']}")
            log(f"phase 17 small, rank {s['rank']} on {s['device']} "
                f"({s['backend']}): halo bit-equal on meshes "
                f"{s['halo']['shapes']} via {s['halo']['route']}; " +
                ", ".join(f"{k} {v:.3g}" for k, v in s["errs"].items()) +
                f" (tol {SMALL_ATOL})")
        res["small"] = small
        outs = spawn_ranks(2, "mp_demo", tmp, "--device", "cuda", "--band",
                           "--dist_timeout", str(RANK_GROUP_TIMEOUT_S),
                           module="tera_mind_tpu_torch.parallel.mp_demo",
                           env=env)
        for r, out in enumerate(outs):
            for tag in (f"process {r}/2 ok", f"process {r} band-streaming "
                        "ok", f"process {r} band-streaming K2 ok"):
                require(f"[mp_demo] {tag}" in out,
                        f"mp_demo rank {r}: no '{tag}':\n{out[-3000:]}")
        log("phase 17 mp_demo --device cuda --band over 2 ranks: " +
            " | ".join(line for out in outs for line in out.splitlines()
                       if line.startswith(("[mp_demo]", "[mesh]"))))
        res["small_seconds"] = time.perf_counter() - t0

        runs = {
            "memory": (2, ["--synthetic", "--hnm", str(RANK_GRID), "--wnm",
                           str(RANK_GRID), "--tot_epoch", str(MAIN_STEPS)]),
            "stream": (2, ["--synthetic", "--stream", "--hnm",
                           str(STREAM_GRID), "--wnm", str(STREAM_GRID),
                           "--tot_epoch", str(RANK_STREAM_STEPS)])}
        refs = {"memory": packed_out, "stream": stream_ref}
        for kind, (nr, argv) in runs.items():
            t0 = time.perf_counter()
            spawn_ranks(nr, kind, tmp, *argv, "--out_dir",
                        f"{tmp}/{kind}_tiles", env=env)
            wall = time.perf_counter() - t0
            ranks = [json.loads(Path(tmp, f"{kind}_{r}.json").read_text())
                     for r in range(nr)]
            union = np.concatenate([np.load(Path(tmp, f"{kind}_{r}.npy"))
                                    for r in range(nr)])
            want, want_var = expected_launches(
                counts, RANK_LAUNCHES[kind]["window_attention"] // counts[2])
            g = RANK_GRID if kind == "memory" else STREAM_GRID
            require_output(union, (g * 256, g * 256, 100))
            steps = MAIN_STEPS if kind == "memory" else RANK_STREAM_STEPS
            for rk in ranks:
                tiles = rk["shape"][0] * rk["shape"][1] // 256 ** 2
                ex = rk["halo"] if kind == "memory" else rk["strips"]
                rk["tiles_per_s"] = tiles * steps / STEPS / rk["seconds"]
                log(f"phase 17 {kind}, rank {rk['rank']} on {rk['device']}: "
                    f"{tiles} tiles x {steps} steps in {rk['seconds']:.2f} s"
                    f" = {rk['tiles_per_s']:.5f} tiles/s (a tile {STEPS} "
                    "steps); "
                    f"{'halo' if kind == 'memory' else 'band strips'} "
                    f"{ex['calls']} exchanges, "
                    f"{ex['bytes'] / max(1, ex['calls']) / 2 ** 20:.3f} MiB "
                    f"sent and {ex['seconds'] / max(1, ex['calls']) * 1e3:.2f}"
                    " ms an exchange, waiting for the neighbour included "
                    f"({ex.get('by_route', backend)}); peak device"
                    f" memory {rk['peak_gib']:.2f} GiB; launches "
                    f"{rk['launches']} (expected {want}), by variant "
                    f"{rk['variants']}")
                require(rk["launches"] == want == RANK_LAUNCHES[kind],
                        f"{kind} rank {rk['rank']}: launches "
                        f"{rk['launches']}, expected {want} / "
                        f"{RANK_LAUNCHES[kind]}")
                require(rk["variants"] == want_var,
                        f"{kind} rank {rk['rank']}: variants "
                        f"{rk['variants']}, expected {want_var}")
                require(ex["calls"] == (steps if kind == "memory"
                                        else steps + 1),
                        f"{kind} rank {rk['rank']}: {ex['calls']} exchanges")
            secs = max(rk["seconds"] for rk in ranks)
            rate = g * g * steps / STEPS / secs
            log(f"phase 17 {kind}: {g * g} tiles x {steps} steps over "
                f"{nr} ranks in {secs:.2f} s (slowest rank) = {rate:.5f} "
                f"tiles/s in all (a tile {STEPS} steps); {wall:.1f} s wall "
                "with the ranks' start and build")
            res[kind] = dict(ranks=ranks, seconds=secs, wall=wall,
                             tiles_per_s=rate,
                             gates=require_chain_gates(
                                 refs[kind], union,
                                 f"phase 17 {kind} union of {nr} ranks vs "
                                 "one process"))
        if cards >= 2:
            t0 = time.perf_counter()
            argv = runs["stream"][1] + ["--out_dir", f"{tmp}/devices",
                                        "--device", "cuda"]
            reset_launches()
            out = generate.main(argv)
            got = read_launches()[0]
            log(f"phase 17 --stream through {cards} cards in one process "
                f"(devices=): {time.perf_counter() - t0:.2f} s, launches "
                f"{got}")
            require(got == {k: 2 * v for k, v in
                            RANK_LAUNCHES["stream"].items()},
                    f"devices= launches {got}")
            res["devices"] = require_chain_gates(
                stream_ref, out, "phase 17 devices= vs one card")
        else:
            log("phase 17: --stream through several cards in one process "
                "(devices=) needs a second card; this machine has one")
            res["devices"] = None
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 17 seconds: {res['phase_seconds']:.1f}")
    return res


# ---------------------------------------------------------------------------
# phase 18: data-parallel training over ranks on the card
# ---------------------------------------------------------------------------

DP_STEPS = 3              # full-width steps, one process and over ranks
DP_TIMED_FROM = 2         # samples/s and step seconds over steps 2..3
DP_DEMO_TOL = 2e-5        # mp_demo's f32 loss history against --train_ref
                          # (JAX's tests/test_multiprocess.py gate)
# Set before the first chip run.  Over ranks the same samples, draws and
# bf16 kernels run at half the batch, so a loss moves only where a conv or
# matmul algorithm for the smaller batch rounds otherwise (bf16 noise of
# ~4e-3 on an output averages to ~1e-5 over the 2 M terms of the mean) and
# where the all-reduced gradient's float32 sums reorder (Adam steps of at
# most 2 lr = 4e-5 a parameter).  Rows or draws out of place, or a loss not
# reduced over the ranks, move it by the batch's spread (~1e-2 or more).
DP_LOSS_ATOL = 1e-3


def train_rank_shapes(n: int) -> tuple:
    """(K1 and K1b (rows, C), K2 and K2b (B, N, D)) of one rank's
    microbatch of ``cli.train --batch 32`` over ``n`` ranks: the
    one-process shapes with 32 / n samples (scripts/kernel_shapes.py
    --train --ranks n)."""
    return ([(r // n, c) for r, c in TRAIN_K1_SHAPES],
            [(b // n, m, d) for b, m, d in TRAIN_K2_SHAPES])


def check_rank_train_kernels(device, n: int) -> dict:
    """K1, K1b, K2 and K2b at one rank's training shapes over ``n`` ranks
    by phases 3 and 4's checks and timings (:func:`k1_row` with the
    float32 master weight that training passes, :func:`k1b_row`,
    :func:`k2_row`, :func:`k2b_row`: every gate of theirs), each row
    tagged with the ranks and its launches a step; a step's sums logged.
    Returns {name: [row]}."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(18)
    path = f"dp rank of {n}"
    k1_shapes, k2_shapes = train_rank_shapes(n)
    rows = {"rmsnorm": [k1_row(g, device, r, c, path, torch.float32)
                        for r, c in k1_shapes],
            "rmsnorm_bwd": [k1b_row(g, device, r, c, path)
                            for r, c in k1_shapes],
            "window_attention": [k2_row(g, device, b, m, d, path)
                                 for b, m, d in k2_shapes],
            "window_attention_bwd": [k2b_row(g, device, b, m, d, path)
                                     for b, m, d in k2_shapes]}
    counts = dp_step_counts(n)
    for name, rs in rows.items():
        c = counts["rmsnorm" if name.startswith("rmsnorm") else
                   "window_attention"]
        step = {k: sum(r[k] * m for r, m in zip(rs, c))
                for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
        for r, m in zip(rs, c):
            r.update(ranks=n, launches_per_step=m)
        log(f"{name} at a rank's training shapes ({n} ranks), a step: "
            f"kernel {step['ms']:.3f} ms, bound {step['bound_ms']:.3f} ms, "
            f"plain {step['plain_ms']:.3f} ms, library "
            f"{step['library_ms']:.3f} ms ({sum(c)} launches)")
    return rows


def dp_step_counts(n: int) -> dict:
    """Launches a step of each shape of :func:`train_rank_shapes`, by
    kernel (scripts/kernel_shapes.py --train --ranks n)."""
    ks = kernel_shapes()
    k1, k2 = ks.train_rank_shapes(n)
    k1_shapes, k2_shapes = train_rank_shapes(n)
    return {"rmsnorm": [k1[s] * ks.TRAIN_ACCUM for s in k1_shapes],
            "window_attention": [k2[s] * ks.TRAIN_ACCUM for s in k2_shapes]}


def dp_config():
    """``cli.train --synthetic --batch 32``'s preset (the 5D model, accum
    2), dropout 0 for the comparison with one process."""
    from tera_mind_tpu_torch.config import prep_config
    conf = prep_config("638850", batch=32)
    conf.dropout = 0.0
    return conf


def dp_steps(trainer, rank: int, ranks: int) -> dict:
    """DP_STEPS steps of ``trainer`` on its rows of the synthetic global
    batches of ``cli.train --synthetic`` (every process draws the same),
    the launch counters and the all-reduce's statistics set to 0 just
    before them: losses, step seconds, launches, the all-reduce's
    statistics, the parameters' digest after each step and the peak
    device memory."""
    import torch

    from tera_mind_tpu_torch.cli import train as train_cli
    from tera_mind_tpu_torch.data.dataset import SyntheticDataset
    from tera_mind_tpu_torch.parallel import mesh
    from tera_mind_tpu_torch.training.harness import state_digest

    conf = trainer.conf
    ds = SyntheticDataset(n=max(conf.batch_size * 8, 64),
                          crop=4 * conf.image_size,
                          gdim=conf.rna_num, snum=conf.rna_slices,
                          stain=conf.stain, pad_bins=conf.gn_sz // 2)
    it = train_cli.epoch_batches(ds, conf.batch_size_effective,
                                 accum=conf.accum_batches, rank=rank,
                                 ranks=ranks)
    state = trainer.init_state()
    dev = trainer.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "step_s": [], "digests": []}
    reset_launches()
    mesh.reset_reduce_stats()
    for _ in range(DP_STEPS):
        batch = trainer.shape_batch(next(it))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        out["losses"].append(float(loss))
        out["step_s"].append(time.perf_counter() - t0)
        out["digests"].append(state_digest(state, moments=False))
    out["launches"], out["variants"] = read_train_launches()
    out["reduce"] = dict(mesh.reduce_stats)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def dp_rank_worker(kind: str, rank: int, n: int, port: str, tmp: str,
                   argv: tuple) -> dict:
    """Phase 18's rank process: ``dp`` the full-width steps over a
    ``('dp',)`` mesh of the ranks (the parameters' digests all-gathered
    and compared after each step), ``dp_cli`` ``cli.train.main`` as a
    user runs it, in ``{tmp}/dp_cli``."""
    import os

    import torch

    from tera_mind_tpu_torch.parallel import mesh
    from tera_mind_tpu_torch.training import harness
    if kind == "dp":
        device = mesh.multihost_init(f"127.0.0.1:{port}", n, rank,
                                     device="cuda",
                                     timeout_s=RANK_GROUP_TIMEOUT_S)
        try:
            from tera_mind_tpu_torch.training.harness import Trainer
            trainer = Trainer(dp_config(), device=device)
            require(trainer.ndp == n and trainer.rank == rank,
                    f"rank {rank}: mesh {trainer.ndp}, rank {trainer.rank}")
            res = dp_steps(trainer, rank, n)
            for s, d in enumerate(res["digests"]):
                got = mesh.host_all_gather(d)
                require(len(set(got)) == 1, f"rank {rank}: parameters "
                        f"differ across ranks after step {s + 1}")
            res.update(backend=torch.distributed.get_backend(),
                       device=str(device))
        except BaseException:
            mesh.shutdown(barrier=False)
            raise
        mesh.shutdown()
        return res
    device = mesh.rank_device("cuda", rank)
    torch.cuda.set_device(device)
    written = []
    real = harness.write_checkpoint

    def spy(root, tree):
        written.append(int(tree["step"]))
        return real(root, tree)

    harness.write_checkpoint = spy
    from tera_mind_tpu_torch.cli import train as train_cli
    work = Path(tmp, "dp_cli")
    work.mkdir(exist_ok=True)
    os.chdir(work)
    reset_launches()
    state = train_cli.main(list(argv) + [
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n),
        "--process_id", str(rank), "--device", "cuda", "--dist_timeout",
        str(RANK_GROUP_TIMEOUT_S)])
    return dict(step=state.step, written=written, device=str(device),
                digest=harness.state_digest(state, moments=False),
                launches=read_train_launches()[0],
                peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)


def run_dp(device, n: int = None) -> dict:
    """Phase 18: data-parallel training over ``n`` ranks (2 sharing the
    card over gloo; with more cards one a card over NCCL): K1, K1b, K2
    and K2b at a rank's training shapes; mp_demo's f32 training over the
    ranks against one process on the card; the 5D model at full width
    over the ranks against one process on the same weights, batches and
    draws; ``cli.train`` over the ranks."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from tera_mind_tpu_torch.parallel import mp_demo
    from tera_mind_tpu_torch.parallel.mesh import choose_backend
    from tera_mind_tpu_torch.training.harness import Trainer

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    n = n or rank_count()[0]
    backend = choose_backend("cuda", n, cards)
    log(f"phase 18: data-parallel training over {n} ranks on {cards} "
        f"card(s), backend {backend} by the rule")
    res = {"ranks": n, "cards": cards, "backend": backend}
    t0 = time.perf_counter()
    res["kernels"] = check_rank_train_kernels(device, n)
    res["kernel_seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # small: mp_demo's f32 config, the ranks against one process
        t0 = time.perf_counter()
        outs = spawn_ranks(n, "dp_demo", tmp, "--device", "cuda",
                           "--train_only", "--dist_timeout",
                           str(RANK_GROUP_TIMEOUT_S),
                           module="tera_mind_tpu_torch.parallel.mp_demo")
        want = mp_demo.train_ref(n, device)
        for r, out in enumerate(outs):
            require(f"[mp_demo] process {r} train replicas bit-equal after "
                    f"each of {mp_demo.TRAIN_STEPS} steps" in out,
                    f"mp_demo rank {r}:\n{out[-3000:]}")
        line = [ln for ln in outs[0].splitlines() if "train losses:" in ln]
        require(len(line) == 1, f"mp_demo: no loss line:\n{outs[0][-3000:]}")
        got = [float(v) for v in line[0].split(":")[1].split()]
        err = max(abs(a - b) for a, b in zip(got, want))
        require(len(got) == len(want) and err <= DP_DEMO_TOL,
                f"mp_demo train losses {got}, train_ref {want}")
        log(f"phase 18 small: mp_demo --train_only over {n} ranks, losses "
            f"{got} against one process {want} (max |d| {err:.3g}, tol "
            f"{DP_DEMO_TOL}); the replicas' parameters and Adam moments "
            "bit-equal after every step (clip by global norm triggers at "
            f"each step); {time.perf_counter() - t0:.1f} s")
        res["small"] = dict(losses=got, ref=want, max_abs_err=err)

        # full width: one process, then the ranks, on the same everything
        conf = dp_config()
        one = Trainer(conf, device=device)
        one_run = dp_steps(one, 0, 1)
        del one
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks(n, "dp", tmp)
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"dp_{r}.json").read_text())
                 for r in range(n)]
        per_step = TRAIN_LAUNCHES["5d"]
        want_l = {k: per_step[k.removesuffix("_bwd")] * DP_STEPS
                  for k in TRAIN_KERNELS}
        want_v = {k: {v: c * DP_STEPS for v, c in by.items()}
                  for k, by in TRAIN_BWD_VARIANTS["5d"].items()}

        def rate(run, samples):
            timed = run["step_s"][DP_TIMED_FROM - 1:]
            return samples * len(timed) / sum(timed), sum(timed) / len(timed)

        one_rate, one_s = rate(one_run, conf.batch_size_effective)
        res["one"] = dict(losses=one_run["losses"], step_s=one_s,
                          samples_per_s=one_rate,
                          peak_gib=one_run["peak_gib"])
        log(f"phase 18 full width, one process: losses "
            f"{one_run['losses']}, {one_s:.3f} s a step, {one_rate:.2f} "
            f"samples/s, peak {one_run['peak_gib']:.2f} GiB")
        for rk in ranks:
            rk["samples_per_s"], rk["step_mean_s"] = rate(
                rk, conf.batch_size_effective // n)
            red = rk["reduce"]
            rk["reduce_per_step"] = dict(
                bytes=red["bytes"] / DP_STEPS,
                seconds=red["seconds"] / DP_STEPS,
                buckets=red["buckets"] / DP_STEPS)
            log(f"phase 18 full width, rank {rk['rank']} on {rk['device']} "
                f"({rk['backend']}): losses {rk['losses']}, "
                f"{rk['step_mean_s']:.3f} s a step, {rk['samples_per_s']:.2f}"
                f" samples/s; all-reduce {red['bytes'] / DP_STEPS / 1e6:.1f}"
                f" MB in {red['buckets'] / DP_STEPS:.0f} buckets and "
                f"{red['seconds'] / DP_STEPS:.3f} s a step "
                f"({red['by_route']}); peak device memory "
                f"{rk['peak_gib']:.2f} GiB; launches {rk['launches']} "
                f"(expected {want_l}), backward by variant {rk['variants']}")
            require(rk["backend"] == backend,
                    f"rank {rk['rank']} backend {rk['backend']}")
            require(rk["launches"] == want_l,
                    f"rank {rk['rank']} launches {rk['launches']}, "
                    f"expected {want_l}")
            require({k: rk["variants"][k] for k in want_v} == want_v,
                    f"rank {rk['rank']} variants {rk['variants']}, "
                    f"expected {want_v}")
            require(red["calls"] == DP_STEPS,
                    f"rank {rk['rank']}: {red['calls']} all-reduces")
            require(rk["losses"] == ranks[0]["losses"],
                    f"rank losses differ: {rk['losses']}")
            require(rk["digests"] == ranks[0]["digests"],
                    "rank parameters differ")
            d = max(abs(a - b) for a, b in zip(rk["losses"],
                                               one_run["losses"]))
            require(all(np.isfinite(rk["losses"])) and d <= DP_LOSS_ATOL,
                    f"rank {rk['rank']} losses {rk['losses']} against one "
                    f"process {one_run['losses']}: {d} > {DP_LOSS_ATOL}")
            rk["loss_err"] = d
        slowest = max(rk["step_mean_s"] for rk in ranks)
        total = conf.batch_size_effective / slowest
        log(f"phase 18 full width: {n} ranks {total:.2f} samples/s in all "
            f"(slowest rank {slowest:.3f} s a step) against {one_rate:.2f} "
            f"in one process; losses within "
            f"{max(rk['loss_err'] for rk in ranks):.3g} of one process's "
            f"(tol {DP_LOSS_ATOL}); parameters bit-equal across ranks "
            f"after every step; {wall:.1f} s wall with the ranks' start")
        res["full"] = dict(ranks=ranks, samples_per_s=total, wall=wall)

        # the CLI as a user runs it, over the ranks, with the preset's
        # dropout
        t0 = time.perf_counter()
        spawn_ranks(n, "dp_cli", tmp, "--synthetic", "--max_steps", "2")
        cli = [json.loads(Path(tmp, f"dp_cli_{r}.json").read_text())
               for r in range(n)]
        runs = list(Path(tmp, "dp_cli", "checkpoints").iterdir())
        require(len(runs) == 1, f"cli.train runs {runs}")
        from tera_mind_tpu_torch.training.harness import checkpoint_steps
        steps = checkpoint_steps(runs[0] / "ckpt")
        losses = [json.loads(ln).get("loss") for ln in
                  (runs[0] / "metrics.jsonl").read_text().splitlines()]
        losses = [v for v in losses if v is not None]
        require(steps == [2] and (runs[0] / "config.json").exists(),
                f"cli.train checkpoints {steps}")
        require(cli[0]["written"] == [2]
                and all(c["written"] == [] for c in cli[1:]),
                f"checkpoints written by rank: {[c['written'] for c in cli]}")
        require(losses and all(np.isfinite(losses)),
                f"cli.train losses {losses}")
        require(len({c["digest"] for c in cli}) == 1
                and all(c["step"] == 2 for c in cli),
                "cli.train ranks' parameters differ")
        log(f"phase 18 cli.train --synthetic --max_steps 2 over {n} ranks "
            "(the preset's dropout 0.1): one checkpoint at step "
            f"{steps} written by rank 0, logged losses {losses}, parameters "
            f"equal across ranks; peak device memory "
            f"{[round(c['peak_gib'], 2) for c in cli]} GiB; "
            f"{time.perf_counter() - t0:.1f} s")
        res["cli"] = dict(losses=losses, peak_gib=[c["peak_gib"]
                                                   for c in cli])
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 seconds: {res['phase_seconds']:.1f}")
    return res


# ---------------------------------------------------------------------------
# phase 19: the other published presets on the card
# ---------------------------------------------------------------------------

# cli.train flags of the presets phase 19 runs (cli.generate takes the
# first one's --mouse, the others' from their checkpoints): 609882's
# 500-gene panel at patch 64; 609889 with the 81-gene M2H panel
# (--to_hbr) at patch 128; and the remaining axes in one run, patch 32,
# one stain and 16 RNA slices (z 8, 6 z-windows of 48 slices)
PRESETS = {
    "609882_64_500_all_4": ["--mouse", "609882"],
    "609889_128_81_all_4": ["--mouse", "609889", "--patch", "128",
                            "--to_hbr"],
    "609889_32_81_DAPI_16": ["--mouse", "609889", "--patch", "32",
                             "--to_hbr", "--stain", "DAPI",
                             "--rna_slc", "16"]}
# presets whose K2 and K2b shapes phase 19 checks and times one by one,
# with no full-width run: 638850 at 8 RNA slices (12 z-windows), whose
# (B, 256, 256) take K2 / K2b wgmma (tensor_core_tiled until PRs 19 and
# 20), and patch 128 at
# cli.train's default batch of 32 (K2b at (512, 128, 512); phase 19's run
# takes batch 8 to fit the card)
PRESET_KERNELS_ONLY = {
    "638850_64_229_all_8": ["--rna_slc", "8"],
    "609889_128_81_all_4 batch 32": ["--mouse", "609889", "--patch", "128",
                                     "--to_hbr", "--batch", "32"]}
PRESET_CHAIN_STEPS = 5     # the 609882 bf16 chain: cut from 15 to keep
                           # the whole smoke inside its cap
PRESET_INT8_STEPS = 2      # the 609882 int8 chain
PRESET_TRAIN_STEPS = 2     # full-width training steps a preset (cut
                           # from 3)
PRESET_TIMED_FROM = 2      # samples/s over step 2
PRESET_GEN_STEPS = 2       # cli.generate from a preset's checkpoint
PRESET_SMALL_STEPS = 2     # the small f32 chains (DDIM steps)
# the patch-128 training's peak device memory: 8 microbatches of 8
# samples hold the pixels of a patch-64 microbatch of 32, whose one-process
# step peaked at 30.4-30.7 GiB (PR 15); batch 32 would need ~110 GiB
PRESET_PEAK_GIB = 40.0
# full-width training runs: (preset, cli.train flags beyond the preset's,
# cli.generate's flags beyond --ckpt_pth from its checkpoint, or None for
# no generation).  At 16 RNA slices (z 8) the packed layout's
# block-structured kernels hold 4.04 G parameters against the 5D model's
# 0.2 G (a minute and a half of host-side packing and loading on the
# card's machine, call 1 of PR 16), so that run generates with the 5D
# model; the packed generation shapes are checked one by one
PRESET_TRAIN = {
    "609882_64_500_all_4 5d": ("609882_64_500_all_4", ["--batch", "32"],
                               None),
    "609889_128_81_all_4 5d": ("609889_128_81_all_4", ["--batch", "8"],
                               []),
    "609889_32_81_DAPI_16 packed": ("609889_32_81_DAPI_16",
                                    ["--packed"], ["--no_packed"])}


def preset_conf(ks, flags: list):
    """``cli.train``'s ``TrainConfig`` for a preset's flags."""
    from tera_mind_tpu_torch.cli import train as train_cli
    a = train_cli.parse_args(flags)
    return ks.preset_conf(a.mouse, a.patch, a.to_hbr, a.stain, a.rna_slc,
                          a.batch)


def launches_now() -> dict:
    """Every kernel's launches and launches by variant since the last
    reset: {name: {"launches": n, "by_variant": {...}}}."""
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    out = {}
    for name, c in (("rmsnorm", k1), ("rmsnorm_bwd", k1.bwd),
                    ("window_attention", k2),
                    ("window_attention_bwd", k2.bwd),
                    ("grouped_rmsnorm", k5), ("grouped_rmsnorm_bwd", k5.bwd),
                    ("residual", k6), ("gated_residual", k7),
                    ("quant_conv", qk.k3), ("quantize", qk.k4)):
        by = dict(c.launches_by_variant)
        out[name] = {"launches": sum(by.values()), "by_variant": by}
    out["rmsnorm"]["by_epilogue"] = dict(k1.launches_by_epilogue)
    out["grouped_rmsnorm"]["by_epilogue"] = dict(k5.launches_by_epilogue)
    out["grouped_rmsnorm"]["by_prologue"] = dict(k5.launches_by_prologue)
    return out


def require_launches(got: dict, want: dict, what: str) -> None:
    """Each kernel's launches and launches by variant (and K5's by
    epilogue and prologue) as ``scripts/kernel_shapes.py`` predicts them
    (``want``; a kernel it does not name launches no time)."""
    for name, g in got.items():
        w = want.get(name, {k: ({v: 0 for v in g[k]} if k != "launches"
                                else 0) for k in g})
        keys = [k for k in ("launches", "by_variant", "by_epilogue",
                            "by_prologue") if k in g]
        require(all(g[k] == w[k] for k in keys),
                f"{what}: {name} launches {g}, kernel_shapes.py predicts "
                f"{ {k: w[k] for k in keys} }")


def require_no_cuda_core_attention(got: dict, what: str) -> None:
    """No K2 or K2b launch of a bf16 run took ``cuda_core``: since
    ``tensor_core_tiled`` every preset's attention shape has tensor
    cores."""
    for name in ("window_attention", "window_attention_bwd"):
        n = got[name]["by_variant"]["cuda_core"]
        require(n == 0, f"{what}: {n} {name} launches on cuda_core")


def preset_kernel_shapes(ks) -> dict:
    """{kernel: [(shape, path)]} of phase 19's full-width runs that
    phases 3-5 do not check (K1 in generation with the bf16 weight, in
    training with the float32 one; K5b each new layout of segments and Z
    once, K5 each new (segments, Z, epilogue, prologue), at its most rows,
    as (rows, segments, Z, epilogue, B, prologue); K6 each new (width,
    skip) at its most rows; "DiT" each new (rows, C) of K7, which K1's
    modulate takes too), and the K2, K2b, K5, K6 and DiT shapes of
    :data:`PRESET_KERNELS_ONLY`'s chains and training steps, from
    ``scripts/kernel_shapes.py``'s predictions, each shape once."""
    seen = {"K1": set(K1_SHAPES) | {s for k1s, _ in PATH_SHAPES.values()
                                    for s in k1s},
            "K1 train": set(TRAIN_K1_SHAPES), "K1b": set(TRAIN_K1_SHAPES),
            "K2": set(K2_SHAPES) | {s for _, k2s in PATH_SHAPES.values()
                                    for s in k2s},
            "K2b": set(TRAIN_K2_SHAPES), "K3": set(K3_SHAPES),
            "K4": set(K4_SHAPES),
            "K5": {s[1:4] + s[5:] for s in k5_shapes(acts=True)},
            "K5b": {s[1:] for s in k5_shapes(train=True)},
            "K6": {s[1:] for s in k6_shapes()},
            "DiT": set(dit_shapes())}
    out = {k: [] for k in seen}

    def add(kernel, pred, path):
        # K5 by its epilogue, with its launches' batches; K5 and K5b at
        # their most rows first
        shapes = [s for s, _ in pred["act_shapes" if kernel == "K5"
                                     else "shapes"]]
        if kernel in ("K5", "K5b", "K6"):
            shapes.sort(key=lambda s: -s[0])
        for shape in shapes:
            shape = tuple(tuple(x) if isinstance(x, list) else x
                          for x in shape)
            if kernel == "K4":
                shape = shape[:3]
            key = (shape[1:4] + shape[5:] if kernel == "K5" else
                   shape[1:] if kernel in ("K5b", "K6") else shape)
            if key not in seen[kernel]:
                seen[kernel].add(key)
                out[kernel].append((shape, path))

    first = preset_conf(ks, PRESETS["609882_64_500_all_4"])
    chain = ks.chain_prediction(first)
    add("K1", chain["rmsnorm"], "609882 chain")
    add("K2", chain["window_attention"], "609882 chain")
    add("K5", chain["grouped_rmsnorm"], "609882 chain")
    add("K6", chain["residual"], "609882 chain")
    add("DiT", chain["gated_residual"], "609882 chain")
    int8 = ks.chain_prediction(first, quant="int8")
    add("K3", int8["quant_conv"], "609882 int8")
    add("K4", int8["quantize"], "609882 int8")
    for run, (preset, flags, gen) in PRESET_TRAIN.items():
        conf = preset_conf(ks, PRESETS[preset] + flags)
        conf.packed_compute = "--packed" in flags
        train = ks.train_prediction(conf)
        for kernel, name in (("K1 train", "rmsnorm"), ("K1b", "rmsnorm_bwd"),
                             ("K2", "window_attention"),
                             ("K2b", "window_attention_bwd"),
                             ("K5b", "grouped_rmsnorm_bwd")):
            add(kernel, train[name], f"{run} training")
        if gen is not None:
            for packed in (True, "--no_packed" not in gen):
                chain = ks.chain_prediction(conf, probes=1, packed=packed)
                add("K1", chain["rmsnorm"], f"{preset} generation")
                add("K2", chain["window_attention"], f"{preset} generation")
                add("K5", chain["grouped_rmsnorm"], f"{preset} generation")
                add("K6", chain["residual"], f"{preset} generation")
                add("DiT", chain["gated_residual"], f"{preset} generation")
    for preset, flags in PRESET_KERNELS_ONLY.items():
        conf = preset_conf(ks, flags)
        chain = ks.chain_prediction(conf)
        add("K2", chain["window_attention"], f"{preset} chain")
        add("K5", chain["grouped_rmsnorm"], f"{preset} chain")
        add("K6", chain["residual"], f"{preset} chain")
        add("DiT", chain["gated_residual"], f"{preset} chain")
        add("K2b", ks.train_prediction(conf)["window_attention_bwd"],
            f"{preset} training")
    return out


def check_preset_kernels(device, ks) -> dict:
    """Every kernel at each shape of :func:`preset_kernel_shapes` by
    phases 3-5's per-shape checks and timings (every gate of theirs; the
    variant each shape's rule names required).  Returns {name: [row]}."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(19)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = preset_kernel_shapes(ks)
    log("phase 19 kernel shapes new to this run: " + "; ".join(
        f"{k} {[s for s, _ in v]}" for k, v in shapes.items()))
    return {
        "rmsnorm": [k1_row(g, device, n, c, path)
                    for (n, c), path in shapes["K1"]]
        + [k1_row(g, device, n, c, path, torch.float32)
           for (n, c), path in shapes["K1 train"]],
        "rmsnorm_bwd": [k1b_row(g, device, n, c, path)
                        for (n, c), path in shapes["K1b"]],
        "window_attention": [k2_row(g, device, b, n, d, path)
                             for (b, n, d), path in shapes["K2"]],
        "window_attention_bwd": [k2b_row(g, device, b, n, d, path)
                                 for (b, n, d), path in shapes["K2b"]],
        "quant_conv": [k3_row(g, device, x, w, sms, path)
                       for (x, w), path in shapes["K3"]],
        "quantize": [k4_row(g, device, r, c, m, path)
                     for (r, c, m), path in shapes["K4"]],
        **preset_grouped_rows(g, device, shapes),
        **preset_dit_rows(g, device, shapes)}


# rows of phase 19's K5 and K5b checks: their layouts are what is new (the
# variant and the kernels' walk depend on the segments and Z alone), and a
# grid-stride loop takes any row count
K5_PRESET_ROWS = 8192


def preset_k5_cut(n: int, act: str, batches: int) -> tuple:
    """(rows, batches) of a phase 19 K5 check of an (n, ..., act,
    batches) launch: at most ``K5_PRESET_ROWS`` rows, and with the
    modulate whole batches of the launch's rows a batch (one at least)."""
    if act != "modulate_silu":
        return min(n, K5_PRESET_ROWS), batches
    per = n // batches
    keep = min(batches, max(1, K5_PRESET_ROWS // per))
    return keep * per, keep


def preset_grouped_rows(g, device, shapes) -> dict:
    """K5 (with the prologue and epilogue of its launches), K5b and K6
    at each new layout of phase 19 (:func:`preset_kernel_shapes`), at up
    to ``K5_PRESET_ROWS`` rows (:func:`preset_k5_cut`), checked, not
    timed."""
    k5_rows = []
    for (n, segs, z, act, b, pro), path in shapes["K5"]:
        n, b = preset_k5_cut(n, act, b)
        k5_rows.append(k5_row(g, device, n, segs, z, path, timed=False,
                              act=act, batches=b, prologue=pro))
    return {"grouped_rmsnorm": k5_rows, "grouped_rmsnorm_bwd": [
        k5b_row(g, device, min(n, K5_PRESET_ROWS), segs, z, path,
                timed=False)
        for (n, segs, z), path in shapes["K5b"]],
        "residual": [k6_row(g, device, min(n, K5_PRESET_ROWS), width, skip,
                            path, timed=False)
                     for (n, width, skip), path in shapes["K6"]]}


def preset_dit_rows(g, device, shapes) -> dict:
    """K1's modulate and K7 at each new (rows, C) of phase 19
    (:func:`preset_kernel_shapes`), at all their rows, checked as
    ``dit_row`` checks them, not timed."""
    pairs = [dit_row(g, device, n, c, path, timed=False)
             for (n, c), path in shapes["DiT"]]
    return {"rmsnorm_modulate": [p[0] for p in pairs],
            "gated_residual": [p[1] for p in pairs]}


def check_small_presets(device, ks) -> dict:
    """For each preset of :data:`PRESETS`, its model at a small width
    (``net_ch`` 8, one ResBlock a level, f32, random weights, no zero
    init) in a 2x2-tile block-major chain of ``PRESET_SMALL_STEPS`` steps
    (tiles of one patch, the preset's RNA slices, stains and 500 genes
    carried): the 5D model on the card against the CPU and the packed
    model against the 5D one on the card, each within ``SMALL_ATOL``.
    Returns {preset: {check: max |d|}}."""
    import dataclasses

    import numpy as np
    import torch

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                       SamplerConfig)
    from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
    from tera_mind_tpu_torch.models.nn import channels_last_, init_weights
    from tera_mind_tpu_torch.models.unet_packed import (make_packed_model,
                                                        pack_unet_params)
    from tera_mind_tpu_torch.parallel.generator import (GeneratorConfig,
                                                        TeraGenerator)

    out = {}
    for preset, flags in PRESETS.items():
        t0 = time.perf_counter()
        conf = preset_conf(ks, flags)
        conf.net_ch, conf.embed_channels = 8, 32
        conf.net_num_res_blocks, conf.compute_dtype = 1, "float32"
        mconf = dataclasses.replace(conf.make_model_conf(),
                                    use_zero_module=False)
        p = conf.image_size
        gconf = GeneratorConfig(
            tile=p, patch=p, gn_blk=16, snum=conf.rna_slices,
            n_slices=4 if conf.rna_slices in (1, 4) else 50,
            stains=2 if conf.stain == "all" else 1, gdim=500,
            window_chunk=1)
        gene = np.random.default_rng(19).integers(
            0, 3, (2, 2, gconf.gsz, gconf.gsz, gconf.z_pad, gconf.gdim)
        ).astype(np.uint8)
        model5 = init_weights(mconf.make_model(), seed=19).eval()
        packed = load_jax_params(make_packed_model(mconf), pack_unet_params(
            export_params(model5), mconf)).eval()

        def chain(model, dev):
            if dev.type == "cuda":
                model = channels_last_(model.to(dev))
            sampler = DiffusionSampler(
                spaced_schedule("linear", 1000, f"ddim{PRESET_SMALL_STEPS}"),
                SamplerConfig(patch_size=p, gn_sz=conf.gn_sz))
            gen = TeraGenerator(sampler, lambda xp, tm, rp, p1, p2: model(
                xp, tm, rp, p1, p2, decode_original=False), gconf,
                device=dev)
            res = gen.run(gene, row0=1, col0=1, grid_w=16, progress=False,
                          block_major=True)
            require(res.shape == (2 * p, 2 * p, gconf.channels)
                    and bool(np.isfinite(res).all()),
                    f"small {preset} chain output {res.shape} not finite "
                    "or misshapen")
            return res
        cpu = chain(model5, torch.device("cpu"))
        card = chain(model5, device)
        card_packed = chain(packed, device)
        errs = {"5d card vs CPU": float(np.abs(card - cpu).max()),
                "packed vs 5d on the card": float(np.abs(card_packed
                                                         - card).max())}
        for name, err in errs.items():
            require(err <= SMALL_ATOL, f"small {preset} chain {name}: {err}"
                    f" > {SMALL_ATOL}")
        log(f"phase 19 small f32 chain {preset} (2x2 tiles of {p} px, "
            f"{gconf.n_win} z-windows, {gconf.channels} channels, "
            f"{PRESET_SMALL_STEPS} steps): " + ", ".join(
                f"{k} max_abs_err {v:.3g}" for k, v in errs.items())
            + f" (tol {SMALL_ATOL}); {time.perf_counter() - t0:.1f} s")
        out[preset] = errs
    return out


def run_preset_chain(device, ks, quant: str, steps: int) -> dict:
    """``cli.generate.build --mouse 609882`` (500 genes) over 2x2 tiles,
    the packed bf16 model or ``--quant``: one warm-up step that plans,
    then ``steps`` steps with the counters set to 0 just before; launches
    by kernel and variant as kernel_shapes.py predicts them."""
    import torch

    from tera_mind_tpu_torch.cli import generate

    args = generate.parse_args(
        ["--synthetic", "--hnm", str(GRID), "--wnm", str(GRID),
         "--tot_epoch", str(steps), "--device", str(device)]
        + PRESETS["609882_64_500_all_4"][:2]
        + (["--quant", quant] if quant else []))
    t0 = time.perf_counter()
    gen, model, gene, (row0, col0) = generate.build(args)
    build_s = time.perf_counter() - t0
    conf = generate.run_config(args)
    plan = ks.gen_plan(conf)
    state0 = torch.as_tensor(gen.init_state(GRID, GRID, row0=row0,
                                            col0=col0), device=device)
    gene_t = torch.as_tensor(gene, device=device)
    gen.compile_step(GRID, GRID, block_major=True)(state0, gene_t,
                                                   steps - 1)
    torch.cuda.synchronize()
    want_strip = 0 if plan["visits"] == 1 else GRID // plan["visits"]
    require((gen.conf.strip_rows, gen.conf.window_chunk)
            == (want_strip, plan["chunk"]),
            f"planned {gen.conf.strip_rows}, {gen.conf.window_chunk}; "
            f"kernel_shapes.py plans {plan}")
    del state0, gene_t
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = gen.run(gene, row0=row0, col0=col0, grid_w=416, block_major=True,
                  progress=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launches_now()
    want = ks.chain_prediction(conf, quant, steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = GRID * GRID * steps / STEPS / secs
    path = f"609882 {quant or 'bf16'} chain"
    log(f"phase 19 {path}: {conf.name}, {GRID}x{GRID} tiles x {steps} "
        f"steps in {secs:.2f} s = {rate:.5f} tiles/s (a tile {STEPS} "
        f"steps); peak device memory {peak:.2f} GiB; built in "
        f"{build_s:.1f} s; launches " + ", ".join(
            f"{k} {v['launches']} {v['by_variant']}" for k, v in got.items()
            if v["launches"]))
    require_output(out, (GRID * 256, GRID * 256, gen.conf.channels))
    require_launches(got, want, path)
    del gen, model
    torch.cuda.empty_cache()
    return dict(seconds=secs, tiles_per_s=rate, peak_gib=peak,
                build_s=build_s, launches=got, steps=steps)


def run_preset_training(device, ks, run: str, tmp: Path) -> dict:
    """``cli.train``'s builder on a preset at full width with
    ``--synthetic``, ``PRESET_TRAIN_STEPS`` steps with the counters set to
    0 just before ``fit``: finite losses, launches by kernel and variant
    as kernel_shapes.py predicts them, samples/s and peak memory; then,
    where :data:`PRESET_TRAIN` says so, ``cli.generate --ckpt_pth`` from
    its checkpoint over 2x2 tiles for ``PRESET_GEN_STEPS`` steps (the
    counters set to 0 just before; the planner's one probe call
    counted)."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.cli import generate
    from tera_mind_tpu_torch.cli import train as train_cli

    preset, flags, gen = PRESET_TRAIN[run]
    steps = PRESET_TRAIN_STEPS
    args = train_cli.parse_args(
        ["--synthetic", "--max_steps", str(steps), "--device", str(device)]
        + PRESETS[preset] + flags)
    t0 = time.perf_counter()
    conf, ds, trainer, _ = train_cli.build(args)
    conf.base_dir = str(tmp / run.replace(" ", "_"))
    require(conf.name.startswith(preset), f"preset {conf.name}, not "
            f"{preset}")
    state = trainer.init_state()
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(train_cli.epoch_batches(
        ds, conf.batch_size_effective), max_steps=steps, state=state,
        log_every=1, metrics=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launches_now()
    want = ks.train_prediction(conf, steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = trainer.log[PRESET_TIMED_FROM - 1:]
    data_s = sum(r["data_s"] for r in timed)
    step_s = sum(r["step_s"] for r in timed)
    rate = conf.batch_size_effective * len(timed) / (data_s + step_s)
    losses = [r["loss"] for r in trainer.log]
    log(f"phase 19 training {run}: {conf.name}, {conf.accum_batches} "
        f"microbatches of {conf.batch_size} samples, built in "
        f"{build_s:.1f} s; {steps} steps in {secs:.2f} s; steps "
        f"{PRESET_TIMED_FROM}-{steps}: {rate:.2f} samples/s, "
        f"{step_s / len(timed):.3f} s a step on the device, data wait "
        f"{100 * data_s / (data_s + step_s):.1f} %; losses "
        f"{[round(v, 4) for v in losses]}; peak device memory {peak:.2f} "
        "GiB; launches " + ", ".join(
            f"{k} {v['launches']} {v['by_variant']}" for k, v in got.items()
            if v["launches"]))
    require(all(np.isfinite(losses)) and len(losses) == steps,
            f"{run} training losses {losses}")
    require_launches(got, want, f"{run} training")
    require_no_cuda_core_attention(got, f"{run} training")
    if conf.image_size == 128:
        require(peak < PRESET_PEAK_GIB, f"{run}: peak {peak:.2f} GiB, not "
                f"under {PRESET_PEAK_GIB}")
    out = dict(samples_per_s=rate, step_s=step_s / len(timed),
               data_wait_pct=100 * data_s / (data_s + step_s),
               seconds=secs, peak_gib=peak, launches=got, losses=losses,
               name=conf.name)
    if gen is None:
        del trainer, state
        torch.cuda.empty_cache()
        return out
    trainer.save(state)
    ckpt = Path(conf.logdir) / "ckpt"
    del trainer, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = generate.main(["--ckpt_pth", str(ckpt), "--hnm", str(GRID),
                         "--wnm", str(GRID), "--tot_epoch",
                         str(PRESET_GEN_STEPS), "--synthetic", "--device",
                         str(device), "--out_dir",
                         str(tmp / f"gen_{run.replace(' ', '_')}")] + gen)
    torch.cuda.synchronize()
    gsecs = time.perf_counter() - t0
    ggot = launches_now()
    gwant = ks.chain_prediction(conf, steps=PRESET_GEN_STEPS, probes=1,
                                packed="--no_packed" not in gen)
    gpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    channels = (2 if conf.stain == "all" else 1) * ks.gen_config(conf).z_use
    grate = GRID * GRID * PRESET_GEN_STEPS / STEPS / gsecs
    log(f"phase 19 cli.generate {' '.join(gen)} from the {run} checkpoint:"
        f" {GRID}x{GRID} "
        f"tiles x {PRESET_GEN_STEPS} steps in {gsecs:.2f} s (build and "
        f"plan included) = {grate:.5f} tiles/s (a tile {STEPS} steps); "
        f"peak device memory {gpeak:.2f} GiB; launches " + ", ".join(
            f"{k} {v['launches']} {v['by_variant']}"
            for k, v in ggot.items() if v["launches"]))
    require_output(res, (GRID * 256, GRID * 256, channels))
    require_launches(ggot, gwant, f"cli.generate from {run}")
    require_no_cuda_core_attention(ggot, f"cli.generate from {run}")
    out.update(generate_s=gsecs, generate_tiles_per_s=grate,
               generate_peak_gib=gpeak, generate_launches=ggot)
    return out


def run_presets(device) -> dict:
    """Phase 19: the presets' new kernel shapes, their small f32 chains,
    then at full width the 609882 bf16 chain (15 steps) and int8 chain
    (2 steps) and the training runs of :data:`PRESET_TRAIN` (two with
    generation from their checkpoints)."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    ks = kernel_shapes()
    res = {"kernels": check_preset_kernels(device, ks)}
    res["kernel_seconds"] = time.perf_counter() - t0
    res["small"] = check_small_presets(device, ks)
    res["chains"] = {"609882 bf16": run_preset_chain(device, ks, "",
                                                     PRESET_CHAIN_STEPS),
                     "609882 int8": run_preset_chain(device, ks, "int8",
                                                     PRESET_INT8_STEPS)}
    with tempfile.TemporaryDirectory() as tmp:
        res["train"] = {}
        for run in PRESET_TRAIN:
            res["train"][run] = run_preset_training(device, ks, run,
                                                    Path(tmp))
            torch.cuda.empty_cache()
    res["launches_by_path"] = {
        **{f"preset {k}": c["launches"] for k, c in res["chains"].items()},
        **{f"preset {k} training": t["launches"]
           for k, t in res["train"].items()},
        **{f"preset {PRESET_TRAIN[k][0]} generation "
           + ("5d" if "--no_packed" in PRESET_TRAIN[k][2] else "packed"):
           t["generate_launches"]
           for k, t in res["train"].items() if "generate_launches" in t}}
    res["phase_seconds"] = time.perf_counter() - t0
    log(f"phase 19 seconds: {res['phase_seconds']:.1f} (kernels "
        f"{res['kernel_seconds']:.1f})")
    return res


def preset_entries(kernels: list, presets: dict) -> None:
    """Phase 19's launches by path and its per-shape rows in each
    kernel's entry of the kernel line."""
    for k in kernels:
        name = k["name"]
        k.setdefault("launches_by_path", {}).update(
            {path: got[name] if name != "rmsnorm_modulate" else
             {"launches": got["rmsnorm"]["by_epilogue"]["modulate"]}
             for path, got in presets["launches_by_path"].items()})
        k["preset_shapes"] = presets["kernels"][name]
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["max_abs_err"] for r in presets["kernels"][name]])


def compare_int8(chains: dict, outs: dict) -> dict:
    """The full-width int8 chain (and int8_static where it runs as many
    steps) against the bf16 packed chain of the same run: tiles/s and
    the output statistics (informative)."""
    int8_vs_bf16 = {}
    for path in (p for p in ("int8", "int8_static")
                 if CHAIN_STEPS[p] == CHAIN_STEPS["packed"]):
        int8_vs_bf16[path] = st = chain_gate_stats(outs["packed"],
                                                   outs[path])
        log(f"full-width {path} chain: {chains[path]['tiles_per_s']:.5f} "
            f"tiles/s against the bf16 packed chain's "
            f"{chains['packed']['tiles_per_s']:.5f} in this run (build "
            f"{chains[path]['build_s']:.1f} s, calibration included); "
            f"output against bf16: mean |d| {st['mean']:.4g}, max "
            f"{st['max']:.4g}, corr {st['corr']:.5f}, mean shift "
            f"{st['mean_shift']:.4g}, std shift {st['std_rel']:.4g} "
            "(informative)")
    return int8_vs_bf16


def quant_kernel_entries(rows: dict, chains: dict) -> list:
    """K3's and K4's entries of the kernel line: the largest shape's
    times, every shape's rows, the main path's launches by variant."""
    quant_sources = {
        "quant_conv": ("tera_mind_tpu_torch/csrc/quant_conv_wgmma.cu",
                       "tera_mind_tpu/ops/quant.py:58 (quant_conv2d; "
                       "not a Pallas kernel)"),
        "quantize": ("tera_mind_tpu_torch/csrc/quantize.cu",
                     "tera_mind_tpu/ops/quant.py:41 (quantize_tensor and "
                     "the a_scale branch :84-87; not a Pallas kernel)")}
    kernels = []
    for name, (src, replaces) in quant_sources.items():
        r = max(rows[name], key=lambda x: x["bound_ms"])  # the largest
        by_path = {path: chains[path]["quant_launches"]
                   for path in ("int8", "int8_static")}
        main_q = by_path["int8"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(main_q[name].values()),
            "launches_by_variant": main_q[name],
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "shapes": rows[name],
            **({"variant_ms": r["variant_ms"],
                "bf16_conv_ms": r["bf16_conv_ms"],
                "bf16_conv": "cuDNN bf16 conv2d of the same shape: not the "
                             "same function, the path int8 has to beat",
                "step_ms": step_sums(rows[name])}
               if name == "quant_conv" else
               {"step_ms": step_sums(rows[name])})})
        log(f"{name} a 2x2 step (ms): {kernels[-1]['step_ms']}")
    return kernels


GROUPED_SOURCES = {
    "grouped_rmsnorm": (
        "tera_mind_tpu_torch/csrc/grouped_rmsnorm.cu",
        "tera_mind_tpu/models/unet_packed.py:73 (GroupedRMSNorm.__call__, "
        "XLA's fusion of :85-108; not a Pallas kernel)"),
    "grouped_rmsnorm_bwd": (
        "tera_mind_tpu_torch/csrc/grouped_rmsnorm_bwd.cu",
        "tera_mind_tpu/models/unet_packed.py:73 (jax.grad of "
        "GroupedRMSNorm.__call__; not a Pallas kernel)"),
    "residual": (
        "tera_mind_tpu_torch/csrc/residual.cu",
        "tera_mind_tpu/models/unet_packed.py:299 (PackedResBlock's "
        "(x + h).astype(dt) with the conv biases of :132-133 and :226: "
        "XLA's fusion; not a Pallas kernel)")}


def grouped_step_sums(rows: list, name: str) -> dict:
    """A block-major 2x2 step's (25 UNet calls) device ms of K5 (each
    shape with its prologue and epilogue) or K6 (``name`` "residual"), or
    a packed training step's (2 microbatches) of K5b: each shape's time
    times its launches (``scripts/kernel_shapes.py``)."""
    from collections import Counter
    k5, k5_act, k6 = Counter(), Counter(), Counter()
    ks = kernel_shapes()
    train = name.endswith("_bwd")
    if train:
        ks.train_shapes(True, k5=k5)
        n = {(r, tuple(s), z): c * ks.TRAIN_ACCUM
             for (r, s, z), c in k5.items()}
    else:
        ks.per_call_shapes(k5=k5, k5_act=k5_act, k6=k6)
        n = Counter({shape: c * 25 for shape, c in k6.items()})
        for (r, s, z, a, _, p), c in k5_act.items():
            n[(r, tuple(s), z, a, p)] += c * 25

    def key(r):
        if name == "residual":
            return tuple(r["shape"])
        return ((r["shape"][0], tuple(r["shape"][1]), r["shape"][2])
                + (() if train else (r["act"], r["prologue"])))
    keyed = [(n[key(r)], r) for r in rows
             if r["path"] in ("block_major", "train")]
    out = {key: sum(c * r[key] for c, r in keyed)
           for key in ("ms", "plain_ms", "bound_ms")}
    out["launches"] = sum(c for c, _ in keyed)
    return out


def grouped_kernel_entries(rows: dict, chains: dict, train: dict) -> list:
    """K5's, K5b's and K6's entries of the kernel line: the largest
    shape's times, every shape's rows, a step's sums, the launches of
    every path (K5, K6: the chains, with K5's by epilogue and prologue;
    K5b: the packed training run's)."""
    kernels = []
    for name, (src, replaces) in GROUPED_SOURCES.items():
        r = max(rows[name], key=lambda x: x["bound_ms"])   # the largest
        bwd = name.endswith("_bwd")
        if bwd:
            by_path = {"train_packed": {
                "launches": train["packed"]["launches"][name],
                "by_variant": train["packed"]["launches_by_variant"][name]}}
        else:
            by_path = {path: {"launches": c["launches"][name],
                              "by_variant": c["variants"][name],
                              **({} if name == "residual" else {
                                  "by_epilogue": c["variants"][
                                      "grouped_rmsnorm_epilogue"],
                                  "by_prologue": c["variants"][
                                      "grouped_rmsnorm_prologue"]})}
                       for path, c in chains.items()}
        main = by_path["train_packed" if bwd else "packed"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main["launches"],
            "launches_by_variant": main["by_variant"],
            **({"launches_by_epilogue": main["by_epilogue"],
                "launches_by_prologue": main["by_prologue"]}
               if "by_epilogue" in main else {}),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "step_ms": grouped_step_sums(rows[name], name),
            "shapes": rows[name]})
        log(f"{name} a {'packed training' if bwd else 'block-major 2x2'} "
            f"step (ms): {kernels[-1]['step_ms']}")
    return kernels


DIT_SOURCES = {
    "rmsnorm_modulate": (
        "tera_mind_tpu_torch/csrc/rmsnorm.cu",
        "tera_mind_tpu/models/nn.py:127 (modulate after the DiT block's "
        "norms, XLA's fusion of :127-130 after rmsnorm_fused; not a Pallas "
        "kernel: K1's epilogue)"),
    "gated_residual": (
        "tera_mind_tpu_torch/csrc/gated_residual.cu",
        "tera_mind_tpu/models/attention.py:196 (DiTBlock's xt + gate * "
        "attn(...) and xt + gate * mlp(...), :196-202: XLA's fusion; not a "
        "Pallas kernel)")}


def dit_step_sums(rows: list) -> dict:
    """A block-major 2x2 step's (25 UNet calls) device ms of K1 with the
    modulate or of K7: each main-path shape's time times its launches
    (``scripts/kernel_shapes.py``; the two take the same shapes, as
    often)."""
    from collections import Counter
    k7 = Counter()
    kernel_shapes().per_call_shapes(k7=k7)
    keyed = [(k7[tuple(r["shape"])] * 25, r) for r in rows
             if r["path"] == "block_major"]
    out = {key: sum(c * r[key] for c, r in keyed)
           for key in ("ms", "plain_ms", "bound_ms") + (
               ("eager_ms",) if "eager_ms" in rows[0] else
               ("library_ms",))}
    out["launches"] = sum(c for c, _ in keyed)
    return out


def dit_kernel_entries(rows: dict, chains: dict) -> list:
    """K1's modulate (its epilogue's launches; K1's entry counts them
    too) and K7's entries of the kernel line: the largest shape's times,
    every shape's rows, a step's sums, the launches of every path."""
    kernels = []
    for name, (src, replaces) in DIT_SOURCES.items():
        r = max(rows[name], key=lambda x: x["bound_ms"])   # the largest
        if name == "gated_residual":
            by_path = {path: {"launches": c["launches"][name],
                              "by_variant": c["variants"][name]}
                       for path, c in chains.items()}
        else:
            by_path = {path: {"launches": c["variants"]["rmsnorm_epilogue"][
                "modulate"], "by_epilogue": c["variants"]["rmsnorm_epilogue"]}
                for path, c in chains.items()}
        main = by_path["packed"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main["launches"],
            **({"launches_by_variant": main["by_variant"]}
               if "by_variant" in main else
               {"launches_by_epilogue": main["by_epilogue"]}),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "step_ms": dit_step_sums(rows[name]), "shapes": rows[name]})
        log(f"{name} a block-major 2x2 step (ms): {kernels[-1]['step_ms']}")
    return kernels


def step_sums(rows: list) -> dict:
    """A 2x2 step's device ms of K3 (by variant, plain, cuDNN bf16,
    bound) or K4 (dynamic, static, bound): each shape's time times its
    launches a step (scripts/kernel_shapes.py --quant int8, 25 UNet calls
    a step)."""
    k3, k4, _ = kernel_shapes().quant_shapes("int8")
    calls = 25
    if "variant_ms" in rows[0]:
        n = {(tuple(x), tuple(w)): c for (x, w), c in k3.items()}
        keyed = [(n[tuple(r["shape"][0]), tuple(r["shape"][1])], r)
                 for r in rows]
        out = {v: sum(c * r["variant_ms"][v] for c, r in keyed) * calls
               for v in rows[0]["variant_ms"]}
        for key in ("plain_ms", "bf16_conv_ms", "bound_ms"):
            out[key] = sum(c * r[key] for c, r in keyed) * calls
        return out
    n = {(r_, c_, m_): c for (r_, c_, m_, _), c in k4.items()}
    keyed = [(n[tuple(r["shape"])], r) for r in rows]
    return {key: sum(c * r[key] for c, r in keyed) * calls
            for key in ("ms", "static_ms", "plain_ms", "bound_ms")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    # the port must be beside this script (fails alone, before any output)
    from tera_mind_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" capability {cap}")
    require(cap == (9, 0), f"needs a Hopper card (sm_90), found {cap}")
    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds or 0:.1f} s) -> {path.name}")
    for line in _build.ptxas_report(_build.build_log):
        log(f"ptxas: {line}")
    if sys.argv[1:] == ["--ranks"]:
        return ranks_only(device, smi)
    if sys.argv[1:] == ["--int8"]:
        return int8_only(device, smi)
    if sys.argv[1:] == ["--dp"]:
        return dp_only(device, smi)
    if sys.argv[1:] == ["--presets"]:
        return presets_only(device, smi)
    if sys.argv[1:] == ["--attention"]:
        return attention_only(device, smi)
    if sys.argv[1:] == ["--norms"]:
        return norms_only(device, smi)
    if sys.argv[1:] == ["--grouped"]:
        return grouped_only(device, smi)
    if sys.argv[1:] == ["--dit"]:
        return dit_only(device, smi)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (only "
              "--ranks, --int8, --dp, --presets, --attention, --norms, "
              "--grouped or --dit)", file=sys.stderr, flush=True)
        return 2

    rows = check_kernels(device)
    rows.update(check_grouped_kernels(device))
    rows.update(check_residual_kernels(device))
    rows.update(check_dit_kernels(device))
    rows.update(check_backward_kernels(device))
    rows.update(check_grouped_bwd(device))
    check_variant_refusal(device)
    check_autograd_guard(device)
    rows.update(check_int8_kernels(device))
    small_int8 = check_small_int8(device)
    small = check_small_chain(device)
    for name, err in small["errs"].items():
        log(f"small chain {name}: max_abs_err {err:.3g} (tol {SMALL_ATOL})")
    err = check_resume(device, small["packed"], small["out"])
    log(f"resume from the epoch-1 float16 spill vs uninterrupted: "
        f"max_abs_err {err:.3g} (tol {RESUME_ATOL})")
    small_stream = check_small_streaming(device, small["packed"])
    for name, err in small_stream.items():
        log(f"small {name}: max_abs_err {err:.3g}")
    chains, plans = {}, None
    for path in ("packed", "int8", "int8_static", "5d", "tile_major"):
        chains[path] = run_main_path(device, path)
        gen = chains[path].pop("gen")
        if path == "tile_major":
            plans = check_planner(gen)
        del gen
        torch.cuda.empty_cache()
    outs = {p: c.pop("out") for p, c in chains.items()}
    packed_out = outs["packed"]     # phase 17's reference
    int8_vs_bf16 = compare_int8(chains, outs)
    eval_outs = {p: outs[p] for p in ("packed", "int8")}
    del outs
    chains["stream"] = run_stream_path(device, chains["packed"]["counts"])
    chains["stream"].pop("out")
    stream_ref = chains["stream"].pop("out2")
    main_path = chains["packed"]

    small_train = check_small_train_step(device)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        train = {path: run_training(device, path, Path(tmp))
                 for path in ("5d", "packed")}
        ckpts = {path: t.pop("ckpt") for path, t in train.items()}
        phase_s = {}
        t0 = time.perf_counter()
        attn = run_attn(device, ckpts["5d"], Path(tmp))
        phase_s["attn"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        evaluate = run_evaluate(device, eval_outs, Path(tmp),
                                int8_vs_bf16["int8"])
        phase_s["evaluate"] = time.perf_counter() - t0
        del eval_outs
        t0 = time.perf_counter()
        baselines = {"small": {m: check_small_baseline(device, m)
                               for m in BASELINES}}
        for m in BASELINES:
            train[m] = run_training(device, m, Path(tmp), BASELINE_STEPS)
            ckpts[m] = train[m].pop("ckpt")
            torch.cuda.empty_cache()
        check_baseline_refusals(device, ckpts)
        phase_s["baselines"] = time.perf_counter() - t0
        log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phase_s.items()))
    for name, out in (("attn", attn), ("evaluate", evaluate),
                      ("baselines", baselines)):
        out["phase_seconds"] = phase_s[name]
    ranks = run_ranks(device, packed_out, stream_ref,
                      chains["packed"]["counts"])
    del packed_out, stream_ref
    dp = run_dp(device)
    presets = run_presets(device)

    sources = {"rmsnorm": ("tera_mind_tpu_torch/csrc/rmsnorm.cu",
                           "tera_mind_tpu/ops/rmsnorm_kernel.py:60"),
               "window_attention": (
                   "tera_mind_tpu_torch/csrc/attention_wgmma.cu",
                   "tera_mind_tpu/ops/attention_kernel.py:62")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name][0]   # the largest shape the kernel gets
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_path["launches"][name],
                        "launches_by_variant": main_path["variants"][name],
                        "launches_by_path": {
                            **{path: {"launches": c["launches"][name],
                                      "by_variant": c["variants"][name]}
                               for path, c in chains.items()},
                            "attn": {"launches": attn["launches"][name],
                                     "by_variant": attn["variants"][name]},
                            **{f"ranks_{kind}": [
                                {"launches": rk["launches"][name],
                                 "by_variant": rk["variants"][name]}
                                for rk in ranks[kind]["ranks"]]
                               for kind in ("memory", "stream")},
                            "dp_train_ranks": [
                                rk["launches"][name]
                                for rk in dp["full"]["ranks"]]},
                        "dp_shapes": dp["kernels"][name],
                        "max_abs_err": max(x["max_abs_err"]
                                           for x in rows[name]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "shapes": rows[name]})
    bwd_sources = {
        "rmsnorm_bwd": ("rmsnorm", "tera_mind_tpu_torch/csrc/rmsnorm_bwd.cu",
                        "tera_mind_tpu/ops/rmsnorm_kernel.py:91"),
        "window_attention_bwd": (
            "window_attention",
            "tera_mind_tpu_torch/csrc/attention_bwd_wgmma.cu",
            "tera_mind_tpu/ops/attention_kernel.py:81")}
    for name, (fwd, src, replaces) in bwd_sources.items():
        r = max(rows[name], key=lambda x: x["bound_ms"])  # the largest
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": train["5d"]["launches"][name],
                        "launches_by_variant":
                            train["5d"]["launches_by_variant"][name],
                        "launches_per_step": {
                            path: t["launches_per_step"][fwd]
                            for path, t in train.items()},
                        "launches_per_step_by_variant": {
                            path: TRAIN_BWD_VARIANTS[path][name]
                            for path in train},
                        "dp_train_ranks": [rk["launches"][name]
                                           for rk in dp["full"]["ranks"]],
                        "dp_shapes": dp["kernels"][name],
                        "max_abs_err": max(x["max_abs_err"]
                                           for x in rows[name]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "shapes": rows[name]})
    kernels += quant_kernel_entries(rows, chains)
    kernels += grouped_kernel_entries(rows, chains, train)
    kernels += dit_kernel_entries(rows, chains)
    preset_entries(kernels, presets)
    print(json.dumps({"kernels": kernels, "train": train,
                      "small_train": small_train, "chain_seconds":
                      main_path["seconds"], "tiles_per_s":
                      main_path["tiles_per_s"],
                      "chains": {p: {k: c[k] for k in (
                          "seconds", "tiles_per_s", "peak_gib", "build_s",
                          "quant_launches",
                          "host_rss_gib", "host_rss_before_gib",
                          "window_chunk", "timing")
                          if k in c}
                          for p, c in chains.items()},
                      "planner": plans, "small_stream": small_stream,
                      "small_int8": small_int8,
                      "int8_vs_bf16": int8_vs_bf16, "attn": attn,
                      "evaluate": evaluate, "baselines": baselines,
                      "ranks": ranks, "dp": dp,
                      "presets": {k: v for k, v in presets.items()
                                  if k != "kernels"}}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def int8_only(device, smi: str) -> int:
    """``--int8``: phase 5 (K3 in both variants and K4 against their plain
    versions at every shape, timed; the refusals; the small int8 chains)
    and phase 9's int8 and int8_static chains with the bf16 packed chain
    they are compared with, for a call that tunes the int8 kernels;
    prints its JSON, the card line and a result line naming the part it
    ran."""
    import torch
    rows = check_int8_kernels(device)
    small_int8 = check_small_int8(device)
    chains = {}
    for path in ("packed", "int8", "int8_static"):
        chains[path] = run_main_path(device, path)
        chains[path].pop("gen")
        torch.cuda.empty_cache()
    outs = {p: c.pop("out") for p, c in chains.items()}
    int8_vs_bf16 = compare_int8(chains, outs)
    kernels = quant_kernel_entries(rows, chains)
    print(json.dumps({"kernels": kernels, "small_int8": small_int8,
                      "int8_vs_bf16": int8_vs_bf16, "chains": {
                          p: {k: c[k] for k in (
                              "seconds", "tiles_per_s", "peak_gib",
                              "build_s", "quant_launches")}
                          for p, c in chains.items()}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "phase 5 and phase 9's int8 "
                      "chains", "device": {
                          "platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def ranks_only(device, smi: str) -> int:
    """``--ranks``: phases 17 and 18 alone, with the two runs phase 17 is
    held against (phase 9's packed chain, the 2-step one-process stream),
    for a call on a machine of several cards; prints its JSON, the card
    line and a result line naming the part it ran."""
    import torch
    chain = run_main_path(device, "packed")
    chain.pop("gen")
    torch.cuda.empty_cache()
    _, stream_ref = stream_timing_run(device)
    ranks = run_ranks(device, chain.pop("out"), stream_ref, chain["counts"])
    dp = run_dp(device)
    print(json.dumps({"ranks": ranks, "dp": dp, "chain": {
        k: chain[k] for k in ("seconds", "tiles_per_s", "peak_gib")}}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "phases 17 and 18", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def presets_only(device, smi: str) -> int:
    """``--presets``: phase 19 alone (the other published presets), for a
    call that checks it; prints its JSON, the card line and a result line
    naming the part it ran."""
    import torch
    presets = run_presets(device)
    print(json.dumps({"presets": presets}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "phase 19", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds of one ``fn()`` call: ``calls`` calls enqueued
    back to back (far fewer than the launch queue holds, so the host
    never waits on the device), then a synchronise outside the clock."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def k2_host_costs(device) -> dict:
    """The host's cost of a K2 call at the main path's shapes, the rule's
    variant (``wgmma``, which encodes three TMA tensor maps a call) beside
    the variant it replaced: {shape: {variant: us}}."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    g = torch.Generator(device="cpu").manual_seed(5)
    out = {}
    for b, n, d in K2_SHAPES:
        q, k, v = k2_inputs(g, b, n, d, torch.bfloat16, device, False)
        want = k2.attention_variant(n, d, torch.bfloat16, True)
        costs = {v_: host_us(lambda: k2.attention_cuda(
            q, k, v, 1.0 / d, variant=v_))
            for v_ in (want, replaced_by(k2, want, n, d)) if v_}
        log(f"K2 ({b}, {n}, {d}) host cost a call: " + ", ".join(
            f"{v_} {us:.1f} us" for v_, us in costs.items()))
        out[f"{b}x{n}x{d}"] = costs
    return out


def attention_only(device, smi: str) -> int:
    """``--attention``: K2 at phase 3's shapes and edge shapes, K2b at
    phase 4's and at a data-parallel rank's (phase 18's over 2 ranks), the
    entry points' refusals, and K2 and K2b at phase 19's
    shapes, each row also timed in the variant its shape took before
    (``FORCED_TIMINGS``: ``wgmma`` rows beside the forced ``tensor_core``
    or ``tensor_core_tiled``, ``tensor_core_tiled`` rows beside
    ``cuda_core``), and K2's host cost a call, for a call that tunes the
    attention kernels; prints its JSON, the card line and a result line
    naming the part it ran."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    global FORCED_TIMINGS
    FORCED_TIMINGS = True
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = {"window_attention": [k2_row(g, device, b, n, d, "block_major")
                                 for b, n, d in K2_SHAPES + K2_EDGE]}
    for path, (_, k2_shapes) in PATH_SHAPES.items():
        rows["window_attention"] += [k2_row(g, device, b, n, d, path)
                                     for b, n, d in k2_shapes]
    gen = torch.Generator(device="cpu").manual_seed(2)
    rows["window_attention_bwd"] = [k2b_row(gen, device, b, n, d, "train")
                                    for b, n, d in TRAIN_K2_SHAPES + K2B_EDGE]
    rows["window_attention_bwd"] += [k2b_row(gen, device, b, n, d,
                                             "dp rank train")
                                     for b, n, d in train_rank_shapes(2)[1]]
    check_variant_refusal(device)
    shapes = preset_kernel_shapes(kernel_shapes())
    g = torch.Generator(device="cpu").manual_seed(19)
    seen = {tuple(r["shape"]) for r in rows["window_attention"]}
    rows["window_attention"] += [
        k2_row(g, device, b, n, d, "train")
        for b, n, d in TRAIN_K2_SHAPES
        if (b, n, d) not in seen | {s for s, _ in shapes["K2"]}]
    rows["window_attention"] += [k2_row(g, device, b, n, d, path)
                                 for (b, n, d), path in shapes["K2"]]
    rows["window_attention_bwd"] += [k2b_row(g, device, b, n, d, path)
                                     for (b, n, d), path in shapes["K2b"]]
    host = k2_host_costs(device)
    print(json.dumps({"shapes": rows, "host_us": host,
                      "launches_by_variant": {
        "window_attention": dict(k2.launches_by_variant),
        "window_attention_bwd": dict(k2.bwd.launches_by_variant)}}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "K2 and K2b", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def norms_only(device, smi: str) -> int:
    """``--norms``: K1 at phase 3's shapes and edge shapes, K1b at phase
    4's, K1 at phase 4's strided shapes with the float32 weight that
    training passes, the entry points' refusals, K1 and K1b at phase 19's
    shapes, and K1 ``vector`` with the float32 weight at
    ``K1_F32_WEIGHT_SMALL`` beside ``F.rms_norm``, for a call that tunes
    the norm kernels; prints its JSON, the card line and a result line
    naming the part it ran."""
    import torch

    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = {"rmsnorm": [k1_row(g, device, n, c, "block_major")
                        for n, c in K1_SHAPES]}
    check_k1_edges(g, device)
    for path, (k1_shapes, _) in PATH_SHAPES.items():
        rows["rmsnorm"] += [k1_row(g, device, n, c, path)
                            for n, c in k1_shapes]
    gen = torch.Generator(device="cpu").manual_seed(2)
    rows["rmsnorm_bwd"] = [k1b_row(gen, device, n, c, "train")
                           for n, c in TRAIN_K1_SHAPES]
    check_k1b_edges(gen, device)
    rows["rmsnorm"] += [
        k1_row(gen, device, n, c, "train", torch.float32)
        for n, c in TRAIN_K1_SHAPES
        if k1.rmsnorm_variant(c, 2, True) == "strided"]

    check_variant_refusal(device)
    shapes = preset_kernel_shapes(kernel_shapes())
    g = torch.Generator(device="cpu").manual_seed(19)
    rows["rmsnorm"] += [k1_row(g, device, n, c, path)
                        for (n, c), path in shapes["K1"]]
    rows["rmsnorm"] += [k1_row(g, device, n, c, path, torch.float32)
                        for (n, c), path in shapes["K1 train"]]
    rows["rmsnorm_bwd"] += [k1b_row(g, device, n, c, path)
                            for (n, c), path in shapes["K1b"]]
    seen = {tuple(r["shape"]) for r in rows["rmsnorm"]
            if r["weight"] == "float32"}
    rows["rmsnorm"] += [k1_row(g, device, n, c, path, torch.float32)
                        for (n, c), path in K1_F32_WEIGHT_SMALL
                        if (n, c) not in seen]
    print(json.dumps({"shapes": rows, "launches_by_variant": {
        "rmsnorm": dict(k1.launches_by_variant),
        "rmsnorm_bwd": dict(k1.bwd.launches_by_variant)}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "K1 and K1b", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def grouped_only(device, smi: str) -> int:
    """``--grouped``: K5, K6 and K5b at phase 3's and 4's shapes and
    edges (timed), the folded ResBlock against the eager one, the
    autograd guard, and at phase 19's new layouts (checked), for a call
    that tunes the packed ResBlock's kernels; prints its JSON, the card
    line and a result line naming the part it ran."""
    import torch

    from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    rows = check_grouped_kernels(device)
    rows.update(check_residual_kernels(device))
    rows.update(check_grouped_bwd(device))
    check_autograd_guard(device)
    presets = preset_grouped_rows(
        torch.Generator(device="cpu").manual_seed(19), device,
        preset_kernel_shapes(kernel_shapes()))
    for name, more in presets.items():
        rows[name] += more
    steps = {name: grouped_step_sums(rows[name], name) for name in rows}
    log(f"K5 / K6 / K5b a step (ms): {steps}")
    print(json.dumps({"shapes": rows, "step_ms": steps,
                      "launches_by_variant": {
                          "grouped_rmsnorm": dict(k5.launches_by_variant),
                          "grouped_rmsnorm_bwd": dict(
                              k5.bwd.launches_by_variant),
                          "residual": dict(k6.launches_by_variant)},
                      "launches_by_epilogue": dict(
                          k5.launches_by_epilogue),
                      "launches_by_prologue": dict(
                          k5.launches_by_prologue)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "K5, K6 and K5b", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dit_only(device, smi: str) -> int:
    """``--dit``: K1's modulate and K7 at phase 3's shapes and edges
    (timed), the folded DiT block against the eager one, and at phase
    19's new shapes (checked), for a call that tunes the DiT block's
    kernels; prints its JSON, the card line and a result line naming the
    part it ran."""
    import torch

    from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    rows = check_dit_kernels(device)
    presets = preset_dit_rows(
        torch.Generator(device="cpu").manual_seed(19), device,
        preset_kernel_shapes(kernel_shapes()))
    steps = {name: dit_step_sums(rows[name]) for name in rows}
    for name, more in presets.items():
        rows[name] += more
    log(f"K1 modulate / K7 a step (ms): {steps}")
    print(json.dumps({"shapes": rows, "step_ms": steps,
                      "launches_by_variant": {
                          "rmsnorm": dict(k1.launches_by_variant),
                          "gated_residual": dict(k7.launches_by_variant)},
                      "launches_by_epilogue": dict(
                          k1.launches_by_epilogue)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "K1's modulate and K7",
                      "device": {
                          "platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dp_only(device, smi: str) -> int:
    """``--dp``: phase 18 alone (data-parallel training over the ranks),
    for a call that checks it; prints its JSON, the card line and a
    result line naming the part it ran."""
    import torch
    dp = run_dp(device)
    print(json.dumps({"dp": dp}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "only": "phase 18", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
