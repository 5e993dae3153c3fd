#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printed on its own line with elapsed seconds:
  1. the card (nvidia-smi name and power limit; compute capability 9.0);
  2. build the CUDA kernels (plain nvcc into a .so, loaded with ctypes);
  3. hold each kernel against its plain PyTorch version at every main
     path shape in bf16 (and each variant at edge shapes), and time the
     kernel, the plain version and one PyTorch library call doing the
     same function (a yardstick only: the port never calls it) on the
     device (CUDA graph replay), beside the card's bound for the work;
     K1 also at the extraction's (3,664, 64) in float32;
  4. the backward kernels K1b and K2b, each variant (K1b ``vector`` and
     ``strided``, K2b ``tensor_core`` and ``cuda_core``) against its plain
     version at every shape of a training step (``scripts/kernel_shapes.py
     --train``) in bf16 and f32 and at edge shapes, randn and peaked for
     K2b, each run twice for bit-equal results, and timed against their
     bound, their plain version and a library yardstick (PyTorch autograd
     through ``F.rms_norm`` or SDPA); the C entry points' refusal of a
     variant that cannot take a call; then the autograd guard: each raw
     forward launcher refuses a CUDA input that requires grad under grad
     mode and runs under ``torch.no_grad()``, and each dispatcher records
     its backward (one forward and one backward launch, finite
     gradients);
  5. int8: K3 (``quant_conv``) bit-equal to its plain version in int32,
     bf16 and f32 and K4 (``quantize``) bit-equal (int8 values, scale,
     abs-max) dynamic and static, at every int8 shape of the main path
     (``scripts/kernel_shapes.py --quant int8``) and at edge shapes (a
     deep concat at B = 2, Ci = 18 with Co = 24 in 3x3 and 1x1, 105
     rows; K4: ties that round to even, a saturating outlier, f32),
     each timed against its bound and its plain version (K3 beside
     cuDNN's bf16 convolution of the same shape, the time int8 has to
     beat); the C entry points' refusals; then the small chain in int8
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
     x 100 channels, 15 DDIM steps, bf16, block-major, window_chunk -1,
     which the memory planner resolves to the whole block and one
     z-window a call), one warm-up step that plans, then one timed chain
     with the kernels' launch counters (total and per variant) set to 0
     just before it; then the same with ``--quant int8`` and ``--quant
     int8_static`` (its build calibrates on the 2x2 block, timed with the
     build), each with exact K3 and K4 launches (75 and 117 a UNet call;
     the abs-max 117 dynamic, 0 static), tiles/s beside the bf16 chain's
     and its output against bf16's (informative); then the 5D model
     (``--no_packed``) on the same weights and the tile-major step
     (``--tile_major``, window_chunk 5);
 10. the planner at full width: its plan, the measured peak of its probe
     and the budget for 2x2, 4x4, 8x8 and 16x16 grids;
 11. whole-brain streaming: ``cli.generate.main`` with ``--stream`` at
     its defaults (2x2-tile windows, K 1, f32 transfers, 3 windows in
     flight, 4 GB of device gene cache, window_chunk 5) on a 4x4 grid,
     15 steps, with the counters set to 0 just before it; then a 2-step
     run of the same grid with ``TMT_STREAM_TIMING`` for its per-phase
     seconds;
 12. training, small: one accumulated f32 train step of a narrow model on
     the card against the CPU from the same weights, batch and draws
     (loss 1e-4, gradients 2e-3 of each leaf's max);
 13. training at full width: ``cli.train``'s builder on the 638850 preset
     (``--synthetic --batch 32``: accum 2, 128 patches a microbatch, bf16
     compute, f32 params, dropout 0.1), the 5D model, then ``--packed``,
     8 steps each with the counters set to 0 just before ``fit``: finite
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
 16. a ``{"kernels": [...]}`` line, then the card line, then the result.

Any failure raises and exits non-zero.  Needs one CUDA card; imports
nothing of JAX.
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
    two graph nodes (about a microsecond) stays in it."""
    import torch
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    n = max(calls, len(arg_sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def variant_of(mod, fn, *args):
    """(fn(*args), the variant of ``mod``'s kernel that the call launched;
    ``mod`` a wrapper module or its ``bwd`` counters)."""
    before = dict(mod.launches_by_variant)
    out = fn(*args)
    moved = [k for k, v in mod.launches_by_variant.items() if v != before[k]]
    require(len(moved) == 1, f"{getattr(mod, '__name__', mod)}: launches "
            f"{moved}")
    return out, moved[0]


def bound(nbytes: float, flops: float, flop_rate: float):
    """(bound_ms, bound_by): the larger of bytes/bandwidth and ops/peak."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
# (512 + 384, collage batch of 64 patches, G = 32).
K1_SHAPES = [(663_552, 96), (10_368, 741), (8_192, 1253), (18_549, 64),
             (41_472, 256), (10_368, 512), (32_768, 896), (32_768, 256)]
# (B, N, D) that the main path gives K2: encoder and collage decoder at
# resolution 16, and the middle block.
K2_SHAPES = [(324, 128, 256), (256, 128, 256), (324, 32, 512)]
# The packed model's K1 and K2 shapes on the other generation paths
# (scripts/kernel_shapes.py --patches P --chunk 5): the tile-major step
# (one tile's 5x5 patches, 5 z-windows a call) and the streamed 2x2-tile
# windows (9x9 patches, 5 z-windows a call: the main path's rows and
# batches x 5, up to 1,620 K2 blocks)
PATH_SHAPES = {
    "tile_major": ([(40_960, 256), (64_000, 256), (16_000, 512),
                    (28_625, 64)],
                   [(320, 128, 256), (500, 128, 256), (500, 32, 512)]),
    "stream": ([(163_840, 256), (207_360, 256), (51_840, 512),
                (92_745, 64)],
               [(1_280, 128, 256), (1_620, 128, 256), (1_620, 32, 512)]),
}
# The (rows, C) that cli.attn's extraction gives K1 in float32: the gene
# block's q-norm on 16 patches x 229 gene tokens of 64 features, 4 launches
# a tile (scripts/kernel_shapes.py --attn)
ATTN_K1_SHAPE = (3_664, 64)
# shapes off the main path that the wrappers accept: ragged rows and
# channels, ragged query tiles and key chunks, the largest shared-memory
# footprint (N = D = 512), the vector variant at one 16-byte vector a row
# (C = 8) and at a row that leaves lanes of its group unequal (C = 264);
# correctness only
K1_EDGE = [(7, 1), (13, 33), (1029, 2050), (1000, 8), (517, 264)]
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


def k2_inputs(g, b, n, d, dtype, device, peaked):
    """q, k, v from randn; ``peaked`` scales q and k so that the logits
    q.k/d have std ``K2_LOGIT_STD``."""
    import torch
    sig = (K2_LOGIT_STD * d ** 0.5) ** 0.5 if peaked else 1.0
    return tuple((s * torch.randn(b, n, d, generator=g)).to(device, dtype)
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
    import torch.nn.functional as F
    sets = input_sets((x, w), 2 * x.numel() * x.element_size())
    bms, by = bound(x.element_size() * (2 * n * c + c), 4 * n * c,
                    H100_F32_FLOP_PER_S)
    return dict(ms=device_ms(k1.rmsnorm_cuda, sets),
                plain_ms=device_ms(k1.rmsnorm_plain, sets),
                library_ms=device_ms(
                    lambda a, b: F.rms_norm(a, (c,), b, 1e-6), sets),
                bound_ms=bms, bound_by=by)


def time_k2(k2, q, k, v, scale, b, n, d) -> dict:
    import torch.nn.functional as F
    sets = input_sets((q, k, v), 4 * q.numel() * q.element_size())
    bms, by = bound(2 * 4 * b * n * d, 4 * b * n * n * d,
                    H100_BF16_FLOP_PER_S)
    return dict(ms=device_ms(lambda *a: k2.attention_cuda(*a, scale), sets),
                plain_ms=device_ms(lambda *a: k2.attention_plain(*a, scale),
                                   sets),
                library_ms=device_ms(lambda *a: F.scaled_dot_product_attention(
                    *a, scale=scale), sets),
                bound_ms=bms, bound_by=by)


def timing_text(t: dict, lib: str) -> str:
    return (f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, {lib} "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f} % of it)")


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
    rows = {"rmsnorm": [], "window_attention": []}

    def k1_agrees(x, w, what):
        out, variant = variant_of(k1, k1.rmsnorm_cuda, x, w)
        ref = k1.rmsnorm_plain(x, w)
        require(bool(torch.isfinite(out.float()).all()),
                f"K1 {what}: output not finite")
        err = (ulp_err(out, ref) if x.dtype == bf16
               else float((out - ref).abs().max()))
        require(err <= (K1_MAX_ULP if x.dtype == bf16 else 1e-5),
                f"K1 {what} {x.dtype} ({variant}): {err}")
        return out, ref, err, variant

    def k1_shape(n, c, path):
        x = torch.randn(n, c, generator=g).to(device, bf16)
        w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, bf16)
        out, ref, err_ulp, variant = k1_agrees(x, w, f"{n}x{c}")
        err = float((out.float() - ref.float()).abs().max())
        want = "vector" if c % 8 == 0 else "strided"
        require(variant == want, f"K1 {n}x{c} took {variant}, not {want}")
        # f32 input: the same variant's float instantiation
        _, _, errf, _ = k1_agrees(x[:4096].float(), w.float(), f"{n}x{c}")
        t = time_k1(k1, x, w, n, c)
        log(f"K1 rmsnorm ({n}, {c}) bf16 [{variant}, {path}]: max_abs_err "
            f"{err:.3g} ({err_ulp:.2f} bf16 ulp, tol {K1_MAX_ULP}), f32 err "
            f"{errf:.3g}; " + timing_text(t, "F.rms_norm"))
        rows["rmsnorm"].append(dict(shape=[n, c], path=path, variant=variant,
                                    max_abs_err=err, **t))

    for n, c in K1_SHAPES:
        k1_shape(n, c, "block_major")
    seen = []
    for n, c in K1_EDGE:
        for dt in (bf16, torch.float32):
            x = torch.randn(n, c, generator=g).to(device, dt)
            w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, dt)
            seen.append(f"({n}, {c}) {str(dt)[6:]} {k1_agrees(x, w, 'edge')[3]}")
    # a contiguous tensor whose storage starts one element off 16 bytes
    for dt in (bf16, torch.float32):
        c = 96
        base = torch.randn(4096 * c + 1, generator=g).to(device, dt)
        x = base[1:].view(4096, c)
        w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, dt)
        require(x.is_contiguous() and x.data_ptr() % 16 != 0,
                "K1 misaligned input is not misaligned")
        variant = k1_agrees(x, w, "misaligned")[3]
        require(variant == "strided", f"K1 misaligned took {variant}")
        seen.append(f"(4096, 96) {str(dt)[6:]} misaligned {variant}")
    log(f"K1 edge shapes agree: {'; '.join(seen)}")

    def k2_shape(b, n, d, path):
        scale = 1.0 / d
        errs = []
        for peaked in (False, True):
            q, k, v = k2_inputs(g, b, n, d, bf16, device, peaked)
            out, variant = variant_of(k2, k2.attention_cuda, q, k, v, scale)
            torch.cuda.synchronize()
            ref = k2.attention_plain(q, k, v, scale)
            errs.append(require_k2(out, ref, f"{b}x{n}x{d} "
                                   f"{'peaked' if peaked else 'randn'}"))
            require(variant == "tensor_core",
                    f"K2 {b}x{n}x{d} bf16 took {variant}")
        err = max(e[0] for e in errs)
        qf, kf, vf = (t[:8].float() for t in (q, k, v))
        outf, variant_f = variant_of(k2, k2.attention_cuda, qf, kf, vf, scale)
        errf = float((outf - k2.attention_plain(qf, kf, vf, scale))
                     .abs().max())
        require(errf <= 1e-5, f"K2 {b}x{n}x{d} f32 ({variant_f}): {errf}")
        q, k, v = k2_inputs(g, b, n, d, bf16, device, False)
        t = time_k2(k2, q, k, v, scale, b, n, d)
        agree = "; ".join(f"{kind}: max_abs_err {e:.3g} = {sp:.2f} "
                          f"spacings, {sh:.2e} differ"
                          for kind, (e, sp, sh) in zip(("randn", "peaked"),
                                                       errs))
        log(f"K2 window_attention ({b}, {n}, {d}) bf16 [{variant}, {path}]: "
            f"{agree} (tol {K2_MAX_SPACINGS} spacings, {K2_MAX_SHARE}); f32 "
            f"[{variant_f}] err {errf:.3g}; " + timing_text(t, "SDPA"))
        rows["window_attention"].append(dict(shape=[b, n, d], path=path,
                                             variant=variant,
                                             max_abs_err=err, **t))

    for b, n, d in K2_SHAPES:
        k2_shape(b, n, d, "block_major")
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
        for n, c in k1_shapes:
            k1_shape(n, c, path)
        for b, n, d in k2_shapes:
            k2_shape(b, n, d, path)
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
# K1 (and K1b) and K2 (and K2b) launches a training step
TRAIN_LAUNCHES = {"5d": {"rmsnorm": 252, "window_attention": 18},
                  "packed": {"rmsnorm": 76, "window_attention": 18}}
# K1b and K2b launches a training step by variant (scripts/kernel_shapes.py
# --train): the odd C of the gene concats take K1b strided
TRAIN_BWD_VARIANTS = {
    "5d": {"rmsnorm_bwd": {"strided": 18, "vector": 234},
           "window_attention_bwd": {"cuda_core": 0, "tensor_core": 18}},
    "packed": {"rmsnorm_bwd": {"strided": 0, "vector": 76},
               "window_attention_bwd": {"cuda_core": 0, "tensor_core": 18}}}
# edge shapes: ragged and odd C, odd row counts, C = 741 and 1,253 (K1b
# strided), C = 8, 264 and 1,024 (vector with one 16-byte vector a row,
# unequal lanes, 32 lanes a row; 1,024 is strided in f32) and 2,050 (a row
# wider than the strided variant's registers); N = 17, 100, 512 and D =
# 48, 130, 512 (K2b tensor_core at (5, 100, 48), with N not a multiple of
# 16; cuda_core at D = 130 and at N = D = 512, the largest shared memory)
K1B_EDGE = [(7, 33), (13, 100), (1029, 741), (517, 1253), (3, 8),
            (517, 264), (1000, 1024), (33, 2050)]
K2B_EDGE = [(5, 100, 48), (3, 17, 130), (2, 512, 512)]
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
    nbytes = 3 * n * c * x.element_size() + 2 * 4 * c
    bms, by = bound(nbytes, 10 * n * c, H100_F32_FLOP_PER_S)
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
    bms, by = bound(7 * b * n * d * q.element_size(), 10 * b * n * n * d,
                    H100_BF16_FLOP_PER_S if q.dtype == torch.bfloat16
                    else H100_F32_FLOP_PER_S)
    return dict(ms=device_ms(lambda *a: k2.attention_bwd_cuda(*a, scale),
                             sets),
                plain_ms=device_ms(
                    lambda *a: k2.attention_bwd_plain(*a, scale), sets),
                library_ms=lib, bound_ms=bms, bound_by=by)


def check_backward_kernels(device) -> dict:
    """Each variant of K1b and K2b against its plain version at every
    training-step shape (bf16, and float32 on a slice of the rows or
    batch) and at the edge shapes (both dtypes, randn and peaked for K2b,
    a misaligned tensor for K1b), each run twice for bit-equal outputs;
    the variant each call takes is required; device times at the
    training shapes.  Returns {name: [row per training shape]}."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    gen = torch.Generator(device="cpu").manual_seed(2)
    bf16 = torch.bfloat16
    rows = {"rmsnorm_bwd": [], "window_attention_bwd": []}

    def k1b_agrees(x, g, w, what, want=None):
        (dx, dw), variant = variant_of(k1.bwd, k1.rmsnorm_bwd_cuda, x, g, w)
        dx2, dw2 = k1.rmsnorm_bwd_cuda(x, g, w)
        torch.cuda.synchronize()
        if want is None:
            want = k1.rmsnorm_bwd_variant(x.shape[-1], x.element_size(),
                                          True)
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

    def k1b_inputs(n, c, dt):
        x = torch.randn(n, c, generator=gen).to(device, dt)
        g = torch.randn(n, c, generator=gen).to(device, dt)
        w = (1 + 0.1 * torch.randn(c, generator=gen)).to(device)
        return x, g, w

    for n, c in TRAIN_K1_SHAPES:
        x, g, w = k1b_inputs(n, c, bf16)
        (err, sp, sh), dw_err, variant = k1b_agrees(x, g, w, f"{n}x{c}")
        xf, gf = x[:4096].float(), g[:4096].float()
        (errf, _, _), dwf, variant_f = k1b_agrees(xf, gf, w, f"{n}x{c}")
        t = time_k1b(k1, x, g, w)
        log(f"K1b rmsnorm_bwd ({n}, {c}) bf16 [{variant}]: dx max_abs_err "
            f"{err:.3g} = {sp:.2f} spacings, {sh:.2e} differ, dw "
            f"{dw_err:.2e} of max; f32 [{variant_f}] dx {errf:.3g}, dw "
            f"{dwf:.2e}; deterministic; " + timing_text(t, "F.rms_norm bwd"))
        rows["rmsnorm_bwd"].append(dict(shape=[n, c], variant=variant,
                                        max_abs_err=err, dw_rel_err=dw_err,
                                        **t))
    seen = []
    for n, c in K1B_EDGE:
        got = [k1b_agrees(*k1b_inputs(n, c, dt), f"edge {n}x{c}")[2]
               for dt in (bf16, torch.float32)]
        seen.append(f"({n}, {c}) bf16 {got[0]}, f32 {got[1]}")
    for dt in (bf16, torch.float32):
        base = torch.randn(4096 * 96 + 1, generator=gen).to(device, dt)
        x = base[1:].view(4096, 96)
        require(x.is_contiguous() and x.data_ptr() % 16 != 0,
                "K1b misaligned input is not misaligned")
        _, g, w = k1b_inputs(4096, 96, dt)
        k1b_agrees(x, g, w, "misaligned 4096x96", want="strided")
    log(f"K1b edge shapes agree, bf16 and f32, deterministic: "
        f"{'; '.join(seen)}; (4096, 96) misaligned strided")

    def k2b_agrees(b, n, d, dt, peaked, what):
        q, k, v = k2_inputs(gen, b, n, d, dt, device, peaked)
        g = torch.randn(b, n, d, generator=gen).to(device, dt)
        out, variant = variant_of(k2.bwd, k2.attention_bwd_cuda, q, k, v, g,
                                  1.0 / d)
        out2 = k2.attention_bwd_cuda(q, k, v, g, 1.0 / d)
        torch.cuda.synchronize()
        want = k2.attention_bwd_variant(n, d, dt, True)
        require(variant == want, f"K2b {what} {dt} took {variant}, not {want}")
        require(all(torch.equal(a, c) for a, c in zip(out, out2)),
                f"K2b {what} ({variant}): two runs differ")
        ref = k2.attention_bwd_plain(q, k, v, g, 1.0 / d)
        gates = [require_bwd(o, r, f"K2b {what} ({variant}) {name} {dt}")
                 for o, r, name in zip(out, ref, ("dq", "dk", "dv"))]
        return tuple(max(e) for e in zip(*gates)), variant

    for b, n, d in TRAIN_K2_SHAPES:
        errs = [k2b_agrees(b, n, d, bf16, peaked, f"{b}x{n}x{d}")
                for peaked in (False, True)]
        variant = errs[0][1]
        (errf, _, _), variant_f = k2b_agrees(8, n, d, torch.float32, False,
                                             f"8x{n}x{d}")
        q, k, v = k2_inputs(gen, b, n, d, bf16, device, False)
        g = torch.randn(b, n, d, generator=gen).to(device, bf16)
        t = time_k2b(k2, q, k, v, g, 1.0 / d)
        agree = "; ".join(f"{kind}: max_abs_err {e:.3g} = {sp:.2f} "
                          f"spacings, {sh:.2e} differ"
                          for kind, ((e, sp, sh), _) in zip(
                              ("randn", "peaked"), errs))
        log(f"K2b window_attention_bwd ({b}, {n}, {d}) bf16 [{variant}]: "
            f"dq, dk, dv {agree} (tol {K2_MAX_SPACINGS} spacings, "
            f"{K2_MAX_SHARE}); f32 [{variant_f}] {errf:.3g}; "
            "deterministic; " + timing_text(t, "SDPA bwd"))
        rows["window_attention_bwd"].append(dict(
            shape=[b, n, d], variant=variant,
            max_abs_err=max(e[0][0] for e in errs),
            max_share=max(e[0][2] for e in errs), **t))
    seen = []
    for b, n, d in K2B_EDGE:
        got = {}
        for dt in (bf16, torch.float32):
            for peaked in (False, True):
                got[dt] = k2b_agrees(b, n, d, dt, peaked,
                                     f"edge {b}x{n}x{d}")[1]
        seen.append(f"({b}, {n}, {d}) bf16 {got[bf16]}, f32 "
                    f"{got[torch.float32]}")
    log("K2b edge shapes agree, bf16 and f32, randn and peaked, "
        f"deterministic: {'; '.join(seen)}")
    return rows


def check_variant_refusal(device) -> None:
    """The backward kernels' C entry points refuse a variant that cannot
    take the call (an error code, no launch): K2b ``tensor_core`` on
    float32, on N = 256 and on a misaligned gradient, an unknown variant;
    K1b ``vector`` on C = 741 and on a misaligned x."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    tc, cc = k2.VARIANTS.index("tensor_core"), k2.VARIANTS.index("cuda_core")

    def k2b(dtype, n, variant, offset=0):
        t = torch.zeros(4 * n * 64 + 8, device=device, dtype=dtype)
        a = t[offset:offset + 4 * n * 64]
        stats = torch.empty(4 * n * 3, device=device)
        return lib.tmt_window_attention_bwd(
            *(a.data_ptr(),) * 7, stats.data_ptr(), 4, n, 64, 1 / 64,
            _build.DTYPES[dtype], variant, stream)

    bf16 = torch.bfloat16
    require(k2b(bf16, 32, tc) == 0 and k2b(torch.float32, 32, cc) == 0,
            "K2b entry refused calls its variants take")
    refused = {"tensor_core on float32": k2b(torch.float32, 32, tc),
               "tensor_core at N = 256": k2b(bf16, 256, tc),
               "tensor_core misaligned": k2b(bf16, 32, tc, offset=1),
               "variant 7": k2b(bf16, 32, 7)}
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

    require(k1b(96, vec) == 0 and k1b(741, strided) == 0,
            "K1b entry refused calls its variants take")
    refused.update({"K1b vector at C = 741": k1b(741, vec),
                    "K1b vector misaligned": k1b(96, vec, offset=1)})
    torch.cuda.synchronize()
    require(all(err != 0 for err in refused.values()),
            f"backward entry points took calls their variant cannot: "
            f"{refused}")
    log(f"K1b and K2b entry points refuse (error codes): {refused}")


# ---------------------------------------------------------------------------
# phase 4, continued: the raw launchers' autograd guard, the Functions
# ---------------------------------------------------------------------------

def check_autograd_guard(device) -> None:
    """Each raw forward launcher (``rmsnorm_cuda``, ``attention_cuda``)
    raises before the launch on a CUDA input that requires grad while
    grad mode is on, and runs the same call under ``torch.no_grad()``;
    the dispatchers (``rmsnorm``, ``window_attention``) record a backward
    instead: one forward and one backward kernel launch, finite
    gradients, and a float32 dw for a float32 weight."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(256, 96, generator=g).to(device, torch.bfloat16)
    w = torch.ones(96, device=device)
    q, k, v = (torch.randn(4, 32, 64, generator=g).to(device, torch.bfloat16)
               for _ in range(3))
    cases = (("rmsnorm", k1, k1.rmsnorm_cuda, k1.rmsnorm, (x, w)),
             ("window_attention", k2, k2.attention_cuda, k2.window_attention,
              (q, k, v, 1.0 / 64)))
    for name, mod, raw, dispatch, args in cases:
        args = [a.detach().requires_grad_(True) if torch.is_tensor(a) else a
                for a in args]
        before = (mod.launches, mod.bwd.launches)
        refused = None
        try:
            raw(*args)
        except RuntimeError as err:
            refused = str(err)
        require(refused is not None and "K1b and K2b" in refused,
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
    (5184, 512, 16), (5184, 970, 16), (5184, 1024, 16), (5184, 1482, 16),
    (4096, 1024, 16), (4096, 1994, 16), (4096, 2506, 16)]
# shapes off the main path: a deep concat input at B = 2, a ragged Ci
# (18, padded to 32) with Co = 24 at B = 1, 3x3 and 1x1, and 105 output
# rows (not a multiple of the 128-row tile) with H != W
K3_EDGE = [((2, 8, 8, 970), (1024, 3, 3)), ((1, 8, 8, 18), (24, 3, 3)),
           ((1, 8, 8, 18), (24, 1, 1)), ((3, 5, 7, 40), (16, 3, 3))]
# launches of K3, K4 (by variant) and K4's abs-max in a 2x2 chain of 375
# UNet calls (scripts/kernel_shapes.py --quant)
QUANT_LAUNCHES = {
    "int8": {"quant_conv": {"dequant": 75 * 375, "int32": 0},
             "quantize": {"dynamic": 117 * 375, "static": 0},
             "absmax": 117 * 375},
    "int8_static": {"quant_conv": {"dequant": 75 * 375, "int32": 0},
                    "quantize": {"dynamic": 0, "static": 117 * 375},
                    "absmax": 0}}
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


def k3_inputs(g, x_shape, w_shape, device):
    """Random int8 x and w with their channels zero-padded to 16, as K4
    writes them and prequantize_params stores them, and a positive f32
    scale and an f32 bias."""
    import torch

    from tera_mind_tpu_torch.ops import quant_kernel as qk
    b, h, w, ci = x_shape
    co, kh, kw = w_shape
    cip = qk.round_up(ci, qk.CONV_ALIGN)
    xq = torch.randint(-127, 128, (b, h, w, cip), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (co, kh, kw, cip), generator=g,
                       dtype=torch.int8)
    xq[..., ci:] = 0
    wq[..., ci:] = 0
    scale = torch.rand(co, generator=g) * 1e-4 + 1e-6
    bias = torch.randn(co, generator=g)
    return tuple(t.to(device) for t in (xq, wq, scale, bias))


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


def k3_agrees(qk, xq, wq, scale, bias, what: str) -> float:
    """K3 bit-equal to its plain version: the int32 sums and the bf16 and
    float32 dequantized outputs; returns the largest |difference| over
    the dequantized outputs (the int32 sums' must be 0 too)."""
    import torch
    errs = []
    for out_dtype in (torch.int32, torch.bfloat16, torch.float32):
        args = (xq, wq) + ((None, None) if out_dtype == torch.int32
                           else (scale, bias))
        got = qk.quant_conv_cuda(*args, out_dtype)
        torch.cuda.synchronize()
        want = qk.quant_conv_plain(*args, out_dtype)
        require(got.dtype == out_dtype and torch.equal(got, want),
                f"K3 {what} {out_dtype}: "
                f"{int((got != want).sum())} outputs differ")
        errs.append(max_abs_diff(got, want))
    return max(errs)


def time_k3(qk, xq, wq, scale, bias, x_shape, w_shape) -> dict:
    """Device times of K3 (bf16 out), its plain version and the yardstick:
    cuDNN's bf16 convolution of the same shape, channels-last (not the
    same function: the time int8 has to beat), beside K3's bound."""
    import torch
    import torch.nn.functional as F
    b, h, w, ci = x_shape
    co, kh, kw = w_shape
    cip = xq.shape[-1]
    sets = input_sets((xq, wq, scale, bias), xq.numel() + wq.numel())
    xb = torch.randn(b, ci, h, w, device=xq.device, dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last)
    wb = torch.randn(co, ci, kh, kw, device=xq.device, dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last)
    bb = torch.randn(co, device=xq.device, dtype=torch.bfloat16)
    lib_sets = input_sets((xb, wb, bb), 2 * (xb.numel() + wb.numel()))
    ops = 2 * b * h * w * co * kh * kw * ci
    nbytes = b * h * w * (cip + 2 * co) + co * kh * kw * cip + 8 * co
    bms, by = bound(nbytes, ops, H100_INT8_OPS_PER_S)
    return dict(ms=device_ms(qk.quant_conv_cuda, sets),
                plain_ms=device_ms(qk.quant_conv_plain, sets),
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


def check_int8_kernels(device) -> dict:
    """K3 and K4 against their plain versions at every main-path int8
    shape and at edge shapes, timed; the C entry points' refusals.
    Returns {name: [row per main-path shape]}."""
    import torch

    from tera_mind_tpu_torch.ops import _build
    from tera_mind_tpu_torch.ops import quant_kernel as qk

    g = torch.Generator(device="cpu").manual_seed(3)
    rows = {"quant_conv": [], "quantize": []}
    for x_shape, w_shape in K3_SHAPES:
        xq, wq, scale, bias = k3_inputs(g, x_shape, w_shape, device)
        err = k3_agrees(qk, xq, wq, scale, bias, f"{x_shape} {w_shape}")
        t = time_k3(qk, xq, wq, scale, bias, x_shape, w_shape)
        tops = t.pop("tops") / t["ms"] / 1e9
        log(f"K3 quant_conv x {x_shape} w {w_shape}: bit-equal (int32, "
            f"bf16, f32); kernel {t['ms']:.4f} ms ({tops:.0f} TOPS), plain "
            f"{t['plain_ms']:.4f} ms, cuDNN bf16 {t['bf16_conv_ms']:.4f} ms"
            f", bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{100 * t['bound_ms'] / t['ms']:.1f} % of it)")
        rows["quant_conv"].append(dict(shape=[list(x_shape), list(w_shape)],
                                       max_abs_err=err, tops=tops, **t))
    for x_shape, w_shape in K3_EDGE:
        k3_agrees(qk, *k3_inputs(g, x_shape, w_shape, device),
                  f"edge {x_shape} {w_shape}")
    log(f"K3 edge shapes bit-equal: {K3_EDGE}")

    # the C entry point refuses a misaligned x, a ragged Ci_pad or Co, an
    # even kernel, a sum that could overflow and a wrong dtype code
    lib, stream = _build.lib(), torch.cuda.current_stream().cuda_stream
    xq, wq, scale, bias = k3_inputs(g, (2, 8, 8, 32), (16, 3, 3), device)
    base = torch.zeros(xq.numel() + 16, dtype=torch.int8, device=device)
    y = torch.empty(2, 8, 8, 16, dtype=torch.bfloat16, device=device)

    def k3_call(x=xq, ci=32, co=16, kh=3, out=1, variant=0):
        return lib.tmt_quant_conv(x.data_ptr(), wq.data_ptr(),
                                  scale.data_ptr(), bias.data_ptr(),
                                  y.data_ptr(), 2, 8, 8, ci, co, kh, kh, out,
                                  variant, stream)
    require(k3_call() == 0, "K3 entry refused a call it takes")
    refused = {"misaligned x": k3_call(x=base[1:1 + xq.numel()]),
               "Ci_pad 24": k3_call(ci=24), "Co 12": k3_call(co=12),
               "2x2 kernel": k3_call(kh=2), "overflow": k3_call(ci=16_000),
               "out dtype 2 for dequant": k3_call(out=2),
               "variant 5": k3_call(variant=5)}
    refused["K4 multiple 4"] = lib.tmt_quantize(
        bias.data_ptr(), base.data_ptr(), scale.data_ptr(), None, 4, 4, 4,
        0, 1, stream)
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

    for r, c, m in K4_SHAPES:
        x = torch.randn(r, c, generator=g).to(device, torch.bfloat16)
        a_scale = (x.float().abs().amax() / 100).reshape(())
        seen, errs = zip(*[k4_agrees(qk, x, a, m, f"({r}, {c}, {m})")
                           for a in (None, a_scale)])
        t = {v: time_k4(qk, x, a, m) for v, a in (("dynamic", None),
                                                   ("static", a_scale))}
        log(f"K4 quantize ({r}, {c}) bf16 -> multiple {m}: bit-equal "
            f"({', '.join(seen)}); dynamic {t['dynamic']['ms']:.4f} ms "
            f"(plain {t['dynamic']['plain_ms']:.4f}), static "
            f"{t['static']['ms']:.4f} ms (plain "
            f"{t['static']['plain_ms']:.4f}), bound "
            f"{t['dynamic']['bound_ms']:.4f} ms ({t['dynamic']['bound_by']}"
            f", {100 * t['dynamic']['bound_ms'] / t['dynamic']['ms']:.1f} "
            f"% of it dynamic)")
        rows["quantize"].append(dict(shape=[r, c, m], max_abs_err=max(errs),
                                     **t["dynamic"],
                                     static_ms=t["static"]["ms"],
                                     static_plain_ms=t["static"]["plain_ms"]
                                     ))
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
    log("K4 bit-equal on ties (round half to even), a saturating outlier "
        "(static), 8 and 16 multiples, f32 (999, 229), and a NaN (dynamic: "
        "NaN scale and abs-max, q = 0; static: q = 0 where x is NaN)")
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
STEPS = 15        # DDIM steps (eta 0)


# launches per chain: K1 norms and K2 attentions per UNet call x UNet
# calls.  The packed model's 46 ResBlock and output norms are
# GroupedRMSNorm (plain PyTorch), so K1 runs only in the 6 DiT blocks
# (norm1, norm2, q_norm, k_norm) and the gene-gene block (q_norm, norm2).
# Block-major 2x2: 25 z-windows x 15 steps = 375 calls; tile-major 2x2 at
# window_chunk 5: 4 tiles x 5 calls x 15 steps = 300; streamed 4x4 in 2x2
# windows at window_chunk 5: 4 windows x 5 calls x 15 steps = 300.
CHAIN_LAUNCHES = {
    "packed": {"rmsnorm": 26 * 375, "window_attention": 6 * 375},
    "int8": {"rmsnorm": 26 * 375, "window_attention": 6 * 375},
    "int8_static": {"rmsnorm": 26 * 375, "window_attention": 6 * 375},
    "5d": {"rmsnorm": 83 * 375, "window_attention": 6 * 375},
    "tile_major": {"rmsnorm": 26 * 300, "window_attention": 6 * 300},
    "stream": {"rmsnorm": 26 * 300, "window_attention": 6 * 300}}
STREAM_GRID = 4   # 4x4 tiles: four 2x2-tile windows a step


def per_call_counts(model) -> tuple:
    """(K1 norms, of them with C % 8 == 0, K2 attentions) per UNet call.
    K1 runs in every RMSNorm itself; its GroupedRMSNorm subclass is plain
    PyTorch."""
    from tera_mind_tpu_torch.models.attention import CrossAttention
    from tera_mind_tpu_torch.models.nn import RMSNorm
    norms = [m.weight.numel() for m in model.modules()
             if type(m) is RMSNorm]
    return (len(norms), sum(c % 8 == 0 for c in norms),
            sum(isinstance(m, CrossAttention) for m in model.modules()))


def expected_launches(counts: tuple, calls: int) -> tuple:
    """(launches, launches by variant) of ``calls`` UNet calls."""
    n_norm, n_vec, n_attn = counts
    return ({"rmsnorm": n_norm * calls, "window_attention": n_attn * calls},
            {"rmsnorm": {"strided": (n_norm - n_vec) * calls,
                         "vector": n_vec * calls},
             "window_attention": {"cuda_core": 0,
                                  "tensor_core": n_attn * calls}})


def read_launches() -> tuple:
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    return ({"rmsnorm": k1.launches, "window_attention": k2.launches},
            {"rmsnorm": dict(k1.launches_by_variant),
             "window_attention": dict(k2.launches_by_variant)})


def reset_launches() -> None:
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    k1.reset_launches()
    k2.reset_launches()
    qk.reset_launches()


def read_quant_launches() -> dict:
    """K3's launches, K4's by variant and K4's abs-max launches."""
    from tera_mind_tpu_torch.ops import quant_kernel as qk
    return {"quant_conv": dict(qk.k3.launches_by_variant),
            "quantize": dict(qk.k4.launches_by_variant),
            "absmax": qk.k4_absmax.launches}


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
    flags = {"packed": [], "5d": ["--no_packed"],
             "tile_major": ["--tile_major"], "int8": ["--quant", "int8"],
             "int8_static": ["--quant", "int8_static"]}[path]
    args = generate.parse_args(["--synthetic", "--hnm", str(GRID),
                                "--wnm", str(GRID), "--tot_epoch",
                                str(STEPS), "--device", str(device)] + flags)
    t0 = time.perf_counter()
    gen, model, gene, (row0, col0) = generate.build(args)
    build_s = time.perf_counter() - t0

    state0 = torch.as_tensor(gen.init_state(GRID, GRID, row0=row0,
                                            col0=col0), device=device)
    t0 = time.perf_counter()
    gen.compile_step(GRID, GRID, block_major=not tile_major)(
        state0, torch.as_tensor(gene, device=device), STEPS - 1)
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
    calls = gen.conf.n_win // gen._wchunk() * STEPS * (
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
    log(f"chain [{path}]: {GRID}x{GRID} tiles x {STEPS} steps in "
        f"{secs:.2f} s = {GRID * GRID / secs:.5f} tiles/s; peak device "
        f"memory {peak:.2f} GiB ({before:.2f} GiB allocated before the "
        f"chain); launches {got} (expected {want}), by "
        f"variant {got_variants} (expected {want_variants}); {card}")

    require_output(out, (GRID * 256, GRID * 256, 100))
    require(got == want, f"launches {got}, expected {want}")
    require(want == CHAIN_LAUNCHES[path],
            f"per-chain launch counts {want} differ from the {path} "
            f"model's {CHAIN_LAUNCHES[path]}")
    require(got_variants == want_variants,
            f"launches by variant {got_variants}, expected {want_variants}")
    want_quant = QUANT_LAUNCHES.get(path, {
        "quant_conv": {"dequant": 0, "int32": 0},
        "quantize": {"dynamic": 0, "static": 0}, "absmax": 0})
    log(f"int8 launches [{path}]: {quant} (expected {want_quant})")
    require(quant == want_quant,
            f"K3/K4 launches {quant}, expected {want_quant}")
    return dict(launches=got, variants=got_variants, seconds=secs,
                tiles_per_s=GRID * GRID / secs, peak_gib=peak, out=out,
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
    """``cli.generate.main --stream`` at its defaults on a 4x4 grid, 15
    steps, with the launch counters set to 0 just before it, then a 2-step
    run of the same grid under ``TMT_STREAM_TIMING``."""
    import contextlib
    import os
    import re
    import tempfile

    import torch

    from tera_mind_tpu_torch.cli import generate

    g = STREAM_GRID
    rss_before = peak_rss_gib()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--stream", "--hnm", str(g), "--wnm", str(g),
                "--tot_epoch", str(STEPS), "--device", str(device),
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
    calls = 25 // wc * (g // 2) ** 2 * STEPS
    want, want_variants = expected_launches(counts, calls)
    log(f"chain [stream]: {g}x{g} tiles x {STEPS} steps in {secs:.2f} s = "
        f"{g * g / secs:.5f} tiles/s (window_chunk {wc}, {calls} UNet "
        f"calls); peak device memory {peak:.2f} GiB, the process's peak "
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

    # the per-phase breakdown: one sequential sweep, 2 steps
    args = generate.parse_args(argv[:6] + ["--tot_epoch", "2", "--device",
                                           str(device)])
    gen, _, gene, (row0, col0) = generate.build(args)
    sgen = generate.make_streamer(args, gen)
    os.environ["TMT_STREAM_TIMING"] = "1"
    try:
        t0 = time.perf_counter()
        sgen.run(g, g, gene, row0=row0, col0=col0, grid_w=416)
        timed_s = time.perf_counter() - t0
    finally:
        del os.environ["TMT_STREAM_TIMING"]
    timing = dict(sgen.timing, seconds=timed_s)
    log(f"stream timing, {g}x{g} x 2 steps, one worker: " + ", ".join(
        f"{k} {v:.3f} s" if k != "n" else f"{v} windows"
        for k, v in timing.items()))
    return dict(launches=got, variants=got_variants, seconds=secs,
                tiles_per_s=g * g / secs, peak_gib=peak, host_rss_gib=rss,
                host_rss_before_gib=rss_before, window_chunk=wc,
                timing=timing, out=out)


# ---------------------------------------------------------------------------
# phases 12 and 13: training
# ---------------------------------------------------------------------------

TRAIN_LOSS_ATOL = 1e-4   # the small f32 train step, card vs CPU: the loss,
TRAIN_GRAD_TOL = 2e-3    # and each gradient leaf within this share of its
                         # max |CPU grad| (cuDNN TF32 off; conv algorithms
                         # and kernel sums reassociate, as the small chains)
TRAIN_STEPS = 8          # full-width steps a model
TRAIN_TIMED_FROM = 3     # samples/s and data wait over steps 3..8


def small_train_config(**kw):
    """tests/test_harness.py's narrow training config, float32, no
    dropout."""
    from tera_mind_tpu_torch.config import TrainConfig
    return TrainConfig(image_size=32, net_ch=8, embed_channels=32,
                       rna_num=16, rna_slices=4, stain="all", batch_size=2,
                       accum_batches=2, lr=1e-3, compute_dtype="float32",
                       train_crop=64, dropout=0.0, **kw)


def check_small_train_step(device) -> dict:
    """One accumulated f32 train step of the narrow config on the card and
    on the CPU from the same weights (every leaf perturbed, so all get a
    gradient), batch and draws (noise, t, block origin): the loss within
    TRAIN_LOSS_ATOL and every gradient leaf within TRAIN_GRAD_TOL of its
    max |CPU grad|; returns the largest differences."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.convert import export_params, load_jax_params
    from tera_mind_tpu_torch.training.harness import Trainer

    conf = small_train_config()
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
    out = {"loss": abs(float(loss_g) - float(loss_c)), "grad": 0.0}
    for name, gc in grads_c.items():
        top = float(gc.abs().max())
        d = float((grads_g[name].cpu() - gc).abs().max())
        require(d <= TRAIN_GRAD_TOL * max(top, 1e-12),
                f"small train step grad {name}: {d} of max {top}")
        out["grad"] = max(out["grad"], d / max(top, 1e-12))
    require(out["loss"] <= TRAIN_LOSS_ATOL,
            f"small train step loss: card {float(loss_g)}, CPU "
            f"{float(loss_c)}")
    log(f"small f32 train step, card vs CPU: loss {float(loss_g):.6f} vs "
        f"{float(loss_c):.6f} (|d| {out['loss']:.3g}, tol "
        f"{TRAIN_LOSS_ATOL}); gradients within {out['grad']:.3g} of each "
        f"leaf's max (tol {TRAIN_GRAD_TOL}), {len(grads_c)} leaves")
    return out


def read_train_launches() -> tuple:
    """(launches of K1, K1b, K2, K2b; K1b's and K2b's by variant)."""
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
    return ({"rmsnorm": k1.launches, "rmsnorm_bwd": k1.bwd.launches,
             "window_attention": k2.launches,
             "window_attention_bwd": k2.bwd.launches},
            {"rmsnorm_bwd": dict(k1.bwd.launches_by_variant),
             "window_attention_bwd": dict(k2.bwd.launches_by_variant)})


def run_training(device, path: str, tmp: Path) -> dict:
    """``cli.train``'s own builder on the 638850 preset at full width
    (``--synthetic --batch 32``: accum 2, 128 patches of 64^2 a
    microbatch; bf16 compute, f32 params, dropout 0.1, lr 2e-5, grad clip
    1), the 5D model or ``--packed``, for TRAIN_STEPS steps with the
    launch counters set to 0 just before ``fit``; then save -> restore on
    the card (bit-equal) and, for the 5D model, ``cli.generate`` on a 1x1
    grid for 2 steps from the checkpoint the trainer wrote."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.cli import generate
    from tera_mind_tpu_torch.cli import train as train_cli
    from tera_mind_tpu_torch.training.harness import Trainer

    args = train_cli.parse_args(
        ["--synthetic", "--batch", "32", "--max_steps", str(TRAIN_STEPS),
         "--device", str(device)] + (["--packed"] if path == "packed" else []))
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
            ds, conf.batch_size_effective), max_steps=TRAIN_STEPS,
            state=state, log_every=1, metrics=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        card = stop_card_sampler(smi_proc)
    got, got_variants = read_train_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rss = peak_rss_gib()
    want_step = TRAIN_LAUNCHES[path]
    want = {k: want_step[k.removesuffix("_bwd")] * TRAIN_STEPS for k in got}
    want_variants = {k: {v: n * TRAIN_STEPS for v, n in by.items()}
                     for k, by in TRAIN_BWD_VARIANTS[path].items()}
    timed = trainer.log[TRAIN_TIMED_FROM - 1:]
    data_s = sum(r["data_s"] for r in timed)
    step_s = sum(r["step_s"] for r in timed)
    rate = conf.batch_size_effective * len(timed) / (data_s + step_s)
    losses = [r["loss"] for r in trainer.log]
    changed = max(float((state.params[n].detach() - p).abs().max())
                  for n, p in before.items())
    log(f"training [{path}]: {n_params / 1e6:.1f}M f32 params, built in "
        f"{build_s:.1f} s; {TRAIN_STEPS} steps of 64 samples in {secs:.2f} "
        f"s; steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS}: {rate:.2f} samples/s, "
        f"{step_s / len(timed):.3f} s a step on the device, data wait "
        f"{100 * data_s / (data_s + step_s):.1f} %; losses "
        f"{[round(v, 4) for v in losses]}; peak device memory {peak:.2f} "
        f"GiB, the process's peak host RSS {rss:.2f} GiB ({rss_before:.2f} "
        f"before); launches {got} (expected {want}), backward by variant "
        f"{got_variants} (expected {want_variants}); {card}")
    require(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
            f"training losses {losses}")
    require(changed > 0, "training left the parameters unchanged")
    require(got == want, f"training launches {got}, expected {want}")
    require(got_variants == want_variants,
            f"training backward launches by variant {got_variants}, "
            f"expected {want_variants}")

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
    if path == "5d":
        out["ckpt"] = Path(conf.logdir) / "ckpt"
        gen_out = generate.main([
            "--ckpt_pth", str(Path(conf.logdir) / "ckpt"), "--hnm", "1",
            "--wnm", "1", "--tot_epoch", "2", "--synthetic", "--device",
            str(device), "--out_dir", str(tmp / "gen_tiles")])
        require_output(gen_out, (256, 256, 100))
        log("cli.generate from the trained checkpoint: 1x1 grid, 2 steps")
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
    want = {"rmsnorm": n_tiles * ATTN_K1_PER_TILE, "window_attention": 0}
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


def main() -> int:
    import numpy as np
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

    rows = check_kernels(device)
    rows.update(check_backward_kernels(device))
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
    int8_vs_bf16 = {}
    for path in ("int8", "int8_static"):
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
    for other in ("5d", "tile_major"):
        diff = np.abs(outs["packed"] - outs[other])
        log(f"full-width bf16 outputs, packed vs {other} on the same "
            f"weights and noise: max |d| {diff.max():.4g}, mean |d| "
            f"{diff.mean():.4g} (informative; the small f32 chains are the "
            "gate)")
    eval_outs = {p: outs[p] for p in ("packed", "int8")}
    del outs
    chains["stream"] = run_stream_path(device, chains["packed"]["counts"])
    chains["stream"].pop("out")
    main_path = chains["packed"]

    small_train = check_small_train_step(device)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        train = {path: run_training(device, path, Path(tmp))
                 for path in ("5d", "packed")}
        phase_s = {}
        t0 = time.perf_counter()
        attn = run_attn(device, train["5d"].pop("ckpt"), Path(tmp))
        phase_s["attn"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        evaluate = run_evaluate(device, eval_outs, Path(tmp),
                                int8_vs_bf16["int8"])
        phase_s["evaluate"] = time.perf_counter() - t0
        log(f"phase seconds: attn {phase_s['attn']:.1f}, evaluate "
            f"{phase_s['evaluate']:.1f}")
    del eval_outs
    attn["phase_seconds"], evaluate["phase_seconds"] = (phase_s["attn"],
                                                        phase_s["evaluate"])

    sources = {"rmsnorm": ("tera_mind_tpu_torch/csrc/rmsnorm.cu",
                           "tera_mind_tpu/ops/rmsnorm_kernel.py:60"),
               "window_attention": ("tera_mind_tpu_torch/csrc/attention.cu",
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
                                     "by_variant": attn["variants"][name]}},
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
            "window_attention", "tera_mind_tpu_torch/csrc/attention_bwd.cu",
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
                        "max_abs_err": max(x["max_abs_err"]
                                           for x in rows[name]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "shapes": rows[name]})
    quant_sources = {
        "quant_conv": ("tera_mind_tpu_torch/csrc/quant_conv.cu",
                       "tera_mind_tpu/ops/quant.py:58 (quant_conv2d; "
                       "not a Pallas kernel)"),
        "quantize": ("tera_mind_tpu_torch/csrc/quantize.cu",
                     "tera_mind_tpu/ops/quant.py:41 (quantize_tensor and "
                     "the a_scale branch :84-87; not a Pallas kernel)")}
    for name, (src, replaces) in quant_sources.items():
        r = max(rows[name], key=lambda x: x["bound_ms"])  # the largest
        by_path = {path: chains[path]["quant_launches"]
                   for path in ("int8", "int8_static")}
        main_q = by_path["int8"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(main_q[name].values()),
            "launches_by_variant": (
                main_q[name] if name == "quant_conv" else
                {**main_q["quantize"], "absmax": main_q["absmax"]}),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "shapes": rows[name],
            **({"bf16_conv_ms": r["bf16_conv_ms"],
                "bf16_conv": "cuDNN bf16 conv2d of the same shape: not the "
                             "same function, the path int8 has to beat"}
               if name == "quant_conv" else {})})
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
                      "evaluate": evaluate}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
