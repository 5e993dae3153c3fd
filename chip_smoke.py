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
  4. the kernels' autograd guard: each wrapper refuses a CUDA input that
     requires grad under grad mode (no backward kernels yet) and runs
     under ``torch.no_grad()``;
  5. the port on a small input on the card (float32, kernels on) against
     the same code on the CPU (plain versions), for the 5D model; the
     packed model (its weights packed from the 5D model's) on the card
     against the CPU, against the 5D model and with ``packed_attn``;
  6. resume on the card: the small packed chain spilled every step
     through ``StateCheckpoint('grid')`` and resumed from its epoch-1
     spill, against the uninterrupted chain;
  7. the main path: ``cli.generate.build`` with its defaults (the packed
     model) at the full width of the 638850 preset (2x2 tiles of 256^2 px
     x 100 channels, 15 DDIM steps, bf16, block-major, window_chunk 1),
     one warm-up step, then one timed chain with the kernels' launch
     counters (total and per variant) set to 0 just before it; then the
     same for the 5D model (``--no_packed``) on the same weights;
  8. a ``{"kernels": [...]}`` line, then the card line, then the result.

Any failure raises and exits non-zero.  Needs one CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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
    """(fn(*args), the variant of ``mod``'s kernel that the call launched)."""
    before = dict(mod.launches_by_variant)
    out = fn(*args)
    moved = [k for k, v in mod.launches_by_variant.items() if v != before[k]]
    require(len(moved) == 1, f"{mod.__name__}: launches {moved}")
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
             (41_472, 256), (10_368, 512), (32_768, 896)]
# (B, N, D) that the main path gives K2: encoder and collage decoder at
# resolution 16, and the middle block.
K2_SHAPES = [(324, 128, 256), (256, 128, 256), (324, 32, 512)]
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
    bms, by = bound(2 * (2 * n * c + c), 4 * n * c, H100_F32_FLOP_PER_S)
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
    """Each kernel against its plain version at every main-path shape
    (bf16 and f32) and at the edge shapes, with device times at the
    main-path shapes.  Returns {name: [row per main-path shape]}."""
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

    for n, c in K1_SHAPES:
        x = torch.randn(n, c, generator=g).to(device, bf16)
        w = (1 + 0.1 * torch.randn(c, generator=g)).to(device, bf16)
        out, ref, err_ulp, variant = k1_agrees(x, w, f"{n}x{c}")
        err = float((out.float() - ref.float()).abs().max())
        want = "vector" if c % 8 == 0 else "strided"
        require(variant == want, f"K1 {n}x{c} took {variant}, not {want}")
        # f32 input: the same variant's float instantiation
        _, _, errf, _ = k1_agrees(x[:4096].float(), w.float(), f"{n}x{c}")
        t = time_k1(k1, x, w, n, c)
        log(f"K1 rmsnorm ({n}, {c}) bf16 [{variant}]: max_abs_err {err:.3g} "
            f"({err_ulp:.2f} bf16 ulp, tol {K1_MAX_ULP}), f32 err {errf:.3g}; "
            + timing_text(t, "F.rms_norm"))
        rows["rmsnorm"].append(dict(shape=[n, c], variant=variant,
                                    max_abs_err=err, **t))

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

    for b, n, d in K2_SHAPES:
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
        log(f"K2 window_attention ({b}, {n}, {d}) bf16 [{variant}]: {agree} "
            f"(tol {K2_MAX_SPACINGS} spacings, {K2_MAX_SHARE}); f32 "
            f"[{variant_f}] err {errf:.3g}; " + timing_text(t, "SDPA"))
        rows["window_attention"].append(dict(shape=[b, n, d], variant=variant,
                                             max_abs_err=err, **t))
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
    return rows


# ---------------------------------------------------------------------------
# phase 4: the kernels' autograd guard
# ---------------------------------------------------------------------------

def check_autograd_guard(device) -> None:
    """Each kernel wrapper, as the model calls it, raises before the launch
    on a CUDA input that requires grad while grad mode is on, and runs
    the same call under ``torch.no_grad()``."""
    import torch

    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(256, 96, generator=g).to(device, torch.bfloat16)
    w = torch.ones(96, device=device, dtype=torch.bfloat16)
    q, k, v = (torch.randn(4, 32, 64, generator=g).to(device, torch.bfloat16)
               for _ in range(3))
    cases = (("rmsnorm", k1, k1.rmsnorm, (x, w), 0),
             ("window_attention", k2, k2.window_attention,
              (q, k, v, 1.0 / 64), 1))
    for name, mod, fn, args, leaf in cases:
        args = list(args)
        args[leaf] = args[leaf].detach().requires_grad_(True)
        before = mod.launches
        refused = None
        try:
            fn(*args)
        except RuntimeError as err:
            refused = str(err)
        require(refused is not None and "K1b and K2b" in refused,
                f"{name} ran on an input that requires grad: {refused}")
        require(mod.launches == before, f"{name} launched before refusing")
        with torch.no_grad():
            out = fn(*args)
        torch.cuda.synchronize()
        require(mod.launches == before + 1 and out.grad_fn is None
                and bool(torch.isfinite(out.float()).all()),
                f"{name} under no_grad: launches {mod.launches - before}")
        log(f"{name}: refused under grad mode ({refused[:60]}...), "
            "ran under no_grad")


# ---------------------------------------------------------------------------
# phases 5 and 6: the port on a small input, card against CPU, and resume
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


def small_chain(model, device, gconf, gene, **run_kw):
    """The 2x2-tile, 3-step block-major chain of ``model`` on ``device``."""
    import copy

    import numpy as np
    import torch

    from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                       SamplerConfig)
    from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
    from tera_mind_tpu_torch.models.nn import channels_last_
    from tera_mind_tpu_torch.parallel.generator import TeraGenerator

    if device.type == "cuda":
        model = channels_last_(copy.deepcopy(model).to(device))
    sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                               SamplerConfig(patch_size=32, gn_sz=2))
    gen = TeraGenerator(
        sampler, lambda xp, tm, rp, p1, p2: model(
            xp, tm, rp, p1, p2, decode_original=False),
        gconf, device=device)
    out = gen.run(gene, row0=1, col0=1, grid_w=16, progress=False, **run_kw)
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
# phase 7: the main path
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


# launches per chain: K1 norms and K2 attentions per UNet call x 25
# z-windows x 15 steps.  The packed model's 46 ResBlock and output norms
# are GroupedRMSNorm (plain PyTorch), so K1 runs only in the 6 DiT blocks
# (norm1, norm2, q_norm, k_norm) and the gene-gene block (q_norm, norm2).
CHAIN_LAUNCHES = {
    "packed": {"rmsnorm": 26 * 375, "window_attention": 6 * 375},
    "5d": {"rmsnorm": 83 * 375, "window_attention": 6 * 375}}


def run_main_path(device, packed: bool = True) -> dict:
    """``cli.generate.build`` with its defaults (or ``--no_packed``), one
    warm-up step, then the timed chain with the launch counters set to 0
    just before it and read just after it."""
    import numpy as np
    import torch

    from tera_mind_tpu_torch.cli import generate
    from tera_mind_tpu_torch.models.attention import CrossAttention
    from tera_mind_tpu_torch.models.nn import RMSNorm
    from tera_mind_tpu_torch.ops import attention_kernel as k2
    from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

    path = "packed" if packed else "5d"
    args = generate.parse_args(["--synthetic", "--hnm", str(GRID),
                                "--wnm", str(GRID), "--tot_epoch",
                                str(STEPS), "--device", str(device)]
                               + ([] if packed else ["--no_packed"]))
    t0 = time.perf_counter()
    gen, model, gene, (row0, col0) = generate.build(args)
    # K1 runs in every RMSNorm itself; its GroupedRMSNorm subclass is
    # plain PyTorch
    norms = [m.weight.numel() for m in model.modules()
             if type(m) is RMSNorm]
    n_norm, n_vec = len(norms), sum(c % 8 == 0 for c in norms)
    n_attn = sum(isinstance(m, CrossAttention) for m in model.modules())
    calls = gen.conf.n_win // gen._wchunk() * STEPS
    want = {"rmsnorm": n_norm * calls, "window_attention": n_attn * calls}
    want_variants = {
        "rmsnorm": {"strided": (n_norm - n_vec) * calls,
                    "vector": n_vec * calls},
        "window_attention": {"cuda_core": 0,
                             "tensor_core": n_attn * calls}}
    log(f"main path [{path}]: 638850 {type(model).__name__} "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params "
        f"bf16, {n_norm} K1 RMSNorm ({n_vec} with C % 8 == 0) + {n_attn} "
        f"CrossAttention per UNet call, "
        f"{calls} UNet calls per chain; built in "
        f"{time.perf_counter() - t0:.1f} s")

    state0 = torch.as_tensor(gen.init_state(GRID, GRID, row0=row0,
                                            col0=col0), device=device)
    t0 = time.perf_counter()
    gen.compile_step(GRID, GRID)(state0, torch.as_tensor(gene, device=device),
                                 STEPS - 1)
    torch.cuda.synchronize()
    log(f"warm-up step: {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    smi_proc = start_card_sampler()
    try:
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        out = gen.run(gene, row0=row0, col0=col0, grid_w=416, progress=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        card = stop_card_sampler(smi_proc)
    got = {"rmsnorm": k1.launches, "window_attention": k2.launches}
    got_variants = {"rmsnorm": dict(k1.launches_by_variant),
                    "window_attention": dict(k2.launches_by_variant)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"chain [{path}]: {GRID}x{GRID} tiles x {STEPS} steps in "
        f"{secs:.2f} s = {GRID * GRID / secs:.5f} tiles/s; peak device "
        f"memory {peak:.2f} GiB; launches {got} (expected {want}), by "
        f"variant {got_variants} (expected {want_variants}); {card}")

    require(out.shape == (GRID * 256, GRID * 256, 100), f"shape {out.shape}")
    require(bool(np.isfinite(out).all()), "non-finite output")
    require(out.min() >= -1.0 and out.max() <= 1.0,
            f"output outside [-1, 1]: [{out.min()}, {out.max()}]")
    require(got == want, f"launches {got}, expected {want}")
    require(want == CHAIN_LAUNCHES[path],
            f"per-chain launch counts {want} differ from the {path} "
            f"model's {CHAIN_LAUNCHES[path]}")
    require(got_variants == want_variants,
            f"launches by variant {got_variants}, expected {want_variants}")
    log(f"output {out.shape} in [{out.min():.4f}, {out.max():.4f}], "
        f"mean {out.mean():.4f}, std {out.std():.4f}")
    del gen, model
    torch.cuda.empty_cache()
    return dict(launches=got, variants=got_variants, seconds=secs,
                tiles_per_s=GRID * GRID / secs, peak_gib=peak, out=out)


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
    check_autograd_guard(device)
    small = check_small_chain(device)
    for name, err in small["errs"].items():
        log(f"small chain {name}: max_abs_err {err:.3g} (tol {SMALL_ATOL})")
    err = check_resume(device, small["packed"], small["out"])
    log(f"resume from the epoch-1 float16 spill vs uninterrupted: "
        f"max_abs_err {err:.3g} (tol {RESUME_ATOL})")
    chains = {"packed": run_main_path(device, packed=True),
              "5d": run_main_path(device, packed=False)}
    diff = np.abs(chains["packed"].pop("out") - chains["5d"].pop("out"))
    log(f"full-width bf16 outputs, packed vs 5d on the same weights and "
        f"noise: max |d| {diff.max():.4g}, mean |d| {diff.mean():.4g} "
        "(informative; the small f32 chain is the gate)")
    main_path = chains["packed"]

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
                            path: {"launches": c["launches"][name],
                                   "by_variant": c["variants"][name]}
                            for path, c in chains.items()},
                        "max_abs_err": max(x["max_abs_err"]
                                           for x in rows[name]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "shapes": rows[name]})
    print(json.dumps({"kernels": kernels, "chain_seconds":
                      main_path["seconds"], "tiles_per_s":
                      main_path["tiles_per_s"],
                      "chains": {p: {k: c[k] for k in ("seconds",
                                                       "tiles_per_s",
                                                       "peak_gib")}
                                 for p, c in chains.items()}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
