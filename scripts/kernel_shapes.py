"""The shapes a generation path gives K1 and K2, and how often, per chain.

    python scripts/kernel_shapes.py [--no_packed] [--patches N --chunk W
                                                   --visits V]

Runs one UNet call of the 638850 preset (bf16, patches of 64^2 px,
collage decoder only, as ``cli.generate`` calls it: the z-packed
``PackedTeraUNet`` by default, the 5D ``TeraUNet`` with ``--no_packed``)
on PyTorch's ``meta`` device, with K1 and K2 replaced by stand-ins that
record their input shapes: no data, no card, about a second on a CPU.
One call takes ``--chunk`` z-windows of ``--patches`` patches each (a
square: 81 for the block-major grid of a 2x2-tile block, the default;
25 for one tile's halo window, the tile-major step).  Prints each
(rows, C) of K1 and (B, N, D) of K2 with its launches per UNet call and
per chain (25 / chunk calls per z-window sweep, ``--visits`` sweeps a
step: the tiles of the tile-major step, the windows of a streamed grid),
and for each variant the bytes one step moves through it (inputs read
once, output written once) and the least time the H100's 3.35 TB/s
allows for them: the yardstick for the variant's device time per step
in scripts/profile_torch_step.py.

    main path, block-major 2x2:    (defaults)
    tile-major 2x2 (chunk 5):      --patches 25 --chunk 5 --visits 4
    streamed 4x4 in 2x2 windows:   --patches 81 --chunk 5 --visits 4

    python scripts/kernel_shapes.py --ranks N [--grid G] [--stream]
        [--steps S]

``--ranks`` lists the shapes and launches of each rank of ``cli.generate``
over N processes on a G x G grid (``--grid``, default 2): in memory, rank
i's block of an (N, 1) mesh, planned as the card plans it (the first of
``plan_candidates``: for a 1 x 2 block, 5 x 9 = 45 patches a z-window,
one z-window a call) with the planner's one probe call at that batch;
with ``--stream`` (G 4), rank i's row band (``band_partition``) in 2x2
windows at streaming's window_chunk (5), over ``--steps`` (default 15).

    python scripts/kernel_shapes.py --quant int8|int8_static [--no_quant_attn]
        [--patches N --chunk W --visits V]

``--quant`` runs the prequantized int8 packed model (``cli.generate
--quant``; with ``int8_static`` its static-activation form) instead and
lists, per UNet call and per chain, K3's (x (B, H, W, Ci), w (Co, kh,
kw)) shapes with the plan ``ops/quant_kernel.py::k3_plan`` gives each
(its variant, TMA box, BN and grid) and K3's launches by variant,
K4's (rows, C, multiple) by variant (``dynamic`` or ``static``, one
launch either way) and ``torch._int_mm``'s (M, K_pad, N), with the int8
operations and the bytes K3 and K4 move a step.

    python scripts/kernel_shapes.py --train [--packed | --method M]
        [--ranks N]

``--train`` runs one training forward of the preset instead: the 5D
``TeraUNet`` (``--packed``: ``PackedTeraUNet(from_5d=True)``; ``--method
patch-dm`` or ``sinf``: that baseline, whose only kernel is K1 in the RNA
tower's gene block) with
float32 parameters and bf16 compute, on one microbatch of ``cli.train``'s
defaults (batch 32: 32 samples, each a 2x2 block of 64^2 patches, so 128
patches, both decoders), and counts it for one step of ``accum``
microbatches (2).  In training every K1 and K2 input requires grad, so
each launch records one backward launch: K1b takes K1's (rows, C) and K2b
K2's (B, N, D), as often; it also prints the launches a step of each
K1b and K2b variant (bf16, aligned tensors) and the bytes a step of each
K1, K1b, K2 and K2b variant with their byte bound.  With ``--ranks N`` it runs
one rank of ``cli.train`` over N processes instead (data parallel: each
rank's microbatch is 32 / N samples, ``accum`` microbatches a step, so
its launches a step are one process's), and prints each shape's bound on
the H100 for K1, K1b, K2 and K2b (``--method`` ours only).

    python scripts/kernel_shapes.py --attn

``--attn`` runs ``cli.attn``'s extractor (``models/unet_attn.py``, float32)
on one tile of the preset instead: its 16 patches of 4x4 gene bins
(``--patches`` does not apply), and lists K1's (rows, C) with its launches
a tile and a 16x16-tile ROI (``--pathway ROI``), its variant, and the
bytes one launch moves with their bound on the H100.  K1 is the
extraction's only kernel: the G x G product stays ``torch.matmul``.

    python scripts/kernel_shapes.py --mouse 609882 [--patch 32|64|128]
        [--to_hbr] [--stain DAPI|PolyT|all] [--rna_slc 1|4|8|16]
        [--batch B] [--train [--packed] | --quant int8 | ...]

``--mouse``, ``--patch``, ``--to_hbr``, ``--stain`` and ``--rna_slc`` pick
the preset as ``cli.train`` does (500 genes for 609882 and 609889, 229
for 638850, the 81-gene M2H panel with ``--to_hbr``; ``in_channels`` =
stains x ceil(rna_slc / 2)), and ``--batch`` its global batch (``accum``
= 64 // batch microbatches of ``batch`` samples); every listing above
then runs that preset.  Generation is planned as ``cli.generate`` plans
a 2x2-tile block on the card when its first candidate fits
(``plan_candidates``): patch 64 the whole block, 9x9 patches a z-window;
patch 32 two strips of 9x17; patch 128 the whole block, 5x5; one
z-window a call, ``n_win`` z-windows (25 at 4 RNA slices, 12 at 8, 6 at
16).  ``chain_prediction`` and ``train_prediction`` give a path's
launches by shape and by variant, which ``chip_smoke.py``'s preset
phase requires.

K5 (the packed model's ``GroupedRMSNorm``) is recorded as (rows,
segments, Z) and with the epilogue each launch takes (``none``, ``silu``,
``modulate_silu``: 29 SiLU and 28 modulate launches a 638850 UNet call;
``none`` wherever autograd records, as in training) and its prologue
(``bias``: in generation each ResBlock's ``out_norm`` adds ``in_conv``'s
bias, 28 a call; ``none`` elsewhere); the default listing prints the
launches by epilogue and prologue and the bytes of the eager passes the
epilogues leave out a step (236.91 GB on the block-major 2x2 path).
K6 (the ResBlocks' residual sum with their convs' biases,
``ops/residual_kernel.py``) is recorded as (rows, width, skip), skip
``conv`` (the skip conv's product and bias) or ``x`` (the block's
input): one a ResBlock in generation (28 a 638850 UNet call), none in
training (autograd records) or int8; the default listing prints its
launches, bytes and byte bound a step, and the bytes of the eager passes
that the bias prologue and K6 leave out.

The DiT blocks' fold: K1 is also recorded as (rows, C, epilogue),
``modulate`` where a DiT block's norm1 / norm2 launches with the adaLN
modulate (``ops/rmsnorm_kernel.rmsnorm_modulate``: 12 a 638850 UNet call
on every generation path, int8 included; ``none`` for every other K1
launch and wherever autograd records), and K7 (the DiT block's gated
residual, ``ops/gated_residual_kernel.py``) as (rows, C): 12 a UNet call
in generation, none in training.  The default listing prints K1's
launches by epilogue, K7's shapes, launches, bytes and byte bound, and
the bytes of the eager passes the fold removes.
"""

from __future__ import annotations

import argparse
import math
import sys
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import STEPS, bound, kernel_work  # noqa: E402
from tera_mind_tpu_torch.config import prep_config  # noqa: E402
from tera_mind_tpu_torch.constants import M2H  # noqa: E402
from tera_mind_tpu_torch.models import attention as attention_mod  # noqa: E402
from tera_mind_tpu_torch.models import nn as nn_mod  # noqa: E402
from tera_mind_tpu_torch.models import unet_packed as packed_mod  # noqa: E402
from tera_mind_tpu_torch.models.unet_packed import (  # noqa: E402
    make_packed_model)
from tera_mind_tpu_torch.ops import quant_kernel as qk  # noqa: E402
from tera_mind_tpu_torch.ops._build import autograd_required  # noqa: E402
from tera_mind_tpu_torch.ops.grouped_rmsnorm_kernel import (  # noqa: E402
    EPILOGUES as K5_EPILOGUES, PROLOGUES as K5_PROLOGUES,
    VARIANTS as K5_VARIANTS, grouped_variant)
from tera_mind_tpu_torch.ops.residual_kernel import (  # noqa: E402
    VARIANTS as K6_VARIANTS, residual_variant, skip_kind)
from tera_mind_tpu_torch.ops.gated_residual_kernel import (  # noqa: E402
    VARIANTS as K7_VARIANTS, gated_variant)
from tera_mind_tpu_torch.ops.attention_kernel import (  # noqa: E402
    BWD_VARIANTS as K2B_VARIANTS, VARIANTS as K2_VARIANTS,
    attention_bwd_variant, attention_variant)
from tera_mind_tpu_torch.ops.rmsnorm_kernel import (  # noqa: E402
    EPILOGUES as K1_EPILOGUES, VARIANTS as K1_VARIANTS,
    rmsnorm_bwd_variant, rmsnorm_modulate_variant, rmsnorm_variant)
from tera_mind_tpu_torch.parallel.band import band_partition  # noqa: E402
from tera_mind_tpu_torch.parallel.generator import (  # noqa: E402
    GeneratorConfig, plan_candidates)

PATCHES = 81       # 9x9 patches of one z-window's padded 2x2-tile block
WINDOWS = 25       # z-windows of the 638850 preset, one UNet call each
H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak
BF16 = 2           # bytes an element
TRAIN_BATCH = 32    # cli.train's default --batch: samples a microbatch
TRAIN_ACCUM = 2     # 64 // batch microbatches a step


def preset_conf(mouse: str = "638850", patch: int = 64,
                to_hbr: bool = False, stain: str = "all", rna_slc: int = 4,
                batch: int = TRAIN_BATCH, method: str = "ours"):
    """``cli.train``'s ``TrainConfig`` for these flags (its rule for the
    gene panel: 81 M2H genes with ``to_hbr``, else 229 for 638850 and
    500 for the other mice)."""
    nrna = len(M2H) if to_hbr else (229 if mouse == "638850" else 500)
    return prep_config(mouse, batch=batch, size=patch, stain=stain,
                       nrna=nrna, srna=rna_slc, method=method)


def gen_config(conf) -> GeneratorConfig:
    """``cli.generate``'s ``GeneratorConfig`` for ``conf`` (256 px tiles,
    50 z-slices, 500 genes carried)."""
    return GeneratorConfig(patch=conf.image_size, snum=conf.rna_slices,
                           stains=2 if conf.stain == "all" else 1)


def gen_plan(conf, grid: int = 2) -> dict:
    """The block-major plan of a grid x grid block for ``conf``'s preset
    when the planner's first candidate fits: the patch grid (p1, p2) of a
    strip's z-window, the z-windows a call (chunk), the strips a step
    (visits), the z-windows and the UNet calls a step."""
    gc = gen_config(conf)
    tm, sr, wc = plan_candidates(grid, grid, gc)[0]
    if tm:
        raise ValueError(f"a {grid}x{grid} block plans tile-major")
    tpp = gc.tile // gc.patch
    rows = sr or grid
    return dict(patches=(rows * tpp + 1, grid * tpp + 1), chunk=wc,
                visits=grid // rows, windows=gc.n_win,
                calls=gc.n_win // wc * (grid // rows))


@contextmanager
def recording(k1: Counter, k2: Counter, k5: Counter = None,
              k5_act: Counter = None, k6: Counter = None,
              k1_act: Counter = None, k7: Counter = None):
    """Stand-ins for K1, K2, K5, K6 and K7 that record their input
    shapes: K1 (rows, C) and, in ``k1_act``, (rows, C, epilogue) (the DiT
    blocks' ``rmsnorm_modulate`` launches with ``modulate``, but where
    autograd records, as its dispatcher then runs ``rmsnorm`` and the
    eager modulate), K2 (B, N, D), K5 (rows, segments, Z) into ``k5`` (or
    a Counter of its own) and (rows, segments, Z, epilogue, B, prologue)
    into ``k5_act`` (the epilogue K5 launches with: ``none`` where
    autograd records, as the dispatcher runs the eager epilogue after the
    Function there; B the batches of the modulate's scale and shift, 0
    without it; prologue ``bias`` where the call adds a conv's bias, else
    ``none``), K6 (rows, width, skip) into ``k6``, K7 (rows, C) into
    ``k7`` (none where autograd records): every packed call must be
    stubbed on the meta device, where the dispatchers have no path."""
    k5 = Counter() if k5 is None else k5
    k5_act = Counter() if k5_act is None else k5_act
    k6 = Counter() if k6 is None else k6
    k1_act = Counter() if k1_act is None else k1_act
    k7 = Counter() if k7 is None else k7

    def rmsnorm(x, weight, eps=1e-6, epilogue="none"):
        key = (x.numel() // x.shape[-1], x.shape[-1])
        k1[key] += 1
        k1_act[key + (epilogue,)] += 1
        return torch.empty_like(x)

    def rmsnorm_modulate(x, weight, scale, shift, eps=1e-6):
        grad = autograd_required(x, weight, scale, shift)
        return rmsnorm(x, weight, eps, "none" if grad else "modulate")

    def gated_residual(x, gate, y):
        if not autograd_required(x, gate, y):
            k7[(x.numel() // x.shape[-1], x.shape[-1])] += 1
        return torch.empty_like(x)

    def window_attention(q, k, v, scale):
        k2[tuple(q.shape)] += 1
        return torch.empty_like(q)

    def grouped_rmsnorm_act(x, weight, z, segments, eps=1e-6,
                            from_5d=False, act="none", scale=None,
                            shift=None, bias=None):
        key = (x.numel() // x.shape[-1], tuple(segments), z)
        k5[key] += 1
        mod = [t for t in (scale, shift, bias) if t is not None]
        if autograd_required(x, weight, *mod):
            act = "none"
        k5_act[key + (act, scale.shape[0] if act == "modulate_silu"
                      else 0, K5_PROLOGUES[bias is not None])] += 1
        return torch.empty_like(x)

    def residual(h, h_bias, s, s_bias=None):
        k6[(h.numel() // h.shape[-1], h.shape[-1], skip_kind(s_bias))] += 1
        return torch.empty_like(h)

    saved = (nn_mod.rmsnorm, attention_mod.window_attention,
             packed_mod.grouped_rmsnorm_act, packed_mod.residual,
             attention_mod.rmsnorm_modulate, attention_mod.gated_residual)
    (nn_mod.rmsnorm, attention_mod.window_attention,
     packed_mod.grouped_rmsnorm_act, packed_mod.residual,
     attention_mod.rmsnorm_modulate, attention_mod.gated_residual) = (
        rmsnorm, window_attention, grouped_rmsnorm_act, residual,
        rmsnorm_modulate, gated_residual)
    try:
        yield
    finally:
        (nn_mod.rmsnorm, attention_mod.window_attention,
         packed_mod.grouped_rmsnorm_act, packed_mod.residual,
         attention_mod.rmsnorm_modulate,
         attention_mod.gated_residual) = saved


def by_epilogue(k5_act: Counter, times: int = 1) -> dict:
    """K5's launches by epilogue (every epilogue named) of ``k5_act``
    ((rows, segments, Z, epilogue, B) -> launches) times ``times``."""
    out = dict.fromkeys(K5_EPILOGUES, 0)
    for key, n in k5_act.items():
        out[key[3]] += n * times
    return out


def by_prologue(k5_act: Counter, times: int = 1) -> dict:
    """K5's launches by prologue (``none``, ``bias``) of ``k5_act``
    times ``times``."""
    out = dict.fromkeys(K5_PROLOGUES, 0)
    for key, n in k5_act.items():
        out[key[5]] += n * times
    return out


def eager_epilogue_bytes(k5_act: Counter, times: int) -> Counter:
    """{epilogue: bytes} that the eager passes after ``times`` rounds of
    the K5 launches ``k5_act`` would move in bf16 (each pass reads and
    writes the norm's whole output: one SiLU, or the modulate's product
    and sum and the SiLU), which the fused epilogue leaves out."""
    passes = {"none": 0, "silu": 1, "modulate_silu": 3}
    out = Counter()
    for (rows, segments, z, act, _, _), n in k5_act.items():
        out[act] += n * times * passes[act] * 2 * BF16 * rows * z * sum(
            segments)
    return out


def k1_by_epilogue(k1_act: Counter, times: int = 1) -> dict:
    """K1's launches by epilogue (``none``, ``modulate``) of ``k1_act``
    ((rows, C, epilogue) -> launches) times ``times``."""
    out = dict.fromkeys(K1_EPILOGUES, 0)
    for key, n in k1_act.items():
        out[key[2]] += n * times
    return out


def dit_fold_bytes(k1_act: Counter, k7: Counter, times: int) -> Counter:
    """{pass: bytes} of ``times`` rounds of the DiT blocks' eager passes
    that K1's modulate epilogue (``k1_act``) and K7 (``k7``) take the
    place of, in bf16, in units of one (rows, C) map: the modulate's
    ``scale + 1.0`` (reads the scale chunk, writes a map: 2), its product
    and its sum (3 each), the gated residual's product and sum (3 each);
    and what the fold moves instead: ``K1 modulate`` (the scale and shift
    K1 now reads, 2) and ``K7`` (``kernel_work``: reads x, the gate and
    y, writes one map)."""
    out = Counter()
    for (rows, c, epi), n in k1_act.items():
        if epi == "modulate":
            unit = n * times * BF16 * rows * c
            out["modulate"] += 8 * unit
            out["K1 modulate"] += 2 * unit
    for (rows, c), n in k7.items():
        out["gated residual"] += 6 * n * times * BF16 * rows * c
        out["K7"] += n * times * kernel_work("K7", (rows, c))[0]
    return out


def fold_bytes(k5_act: Counter, k6: Counter, times: int) -> Counter:
    """{pass: bytes} of ``times`` rounds of the eager passes that K5's
    bias prologue (``k5_act``) and K6 (``k6``) take the place of, in bf16:
    ``in_conv``'s bias add before the norm, ``out_conv``'s and
    ``skip_conv``'s bias adds (each reads and writes the map) and the
    residual sum (reads two maps, writes one); and ``K6`` itself (reads
    two, writes one, and its biases), which the fold adds."""
    out = Counter()
    for (rows, segments, z, _, _, pro), n in k5_act.items():
        if pro == "bias":
            out["in_conv bias"] += n * times * 2 * BF16 * rows * z * sum(
                segments)
    for (rows, width, skip), n in k6.items():
        unit = n * times * BF16 * rows * width
        out["out_conv bias"] += 2 * unit
        out["skip_conv bias"] += 2 * unit * (skip == "conv")
        out["residual sum"] += 3 * unit
        out["K6"] += n * times * kernel_work("K6", (rows, width, skip))[0]
    return out


def patch_grid(conf, patches: int = None, grid: tuple = None) -> tuple:
    """(p1, p2): ``grid``, else a square of ``patches``, else the plan's
    (:func:`gen_plan`)."""
    if grid is not None:
        return tuple(grid)
    if patches is None:
        return gen_plan(conf)["patches"]
    side = math.isqrt(patches)
    if side * side != patches:
        raise ValueError(f"{patches} patches a z-window is not a square grid")
    return side, side


def per_call_shapes(packed: bool = True, patches: int = None,
                    chunk: int = 1, grid: tuple = None, conf=None,
                    k5: Counter = None, k5_act: Counter = None,
                    k6: Counter = None, k1_act: Counter = None,
                    k7: Counter = None) -> tuple[Counter, Counter]:
    """(K1 (rows, C) -> launches, K2 (B, N, D) -> launches) of one UNet
    call on ``chunk`` z-windows of ``patches`` patches each (a square, or
    a ``grid`` of p1 x p2 patches; default the preset's plan), for the
    packed model or the 5D one, of ``conf``'s preset (default 638850);
    ``k5`` gets K5's (rows, segments, Z) -> launches, ``k5_act`` its
    (rows, segments, Z, epilogue, B, prologue) -> launches, ``k6`` K6's
    (rows, width, skip) -> launches, ``k1_act`` K1's (rows, C, epilogue)
    -> launches, ``k7`` K7's (rows, C) -> launches."""
    conf = conf or preset_conf()
    p1, p2 = patch_grid(conf, patches, grid)
    patches = p1 * p2
    conf = conf.make_model_conf()
    k1, k2 = Counter(), Counter()
    # generation runs the model under inference mode: no autograd records
    with recording(k1, k2, k5, k5_act, k6, k1_act, k7), \
            torch.device("meta"), torch.no_grad():
        model = make_packed_model(conf) if packed else conf.make_model()
        model = model.to(torch.bfloat16)
        p = conf.image_size
        x = torch.empty(chunk * patches, p, p, conf.in_channels)
        rna = torch.empty(chunk * patches, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(chunk, dtype=torch.long), rna, p1, p2,
              decode_original=False)
    return k1, k2


TILE_PATCHES = 4        # 256 px tiles of 64 px patches a side
STREAM_BLOCK = 2        # cli.generate's --stream_block
MAX_PATCHES = 600       # TMT_MAX_PATCHES, streaming's window_chunk bound


def rank_runs(ranks: int, grid: int, stream: bool = False) -> list:
    """What each rank of ``cli.generate`` over ``ranks`` processes runs on
    a grid x grid tile grid: [{rank, block (r0, rows, cols), patches
    (p1, p2) a z-window, chunk (z-windows a call), visits (patch grids a
    step), probes (planner calls)}].  In memory: an (N, 1) mesh's block,
    block-major, planned (the first candidate; one probe call); streamed:
    the band of ``band_partition`` in 2x2-tile windows."""
    conf = GeneratorConfig()
    out = []
    for rank in range(ranks):
        if stream:
            r0, rows = band_partition(grid, ranks, rank)
            br, bc = min(STREAM_BLOCK, rows), min(STREAM_BLOCK, grid)
            n_r = len({min(r, rows - br) for r in range(0, rows, br)})
            n_c = len({min(c, grid - bc) for c in range(0, grid, bc)})
            p1, p2 = br * TILE_PATCHES + 1, bc * TILE_PATCHES + 1
            chunk = max(d for d in range(1, WINDOWS + 1)
                        if WINDOWS % d == 0 and d * p1 * p2 <= MAX_PATCHES)
            out.append(dict(rank=rank, block=(r0, rows, grid),
                            patches=(p1, p2), chunk=chunk,
                            visits=n_r * n_c, probes=0))
            continue
        if grid % ranks:
            raise ValueError(f"{grid} tile rows over {ranks} ranks")
        rows = grid // ranks
        tm, sr, wc = plan_candidates(rows, grid, conf)[0]
        if tm:
            raise ValueError(f"a {rows}x{grid} block plans tile-major")
        p1 = (sr or rows) * TILE_PATCHES + 1
        out.append(dict(rank=rank, block=(rank * rows, rows, grid),
                        patches=(p1, grid * TILE_PATCHES + 1), chunk=wc,
                        visits=rows // (sr or rows), probes=1))
    return out


def rank_launches(run: dict, steps: int = STEPS) -> tuple:
    """(K1 launches, K2 launches, UNet calls) of one rank's ``run`` over
    ``steps`` steps, the planner's probe calls included."""
    k1, k2 = per_call_shapes(grid=run["patches"], chunk=run["chunk"])
    calls = WINDOWS // run["chunk"] * run["visits"] * steps + run["probes"]
    return sum(k1.values()) * calls, sum(k2.values()) * calls, calls


def main_ranks(ranks: int, grid: int, stream: bool, steps: int) -> None:
    print(f"cli.generate over {ranks} ranks, {grid}x{grid} tiles, "
          f"{'band-parallel --stream' if stream else 'in memory'}, "
          f"{steps} steps")
    for run in rank_runs(ranks, grid, stream):
        k1, k2 = per_call_shapes(grid=run["patches"], chunk=run["chunk"])
        n1, n2, calls = rank_launches(run, steps)
        r0, rows, cols = run["block"]
        print(f"rank {run['rank']}: tile rows {r0}..{r0 + rows} x {cols} "
              f"cols, {run['patches'][0]}x{run['patches'][1]} patches a "
              f"z-window, {run['chunk']} z-windows a call, {run['visits']} "
              f"patch grids a step, {calls} UNet calls "
              f"({run['probes']} planner probe): K1 {n1}, K2 {n2}")
        for name, counts in (("  K1 (rows, C)", k1),
                             ("  K2 (B, N, D)", k2)):
            for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
                print(f"{name} {shape}: {n} per call, {n * calls} per "
                      "chain")


@contextmanager
def quant_recording(k3: Counter, k4: Counter, mm: Counter):
    """Stand-ins for K3, K4 and ``torch._int_mm`` that record their
    shapes: K3 ((B, H, W, Ci), (Co, kh, kw)), K4 (rows, C, multiple,
    variant), the product (M, K_pad, N)."""
    true_ci = {}   # id of a quantized activation -> its unpadded C

    def quantize(x, a_scale=None, multiple=qk.CONV_ALIGN):
        cols = x.shape[-1]
        k4[(x.numel() // cols, cols, multiple,
            qk.quantize_variant(a_scale))] += 1
        q = torch.empty(*x.shape[:-1], qk.round_up(cols, multiple),
                        dtype=torch.int8)
        true_ci[id(q)] = cols
        s = torch.empty((), dtype=torch.float32)
        return q, s, (s if a_scale is None else None)

    def quant_conv(xq, wq, w_scale=None, bias=None,
                   out_dtype=torch.bfloat16, x_scale=None):
        co, kh, kw, _ = wq.shape
        k3[(tuple(xq.shape[:3]) + (true_ci[id(xq)],), (co, kh, kw))] += 1
        return torch.empty(*xq.shape[:3], co, dtype=out_dtype)

    def int8_mm(a, b):
        mm[(a.shape[0], a.shape[1], b.shape[0])] += 1
        return torch.empty(a.shape[0], b.shape[0], dtype=torch.int32)

    saved = qk.quantize, qk.quant_conv, qk.int8_mm
    qk.quantize, qk.quant_conv, qk.int8_mm = quantize, quant_conv, int8_mm
    try:
        yield
    finally:
        qk.quantize, qk.quant_conv, qk.int8_mm = saved


def k3_variants(k3: Counter) -> dict:
    """K3's launches by variant for its shapes -> launches (``k3_plan``'s
    rule; every variant named, 0 where none launches)."""
    out = dict.fromkeys(qk.CONV_VARIANTS, 0)
    for (x_shape, w_shape), n in k3.items():
        out[qk.k3_plan(x_shape, w_shape).variant] += n
    return out


def quant_shapes(quant: str = "int8", attn: bool = True,
                 patches: int = None, chunk: int = 1, conf=None,
                 grid: tuple = None, k12: tuple = None
                 ) -> tuple[Counter, Counter, Counter]:
    """(K3, K4, ``_int_mm``) shapes -> launches of one UNet call of the
    prequantized int8 packed model (``cli.generate --quant``) of
    ``conf``'s preset (default 638850; the patch grid as
    :func:`per_call_shapes` takes it), as :func:`quant_recording` keys
    them; ``k12``: two Counters that get its K1 and K2 shapes (and a third
    that gets K5's, a fourth K5's with their epilogues, a fifth K6's, a
    sixth K1's with their epilogues, a seventh K7's)."""
    conf = conf or preset_conf()
    p1, p2 = patch_grid(conf, patches, grid)
    conf = conf.make_model_conf()
    k3, k4, mm = Counter(), Counter(), Counter()
    with quant_recording(k3, k4, mm), recording(
            *(k12 or (Counter(), Counter()))), torch.device("meta"), \
            torch.no_grad():
        model = make_packed_model(conf, quant="int8", prequant=True,
                                  static_act=quant == "int8_static",
                                  quant_attn=attn).to(torch.bfloat16)
        p = conf.image_size
        x = torch.empty(chunk * p1 * p2, p, p, conf.in_channels)
        rna = torch.empty(chunk * p1 * p2, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(chunk, dtype=torch.long), rna, p1, p2,
              decode_original=False)
    return k3, k4, mm


def main_quant(quant: str, attn: bool, patches: int, chunk: int,
               visits: int, conf=None) -> None:
    conf = conf or preset_conf()
    windows = gen_config(conf).n_win
    if patches is None:
        visits = gen_plan(conf)["visits"] * visits
    per_step = windows // chunk * visits
    calls = STEPS * per_step
    k3, k4, mm = quant_shapes(quant, attn, patches, chunk, conf)
    print(f"PackedTeraUNet --quant {quant}"
          + ("" if attn else " --no_quant_attn"))
    ops = sum(2 * b * h * w * co * kh * kw * ci * n
              for ((b, h, w, ci), (co, kh, kw)), n in k3.items())
    nbytes = sum((b * h * w * (qk.round_up(ci, qk.CONV_ALIGN) + BF16 * co)
                  + co * kh * kw * qk.round_up(ci, qk.CONV_ALIGN) + 8 * co)
                 * n for ((b, h, w, ci), (co, kh, kw)), n in k3.items())
    for name, counts in (("K3 quant_conv (x (B, H, W, Ci), w (Co, kh, kw))",
                          k3),
                         ("K4 quantize (rows, C, multiple, variant)", k4),
                         ("torch._int_mm (M, K_pad, N)", mm)):
        print(f"{name}: {sum(counts.values())} per UNet call, "
              f"{sum(counts.values()) * calls} per chain of {calls} calls")
        for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"  {shape}: {n} per call, {n * calls} per chain")
    for (x_shape, w_shape), n in sorted(k3.items()):
        p = qk.k3_plan(x_shape, w_shape)
        print(f"  K3 plan x {x_shape} w {w_shape}: {p.variant}, box "
              f"{p.box}, BN {p.bn}, {p.stages} stages, "
              f"{p.units} units on a grid of {p.grid}")
    print(f"K3 launches by variant: {k3_variants(k3)} per call")
    # the function's bytes: x read once, q written once (the dynamic
    # kernel reads x a second time for the abs-max where x passes the L2)
    k4_bytes = sum(rows * (BF16 * c + qk.round_up(c, m)) * n
                   for (rows, c, m, _), n in k4.items())
    print(f"K3: {ops / 1e12:.3f} T int8 operations a call, "
          f"{ops * per_step / 1e12:.1f} T a step: "
          f"{ops * per_step / H100_INT8_OPS * 1e3:.1f} ms a step at the "
          f"H100's {H100_INT8_OPS / 1e12:.0f} TOPS; "
          f"{nbytes * per_step / 1e9:.3f} GB a step")
    print(f"K4: {k4_bytes * per_step / 1e9:.3f} GB a step, byte bound "
          f"{k4_bytes * per_step / H100_BYTES_PER_S * 1e3:.2f} ms a step")


def train_shapes(packed: bool = False, batch: int = None,
                 method: str = "ours", conf=None, k5: Counter = None,
                 k5_act: Counter = None, k6: Counter = None,
                 k1_act: Counter = None, k7: Counter = None
                 ) -> tuple[Counter, Counter]:
    """(K1 (rows, C) -> launches, K2 (B, N, D) -> launches) of one
    training forward on a microbatch of ``batch`` samples (default the
    preset's, ``conf.batch_size``; 2x2 blocks of patches, both decoders)
    of ``method``'s model on ``conf``'s preset (default 638850); K1b and
    K2b get the same, and K5b ``k5``'s K5 shapes (the packed model's
    GroupedRMSNorm, every input of which requires grad); ``k6`` K6's
    and ``k7`` K7's shapes (none: autograd records, so the ResBlocks and
    the DiT blocks run eagerly), ``k1_act`` K1's by epilogue (all
    ``none``)."""
    conf = conf or preset_conf(method=method)
    batch = batch or conf.batch_size
    conf = conf.make_model_conf()
    k1, k2 = Counter(), Counter()
    with recording(k1, k2, k5, k5_act, k6, k1_act, k7), \
            torch.device("meta"):
        model = (make_packed_model(conf, torch.float32, from_5d=True)
                 if packed else conf.make_model(torch.float32)).train()
        p = conf.image_size
        x = torch.empty(4 * batch, p, p, conf.in_channels)
        rna = torch.empty(4 * batch, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(batch, dtype=torch.long), rna, 2, 2)
    return k1, k2


def train_bwd_variants(packed: bool = False, method: str = "ours",
                       batch: int = None, conf=None) -> dict:
    """K1b's, K2b's and K5b's launches a training step by variant: the
    shapes of ``train_shapes`` (a microbatch of ``batch`` samples) in
    bf16 with aligned tensors, the preset's ``accum`` microbatches."""
    conf = conf or preset_conf(method=method)
    k5 = Counter()
    k1, k2 = train_shapes(packed, batch=batch, method=method, conf=conf,
                          k5=k5)
    return {"rmsnorm_bwd": by_variant("K1b", k1, conf.accum_batches),
            "window_attention_bwd": by_variant("K2b", k2,
                                               conf.accum_batches),
            "grouped_rmsnorm_bwd": by_variant("K5b", k5,
                                              conf.accum_batches)}


def variant(kernel: str, shape: tuple) -> str:
    """The variant of K1, K1b, K2, K2b, K5, K5b, K6 or K7 that a bf16
    call with aligned tensors at ``shape`` launches (K7's gate a chunk of
    a (rows, 7C) tensor, as in the DiT block)."""
    if kernel == "K7":
        return gated_variant(shape[1], 7 * shape[1], BF16, True)
    if kernel == "K1m":
        return rmsnorm_modulate_variant(shape[1], BF16, True, True)
    if kernel == "K6":
        return residual_variant(shape[1], BF16, True)
    if kernel in ("K5", "K5b"):
        _, segments, z = shape
        return grouped_variant(z, segments, BF16, True)
    if kernel in ("K1", "K1b"):
        return rmsnorm_variant(shape[-1], BF16, True)
    rule = attention_variant if kernel == "K2" else attention_bwd_variant
    return rule(shape[1], shape[2], torch.bfloat16, True)


def by_variant(kernel: str, counts: Counter, times: int = 1) -> dict:
    """Launches by variant (every variant named) of ``counts`` (shape ->
    launches) times ``times``."""
    out = dict.fromkeys(K1_VARIANTS if kernel in ("K1", "K1b")
                        else K5_VARIANTS if kernel in ("K5", "K5b")
                        else K6_VARIANTS if kernel == "K6"
                        else K7_VARIANTS if kernel == "K7"
                        else K2_VARIANTS if kernel == "K2"
                        else K2B_VARIANTS, 0)
    for shape, n in counts.items():
        out[variant(kernel, shape)] += n * times
    return out


def prediction(counts: dict, times: int, k5_act: Counter = None,
               k1_act: Counter = None) -> dict:
    """{name: {launches, by_variant, shapes}} of {name: (kernel, shape ->
    launches a call)} over ``times`` calls (``chip_smoke.py``'s launch
    counters' names; shapes as lists, for JSON); with ``k5_act`` K5's
    ``by_epilogue``, ``by_prologue`` and ``act_shapes`` ((rows, segments,
    Z, epilogue, B, prologue) -> launches) too, with ``k1_act`` K1's
    ``by_epilogue`` and ``act_shapes`` ((rows, C, epilogue) ->
    launches)."""
    out = {}
    for name, (kernel, c) in counts.items():
        if kernel in ("K3", "K4"):
            by = (k3_variants(c) if kernel == "K3" else
                  {v: sum(n for s, n in c.items() if s[-1] == v)
                   for v in qk.QUANT_VARIANTS})
            by = {v: n * times for v, n in by.items()}
        else:
            by = by_variant(kernel, c, times)
        out[name] = dict(launches=sum(c.values()) * times, by_variant=by,
                         shapes=[[list(s), n * times] for s, n in
                                 sorted(c.items(), key=lambda kv: -kv[1])])
        if kernel == "K5" and k5_act is not None:
            out[name]["by_epilogue"] = by_epilogue(k5_act, times)
            out[name]["by_prologue"] = by_prologue(k5_act, times)
            out[name]["act_shapes"] = [
                [list(s), n * times] for s, n in
                sorted(k5_act.items(), key=lambda kv: -kv[1])]
        if kernel == "K1" and k1_act is not None:
            out[name]["by_epilogue"] = k1_by_epilogue(k1_act, times)
            out[name]["act_shapes"] = [
                [list(s), n * times] for s, n in
                sorted(k1_act.items(), key=lambda kv: -kv[1])]
    return out


def chain_prediction(conf, quant: str = "", steps: int = STEPS,
                     probes: int = 0, packed: bool = True) -> dict:
    """The launches of ``cli.generate``'s block-major chain of ``steps``
    steps over 2x2 tiles of ``conf``'s preset (:func:`gen_plan`), plus
    ``probes`` planner calls: K1, K2, K5, K6 and K7 (the packed model,
    ``packed`` False the 5D one), and with ``quant`` K3 and K4, as
    :func:`prediction` gives them."""
    calls = gen_plan(conf)["calls"] * steps + probes
    k1, k2, k5, k5_act, k6, k1_act, k7 = (Counter() for _ in range(7))
    counts = {}
    if quant:
        k3, k4, _ = quant_shapes(quant, conf=conf,
                                 k12=(k1, k2, k5, k5_act, k6, k1_act, k7))
        counts = {"quant_conv": ("K3", k3), "quantize": ("K4", k4)}
    else:
        k1, k2 = per_call_shapes(packed, conf=conf, k5=k5, k5_act=k5_act,
                                 k6=k6, k1_act=k1_act, k7=k7)
    return prediction({"rmsnorm": ("K1", k1),
                       "window_attention": ("K2", k2),
                       "grouped_rmsnorm": ("K5", k5),
                       "residual": ("K6", k6),
                       "gated_residual": ("K7", k7), **counts}, calls,
                      k5_act, k1_act)


def train_prediction(conf, steps: int = 1) -> dict:
    """The launches of ``steps`` training steps of ``cli.train`` on
    ``conf``'s preset (the packed model where ``conf.packed_compute``):
    K1, K1b, K2, K2b, K5, K5b, K6 and K7 (none), as :func:`prediction`
    gives them."""
    k5, k5_act, k6, k1_act, k7 = (Counter() for _ in range(5))
    k1, k2 = train_shapes(conf.packed_compute, conf=conf, k5=k5,
                          k5_act=k5_act, k6=k6, k1_act=k1_act, k7=k7)
    times = conf.accum_batches * steps
    return prediction({"rmsnorm": ("K1", k1), "rmsnorm_bwd": ("K1b", k1),
                       "window_attention": ("K2", k2),
                       "window_attention_bwd": ("K2b", k2),
                       "grouped_rmsnorm": ("K5", k5),
                       "grouped_rmsnorm_bwd": ("K5b", k5),
                       "residual": ("K6", k6),
                       "gated_residual": ("K7", k7)}, times, k5_act,
                      k1_act)


def main_train(packed: bool, method: str = "ours", conf=None) -> None:
    conf = conf or preset_conf(method=method)
    accum = conf.accum_batches
    k5 = Counter()
    k1, k2 = train_shapes(packed, method=method, conf=conf, k5=k5)
    name = ("PackedTeraUNet(from_5d)" if packed else "TeraUNet (5D)") \
        if method == "ours" else f"the {method} baseline"
    print(f"{name} training on {conf.name}, {accum} microbatches of "
          f"{conf.batch_size} samples a step")
    for name, counts in (("K1 rmsnorm and K1b (rows, C)", k1),
                         ("K2 window_attention and K2b (B, N, D)", k2)):
        print(f"{name}: {sum(counts.values())} per microbatch, "
              f"{sum(counts.values()) * accum} per step, each")
        for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"  {shape}: {n} per microbatch, {n * accum} per "
                  "step")
    for name, by in train_bwd_variants(packed, method, conf=conf).items():
        print(f"{name} launches a step by variant: {by}")
    if k5:
        print_k5(k5, accum, accum, ("K5", "K5b"))
        for kernel in ("K5", "K5b"):
            print(f"{kernel} launches a step by variant: "
                  f"{by_variant(kernel, k5, accum)}")
    step = norm_step_bytes(k1, accum) + attention_step_bytes(k2, accum)
    for kernel, nbytes in sorted(step.items()):
        print(f"{kernel}: {nbytes / 1e9:.3f} GB a step, byte bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.4f} ms a step")


def print_k5(k5: Counter, times: int, per_step: int,
             kernels: tuple = ("K5",)) -> None:
    """K5's (rows, segments, Z) with launches a call (a microbatch) and a
    chain (a step: ``times``), variant, and bytes and byte bound a launch
    and a step (``per_step`` calls), for each of ``kernels`` (K5, K5b)."""
    for kernel in kernels:
        print(f"{kernel} grouped_rmsnorm{'_bwd' if kernel == 'K5b' else ''}"
              f" (rows, segments, Z): {sum(k5.values())} per call, "
              f"{sum(k5.values()) * times} per chain")
        for shape, n in sorted(k5.items(), key=lambda kv: -kv[1]):
            nbytes = kernel_work(kernel, shape)[0]
            print(f"  {shape} width {shape[2] * sum(shape[1])}: {n} per "
                  f"call, {n * times} per chain; {variant(kernel, shape)};"
                  f" {nbytes / 1e6:.2f} MB a launch, bound "
                  f"{bound_ms(kernel, shape)[0]:.4f} ms; "
                  f"{n * per_step * nbytes / 1e9:.3f} GB a step")
    for name, nbytes in sorted(grouped_step_bytes(k5, per_step,
                                                  kernels).items()):
        print(f"{name}: {nbytes / 1e9:.3f} GB a step, byte bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.2f} ms a step")


def print_k6(k6: Counter, times: int, per_step: int) -> None:
    """K6's (rows, width, skip) with launches a call and a chain
    (``times`` calls), variant, and bytes and byte bound a launch and a
    step (``per_step`` calls)."""
    print(f"K6 residual (rows, width, skip): {sum(k6.values())} per call, "
          f"{sum(k6.values()) * times} per chain")
    total = 0
    for shape, n in sorted(k6.items(), key=lambda kv: -kv[1]):
        nbytes = kernel_work("K6", shape)[0]
        total += n * per_step * nbytes
        print(f"  {shape}: {n} per call, {n * times} per chain; "
              f"{variant('K6', shape)}; {nbytes / 1e6:.2f} MB a launch, "
              f"bound {bound_ms('K6', shape)[0]:.4f} ms; "
              f"{n * per_step * nbytes / 1e9:.3f} GB a step")
    if k6:
        print(f"K6: {total / 1e9:.3f} GB a step, byte bound "
              f"{total / H100_BYTES_PER_S * 1e3:.2f} ms a step")


def print_k7(k1_act: Counter, k7: Counter, times: int,
             per_step: int) -> None:
    """K1's launches by epilogue and K7's (rows, C) with launches a call
    and a chain (``times`` calls), variant, and bytes and byte bound a
    launch and a step (``per_step`` calls); then the eager passes the
    DiT fold removes a step."""
    print(f"K1 launches by epilogue: {k1_by_epilogue(k1_act)} per call, "
          f"{k1_by_epilogue(k1_act, times)} per chain")
    for (rows, c, epi), n in sorted(k1_act.items(), key=lambda kv: -kv[1]):
        if epi == "modulate":
            nbytes = kernel_work("K1m", (rows, c))[0]
            print(f"  K1 modulate ({rows}, {c}): {n} per call, {n * times} "
                  f"per chain; {variant('K1m', (rows, c))}; "
                  f"{nbytes / 1e6:.2f} MB a launch, bound "
                  f"{bound_ms('K1m', (rows, c))[0]:.4f} ms")
    print(f"K7 gated_residual (rows, C): {sum(k7.values())} per call, "
          f"{sum(k7.values()) * times} per chain")
    for shape, n in sorted(k7.items(), key=lambda kv: -kv[1]):
        nbytes = kernel_work("K7", shape)[0]
        print(f"  {shape}: {n} per call, {n * times} per chain; "
              f"{variant('K7', shape)}; {nbytes / 1e6:.2f} MB a launch, "
              f"bound {bound_ms('K7', shape)[0]:.4f} ms; "
              f"{n * per_step * nbytes / 1e9:.3f} GB a step")
    fold = dit_fold_bytes(k1_act, k7, per_step)
    if not fold:
        return
    eager = fold["modulate"] + fold["gated residual"]
    moved = fold["K1 modulate"] + fold["K7"]
    print(f"K7: {fold['K7'] / 1e9:.3f} GB a step, byte bound "
          f"{fold['K7'] / H100_BYTES_PER_S * 1e3:.2f} ms a step")
    print(f"eager passes the DiT fold replaces: modulate "
          f"{fold['modulate'] / 1e9:.2f} GB, gated residual "
          f"{fold['gated residual'] / 1e9:.2f} GB a step, "
          f"{eager / 1e9:.2f} GB in all; K1's scale and shift reads "
          f"{fold['K1 modulate'] / 1e9:.2f} GB and K7 "
          f"{fold['K7'] / 1e9:.2f} GB, so the fold removes "
          f"{(eager - moved) / 1e9:.2f} GB a step, byte bound "
          f"{(eager - moved) / H100_BYTES_PER_S * 1e3:.2f} ms")


def grouped_step_bytes(k5: Counter, times: int,
                       kernels: tuple = ("K5", "K5b")) -> Counter:
    """{"K5 <variant>" / "K5b <variant>": bytes} that ``times`` rounds of
    the K5 launches ``k5`` (shape -> launches) and, with K5b, their
    backward launches move in bf16 with aligned tensors, by variant."""
    out = Counter()
    for shape, n in k5.items():
        for kernel in kernels:
            out[f"{kernel} {variant(kernel, shape)}"] += (
                n * times * kernel_work(kernel, shape)[0])
    return out


def norm_step_bytes(k1: Counter, times: int) -> Counter:
    """{"K1 <variant>" / "K1b <variant>": bytes} that ``times`` rounds of
    the K1 launches ``k1`` (shape -> launches) and their K1b launches move
    in bf16 with aligned tensors, by variant (``kernel_work``'s count, as
    ``chip_smoke.py`` times them)."""
    out = Counter()
    for (rows, c), n in k1.items():
        for kernel in ("K1", "K1b"):
            out[f"{kernel} {rmsnorm_variant(c, BF16, True)}"] += (
                n * times * kernel_work(kernel, (rows, c))[0])
    return out


def attention_step_bytes(k2: Counter, times: int) -> Counter:
    """{"K2 <variant>" / "K2b <variant>": bytes} that ``times`` rounds of
    the K2 launches ``k2`` (shape -> launches) and their K2b launches move
    in bf16 with aligned tensors (inputs read once, outputs written once,
    as ``chip_smoke.py``'s ``kernel_work`` counts them), by variant."""
    out = Counter()
    for (b, n, d), c in k2.items():
        for kernel, rule in (("K2", attention_variant),
                             ("K2b", attention_bwd_variant)):
            nbytes = kernel_work(kernel, (b, n, d))[0]
            out[f"{kernel} {rule(n, d, torch.bfloat16, True)}"] += (
                c * times * nbytes)
    return out


def bound_ms(kernel: str, shape: tuple, itemsize: int = BF16) -> tuple:
    """(least ms on the H100, 'bytes' or 'operations') for one launch of
    ``kernel`` (K1, K1m: K1 with the modulate, K1b, K2, K2b, K5, K5b, K6,
    K7) at ``shape``: the larger of
    the bytes it
    must move over 3.35 TB/s and its operations over the peak rate of
    their type (``chip_smoke.py``'s ``kernel_work``, as its timings
    count them)."""
    return bound(*kernel_work(kernel, shape, itemsize))


def train_rank_shapes(ranks: int, packed: bool = False
                      ) -> tuple[Counter, Counter]:
    """(K1 (rows, C) -> launches, K2 (B, N, D) -> launches) of one
    microbatch of one rank of a data-parallel ``cli.train`` over
    ``ranks`` processes (the global microbatch split evenly)."""
    if TRAIN_BATCH % ranks:
        raise ValueError(f"a batch of {TRAIN_BATCH} over {ranks} ranks")
    return train_shapes(packed, batch=TRAIN_BATCH // ranks)


def main_train_ranks(ranks: int, packed: bool) -> None:
    k1, k2 = train_rank_shapes(ranks, packed)
    one = [sum(c.values()) for c in train_shapes(packed)]
    got = [sum(c.values()) for c in (k1, k2)]
    print(f"{'PackedTeraUNet(from_5d)' if packed else 'TeraUNet (5D)'} "
          f"training over {ranks} ranks: {TRAIN_BATCH // ranks} samples a "
          f"rank's microbatch, {TRAIN_ACCUM} microbatches a step")
    print(f"launches a step a rank: K1 and K1b {got[0] * TRAIN_ACCUM}, K2 "
          f"and K2b {got[1] * TRAIN_ACCUM} (one process: "
          f"{one[0] * TRAIN_ACCUM}, {one[1] * TRAIN_ACCUM}: "
          f"{'equal' if got == one else 'NOT equal'})")
    for name, counts, fwd, bwd in (("(rows, C)", k1, "K1", "K1b"),
                                   ("(B, N, D)", k2, "K2", "K2b")):
        for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            (fb, fby), (bb, bby) = (bound_ms(k, shape) for k in (fwd, bwd))
            variant = (rmsnorm_bwd_variant(shape[1], BF16, True)
                       if fwd == "K1" else attention_bwd_variant(
                           shape[1], shape[2], torch.bfloat16, True))
            print(f"  {fwd} {name} {shape}: {n * TRAIN_ACCUM} a step; bound "
                  f"{fb:.4f} ms ({fby}); {bwd} {variant} bound {bb:.4f} ms "
                  f"({bby})")
    for name, by in train_bwd_variants(packed, batch=TRAIN_BATCH // ranks
                                       ).items():
        print(f"{name} launches a step by variant: {by}")


ATTN_ROI_TILES = 16 * 16   # --pathway ROI: MROI size 128 // 8 tiles a side
F32 = 4


def attn_shapes() -> tuple[Counter, int]:
    """(K1 (rows, C) -> launches, patches) of ``cli.attn``'s extractor on
    one tile of the preset (float32): the tile's interior 16 x 16 gene
    bins split into patches of gn_sz x gn_sz bins."""
    from tera_mind_tpu_torch.cli.attn import GDIM, GSZ
    from tera_mind_tpu_torch.models.unet_attn import GeneAttnExtractor
    conf = prep_config("638850")
    side = (GSZ - 4) // conf.gn_sz
    k1 = Counter()
    with recording(k1, Counter()), torch.device("meta"):
        ext = GeneAttnExtractor(conf.rna_num, conf.rna_slices, conf.gn_sz)
        ext(torch.empty(side * side, conf.gn_sz, conf.gn_sz,
                        conf.rna_slices * GDIM))
    return k1, side * side


def main_attn() -> None:
    k1, patches = attn_shapes()
    print(f"GeneAttnExtractor (cli.attn, float32), {patches} patches a tile")
    print(f"K1 rmsnorm (rows, C): {sum(k1.values())} per tile, "
          f"{sum(k1.values()) * ATTN_ROI_TILES} per {ATTN_ROI_TILES}-tile "
          "ROI")
    for (rows, c), n in sorted(k1.items(), key=lambda kv: -kv[1]):
        nbytes = F32 * (2 * rows * c + c)
        print(f"  ({rows}, {c}): {n} per tile, {n * ATTN_ROI_TILES} per ROI;"
              f" {rmsnorm_variant(c, F32, True)}; {nbytes / 1e6:.3f} MB a "
              f"launch, byte bound {nbytes / H100_BYTES_PER_S * 1e6:.3f} us")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no_packed", action="store_true",
                    help="the 5D TeraUNet instead of the packed model")
    ap.add_argument("--patches", type=int, default=None,
                    help="patches of one z-window (a square; 81 for a 2x2 "
                    "block, 25 for one tile; default the preset's plan)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="z-windows per UNet call (window_chunk)")
    ap.add_argument("--visits", type=int, default=1,
                    help="z-window sweeps a step (tiles of the tile-major "
                    "step, streamed windows of the grid)")
    ap.add_argument("--train", action="store_true",
                    help="one training step of cli.train's defaults")
    ap.add_argument("--packed", action="store_true",
                    help="with --train: the packed model")
    ap.add_argument("--method", default="ours",
                    choices=("ours", "patch-dm", "sinf"),
                    help="with --train: the model of this method")
    ap.add_argument("--quant", default="", choices=("", "int8",
                                                   "int8_static"),
                    help="the prequantized int8 packed model's K3, K4 "
                    "and _int_mm shapes")
    ap.add_argument("--no_quant_attn", action="store_true",
                    help="with --quant: the DiT denses stay bf16")
    ap.add_argument("--attn", action="store_true",
                    help="cli.attn's gene-gene extraction, one tile")
    ap.add_argument("--ranks", type=int, default=0,
                    help="each rank of cli.generate over this many "
                    "processes (with --train: of cli.train)")
    ap.add_argument("--grid", type=int, default=None,
                    help="with --ranks: tiles a side (2; 4 with --stream)")
    ap.add_argument("--stream", action="store_true",
                    help="with --ranks: band-parallel --stream")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="with --ranks: DDIM steps")
    ap.add_argument("--mouse", default="638850",
                    choices=("609882", "609889", "638850"))
    ap.add_argument("--patch", type=int, default=64, choices=(32, 64, 128))
    ap.add_argument("--to_hbr", action="store_true",
                    help="the 81-gene M2H panel")
    ap.add_argument("--stain", default="all",
                    choices=("DAPI", "PolyT", "all"))
    ap.add_argument("--rna_slc", type=int, default=4, choices=(1, 4, 8, 16))
    ap.add_argument("--batch", type=int, default=TRAIN_BATCH,
                    help="with --train: cli.train's global batch")
    args = ap.parse_args()
    conf = preset_conf(args.mouse, args.patch, args.to_hbr, args.stain,
                       args.rna_slc, args.batch, args.method)
    if (conf.name.split("_")[:5] != "638850_64_229_all_4".split("_")
            and (args.ranks or args.attn)):
        ap.error("--ranks and --attn list the 638850 preset only")
    if args.train and args.ranks:
        main_train_ranks(args.ranks, args.packed)
        return
    if args.ranks:
        main_ranks(args.ranks, args.grid or (4 if args.stream else 2),
                   args.stream, args.steps)
        return
    if args.attn:
        main_attn()
        return
    if args.train:
        main_train(args.packed, args.method, conf)
        return
    if args.quant:
        main_quant(args.quant, not args.no_quant_attn, args.patches,
                   args.chunk, args.visits, conf)
        return
    plan = gen_plan(conf)
    visits = args.visits * (plan["visits"] if args.patches is None else 1)
    per_step = plan["windows"] // args.chunk * visits
    calls = STEPS * per_step
    k5, k5_act, k6, k1_act, k7 = (Counter() for _ in range(5))
    k1, k2 = per_call_shapes(packed=not args.no_packed,
                             patches=args.patches, chunk=args.chunk,
                             conf=conf, k5=k5, k5_act=k5_act, k6=k6,
                             k1_act=k1_act, k7=k7)
    print(("PackedTeraUNet" if not args.no_packed else "TeraUNet (5D)")
          + f" on {conf.name}: {plan['windows']} z-windows, "
          f"{per_step} UNet calls a step")
    for name, counts in (("K1 rmsnorm (rows, C)", k1),
                         ("K2 window_attention (B, N, D)", k2)):
        print(f"{name}: {sum(counts.values())} per UNet call, "
              f"{sum(counts.values()) * calls} per chain of {calls} calls")
        for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"  {shape}: {n} per call, {n * calls} per chain")
    print_k5(k5, calls, per_step)
    print_k6(k6, calls, per_step)
    print_k7(k1_act, k7, calls, per_step)
    for kernel, counts in (("K1", k1), ("K2", k2), ("K5", k5), ("K6", k6),
                           ("K7", k7)):
        print(f"{kernel} launches a chain by variant: "
              f"{by_variant(kernel, counts, calls)}")
    print(f"K5 launches by epilogue: {by_epilogue(k5_act)} per call, "
          f"{by_epilogue(k5_act, calls)} per chain; by prologue: "
          f"{by_prologue(k5_act)} per call, {by_prologue(k5_act, calls)} "
          "per chain")
    removed = eager_epilogue_bytes(k5_act, per_step)
    print("eager passes the K5 epilogues leave out: "
          + ", ".join(f"{act} {n / 1e9:.2f} GB" for act, n in
                      sorted(removed.items()))
          + f" a step, {sum(removed.values()) / 1e9:.2f} GB in all, byte "
          f"bound {sum(removed.values()) / H100_BYTES_PER_S * 1e3:.2f} ms")
    fold = fold_bytes(k5_act, k6, per_step)
    eager = sum(v for k, v in fold.items() if k != "K6")
    print("eager passes the bias prologue and K6 replace: "
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in sorted(
              fold.items()) if k != "K6")
          + f" a step, {eager / 1e9:.2f} GB in all; K6 moves "
          f"{fold['K6'] / 1e9:.2f} GB, so the fold removes "
          f"{(eager - fold['K6']) / 1e9:.2f} GB a step, byte bound "
          f"{(eager - fold['K6']) / H100_BYTES_PER_S * 1e3:.2f} ms")
    step = grouped_step_bytes(k5, per_step, ("K5",))
    for (rows, c, epi), n in k1_act.items():
        kernel = "K1m" if epi == "modulate" else "K1"
        step["K1 " + variant(kernel, (rows, c))] += (
            n * per_step * kernel_work(kernel, (rows, c))[0])
    step.update({k: v for k, v in attention_step_bytes(k2, per_step).items()
                 if k.startswith("K2 ")})
    for name, nbytes in sorted(step.items()):
        print(f"{name}: {nbytes / 1e9:.3f} GB a step, byte bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.2f} ms a step")


if __name__ == "__main__":
    main()
