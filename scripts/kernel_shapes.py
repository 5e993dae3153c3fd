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

    python scripts/kernel_shapes.py --quant int8|int8_static [--no_quant_attn]
        [--patches N --chunk W --visits V]

``--quant`` runs the prequantized int8 packed model (``cli.generate
--quant``; with ``int8_static`` its static-activation form) instead and
lists, per UNet call and per chain, K3's (x (B, H, W, Ci), w (Co, kh,
kw)) shapes, K4's (rows, C, multiple) by variant (``dynamic``: an
abs-max launch too; ``static``: none) and ``torch._int_mm``'s (M, K_pad,
N), with the int8 operations and the bytes K3 and K4 move a step.

    python scripts/kernel_shapes.py --train [--packed]

``--train`` runs one training forward of the preset instead: the 5D
``TeraUNet`` (``--packed``: ``PackedTeraUNet(from_5d=True)``) with
float32 parameters and bf16 compute, on one microbatch of ``cli.train``'s
defaults (batch 32: 32 samples, each a 2x2 block of 64^2 patches, so 128
patches, both decoders), and counts it for one step of ``accum``
microbatches (2).  In training every K1 and K2 input requires grad, so
each launch records one backward launch: K1b takes K1's (rows, C) and K2b
K2's (B, N, D), as often; it also prints the launches a step of each
K1b and K2b variant (bf16, aligned tensors).

    python scripts/kernel_shapes.py --attn

``--attn`` runs ``cli.attn``'s extractor (``models/unet_attn.py``, float32)
on one tile of the preset instead: its 16 patches of 4x4 gene bins
(``--patches`` does not apply), and lists K1's (rows, C) with its launches
a tile and a 16x16-tile ROI (``--pathway ROI``), its variant, and the
bytes one launch moves with their bound on the H100.  K1 is the
extraction's only kernel: the G x G product stays ``torch.matmul``.
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

from chip_smoke import STEPS  # noqa: E402
from tera_mind_tpu_torch.config import prep_config  # noqa: E402
from tera_mind_tpu_torch.models import attention as attention_mod  # noqa: E402
from tera_mind_tpu_torch.models import nn as nn_mod  # noqa: E402
from tera_mind_tpu_torch.models.unet_packed import (  # noqa: E402
    make_packed_model)
from tera_mind_tpu_torch.ops import quant_kernel as qk  # noqa: E402
from tera_mind_tpu_torch.ops.attention_kernel import (  # noqa: E402
    VARIANTS as K2_VARIANTS, attention_bwd_variant, attention_variant)
from tera_mind_tpu_torch.ops.rmsnorm_kernel import (  # noqa: E402
    VARIANTS as K1_VARIANTS, rmsnorm_bwd_variant, rmsnorm_variant)

PATCHES = 81       # 9x9 patches of one z-window's padded 2x2-tile block
WINDOWS = 25       # z-windows of the 638850 preset, one UNet call each
H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak
BF16 = 2           # bytes an element


@contextmanager
def recording(k1: Counter, k2: Counter):
    def rmsnorm(x, weight, eps=1e-6):
        k1[(x.numel() // x.shape[-1], x.shape[-1])] += 1
        return torch.empty_like(x)

    def window_attention(q, k, v, scale):
        k2[tuple(q.shape)] += 1
        return torch.empty_like(q)

    saved = nn_mod.rmsnorm, attention_mod.window_attention
    nn_mod.rmsnorm, attention_mod.window_attention = rmsnorm, window_attention
    try:
        yield
    finally:
        nn_mod.rmsnorm, attention_mod.window_attention = saved


def per_call_shapes(packed: bool = True, patches: int = PATCHES,
                    chunk: int = 1) -> tuple[Counter, Counter]:
    """(K1 (rows, C) -> launches, K2 (B, N, D) -> launches) of one UNet
    call on ``chunk`` z-windows of ``patches`` patches each (a square),
    for the packed model or the 5D one."""
    side = math.isqrt(patches)
    if side * side != patches:
        raise ValueError(f"{patches} patches a z-window is not a square grid")
    conf = prep_config("638850").make_model_conf()
    k1, k2 = Counter(), Counter()
    with recording(k1, k2), torch.device("meta"):
        model = make_packed_model(conf) if packed else conf.make_model()
        model = model.to(torch.bfloat16)
        p = conf.image_size
        x = torch.empty(chunk * patches, p, p, conf.in_channels)
        rna = torch.empty(chunk * patches, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(chunk, dtype=torch.long), rna, side, side,
              decode_original=False)
    return k1, k2


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

    def quant_conv(xq, wq, scale=None, bias=None, out_dtype=torch.bfloat16):
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


def quant_shapes(quant: str = "int8", attn: bool = True,
                 patches: int = PATCHES, chunk: int = 1
                 ) -> tuple[Counter, Counter, Counter]:
    """(K3, K4, ``_int_mm``) shapes -> launches of one UNet call of the
    prequantized int8 packed model (``cli.generate --quant``), as
    :func:`quant_recording` keys them."""
    side = math.isqrt(patches)
    if side * side != patches:
        raise ValueError(f"{patches} patches a z-window is not a square grid")
    conf = prep_config("638850").make_model_conf()
    k3, k4, mm = Counter(), Counter(), Counter()
    with quant_recording(k3, k4, mm), recording(Counter(), Counter()), \
            torch.device("meta"):
        model = make_packed_model(conf, quant="int8", prequant=True,
                                  static_act=quant == "int8_static",
                                  quant_attn=attn).to(torch.bfloat16)
        p = conf.image_size
        x = torch.empty(chunk * patches, p, p, conf.in_channels)
        rna = torch.empty(chunk * patches, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(chunk, dtype=torch.long), rna, side, side,
              decode_original=False)
    return k3, k4, mm


def main_quant(quant: str, attn: bool, patches: int, chunk: int,
               visits: int) -> None:
    per_step = WINDOWS // chunk * visits
    calls = STEPS * per_step
    k3, k4, mm = quant_shapes(quant, attn, patches, chunk)
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
    # the function's bytes: x read once, q written once (the dynamic
    # kernel reads x a second time for the abs-max)
    k4_bytes = sum(rows * (BF16 * c + qk.round_up(c, m)) * n
                   for (rows, c, m, _), n in k4.items())
    print(f"K3: {ops / 1e12:.3f} T int8 operations a call, "
          f"{ops * per_step / 1e12:.1f} T a step: "
          f"{ops * per_step / H100_INT8_OPS * 1e3:.1f} ms a step at the "
          f"H100's {H100_INT8_OPS / 1e12:.0f} TOPS; "
          f"{nbytes * per_step / 1e9:.3f} GB a step")
    print(f"K4: {k4_bytes * per_step / 1e9:.3f} GB a step, byte bound "
          f"{k4_bytes * per_step / H100_BYTES_PER_S * 1e3:.2f} ms a step")


TRAIN_BATCH = 32    # cli.train's default --batch: samples a microbatch
TRAIN_ACCUM = 2     # 64 // batch microbatches a step


def train_shapes(packed: bool = False, batch: int = TRAIN_BATCH
                 ) -> tuple[Counter, Counter]:
    """(K1 (rows, C) -> launches, K2 (B, N, D) -> launches) of one
    training forward on a microbatch of ``batch`` samples (2x2 blocks of
    patches, both decoders); K1b and K2b get the same."""
    conf = prep_config("638850").make_model_conf()
    k1, k2 = Counter(), Counter()
    with recording(k1, k2), torch.device("meta"):
        model = (make_packed_model(conf, torch.float32, from_5d=True)
                 if packed else conf.make_model(torch.float32)).train()
        p = conf.image_size
        x = torch.empty(4 * batch, p, p, conf.in_channels)
        rna = torch.empty(4 * batch, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(batch, dtype=torch.long), rna, 2, 2)
    return k1, k2


def train_bwd_variants(packed: bool = False) -> dict:
    """K1b's and K2b's launches a training step by variant: the shapes of
    ``train_shapes`` in bf16 with aligned tensors, ``TRAIN_ACCUM``
    microbatches."""
    k1, k2 = train_shapes(packed)
    out = {"rmsnorm_bwd": dict.fromkeys(K1_VARIANTS, 0),
           "window_attention_bwd": dict.fromkeys(K2_VARIANTS, 0)}
    for (_, c), n in k1.items():
        out["rmsnorm_bwd"][rmsnorm_bwd_variant(c, BF16, True)] += (
            n * TRAIN_ACCUM)
    for (_, n_, d), n in k2.items():
        out["window_attention_bwd"][attention_bwd_variant(
            n_, d, torch.bfloat16, True)] += n * TRAIN_ACCUM
    return out


def main_train(packed: bool) -> None:
    k1, k2 = train_shapes(packed)
    print(("PackedTeraUNet(from_5d)" if packed else "TeraUNet (5D)")
          + f" training, {TRAIN_ACCUM} microbatches of {TRAIN_BATCH} "
          "samples a step")
    for name, counts in (("K1 rmsnorm and K1b (rows, C)", k1),
                         ("K2 window_attention and K2b (B, N, D)", k2)):
        print(f"{name}: {sum(counts.values())} per microbatch, "
              f"{sum(counts.values()) * TRAIN_ACCUM} per step, each")
        for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"  {shape}: {n} per microbatch, {n * TRAIN_ACCUM} per "
                  "step")
    for name, by in train_bwd_variants(packed).items():
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
    ap.add_argument("--patches", type=int, default=PATCHES,
                    help="patches of one z-window (a square; 81 for a 2x2 "
                    "block, 25 for one tile)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="z-windows per UNet call (window_chunk)")
    ap.add_argument("--visits", type=int, default=1,
                    help="z-window sweeps a step (tiles of the tile-major "
                    "step, streamed windows of the grid)")
    ap.add_argument("--train", action="store_true",
                    help="one training step of cli.train's defaults")
    ap.add_argument("--packed", action="store_true",
                    help="with --train: the packed model")
    ap.add_argument("--quant", default="", choices=("", "int8",
                                                   "int8_static"),
                    help="the prequantized int8 packed model's K3, K4 "
                    "and _int_mm shapes")
    ap.add_argument("--no_quant_attn", action="store_true",
                    help="with --quant: the DiT denses stay bf16")
    ap.add_argument("--attn", action="store_true",
                    help="cli.attn's gene-gene extraction, one tile")
    args = ap.parse_args()
    if args.attn:
        main_attn()
        return
    if args.train:
        main_train(args.packed)
        return
    if args.quant:
        main_quant(args.quant, not args.no_quant_attn, args.patches,
                   args.chunk, args.visits)
        return
    per_step = WINDOWS // args.chunk * args.visits
    calls = STEPS * per_step
    k1, k2 = per_call_shapes(packed=not args.no_packed,
                             patches=args.patches, chunk=args.chunk)
    print("PackedTeraUNet" if not args.no_packed else "TeraUNet (5D)")
    for name, counts in (("K1 rmsnorm (rows, C)", k1),
                         ("K2 window_attention (B, N, D)", k2)):
        print(f"{name}: {sum(counts.values())} per UNet call, "
              f"{sum(counts.values()) * calls} per chain of {calls} calls")
        for shape, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"  {shape}: {n} per call, {n * calls} per chain")
    step = Counter()
    for (rows, c), n in k1.items():
        step["K1 " + rmsnorm_variant(c, BF16, True)] += (
            n * per_step * BF16 * (2 * rows * c + c))
    for (b, n_, d), n in k2.items():
        step["K2 " + attention_variant(n_, d, torch.bfloat16, True)] += (
            n * per_step * BF16 * 4 * b * n_ * d)
    for name, nbytes in sorted(step.items()):
        print(f"{name}: {nbytes / 1e9:.3f} GB a step, byte bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.2f} ms a step")


if __name__ == "__main__":
    main()
