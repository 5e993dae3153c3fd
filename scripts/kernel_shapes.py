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

    python scripts/kernel_shapes.py --train [--packed]

``--train`` runs one training forward of the preset instead: the 5D
``TeraUNet`` (``--packed``: ``PackedTeraUNet(from_5d=True)``) with
float32 parameters and bf16 compute, on one microbatch of ``cli.train``'s
defaults (batch 32: 32 samples, each a 2x2 block of 64^2 patches, so 128
patches, both decoders), and counts it for one step of ``accum``
microbatches (2).  In training every K1 and K2 input requires grad, so
each launch records one backward launch: K1b takes K1's (rows, C) and K2b
K2's (B, N, D), as often.
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
from tera_mind_tpu_torch.ops.attention_kernel import (  # noqa: E402
    attention_variant)
from tera_mind_tpu_torch.ops.rmsnorm_kernel import rmsnorm_variant  # noqa: E402

PATCHES = 81       # 9x9 patches of one z-window's padded 2x2-tile block
WINDOWS = 25       # z-windows of the 638850 preset, one UNet call each
H100_BYTES_PER_S = 3.35e12
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
    args = ap.parse_args()
    if args.train:
        main_train(args.packed)
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
