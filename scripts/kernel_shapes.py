"""The shapes the main path gives K1 and K2, and how often, per chain.

    python scripts/kernel_shapes.py [--no_packed]

Runs one UNet call of the 638850 preset (bf16, 9x9 patches of 64^2 px,
collage decoder only, as ``cli.generate`` calls it: the z-packed
``PackedTeraUNet`` by default, the 5D ``TeraUNet`` with ``--no_packed``)
on PyTorch's ``meta`` device, with K1 and K2 replaced by stand-ins that record their input
shapes: no data, no card, about a second on a CPU.  Prints each
(rows, C) of K1 and (B, N, D) of K2 with its launches per UNet call and
per chain (one call per z-window per step of chip_smoke.py's chain),
and for each variant the bytes one step moves through it (inputs read
once, output written once) and the least time the H100's 3.35 TB/s
allows for them: the yardstick for the variant's device time per step
in scripts/profile_torch_step.py.
"""

from __future__ import annotations

import argparse
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

PATCHES = 9        # 9x9 patches of one z-window's padded 2x2-tile block
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


def per_call_shapes(packed: bool = True) -> tuple[Counter, Counter]:
    """(K1 (rows, C) -> launches, K2 (B, N, D) -> launches) of one UNet
    call on the main path (the packed model, or the 5D one)."""
    conf = prep_config("638850").make_model_conf()
    k1, k2 = Counter(), Counter()
    with recording(k1, k2), torch.device("meta"):
        model = make_packed_model(conf) if packed else conf.make_model()
        model = model.to(torch.bfloat16)
        p = conf.image_size
        x = torch.empty(PATCHES ** 2, p, p, conf.in_channels)
        rna = torch.empty(PATCHES ** 2, conf.gn_sz, conf.gn_sz,
                          len(conf.rna_tpl) * conf.rna_num)
        model(x, torch.zeros(1, dtype=torch.long), rna, PATCHES, PATCHES,
              decode_original=False)
    return k1, k2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no_packed", action="store_true",
                    help="the 5D TeraUNet instead of the packed model")
    args = ap.parse_args()
    calls = STEPS * WINDOWS
    k1, k2 = per_call_shapes(packed=not args.no_packed)
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
            n * WINDOWS * BF16 * (2 * rows * c + c))
    for (b, n_, d), n in k2.items():
        step["K2 " + attention_variant(n_, d, torch.bfloat16, True)] += (
            n * WINDOWS * BF16 * 4 * b * n_ * d)
    for name, nbytes in sorted(step.items()):
        print(f"{name}: {nbytes / 1e9:.3f} GB a step, byte bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.2f} ms a step")


if __name__ == "__main__":
    main()
