"""Profile the PyTorch port's tera-generator step on one CUDA card.

    python scripts/profile_torch_step.py [--no_packed] [--json PATH]

Builds the ``cli.generate`` path (638850 preset, 2x2 tiles, bf16,
block-major, window_chunk 1; the packed model, or the 5D one with
``--no_packed``) and, after a warm-up step, traces one step with
``torch.profiler``: it prints device time by category (convolution, each
variant of K1 rmsnorm and of K2 window attention, matmul,
elementwise/copies, other), the device time of the kernels launched
inside ``GroupedRMSNorm`` (plain PyTorch, spread over the categories
above; each call is wrapped in a ``record_function`` range for the
trace), the top kernels, and the device's idle share over the step
(1 - summed kernel time / wall time).  Every line names the card and its
power limit.  ``--json PATH`` also writes the per-kernel table there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tera_mind_tpu_torch.cli import generate  # noqa: E402
from tera_mind_tpu_torch.models import unet_packed  # noqa: E402

TILES = 2          # 2x2 tiles of 256^2 px, as chip_smoke.py's main path

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("K1 rmsnorm vector", ("rmsnorm_kernel_vec",)),
    ("K1 rmsnorm strided", ("rmsnorm_kernel",)),
    ("K2 attention tensor_core", ("attention_kernel_tc",)),
    ("K2 attention cuda_core", ("attention_kernel",)),
    ("convolution", ("conv", "implicit", "xmma_fprop", "dgrad", "wgrad",
                     "cudnn", "fprop", "winograd")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "ampere_", "sm80")),
    ("elementwise/copy", ("elementwise", "copy", "cat", "vectorized",
                          "reduce", "index", "pad", "fill", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def trace_grouped_norms() -> None:
    """Wrap every GroupedRMSNorm call in a profiler range of that name."""
    from torch.profiler import record_function
    forward = unet_packed.GroupedRMSNorm.forward

    def traced(self, x):
        with record_function("GroupedRMSNorm"):
            return forward(self, x)
    unet_packed.GroupedRMSNorm.forward = traced


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no_packed", action="store_true")
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    trace_grouped_norms()
    args = generate.parse_args(["--synthetic", "--hnm", str(TILES),
                                "--wnm", str(TILES)]
                               + ["--no_packed"] * a.no_packed)
    gen, _, gene, (row0, col0) = generate.build(args)
    dev = gen.device
    state = torch.as_tensor(gen.init_state(TILES, TILES, row0=row0,
                                           col0=col0), device=dev)
    gene = torch.as_tensor(gene, device=dev)
    t = 7
    step = gen.compile_step(TILES, TILES)
    step(state, gene, t)                           # warm-up

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, gene, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(ev):
        return ev.device_time_total if hasattr(
            ev, "device_time_total") else ev.cuda_time_total

    kernels = defaultdict(lambda: [0.0, 0])
    grouped = [0.0, 0]    # device us of the kernels inside, and calls
    grouped_span = 0.0    # device us of the ranges' spans on the card
    for ev in prof.events():
        on_card = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.name == "GroupedRMSNorm":
            if on_card:           # the range itself, not a kernel
                grouped_span += dev_us(ev)
            else:
                grouped[0] += dev_us(ev)
                grouped[1] += 1
        elif on_card:
            k = kernels[ev.name]
            k[0] += dev_us(ev)
            k[1] += 1
    total_us = sum(v[0] for v in kernels.values())
    cats = defaultdict(float)
    for name, (us, _) in kernels.items():
        cats[category(name)] += us
    print(f"traced step: wall {wall:.4f} s, "
          f"device busy {total_us / 1e6:.4f} s, idle share "
          f"{1 - total_us / 1e6 / wall:.3f} ({card})", flush=True)
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:26s} {us / 1e3:9.2f} ms  {100 * us / total_us:5.1f} %")
    print(f"  GroupedRMSNorm: kernels inside its {grouped[1]} calls "
          f"{grouped[0] / 1e3:.2f} ms ({100 * grouped[0] / total_us:.1f} %),"
          f" its ranges' spans on the card {grouped_span / 1e3:.2f} ms")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in top[:25]:
        print(f"  {us / 1e3:9.2f} ms  {n:6d}x  [{category(name)}] "
              f"{name[:110]}")
    if a.json is None:
        return
    a.json.parent.mkdir(parents=True, exist_ok=True)
    a.json.write_text(json.dumps({
        "card": card, "packed": not a.no_packed, "wall_s": wall,
        "busy_us": total_us, "categories_us": cats,
        "grouped_rmsnorm_us": grouped[0],
        "grouped_rmsnorm_calls": grouped[1],
        "grouped_rmsnorm_span_us": grouped_span,
        "kernels": {n: v for n, v in top}}, indent=1))


if __name__ == "__main__":
    main()
