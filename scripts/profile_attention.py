"""Device time of each CUDA kernel K2 and K2b launch at given shapes.

    python scripts/profile_attention.py [--shapes B,N,D ...]

Needs one CUDA card.  For each (B, N, D) in bf16 (default: the presets'
shapes with N > 128 or D = 512, the main training shape and the edge
(2, 512, 512)), runs ``attention_cuda`` and ``attention_bwd_cuda`` (the
shape rule's variants) ``REPS`` times under ``torch.profiler`` and
prints each CUDA kernel's mean device time per call: K2's one kernel,
K2b's passes apart (``wgmma``: one fused kernel at N <= 128, its dq
kernel and its dk/dv kernel at N > 128 with D <= 256, else the blocks'
statistics, the blocks' tiles and the sum of their partials; the
``mma.sync`` variants' dq and dk/dv passes), after ``ptxas``'s registers
and spills of the attention kernels.  The inputs are randn; timings are
warm (the same tensors each call, so K and V of a call may sit in the
L2).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tera_mind_tpu_torch.ops import _build  # noqa: E402
from tera_mind_tpu_torch.ops import attention_kernel as k2  # noqa: E402

REPS = 20
SHAPES = [(512, 512, 128), (612, 512, 128), (128, 512, 128),
          (100, 128, 512), (128, 128, 512), (512, 128, 512),
          (256, 256, 256), (512, 256, 256), (128, 256, 256),
          (512, 128, 256), (2, 512, 512)]


FUSED_MODES = {"0": "fused", "1": "block statistics", "2": "block tiles"}


def short(name: str) -> str:
    """A kernel's name without its namespace and argument list (K2b
    wgmma's fused kernel with its mode: fused, or the blocked design's
    statistics and tiles)."""
    if "attention_bwd_fused_kernel<" in name:
        args = name.split("attention_bwd_fused_kernel<", 1)[1]
        mode = args.split(">", 1)[0].split(",")[-1].strip()
        return f"attention_bwd_fused_kernel ({FUSED_MODES.get(mode, mode)})"
    for key in ("attention_wgmma_kernel", "attention_bwd_fused_kernel",
                "attention_bwd_reduce_kernel",
                "attention_bwd_dq_wgmma", "attention_bwd_dkdv_wgmma",
                "attention_bwd_tiled_dkdv",
                "attention_bwd_tiled_dq",
                "attention_kernel_tiled", "attention_bwd_tc_dkdv",
                "attention_bwd_tc_dq", "attention_kernel_tc",
                "attention_bwd_dkdv", "attention_bwd_dq", "attention_kernel"):
        if key in name:
            return key
    return name[:60]


def kernel_ms(fn, reps: int) -> dict:
    """{kernel: mean device ms per call} of ``reps`` calls of fn."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[short(ev.name)] += ev.device_time / 1e3 / reps
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,N,D triples (default: SHAPES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_attention: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    _build.lib()
    for line in _build.ptxas_report(_build.build_log):
        if "attention" in line:
            print(f"ptxas: {line}", flush=True)
    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shapes]
              if args.shapes else SHAPES)
    g = torch.Generator().manual_seed(0)
    for b, n, d in shapes:
        q, k, v, gr = (torch.randn(b, n, d, generator=g).to("cuda",
                                                             torch.bfloat16)
                       for _ in range(4))
        scale = 1.0 / d
        fwd = kernel_ms(lambda: k2.attention_cuda(q, k, v, scale), REPS)
        bwd = kernel_ms(lambda: k2.attention_bwd_cuda(q, k, v, gr, scale),
                        REPS)
        rule = (k2.attention_variant(n, d, q.dtype, True),
                k2.attention_bwd_variant(n, d, q.dtype, True))
        text = "; ".join(f"{name} {ms:.4f} ms" for name, ms in
                         list(fwd.items()) + list(bwd.items()))
        print(f"({b}, {n}, {d}) K2 {rule[0]}, K2b {rule[1]}: {text}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
