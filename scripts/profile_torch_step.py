"""Profile the PyTorch port's tera-generator step, or a training step, on
one CUDA card.

    python scripts/profile_torch_step.py [--no_packed]
        [--path block_major|tile_major|stream] [--json PATH]
    python scripts/profile_torch_step.py --path train [--packed] [--json PATH]

Builds the ``cli.generate`` path (638850 preset, bf16; the packed model,
or the 5D one with ``--no_packed``): ``block_major`` (the default, 2x2
tiles, the planned window_chunk 1), ``tile_major`` (2x2 tiles,
``--tile_major``, window_chunk 5) or ``stream`` (``--stream`` at its
defaults on 4x4 tiles: one step is a sweep of four 2x2-tile windows, 3
in flight on their own streams).  After a warm-up step it traces one
step with ``torch.profiler``: it prints device time by category
(convolution, each variant of K1 rmsnorm and of K2 window attention, the
backward kernels K1b and K2b, matmul, elementwise/copies, other), the
device time of the kernels launched inside ``GroupedRMSNorm`` (plain
PyTorch, spread over the categories above; each call is wrapped in a
``record_function`` range for the trace) and, for ``--path train``,
inside the optimizer's update, the top kernels, and the device's idle
share over the step: 1 - (time in which at least one kernel runs) / wall
time, which on one stream is 1 - summed kernel time / wall time.
``--path train`` is one step of ``cli.train``'s builder on the 638850
preset (``--synthetic --batch 32``: 2 microbatches of 32 samples, bf16
compute, f32 params, dropout 0.1; the 5D model, ``--packed`` the packed
one) after a warm-up step.  Every line names the card and its power
limit.  ``--json PATH`` also writes the per-kernel table there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tera_mind_tpu_torch.cli import generate  # noqa: E402
from tera_mind_tpu_torch.cli import train as train_cli  # noqa: E402
from tera_mind_tpu_torch.models import unet_packed  # noqa: E402
from tera_mind_tpu_torch.training import harness  # noqa: E402

TILES = {"block_major": 2, "tile_major": 2, "stream": 4}  # grid side

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("K1b rmsnorm_bwd", ("rmsnorm_bwd_",)),
    ("K2b attention_bwd", ("attention_bwd_",)),
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


RANGES = ("GroupedRMSNorm", "optimizer")   # profiler ranges reported


def trace_ranges() -> None:
    """Wrap every GroupedRMSNorm call and every optimizer update in a
    profiler range of that name."""
    from torch.profiler import record_function

    def wrap(cls, attr, name):
        fn = getattr(cls, attr)

        def traced(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        setattr(cls, attr, traced)
    wrap(unet_packed.GroupedRMSNorm, "forward", "GroupedRMSNorm")
    wrap(harness.Optimizer, "step", "optimizer")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time in which at
    least one kernel runs, on any stream."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def make_train_step(packed: bool, logdir: str):
    """(one training step of cli.train's builder as a callable, device)."""
    args = train_cli.parse_args(["--synthetic", "--batch", "32"]
                                + ["--packed"] * packed)
    conf, ds, trainer, _ = train_cli.build(args)
    conf.base_dir = logdir
    state = trainer.init_state()
    batch = trainer.shape_batch(next(train_cli.epoch_batches(
        ds, conf.batch_size_effective)))

    def step():
        trainer.train_step(state, batch)
    return step, trainer.device


def make_step(path: str, no_packed: bool):
    """(one step of ``path`` as a callable, the CUDA device)."""
    n = TILES[path]
    flags = {"block_major": [], "tile_major": ["--tile_major"],
             "stream": ["--stream"]}[path]
    args = generate.parse_args(["--synthetic", "--hnm", str(n), "--wnm",
                                str(n)] + flags + ["--no_packed"] * no_packed)
    gen, _, gene, (row0, col0) = generate.build(args)
    dev = gen.device
    state0 = gen.init_state(n, n, row0=row0, col0=col0)
    t = 7
    if path == "stream":
        sgen = generate.make_streamer(args, gen)
        sgen.sconf.progress = False
        hs = sgen.make_state(n, n)

        def step():   # one sweep: the last timestep of the chain
            hs.read[:] = torch.from_numpy(state0)
            sgen.run(n, n, gene, row0=row0, col0=col0, state=hs, start_t=1)
        return step, dev
    state = torch.as_tensor(state0, device=dev)
    gene = torch.as_tensor(gene, device=dev)
    fn = gen.compile_step(n, n, block_major=path == "block_major")
    return (lambda: fn(state, gene, t)), dev


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no_packed", action="store_true")
    ap.add_argument("--path", default="block_major",
                    choices=("block_major", "tile_major", "stream", "train"))
    ap.add_argument("--packed", action="store_true",
                    help="with --path train: the packed model")
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    trace_ranges()
    tmp = tempfile.TemporaryDirectory()
    step, dev = (make_train_step(a.packed, tmp.name) if a.path == "train"
                 else make_step(a.path, a.no_packed))
    step()                                         # warm-up

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

    def dev_us(ev):
        return ev.device_time_total if hasattr(
            ev, "device_time_total") else ev.cuda_time_total

    kernels = defaultdict(lambda: [0.0, 0])
    # per range: device us of the kernels inside, calls, and device us of
    # the ranges' spans on the card
    ranges = {name: [0.0, 0, 0.0] for name in RANGES}
    spans = []            # (start, end) us of every kernel on the card
    for ev in prof.events():
        on_card = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.name in ranges:
            r = ranges[ev.name]
            if on_card:           # the range itself, not a kernel
                r[2] += dev_us(ev)
            else:
                r[0] += dev_us(ev)
                r[1] += 1
        elif on_card:
            k = kernels[ev.name]
            k[0] += dev_us(ev)
            k[1] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    total_us = sum(v[0] for v in kernels.values())
    union_us = busy_us(spans)
    cats = defaultdict(float)
    for name, (us, _) in kernels.items():
        cats[category(name)] += us
    print(f"traced step [{a.path}]: wall {wall:.4f} s, kernel time "
          f"{total_us / 1e6:.4f} s, device busy {union_us / 1e6:.4f} s, "
          f"idle share {1 - union_us / 1e6 / wall:.3f} ({card})", flush=True)
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:26s} {us / 1e3:9.2f} ms  {100 * us / total_us:5.1f} %")
    if a.path == "stream":
        print("  GroupedRMSNorm: its ranges run on the window workers' "
              "threads, which the profiler does not record")
    else:
        for name, (us, calls, span) in ranges.items():
            if calls:
                print(f"  {name}: kernels inside its {calls} calls "
                      f"{us / 1e3:.2f} ms ({100 * us / total_us:.1f} %), "
                      f"its ranges' spans on the card {span / 1e3:.2f} ms")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in top[:25]:
        print(f"  {us / 1e3:9.2f} ms  {n:6d}x  [{category(name)}] "
              f"{name[:110]}")
    if a.json is None:
        return
    a.json.parent.mkdir(parents=True, exist_ok=True)
    a.json.write_text(json.dumps({
        "card": card, "path": a.path,
        "packed": a.packed if a.path == "train" else not a.no_packed,
        "wall_s": wall, "kernel_us": total_us, "busy_us": union_us,
        "categories_us": cats,
        "ranges": {name: {"us": r[0], "calls": r[1], "span_us": r[2]}
                   for name, r in ranges.items()},
        "kernels": {n: v for n, v in top}}, indent=1))


if __name__ == "__main__":
    main()
