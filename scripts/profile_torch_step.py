"""Profile the PyTorch port's tera-generator step, or a training step, on
one CUDA card.

    python scripts/profile_torch_step.py [--no_packed]
        [--path block_major|tile_major|stream] [--json PATH]
    python scripts/profile_torch_step.py --path train [--packed]
        [--train_args "--mouse 609889 --patch 32 ..."] [--json PATH]
    python scripts/profile_torch_step.py --quant int8|int8_static [--json PATH]
    python scripts/profile_torch_step.py --shapes [--path ...] [--json PATH]

Builds the ``cli.generate`` path (638850 preset, bf16; the packed model,
or the 5D one with ``--no_packed``): ``block_major`` (the default, 2x2
tiles, the planned window_chunk 1), ``tile_major`` (2x2 tiles,
``--tile_major``, window_chunk 5) or ``stream`` (``--stream`` at its
defaults on 4x4 tiles: one step is a sweep of four 2x2-tile windows, 3
in flight on their own streams).  After a warm-up step it traces one
step with ``torch.profiler``: it prints device time by category
(convolution, each variant of K1 rmsnorm, of K2 window attention and of
their backward kernels K1b (with its dw sum over the blocks) and K2b,
matmul, elementwise/copies, other), the
device time of the kernels launched inside ``GroupedRMSNorm`` (K5, or
in a tree without it its plain PyTorch passes spread over the categories
above; each call is wrapped in a ``record_function`` range for the
trace), inside its autograd Function's backward (K5b) and, for ``--path
train``, inside the optimizer's update, the top kernels, and the device's
idle share over the step: 1 - (time in which at least one kernel runs) /
wall time, which on one stream is 1 - summed kernel time / wall time.
``--path train`` is one step of ``cli.train``'s builder on the 638850
preset (``--synthetic --batch 32``: 2 microbatches of 32 samples, bf16
compute, f32 params, dropout 0.1; the 5D model, ``--packed`` the packed
one; ``--train_args`` adds ``cli.train`` flags, such as another preset's)
after a warm-up step.  ``--steps N`` first times N untraced steps
after the warm-up, each ending in ``torch.cuda.synchronize``, and prints
them and their median.  Every line names the card and its power limit.
``--json PATH`` also writes the per-kernel table there.  ``--quant
int8|int8_static`` builds the generation path with ``cli.generate
--quant`` (int8_static calibrates first); K3 (``quant_conv``, by
variant), K4 (``quantize``, one launch with its abs-max) and
``torch._int_mm``'s cuBLASLt int8 products are then categories of their
own, as are K6 (``residual``, the packed ResBlocks' residual sum with
their convs' biases) and K7 (``gated_residual``, the DiT blocks' gated
residual; K1's launches with the DiT blocks' modulate count in K1's
categories).  ``--shapes`` (generation paths) traces the step
with ``record_shapes=True`` and each conv of the model, each
``PackedResBlock``, DiT block and the RNA tower wrapped in a profiler
range named by its role (``in_conv``, ``out_conv``, ``skip_conv``,
``stem``, ``out_conv (UNet)``, ...), and prints the elementwise ops
(adds, copies, casts, cats, products) with their input shapes and the
innermost range they ran in, by count a step: which broadcast adds are
conv biases ``(N, C, H, W) + (1, C, 1, 1)`` and of which conv.
"""

from __future__ import annotations

import argparse
import json
import shlex
import statistics
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
    ("K7 gated_residual", ("gated_residual_kernel",)),
    ("K6 residual", ("residual_kernel",)),
    ("K5b grouped_rmsnorm_bwd dw sum", ("grouped_bwd_dw",)),
    ("K5b grouped_rmsnorm_bwd vector", ("grouped_bwd_vec",)),
    ("K5b grouped_rmsnorm_bwd staged", ("grouped_bwd_staged",)),
    ("K5 grouped_rmsnorm vector", ("grouped_vec",)),
    ("K5 grouped_rmsnorm staged", ("grouped_staged",)),
    ("K3 quant_conv wgmma", ("quant_conv_wgmma",)),
    ("K3 quant_conv mma_sync", ("quant_conv_kernel",)),
    ("K4 quantize", ("quantize_kernel",)),
    ("int8 matmul (_int_mm)", ("imma", "s8s8", "i8i8", "int8", "_s8",
                               "igemm", "s32_")),
    ("K1b rmsnorm_bwd vector", ("rmsnorm_bwd_vec",)),
    ("K1b rmsnorm_bwd dw sum", ("rmsnorm_bwd_dw",)),
    ("K1b rmsnorm_bwd strided", ("rmsnorm_bwd_",)),
    ("K2b attention_bwd wgmma", ("attention_bwd_fused",
                                 "attention_bwd_dq_wgmma",
                                 "attention_bwd_dkdv_wgmma",
                                 "attention_bwd_reduce")),
    ("K2b attention_bwd tensor_core_tiled", ("attention_bwd_tiled",)),
    ("K2b attention_bwd tensor_core", ("attention_bwd_tc",)),
    ("K2b attention_bwd cuda_core", ("attention_bwd_",)),
    ("K1 rmsnorm vector", ("rmsnorm_kernel_vec",)),
    ("K1 rmsnorm strided", ("rmsnorm_kernel",)),
    ("K2 attention wgmma", ("attention_wgmma_kernel",)),
    ("K2 attention tensor_core_tiled", ("attention_kernel_tiled",)),
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


# profiler ranges reported
RANGES = ("GroupedRMSNorm", "GroupedRMSNorm backward", "optimizer")


def trace_ranges() -> None:
    """Wrap every GroupedRMSNorm call, every backward of its autograd
    Function (K5b; a tree whose GroupedRMSNorm is plain PyTorch has none)
    and every optimizer update in a profiler range of that name."""
    from torch.profiler import record_function

    def wrap(cls, attr, name, static=False):
        fn = getattr(cls, attr)

        def traced(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        setattr(cls, attr, staticmethod(traced) if static else traced)
    wrap(unet_packed.GroupedRMSNorm, "forward", "GroupedRMSNorm")
    wrap(harness.Optimizer, "step", "optimizer")
    try:
        from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
    except ImportError:
        return
    wrap(k5.GroupedRMSNormFunction, "backward", "GroupedRMSNorm backward",
         static=True)


# the ops --shapes lists, and the profiler ranges it wraps around modules
SHAPE_OPS = ("aten::add", "aten::add_", "aten::copy_", "aten::cat",
             "aten::mul", "aten::mul_", "aten::_to_copy", "aten::silu")
ROLE_RANGES = ("in_conv", "out_conv", "skip_conv", "stem", "out_conv (UNet)",
               "PackedResBlock", "DiTBlock", "RNATower")


def wrap_roles(model) -> None:
    """Wrap each conv of ``model`` (its ``forward`` and, where it has
    one, ``product``), each ``PackedResBlock``, DiT block and the RNA
    tower in a profiler range named by its role (:data:`ROLE_RANGES`)."""
    from torch.profiler import record_function

    def wrap(mod, attr, name):
        fn = getattr(mod, attr)

        def traced(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        setattr(mod, attr, traced)
    for name, mod in model.named_modules():
        role = name.rsplit(".", 1)[-1]
        if role in ("in_conv", "out_conv", "skip_conv", "stem"):
            role = "out_conv (UNet)" if name == "out_conv" else role
            for attr in ("forward", "product"):
                if hasattr(mod, attr):
                    wrap(mod, attr, role)
        elif type(mod).__name__ in ROLE_RANGES:
            wrap(mod, "forward", type(mod).__name__)


def shape_table(prof) -> list:
    """[(count, op, input shapes, innermost role range)] of the
    :data:`SHAPE_OPS` CPU ops a ``record_shapes`` trace recorded, most
    frequent first."""
    rows = defaultdict(int)
    for ev in prof.events():
        if ev.name not in SHAPE_OPS or \
                ev.device_type == torch.autograd.DeviceType.CUDA:
            continue
        parent, role = ev.cpu_parent, "-"
        while parent is not None:
            if parent.name in ROLE_RANGES:
                role = parent.name
                break
            parent = parent.cpu_parent
        shapes = tuple(tuple(s) for s in ev.input_shapes if s)
        rows[(ev.name, shapes, role)] += 1
    return sorted(((n,) + k for k, n in rows.items()), key=lambda r: -r[0])


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time in which at
    least one kernel runs, on any stream."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def make_train_step(packed: bool, logdir: str, extra: list = ()):
    """(one training step of cli.train's builder as a callable, device);
    ``extra``: more cli.train flags."""
    args = train_cli.parse_args(["--synthetic", "--batch", "32"]
                                + ["--packed"] * packed + list(extra))
    conf, ds, trainer, _ = train_cli.build(args)
    conf.base_dir = logdir
    state = trainer.init_state()
    batch = trainer.shape_batch(next(train_cli.epoch_batches(
        ds, conf.batch_size_effective)))

    def step():
        trainer.train_step(state, batch)
    return step, trainer.device


def make_step(path: str, no_packed: bool, quant: str = ""):
    """(one step of ``path`` as a callable, the CUDA device, the
    model)."""
    n = TILES[path]
    flags = {"block_major": [], "tile_major": ["--tile_major"],
             "stream": ["--stream"]}[path]
    args = generate.parse_args(["--synthetic", "--hnm", str(n), "--wnm",
                                str(n)] + flags + ["--no_packed"] * no_packed
                               + (["--quant", quant] if quant else []))
    gen, model, gene, (row0, col0) = generate.build(args)
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
        return step, dev, model
    state = torch.as_tensor(state0, device=dev)
    gene = torch.as_tensor(gene, device=dev)
    fn = gen.compile_step(n, n, block_major=path == "block_major")
    return (lambda: fn(state, gene, t)), dev, model


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no_packed", action="store_true")
    ap.add_argument("--path", default="block_major",
                    choices=("block_major", "tile_major", "stream", "train"))
    ap.add_argument("--packed", action="store_true",
                    help="with --path train: the packed model")
    ap.add_argument("--quant", default="", choices=("", "int8",
                                                   "int8_static"),
                    help="generation with cli.generate --quant")
    ap.add_argument("--train_args", default="",
                    help="with --path train: more cli.train flags, one "
                    "string (--train_args=\"--mouse 609889 ...\")")
    ap.add_argument("--steps", type=int, default=0,
                    help="untraced steps to time before the traced one")
    ap.add_argument("--shapes", action="store_true",
                    help="record input shapes: the elementwise ops by "
                    "shape and by the module role they ran in")
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args()
    if a.shapes and a.path == "train":
        ap.error("--shapes traces the generation paths")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    trace_ranges()
    tmp = tempfile.TemporaryDirectory()
    if a.path == "train":
        step, dev = make_train_step(a.packed, tmp.name,
                                    shlex.split(a.train_args))
    else:
        step, dev, model = make_step(a.path, a.no_packed, a.quant)
        if a.shapes:
            wrap_roles(model)
    step()                                         # warm-up
    torch.cuda.synchronize(dev)
    untraced = []
    for _ in range(a.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        untraced.append(time.perf_counter() - t0)
    if untraced:
        print(f"untraced steps [{a.path}]: median "
              f"{statistics.median(untraced):.4f} s of "
              f"{[round(t, 4) for t in untraced]} ({card})", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=a.shapes) as prof:
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
        elif on_card and ev.name not in ROLE_RANGES:   # not --shapes' spans
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
        print(f"  {cat:30s} {us / 1e3:9.2f} ms  {100 * us / total_us:5.1f} %")
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
    shapes = shape_table(prof) if a.shapes else []
    for n, op, ins, role in shapes[:40]:
        print(f"  shapes {n:6d}x  {op:16s} [{role}] {list(ins)}")
    if shapes:
        bias = sum(n for n, op, ins, role in shapes
                   if op == "aten::add_" and len(ins) == 2
                   and len(ins[1]) == 4 and ins[1][0] == 1
                   and ins[1][2:] == (1, 1))
        by_role = defaultdict(int)
        for n, op, ins, role in shapes:
            if op == "aten::add_" and len(ins) == 2 and len(ins[1]) == 4 \
                    and ins[1][2:] == (1, 1):
                by_role[role] += n
        print(f"  conv bias adds (N, C, H, W) + (1, C, 1, 1): {bias} a "
              f"step, by range {dict(by_role)}")
    if a.json is None:
        return
    a.json.parent.mkdir(parents=True, exist_ok=True)
    a.json.write_text(json.dumps({
        "card": card, "path": a.path, "quant": a.quant,
        "packed": a.packed if a.path == "train" else not a.no_packed,
        "wall_s": wall, "kernel_us": total_us, "busy_us": union_us,
        "untraced_s": untraced,
        "categories_us": cats,
        "ranges": {name: {"us": r[0], "calls": r[1], "span_us": r[2]}
                   for name, r in ranges.items()},
        "kernels": {n: v for n, v in top},
        "shapes": [[n, op, [list(s) for s in ins], role]
                   for n, op, ins, role in shapes]}, indent=1))


if __name__ == "__main__":
    main()
