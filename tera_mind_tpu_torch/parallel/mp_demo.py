"""Multi-process tera-generation and data-parallel training demo and
self-check.

Port of ``tera_mind_tpu/parallel/mp_demo.py`` (the reference's mp.spawn +
NCCL lock-step generation, test_brn.py:26-48, 232-273, and its Lightning
DDP training, experiment.py:485), one rank per device:

- :func:`~.mesh.multihost_init` joins the process group (NCCL with a card
  a rank, gloo on the CPU or where ranks share a card);
- the ranks form an (R, C) mesh, (processes, 1) by default, each owning
  one tile block of the grid and building only that block's genes (from
  a per-tile provider) and initial noise;
- every step each rank trades its edge strips with its neighbours
  (``exchange_halo_2d``), no disk round trip, no barriers.

Each rank then recomputes the whole grid on its own device in one
process and checks its block against it, and (without ``--fast``, or
with ``--band``) streams its row band of the grid with band edge strips
exchanged every visit (``parallel/band.py``), K = 1 and (without
``--fast``) K = 2.  Then (without ``--fast``, or alone with
``--train_only``) the ranks train the tiny f32 config of ``_train_conf``
data-parallel for 3 steps, each rank on its rows of a fixed global batch,
check after every step that every rank holds the same parameters and
Adam moments (a digest of their bits), and rank 0 prints the loss
history.  ``--train_ref`` trains the same global batches in one process
(``_interleave_for_single``) and prints its losses, which the ranks' must
match (2e-5, JAX's tests/test_multiprocess.py gate).

Usage (one command per rank):

    python -m tera_mind_tpu_torch.parallel.mp_demo \\
        --coordinator 127.0.0.1:29531 --num_processes 2 --process_id 0

``--device cpu`` runs the ranks on the CPU over gloo.  The reference
for the training check, in one process:

    python -m tera_mind_tpu_torch.parallel.mp_demo --train_ref \
        --num_processes 2
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

TOL = 1e-5   # the sharded and streamed bands against the one-device run


def leaky_model_fn(xp, tm, rp, p1, p2):
    """Deterministic halo-sensitive mock model (as tests/test_generator.py):
    collage pred = windowed average of x + mean rna bias; drives the whole
    data flow without network weights."""
    from ..ops.collage import to_collage
    ps = xp.shape[1]
    col = to_collage(xp.reshape(xp.shape[0], 1, ps, ps, xp.shape[-1]),
                     p1, p2)[:, 0]
    col_r = to_collage(rp.reshape(rp.shape[0], 1, *rp.shape[1:]),
                       p1, p2)[:, 0]
    bias = col_r.mean(dim=(1, 2, 3))[:, None, None, None]
    return 0.1 * col + 0.01 * bias, torch.zeros_like(xp)


def gene_provider(r: int, c: int) -> np.ndarray:
    """Deterministic per-tile gene stack, a pure function of GLOBAL bin
    coordinates, so neighbouring tiles' overlap bins agree (what real
    MERFISH tiles have and the K > 1 gene ring assembly relies on)."""
    g = _gconf()
    nb, hb = g.tile // g.gn_blk, g.pad // g.gn_blk
    ys = np.arange(r * nb - hb, r * nb + nb + hb, dtype=np.int64)
    xs = np.arange(c * nb - hb, c * nb + nb + hb, dtype=np.int64)
    yy = ys[:, None, None, None]
    xx = xs[None, :, None, None]
    zz = np.arange(g.z_pad, dtype=np.int64)[None, None, :, None]
    gg = np.arange(g.gdim, dtype=np.int64)[None, None, None, :]
    h = (yy * 73856093 ^ xx * 19349663 ^ zz * 83492791 ^ gg * 40503) \
        & 0xFFFFFFFF
    return (((h % 100) < 20) * (1 + (h >> 16) % 3)).astype(np.uint8)


def _gconf():
    from .generator import GeneratorConfig
    return GeneratorConfig(tile=32, patch=16, gn_blk=8, snum=4, n_slices=4,
                           stains=1, gdim=6, noise_backend="jax")


def _make_gen(mesh, device=None):
    from ..diffusion.sampler import DiffusionSampler, SamplerConfig
    from ..diffusion.schedule import spaced_schedule
    from .generator import TeraGenerator
    g = _gconf()
    sampler = DiffusionSampler(
        spaced_schedule("linear", 1000, "ddim3"),
        SamplerConfig(patch_size=g.patch, gn_sz=g.patch // g.gn_blk))
    return TeraGenerator(sampler, leaky_model_fn, g, mesh=mesh,
                         device=device)


TRAIN_STEPS = 3
TRAIN_BATCH = 16     # the global effective batch


def _float32() -> None:
    """The f32 check's convs and matmuls in float32 on a card (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _train_conf(**kw):
    """The tiny f32 training config of JAX's demo."""
    from ..config import TrainConfig
    return TrainConfig(**{**dict(
        image_size=32, net_ch=8, embed_channels=32, rna_num=16,
        rna_slices=4, stain="all", batch_size=8, accum_batches=2, lr=1e-3,
        compute_dtype="float32", train_crop=64, dropout=0.0,
        save_every_steps=10 ** 9), **kw})


def _train_batch(conf, step: int, lo: int = 0, hi: int = TRAIN_BATCH
                 ) -> dict:
    """Deterministic global effective batch (16 samples), sliced [lo:hi].

    Rank r holds [r per, (r + 1) per): the global sample order is accum
    row-major with per-rank blocks, [r0 s0-3, r1 s0-3, r0 s4-7, r1 s4-7]
    for 2 ranks x accum 2 (JAX's dp layout over processes)."""
    rng = np.random.default_rng(1000 + step)
    crop = conf.train_crop
    gh = crop // 16 + conf.gn_sz
    b = {"image": rng.standard_normal(
            (TRAIN_BATCH, crop, crop, conf.in_channels)).clip(-1, 1).astype(
                np.float32),
         "rna": rng.integers(0, 3, (TRAIN_BATCH, gh, gh, 4 * conf.rna_num)
                             ).astype(np.float32)}
    return {k: v[lo:hi] for k, v in b.items()}


def _interleave_for_single(conf, step: int, nproc: int, per: int) -> dict:
    """Reorder the global batch so a single-process run forms the same
    (accum, micro) grid as the multi-rank assembly."""
    b = _train_batch(conf, step)
    a = conf.accum_batches
    loc_micro = per // a
    out = {}
    for k, v in b.items():
        rows = []
        for ai in range(a):
            for p in range(nproc):
                s = p * per + ai * loc_micro
                rows.append(v[s:s + loc_micro])
        out[k] = np.concatenate(rows)
    return out


def train_ref(nproc: int = 2, device="cuda", steps: int = TRAIN_STEPS,
              **conf_kw) -> list:
    """One-process reference: the global batches of an ``nproc``-rank
    run, on one device (the card unless the caller passes ``"cpu"``);
    prints and returns the loss history."""
    from ..training.harness import Trainer
    _float32()
    conf = _train_conf(**conf_kw)
    tr = Trainer(conf, device=device, mesh=False)
    state = tr.init_state()
    losses = []
    for s in range(steps):
        b = _interleave_for_single(conf, s, nproc, TRAIN_BATCH // nproc)
        state, loss = tr.train_step(state, tr.shape_batch(b))
        losses.append(float(loss))
    print("[mp_demo] train_ref losses: " +
          " ".join(f"{v:.6f}" for v in losses), flush=True)
    return losses


def train_ranks(device, steps: int = TRAIN_STEPS, **conf_kw) -> list:
    """The data-parallel training check of one rank: ``steps`` steps on
    its rows of the global batches over a ``('dp',)`` mesh of every rank,
    the replicas' digests compared after every step; rank 0 prints the
    loss history.  Returns it."""
    from ..training.harness import Trainer, state_digest
    from .mesh import host_all_gather, make_mesh, world
    rank, nproc = world()
    _float32()
    conf = _train_conf(**conf_kw)
    tr = Trainer(conf, mesh=make_mesh(("dp",), device=device))
    per = TRAIN_BATCH // nproc
    state = tr.init_state()
    losses = []
    for s in range(steps):
        loc = _train_batch(conf, s, lo=rank * per, hi=(rank + 1) * per)
        state, loss = tr.train_step(state, tr.shape_batch(loc))
        losses.append(float(loss))
        digests = host_all_gather(state_digest(state))
        if len(set(digests)) != 1:
            raise RuntimeError(f"rank {rank}: the replicas differ after "
                               f"step {s + 1}: {digests}")
    print(f"[mp_demo] process {rank} train replicas bit-equal after each "
          f"of {steps} steps", flush=True)
    if rank == 0:
        print("[mp_demo] train losses: " +
              " ".join(f"{v:.6f}" for v in losses), flush=True)
    return losses


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from .mesh import DEFAULT_TIMEOUT_S
    ap = argparse.ArgumentParser(description="multi-process generation "
                                 "and data-parallel training check "
                                 "(PyTorch port)")
    ap.add_argument("--train_ref", action="store_true",
                    help="one-process training reference (no process "
                    "group) of a --num_processes run; prints the loss "
                    "history")
    ap.add_argument("--train_only", action="store_true",
                    help="over ranks: only the data-parallel training "
                    "check")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--tiles_per_device", type=int, default=2,
                    help="tile rows and cols of each rank's block")
    ap.add_argument("--mesh_shape", default=None,
                    help="R,C ranks of the mesh (default: processes,1)")
    ap.add_argument("--fast", action="store_true",
                    help="only the in-memory mesh check")
    ap.add_argument("--band", action="store_true",
                    help="with --fast: also the band-streaming K=1 check")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card a rank, cuda:{rank %% cards}) or "
                    "cpu")
    ap.add_argument("--dist_timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds before a wait on another rank fails")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from .mesh import multihost_init, shutdown
    args = parse_args(argv)
    if args.train_ref:
        train_ref(args.num_processes or 2, args.device)
        return
    device = multihost_init(args.coordinator, args.num_processes,
                            args.process_id, device=args.device,
                            timeout_s=args.dist_timeout)
    try:
        if not args.train_only:
            check(args, device)
        if args.train_only or not args.fast:
            train_ranks(device)
    except BaseException:
        shutdown(barrier=False)
        raise
    shutdown()


def check(args: argparse.Namespace, device: torch.device) -> None:
    """The checks of one rank (``main`` after the process group is up)."""
    from .band import StripExchange, band_partition
    from .mesh import (host_barrier, host_broadcast, is_primary, make_mesh,
                       world)
    from .streaming import StreamConfig, StreamingGenerator

    rank, nproc = world()
    shape = ((nproc, 1) if args.mesh_shape is None else
             tuple(int(v) for v in args.mesh_shape.split(",")))
    mesh = make_mesh(("gr", "gc"), shape, device=device)

    # cross-rank coordination (replaces torch.distributed barrier and
    # broadcast of the reference, utils/dist_utils.py:5-24)
    token = host_broadcast(1234 if is_primary() else 0)
    if token != 1234:
        raise RuntimeError(f"rank {rank}: broadcast gave {token}")
    host_barrier("mp_demo_start")

    g = _gconf()
    tpd = args.tiles_per_device
    rows, cols = mesh.shape[0] * tpd, mesh.shape[1] * tpd

    gen = _make_gen(mesh)
    local = gen.run(gene_provider, rows=rows, cols=cols, row0=1, col0=1,
                    grid_w=16, progress=False)
    h0, w0 = gen._local_offset

    # independent one-device recomputation of the whole grid; my block
    # must agree (up to float reassociation)
    ref = _make_gen(None, device).run(gene_provider, rows=rows, cols=cols,
                                      row0=1, col0=1, grid_w=16,
                                      progress=False)
    block = ref[h0:h0 + local.shape[0], w0:w0 + local.shape[1]]
    err = float(np.abs(block - local).max())
    if not err < TOL:
        raise RuntimeError(f"process {rank} block mismatch: {err}")
    print(f"[mp_demo] process {rank}/{nproc} ok (band offset {(h0, w0)}, "
          f"local {local.shape}, mesh {mesh.shape} at {mesh.coords}, "
          f"{device}, max|diff|={err:.2e})", flush=True)

    if args.fast and not args.band:
        return

    # band-parallel host streaming (parallel/band.py): each rank streams
    # a row band, neighbouring edge strips exchanged every visit
    r0_band, n_band = band_partition(rows, nproc, rank)
    want = ref[r0_band * g.tile:(r0_band + n_band) * g.tile]

    def band_run(k: int) -> float:
        ex = StripExchange(g.pad + g.patch * (k - 1), cols * g.tile,
                           g.channels, device=device)
        sgen = StreamingGenerator(_make_gen(None, device), StreamConfig(
            progress=False, steps_per_window=k))
        hstate = sgen.run(
            n_band, cols, lambda r, c: gene_provider(r0_band + r, c),
            row0=1 + r0_band, col0=1, grid_w=16, strip_exchange=ex,
            rows_above=r0_band, rows_below=rows - r0_band - n_band)
        return float(np.abs(hstate.read.float().numpy() - want).max())

    err2 = band_run(1)
    if not err2 < TOL:
        raise RuntimeError(f"process {rank} streaming band mismatch: "
                           f"{err2}")
    print(f"[mp_demo] process {rank} band-streaming ok (rows {r0_band}.."
          f"{r0_band + n_band}, max|diff|={err2:.2e})", flush=True)
    if args.fast:
        return      # --fast --band: in-memory + band streaming K=1 only

    # temporal halo blocking (K = 2): ghost strips of pad + patch px and
    # cross-band gene rows feed the enlarged window halo
    err3 = band_run(2)
    if not err3 < TOL:
        raise RuntimeError(f"process {rank} K=2 streaming band mismatch: "
                           f"{err3}")
    print(f"[mp_demo] process {rank} band-streaming K2 ok "
          f"(max|diff|={err3:.2e})", flush=True)


if __name__ == "__main__":
    main()
