"""Training CLI (reference train.py:7-45 argument surface), on one
device or data-parallel over ranks.

    python -m tera_mind_tpu_torch.cli.train --mouse 638850 --batch 32 \
        --patch 64 --stain all --rna_slc 4 [--synthetic]
    # data parallel, one command a rank (a card each, or sharing one):
    python -m tera_mind_tpu_torch.cli.train --synthetic \
        --coordinator 127.0.0.1:29531 --num_processes 2 --process_id 0

Port of ``tera_mind_tpu/cli/train.py`` with every JAX flag, plus
``--device`` (``cuda`` by default; without a card it refuses and names
``--device cpu``).  The 5D ``TeraUNet`` by default, ``--packed`` the
z-packed layout on the same 5D parameters; bf16 compute on float32
parameters.  Checkpoints go to ``checkpoints/{run name}/ckpt`` (see
``training/harness.py``), which ``cli.generate --ckpt_pth`` reads.

JAX's trainer spreads the batch over every device of its host by
itself; PyTorch runs a rank per device, so ``--coordinator
--num_processes --process_id`` (as ``cli.generate``'s) start one rank a
device (``cuda:{rank % cards}``; NCCL with a card a rank, else gloo).
``--batch`` stays the global batch: each rank decodes only its rows of
every microbatch of the global effective batch (with the one-process
loader's random draws, ``--workers`` or not) and trains on them, the
gradients all-reduced once a step; rank 0 writes the one checkpoint
directory.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from ..parallel.mesh import DEFAULT_TIMEOUT_S


def rank_positions(eff_batch: int, accum: int, rank: int,
                   ranks: int) -> Optional[list]:
    """Rank ``rank``'s positions in a global effective batch of ``accum``
    microbatches (None: all of them, one rank): block ``rank`` of each
    microbatch, accum row-major, the layout JAX's dp sharding gives each
    process (its ``parallel/mp_demo.py``), so the union over the ranks of
    a microbatch is the one-process microbatch."""
    if ranks == 1:
        return None
    micro = eff_batch // accum
    m = micro // ranks
    return [a * micro + rank * m + j for a in range(accum) for j in range(m)]


def epoch_batches(ds, eff_batch: int, *, workers: int = 0,
                  accum: int = 1, rank: int = 0, ranks: int = 1):
    """Endless effective-batch iterator over dataset passes.

    The loader yields EFFECTIVE batches (batch * accum samples); the
    trainer splits them into accum microbatches of `batch` samples each
    (reference accumulate_grad_batches semantics, config.py:172-174).
    Over ``ranks`` ranks each rank decodes only its rows of the global
    effective batch (:func:`rank_positions`) and skips the others with
    their random draws, so its rows are the one-process run's.  A pass
    shorter than one effective batch raises instead of spinning forever
    decoding and dropping (drop_last).
    """
    from ..data.dataset import batches
    keep = rank_positions(eff_batch, accum, rank, ranks)
    while True:
        n = 0
        for b in batches(ds, eff_batch, workers=workers, keep=keep):
            n += 1
            yield b
        if n == 0:
            raise RuntimeError(
                f"dataset pass ({len(ds)} samples) yielded no "
                f"effective batch of {eff_batch} — fewer samples than "
                "batch*accum; raise `repeat` or shrink the batch")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train Tera-MIND (PyTorch port)")
    ap.add_argument("--batch", type=int, default=32, help="global batch size")
    ap.add_argument("--patch", type=int, default=64,
                    choices=(32, 64, 128), help="model patch size")
    ap.add_argument("--mouse", type=str, default="638850",
                    choices=("609882", "609889", "638850"))
    ap.add_argument("--stain", type=str, default="all",
                    choices=("DAPI", "PolyT", "all"))
    ap.add_argument("--rna_slc", type=int, default=4, choices=(1, 4, 8, 16))
    ap.add_argument("--method", type=str, default="ours")
    ap.add_argument("--to_hbr", action="store_true",
                    help="human-brain transfer: 81-gene M2H panel")
    ap.add_argument("--data_path", type=str, default="",
                    help="root of per-tile gene npz + image files")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--net_ch", type=int, default=None,
                    help="override the base channel width (preset: 64). "
                    "The width is persisted in the run's config.json, "
                    "which cli.generate prefers over run-name parsing")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic fixture (smoke runs)")
    ap.add_argument("--workers", type=int, default=0,
                    help="loader worker PROCESSES decoding samples in "
                    "parallel (0 = one background IO thread)")
    ap.add_argument("--pretrain", type=Path, default=None,
                    help="initialize (not resume) from a checkpoint: a "
                    "torch Lightning .ckpt (converted, ema_model keys "
                    "stripped — reference experiment.py:50-58) or a port "
                    "checkpoint directory written by a previous run. "
                    "Optimizer state and step start fresh")
    ap.add_argument("--packed", action="store_true",
                    help="z-packed compute layout with exact 5D params "
                    "(checkpoints identical)")
    ap.add_argument("--packed_attn", action="store_true",
                    help="with --packed: DiT blocks on the (h,w,z)-token "
                    "packed layout (reassociation-equivalent; same "
                    "weight class)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; over ranks cuda:{rank %% "
                    "cards}) or cpu")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of rank 0's rendezvous for data "
                    "parallel training over several processes, one a "
                    "device")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--dist_timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds before a wait on another rank fails")
    return ap.parse_args(argv)


def check_card(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass "
                         "--device cpu")


def build(args: argparse.Namespace):
    """(config, dataset, trainer, initial state or None) for ``args``
    (``args.device``: this rank's device once the process group is
    up)."""
    from ..config import prep_config
    from ..constants import M2H
    from ..data.dataset import MerfishTrainDataset, SyntheticDataset
    from ..training.harness import Trainer

    check_card(args.device)
    nrna = len(M2H) if args.to_hbr else (229 if args.mouse == "638850"
                                         else 500)
    conf = prep_config(args.mouse, batch=args.batch, size=args.patch,
                       stain=args.stain, nrna=nrna, srna=args.rna_slc,
                       method=args.method, data_path=args.data_path)
    if args.net_ch:
        conf.net_ch = args.net_ch
    conf.packed_compute = args.packed
    conf.packed_attn = args.packed_attn

    if args.synthetic:
        ds = SyntheticDataset(n=max(args.batch * 8, 64), crop=4 * args.patch,
                              gdim=conf.rna_num, snum=args.rna_slc,
                              stain=args.stain, pad_bins=conf.gn_sz // 2)
    else:
        gene_files = sorted(Path(conf.data_path).glob("gene_*/*.npz"))
        if not gene_files:
            raise SystemExit(f"no gene npz under {conf.data_path}")
        # one dataset pass must yield at least one EFFECTIVE batch
        repeat = max(10, -(-2 * conf.batch_size_effective
                           // len(gene_files)))
        ds = MerfishTrainDataset(gene_files, gdim=500,
                                 gblk=conf.gn_blk, crop=4 * args.patch,
                                 snum=args.rna_slc, stain=args.stain,
                                 pad_bins=conf.gn_sz // 2, repeat=repeat,
                                 compact=True)

    trainer = Trainer(conf, device=args.device)
    state = None
    if args.pretrain is not None:
        from ..convert import load_pretrain_params
        params = load_pretrain_params(args.pretrain, conf.make_model_conf())
        state = trainer.state_from_params(params)
        print(f"pretrained init from {args.pretrain}", flush=True)
    return conf, ds, trainer, state


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI; returns the final train state (this rank's replica
    over several processes)."""
    from ..parallel.mesh import multihost_init, shutdown
    args = parse_args(argv)
    check_card(args.device)
    device = multihost_init(args.coordinator, args.num_processes,
                            args.process_id, device=args.device,
                            timeout_s=args.dist_timeout)
    args.device = str(device)
    try:
        state = train(args)
    except BaseException:
        shutdown(barrier=False)
        raise
    shutdown()
    return state


def train(args: argparse.Namespace):
    """``main`` after the process group is up."""
    conf, ds, trainer, state = build(args)
    max_steps = args.max_steps or conf.total_samples
    return trainer.fit(epoch_batches(
        ds, conf.batch_size_effective, workers=args.workers,
        accum=conf.accum_batches, rank=trainer.rank, ranks=trainer.ndp),
        max_steps=max_steps, state=state)


if __name__ == "__main__":
    main()
