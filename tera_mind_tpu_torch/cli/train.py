"""Training CLI on one device (reference train.py:7-45 argument surface).

    python -m tera_mind_tpu_torch.cli.train --mouse 638850 --batch 32 \
        --patch 64 --stain all --rna_slc 4 [--synthetic]

Port of ``tera_mind_tpu/cli/train.py`` with every JAX flag, plus
``--device`` (``cuda`` by default; without a card it refuses and names
``--device cpu``).  The 5D ``TeraUNet`` by default, ``--packed`` the
z-packed layout on the same 5D parameters; bf16 compute on float32
parameters.  Checkpoints go to ``checkpoints/{run name}/ckpt`` (see
``training/harness.py``), which ``cli.generate --ckpt_pth`` reads.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence


def epoch_batches(ds, eff_batch: int, *, workers: int = 0):
    """Endless effective-batch iterator over dataset passes.

    The loader yields EFFECTIVE batches (batch * accum samples); the
    trainer splits them into accum microbatches of `batch` samples each
    (reference accumulate_grad_batches semantics, config.py:172-174).
    A pass shorter than one effective batch raises instead of spinning
    forever decoding and dropping (drop_last).
    """
    from ..data.dataset import batches
    while True:
        n = 0
        for b in batches(ds, eff_batch, workers=workers):
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
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(config, dataset, trainer, initial state or None) for ``args``."""
    import torch

    from ..config import prep_config
    from ..constants import M2H
    from ..data.dataset import MerfishTrainDataset, SyntheticDataset
    from ..training.harness import Trainer

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass "
                         "--device cpu")
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
    args = parse_args(argv)
    conf, ds, trainer, state = build(args)
    max_steps = args.max_steps or conf.total_samples
    return trainer.fit(epoch_batches(ds, conf.batch_size_effective,
                                     workers=args.workers),
                       max_steps=max_steps, state=state)


if __name__ == "__main__":
    main()
