"""Tera-scale generation CLI, in-memory on one device.

    python -m tera_mind_tpu_torch.cli.generate --synthetic --hnm 2 --wnm 2 \
        --tot_epoch 15 --out final_state.npy

Port of ``tera_mind_tpu/cli/generate.py`` on its ``--no_packed`` path: the
5D ``TeraUNet`` at the preset of ``--mouse`` in bf16, block-major DDIM
steps (eta 0), per-tile LCG noise drawn on the CPU.  This slice runs on
synthetic gene grids with seeded random weights; checkpoints, real gene
files, the packed model, streaming and multi-process runs are later
slices.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import prep_config
from ..models.nn import channels_last_, init_weights
from ..parallel.generator import GeneratorConfig, TeraGenerator


def synthetic_gene_grid(rows, cols, gsz, z_pad, gdim, seed=0,
                        overlap_bins=4):
    """Per-tile padded gene arrays sliced from ONE global field, so
    neighbouring tiles' overlap bins agree (what real data has and the
    block-major bin assembly relies on)."""
    nb = gsz - overlap_bins          # bins owned per tile side
    hb = overlap_bins // 2
    rng = np.random.default_rng(seed)
    fshape = (rows * nb + 2 * hb, cols * nb + 2 * hb, z_pad, gdim)
    field = ((rng.random(fshape) < 0.01) *
             rng.integers(1, 5, fshape)).astype(np.uint8)
    return np.stack([
        np.stack([field[r * nb: r * nb + gsz, c * nb: c * nb + gsz]
                  for c in range(cols)]) for r in range(rows)])


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Tera-scale generation "
                                 "(PyTorch port)")
    ap.add_argument("--mouse", type=str, default="638850")
    ap.add_argument("--hst", type=int, default=256)
    ap.add_argument("--wst", type=int, default=256)
    ap.add_argument("--hnm", type=int, default=286)
    ap.add_argument("--wnm", type=int, default=414)
    ap.add_argument("--tot_epoch", type=int, default=15)
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic gene grid (the only gene source of "
                    "this slice)")
    ap.add_argument("--window_chunk", type=int, default=1,
                    help="z-windows per model call (0 = all 25)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None,
                    help=".npy path for the final (H, W, channels) state")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(generator, model, gene grid, grid origin) for ``args``: the 5D
    model at the preset's full width with seeded random weights on the
    device."""
    if not args.synthetic:
        raise SystemExit("only --synthetic gene grids are supported by the "
                         "PyTorch port so far")
    device = torch.device(args.device)
    conf = prep_config(args.mouse)
    conf.compute_dtype = "bfloat16"
    mconf = conf.make_model_conf()
    model = init_weights(mconf.make_model(), conf.seed)
    model = channels_last_(model.to(device)).eval()
    print("WARNING: random init (no checkpoint)", flush=True)

    gconf = GeneratorConfig(tile=256, patch=conf.image_size, gn_blk=16,
                            snum=conf.rna_slices, n_slices=50,
                            stains=2 if conf.stain == "all" else 1,
                            gdim=500, window_chunk=args.window_chunk)

    def model_fn(xp, tm, rp, p1, p2):
        # sampling reads only the collage decode
        return model(xp, tm, rp, p1, p2, decode_original=False)

    sampler = conf.make_eval_sampler(T=args.tot_epoch)
    gen = TeraGenerator(sampler, model_fn, gconf, device=device)
    gene = synthetic_gene_grid(args.hnm, args.wnm, gconf.gsz, gconf.z_pad,
                               gconf.gdim)
    return gen, model, gene, (args.hst // 256, args.wst // 256)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    gen, _, gene, (row0, col0) = build(args)
    t0 = time.perf_counter()
    out = gen.run(gene, row0=row0, col0=col0, grid_w=416)
    dt = time.perf_counter() - t0
    print(f"done: {args.hnm}x{args.wnm} tiles, {args.tot_epoch} steps in "
          f"{dt:.2f} s; state {out.shape} in [{out.min():.3f}, "
          f"{out.max():.3f}]", flush=True)
    if args.out:
        np.save(args.out, out)
    return out


if __name__ == "__main__":
    main()
