"""Tera-scale generation CLI, in-memory on one device.

    python -m tera_mind_tpu_torch.cli.generate --mouse 638850 \
        --ckpt_pth checkpoints/638850_64_229_all_4_ours/last.ckpt \
        --data_path Data/MERFISH_50/gene_638850 \
        --hst 38400 --wst 38400 --hnm 4 --wnm 4 --out_dir out/roi

    python -m tera_mind_tpu_torch.cli.generate --synthetic --hnm 2 --wnm 2

Port of ``tera_mind_tpu/cli/generate.py`` for one device: the z-packed
``PackedTeraUNet`` by default (``--no_packed``: the 5D ``TeraUNet``,
``--packed_attn``: DiT blocks on the packed tokens), in bf16, block-major
DDIM steps (eta 0), per-tile LCG noise drawn on the CPU.  Weights come
from a reference Lightning ``.ckpt`` (the preset is read from its run
directory's name) or, without one, from a seeded random init.  Gene tiles
come from the reference's per-tile COO files under ``--data_path`` or,
with ``--synthetic``, from one seeded field.  The state is spilled to
``{out_dir}_state_{epoch}`` every ``--ckpt_every`` steps; a rerun resumes
from the latest spill, or from ``--cur_epoch``'s.  The final tiles are
written to ``--out_dir`` as float16 ``.npy`` files named
``{h0}_{h1}_{w0}_{w1}``, with per-slice jpg previews under
``{out_dir}/preview`` for grids of up to 32x32 tiles.  Not ported yet:
orbax checkpoints, streaming, multi-process runs and int8.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import config_from_name, prep_config
from ..convert import (convert_unet_params, export_params, load_jax_params,
                       load_torch_state_dict)
from ..data.coo import COO
from ..data.tilestore import StateCheckpoint, TileStore, tile_name
from ..models.nn import channels_last_, init_weights
from ..models.unet import TeraUNetConfig
from ..models.unet_packed import make_packed_model, pack_unet_params
from ..parallel.generator import GeneratorConfig, TeraGenerator, grid_to_image

TILE = 256          # px per tile side, the reference's grid unit


def load_gene_tile(path: Path, *, gblk: int, gdim: int, spad: int,
                   tile: int = TILE, overlap: int = 128, pad: int = 32
                   ) -> np.ndarray:
    """One inference gene file -> (gsz, gsz, z_pad, G) dense stack.

    A file covers the tile and ``overlap`` px around it (named as the
    reference's gn_sublst, test_brn.py:51-70); bins are summed over
    ``gblk`` px and cropped to the half-patch-padded tile, and the z
    channels are zero-padded by ``spad`` slices on each side (reference
    MBADataset_tst.py:65-89)."""
    gn = COO.load_npz(path).block_sum(gblk)
    if spad > 0:
        gn = gn.pad_channels(spad * gdim, spad * gdim)
    off = (overlap - pad) // gblk
    gsz = (tile + 2 * pad) // gblk
    dense = gn.crop2d(off, off, gsz, gsz).todense(np.float32)
    return dense.reshape(gsz, gsz, dense.shape[-1] // gdim, gdim)


def gene_tile_name(h0: int, w0: int, tile: int = TILE,
                   overlap: int = 128) -> str:
    """The reference's gene file of the tile at pixel (h0, w0)."""
    return (f"{h0}_{h0 + tile}_{w0}_{w0 + tile}_{h0 - overlap}_"
            f"{h0 + tile + overlap}_{w0 - overlap}_{w0 + tile + overlap}.npz")


def gene_provider(gdir: Path, hst: int, wst: int, *, gdim: int,
                  spad: int) -> Callable[[int, int], np.ndarray]:
    """``(r, c) -> (gsz, gsz, z_pad, G)``: the gene stack of the grid's
    tile (r, c), whose top-left pixel is (hst + r*256, wst + c*256)."""
    def gene(r: int, c: int) -> np.ndarray:
        name = gene_tile_name(hst + r * TILE, wst + c * TILE)
        return load_gene_tile(gdir / name, gblk=16, gdim=gdim, spad=spad)
    return gene


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


def save_preview(out: np.ndarray, odir: Path, stain: str, stains: int,
                 n_win: int, zi: int, max_px: int = 8192) -> None:
    """One 8-bit jpg per z-slice and stain of the final (H, W, channels)
    state, channels stain-major (reference gen_img, test_brn.py:73-121);
    nothing for a state wider than ``max_px``."""
    from PIL import Image
    odir.mkdir(parents=True, exist_ok=True)
    h, w, _ = out.shape
    if h > max_px or w > max_px:
        return
    img8 = np.clip((out + 1) * 127.5, 0, 255).astype(np.uint8)
    names = ["DAPI", "PolyT"] if stains == 2 else [stain]
    for s, nm in enumerate(names):
        for sl in range(n_win * zi):
            Image.fromarray(img8[..., s * n_win * zi + sl]).save(
                odir / f"{sl}_{nm}_gen.jpg")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Tera-scale generation "
                                 "(PyTorch port)")
    ap.add_argument("--mouse", type=str, default="638850")
    ap.add_argument("--data_path", "-d", type=str, default="",
                    help="directory of the per-tile gene .npz files "
                    "(default Data/MERFISH_50/gene_{mouse})")
    ap.add_argument("--ckpt_pth", type=Path, default=None,
                    help="reference Lightning .ckpt; its directory's name "
                    "gives the preset (reference test_brn.py:337-344)")
    ap.add_argument("--out_dir", "-g", type=str, default="./output_tiles")
    ap.add_argument("--hst", type=int, default=256)
    ap.add_argument("--wst", type=int, default=256)
    ap.add_argument("--hnm", type=int, default=286)
    ap.add_argument("--wnm", type=int, default=414)
    ap.add_argument("--tot_epoch", type=int, default=15)
    ap.add_argument("--cur_epoch", type=int, default=None,
                    help="resume from this epoch's spill; default: the "
                    "latest spill, if any")
    ap.add_argument("--ckpt_every", type=int, default=5,
                    help="spill the state every this many steps (0: never)")
    ap.add_argument("--synthetic", action="store_true",
                    help="a seeded synthetic gene grid instead of gene files")
    ap.add_argument("--window_chunk", type=int, default=1,
                    help="z-windows per model call (0 = all 25)")
    ap.add_argument("--no_packed", action="store_true",
                    help="run the 5D TeraUNet instead of its z-packed "
                    "re-parameterization (models/unet_packed.py)")
    ap.add_argument("--packed_attn", action="store_true",
                    help="run the DiT blocks on the packed (h, w, z) tokens "
                    "(no unpack/pack around each block; equal up to float "
                    "reassociation)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None,
                    help="also save the final (H, W, channels) state here "
                    "as .npy")
    return ap.parse_args(argv)


def make_model(mconf: TeraUNetConfig, params5: Optional[dict] = None, *,
               seed: int = 0, packed: bool = True,
               packed_attn: bool = False) -> torch.nn.Module:
    """The model in the compute dtype on the CPU, from a 5D flax-named
    tree ``params5`` or, without one, from ``init_weights(seed)`` of the
    5D model.  ``packed``: the tree is packed (``pack_unet_params``) into
    a ``PackedTeraUNet``, as the JAX CLI does."""
    if params5 is None:
        model5 = init_weights(mconf.make_model(), seed)
        if not packed:
            return model5
        params5 = export_params(model5)
    if not packed:
        return load_jax_params(mconf.make_model(), params5)
    return load_jax_params(make_packed_model(mconf, packed_attn=packed_attn),
                           pack_unet_params(params5, mconf))


def run_config(args: argparse.Namespace):
    """The run's ``TrainConfig`` in bf16: the preset of the checkpoint's
    run directory name, or of ``--mouse``."""
    if args.ckpt_pth is not None:
        if args.ckpt_pth.suffix != ".ckpt":
            raise SystemExit(f"--ckpt_pth {args.ckpt_pth}: the port reads "
                             "reference .ckpt files only (orbax directories "
                             "come with the training slice)")
        conf = config_from_name(args.ckpt_pth.parent.name)
    else:
        conf = prep_config(args.mouse)
    conf.compute_dtype = "bfloat16"
    return conf


def build(args: argparse.Namespace):
    """(generator, model, gene grid or provider, grid origin) for
    ``args``, the model on the device."""
    device = torch.device(args.device)
    conf = run_config(args)
    mconf = conf.make_model_conf()
    params5 = None
    if args.ckpt_pth is not None:
        params5 = convert_unet_params(load_torch_state_dict(args.ckpt_pth),
                                      mconf)
        print(f"converted torch checkpoint {args.ckpt_pth}", flush=True)
    else:
        print("WARNING: random init (no checkpoint)", flush=True)
    model = make_model(mconf, params5, seed=conf.seed,
                       packed=not args.no_packed,
                       packed_attn=args.packed_attn)
    model = channels_last_(model.to(device)).eval()

    gconf = GeneratorConfig(tile=TILE, patch=conf.image_size, gn_blk=16,
                            snum=conf.rna_slices, n_slices=50,
                            stains=2 if conf.stain == "all" else 1,
                            gdim=500, window_chunk=args.window_chunk)

    def model_fn(xp, tm, rp, p1, p2):
        # sampling reads only the collage decode
        return model(xp, tm, rp, p1, p2, decode_original=False)

    sampler = conf.make_eval_sampler(T=args.tot_epoch)
    gen = TeraGenerator(sampler, model_fn, gconf, device=device)
    if args.synthetic:
        gene = synthetic_gene_grid(args.hnm, args.wnm, gconf.gsz,
                                   gconf.z_pad, gconf.gdim)
    else:
        gdir = Path(args.data_path or f"Data/MERFISH_50/gene_{conf.mouse}")
        gene = gene_provider(gdir, args.hst, args.wst, gdim=gconf.gdim,
                             spad=gconf.spad)
    return gen, model, gene, (args.hst // TILE, args.wst // TILE)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    gen, _, gene, (row0, col0) = build(args)
    c = gen.conf
    rows, cols = args.hnm, args.wnm
    ck = StateCheckpoint(f"{args.out_dir}_state", fmt="grid")
    state0 = start_t = None
    if args.cur_epoch is not None:
        grid, meta = ck.load_grid(args.cur_epoch)
        got = (meta["rows"], meta["cols"], meta["size"], meta["channels"])
        if got != (rows, cols, c.tile, c.channels):
            raise SystemExit(f"spill of epoch {args.cur_epoch} holds (rows, "
                             f"cols, size, channels) {got}, not "
                             f"{(rows, cols, c.tile, c.channels)}")
        state0 = grid_to_image(grid)
        start_t = args.tot_epoch - args.cur_epoch

    t0 = time.perf_counter()
    out = gen.run(gene, rows=rows, cols=cols, row0=row0, col0=col0,
                  grid_w=416, state=state0, start_t=start_t, checkpoint=ck,
                  checkpoint_every=args.ckpt_every)
    dt = time.perf_counter() - t0

    store = TileStore(args.out_dir).create()
    size = c.tile
    for r in range(rows):
        for cc in range(cols):
            h0, w0 = args.hst + r * size, args.wst + cc * size
            store.write(tile_name(h0, h0 + size, w0, w0 + size),
                        out[r * size:(r + 1) * size,
                            cc * size:(cc + 1) * size].astype(np.float16))
    if rows <= 32 and cols <= 32:
        save_preview(out, Path(args.out_dir) / "preview",
                     run_config(args).stain, c.stains, c.n_win, c.zi)
    if args.out:
        np.save(args.out, out)
    print(f"done: {rows}x{cols} tiles, {args.tot_epoch} steps in {dt:.2f} s;"
          f" state {out.shape} in [{out.min():.3f}, {out.max():.3f}] -> "
          f"{args.out_dir}", flush=True)
    return out


if __name__ == "__main__":
    main()
