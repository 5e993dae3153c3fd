"""Gene-gene attention extraction CLI (reference test_attn.py surface).

    python -m tera_mind_tpu_torch.cli.attn --calc_attn --synthetic \
        --pathway ROI --roi 0 --ckpt_pth checkpoints/{run}/ckpt

    python -m tera_mind_tpu_torch.cli.attn --is_vis --out_dir attn_tiles

Port of ``tera_mind_tpu/cli/attn.py``.  ``--calc_attn`` runs the trained
gene-gene attention block (``models/unet_attn.py``, float32, K1 for its
q-norm on the card) over a region's tiles and writes, per tile, the
pathway attention products: for each z-group (the sliding z-pairs and the
ensemble) and each selected gene g, the attention-weighted expression map
``sum_j attn[g, j] * expr[j]`` over the selected genes, then their raw
expression (reference test_attn.py:359-431); float16 tiles in a
``TileStore`` under ``--out_dir``, and ``attn_ensemble.npy``: the last
tile's ensemble attention, averaged over its patches.  ``--pathway ROI``
reads the region and its genes from ``MROI``; GLUT/DOPA/BLOD read the
genes from ``MALL``.

``--ckpt_pth`` is a reference ``.ckpt`` or the port trainer's checkpoint
directory (``{logdir}/ckpt``: its newest step, the EMA params when it has
them), with the ``config.json`` beside it (else its directory's name)
giving the preset, read as ``cli.generate`` reads it; any other path is
refused.  Without one, the weights are a seeded random init.  Gene tiles
come from ``--data_path`` (default ``Data/MERFISH_50/gene_{--mouse}``)
or, with ``--synthetic``, from one seeded field.

``--is_vis`` stitches the stored tiles into per-group heatmaps,
attention-vs-expression scatter plots with a regression line, and 3D
surfaces under ``{out_dir}/vis`` (matplotlib's Agg backend, imported
there and only there).

The extraction runs on ``--device`` (``cuda`` by default; ``cpu`` on
request): without a card it exits.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig
from ..constants import MALL, MROI
from ..convert import load_jax_params, load_pretrain_params
from ..data.tilestore import TileStore, tile_name
from ..models.nn import init_weights
from ..models.unet_attn import GeneAttnExtractor, extractor_params_from_unet
from .generate import TILE, gene_provider, run_config, synthetic_gene_grid

GDIM = 500       # genes a gene file carries (the 500-plex panel)
GSZ = 20         # gene bins a padded tile side
Z_PAD = 52       # z-slices of a gene stack, 2 pad slices included
SPAD = {1: 0, 4: 1, 8: 1, 16: 3}   # pad slices by the model's RNA z depth


def pathway_products(attn: np.ndarray, expr: np.ndarray,
                     glst: np.ndarray) -> np.ndarray:
    """attn: (G, G) row-softmax; expr: (gh, gw, G) windowed expression.

    Returns (gh, gw, 2k) for the k genes of ``glst``: for each, the map
    ``expr @ attn[g, :]`` over the selected genes, then the raw expression
    of the selected genes (reference test_attn.py:405-422)."""
    sub = attn[np.ix_(glst, glst)]            # (k, k)
    e = expr[..., glst]                       # (gh, gw, k)
    prod = np.einsum("hwk,gk->hwg", e, sub)   # attention-weighted maps
    return np.concatenate([prod, e], axis=-1)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="gene-gene attention analysis "
                                 "(PyTorch port)")
    ap.add_argument("--mouse", type=str, default="638850")
    ap.add_argument("--data_path", type=str, default="")
    ap.add_argument("--ckpt_pth", type=Path, default=None)
    ap.add_argument("--out_dir", type=str, default="./attn_tiles")
    ap.add_argument("--pathway", type=str, default="GLUT",
                    choices=("GLUT", "DOPA", "BLOD", "ROI"))
    ap.add_argument("--roi", type=int, default=0, help="MROI index")
    ap.add_argument("--hst", type=int, default=256)
    ap.add_argument("--wst", type=int, default=256)
    ap.add_argument("--hnm", type=int, default=4)
    ap.add_argument("--wnm", type=int, default=4)
    ap.add_argument("--calc_attn", action="store_true")
    ap.add_argument("--is_vis", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def apply_roi(args: argparse.Namespace) -> None:
    """``--pathway ROI``: the region's origin and grid from ``MROI``
    (pos * 32 px, size // 8 tiles a side; reference test_attn.py:465-472)."""
    if args.mouse not in MROI:
        raise SystemExit(f"--pathway ROI: no MROI presets for mouse "
                         f"{args.mouse} (have {sorted(MROI)})")
    _slst, size, pos, _gnm = MROI[args.mouse]
    if not 0 <= args.roi < len(pos):
        raise SystemExit(f"--roi {args.roi} out of range "
                         f"(mouse {args.mouse} has {len(pos)} ROIs)")
    args.hst = pos[args.roi][0] * 32
    args.wst = pos[args.roi][1] * 32
    args.hnm = args.wnm = size // 8


def _gene_names(mouse: str) -> list[str]:
    """Panel gene names (the package's own asset tables); g0..g499 for a
    panel without one."""
    csv = Path(__file__).parent.parent / "assets" / f"{mouse[:5]}_gnm.csv"
    if csv.exists():
        return [ln.strip() for ln in csv.read_text().splitlines()[1:]]
    return [f"g{i}" for i in range(GDIM)]


def pathway_genes(args: argparse.Namespace, conf: TrainConfig) -> np.ndarray:
    """Indices of the selected genes that the attention matrix covers (the
    first ``rna_num``); the first two genes when none is."""
    names = _gene_names(args.mouse)
    if args.pathway == "ROI":
        want = MROI[args.mouse][3][args.roi] if args.mouse in MROI else []
    else:
        want = MALL.get(args.pathway, [])
    glst = np.array([names.index(g) for g in want
                     if g in names and names.index(g) < conf.rna_num],
                    dtype=np.int64)
    return glst if len(glst) else np.arange(min(2, conf.rna_num))


def load_extractor(args: argparse.Namespace, conf: TrainConfig,
                   device: torch.device) -> GeneAttnExtractor:
    """The float32 extractor on ``device``: the checkpoint's
    ``rna_tower/gene_attn``, or a seeded random init."""
    ext = GeneAttnExtractor(conf.rna_num, conf.rna_slices, conf.gn_sz)
    if args.ckpt_pth is not None:
        uparams = load_pretrain_params(args.ckpt_pth, conf.make_model_conf())
        load_jax_params(ext, extractor_params_from_unet(uparams))
        print(f"trained attention weights from {args.ckpt_pth}", flush=True)
    else:
        init_weights(ext, conf.seed)
        print("WARNING: random-init attention weights", flush=True)
    return ext.to(device).eval()


@torch.no_grad()
def attn_tile(ext: GeneAttnExtractor, stack: np.ndarray, conf: TrainConfig,
              glst: np.ndarray, device: torch.device
              ) -> tuple[np.ndarray, np.ndarray]:
    """One tile's (float16 pathway maps (groups, gh, gh, 2k), attention
    stack (groups, patches, G, G)) from its (gsz, gsz, z_pad, 500) gene
    stack: the central window of ``rna_slices`` slices and the interior
    16 x 16 bins, split into patches of gn_sz x gn_sz bins (the block's
    trained granularity), each patch's attention applied to its
    z-summed expression."""
    z = conf.rna_slices
    z0 = (stack.shape[2] - z) // 2
    # windowed before the cast: the same values as JAX's cast-then-window
    win = stack[2:-2, 2:-2, z0:z0 + z, :].astype(np.float32)
    gh, gp = win.shape[0], conf.gn_sz
    p = gh // gp
    w2 = win.reshape(p, gp, p, gp, z, GDIM).transpose(0, 2, 1, 3, 4, 5)
    # the full 500-gene width: rna_grid_from_dense subsets genes per slice
    rna_dense = np.ascontiguousarray(w2).reshape(p * p, gp, gp, z * GDIM)
    attn_stack, rna_core = ext(torch.from_numpy(rna_dense).to(device))
    attn_stack = attn_stack.cpu().numpy()        # (groups, p*p, G, G)
    expr = rna_core.cpu().numpy().sum(1)         # (p*p, gp, gp, G)
    outs = []
    for a in attn_stack:                         # per z-group
        per_patch = np.stack([pathway_products(a[b], expr[b], glst)
                              for b in range(p * p)])
        outs.append(per_patch.reshape(p, p, gp, gp, -1)
                    .transpose(0, 2, 1, 3, 4).reshape(gh, gh, -1))
    return np.stack(outs).astype(np.float16), attn_stack


def calc(args: argparse.Namespace, conf: TrainConfig) -> dict:
    """``--calc_attn``: every tile of the grid through the extractor into
    the store.  Returns what ran: the extractor, the selected genes, the
    synthetic gene grid (None for gene files), the tile names, seconds."""
    device = torch.device(args.device)
    glst = pathway_genes(args, conf)
    ext = load_extractor(args, conf, device)
    store = TileStore(args.out_dir).create()
    spad = SPAD[conf.rna_slices]
    if args.synthetic:
        gene = synthetic_gene_grid(args.hnm, args.wnm, GSZ, Z_PAD, GDIM)
        tile_stack = lambda r, c: gene[r, c]   # noqa: E731
    else:
        gene = None
        tile_stack = gene_provider(
            Path(args.data_path or f"Data/MERFISH_50/gene_{args.mouse}"),
            args.hst, args.wst, gdim=GDIM, spad=spad)
    names = []
    t0 = time.perf_counter()
    for r in range(args.hnm):
        for c in range(args.wnm):
            h0, w0 = args.hst + r * TILE, args.wst + c * TILE
            tile, attn_stack = attn_tile(ext, tile_stack(r, c), conf, glst,
                                         device)
            names.append(tile_name(h0, h0 + TILE, w0, w0 + TILE))
            store.write(names[-1], tile)
    secs = time.perf_counter() - t0
    np.save(Path(args.out_dir) / "attn_ensemble.npy", attn_stack[-1].mean(0))
    print(f"attn tiles -> {args.out_dir}: {len(names)} tiles in {secs:.2f} "
          f"s ({len(names) / secs:.2f} tiles/s)", flush=True)
    return dict(extractor=ext, glst=glst, gene=gene, names=names,
                seconds=secs, conf=conf)


def _stitch(tiles: dict, names: list, grp: int, ch: int, gh: int,
            gw: int) -> np.ndarray:
    """The grid of ``tiles``' group ``grp``, channel ``ch`` as one map."""
    rows = sorted({n.split("_")[0] for n in names}, key=int)
    cols = sorted({n.split("_")[2] for n in names}, key=int)
    canvas = np.zeros((len(rows) * gh, len(cols) * gw), np.float32)
    for n, tile in tiles.items():
        r = rows.index(n.split("_")[0])
        c = cols.index(n.split("_")[2])
        canvas[r * gh:(r + 1) * gh, c * gw:(c + 1) * gw] = tile[grp, :, :, ch]
    return canvas


def vis(args: argparse.Namespace) -> None:
    """``--is_vis``: per-group heatmaps (``group{g}_ch{c}.png``),
    attention-vs-expression joint plots (``joint_ch{c}.png``, reference
    draw_attplot, test_attn.py:166-238) and 3D surfaces of the ensemble
    map (``surface_ch{c}.png``, test_attn.py:240-308) under
    ``{out_dir}/vis``."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("--is_vis needs matplotlib, which is not "
                         "installed (--calc_attn runs without it)")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    store = TileStore(args.out_dir)
    # tile entries only (the store dir also holds attn_ensemble.npy)
    names = [n for n in store.names() if n.split("_")[0].isdigit()]
    if not names:
        print("no attention tiles found", flush=True)
        return
    odir = Path(args.out_dir) / "vis"
    odir.mkdir(parents=True, exist_ok=True)
    tiles = {n: store.read(n) for n in names}
    n_groups, gh, gw, k2 = next(iter(tiles.values())).shape
    for grp in range(n_groups):
        for ch in range(k2):
            fig, ax = plt.subplots(figsize=(6, 6))
            ax.imshow(_stitch(tiles, names, grp, ch, gh, gw), cmap="magma")
            ax.set_axis_off()
            fig.savefig(odir / f"group{grp}_ch{ch}.png",
                        bbox_inches="tight", dpi=150)
            plt.close(fig)

    k = k2 // 2
    ens = n_groups - 1
    for ch in range(k):
        a = np.concatenate([t[ens, :, :, ch].reshape(-1)
                            for t in tiles.values()]).astype(np.float64)
        e = np.concatenate([t[ens, :, :, k + ch].reshape(-1)
                            for t in tiles.values()]).astype(np.float64)
        sel = (a != 0) | (e != 0)
        a, e = a[sel], e[sel]
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(e, a, s=2, alpha=0.3, color="#4477aa")
        if len(e) > 2 and e.std() > 0:
            coef = np.polyfit(e, a, 1)
            xs = np.linspace(e.min(), e.max(), 50)
            rho = float(np.corrcoef(e, a)[0, 1])
            ax.plot(xs, np.polyval(coef, xs), color="#cc3311",
                    label=f"r={rho:.3f}")
            ax.legend()
        ax.set_xlabel("expression")
        ax.set_ylabel("attention-weighted")
        fig.savefig(odir / f"joint_ch{ch}.png", bbox_inches="tight", dpi=150)
        plt.close(fig)

    for ch in range(min(k, 4)):
        canvas = _stitch(tiles, names, ens, ch, gh, gw)
        fig = plt.figure(figsize=(6, 5))
        ax3 = fig.add_subplot(projection="3d")
        yy, xx = np.mgrid[0:canvas.shape[0], 0:canvas.shape[1]]
        ax3.plot_surface(xx, yy, canvas, cmap="magma",
                         rstride=max(1, canvas.shape[0] // 64),
                         cstride=max(1, canvas.shape[1] // 64))
        fig.savefig(odir / f"surface_ch{ch}.png", bbox_inches="tight",
                    dpi=120)
        plt.close(fig)
    print(f"heatmaps/joint/surface -> {odir}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs ``--calc_attn`` then ``--is_vis``; returns :func:`calc`'s
    record (empty without ``--calc_attn``)."""
    args = parse_args(argv)
    conf = run_config(args)
    if args.pathway == "ROI":
        apply_roi(args)
    out = {}
    if args.calc_attn:
        if args.device.startswith("cuda") and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: run on the card, or pass "
                             "--device cpu")
        out = calc(args, conf)
    if args.is_vis:
        vis(args)
    return out


if __name__ == "__main__":
    main()
