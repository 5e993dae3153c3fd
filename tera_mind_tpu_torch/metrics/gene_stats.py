"""Per-region gene-expression statistics over the brain tile grid.

Capability parity with the reference's utils/inft_mba.py: ``gn_proc``
(105-166) walks every tile of the grid, masks it by region, and streams
per-gene Welford mean/std; ``proc_gene`` (169-241) renders heatmaps of the
top/all genes and writes CSV tables.  Rebuilt here over the framework's
tile/gene providers — no sparse/seaborn dependency in the core path.
The port's own numpy copy of ``tera_mind_tpu/metrics/gene_stats.py``;
matplotlib is imported only inside :func:`save_gene_heatmaps`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np

from .stats import OnlineVariance

# provider: (row, col) -> (gh, gw, Z, G) dense per-tile gene stack (or None
# for missing tiles)
TileGeneProvider = Callable[[int, int], Optional[np.ndarray]]


def region_gene_stats(provider: TileGeneProvider,
                      tiles: Iterable[Tuple[int, int]], *,
                      gdim: int,
                      mask_fn: Optional[Callable[[int, int, np.ndarray],
                                                 np.ndarray]] = None
                      ) -> OnlineVariance:
    """Stream per-gene mean/std over a set of tiles.

    ``mask_fn(row, col, stack) -> (gh, gw) bool`` selects in-region bins
    (the reference's per-region ROI masks, inft_mba.py:117-140); rows of
    the (bins x G) observation matrix outside the mask are dropped.
    """
    ov = OnlineVariance(gdim)
    for r, c in tiles:
        stack = provider(r, c)
        if stack is None:
            continue
        g = np.asarray(stack, np.float32)
        gh, gw = g.shape[:2]
        obs = g.sum(axis=2).reshape(gh * gw, -1)[:, :gdim]  # z-summed counts
        if mask_fn is not None:
            m = np.asarray(mask_fn(r, c, g), bool).reshape(-1)
            obs = obs[m]
        if len(obs):
            ov.update(obs)
    return ov


def top_genes(ov: OnlineVariance, names: Sequence[str],
              k: int = 20) -> list[tuple[str, float, float]]:
    """Top-k genes by mean expression: (name, mean, std)."""
    order = np.argsort(ov.mean)[::-1][:k]
    return [(names[i], float(ov.mean[i]), float(ov.std[i])) for i in order]


def save_stats_csv(ov: OnlineVariance, names: Sequence[str],
                   path: str | Path) -> None:
    """Per-gene mean/std table (reference gene tables, inft_mba.py:160-166)."""
    lines = ["gene,mean,std"]
    for i, n in enumerate(names[: len(ov.mean)]):
        lines.append(f"{n},{ov.mean[i]:.6g},{ov.std[i]:.6g}")
    Path(path).write_text("\n".join(lines) + "\n")


def gene_expression_map(provider: TileGeneProvider,
                        tiles: Sequence[Tuple[int, int]],
                        gene_idx: int) -> np.ndarray:
    """Stitch a whole-region z-summed expression map for one gene
    (the raster behind proc_gene's heatmaps, inft_mba.py:169-241)."""
    rows = sorted({r for r, _ in tiles})
    cols = sorted({c for _, c in tiles})
    sample = None
    for r, c in tiles:
        sample = provider(r, c)
        if sample is not None:
            break
    assert sample is not None, "no tiles available"
    gh, gw = sample.shape[:2]
    canvas = np.zeros((len(rows) * gh, len(cols) * gw), np.float32)
    for r, c in tiles:
        stack = provider(r, c)
        if stack is None:
            continue
        i, j = rows.index(r), cols.index(c)
        canvas[i * gh:(i + 1) * gh, j * gw:(j + 1) * gw] = \
            np.asarray(stack, np.float32)[..., gene_idx].sum(axis=2)
    return canvas


def save_gene_heatmaps(provider: TileGeneProvider,
                       tiles: Sequence[Tuple[int, int]],
                       names: Sequence[str], gene_ids: Sequence[int],
                       out_dir: str | Path, *, cmap: str = "magma") -> None:
    """Expression heatmap pngs for the selected genes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for gi in gene_ids:
        canvas = gene_expression_map(provider, tiles, gi)
        fig, ax = plt.subplots(figsize=(6, 6))
        im = ax.imshow(canvas, cmap=cmap)
        fig.colorbar(im, ax=ax, shrink=0.8)
        ax.set_title(names[gi] if gi < len(names) else f"g{gi}")
        ax.set_axis_off()
        fig.savefig(out / f"{names[gi] if gi < len(names) else gi}.png",
                    bbox_inches="tight", dpi=150)
        plt.close(fig)
