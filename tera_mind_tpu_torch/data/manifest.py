"""Training-manifest preparation (reference utils/dataset_util.py:8-35).

Port of ``tera_mind_tpu/data/manifest.py`` (the same CSV files).

Enumerates the per-mouse tile grid, checks which gene/image tile pairs
exist on disk, and writes the CSV manifests the training dataset consumes.
Cross-mouse convention preserved: mouse 609882 trains on 609889's list and
vice versa; 638850 trains on the union (reference MBADataset.py:50-57).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List


def tile_grid_paths(root: str | Path, mouse: str, *, tile: int = 512,
                    rows: int = 144, cols: int = 208) -> List[Path]:
    """Candidate training gene-tile paths over the atlas grid."""
    root = Path(root)
    out = []
    for r in range(rows):
        for c in range(cols):
            h0, w0 = r * tile, c * tile
            out.append(root / f"gene_{mouse}"
                       / f"{h0}_{h0+tile}_{w0}_{w0+tile}.npz")
    return out


def prep_manifest(root: str | Path, mouse: str, out_csv: str | Path, *,
                  tile: int = 512, rows: int = 144, cols: int = 208,
                  require_image: bool = True) -> int:
    """Write a CSV of existing gene tiles (column 'pth'); returns count."""
    kept = []
    for p in tile_grid_paths(root, mouse, tile=tile, rows=rows, cols=cols):
        if not p.exists():
            continue
        if require_image:
            img = Path(str(p).replace("gene", "img").replace(".npz", ".npy"))
            if not img.exists():
                continue
        kept.append(p)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pth"])
        for p in kept:
            w.writerow([str(p)])
    return len(kept)


def load_manifest(csv_path: str | Path) -> List[str]:
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    if not rows or rows[0] != ["pth"]:
        raise ValueError(f"bad manifest {csv_path}")
    return [r[0] for r in rows[1:]]


def train_paths_for_mouse(manifest_dir: str | Path, mouse: str,
                          use_exl: bool = False) -> List[str]:
    """Cross-mouse training lists (reference MBADataset.py:49-57)."""
    sfx = "_exl" if use_exl else ""
    d = Path(manifest_dir)
    if mouse == "609882":
        return load_manifest(d / f"609889{sfx}.csv")
    if mouse == "609889":
        return load_manifest(d / f"609882{sfx}.csv")
    if mouse == "638850":
        return (load_manifest(d / f"609882{sfx}.csv")
                + load_manifest(d / f"609889{sfx}.csv"))
    raise ValueError(mouse)
