"""Figure-generation utilities: ROI extraction, zoom insets, coloured
overlays, ontology composites, metric tables and small stitched grids.

Port of ``tera_mind_tpu/assembly/vis.py`` (capability parity with the
reference's utils/vis_mba.py), the same numpy code.  Images are
channels-last numpy arrays; WSI-scale inputs are read through the tile
store, never materialized whole.  Pillow is imported inside
:func:`save_png` only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,1] float -> uint8."""
    x = np.asarray(img, np.float32)
    if x.min() < 0:
        x = (x + 1) / 2
    return np.clip(x * 255, 0, 255).astype(np.uint8)


def gen_roi(img: np.ndarray, top: int, left: int, h: int, w: int,
            border: int = 4,
            color: Tuple[int, int, int] = (255, 0, 0)
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Crop an ROI and return (roi, annotated_full) with the ROI outlined
    (reference vis_mba.py:80-115)."""
    roi = img[top:top + h, left:left + w].copy()
    full = np.stack([to_uint8(img)] * 3, -1) if img.ndim == 2 \
        else to_uint8(img).copy()
    c = np.asarray(color, np.uint8)
    full[top:top + border, left:left + w] = c
    full[top + h - border:top + h, left:left + w] = c
    full[top:top + h, left:left + border] = c
    full[top:top + h, left + w - border:left + w] = c
    return roi, full


def gen_zoom(img: np.ndarray, top: int, left: int, size: int,
             scale: int = 4) -> np.ndarray:
    """Nearest-neighbor zoom inset (reference vis_mba.py:182-239)."""
    roi = img[top:top + size, left:left + size]
    return np.repeat(np.repeat(roi, scale, axis=0), scale, axis=1)


def color_overlay(base: np.ndarray,
                  layers: Sequence[np.ndarray],
                  colors: Sequence[Tuple[float, float, float]],
                  alpha: float = 0.7) -> np.ndarray:
    """Compose intensity maps over a grayscale base with additive colors
    (reference onto_overlay / attention overlays, vis_mba.py:118-179,
    365-393; pathway palettes in constants.CM)."""
    g = to_uint8(base).astype(np.float32)
    out = np.stack([g] * 3, -1)
    for layer, col in zip(layers, colors):
        l01 = np.asarray(layer, np.float32)
        rng = l01.max() - l01.min()
        if rng > 0:
            l01 = (l01 - l01.min()) / rng
        for ch in range(3):
            out[..., ch] = out[..., ch] * (1 - alpha * l01) \
                + 255.0 * col[ch] * alpha * l01
    return np.clip(out, 0, 255).astype(np.uint8)


def region_mask(onto: np.ndarray, region: str = "all") -> np.ndarray:
    """Zero an ontology-mask outside the selected region (the reference's
    add_onto modes, vis_mba.py:141-160): all | half (left) | rhalf | thalf
    | bhalf/main (bottom) | quarter (top-left) | 3quarter (all minus
    top-right)."""
    h, w = onto.shape[:2]
    msk = np.array(onto, copy=True)
    if region == "all":
        return msk
    keep = np.zeros_like(msk)
    if region == "quarter":
        keep[:h // 2, :w // 2] = msk[:h // 2, :w // 2]
    elif region in ("main", "bhalf"):
        keep[h // 2:] = msk[h // 2:]
    elif region == "half":
        keep[:, :w // 2] = msk[:, :w // 2]
    elif region == "rhalf":
        keep[:, w // 2:] = msk[:, w // 2:]
    elif region == "thalf":
        keep[:h // 2] = msk[:h // 2]
    elif region == "3quarter":
        keep = msk
        keep[:h // 2, w // 2:] = 0
    else:
        raise ValueError(f"unknown region {region!r}")
    return keep


def onto_overlay(img: np.ndarray, onto: np.ndarray, *,
                 region: str = "all", alpha: int = 100,
                 bright: Optional[float] = None) -> np.ndarray:
    """Alpha-composite an RGB ontology mask over an image
    (reference onto_overlay, vis_mba.py:118-179, pyvips composite 'over'
    at integer alpha 0-255 wherever the mask is non-zero; optional
    brightness boost of the underlying image first)."""
    base = to_uint8(img)
    if base.ndim == 2:
        base = np.stack([base] * 3, -1)
    base = base.astype(np.float32)
    if bright is not None:
        base = np.clip(base * bright, 0, 255)
    msk = region_mask(to_uint8(onto), region).astype(np.float32)
    a = (alpha / 255.0) * (msk.sum(-1, keepdims=True) != 0)
    out = base * (1 - a) + msk * a
    return np.clip(out, 0, 255).astype(np.uint8)


def merge_mask(img: np.ndarray, mask: np.ndarray,
               alpha: int = 100) -> np.ndarray:
    """Binarized-mask composite (reference merg_msk, vis_mba.py:448-474):
    any non-zero mask pixel becomes a white overlay at ``alpha``."""
    m = np.asarray(mask)
    binary = (m.sum(-1) if m.ndim == 3 else m) != 0
    white = np.full(3, 255, np.uint8)
    onto = binary[..., None] * white
    return onto_overlay(img, onto, alpha=alpha)


def metric_table(rows: Iterable[dict], columns: Sequence[str]) -> str:
    """CSV-ish metric table rendering (vis_mba.py:241-275 reshapes metric
    CSVs for the paper; here: plain aligned text)."""
    rows = list(rows)
    widths = {c: max(len(c), *(len(f"{r.get(c, '')}") for r in rows))
              for c in columns}
    out = ["  ".join(c.ljust(widths[c]) for c in columns)]
    for r in rows:
        out.append("  ".join(f"{r.get(c, '')}".ljust(widths[c])
                             for c in columns))
    return "\n".join(out)


def save_png(img: np.ndarray, path: str | Path) -> None:
    from PIL import Image
    arr = to_uint8(img) if img.dtype != np.uint8 else img
    Image.fromarray(arr).save(path)


def stitch_tiles(read_tile, rows: int, cols: int, tile: int = 256,
                 max_px: int = 16384) -> Optional[np.ndarray]:
    """Stitch a small grid for figures; refuses WSI-scale requests."""
    if rows * tile > max_px or cols * tile > max_px:
        return None
    out = None
    for r in range(rows):
        for c in range(cols):
            t = np.asarray(read_tile(r, c))
            if out is None:
                out = np.zeros((rows * tile, cols * tile) + t.shape[2:],
                               t.dtype)
            out[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = t
    return out
