"""Nuclei morphology statistics (reference calc_cellpose,
utils/metrics.py:153-199): per-tile nuclei count, size and mean-intensity
distributions for generated-vs-real comparison.

Cellpose is not available in this environment; the default segmenter is a
classical threshold + watershed-free connected-components pipeline
(scipy.ndimage), which is deterministic and dependency-free.  When cellpose
IS importable it is used instead (same stats downstream).  The port's
own numpy/scipy copy of ``tera_mind_tpu/metrics/morphology.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class NucleiStats:
    count: int
    sizes: np.ndarray        # px per nucleus
    intensities: np.ndarray  # mean intensity per nucleus

    def summary(self) -> dict:
        return {
            "count": int(self.count),
            "size_mean": float(self.sizes.mean()) if self.count else 0.0,
            "size_std": float(self.sizes.std()) if self.count else 0.0,
            "intensity_mean": float(self.intensities.mean())
            if self.count else 0.0,
        }


def _segment_classical(img01: np.ndarray, *, thresh: Optional[float] = None,
                       min_size: int = 12) -> np.ndarray:
    from scipy import ndimage as ndi
    if thresh is None:
        # Otsu-style: maximize between-class variance on the histogram
        hist, edges = np.histogram(img01, bins=128, range=(0, 1))
        p = hist.astype(np.float64) / max(hist.sum(), 1)
        omega = np.cumsum(p)
        mu = np.cumsum(p * (edges[:-1] + edges[1:]) / 2)
        mu_t = mu[-1]
        denom = omega * (1 - omega)
        denom[denom == 0] = np.inf
        sigma_b = (mu_t * omega - mu) ** 2 / denom
        # split at bin i puts bin i in the BACKGROUND class (omega is an
        # inclusive cumsum), so the threshold is that bin's right edge
        thresh = float(edges[np.argmax(sigma_b) + 1])
    mask = img01 > thresh
    mask = ndi.binary_opening(mask, iterations=1)
    labels, n = ndi.label(mask)
    if min_size > 1 and n:
        sizes = ndi.sum_labels(np.ones_like(labels), labels,
                               np.arange(1, n + 1))
        small = np.flatnonzero(sizes < min_size) + 1
        labels[np.isin(labels, small)] = 0
        labels, n = ndi.label(labels > 0)
    return labels


def _segment_cellpose(img01: np.ndarray) -> Optional[np.ndarray]:
    try:
        from cellpose import models
    except ImportError:
        return None
    model = models.Cellpose(model_type="nuclei")
    masks, *_ = model.eval([img01 * 255], diameter=None, channels=[0, 0])
    return masks[0]


def nuclei_stats(img: np.ndarray, *, use_cellpose: bool = True,
                 expression: Optional[np.ndarray] = None) -> NucleiStats:
    """img: (H, W) in [-1,1] or [0,1].  Optional ``expression`` map is
    averaged per nucleus instead of image intensity (the reference computes
    per-nucleus gene expression, metrics.py:176-191)."""
    from scipy import ndimage as ndi
    x = np.asarray(img, np.float32)
    if x.min() < 0:
        x = (x + 1) / 2
    labels = _segment_cellpose(x) if use_cellpose else None
    if labels is None:
        labels = _segment_classical(x)
    n = int(labels.max())
    if n == 0:
        return NucleiStats(0, np.zeros(0), np.zeros(0))
    idx = np.arange(1, n + 1)
    sizes = ndi.sum_labels(np.ones_like(x), labels, idx)
    src = expression if expression is not None else x
    inten = ndi.mean(src, labels, idx)
    return NucleiStats(n, np.asarray(sizes), np.asarray(inten))


def stats_from_masks(img: np.ndarray, masks) -> Optional[tuple]:
    """Mask→stats stage of the reference's ``calc_cellpose``
    (utils/metrics.py:157-191) with the segmenter factored out.

    img: (B, C, H, W) uint8-range array; slice ``v`` is valid iff its
    channel-0 has any nonzero pixel (metrics.py:159).  ``masks``: integer
    label maps (H, W), one per VALID slice in valid-slice order — exactly
    what cellpose's ``mod.eval`` returns.  Returns ``(nstat, narea, valid)``
    matching the reference's ``met['nstat'/'narea'/'valid']`` entries:

    - nstat (1+C, B): row 0 = nuclei count per slice; rows 1..C = per-channel
      mean intensity of the /255-scaled slice (metrics.py:166, 176-178)
    - narea (mlen, B): per-nucleus pixel counts (background label dropped),
      rows truncated to the max count (metrics.py:175-185)
    - valid: indices of non-black slices

    Returns None when every slice is black (reference early-out,
    metrics.py:161-163).
    """
    img = np.asarray(img)
    im = img.astype(np.float64) / 255.0
    valid = [v for v in range(img.shape[0]) if (img[v, 0] != 0).any()]
    if not valid:
        return None
    masks = list(masks)
    assert len(masks) == len(valid), (len(masks), len(valid))
    n_b, n_c = img.shape[:2]
    expr = im.mean((-1, -2))
    nstat = np.zeros((1 + n_c, n_b), np.float32)
    narea = np.zeros((512, n_b), np.float32)
    for mid, msk in zip(valid, masks):
        # per-label pixel counts with the first (background) bucket dropped
        cnt = np.unique(msk, return_counts=True)[1][1:]
        nstat[0, mid] = len(cnt)
        nstat[1:, mid] = expr[mid]
        narea[: len(cnt), mid] = cnt
    mlen = int(nstat[0].max())
    assert mlen <= narea.shape[0]
    return nstat, narea[:mlen], valid


def compare_morphology(gen_tiles, real_tiles, **kw) -> dict:
    """Aggregate morphology deltas between generated and real tile streams."""
    agg = {"gen": [], "real": []}
    for key, tiles in (("gen", gen_tiles), ("real", real_tiles)):
        for t in tiles:
            agg[key].append(nuclei_stats(t, **kw).summary())
    out = {}
    for key in ("count", "size_mean", "intensity_mean"):
        g = np.array([s[key] for s in agg["gen"]])
        r = np.array([s[key] for s in agg["real"]])
        out[f"{key}_gen"] = float(g.mean()) if len(g) else 0.0
        out[f"{key}_real"] = float(r.mean()) if len(r) else 0.0
        out[f"{key}_rel_err"] = float(abs(out[f"{key}_gen"]
                                          - out[f"{key}_real"])
                                      / (abs(out[f"{key}_real"]) + 1e-8))
    return out
