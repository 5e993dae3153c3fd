"""Streaming statistics: Welford online mean/variance for per-gene
expression tables over the whole brain grid (reference
utils/inft_mba.py:17-45 ``OnlineVariance``).

The port's own numpy copy of ``tera_mind_tpu/metrics/stats.py``: the same
results, bit for bit."""

from __future__ import annotations

from typing import Optional

import numpy as np


class OnlineVariance:
    """Chan/Welford parallel-merge online mean and variance over batches of
    per-element vectors (e.g. per-gene counts).

    ``update(batch, mask)`` supports the reference's per-element masked
    accumulation (inft_mba.py:28-38 ``include(dat, bat)``): counts are kept
    PER DIMENSION, and masked-out entries contribute nothing — used for
    per-region gene stats where a gene's coverage varies across tiles.
    """

    def __init__(self, dim: int):
        self.n = np.zeros(dim, np.float64)
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, batch: np.ndarray,
               mask: Optional[np.ndarray] = None) -> None:
        """batch: (N, dim) observations; mask: optional (N, dim) 0/1."""
        b = np.asarray(batch, np.float64)
        if b.ndim == 1:
            b = b[None]
        if len(b) == 0:
            return
        if mask is None:
            m = np.ones_like(b)
        else:
            m = np.asarray(mask, np.float64)
            if m.ndim == 1:
                m = m[None]
        nb = m.sum(0)
        tot = self.n + nb
        safe = np.where(tot == 0, 1.0, tot)
        # batched Welford with per-dim masked counts (matches the
        # reference's sequential include() exactly for batch rows applied
        # in order; we apply the whole batch via the pairwise-merge form)
        msum = (b * m).sum(0)
        b_mean = msum / np.where(nb == 0, 1.0, nb)
        b_m2 = (((b - b_mean) ** 2) * m).sum(0)
        delta = b_mean - self.mean
        self.mean += delta * nb / safe
        self.m2 += b_m2 + delta ** 2 * self.n * nb / safe
        self.n = tot

    @property
    def variance(self) -> np.ndarray:
        return self.m2 / np.maximum(self.n - 1, 1.0)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)
