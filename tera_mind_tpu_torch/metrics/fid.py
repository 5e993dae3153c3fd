"""d-FID: Frechet distance with the eigenvalue trace trick + streaming
masked feature moments (the port's own numpy copy of
``tera_mind_tpu/metrics/fid.py``: the same results, bit for bit).

The reference avoids ``scipy.linalg.sqrtm`` by using
``tr sqrtm(S1 S2) = sum sqrt eig(S1 S2)`` (utils/metrics.py:56-116) and
accumulates masked per-tile feature sums/second moments over the whole
brain grid (utils/feat_mba.py:320-363).  Same math here, numpy float64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """FID between two Gaussians, eigenvalue form (metrics.py:56-97)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    eig = np.linalg.eigvals(sigma1 @ sigma2)
    tr_sqrt = 2.0 * np.sqrt(np.clip(eig.real, 0.0, None)).sum()
    return float(((mu1 - mu2) ** 2).sum() + np.trace(sigma1)
                 + np.trace(sigma2) - tr_sqrt)


class StreamingMoments:
    """Streaming mean + covariance of feature batches, optionally masked
    (skip empty tiles, feat_mba.py:343-357).  O(D^2) memory, single pass."""

    def __init__(self, dim: int):
        self.n = 0.0
        self.s1 = np.zeros(dim, np.float64)
        self.s2 = np.zeros((dim, dim), np.float64)

    def add(self, feats: np.ndarray, mask: Optional[np.ndarray] = None
            ) -> None:
        f = np.asarray(feats, np.float64)
        if mask is not None:
            f = f[np.asarray(mask, bool)]
        if len(f) == 0:
            return
        self.n += len(f)
        self.s1 += f.sum(0)
        self.s2 += f.T @ f

    def finalize(self, ddof: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, cov).  ddof=1: unbiased (what `np.cov` gives); ddof=0: the
        reference's ML covariance ``scm/tot - mu mu^T``
        (metrics.py:118-122 ``calc_mean_var``) — use for numbers meant to
        be compared against the paper's d-FID."""
        assert self.n > ddof
        mu = self.s1 / self.n
        cov = (self.s2 - self.n * np.outer(mu, mu)) / (self.n - ddof)
        return mu, cov

    def merge(self, other: "StreamingMoments") -> "StreamingMoments":
        self.n += other.n
        self.s1 += other.s1
        self.s2 += other.s2
        return self


def d_fid_from_moments(a: StreamingMoments, b: StreamingMoments) -> float:
    mu1, c1 = a.finalize()
    mu2, c2 = b.finalize()
    return frechet_distance(mu1, c1, mu2, c2)
