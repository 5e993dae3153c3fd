"""Deterministic per-tile initial noise.

Port of ``tera_mind_tpu/data/noise.py``, ``'torch'`` backend only: every
tile's t=0 noise is ``torch.randn`` on a CPU generator seeded by an LCG
over its grid position (reference utils/MBADataset_tst.py:11-14), so any
worker regenerates a neighbour's noise without communication.  The noise
is drawn on the CPU and moved to the card by the caller: a CUDA generator
would give other numbers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def lcg(x: int, a: int = 1103515245, c: int = 12345, m: int = 2 ** 31) -> int:
    """glibc-style linear congruential step."""
    return (a * x + c) % m


def tile_seed(row: int, col: int, grid_w: int) -> int:
    return lcg(row * grid_w + col)


def tile_init_noise(row: int, col: int, grid_w: int,
                    shape: Tuple[int, ...]) -> np.ndarray:
    """Initial N(0,1) state for tile (row, col); channels-last shape."""
    g = torch.Generator().manual_seed(tile_seed(row, col, grid_w))
    return torch.randn(shape, generator=g).numpy()
