"""Halo padding of the spatial state (single device).

Port of ``tera_mind_tpu/parallel/halo.py::pad_halo_single``: the grid's
outer border gets ``fill`` (-1, the reference's empty background).  The
multi-device exchange is a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_halo_single(block: torch.Tensor, pad: int,
                    fill: float = -1.0) -> torch.Tensor:
    """(H, W, C) -> (H+2p, W+2p, C), constant ``fill`` border."""
    return F.pad(block, (0, 0, pad, pad, pad, pad), value=fill)
