"""Pure reshape ops for patch <-> image <-> shifted-collage conversion.

Port of ``tera_mind_tpu/ops/collage.py``; channels-last throughout:

- images:  ``(B, H, W, C)`` or feature maps ``(B, Z, H, W, C)``
- patches: ``(B * p1 * p2, ..., h, w, C)`` with b-major, row-major patch order
"""

from __future__ import annotations

import torch


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*p1*p2, patch, patch, C), row-major patches."""
    b, h, w, c = img.shape
    p1, p2 = h // patch, w // patch
    x = img.reshape(b, p1, patch, p2, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * p1 * p2, patch, patch, c)


def unpatchify(patches: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """(B*p1*p2, h, w, C) -> (B, p1*h, p2*w, C)."""
    bp, h, w, c = patches.shape
    b = bp // (p1 * p2)
    x = patches.reshape(b, p1, p2, h, w, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, p1 * h, p2 * w, c)


def to_collage(h: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """(B*p1*p2, Z, hh, ww, C) -> (B*(p1-1)*(p2-1), Z, hh, ww, C): the
    half-patch-shifted collage of a feature-patch batch."""
    bp, z, hh, ww, c = h.shape
    b = bp // (p1 * p2)
    half = hh // 2
    x = h.reshape(b, p1, p2, z, hh, ww, c)
    x = x.permute(0, 3, 1, 4, 2, 5, 6)            # b z p1 hh p2 ww c
    x = x.reshape(b, z, p1 * hh, p2 * ww, c)
    x = x[:, :, half:-half, half:-half]
    x = x.reshape(b, z, p1 - 1, hh, p2 - 1, ww, c)
    x = x.permute(0, 2, 4, 1, 3, 5, 6)            # b p1-1 p2-1 z hh ww c
    return x.reshape(b * (p1 - 1) * (p2 - 1), z, hh, ww, c)


def pixels_to_voxels(x: torch.Tensor, z_size: int) -> torch.Tensor:
    """(B, H, W, S*Z) stain-major pixel channels -> (B, Z, H, W, S)."""
    b, h, w, sz = x.shape
    s = sz // z_size
    return x.reshape(b, h, w, s, z_size).permute(0, 4, 1, 2, 3)


def voxels_to_pixels(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pixels_to_voxels`: (B, Z, H, W, S) -> (B, H, W, S*Z)."""
    b, z, h, w, s = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(b, h, w, s * z)
