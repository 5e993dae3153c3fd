"""Residual block of the 3D patch UNet (channels-last).

Port of ``tera_mind_tpu/models/blocks.py::ResBlock3D``:
  in:   RMSNorm -> SiLU -> [resample] -> Conv3d(3,3,3)
  out:  RMSNorm -> *(1+scale)+shift (time emb) -> SiLU -> Dropout
        -> Conv3d(0-init)
  skip: identity | 1x1x1 conv
Dropout runs only in training mode and only with a ``generator`` (the
JAX block's ``deterministic=False`` with a dropout rng), never from the
global RNG.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .nn import Conv3d, Dense, RMSNorm, downsample_2x, dropout, upsample_2x


class ResBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 emb_channels: Optional[int] = None, *, up: bool = False,
                 down: bool = False, use_zero_module: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.up, self.down = up, down
        self.dropout = dropout
        self.in_norm = RMSNorm(in_channels)
        self.in_conv = Conv3d(in_channels, out_channels, (3, 3, 3))
        self.out_norm = RMSNorm(out_channels)
        if emb_channels is not None:
            self.emb_proj = Dense(emb_channels, 2 * out_channels)
        self.out_conv = Conv3d(out_channels, out_channels, (3, 3, 3),
                               zero_init=use_zero_module)
        if in_channels != out_channels:
            self.skip_conv = Conv3d(in_channels, out_channels, (1, 1, 1))

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None,
                *, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        dt = self.in_conv.dtype
        h = F.silu(self.in_norm(x.to(dt)))
        if self.up:
            h, x = upsample_2x(h), upsample_2x(x)
        elif self.down:
            h, x = downsample_2x(h), downsample_2x(x)
        h = self.out_norm(self.in_conv(h))
        if emb is not None:
            emb_out = self.emb_proj(F.silu(emb.to(dt))).to(h.dtype)
            scale, shift = emb_out[:, None, None, None, :].chunk(2, dim=-1)
            h = h * (1.0 + scale) + shift
        h = F.silu(h)
        if self.training and self.dropout > 0 and generator is not None:
            h = dropout(h, self.dropout, generator)
        h = self.out_conv(h)
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return (x + h).to(dt)
