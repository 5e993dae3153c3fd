"""Legacy-style blocks of the 'patch-dm' / 'sinf' baseline model families.

Port of ``tera_mind_tpu/models/legacy_blocks.py`` (channels-last): the
GroupNorm residual block with time-embedding scale/shift, the 8x8-window
single-head self-attention and the adaptive group count of the
reference's 2D-era blocks (CTPLab/Tera-MIND model/blocks.py,
model/nn.py).  Stock PyTorch ops only: in the JAX package none of these
reaches a Pallas kernel, so none reaches a kernel of the port.

Module and parameter names are the flax ones (``in_norm.gn.scale``,
``qkv``, ``proj``, ...), so ``convert.load_jax_params`` maps a flax tree
one for one.  Each weighted module computes in its weights' dtype, as
flax's ``Dense`` and ``Conv`` without ``dtype=`` compute in the promotion
of their input's and weights' dtypes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .nn import Conv3d, Dense, downsample_2x, dropout, upsample_2x


def adaptive_groups(channels: int) -> int:
    """Largest of (32, 16, 8, 4, 2) dividing ``channels`` (else 1); the
    reference's ``normalization`` (model/nn.py:172-184)."""
    for g in (32, 16, 8, 4, 2):
        if channels % g == 0:
            return min(g, channels)
    return 1


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over the channel (last) axis of a float32
    input: groups of contiguous channels, statistics over every axis but
    the batch, then ``scale`` and ``bias``.  Computed by ``F.group_norm``
    on the channels-first view: its two-pass variance and flax's
    E[x^2] - E[x]^2 (``use_fast_variance``) agree within 1e-5 at these
    activations' scales (tests/test_torch_baselines.py), and the fused op
    keeps only its input and two statistics a group for the backward."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.movedim(-1, 1), self.num_groups,
                         self.scale.float(), self.bias.float(), self.eps)
        return y.movedim(1, -1)

    def reset_affine(self) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()


class GroupNorm32(nn.Module):
    """GroupNorm over the channel (last) axis with ``adaptive_groups``
    groups and eps 1e-5, computed in float32 and cast back to the input's
    dtype (reference model/nn.py:96-98)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gn = GroupNorm(channels, adaptive_groups(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(x.float()).to(x.dtype)


class LegacyResBlock3D(nn.Module):
    """GroupNorm residual block (reference blocks.py:82-259) on
    ``(B, Z, H, W, C)``:

    in:   GroupNorm -> SiLU -> [resample] -> Conv3d(3,3,3)
    out:  GroupNorm -> *(1+scale)+shift (time emb) -> SiLU -> Dropout
          -> Conv3d (0-init)
    skip: identity | 1x1x1 conv

    Dropout runs only in training mode and only with a ``generator``."""

    def __init__(self, in_channels: int, out_channels: int,
                 emb_channels: Optional[int] = None, *, dropout: float = 0.0,
                 up: bool = False, down: bool = False,
                 use_zero_module: bool = True):
        super().__init__()
        self.up, self.down, self.dropout = up, down, dropout
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = Conv3d(in_channels, out_channels, (3, 3, 3))
        self.out_norm = GroupNorm32(out_channels)
        if emb_channels is not None:
            self.emb_proj = Dense(emb_channels, 2 * out_channels)
        self.out_conv = Conv3d(out_channels, out_channels, (3, 3, 3),
                               zero_init=use_zero_module)
        if in_channels != out_channels:
            self.skip_conv = Conv3d(in_channels, out_channels, (1, 1, 1))

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None,
                *, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = F.silu(self.in_norm(x))
        if self.up:
            h, x = upsample_2x(h), upsample_2x(x)
        elif self.down:
            h, x = downsample_2x(h), downsample_2x(x)
        h = self.out_norm(self.in_conv(h))
        if emb is not None:
            emb_out = self.emb_proj(F.silu(emb)).to(h.dtype)
            scale, shift = emb_out[:, None, None, None, :].chunk(2, dim=-1)
            h = h * (1.0 + scale) + shift
        h = F.silu(h)
        if self.training and self.dropout > 0 and generator is not None:
            h = dropout(h, self.dropout, generator)
        h = self.out_conv(h)
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return x + h


class WindowSelfAttention(nn.Module):
    """Single-head self-attention over spatial tokens, partitioned into
    ``window`` x ``window`` spatial windows when the map is larger (the
    reference's ``is_half`` path, blocks.py:448-471).  Residual, with a
    zero-init projection.

    Input ``(B, Z, H, W, C)``; attention runs over (Z * 8 * 8) tokens per
    window with the full channel width as one head, in the JAX module's
    order of roundings: the logits of ``q * c^-1/2`` and ``k`` in the
    compute dtype, the softmax in float32 cast back, ``attn @ v`` in the
    compute dtype (plain matmuls: SDPA rounds otherwise)."""

    def __init__(self, channels: int, window: int = 8, is_half: bool = True):
        super().__init__()
        self.window, self.is_half = window, is_half
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)
        self.proj.zero_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, z, hh, ww, c = x.shape
        qkv = self.qkv(self.norm(x))
        win = self.window
        use_win = self.is_half and (hh > win or ww > win)
        if use_win:
            nh, nw = hh // win, ww // win
            qkv = qkv.reshape(b, z, nh, win, nw, win, 3 * c)
            qkv = qkv.permute(0, 2, 4, 1, 3, 5, 6).reshape(
                b * nh * nw, z * win * win, 3 * c)
        else:
            qkv = qkv.reshape(b, z * hh * ww, 3 * c)

        q, k, v = qkv.chunk(3, dim=-1)
        # c^-1/2 rounded in the compute dtype (exact there as a Python float)
        scale = (1.0 / torch.sqrt(torch.tensor(float(c), dtype=q.dtype,
                                                device="cpu"))).item()
        attn = torch.matmul(q * scale, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        o = self.proj(torch.matmul(attn, v))

        if use_win:
            o = o.reshape(b, nh, nw, z, win, win, c)
            o = o.permute(0, 3, 1, 4, 2, 5, 6).reshape(b, z, hh, ww, c)
        else:
            o = o.reshape(b, z, hh, ww, c)
        return x + o
