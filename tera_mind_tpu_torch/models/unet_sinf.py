"""'sinf' baseline: flat ConvNeXt denoiser (method='sinf').

Port of ``tera_mind_tpu/models/unet_sinf.py`` (the reference baseline
CTPLab/Tera-MIND model/unet_sinf.py): a depth-16 chain of ConvNeXt blocks
at full patch resolution with U-style residual pops (the first half
pushes its outputs, the second half takes cat(x, residual, rna)).  The
RNA tower's full-resolution stage is its only conditioning.

The model predicts one eps per patch; ``forward`` also returns the
half-patch-shifted collage of those predictions as ``pred_col``, so that
it plugs into the sampler and the generator (an output-level collage).
Like the JAX module, ``forward`` takes no ``decode_original``: the JAX
package's generation CLI and in-training preview, which pass it, fail for
this model, and the port refuses them (``cli.generate``,
``Trainer.preview``).

Dtypes follow the JAX module's promotions, as in ``unet_patch_dm.py``:
the RNA tower in the compute dtype, every other module in its weights'
dtype.  The 2D convs are :class:`Conv2d` on ``(B, H, W, C)`` maps (flax
HWIO kernels, the depthwise 7x7 with ``groups``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.collage import to_collage
from .nn import Conv2d, Dense
from .rna import RNA_CHANNELS, RNATower, rna_grid_from_dense
from .unet_patch_dm import baseline_dtypes


@dataclasses.dataclass(frozen=True)
class SinfNetConfig:
    """Reference unet_sinf.py:81-150 (filters_per_layer=64, depth=16)."""

    image_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 64      # filters per layer
    depth: int = 16
    mlp_mult: int = 3
    rna_tpl: Tuple[int, ...] = (0, 1, 2, 3)
    rna_num: int = 500
    gn_sz: int = 4
    dtype_name: str = "float32"

    @property
    def z_size(self) -> int:
        return math.ceil(len(self.rna_tpl) / 2)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_name == "bfloat16" \
            else torch.float32

    def make_model(self, param_dtype: Optional[torch.dtype] = None
                   ) -> "SinfNet":
        """The model on the CPU (weights uninitialised), its parameters in
        ``param_dtype`` (default: the compute dtype), the RNA tower
        computing in the compute dtype."""
        return baseline_dtypes(SinfNet(self), self.dtype, param_dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels only, biased variance, in float32
    (unet_sinf.py:34-44); the result in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(channels))
        self.b = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (y * self.g.float() + self.b.float()).to(x.dtype)

    def reset_affine(self) -> None:
        self.g.data.fill_(1.0)
        self.b.data.zero_()


class ConvNextBlock(nn.Module):
    """Depthwise 7x7 -> (+time emb) -> LN -> 3x3 expand -> GELU -> 3x3,
    residual (unet_sinf.py:47-78).  GELU is flax's default, the tanh
    approximation."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 *, mlp_mult: int = 3, norm: bool = True):
        super().__init__()
        c = in_channels
        self.ds_conv = Conv2d(c, c, (7, 7), groups=c)
        self.emb_proj = Dense(emb_channels, c)
        if norm:
            self.norm = ChannelLayerNorm(c)
        self.conv1 = Conv2d(c, out_channels * mlp_mult, (3, 3))
        self.conv2 = Conv2d(out_channels * mlp_mult, out_channels, (3, 3))
        if c != out_channels:
            self.res_conv = Conv2d(c, out_channels, (1, 1))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.ds_conv(x)
        cond = self.emb_proj(F.gelu(emb, approximate="tanh"))
        h = h + cond[:, None, None, :].to(h.dtype)
        if hasattr(self, "norm"):
            h = self.norm(h)
        h = F.gelu(self.conv1(h), approximate="tanh")
        h = self.conv2(h)
        if hasattr(self, "res_conv"):
            x = self.res_conv(x)
        return h + x


class SinfNet(nn.Module):
    """See the module docstring.  ``generator`` is accepted for the
    trainer's call and unused (no dropout), as the JAX module ignores
    ``deterministic``."""

    def __init__(self, conf: SinfNetConfig):
        super().__init__()
        self.conf = conf
        dim, depth = conf.model_channels, conf.depth
        self.time_1 = Dense(dim, dim * 4)
        self.time_3 = Dense(dim * 4, dim)
        self.rna_tower = RNATower(conf.rna_num, len(conf.rna_tpl),
                                  conf.gn_sz)
        rch = conf.z_size * RNA_CHANNELS[-1]
        half_d = (depth + 1) // 2
        for i in range(depth):
            cin = (conf.in_channels if i == 0 else dim) if i < half_d \
                else 2 * dim + rch
            self.add_module(f"layer_{i}", ConvNextBlock(
                cin, dim, dim, mlp_mult=conf.mlp_mult, norm=(i > 0)))
        self.final_conv = Conv2d(dim, conf.out_channels, (1, 1))

    def forward(self, x: torch.Tensor, t: torch.Tensor, rna: torch.Tensor,
                p1: int, p2: int, *,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        conf = self.conf
        dt = conf.dtype
        depth, dim = conf.depth, conf.model_channels
        bp = x.shape[0]

        # time embedding: sin-first sinusoid -> Dense(4d) -> GELU ->
        # Dense(d) (unet_sinf.py:19-31, 181-186), repeated per patch
        t_rep = t.repeat_interleave(bp // t.shape[0])
        half = dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=t.device)
                          * (-math.log(10000.0) / (half - 1)))
        args = t_rep.float()[:, None] * freqs[None]
        t_emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
        emb = self.time_3(F.gelu(self.time_1(t_emb), approximate="tanh"))

        # RNA tower; only the full-resolution stage conditions this model
        rna_grid = rna_grid_from_dense(rna.to(dt), len(conf.rna_tpl),
                                       conf.rna_num)
        rfull = self.rna_tower(rna_grid)[0][-1]     # (Bp, z2, ps, ps, 32)
        b2, zz, hh, ww, cc = rfull.shape
        rfull = rfull.permute(0, 2, 3, 1, 4).reshape(b2, hh, ww, zz * cc)

        h = x.to(dt)
        residuals = []
        half_d = (depth + 1) // 2
        for i in range(half_d):
            h = getattr(self, f"layer_{i}")(h, emb)
            residuals.append(h)
        for i in range(half_d, depth):
            h = torch.cat([h, residuals.pop(), rfull.to(h.dtype)], dim=-1)
            h = getattr(self, f"layer_{i}")(h, emb)

        pred = self.final_conv(h).float()
        # output-level collage for sampler compatibility
        pred_col = to_collage(pred[:, None], p1, p2)[:, 0]
        return pred_col, pred
