"""Neural-net primitives, channels-last ``(B, Z, H, W, C)``.

Port of ``tera_mind_tpu/models/nn.py``.  A module with weights (``Dense``,
``Conv3d`` and its subclasses: :class:`CastsWeights`) computes in its
``compute_dtype``: it casts its input and its weights to that dtype at
use, as flax's ``dtype=`` does over float32 params ("bf16 compute, f32
params"), so training keeps float32 master weights.  Generation casts the
weights to the compute dtype once (``TeraUNetConfig.make_model()``), and
the cast at use is then a no-op.  ``TimeEmbed`` computes in float32, as
the JAX module (no ``dtype=``) does.  ``RMSNorm`` computes in its input's
dtype and hands its weight as it is to K1 (which casts it to the input's
dtype) and K1b (which reads it as float32).  Parameter names follow the
flax ones (``kernel`` -> ``weight``), so ``convert.load_jax_params`` maps
a flax tree one for one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rmsnorm_kernel import rmsnorm


class CastsWeights:
    """Mixin of the modules that cast their input and weights at use to
    ``compute_dtype`` (None, the default: the weights' own dtype), set by
    :func:`set_compute_dtype`."""

    compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        """The dtype this module computes in."""
        return self.compute_dtype or self.weight.dtype

    def cast(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t.to(self.dtype)


class RMSNorm(nn.Module):
    """RMS norm over the channel (last) axis, statistics in float32.

    CUDA tensors (float32 or bf16) go through K1 (``ops/rmsnorm_kernel``),
    CPU tensors through its plain version."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order (cos first)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(CastsWeights, nn.Linear):
    """``nn.Linear`` in its compute dtype (flax Dense with ``dtype=``).
    Weight is ``(out, in)``; flax's kernel is its transpose."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.cast(x), self.cast(self.weight),
                        self.cast(self.bias))


class TimeEmbed(nn.Module):
    """Time MLP: linear-SiLU-linear (the position half of the JAX module,
    ``use_pos``, serves the patch-dm baseline, not ported yet).

    Computes in float32 whatever the model's compute dtype
    (:func:`set_compute_dtype` leaves it out), as the JAX module (no
    ``dtype=``) computes in float32 on float32 params."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.time_0 = Dense(in_channels, out_channels)
        self.time_2 = Dense(out_channels, out_channels)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.time_2(F.silu(self.time_0(t_emb)))


class Mlp(nn.Module):
    """dense -> GELU(tanh) -> dense."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, out_features or in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def modulate(norm: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: norm(x) * (1 + scale) + shift."""
    return norm(x) * (scale + 1.0) + shift


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element where a uniform draw from
    ``generator`` is below 1 - rate, and scale the kept ones by
    1 / (1 - rate) in x's dtype."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Conv3d(CastsWeights, nn.Module):
    """3D conv over (Z, H, W) of a channels-last ``(B, Z, H, W, C)`` map.

    Padding defaults to the symmetric ``(k - 1) // 2`` per axis (the JAX
    ``conv3d``).  The input is handed to ``F.conv3d`` as an NCDHW view of
    the channels-last storage (``channels_last_3d`` strides, no copy) and
    the result is viewed back.  ``zero_init`` marks the residual out-convs
    that :func:`init_weights` zeroes (``use_zero_module``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], *, padding: Optional[Sequence[int]]
                 = None, use_bias: bool = True, zero_init: bool = False):
        super().__init__()
        self.padding = tuple(padding if padding is not None
                             else [(k - 1) // 2 for k in kernel])
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cast(x).permute(0, 4, 1, 2, 3)
        y = F.conv3d(x, self.cast(self.weight), self.cast(self.bias),
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class Conv2d(Conv3d):
    """2D conv over (H, W) of a channels-last ``(B, H, W, C)`` map: the
    z-packed model's convs (``models/unet_packed.py``).  Weight
    ``(out, in, kh, kw)``; flax's HWIO kernel is its transpose.  Handed to
    ``F.conv2d`` as an NCHW view of the channels-last storage, as
    :class:`Conv3d` does, whose parameters, padding and init it shares."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cast(x).permute(0, 3, 1, 2)
        y = F.conv2d(x, self.cast(self.weight), self.cast(self.bias),
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x spatial upsample of (B, Z, H, W, C); z untouched."""
    b, z, h, w, c = x.shape
    x = x[:, :, :, None, :, None, :].expand(b, z, h, 2, w, 2, c)
    return x.reshape(b, z, h * 2, w * 2, c)


def downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 spatial average-pool of (B, Z, H, W, C); z untouched."""
    b, z, h, w, c = x.shape
    return x.reshape(b, z, h // 2, 2, w // 2, 2, c).mean(dim=(3, 5))


# flax's variance_scaling "truncated_normal": the std of a standard normal
# cut to [-2, 2], which the draw is divided by to keep the variance
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in the JAX package's scheme: lecun-normal
    kernels as flax's ``variance_scaling(1.0, "fan_in",
    "truncated_normal")`` draws them (a standard normal cut to [-2, 2],
    times ``sqrt(1 / fan_in) / TRUNC_STD``), zero biases, unit norm
    weights, and zero ``zero_init`` convs.  Drawn on a CPU generator, so
    the weights do not depend on the device."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, Conv3d)):   # and Conv3d's subclasses
            w = mod.weight
            fan_in = w[0].numel()
            val = torch.zeros(w.shape)
            if not getattr(mod, "zero_init", False):
                nn.init.trunc_normal_(val, 0.0, 1.0, -2.0, 2.0, generator=g)
                val *= math.sqrt(1.0 / fan_in) / TRUNC_STD
            w.copy_(val)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype, *,
                      param_dtype: Optional[torch.dtype] = None
                      ) -> nn.Module:
    """Store ``model``'s parameters in ``param_dtype`` (default: ``dtype``,
    as generation runs) with ``TimeEmbed``'s kept float32, and make every
    weighted module but ``TimeEmbed``'s compute in ``dtype``: in its
    weights' dtype when that is ``dtype``, else by casting them at use
    (float32 master weights for training).  Returns ``model``."""
    param_dtype = param_dtype or dtype
    model.to(param_dtype)
    for mod in model.modules():
        if isinstance(mod, CastsWeights):
            mod.compute_dtype = None if param_dtype == dtype else dtype
    for mod in model.modules():
        if isinstance(mod, TimeEmbed):
            mod.float()
            for sub in mod.modules():
                if isinstance(sub, CastsWeights):
                    sub.compute_dtype = None
    return model


def channels_last_(model: nn.Module) -> nn.Module:
    """Store every conv kernel channels-last (``channels_last_3d`` or, for
    2D kernels, ``channels_last``) so cuDNN runs the channels-last
    convolution without converting the weight per call."""
    for mod in model.modules():
        if isinstance(mod, Conv3d):
            fmt = torch.channels_last if mod.weight.dim() == 4 \
                else torch.channels_last_3d
            mod.weight.data = mod.weight.data.contiguous(memory_format=fmt)
    return model
