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
from typing import Optional, Sequence

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
    """Time(+position) MLP: linear-SiLU-linear.

    With ``use_pos`` (the patch-dm baseline) the output is ``[time_half |
    pos_half]``: the time MLP and a second MLP (``pos_0``, ``pos_2``) of
    the ``pos_channels``-wide position embedding, each ``out_channels //
    2`` wide.  ``use_pos`` without ``pos_channels`` is refused: the JAX
    module asserts at its first call that a position embedding was passed,
    and ``TeraUNet`` and ``PackedTeraUNet`` pass none, so JAX fails there
    for the ``ours`` model with ``use_pos``.

    Computes in float32 whatever the model's compute dtype
    (:func:`set_compute_dtype` leaves it out), as the JAX module (no
    ``dtype=``) computes in float32 on float32 params."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 use_pos: bool = False, pos_channels: Optional[int] = None):
        super().__init__()
        if use_pos and pos_channels is None:
            raise ValueError(
                "TimeEmbed(use_pos=True) needs the position embedding's "
                "width (pos_channels): the JAX TimeEmbed asserts at its "
                "first call that a position embedding was passed, and no "
                "caller of TeraUNet or PackedTeraUNet passes one, so "
                "use_pos serves the patch-dm baseline only")
        self.use_pos = use_pos
        out = out_channels // 2 if use_pos else out_channels
        self.time_0 = Dense(in_channels, out)
        self.time_2 = Dense(out, out)
        if use_pos:
            self.pos_0 = Dense(pos_channels, out)
            self.pos_2 = Dense(out, out)

    def forward(self, t_emb: torch.Tensor,
                pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.time_2(F.silu(self.time_0(t_emb)))
        if not self.use_pos:
            return h
        if pos_emb is None:
            raise ValueError("TimeEmbed(use_pos=True) needs a position "
                             "embedding (the JAX module asserts the same)")
        p = self.pos_2(F.silu(self.pos_0(pos_emb)))
        return torch.cat([h, p], dim=-1)


class Mlp(nn.Module):
    """dense -> GELU(tanh) -> dense.  ``quant='int8'``: both denses are
    ``QuantDense`` (``ops/quant.py``; same parameter names and shapes), the
    packed model's opt-in int8 inference."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, *,
                 quant: Optional[str] = None, prequant: bool = False,
                 static_act: bool = False):
        super().__init__()
        from ..ops.quant import dense
        q = dict(quant=quant, prequant=prequant, static_act=static_act)
        self.fc1 = dense(in_features, hidden_features, **q)
        self.fc2 = dense(hidden_features, out_features or in_features, **q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


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
    that :func:`init_weights` zeroes (``use_zero_module``); ``groups`` is
    flax's ``feature_group_count`` (the weight is ``(out, in // groups,
    ...)``, as flax's kernel ``(..., in // groups, out)``).  A bf16 conv
    on the CPU runs on its operands widened to float32 and rounds the
    result to bf16, as XLA's bf16 conv does (float32 sums): PyTorch's CPU
    bf16 ``conv3d`` gets the weight gradient wrong by up to 0.9 of its
    max, and non-finite in training."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], *, padding: Optional[Sequence[int]]
                 = None, use_bias: bool = True, zero_init: bool = False,
                 groups: int = 1):
        super().__init__()
        self.padding = tuple(padding if padding is not None
                             else [(k - 1) // 2 for k in kernel])
        self.zero_init = zero_init
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_channels,
                                               in_channels // groups,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cast(x).permute(0, 4, 1, 2, 3)
        w, b = self.cast(self.weight), self.cast(self.bias)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            y = F.conv3d(x.float(), w.float(),
                         None if b is None else b.float(),
                         padding=self.padding, groups=self.groups
                         ).to(x.dtype)
        else:
            y = F.conv3d(x, w, b, padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 4, 1)


class Conv2d(Conv3d):
    """2D conv over (H, W) of a channels-last ``(B, H, W, C)`` map: the
    z-packed model's convs (``models/unet_packed.py``).  Weight
    ``(out, in, kh, kw)``; flax's HWIO kernel is its transpose.  Handed to
    ``F.conv2d`` as an NCHW view of the channels-last storage, as
    :class:`Conv3d` does, whose parameters, padding and init it shares.
    :meth:`product` is the convolution without its bias and
    :meth:`packed_bias` the bias, which a kernel that reads the product
    adds (``models/unet_packed.py``'s ResBlocks: K5's prologue, K6)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.cast(self.bias))

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias: on the card cuDNN's output
        before PyTorch's broadcast add of the bias."""
        return self._conv(x, None)

    def packed_bias(self) -> Optional[torch.Tensor]:
        """The bias (out,) in the compute dtype, as :meth:`forward`
        adds it."""
        return self.cast(self.bias)

    def _conv(self, x: torch.Tensor, bias) -> torch.Tensor:
        x = self.cast(x).permute(0, 3, 1, 2)
        y = F.conv2d(x, self.cast(self.weight), bias,
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class EquiGroupNorm(nn.Module):
    """Sliding-window shift-equivariant GroupNorm (reference model/nn.py:
    26-86, present but disabled there; kept for capability parity).

    ``ksize`` None: plain GroupNorm (two-pass variance over H, W and the
    group's channels).  Else each pixel is normalized by the mean and
    variance (E[x^2] - E[x]^2, clipped at 0) of its group's channels over
    the ``ksize`` x ``ksize`` window centred on it, after zero-padding H
    and W by ``pad``.  Input ``(..., H, W, C)`` channels-last; statistics
    in float32, the result in the input's dtype."""

    def __init__(self, channels: int, num_groups: int,
                 ksize: Optional[int] = None, pad: int = 0,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels in {num_groups} groups")
        self.num_groups, self.ksize, self.pad, self.eps = (
            num_groups, ksize, pad, eps)
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))

    def _win_mean(self, a: torch.Tensor) -> torch.Tensor:
        """Mean of (B, H', W', g, cg) over k x k windows (stride 1, no
        padding) and the group's channels: (B, H'-k+1, W'-k+1, g, 1)."""
        k, cg = self.ksize, a.shape[-1]
        s = a.sum(-1).permute(0, 3, 1, 2)
        s = F.avg_pool2d(s, k, stride=1, divisor_override=1)
        return (s / (k * k * cg)).permute(0, 2, 3, 1)[..., None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, h, w, c = x.shape
        g = self.num_groups
        xf = x.float().reshape(-1, h, w, g, c // g)
        if self.ksize is None:
            mean = xf.mean(dim=(1, 2, 4), keepdim=True)
            var = xf.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
            y = (xf - mean) * torch.rsqrt(var + self.eps)
        else:
            p, exl = self.pad, (self.ksize - 1) // 2
            xp = F.pad(xf, (0, 0, 0, 0, p, p, p, p))
            mean = self._win_mean(xp)
            var = self._win_mean(xp * xp) - mean * mean
            xc = xp[:, exl:-exl, exl:-exl] if exl else xp
            y = (xc - mean) * torch.rsqrt(var.clamp(min=0.0) + self.eps)
        y = y.reshape(*lead, *y.shape[1:3], c)
        if hasattr(self, "weight"):
            y = y * self.weight + self.bias
        return y.to(x.dtype)

    def reset_affine(self) -> None:
        if hasattr(self, "weight"):
            self.weight.data.fill_(1.0)
            self.bias.data.zero_()


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
    weights (and zero norm biases), and zero ``zero_init`` convs and
    denses.  Drawn on a CPU generator, so the weights do not depend on
    the device.  The int8 modules with a
    float weight draw as their float counterparts; prequantized ones
    (``kernel_q``) keep their buffers."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, CastsWeights)) and isinstance(
                getattr(mod, "weight", None), nn.Parameter):
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
        elif hasattr(mod, "reset_affine"):
            mod.reset_affine()
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
