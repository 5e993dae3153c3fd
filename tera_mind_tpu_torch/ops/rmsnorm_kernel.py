"""K1: RMSNorm forward, y = x * rsqrt(mean(x^2, -1) + eps) * w.

Replaces the Pallas TPU kernel ``tera_mind_tpu/ops/rmsnorm_kernel.py``
(``rmsnorm_fused``, ``_kernel``).  On Hopper it is bound by memory: one
read and one write of ``rows * C`` elements.  ``rmsnorm_variant`` picks
one of two CUDA kernels (``csrc/rmsnorm.cu``) from C, dtype and pointer
alignment before the launch:

- ``vector``: C % 8 == 0, a row of at most 2,048 bytes (C <= 1024 in bf16,
  512 in float32), and x, w, y 16-byte aligned.  A group of lanes sized to
  C holds the row in registers from 16-byte loads, reduces it with warp
  shuffles and writes y from the same registers.
- ``strided``: any other C (741 and 1,253 on the main path) or pointer;
  one warp per row with a strided loop.

Any row count works, so the TPU kernel's fallback for rows that do not
block has no counterpart: a CUDA tensor always goes through a kernel.

Statistics are float32.  For bf16 the rounding follows the TPU kernel
(inv and w cast to bf16 before the two multiplies); for float32 the
result is ``w * (x * inv)``, the JAX package's f32 formula.

K1b, the backward (``csrc/rmsnorm_bwd.cu``), replaces the TPU kernel's
``custom_vjp`` rule ``_bwd``: dx per row from x, g and the float32
weight with the statistics recomputed in float32, dw from per-block
partial sums reduced in a second kernel (no atomics, so deterministic).
``rmsnorm`` dispatches: without a gradient to record, the raw K1 launch
(or the plain version on the CPU); with one, :class:`RMSNormFunction`,
whose forward is K1 and backward K1b (on the CPU the plain forward and
the plain ``_bwd`` formula).
"""

from __future__ import annotations

import sys

import torch

from . import _build

VEC_MAX_ROW_BYTES = 2048   # csrc/rmsnorm.cu kVecMaxBytes
VARIANTS = ("strided", "vector")   # csrc/rmsnorm.cu codes
BWD_WARPS = 8              # csrc/rmsnorm_bwd.cu kBwdWarps: rows a block
BWD_MAX_BLOCKS = 8 * 132   # csrc/rmsnorm_bwd.cu kMaxBlocks
BWD_MAX_C = 7264           # csrc/rmsnorm_bwd.cu kMaxC

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)
bwd = _build.Counters(("rowwise",))   # K1b's launches


def reset_launches() -> None:
    """Set K1's and K1b's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])
    _build.reset_launches(bwd)


def bwd_blocks(rows: int) -> int:
    """The grid of K1b's row kernel: a warp a row, at most
    ``BWD_MAX_BLOCKS`` blocks (the rows of ``partial``)."""
    return max(1, min(-(-rows // BWD_WARPS), BWD_MAX_BLOCKS))


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm_variant(c: int, itemsize: int, aligned: bool) -> str:
    """The variant a CUDA call with rows of C elements of ``itemsize``
    bytes launches; ``aligned``: x, w and y all start on 16 bytes."""
    if aligned and c % 8 == 0 and c * itemsize <= VEC_MAX_ROW_BYTES:
        return "vector"
    return "strided"


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's check."""
    var = x.to(_stat_dtype(x.dtype)).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    if x.dtype == inv.dtype:
        return weight * (x * inv)
    return weight.to(x.dtype) * (x * inv.to(x.dtype))


def rmsnorm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1b, the JAX rule ``_bwd`` term for term:
    (dx in x's dtype, dw in weight's dtype), computed in float32."""
    s = _stat_dtype(x.dtype)
    xf, gf, wf = x.to(s), g.to(s), weight.to(s)
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    gw = gf * wf
    m = (gw * xf).mean(-1, keepdim=True)
    dx = inv * gw - inv * inv * inv * xf * m
    dw = (gf * xf * inv).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch K1 on a CUDA tensor (weight is cast to x's dtype).  Raises
    when autograd would need a backward (``_build.autograd_required``)."""
    _build.refuse_autograd("rmsnorm", x, weight)
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    w = weight.to(device=x.device, dtype=x.dtype).contiguous()
    if w.shape != (c,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} != ({c},)")
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    code = _build.dtype_code(x, "rmsnorm")
    variant = rmsnorm_variant(
        c, x.element_size(), all(t.data_ptr() % 16 == 0 for t in (x2, w, y)))
    err = _build.lib().tmt_rmsnorm(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                                   x2.shape[0], c, eps, code,
                                   VARIANTS.index(variant),
                                   _build.stream_ptr(x))
    _build.check(err, f"tmt_rmsnorm ({variant})")
    _build.count_launch(sys.modules[__name__], variant)
    return y.reshape(x.shape)


def rmsnorm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1b on CUDA tensors: (dx in x's dtype, dw in weight's
    dtype); x and g of one dtype, the weight read as float32."""
    c = x.shape[-1]
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} {g.dtype} is not "
                         f"x's {tuple(x.shape)} {x.dtype}")
    if weight.shape != (c,):
        raise ValueError(f"rmsnorm_bwd: weight {tuple(weight.shape)} != "
                         f"({c},)")
    if c > BWD_MAX_C:
        raise ValueError(f"rmsnorm_bwd: C={c} above the kernel's "
                         f"{BWD_MAX_C}")
    x2 = x.reshape(-1, c).contiguous()
    g2 = g.reshape(-1, c).contiguous()
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    if rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(weight)
    blocks = bwd_blocks(rows)
    partial = torch.empty(blocks, c, device=x.device, dtype=torch.float32)
    dw = torch.empty(c, device=x.device, dtype=torch.float32)
    err = _build.lib().tmt_rmsnorm_bwd(
        x2.data_ptr(), g2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), rows, c, blocks, eps,
        _build.dtype_code(x, "rmsnorm_bwd"), _build.stream_ptr(x))
    _build.check(err, "tmt_rmsnorm_bwd")
    _build.count_launch(bwd, "rowwise")
    return dx.reshape(x.shape), dw.to(weight.dtype)


def _device_type(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: no path for device {x.device}")
    return x.device.type


class RMSNormFunction(torch.autograd.Function):
    """K1 forward and K1b backward on CUDA tensors; the plain forward and
    the plain ``_bwd`` formula on CPU tensors.  Saves x and the weight as
    given (the float32 master weight in training), so dw is K1b's float32
    sum, as JAX's ``_bwd`` returns ``dw`` in the weight's dtype."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if _device_type(x, "rmsnorm") == "cuda":
            return rmsnorm_cuda(x, weight, eps)
        return rmsnorm_plain(x, weight, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        bwd_fn = rmsnorm_bwd_cuda if x.device.type == "cuda" \
            else rmsnorm_bwd_plain
        dx, dw = bwd_fn(x, g.to(x.dtype), weight, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain version for a CPU tensor; through
    :class:`RMSNormFunction` (K1b or the plain backward) when autograd
    has a gradient to record."""
    dev = _device_type(x, "rmsnorm")
    if _build.autograd_required(x, weight):
        return RMSNormFunction.apply(x, weight, eps)
    if dev == "cuda":
        return rmsnorm_cuda(x, weight, eps)
    return rmsnorm_plain(x, weight, eps)
