"""K7: the DiT block's gated residual, ``x + gate * y``.

Each DiT block ends its two sub-layers in ``xt + gate * attn(...)`` and
``xt + gate * mlp(...)`` (``tera_mind_tpu/models/attention.py:196-202``;
on the TPU XLA fuses them into the output fusion of the dense before
them, no Pallas kernel).  Eager PyTorch runs each as two passes over the
token map, the product and the sum.  K7 computes, in one launch,

    out = r(x + r(gate * y))

with ``r`` rounding to the tensors' dtype (bf16 or float32) where each
eager op rounds, so that on the card it gives the eager sequence's bits
(``csrc/gated_residual.cu``).  ``x`` is the residual stream and ``y`` the
sub-layer's output, both (rows, C); ``gate`` is a (rows, C) view with
contiguous channels and its own row stride (a chunk of the adaLN dense's
(B, N, 7C) output), read through that stride, never copied.
:func:`gated_residual_plain` is the eager sequence, the CPU path and the
kernel's check; :func:`gated_residual` dispatches: K7 for CUDA tensors
with no gradient to record, the plain sequence where autograd records or
on the CPU.  ``gated_variant`` picks the variant before the launch:
``vector`` (16-byte vectors) where a row and the gate's row stride are
whole numbers of 16 bytes and every tensor is 16-byte aligned, else
``scalar``.  K7 writes a new tensor: the packed UNet still reads the
block's input as a skip.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from .rmsnorm_kernel import _device_type, row_view

VARIANTS = ("scalar", "vector")   # csrc/gated_residual.cu codes
THREADS = 256                     # csrc/gated_residual.cu kThreads
BLOCKS_PER_SM = 4                 # csrc/gated_residual.cu kBlocksPerSm
UNROLL = 4                        # csrc/gated_residual.cu kUnroll

launches = 0  # K7 launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)

NO_BACKWARD = ("K7 records no backward; call the dispatcher "
               "gated_residual, which runs the plain sequence where "
               "autograd records, or call it under torch.no_grad()")


def reset_launches() -> None:
    """Set K7's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])


def check_call(x: torch.Tensor, gate: torch.Tensor,
               y: torch.Tensor) -> None:
    """x, gate and y of one shape, dtype (bf16 or float32) and device;
    gate a (rows, C) view with contiguous channels."""
    if x.dim() < 1 or gate.shape != x.shape or y.shape != x.shape:
        raise ValueError(f"gated_residual: x {tuple(x.shape)}, gate "
                         f"{tuple(gate.shape)} and y {tuple(y.shape)} "
                         "differ")
    ts = (x, gate, y)
    if any(t.dtype != x.dtype or t.device != x.device for t in ts):
        raise ValueError("gated_residual: x, gate and y must share one "
                         "dtype and device, not "
                         f"{[(str(t.dtype), str(t.device)) for t in ts]}")
    if x.dtype not in _build.DTYPES:
        raise TypeError(f"gated_residual: no kernel for dtype {x.dtype}")
    row_view(gate, x.shape[-1], "gated_residual gate")


def gated_residual_plain(x: torch.Tensor, gate: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the DiT block's eager ``x + gate * y``, the
    CPU path and the kernel's check."""
    return x + gate * y


def gated_variant(c: int, gstride: int, itemsize: int,
                  aligned: bool) -> str:
    """The K7 variant a CUDA call launches: ``vector`` where a row of C
    and the gate's row stride are whole numbers of 16-byte vectors and
    ``aligned`` (every tensor of the call starts on 16 bytes), else
    ``scalar``."""
    return "vector" if aligned and c * itemsize % 16 == 0 \
        and gstride * itemsize % 16 == 0 else "scalar"


def grid(rows: int, c: int, itemsize: int, variant: str,
         sms: int) -> tuple:
    """(blocks, rows a grid stride) of a launch (``launch`` in
    csrc/gated_residual.cu): a unit is a 16-byte vector (``vector``) or an
    element, at most ``BLOCKS_PER_SM`` blocks an SM, and the threads that
    cover whole rows of units walk the map, each in one column."""
    w = c // (16 // itemsize) if variant == "vector" else c
    blocks = min(-(-rows * w // THREADS), BLOCKS_PER_SM * sms)
    return blocks, blocks * THREADS // w


def gated_residual_cuda(x: torch.Tensor, gate: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA tensors: one launch.  Raises when autograd would
    need a backward, and on a call the kernel cannot take, before any
    launch."""
    _build.refuse_autograd("gated_residual", x, gate, y, why=NO_BACKWARD)
    check_call(x, gate, y)
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    y2 = y.reshape(-1, c)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if not y2.is_contiguous():
        y2 = y2.contiguous()
    g2, gstride = row_view(gate, c, "gated_residual gate")
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    variant = gated_variant(c, gstride, x.element_size(), all(
        t.data_ptr() % 16 == 0 for t in (x2, g2, y2, out)))
    err = _build.lib().tmt_gated_residual(
        x2.data_ptr(), g2.data_ptr(), y2.data_ptr(), out.data_ptr(),
        x2.shape[0], c, gstride, _build.dtype_code(x, "gated_residual"),
        VARIANTS.index(variant), _build.stream_ptr(x))
    _build.check(err, f"tmt_gated_residual ({variant})")
    _build.count_launch(sys.modules[__name__], variant)
    return out.reshape(x.shape)


def gated_residual(x: torch.Tensor, gate: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """``x + gate * y``: one K7 launch for CUDA tensors with no gradient
    to record; the plain sequence where autograd records or on the CPU.
    A CUDA call the kernel cannot take raises before any launch, as does
    one the card could not take on the CPU."""
    dev = _device_type(x, "gated_residual")
    if _build.autograd_required(x, gate, y):
        return gated_residual_plain(x, gate, y)
    check_call(x, gate, y)
    if dev == "cuda":
        return gated_residual_cuda(x, gate, y)
    return gated_residual_plain(x, gate, y)
