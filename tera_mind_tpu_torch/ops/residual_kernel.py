"""K6: the packed ResBlock's residual sum with its convs' biases.

The packed ``PackedResBlock`` ends in two convolutions whose products
meet: ``out_conv``'s ``h`` and the skip path ``s``, which is
``skip_conv``'s product ``c`` where the block changes its width, else
the block's input ``x`` (after ``_up2`` / ``_down2`` where the block
resamples).  In eager PyTorch each conv's bias is a broadcast add after
cuDNN's convolution, then the block returns ``(x + h).to(dt)``: up to
four passes over the map.  K6 computes, in one launch,

    out = r(r(h + b_h) + s),   s = r(c + b_c)  (skip "conv")  or  x  ("x")

with ``r`` rounding to the tensors' dtype (bf16 or float32) where each
eager add rounds, so that on the card it gives the eager sequence's bits
(``csrc/residual.cu``).  The JAX package's ``PackedResBlock``
(``tera_mind_tpu/models/unet_packed.py``) is not a Pallas kernel: on the
TPU XLA fuses the bias adds (:132-133, :226) and the sum (:299) into the
convolutions' output fusion.  :func:`residual_plain` is that eager
sequence, the CPU path and the kernel's check; :func:`residual`
dispatches: K6 for CUDA tensors with no gradient to record, the plain
sequence where autograd records or on the CPU.  ``residual_variant``
picks the variant before the launch: ``vector`` (16-byte vectors) where
a row is a whole number of 16 bytes and every tensor 16-byte aligned,
else ``scalar``.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from . import _build
from .rmsnorm_kernel import _device_type

VARIANTS = ("scalar", "vector")   # csrc/residual.cu codes
SKIPS = ("x", "conv")             # the skip path: the block's x, or a conv
THREADS = 256                     # csrc/residual.cu kThreads
BLOCKS_PER_SM = 4                 # csrc/residual.cu kBlocksPerSm
UNROLL = 4                        # csrc/residual.cu kUnroll

launches = 0  # K6 launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)

NO_BACKWARD = ("K6 records no backward; call the dispatcher residual, "
               "which runs the plain sequence where autograd records, or "
               "call it under torch.no_grad()")


def reset_launches() -> None:
    """Set K6's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])


def skip_kind(s_bias: Optional[torch.Tensor]) -> str:
    """The skip path a call takes: ``conv`` with the skip conv's bias,
    ``x`` without."""
    return SKIPS[s_bias is not None]


def check_call(h: torch.Tensor, h_bias: torch.Tensor, s: torch.Tensor,
               s_bias: Optional[torch.Tensor]) -> None:
    """h and s of one shape, the biases (W,), every tensor of one dtype
    (bf16 or float32) on one device."""
    width = h.shape[-1] if h.dim() else 0
    if h.dim() < 1 or s.shape != h.shape:
        raise ValueError(f"residual: s {tuple(s.shape)} is not h's "
                         f"{tuple(h.shape)}")
    biases = [b for b in (h_bias, s_bias) if b is not None]
    for b in biases:
        if tuple(b.shape) != (width,):
            raise ValueError(f"residual: bias {tuple(b.shape)} is not "
                             f"({width},)")
    ts = (h, s, *biases)
    if any(t.dtype != h.dtype or t.device != h.device for t in ts):
        raise ValueError("residual: h, s and the biases must share one "
                         "dtype and device, not "
                         f"{[(str(t.dtype), str(t.device)) for t in ts]}")
    if h.dtype not in _build.DTYPES:
        raise TypeError(f"residual: no kernel for dtype {h.dtype}")


def residual_plain(h: torch.Tensor, h_bias: torch.Tensor, s: torch.Tensor,
                   s_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the eager sequence after the block's convs
    (each conv's broadcast bias add, then ``(x + h).to(dt)``), the CPU
    path and the kernel's check."""
    check_call(h, h_bias, s, s_bias)
    h = h + h_bias
    if s_bias is not None:
        s = s + s_bias
    return (s + h).to(h.dtype)


def residual_variant(width: int, itemsize: int, aligned: bool) -> str:
    """The K6 variant a CUDA call launches: ``vector`` where a row is a
    whole number of 16-byte vectors and ``aligned`` (every tensor of the
    call starts on 16 bytes), else ``scalar``."""
    return "vector" if aligned and width * itemsize % 16 == 0 else "scalar"


def grid(rows: int, width: int, itemsize: int, variant: str,
         sms: int) -> tuple:
    """(blocks, stride in units) of a launch (``launch`` in
    csrc/residual.cu): a unit is a 16-byte vector (``vector``) or an
    element; at most ``BLOCKS_PER_SM`` blocks an SM, and a stride of the
    whole rows the threads cover, so each thread keeps one column."""
    w = width // (16 // itemsize) if variant == "vector" else width
    n = rows * w
    blocks = min(-(-n // THREADS), BLOCKS_PER_SM * sms)
    return blocks, blocks * THREADS // w * w


def residual_cuda(h: torch.Tensor, h_bias: torch.Tensor, s: torch.Tensor,
                  s_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K6 on CUDA tensors: one launch.  Raises when autograd would
    need a backward."""
    biases = [b for b in (h_bias, s_bias) if b is not None]
    _build.refuse_autograd("residual", h, s, *biases, why=NO_BACKWARD)
    check_call(h, h_bias, s, s_bias)
    width = h.shape[-1]
    h2 = h.reshape(-1, width)
    s2 = s.reshape(-1, width)
    if not h2.is_contiguous():
        h2 = h2.contiguous()
    if not s2.is_contiguous():
        s2 = s2.contiguous()
    h_bias = h_bias.contiguous()
    s_bias = None if s_bias is None else s_bias.contiguous()
    out = torch.empty_like(h2)
    if h2.shape[0] == 0:
        return out.reshape(h.shape)
    ts = [h2, s2, out, h_bias] + ([s_bias] if s_bias is not None else [])
    variant = residual_variant(width, h.element_size(),
                               all(t.data_ptr() % 16 == 0 for t in ts))
    err = _build.lib().tmt_residual(
        h2.data_ptr(), h_bias.data_ptr(), s2.data_ptr(),
        None if s_bias is None else s_bias.data_ptr(), out.data_ptr(),
        h2.shape[0], width, _build.dtype_code(h, "residual"),
        VARIANTS.index(variant), _build.stream_ptr(h))
    _build.check(err, f"tmt_residual ({variant}, skip {skip_kind(s_bias)})")
    _build.count_launch(sys.modules[__name__], variant)
    return out.reshape(h.shape)


def residual(h: torch.Tensor, h_bias: torch.Tensor, s: torch.Tensor,
             s_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out_conv``'s bias-free product ``h`` plus its bias ``h_bias``,
    plus the skip path ``s`` (with the skip conv's bias ``s_bias``, or
    None where ``s`` is the block's input): one K6 launch for CUDA
    tensors with no gradient to record; the plain sequence where autograd
    records or on the CPU.  A call the kernel cannot take raises before
    any launch."""
    dev = _device_type(h, "residual")
    check_call(h, h_bias, s, s_bias)
    biases = [b for b in (h_bias, s_bias) if b is not None]
    if dev == "cuda" and not _build.autograd_required(h, s, *biases):
        return residual_cuda(h, h_bias, s, s_bias)
    return residual_plain(h, h_bias, s, s_bias)
