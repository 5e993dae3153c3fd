"""K3 (int8 convolution) and K4 (activation quantize): the int8 kernels.

Neither replaces a Pallas kernel.  The JAX package quantizes in
``tera_mind_tpu/ops/quant.py`` and XLA runs the rest on the TPU:
``quant_conv2d`` (:58) is a ``lax.conv_general_dilated`` of int8 inputs
into int32, which PyTorch does not have, and ``quantize_tensor`` (:41)
with the ``a_scale`` branch (:84-87) is a reduction and elementwise
passes that XLA fuses into their producer.

- K3 ``quant_conv`` (``csrc/quant_conv.cu``): NHWC SAME convolution of
  int8 x ``(B, H, W, Ci_pad)`` and w ``(Co, kh, kw, Ci_pad)`` (channels
  zero-padded to a multiple of ``CONV_ALIGN``) into int32 on the tensor
  cores (``mma.sync`` m16n8k32 s8), then ``f32(acc) * scale[co] +
  bias[co]`` to bf16 or float32.  Variants: ``dequant`` and ``int32``
  (the raw sums, for the checks), chosen from the output dtype.
- K4 ``quantize`` (``csrc/quantize.cu``): ``s = max(amax|x| / 127,
  1e-8)`` (variant ``dynamic``, an abs-max launch first) or a calibrated
  ``a_scale`` (``static``), then ``clip(round_half_even(x / s), ±127)``
  into rows of ``round_up(C, multiple)`` int8, the pad 0: the layout K3
  (multiple 16) or ``torch._int_mm`` (multiple 8) reads.

Both are inference-only: the dispatchers refuse an input that requires
grad (the JAX package has no VJP for them either,
``tera_mind_tpu/models/unet_packed.py:140``).  ``quantize_plain`` and
``quant_conv_plain`` are their plain PyTorch versions, in the JAX
package's float32 order: what a CPU tensor runs and what
``chip_smoke.py`` holds the kernels against.  ``quant_conv_plain`` is
exact: an im2col of the int8 input and one ``torch._int_mm`` (an f32
convolution is not: 127^2 * 9 * Ci passes 2^24 once Ci >= 116).  A CUDA
tensor goes through the kernel or raises.  Launches count through
``_build.count_launch``: ``k3`` by variant, ``k4`` by variant and
``k4_absmax``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

EPS = 1e-8                 # tera_mind_tpu/ops/quant.py _EPS
CONV_ALIGN = 16            # K3's Ci_pad multiple (csrc/quant_conv.cu)
MM_ALIGN = 8               # torch._int_mm's K multiple
CONV_VARIANTS = ("dequant", "int32")         # csrc/quant_conv.cu codes
CONV_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
QUANT_VARIANTS = ("dynamic", "static")       # csrc/quantize.cu codes
MAX_SUM = 2 ** 31 - 1

k3 = _build.Counters(CONV_VARIANTS)          # K3 launches
k4 = _build.Counters(QUANT_VARIANTS)         # K4 quantize launches
k4_absmax = _build.Counters(("absmax",))     # K4 abs-max launches

INFERENCE_ONLY = ("int8 is inference-only and records no backward (the "
                  "JAX package has none either); call it under "
                  "torch.no_grad() or torch.inference_mode()")


def reset_launches() -> None:
    """Set K3's and K4's launch counters to 0."""
    for counters in (k3, k4, k4_absmax):
        _build.reset_launches(counters)


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_last(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to a multiple of ``multiple``
    (``t`` itself when it is one already)."""
    pad = round_up(t.shape[-1], multiple) - t.shape[-1]
    return F.pad(t, (0, pad)) if pad else t


def conv_variant(out_dtype: torch.dtype) -> str:
    """K3's variant for an output of ``out_dtype``."""
    return "int32" if out_dtype == torch.int32 else "dequant"


def quantize_variant(a_scale: Optional[torch.Tensor]) -> str:
    """K4's variant: ``static`` with a calibrated scale, else
    ``dynamic``."""
    return "dynamic" if a_scale is None else "static"


def conv_sum_bound(kh: int, kw: int, ci: int) -> int:
    """The largest |int32 sum| K3 can form: 127^2 * kh * kw * Ci."""
    return 127 * 127 * kh * kw * ci


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: a tensor operand, so
    ``a / _f32(127.0, a)`` is an IEEE division on the card too (a Python
    scalar divisor becomes a multiply by its reciprocal there)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _device(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: no path for device {t.device}")
    return t.device.type


def _grads(*tensors: Optional[torch.Tensor]) -> tuple:
    return tuple(t for t in tensors if t is not None)


# --------------------------------------------------------------------- #
# K4: quantize                                                           #
# --------------------------------------------------------------------- #
def quantize_plain(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None,
                   multiple: int = CONV_ALIGN):
    """Plain version of K4: ``(q, s, amax)``, q ``(..., round_up(C,
    multiple))`` int8 with the pad 0, s the float32 scale, amax the
    float32 abs-max (None with ``a_scale``); JAX's ``quantize_tensor``
    or its ``a_scale`` branch, op for op.  A NaN quotient becomes 0, as
    XLA's float-to-int convert makes it (PyTorch leaves that cast
    undefined), so a NaN input gives a NaN dynamic scale and q = 0."""
    if a_scale is None:
        amax = x.abs().amax().float()
        s = torch.maximum(amax / _f32(127.0, x), _f32(EPS, x))
    else:
        amax, s = None, a_scale.to(device=x.device, dtype=torch.float32)
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return pad_last(q, multiple), s, amax


def quantize_cuda(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None,
                  multiple: int = CONV_ALIGN):
    """Launch K4 on a CUDA tensor (float32 or bf16): the abs-max, then
    the quantize (dynamic), or the quantize alone (static); returns what
    :func:`quantize_plain` returns."""
    _build.refuse_autograd("quantize", *_grads(x, a_scale),
                           why=INFERENCE_ONLY)
    if multiple % MM_ALIGN:
        raise ValueError(f"quantize: multiple {multiple} is not one of 8")
    cols = x.shape[-1]
    x2 = x.reshape(-1, cols).contiguous()
    rows = x2.shape[0]
    cols_pad = round_up(cols, multiple)
    code = _build.dtype_code(x, "quantize")
    if rows == 0 or cols == 0:
        raise ValueError(f"quantize: empty input {tuple(x.shape)}")
    q = torch.empty(*x.shape[:-1], cols_pad, dtype=torch.int8,
                    device=x.device)
    variant = quantize_variant(a_scale)
    lib, stream = _build.lib(), _build.stream_ptr(x)
    if variant == "dynamic":
        word = torch.empty((), dtype=torch.int32, device=x.device)
        _build.check(lib.tmt_absmax(x2.data_ptr(), x2.numel(), code,
                                    word.data_ptr(), stream), "tmt_absmax")
        _build.count_launch(k4_absmax, "absmax")
        s = torch.empty((), dtype=torch.float32, device=x.device)
        src, out, amax = word, s.data_ptr(), word.view(torch.float32)
    else:
        s = a_scale.to(device=x.device, dtype=torch.float32).reshape(())
        s = s.contiguous()
        src, out, amax = s, None, None
    err = lib.tmt_quantize(x2.data_ptr(), q.data_ptr(), src.data_ptr(), out,
                           rows, cols, cols_pad, code,
                           QUANT_VARIANTS.index(variant), stream)
    _build.check(err, f"tmt_quantize ({variant})")
    _build.count_launch(k4, variant)
    return q, s, amax


def quantize(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None,
             multiple: int = CONV_ALIGN):
    """K4 for a CUDA tensor, its plain version for a CPU tensor."""
    _build.refuse_autograd("quantize", *_grads(x, a_scale),
                           why=INFERENCE_ONLY)
    fn = quantize_cuda if _device(x, "quantize") == "cuda" else quantize_plain
    return fn(x, a_scale, multiple)


# --------------------------------------------------------------------- #
# int8 matrix product (torch._int_mm) and K3: quant_conv                 #
# --------------------------------------------------------------------- #
def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (N, K)^T`` of int8 matrices into int32, exactly, by
    ``torch._int_mm`` (cuBLASLt on the card).  K must be a multiple of 8
    (the callers pad it with zeros); M <= 16 and N % 8 on the card are
    padded here with zero rows, which add nothing."""
    m, n = a.shape[0], b.shape[0]
    if a.is_cuda:
        if a.shape[1] % MM_ALIGN:
            raise ValueError(f"int8_mm: K={a.shape[1]} is not a multiple "
                             f"of {MM_ALIGN}")
        if m <= 16:
            a = F.pad(a, (0, 0, 0, 17 - m))
        if n % MM_ALIGN:
            b = F.pad(b, (0, 0, 0, round_up(n, MM_ALIGN) - n))
    y = torch._int_mm(a.contiguous(), b.contiguous().t())
    return y if y.shape == (m, n) else y[:m, :n]


def quant_conv_plain(xq: torch.Tensor, wq: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """Plain version of K3: the exact int32 sums of the SAME convolution
    (an im2col, tap-major as w's rows, and :func:`int8_mm`), then, unless
    ``out_dtype`` is int32, ``f32(acc) * scale``, ``+ bias`` and the cast,
    JAX's dequantize (ops/quant.py:98-101)."""
    b, h, w, ci = xq.shape
    co, kh, kw, _ = wq.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    cols = torch.cat([xp[:, r:r + h, s:s + w] for r in range(kh)
                      for s in range(kw)], -1)
    acc = int8_mm(cols.reshape(b * h * w, kh * kw * ci),
                  wq.reshape(co, kh * kw * ci)).reshape(b, h, w, co)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def _check_conv(xq: torch.Tensor, wq: torch.Tensor) -> tuple:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"quant_conv: int8 inputs, not {xq.dtype} and "
                        f"{wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[-1] != wq.shape[-1]:
        raise ValueError(f"quant_conv: x {tuple(xq.shape)} and w "
                         f"{tuple(wq.shape)} are not (B, H, W, Ci) and "
                         "(Co, kh, kw, Ci)")
    co, kh, kw, ci = wq.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"quant_conv: kernel {kh}x{kw} is not odd (SAME)")
    if conv_sum_bound(kh, kw, ci) > MAX_SUM:
        raise ValueError(f"quant_conv: {kh}x{kw}x{ci} taps could overflow "
                         "the int32 sums")
    return co, kh, kw, ci


def quant_conv_cuda(xq: torch.Tensor, wq: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """Launch K3 on CUDA tensors: xq ``(B, H, W, Ci_pad)`` and wq ``(Co,
    kh, kw, Ci_pad)`` int8, contiguous and 16-byte aligned, Ci_pad % 16
    == 0, Co % 8 == 0; scale and bias ``(Co,)`` (cast to float32).  The C
    entry point refuses what it does not take (misaligned pointers, a
    ragged Ci_pad or Co)."""
    _build.refuse_autograd("quant_conv", *_grads(scale, bias),
                           why=INFERENCE_ONLY)
    co, kh, kw, ci = _check_conv(xq, wq)
    if out_dtype not in CONV_OUT_CODES:
        raise TypeError(f"quant_conv: no kernel for output {out_dtype}")
    variant = conv_variant(out_dtype)
    b, h, w, _ = xq.shape
    y = torch.empty(b, h, w, co, dtype=out_dtype, device=xq.device)
    if variant == "dequant":
        if scale is None:
            raise ValueError("quant_conv: dequant needs the scale")
        scale = scale.to(device=xq.device, dtype=torch.float32).contiguous()
        if bias is not None:
            bias = bias.to(device=xq.device, dtype=torch.float32)
            bias = bias.contiguous()
        for t in (scale, bias):
            if t is not None and t.shape != (co,):
                raise ValueError(f"quant_conv: {tuple(t.shape)} != ({co},)")
    else:
        scale = bias = None
    if y.numel() == 0:
        return y
    err = _build.lib().tmt_quant_conv(
        xq.contiguous().data_ptr(), wq.contiguous().data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), b, h, w,
        ci, co, kh, kw, CONV_OUT_CODES[out_dtype],
        CONV_VARIANTS.index(variant), _build.stream_ptr(xq))
    _build.check(err, f"tmt_quant_conv ({variant})")
    _build.count_launch(k3, variant)
    return y


def quant_conv(xq: torch.Tensor, wq: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    _build.refuse_autograd("quant_conv", *_grads(scale, bias),
                           why=INFERENCE_ONLY)
    if _device(xq, "quant_conv") == "cuda":
        return quant_conv_cuda(xq, wq, scale, bias, out_dtype)
    _check_conv(xq, wq)
    return quant_conv_plain(xq, wq, scale, bias, out_dtype)
