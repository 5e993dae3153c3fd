"""K3 (int8 convolution) and K4 (activation quantize): the int8 kernels.

Neither replaces a Pallas kernel.  The JAX package quantizes in
``tera_mind_tpu/ops/quant.py`` and XLA runs the rest on the TPU:
``quant_conv2d`` (:58) is a ``lax.conv_general_dilated`` of int8 inputs
into int32, which PyTorch does not have, and ``quantize_tensor`` (:41)
with the ``a_scale`` branch (:84-87) is a reduction and elementwise
passes that XLA fuses into their producer.

- K3 ``quant_conv``: NHWC SAME convolution of int8 x ``(B, H, W,
  Ci_pad)`` and w ``(Co, kh, kw, Ci_pad)`` (channels zero-padded to a
  multiple of ``CONV_ALIGN``; the model pads to :func:`conv_align`'s)
  into int32 on the tensor cores, then
  ``f32(acc) * (s_x * s_w[co]) + bias[co]`` to bf16 or float32, or the
  raw int32 sums.  The scale product is formed in the kernel, so the
  caller passes the activation scale ``x_scale`` (a device scalar) and
  the weight scales ``w_scale`` (Co,) apart.  Two variants, chosen by
  :func:`k3_plan`'s stated shape rule (:func:`conv_variant`):
  ``wgmma`` (``csrc/quant_conv_wgmma.cu``: Hopper ``wgmma`` s8 fed by
  TMA, where W x H tiles into whole image rows of the 128-pixel M tile)
  and ``mma_sync`` (``csrc/quant_conv.cu``: PR 10's ``mma.sync``
  m16n8k32 kernel, every other shape).  The plan (the TMA box, the tile
  width BN and the persistent grid) is computed here and passed to the C
  entry point, which refuses a plan it cannot run.
- K4 ``quantize`` (``csrc/quantize.cu``): ``s = max(amax|x| / 127,
  1e-8)`` (variant ``dynamic``: one cooperative launch, the abs-max, a
  grid barrier, then the quantize) or a calibrated ``a_scale``
  (``static``), then ``clip(round_half_even(x / s), ±127)`` into rows of
  ``round_up(C, multiple)`` int8, the pad 0: the layout K3 (multiple 16)
  or ``torch._int_mm`` (multiple 8) reads.

Both are inference-only: the dispatchers refuse an input that requires
grad (the JAX package has no VJP for them either,
``tera_mind_tpu/models/unet_packed.py:140``).  ``quantize_plain`` and
``quant_conv_plain`` are their plain PyTorch versions, in the JAX
package's float32 order: what a CPU tensor runs and what
``chip_smoke.py`` holds the kernels against.  ``quant_conv_plain`` is
exact: an im2col of the int8 input and one ``torch._int_mm`` (an f32
convolution is not: 127^2 * 9 * Ci passes 2^24 once Ci >= 116).  A CUDA
tensor goes through the kernel or raises.  Launches count through
``_build.count_launch``: ``k3`` and ``k4`` by variant.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

EPS = 1e-8                 # tera_mind_tpu/ops/quant.py _EPS
CONV_ALIGN = 16            # K3's Ci_pad multiple (csrc/quant_conv.cu)
MM_ALIGN = 8               # torch._int_mm's K multiple
CONV_VARIANTS = ("wgmma", "mma_sync")        # csrc/quant_conv.cuh codes
CONV_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
QUANT_VARIANTS = ("dynamic", "static")       # csrc/quantize.cu codes
MAX_SUM = 2 ** 31 - 1
H100_SMS = 132             # the plan's SM count off the card

# csrc/quant_conv_wgmma.cu: a 128-pixel M tile (two consumer warpgroups
# of 64 rows), 128-byte k chunks (one tap, 128 input channels), a ring
# of 192 KB of stages; csrc/quant_conv.cu: 128 x 128 tiles
K3_BM = 128
K3_BK = 128
K3_RING_BYTES = 192 * 1024
K4_BLOCKS_PER_SM = 2       # csrc/quantize.cu kBlocksPerSM

k3 = _build.Counters(CONV_VARIANTS)          # K3 launches
k4 = _build.Counters(QUANT_VARIANTS)         # K4 launches

INFERENCE_ONLY = ("int8 is inference-only and records no backward (the "
                  "JAX package has none either); call it under "
                  "torch.no_grad() or torch.inference_mode()")


def reset_launches() -> None:
    """Set K3's and K4's launch counters to 0."""
    for counters in (k3, k4):
        _build.reset_launches(counters)


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_last(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to a multiple of ``multiple``
    (``t`` itself when it is one already)."""
    pad = round_up(t.shape[-1], multiple) - t.shape[-1]
    return F.pad(t, (0, pad)) if pad else t


def conv_align(ci: int) -> int:
    """The multiple K3's input channels are zero-padded to: 128 where that
    adds at most a sixteenth of the row (the deep concats 970, 1,482,
    1,994 and 2,506 -> 1,024 ... 2,560), so x's and w's rows start on
    128-byte lines, which the ``wgmma`` variant's TMA loads read about
    twice as fast at the 8 x 8 level; else ``CONV_ALIGN`` (16)."""
    pad = round_up(ci, 128) - ci
    ragged = round_up(ci, CONV_ALIGN) % 128 != 0
    return 128 if ragged and pad * 16 <= ci else CONV_ALIGN


def wgmma_box(h: int, w: int) -> Optional[tuple]:
    """The TMA box ``(bw, bh, bb)`` of whole image rows that covers one
    128-pixel M tile of an ``h x w`` image (``bw * bh * bb == 128``,
    ``bw == w``), or None where none does: W must divide 128, and then
    ``128 / W`` rows must divide H, or whole images of ``H * W`` pixels
    must divide 128."""
    if w > K3_BM or K3_BM % w:
        return None
    if h * w >= K3_BM:
        bh = K3_BM // w
        return (w, bh, 1) if h % bh == 0 else None
    if K3_BM % (h * w):
        return None
    return (w, h, K3_BM // (h * w))


def conv_variant(h: int, w: int) -> str:
    """K3's shape rule: ``wgmma`` where an M tile of 128 output pixels is
    whole image rows (:func:`wgmma_box`: every main-path shape, W = 64,
    32, 16 or 8), ``mma_sync`` otherwise (e.g. a 5 x 7 image)."""
    return "wgmma" if wgmma_box(h, w) is not None else "mma_sync"


class K3Plan(NamedTuple):
    """What K3's C entry point is told: the variant, the TMA box of x
    (``wgmma``; zeros for ``mma_sync``), the output channels a tile
    (BN), the ring's stages, the tiles and the persistent grid."""
    variant: str
    box: tuple           # (bw, bh, bb)
    bn: int
    stages: int
    m_tiles: int
    n_tiles: int
    k_chunks: int        # kh * kw * ceil(Ci_pad / 128) (wgmma)
    units: int           # m_tiles * n_tiles
    grid: int


def conv_bn(co: int) -> int:
    """The ``wgmma`` variant's output channels a tile: 256 where Co >
    128 (every such main-path conv has Co a multiple of 256), else 128."""
    return 256 if co > 128 else 128


def k3_plan(x_shape, w_shape, sms: int = H100_SMS,
            variant: Optional[str] = None) -> K3Plan:
    """K3's host-side plan (:func:`_k3_plan`), kept per shape: the main
    path asks for the same few dozen plans at every call."""
    return _k3_plan(tuple(x_shape[:4]), tuple(w_shape[:3]), sms, variant)


@functools.lru_cache(maxsize=1024)
def _k3_plan(x_shape: tuple, w_shape: tuple, sms: int,
             variant: Optional[str]) -> K3Plan:
    """K3's host-side plan for x ``(B, H, W, Ci)`` and w ``(Co, kh,
    kw[, Ci])``.  ``wgmma``: 128-pixel M tiles, :func:`conv_bn` output
    channels, each tile's K whole in chunks of one tap x 128 channels,
    and a persistent grid of one block an SM (``sms``), or one a tile
    where the tiles are fewer.  ``mma_sync``: PR 10's fixed 128 x 128
    tiles, one block each.  ``variant`` forces one (the checks run both);
    ``wgmma`` raises for a shape outside the rule."""
    b, h, w = x_shape[:3]
    co, kh, kw = w_shape[:3]
    cip = round_up(x_shape[3], conv_align(x_shape[3]))
    m = b * h * w
    m_tiles = -(-m // K3_BM)
    variant = variant or conv_variant(h, w)
    if variant == "mma_sync":
        n_tiles = -(-co // 128)
        taps = kh * kw * -(-cip // 64)
        return K3Plan("mma_sync", (0, 0, 0), 128, 3, m_tiles, n_tiles,
                      taps, m_tiles * n_tiles, m_tiles * n_tiles)
    if variant != "wgmma":
        raise ValueError(f"quant_conv: no variant {variant!r}")
    box = wgmma_box(h, w)
    if box is None:
        raise ValueError(f"quant_conv: wgmma takes no {h}x{w} image (W "
                         "must tile 128 output pixels in whole rows)")
    bn = conv_bn(co)
    n_tiles = -(-co // bn)
    units = m_tiles * n_tiles
    return K3Plan("wgmma", box, bn,
                  K3_RING_BYTES // (K3_BM * K3_BK + bn * K3_BK), m_tiles,
                  n_tiles, kh * kw * -(-cip // K3_BK), units,
                  min(units, sms))


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
    """Launch K4 on a CUDA tensor (float32 or bf16), once: dynamic (the
    abs-max and the quantize in one cooperative launch) or static;
    returns what :func:`quantize_plain` returns."""
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
    if variant == "dynamic":
        s = torch.empty((), dtype=torch.float32, device=x.device)
        word = torch.empty((), dtype=torch.int32, device=x.device)
        blocks = K4_BLOCKS_PER_SM * torch.cuda.get_device_properties(
            x.device).multi_processor_count
        partials = torch.empty(blocks, dtype=torch.int32, device=x.device)
        src, amax = None, word.view(torch.float32)
        ptrs = (s.data_ptr(), word.data_ptr(), partials.data_ptr())
    else:
        blocks = 0
        s = a_scale.to(device=x.device, dtype=torch.float32).reshape(())
        s = s.contiguous()
        src, amax, ptrs = s.data_ptr(), None, (None, None, None)
    err = _build.lib().tmt_quantize(
        x2.data_ptr(), q.data_ptr(), src, *ptrs, blocks, rows, cols,
        cols_pad, code, QUANT_VARIANTS.index(variant), _build.stream_ptr(x))
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


def dequant_scale(w_scale: torch.Tensor,
                  x_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """K3's per-channel scale ``s_x * s_w`` in float32, rounded once, as
    the kernels form it (``__fmul_rn(s_x, s_w[co])``; ``s_x`` = 1 when
    None) and as JAX's ``quant_conv2d`` forms ``x_scale * w_scale``."""
    sw = w_scale.float()
    return sw if x_scale is None else x_scale.float() * sw


def quant_conv_plain(xq: torch.Tensor, wq: torch.Tensor,
                     w_scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.bfloat16,
                     x_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain version of K3: the exact int32 sums of the SAME convolution
    (an im2col, tap-major as w's rows, and :func:`int8_mm`), then, unless
    ``out_dtype`` is int32, ``f32(acc) * dequant_scale(w_scale,
    x_scale)``, ``+ bias`` and the cast, JAX's dequantize
    (ops/quant.py:98-101)."""
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
    y = acc.float() * dequant_scale(w_scale, x_scale)
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


def _f32_on(t: Optional[torch.Tensor], device, name: str, shape: tuple):
    if t is None:
        return None
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if t.shape != shape:
        raise ValueError(f"quant_conv: {name} {tuple(t.shape)} != {shape}")
    return t


def quant_conv_cuda(xq: torch.Tensor, wq: torch.Tensor,
                    w_scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.bfloat16,
                    x_scale: Optional[torch.Tensor] = None,
                    variant: Optional[str] = None) -> torch.Tensor:
    """Launch K3 on CUDA tensors: xq ``(B, H, W, Ci_pad)`` and wq ``(Co,
    kh, kw, Ci_pad)`` int8, contiguous and 16-byte aligned, Ci_pad % 16
    == 0, Co % 8 == 0; w_scale and bias ``(Co,)`` and x_scale ``()``
    (cast to float32; w_scale required unless the output is int32, where
    none is taken).  The variant is :func:`k3_plan`'s unless ``variant``
    forces one.  The C entry point refuses what it does not take
    (misaligned pointers, a ragged Ci_pad or Co, a plan that does not fit
    the shape)."""
    _build.refuse_autograd("quant_conv", *_grads(w_scale, bias, x_scale),
                           why=INFERENCE_ONLY)
    co, kh, kw, ci = _check_conv(xq, wq)
    if out_dtype not in CONV_OUT_CODES:
        raise TypeError(f"quant_conv: no kernel for output {out_dtype}")
    b, h, w, _ = xq.shape
    y = torch.empty(b, h, w, co, dtype=out_dtype, device=xq.device)
    if out_dtype == torch.int32:
        w_scale = bias = x_scale = None
    elif w_scale is None:
        raise ValueError("quant_conv: a dequantized output needs w_scale")
    w_scale = _f32_on(w_scale, xq.device, "w_scale", (co,))
    bias = _f32_on(bias, xq.device, "bias", (co,))
    if x_scale is not None:
        x_scale = _f32_on(x_scale.reshape(()), xq.device, "x_scale", ())
    if y.numel() == 0:
        return y
    sms = torch.cuda.get_device_properties(xq.device).multi_processor_count
    plan = k3_plan(xq.shape, wq.shape, sms, variant)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.lib().tmt_quant_conv(
        xq.contiguous().data_ptr(), wq.contiguous().data_ptr(),
        ptr(x_scale), ptr(w_scale), ptr(bias), y.data_ptr(), b, h, w, ci,
        co, kh, kw, CONV_OUT_CODES[out_dtype],
        CONV_VARIANTS.index(plan.variant), *plan.box, plan.bn, plan.grid,
        _build.stream_ptr(xq))
    _build.check(err, f"tmt_quant_conv ({plan.variant})")
    _build.count_launch(k3, plan.variant)
    return y


def quant_conv(xq: torch.Tensor, wq: torch.Tensor,
               w_scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.bfloat16,
               x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    _build.refuse_autograd("quant_conv", *_grads(w_scale, bias, x_scale),
                           why=INFERENCE_ONLY)
    if _device(xq, "quant_conv") == "cuda":
        return quant_conv_cuda(xq, wq, w_scale, bias, out_dtype, x_scale)
    _check_conv(xq, wq)
    return quant_conv_plain(xq, wq, w_scale, bias, out_dtype, x_scale)
