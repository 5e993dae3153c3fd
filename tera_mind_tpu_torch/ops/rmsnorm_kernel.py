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
- ``strided``: any other C or pointer: the odd C of the gene concats
  (485, 741, 997 and 1,253 in the 5D chain; 337, 593, 849 and 1,105 at
  the 81-gene presets), the 500-gene presets' 756, 1,012, 1,268 and 1,524
  (rows over 2 KB), float32 rows over 512 channels, misaligned tensors.
  One warp a row, 16 warps a block, a grid-stride loop of two blocks an
  SM.  Rows of up to ``REGISTER_MAX_ROW_BYTES`` (2,048 bf16 or 1,024
  float32 channels) are held in registers from 16-byte loads of the
  aligned words that cover them (``csrc/rmsnorm_words.cuh``: the
  neighbours' elements of the two words a row shares set to 0, the words
  at the tensor's ends read element by element), and y is written from
  them: 16-byte stores inside the row, the widest aligned pieces on the
  shared words.  w is staged once a block in shared memory as words in
  x's layout, one copy for each offset a row can start at, so a word of y
  is one read of w and, in bf16, eight ``bf16x2`` multiplies; a float32
  weight of a bf16 x (the training's master weight) is passed as it is
  and rounded to bf16 there, as a cast before the call would round it.
  Wider rows keep a second read of the row from L1.

``vector`` too reads a float32 weight of a bf16 x as it is (two 16-byte
loads a bf16 vector, rounded in registers), so every K1 call is one
launch.

Any row count works, so the TPU kernel's fallback for rows that do not
block has no counterpart: a CUDA tensor always goes through a kernel.

Statistics are float32.  For bf16 the rounding follows the TPU kernel
(inv and w cast to bf16 before the two multiplies); for float32 the
result is ``w * (x * inv)``, the JAX package's f32 formula.

K1b, the backward (``csrc/rmsnorm_bwd.cu``), replaces the TPU kernel's
``custom_vjp`` rule ``_bwd``: dx per row from x, g and the float32
weight with the statistics recomputed in float32, dw from per-block
partial sums reduced in a second kernel (no atomics, so deterministic).
``rmsnorm_bwd_variant`` picks its variant by K1's rule: ``vector`` (a
lane group sized to C, 16-byte loads, w and the dw sums in registers;
x, g, w, dx 16-byte aligned) or ``strided`` (one warp a row holding it in
registers, w in shared memory; any C and alignment): up to
``BWD_LANE_ROW_MAX_C`` channels lane i holds channels i, i + 32, ... and
their dw sums; bf16 rows of up to ``BWD_REGISTER_MAX_C`` take K1's
16-byte words, with each warp's dw sums in shared memory; wider rows,
float32 rows over ``BWD_LANE_ROW_MAX_C`` and an x and g of different
16-byte phases keep a second read of the row from L1.
``rmsnorm`` dispatches: without a gradient to record, the raw K1 launch
(or the plain version on the CPU); with one, :class:`RMSNormFunction`,
whose forward is K1 and backward K1b (on the CPU the plain forward and
the plain ``_bwd`` formula).

K1 has one epilogue (``EPILOGUES``; counted in ``launches_by_epilogue``):
``modulate``, the DiT block's adaLN modulate after its norms,
``y * (scale + 1.0) + shift`` (``tera_mind_tpu/models/nn.py:127-130``,
which XLA fuses after the norm) with per-token (rows, C) scale and shift
that are strided chunks of the adaLN dense's (B, N, 7C) output.
:func:`rmsnorm_modulate` dispatches it: one K1 launch for a CUDA tensor
with no gradient to record (every variant takes it: ``vector`` where
scale and shift start on 16 bytes with rows a whole number of 16 bytes
apart, else ``strided``); where autograd records, :func:`rmsnorm` and the
eager modulate; on the CPU the plain sequence.  The kernel rounds each
step to x's dtype as the eager ops do, so the result is their bits.
"""

from __future__ import annotations

import functools
import sys
from typing import Optional

import torch

from . import _build

VEC_MAX_ROW_BYTES = 2048   # csrc/rmsnorm.cu kVecMaxBytes
VARIANTS = ("strided", "vector")   # csrc/rmsnorm.cu codes
EPILOGUES = ("none", "modulate")   # tmt_rmsnorm, tmt_rmsnorm_modulate
BWD_WARPS = 8              # csrc/rmsnorm_bwd.cu kBwdWarps: rows a block
BWD_MAX_BLOCKS = 8 * 132   # csrc/rmsnorm_bwd.cu kMaxBlocks
BWD_MAX_C = 7264           # csrc/rmsnorm_bwd.cu kMaxC
BWD_VEC_THREADS = 256      # csrc/rmsnorm_bwd.cu kVecThreads
VEC_MAX = 4                # csrc/rmsnorm*.cu kVecMax: 16-byte vectors a lane
REGISTER_MAX_ROW_BYTES = 4096   # csrc/rmsnorm_words.cuh kRegMaxBytes: K1
BWD_LANE_ROW_MAX_C = 32 * 40    # csrc/rmsnorm_bwd.cu 32 * kLaneRowMaxPer
BWD_REGISTER_MAX_C = 32 * 64    # csrc/rmsnorm_bwd.cu 32 * kStridedMaxPer

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)
launches_by_epilogue = dict.fromkeys(EPILOGUES, 0)
bwd = _build.Counters(VARIANTS)   # K1b's launches (csrc/rmsnorm_bwd.cu)


def reset_launches() -> None:
    """Set K1's and K1b's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])
    _build.reset_launches(bwd)


def bwd_blocks(rows: int, rows_per_block: int = BWD_WARPS,
               max_blocks: int = BWD_MAX_BLOCKS) -> int:
    """The grid of K1b's row kernel: ``rows_per_block`` rows in flight a
    block (a warp a row in the strided variant), at most ``max_blocks``
    (up to ``BWD_MAX_BLOCKS``, the rows of ``partial``)."""
    return max(1, min(-(-rows // rows_per_block), max_blocks))


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device) -> int:
    """K1b's grid cap on ``device``: two blocks on each SM, the blocks of
    either variant that fit there at once (each lane's rows in registers
    over the grid-stride loop), so each block sums its dw once."""
    return min(2 * torch.cuda.get_device_properties(
        device).multi_processor_count, BWD_MAX_BLOCKS)


def vector_group(c: int, itemsize: int) -> int:
    """The lanes a row gets in the vector variants (``launch_vector`` in
    csrc/rmsnorm.cu and csrc/rmsnorm_bwd.cu): the smallest power of two
    up to 32 that leaves each lane at most ``VEC_MAX`` 16-byte vectors."""
    nvec, g = c // (16 // itemsize), 1
    while g < 32 and g * VEC_MAX < nvec:
        g *= 2
    return g


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm_variant(c: int, itemsize: int, aligned: bool) -> str:
    """The variant a CUDA call with rows of C elements of ``itemsize``
    bytes launches; ``aligned``: x, w and y all start on 16 bytes."""
    if aligned and c % 8 == 0 and c * itemsize <= VEC_MAX_ROW_BYTES:
        return "vector"
    return "strided"


def rmsnorm_bwd_variant(c: int, itemsize: int, aligned: bool) -> str:
    """The K1b variant a CUDA call with rows of C elements of
    ``itemsize`` bytes launches; ``aligned``: x, g, w and dx all start on
    16 bytes.  K1's rule: ``vector`` for C % 8 == 0 and a row of at most
    2,048 bytes, else ``strided``."""
    return rmsnorm_variant(c, itemsize, aligned)


def kernel_weight(x_dtype: torch.dtype, w: torch.Tensor) -> torch.Tensor:
    """The weight as K1 takes it for an x of ``x_dtype``: as it is when of
    x's dtype or a float32 weight of a bf16 x (either variant rounds it to
    bf16 itself, in one launch), else cast to x's dtype (a new tensor,
    which starts on 16 bytes)."""
    if w.dtype == x_dtype or (x_dtype == torch.bfloat16
                              and w.dtype == torch.float32):
        return w
    return w.to(x_dtype)


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
    """Launch K1 on a CUDA tensor.  The weight is cast to x's dtype, but
    a float32 weight of a bf16 x (the training's master weight), which
    either variant rounds to bf16 itself in one launch.  Raises when
    autograd would need a backward (``_build.autograd_required``)."""
    _build.refuse_autograd("rmsnorm", x, weight)
    return _launch(x, weight, eps)


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float,
            scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K1 launch on a CUDA tensor: ``tmt_rmsnorm``, or with scale and
    shift (checked by the caller) ``tmt_rmsnorm_modulate``."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    w = weight.to(device=x.device).contiguous()
    if w.shape != (c,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} != ({c},)")
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    code = _build.dtype_code(x, "rmsnorm")
    w = kernel_weight(x.dtype, w)
    item = x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, y, w))
    args = (x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], c, eps,
            code, _build.dtype_code(w, "rmsnorm weight"))
    if scale is None:
        epilogue, name = "none", "tmt_rmsnorm"
        variant = rmsnorm_variant(c, item, aligned)
        err = _build.lib().tmt_rmsnorm(*args, VARIANTS.index(variant),
                                       _build.stream_ptr(x))
    else:
        epilogue, name = "modulate", "tmt_rmsnorm_modulate"
        s2, sstride = row_view(scale, c, "rmsnorm_modulate scale")
        h2, hstride = row_view(shift, c, "rmsnorm_modulate shift")
        variant = rmsnorm_modulate_variant(
            c, item, aligned,
            all(t.data_ptr() % 16 == 0 for t in (s2, h2))
            and sstride * item % 16 == 0 and hstride * item % 16 == 0)
        err = _build.lib().tmt_rmsnorm_modulate(
            *args, VARIANTS.index(variant), s2.data_ptr(), h2.data_ptr(),
            sstride, hstride, _build.stream_ptr(x))
    _build.check(err, f"{name} ({variant})")
    _build.count_launch(sys.modules[__name__], variant, epilogue)
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
    code = _build.dtype_code(x, "rmsnorm_bwd")
    variant = rmsnorm_bwd_variant(
        c, x.element_size(),
        all(t.data_ptr() % 16 == 0 for t in (x2, g2, w, dx)))
    blocks = bwd_blocks(rows, BWD_WARPS if variant == "strided" else
                        BWD_VEC_THREADS // vector_group(c, x.element_size()),
                        _resident_blocks(x.device))
    partial = torch.empty(blocks, c, device=x.device, dtype=torch.float32)
    dw = torch.empty(c, device=x.device, dtype=torch.float32)
    err = _build.lib().tmt_rmsnorm_bwd(
        x2.data_ptr(), g2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), rows, c, blocks, eps, code,
        VARIANTS.index(variant), _build.stream_ptr(x))
    _build.check(err, f"tmt_rmsnorm_bwd ({variant})")
    _build.count_launch(bwd, variant)
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


# ---------------------------------------------------------------------------
# the modulate epilogue
# ---------------------------------------------------------------------------

NO_BACKWARD = ("K1's modulate epilogue records no backward; call the "
               "dispatcher rmsnorm_modulate, which runs rmsnorm and the "
               "eager modulate where autograd records, or call it under "
               "torch.no_grad()")


def modulate_plain(y: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor) -> torch.Tensor:
    """The eager adaLN modulate after a norm: ``y * (scale + 1.0) +
    shift``, each op rounding to its dtype."""
    return y * (scale + 1.0) + shift


def rmsnorm_modulate_plain(x: torch.Tensor, weight: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K1 with the modulate: the CPU path and the
    kernel's check."""
    return modulate_plain(rmsnorm_plain(x, weight, eps), scale, shift)


def row_view(t: torch.Tensor, c: int, name: str) -> tuple:
    """(t as a (rows, c) view, its row stride in elements): t's channels
    contiguous and its rows one stride apart (a chunk of a wider
    tensor's last axis is), without a copy; raises otherwise."""
    if t.dim() < 1 or t.shape[-1] != c:
        raise ValueError(f"{name}: {tuple(t.shape)} does not end in {c}")
    if t.numel() and c > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: channel stride {t.stride(-1)}, not 1")
    try:
        t2 = t.view(-1, c)
    except RuntimeError:
        raise ValueError(f"{name}: rows of {tuple(t.shape)} with strides "
                         f"{t.stride()} are not one stride apart") from None
    return t2, (t2.stride(0) if t2.shape[0] > 1 else c)


def check_modulate(x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor) -> None:
    """scale and shift of x's shape, dtype (bf16 or float32) and device,
    each a (rows, C) view with contiguous channels (any row stride)."""
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"rmsnorm_modulate: {name} {tuple(t.shape)} "
                             f"is not x's {tuple(x.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"rmsnorm_modulate: {name} {t.dtype} on "
                             f"{t.device} is not x's {x.dtype} on "
                             f"{x.device}")
        row_view(t, x.shape[-1], f"rmsnorm_modulate {name}")
    if x.dtype not in _build.DTYPES:
        raise TypeError(f"rmsnorm_modulate: no kernel for dtype {x.dtype}")


def rmsnorm_modulate_variant(c: int, itemsize: int, aligned: bool,
                             mod_aligned: bool) -> str:
    """The variant a CUDA call of K1 with the modulate launches: K1's rule
    (``aligned``: x, w and y on 16 bytes), and ``vector`` only where
    ``mod_aligned`` too: scale and shift start on 16 bytes and their rows
    lie a whole number of 16 bytes apart."""
    if mod_aligned and rmsnorm_variant(c, itemsize, aligned) == "vector":
        return "vector"
    return "strided"


def rmsnorm_modulate_cuda(x: torch.Tensor, weight: torch.Tensor,
                          scale: torch.Tensor, shift: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """Launch K1 with the modulate epilogue on CUDA tensors: one launch;
    scale and shift read through their strides, never copied.  Raises
    when autograd would need a backward, and on a call the kernel cannot
    take, before any launch."""
    _build.refuse_autograd("rmsnorm_modulate", x, weight, scale, shift,
                           why=NO_BACKWARD)
    check_modulate(x, scale, shift)
    return _launch(x, weight, eps, scale, shift)


def rmsnorm_modulate(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor, shift: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm(x) * (scale + 1.0) + shift``: one K1 launch with the
    modulate for a CUDA tensor with no gradient to record; where autograd
    records, :func:`rmsnorm` (K1 and K1b on the card) and the eager
    modulate; the plain sequence on the CPU.  A CUDA call the kernel
    cannot take raises before any launch, as does one the card could not
    take on the CPU."""
    dev = _device_type(x, "rmsnorm_modulate")
    if _build.autograd_required(x, weight, scale, shift):
        return modulate_plain(rmsnorm(x, weight, eps), scale, shift)
    check_modulate(x, scale, shift)
    if dev == "cuda":
        return rmsnorm_modulate_cuda(x, weight, scale, shift, eps)
    return rmsnorm_modulate_plain(x, weight, scale, shift, eps)
