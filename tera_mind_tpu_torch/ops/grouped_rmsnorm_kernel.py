"""K5: the packed model's ``GroupedRMSNorm``; K5b: its backward.

A packed map ``(..., Z*Ctot)`` holds plainly concatenated ``segments``
(per-plane channel counts c_1..c_S summing to Ctot), each z-major inside:
channel j of plane z in segment s lies at ``off_s + z*c_s + j``, with
``off_s = Z * (c_1 + ... + c_{s-1})``.  Each (row, plane) is normalised
over its Ctot channels, gathered from the S segments:

    inv_z = rsqrt(sum over plane z of x^2 / Ctot + eps)   (float32)
    y = (x * inv_z) * w

in x's dtype, rounded after each multiply for bf16 (``inv_z`` rounded to
bf16 first), the JAX module's ``x * sc * w``.  The weight is the runtime
layout ``(Z*Ctot,)``, or with ``from_5d`` the 5D model's ``(Ctot,)``,
whose channel ``cum_s + j`` every plane of segment s reads (JAX's
``coff``); a float32 weight of a bf16 x (the training's master weight)
is read as it is and rounded to bf16 inside the launch.

The JAX package's ``GroupedRMSNorm`` (``tera_mind_tpu/models/
unet_packed.py``) is not a Pallas kernel: XLA runs it on the TPU as
masked full-width reductions and one fused elementwise output.  Eager
PyTorch runs its plain version (:func:`grouped_rmsnorm_plain`) as 8-14
launches a call, so the port fuses it by hand into one CUDA kernel
(``csrc/grouped_rmsnorm.cu``), bound by memory: one read of x, one write
of y.  ``grouped_variant`` picks its variant before the launch:

- ``vector``: every c_s % 8 == 0, a row of at most 2,048 bytes, and x, w
  and y 16-byte aligned: every 16-byte vector lies in one plane, so a
  lane group sized to the row (K1's ``vector_group``) holds the row in
  registers, and each lane's vectors, their planes and their weight stay
  the same from row to row (weight loaded once, grid-stride loop).
- ``staged``: any other row (the 229-gene segment's odd widths, rows over
  2,048 bytes, misaligned tensors): a warp a row, the row staged in the
  warp's buffer of shared memory from K1's 16-byte words
  (``csrc/rmsnorm_words.cuh``), the planes walked in turn (a plane's sum
  one ``warp_sum``), y written back through the same words; as many
  warps a block as its shared memory holds (:func:`staged_smem`).

K5b (``csrc/grouped_rmsnorm_bwd.cu``) is the gradient of that function in
float32 from x, g and the float32 weight, each plane's statistics
recomputed:

    gw = g * w;  m_z = mean over plane z of gw * x
    dx = inv_z * gw - inv_z^3 * x * m_z            (rounded to x's dtype)
    dw = sum over rows of g * x * inv_z            (float32; with
         ``from_5d`` also summed over the Z planes into (Ctot,))

dw from per-block float32 partials summed in a second launch in a fixed
order (no atomics: the same inputs give the same dw bit for bit), by the
same two variants.  :class:`GroupedRMSNormFunction` records it;
:func:`grouped_rmsnorm` dispatches: K5 (or, with a gradient to record,
the Function) for a CUDA tensor, the plain versions for a CPU tensor.
"""

from __future__ import annotations

import functools
import sys
from typing import Sequence

import torch

from . import _build
from .rmsnorm_kernel import (_device_type, _stat_dtype, kernel_weight,
                             vector_group)

VARIANTS = ("staged", "vector")   # csrc/grouped_rmsnorm*.cu codes
VEC_MAX_ROW_BYTES = 2048   # csrc/grouped_rmsnorm.cuh kVecMaxBytes
MAX_Z = 8                  # csrc/grouped_rmsnorm.cuh kMaxZ
MAX_SEGMENTS = 3           # csrc/grouped_rmsnorm.cuh kMaxSegments
MAX_WIDTH = 12288          # csrc/grouped_rmsnorm.cuh kMaxWidth: Z * Ctot
THREADS = 256              # csrc/grouped_rmsnorm.cuh kThreads: a block
STAGED_MAX_WARPS = 8       # csrc/grouped_rmsnorm.cuh kStagedMaxWarps
BLOCK_SMEM = 232448        # csrc/common.cuh kMaxBlockSmem
SM_SMEM = 233472           # csrc/grouped_rmsnorm.cuh kSmSmem (228 KB)
BWD_MAX_BLOCKS = 8 * 132   # csrc/grouped_rmsnorm_bwd.cu kMaxBlocks
BWD_VEC_BLOCKS_PER_SM = 2  # grouped_bwd_vec_kernel's __launch_bounds__

launches = 0  # K5 launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)
bwd = _build.Counters(VARIANTS)   # K5b's launches

NO_BACKWARD = ("this raw CUDA launcher records no backward; call the "
               "dispatcher grouped_rmsnorm, whose autograd.Function "
               "launches K5b, or call it under torch.no_grad()")


def reset_launches() -> None:
    """Set K5's and K5b's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])
    _build.reset_launches(bwd)


def check_layout(z: int, segments: Sequence[int], width: int) -> tuple:
    """The segments as a tuple of ints, after checking that ``width`` is
    Z times their sum."""
    segs = tuple(int(c) for c in segments)
    if z < 1 or not segs or min(segs) < 1 or z * sum(segs) != width:
        raise ValueError(f"grouped_rmsnorm: width {width} is not z={z} x "
                         f"sum of segments {segs}")
    return segs


def weight_len(z: int, segments: Sequence[int], from_5d: bool) -> int:
    """The weight's length: (Ctot,) with ``from_5d``, else (Z*Ctot,)."""
    return sum(segments) * (1 if from_5d else z)


def grouped_variant(z: int, segments: Sequence[int], itemsize: int,
                    aligned: bool) -> str:
    """The K5 / K5b variant a CUDA call launches; ``aligned``: every
    tensor of the call starts on 16 bytes."""
    if (aligned and all(c % 8 == 0 for c in segments)
            and z * sum(segments) * itemsize <= VEC_MAX_ROW_BYTES):
        return "vector"
    return "staged"


def element_planes(z: int, segments: Sequence[int],
                   from_5d: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(plane, weight index) of each of a row's Z*Ctot elements: the
    mapping both kernels compute from (off_s, c_s, cum_s)."""
    plane, widx, cum = [], [], 0
    for c in segments:
        for zi in range(z):
            plane += [zi] * c
            widx += (list(range(cum, cum + c)) if from_5d else
                     list(range(len(widx), len(widx) + c)))
        cum += c
    return torch.tensor(plane), torch.tensor(widx)


@functools.lru_cache(maxsize=None)
def _device_planes(z: int, segments: tuple, from_5d: bool,
                   device: torch.device) -> tuple:
    """:func:`element_planes` on ``device``, made once (a copy to the card
    cannot run inside a CUDA graph's capture, where it is timed)."""
    return tuple(t.to(device) for t in element_planes(z, segments, from_5d))


def grouped_rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, z: int,
                          segments: Sequence[int], eps: float = 1e-6,
                          from_5d: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's check.  Per
    segment, the sum of squares per plane is taken in float32
    (``vector_norm`` with a float32 accumulator); then each segment is
    scaled as ``(x * inv) * w``, the JAX module's two roundings, and the
    segments are concatenated."""
    segs = check_layout(z, segments, x.shape[-1])
    ctot = sum(segs)

    def planes(t, off, cs):                     # (..., Z, cs) view
        return t[..., off:off + z * cs].unflatten(-1, (z, cs))

    sq, off = None, 0
    for cs in segs:
        s = torch.linalg.vector_norm(planes(x, off, cs), dim=-1,
                                     dtype=_stat_dtype(x.dtype)).square()
        sq = s if sq is None else sq + s
        off += z * cs
    inv = torch.rsqrt(sq / ctot + eps).to(x.dtype)[..., None]
    w = weight.to(x.dtype)
    parts, off, woff = [], 0, 0
    for cs in segs:
        ws = w[woff:woff + cs] if from_5d else w[off:off + z * cs].view(z, cs)
        parts.append(torch.mul(planes(x, off, cs), inv).mul_(ws).flatten(-2))
        off += z * cs
        woff += cs
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def grouped_rmsnorm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                              weight: torch.Tensor, z: int,
                              segments: Sequence[int], eps: float = 1e-6,
                              from_5d: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5b: (dx in x's dtype, dw in weight's
    dtype), computed in float32 (float64 for float64 inputs)."""
    segs = check_layout(z, segments, x.shape[-1])
    ctot = sum(segs)
    s = _stat_dtype(x.dtype)
    plane, widx = _device_planes(z, segs, from_5d, x.device)
    xf, gf = x.to(s), g.to(s)
    gw = gf * weight.to(s)[widx]

    def per_plane(t):                           # (..., Z) sums
        out = t.new_zeros(*t.shape[:-1], z)
        return out.index_add_(-1, plane, t)

    inv = torch.rsqrt(per_plane(xf * xf) / ctot + eps)[..., plane]
    m = (per_plane(gw * xf) / ctot)[..., plane]
    dx = inv * gw - inv * inv * inv * xf * m
    dw_el = (gf * xf * inv).reshape(-1, x.shape[-1]).sum(0)
    dw = dw_el.new_zeros(weight_len(z, segs, from_5d)).index_add_(
        0, widx, dw_el)
    return dx.to(x.dtype), dw.to(weight.dtype)


def _segment_args(segs: tuple) -> list:
    return list(segs) + [0] * (MAX_SEGMENTS - len(segs))


def _check_cuda_call(name: str, z: int, segs: tuple, weight: torch.Tensor,
                     from_5d: bool) -> None:
    if z > MAX_Z or len(segs) > MAX_SEGMENTS or z * sum(segs) > MAX_WIDTH:
        raise ValueError(f"{name}: z={z}, segments {segs} beyond the "
                         f"kernel's {MAX_Z} planes, {MAX_SEGMENTS} segments"
                         f" or {MAX_WIDTH} elements a row")
    n = weight_len(z, segs, from_5d)
    if tuple(weight.shape) != (n,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} != ({n},)")


def grouped_rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, z: int,
                         segments: Sequence[int], eps: float = 1e-6,
                         from_5d: bool = False) -> torch.Tensor:
    """Launch K5 on a CUDA tensor: one launch, the weight read as it is
    (x's dtype, or the float32 master weight of a bf16 x).  Raises when
    autograd would need a backward."""
    _build.refuse_autograd("grouped_rmsnorm", x, weight, why=NO_BACKWARD)
    width = x.shape[-1]
    segs = check_layout(z, segments, width)
    _check_cuda_call("grouped_rmsnorm", z, segs, weight, from_5d)
    x2 = x.reshape(-1, width)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    w = kernel_weight(x.dtype, weight.to(device=x.device).contiguous())
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    code = _build.dtype_code(x, "grouped_rmsnorm")
    variant = grouped_variant(z, segs, x.element_size(), all(
        t.data_ptr() % 16 == 0 for t in (x2, y, w)))
    err = _build.lib().tmt_grouped_rmsnorm(
        x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], z,
        len(segs), *_segment_args(segs), eps, code,
        _build.dtype_code(w, "grouped_rmsnorm weight"), int(from_5d),
        VARIANTS.index(variant), _build.stream_ptr(x))
    _build.check(err, f"tmt_grouped_rmsnorm ({variant})")
    _build.count_launch(sys.modules[__name__], variant)
    return y.reshape(x.shape)


def staged_words(width: int, itemsize: int) -> int:
    """The most 16-byte words a row of ``width`` elements can touch
    (``staged_words`` in csrc/grouped_rmsnorm.cuh)."""
    e = 16 // itemsize
    return (width + 2 * e - 2) // e


def staged_smem(width: int, itemsize: int, bwd: bool) -> tuple:
    """(warps a block, shared-memory bytes a block) of the staged kernels
    (``staged_warps`` and ``staged_smem`` in csrc/grouped_rmsnorm.cuh): the
    weight by element in floats, then per warp the row's words of x (K5b:
    and of g, and the warp's dw sums), as many warps as the block's shared
    memory holds, at most ``STAGED_MAX_WARPS``."""
    wbytes = 4 * (-(-width // 4) * 4)
    per_warp = (16 * staged_words(width, itemsize) * (2 if bwd else 1)
                + (wbytes if bwd else 0))
    warps = max(1, min(STAGED_MAX_WARPS, (BLOCK_SMEM - wbytes) // per_warp))
    return warps, wbytes + warps * per_warp


def bwd_blocks(rows: int, variant: str, width: int, itemsize: int,
               sms: int) -> int:
    """K5b's row-kernel grid (the rows of ``partial``): ``THREADS / G``
    rows in flight a block in the vector variant (two blocks an SM), a
    warp's row in each of the staged variant's warps (as many blocks an
    SM as its threads and shared memory allow: ``staged_blocks_per_sm`` in
    csrc/grouped_rmsnorm.cuh); no more blocks than the card holds at
    once, so every block runs its share of the rows from the start."""
    if variant == "vector":
        per_block = THREADS // vector_group(width, itemsize)
        per_sm = BWD_VEC_BLOCKS_PER_SM
    else:
        per_block, smem = staged_smem(width, itemsize, True)
        per_sm = max(1, min(64 // per_block, SM_SMEM // (smem + 1024)))
    return max(1, min(-(-rows // per_block), per_sm * sms, BWD_MAX_BLOCKS))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grouped_rmsnorm_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                             weight: torch.Tensor, z: int,
                             segments: Sequence[int], eps: float = 1e-6,
                             from_5d: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K5b on CUDA tensors: (dx in x's dtype, dw in weight's
    dtype); x and g of one dtype, the weight read as float32."""
    width = x.shape[-1]
    segs = check_layout(z, segments, width)
    _check_cuda_call("grouped_rmsnorm_bwd", z, segs, weight, from_5d)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"grouped_rmsnorm_bwd: g {tuple(g.shape)} {g.dtype}"
                         f" is not x's {tuple(x.shape)} {x.dtype}")
    x2 = x.reshape(-1, width).contiguous()
    g2 = g.reshape(-1, width).contiguous()
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    if rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(weight)
    code = _build.dtype_code(x, "grouped_rmsnorm_bwd")
    variant = grouped_variant(z, segs, x.element_size(), all(
        t.data_ptr() % 16 == 0 for t in (x2, g2, w, dx)))
    blocks = bwd_blocks(rows, variant, width, x.element_size(),
                        _sm_count(x.device))
    partial = torch.empty(blocks, width, device=x.device,
                          dtype=torch.float32)
    dw = torch.empty(weight_len(z, segs, from_5d), device=x.device,
                     dtype=torch.float32)
    err = _build.lib().tmt_grouped_rmsnorm_bwd(
        x2.data_ptr(), g2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), rows, z, len(segs),
        *_segment_args(segs), blocks, eps, code, int(from_5d),
        VARIANTS.index(variant), _build.stream_ptr(x))
    _build.check(err, f"tmt_grouped_rmsnorm_bwd ({variant})")
    _build.count_launch(bwd, variant)
    return dx.reshape(x.shape), dw.to(weight.dtype)


class GroupedRMSNormFunction(torch.autograd.Function):
    """K5 forward and K5b backward on CUDA tensors; the plain forward and
    the plain backward formula on CPU tensors.  Saves x and the weight as
    given (the float32 master weight in training), so dw is K5b's float32
    sum."""

    @staticmethod
    def forward(ctx, x, weight, z, segments, eps, from_5d):
        ctx.save_for_backward(x, weight)
        ctx.args = (z, tuple(segments), eps, from_5d)
        if _device_type(x, "grouped_rmsnorm") == "cuda":
            return grouped_rmsnorm_cuda(x, weight, *ctx.args)
        return grouped_rmsnorm_plain(x, weight, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        bwd_fn = grouped_rmsnorm_bwd_cuda if x.device.type == "cuda" \
            else grouped_rmsnorm_bwd_plain
        dx, dw = bwd_fn(x, g.to(x.dtype), weight, *ctx.args)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None,
                None, None, None, None)


def grouped_rmsnorm(x: torch.Tensor, weight: torch.Tensor, z: int,
                    segments: Sequence[int], eps: float = 1e-6,
                    from_5d: bool = False) -> torch.Tensor:
    """K5 for a CUDA tensor, the plain version for a CPU tensor; through
    :class:`GroupedRMSNormFunction` (K5b or the plain backward) when
    autograd has a gradient to record."""
    dev = _device_type(x, "grouped_rmsnorm")
    if _build.autograd_required(x, weight):
        return GroupedRMSNormFunction.apply(x, weight, z, tuple(segments),
                                            eps, from_5d)
    if dev == "cuda":
        return grouped_rmsnorm_cuda(x, weight, z, segments, eps, from_5d)
    return grouped_rmsnorm_plain(x, weight, z, segments, eps, from_5d)
