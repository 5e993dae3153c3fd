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
  the same from row to row (the weight staged in shared memory once a
  block, grid-stride loop).
- ``staged``: any other row (the 229-gene segment's odd widths, rows over
  2,048 bytes, misaligned tensors): a warp a row, the row staged in one of
  the warp's two buffers of shared memory from K1's 16-byte words
  (``csrc/rmsnorm_words.cuh``) by ``cp.async`` while the warp walks the
  row before, the planes walked in turn (a plane's sum one ``warp_sum``),
  y written back through the same words; as many warps a block as its
  shared memory holds, at most 8.

K5b (``csrc/grouped_rmsnorm_bwd.cu``) is the gradient of that function in
float32 from x, g and the float32 weight, each plane's statistics
recomputed:

    gw = g * w;  m_z = mean over plane z of gw * x
    dx = inv_z * gw - inv_z^3 * x * m_z            (rounded to x's dtype)
    dw = sum over rows of g * x * inv_z            (float32; with
         ``from_5d`` also summed over the Z planes into (Ctot,))

dw from per-block float32 partials summed in a second launch in a fixed
order (no atomics: the same inputs give the same dw bit for bit), by the
same two variants; K5b ``staged`` takes a block a row, each thread owning
fixed elements of every row (:func:`bwd_staged_plan`), the next row's x
and g on their way by ``cp.async``.  :class:`GroupedRMSNormFunction`
records it; :func:`grouped_rmsnorm_act` dispatches: K5 (or, with a
gradient to record, the Function) for a CUDA tensor, the plain versions
for a CPU tensor.

Every norm of the packed model feeds an elementwise consumer, which K5
applies before its store (``EPILOGUES``; :func:`grouped_rmsnorm_act`):

- ``silu``: ``F.silu(y)`` (each ``in_norm``, the UNet's ``out_norm``);
- ``modulate_silu``: ``F.silu(y * (1.0 + scale) + shift)`` with the
  adaLN ``scale`` and ``shift`` of shape (B, C), channel c of every plane
  of batch b reading ``scale[b, c]`` (each ResBlock's ``out_norm``, one
  segment of C channels); batch b holds rows b*R .. b*R + R - 1, R the
  rows of x per batch.

rounded where that eager sequence rounds (each of ``1 + scale``, the
product, the sum and the SiLU in x's dtype), so that in bf16 the fused
launch gives the plain sequence's bits.  Under autograd the Function and
the eager epilogue run instead, so training's numbers and gradients are
the unfused ones.

A ResBlock's ``out_norm`` reads ``in_conv``'s product, whose bias PyTorch
adds as a separate broadcast pass after cuDNN's convolution; K5 takes
that bias as a prologue instead (``bias``, ``PROLOGUES``): a (Z*C,)
tensor of x's dtype in the packed layout, one segment, each element
first made ``x + bias`` rounded to x's dtype (the eager add's rounding),
then normalised.
"""

from __future__ import annotations

import functools
import sys
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build
from .rmsnorm_kernel import (_device_type, _stat_dtype, kernel_weight,
                             vector_group)

VARIANTS = ("staged", "vector")   # csrc/grouped_rmsnorm*.cu codes
EPILOGUES = ("none", "silu", "modulate_silu")   # grouped_rmsnorm.cuh codes
PROLOGUES = ("none", "bias")   # the conv bias added before the norm
VEC_MAX_ROW_BYTES = 2048   # csrc/grouped_rmsnorm.cuh kVecMaxBytes
MAX_Z = 8                  # csrc/grouped_rmsnorm.cuh kMaxZ
MAX_SEGMENTS = 3           # csrc/grouped_rmsnorm.cuh kMaxSegments
MAX_WIDTH = 12288          # csrc/grouped_rmsnorm.cuh kMaxWidth: Z * Ctot
THREADS = 256              # csrc/grouped_rmsnorm.cuh kThreads: a block
MAX_Z_SLOTS = 8            # csrc/grouped_rmsnorm.cuh kMaxZ (K5b's sums)
BWD_MAX_THREADS = 512      # csrc/grouped_rmsnorm.cuh kBwdMaxThreads
SM_SMEM = 233472           # csrc/grouped_rmsnorm.cuh kSmSmem (228 KB)
BWD_MAX_BLOCKS = 8 * 132   # csrc/grouped_rmsnorm_bwd.cu kMaxBlocks
BWD_VEC_BLOCKS_PER_SM = 2  # grouped_bwd_vec_kernel's __launch_bounds__

launches = 0  # K5 launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)
launches_by_epilogue = dict.fromkeys(EPILOGUES, 0)
launches_by_prologue = dict.fromkeys(PROLOGUES, 0)
bwd = _build.Counters(VARIANTS)   # K5b's launches

NO_BACKWARD = ("this raw CUDA launcher records no backward; call the "
               "dispatcher grouped_rmsnorm_act, whose autograd.Function "
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
                    aligned: bool, act: str = "none") -> str:
    """The K5 / K5b variant a CUDA call launches; ``aligned``: every
    tensor of the call starts on 16 bytes; ``act``: K5's epilogue, which
    ``vector`` is compiled with for bf16 rows only (float32 runs only the
    small checks; its epilogues take ``staged``)."""
    if (aligned and all(c % 8 == 0 for c in segments)
            and z * sum(segments) * itemsize <= VEC_MAX_ROW_BYTES
            and (itemsize == 2 or act == "none")):
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


def check_epilogue(act: str, segs: tuple, x: torch.Tensor,
                   scale, shift) -> int:
    """The rows of x a batch of ``scale`` / ``shift`` covers (0 without
    them), after checking the epilogue ``act`` and its operands:
    ``modulate_silu`` takes one segment of C channels and a (B, C) scale
    and shift, B x's leading dimension (or 1: every row reads row 0)."""
    if act not in EPILOGUES:
        raise ValueError(f"grouped_rmsnorm: epilogue {act!r} is none of "
                         f"{EPILOGUES}")
    if act != "modulate_silu":
        if scale is not None or shift is not None:
            raise ValueError(f"grouped_rmsnorm: epilogue {act!r} takes no "
                             "scale or shift")
        return 0
    if len(segs) != 1:
        raise ValueError(f"grouped_rmsnorm: modulate_silu takes one "
                         f"segment, not {segs}")
    if scale is None or shift is None:
        raise ValueError("grouped_rmsnorm: modulate_silu needs scale and "
                         "shift")
    b = scale.shape[0] if scale.dim() == 2 else -1
    if (tuple(scale.shape) != (b, segs[0]) or shift.shape != scale.shape
            or x.dim() < 2 or b not in (1, x.shape[0])):
        raise ValueError(f"grouped_rmsnorm: scale {tuple(scale.shape)} and "
                         f"shift {tuple(shift.shape)} are not (B, "
                         f"{segs[0]}) for x {tuple(x.shape)}")
    return x.numel() // x.shape[-1] // b


def check_bias(segs: tuple, x: torch.Tensor, bias) -> None:
    """A prologue's ``bias`` (None: no prologue) must be one segment's
    (Z*C,) of x's dtype on x's device."""
    if bias is None:
        return
    if len(segs) != 1:
        raise ValueError(f"grouped_rmsnorm: a bias takes one segment, not "
                         f"{segs}")
    if (tuple(bias.shape) != (x.shape[-1],) or bias.dtype != x.dtype
            or bias.device != x.device):
        raise ValueError(f"grouped_rmsnorm: bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device} is not "
                         f"({x.shape[-1]},) {x.dtype} on {x.device}")


def act_plain(y: torch.Tensor, act: str, z: int, scale=None,
              shift=None) -> torch.Tensor:
    """The eager epilogue after the norm: ``modulate_silu`` is the
    ResBlock's ``y * (1.0 + scale) + shift`` with (B, C) scale and shift
    repeated over the Z planes and broadcast over y's middle dimensions,
    then ``F.silu``; ``silu`` the SiLU alone."""
    if act == "none":
        return y
    if act == "modulate_silu":
        shape = (scale.shape[0],) + (1,) * (y.dim() - 2) + (-1,)
        y = y * (1.0 + scale.repeat(1, z).view(shape)) \
            + shift.repeat(1, z).view(shape)
    return F.silu(y)


def grouped_rmsnorm_act_plain(x: torch.Tensor, weight: torch.Tensor, z: int,
                              segments: Sequence[int], eps: float = 1e-6,
                              from_5d: bool = False, act: str = "none",
                              scale=None, shift=None,
                              bias=None) -> torch.Tensor:
    """Plain PyTorch version of K5 with its prologue and epilogue: the
    CPU path and the kernel's check; ``x + bias`` where a bias is given,
    :func:`grouped_rmsnorm_plain`, then :func:`act_plain`, each op
    rounding in x's dtype."""
    segs = check_layout(z, segments, x.shape[-1])
    check_epilogue(act, segs, x, scale, shift)
    check_bias(segs, x, bias)
    if bias is not None:
        x = x + bias
    return act_plain(grouped_rmsnorm_plain(x, weight, z, segs, eps, from_5d),
                     act, z, scale, shift)


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
                         from_5d: bool = False, act: str = "none",
                         scale=None, shift=None,
                         bias=None) -> torch.Tensor:
    """Launch K5 on a CUDA tensor: one launch, the weight read as it is
    (x's dtype, or the float32 master weight of a bf16 x), the prologue's
    ``bias`` added to x first, the epilogue ``act`` applied before the
    store (scale and shift of x's dtype, read in place: the two halves of
    one (B, 2C) tensor need no copy).  Raises when autograd would need a
    backward."""
    mod = [t for t in (scale, shift) if t is not None]
    pro = [] if bias is None else [bias]
    _build.refuse_autograd("grouped_rmsnorm", x, weight, *mod, *pro,
                           why=NO_BACKWARD)
    width = x.shape[-1]
    segs = check_layout(z, segments, width)
    _check_cuda_call("grouped_rmsnorm", z, segs, weight, from_5d)
    rows_per_batch = check_epilogue(act, segs, x, scale, shift)
    check_bias(segs, x, bias)
    if bias is not None and not bias.is_contiguous():
        bias = pro[0] = bias.contiguous()
    stride = 0
    if mod:
        if any(t.dtype != x.dtype or t.device != x.device for t in mod):
            raise ValueError(f"grouped_rmsnorm: scale and shift must be "
                             f"{x.dtype} on {x.device}")
        if (scale.stride(1) != 1 or shift.stride(1) != 1
                or scale.stride(0) != shift.stride(0)):
            scale, shift = scale.contiguous(), shift.contiguous()
        stride = scale.stride(0)
    x2 = x.reshape(-1, width)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    w = kernel_weight(x.dtype, weight.to(device=x.device).contiguous())
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    code = _build.dtype_code(x, "grouped_rmsnorm")
    variant = grouped_variant(z, segs, x.element_size(), all(
        t.data_ptr() % 16 == 0 for t in (x2, y, w, *mod, *pro))
        and stride * x.element_size() % 16 == 0, act)
    if variant == "vector" and act != "none" and w.dtype != x.dtype:
        # vector reads a float32 weight of a bf16 x only with no epilogue
        # (training's forward, under autograd); Trainer.preview samples
        # the packed training model under no_grad, its float32 master
        # weight with bf16 activations: rounded to bf16 here, as vector
        # would round it itself
        w = w.to(x.dtype)
    err = _build.lib().tmt_grouped_rmsnorm(
        x2.data_ptr(), w.data_ptr(), bias.data_ptr() if pro else None,
        y.data_ptr(), x2.shape[0], z,
        len(segs), *_segment_args(segs), eps, code,
        _build.dtype_code(w, "grouped_rmsnorm weight"), int(from_5d),
        VARIANTS.index(variant), EPILOGUES.index(act),
        scale.data_ptr() if mod else None,
        shift.data_ptr() if mod else None, stride, rows_per_batch,
        _build.stream_ptr(x))
    prologue = PROLOGUES[bool(pro)]
    _build.check(err, f"tmt_grouped_rmsnorm ({variant}, {prologue}, {act})")
    _build.count_launch(sys.modules[__name__], variant, act, prologue)
    return y.reshape(x.shape)


def staged_words(width: int, itemsize: int) -> int:
    """The most 16-byte words a row of ``width`` elements can touch
    (``staged_words`` in csrc/grouped_rmsnorm.cuh)."""
    e = 16 // itemsize
    return (width + 2 * e - 2) // e


def blocks_per_sm(smem: int, threads: int, regs: int) -> int:
    """The blocks an SM holds at once (``blocks_per_sm`` in
    csrc/grouped_rmsnorm.cuh): its 228 KB of shared memory (1 KB reserved
    a block), 2,048 threads and 65,536 registers at ``regs`` a thread."""
    return max(1, min(SM_SMEM // (smem + 1024), 2048 // threads,
                      65536 // (threads * regs)))


def bwd_staged_plan(width: int, itemsize: int) -> tuple:
    """(elements a thread, threads a block, shared-memory bytes a block)
    of K5b ``staged`` (``bwd_ept``, ``bwd_threads`` and
    ``bwd_staged_smem`` in csrc/grouped_rmsnorm.cuh): a block a row, at
    most ``BWD_MAX_THREADS`` threads of 8, 16 or 24 elements each; two
    slots of a row's x and g words and each warp's two sums a plane."""
    ept = next(e for e in (8, 16, 24) if width <= e * BWD_MAX_THREADS)
    threads = -(-(-(-width // ept)) // 32) * 32
    smem = (2 * 2 * 16 * staged_words(width, itemsize)
            + 4 * (threads // 32) * 2 * MAX_Z_SLOTS)
    return ept, threads, smem


def bwd_blocks(rows: int, variant: str, width: int, itemsize: int,
               sms: int) -> int:
    """K5b's row-kernel grid (the rows of ``partial``): ``THREADS / G``
    rows in flight a block in the vector variant (two blocks an SM), one
    row a block in the staged variant (as many blocks an SM as its
    threads, registers and shared memory allow:
    :func:`bwd_staged_plan`, :func:`blocks_per_sm`); no more blocks than
    the card holds at once, so every block runs its share of the rows
    from the start."""
    if variant == "vector":
        per_block = THREADS // vector_group(width, itemsize)
        per_sm = BWD_VEC_BLOCKS_PER_SM
    else:
        ept, threads, smem = bwd_staged_plan(width, itemsize)
        per_block = 1   # registers a thread: its __launch_bounds__'
        per_sm = blocks_per_sm(smem, threads, 64 if ept == 8 else 128)
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


def grouped_rmsnorm_act(x: torch.Tensor, weight: torch.Tensor, z: int,
                        segments: Sequence[int], eps: float = 1e-6,
                        from_5d: bool = False, act: str = "none",
                        scale=None, shift=None,
                        bias=None) -> torch.Tensor:
    """The norm with its prologue ``bias`` (None: none) and its epilogue
    ``act`` (``EPILOGUES``): one K5 launch for a CUDA tensor with no
    gradient to record; where autograd records, the eager ``x + bias``,
    :class:`GroupedRMSNormFunction` (K5 and K5b on the card) and then the
    eager epilogue (:func:`act_plain`); the plain versions for a CPU
    tensor.  A variant, prologue or epilogue that cannot take a call
    raises before any launch."""
    dev = _device_type(x, "grouped_rmsnorm")
    segs = check_layout(z, segments, x.shape[-1])
    check_epilogue(act, segs, x, scale, shift)
    check_bias(segs, x, bias)
    mod = [t for t in (scale, shift, bias) if t is not None]
    if _build.autograd_required(x, weight, *mod):
        if bias is not None:
            x = x + bias
        return act_plain(GroupedRMSNormFunction.apply(
            x, weight, z, segs, eps, from_5d), act, z, scale, shift)
    if dev == "cuda":
        return grouped_rmsnorm_cuda(x, weight, z, segs, eps, from_5d, act,
                                    scale, shift, bias)
    return grouped_rmsnorm_act_plain(x, weight, z, segs, eps, from_5d, act,
                                     scale, shift, bias)
