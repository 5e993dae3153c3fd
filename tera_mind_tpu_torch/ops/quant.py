"""int8 inference: symmetric int8 convolutions and dense products.

Port of ``tera_mind_tpu/ops/quant.py``, with its names and float32
arithmetic order.  Opt-in through ``PackedTeraUNet(conf, quant='int8')``
(``models/unet_packed.py``) and ``cli.generate --quant``:

- weights: symmetric per output channel, ``s_w = max(amax / 127, 1e-8)``
  (:func:`quantize_weight`), at each call or once
  (:func:`prequantize_params`: ``kernel_q`` int8 and ``w_scale``);
- activations: symmetric per tensor, from their abs-max at each call, or
  from a calibrated ``a_scale`` (``static_act``; :func:`calibrate_generator`
  and :func:`bake_act_scales`);
- int32 sums, then ``f32(acc) * (s_x * s_w)``, ``+ f32(bias)`` and the
  cast to the compute dtype (K3 forms ``s_x * s_w`` in its epilogue).

On the card the activation quantize is K4 and the convolution K3
(``ops/quant_kernel.py``); the dense product is ``torch._int_mm``
(cuBLASLt), as JAX leaves its ``dot_general`` to XLA, and its dequantize
plain PyTorch in JAX's order.  Inference-only.

Layouts: the port's float weights are ``(co, ci, kh, kw)`` and ``(co,
ci)``; its ``kernel_q`` buffers are ``(co, kh, kw, ci_pad)`` (K3's
K-contiguous layout) and ``(co, ci_pad)``, the input channels zero-padded
to ``conv_align(ci)`` (16, or 128 for the deep concats) and
``MM_ALIGN`` (8), which the kernels and
``torch._int_mm`` need and which add nothing to the sums.
``convert.load_jax_params`` pads JAX's ``kernel_q`` (HWIO, ``(ci, co)``)
into them and ``export_params`` strips the pad again.  The scales stay
float32 whatever dtype the model is cast to (:class:`QuantModule`), as
JAX's :func:`to_inference_dtype` keeps them.

Calibration: where JAX sows each module's activation abs-max into a
``calib`` collection (and, because of tracing, needs an instrumented
window loop), :func:`recording` sets a flag on the quant modules, whose
forward then keeps a running device max of the abs-max K4 computes
anyway; an ordinary dynamic int8 chain of ``TeraGenerator`` fills it.
Keys are JAX's: ``('calib', <module path...>, 'a_max')``.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import jax_to_torch_array, torch_to_jax_array
from ..models.nn import CastsWeights, set_compute_dtype
from . import quant_kernel as qk
from .quant_kernel import MM_ALIGN

_EPS = qk.EPS   # 1e-8
SCALES = ("w_scale", "a_scale")   # float32 whatever the model's dtype


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (x_q, scale); K4 on the card."""
    q, s, _ = qk.quantize(x, None, MM_ALIGN)
    return q[..., :x.shape[-1]], s


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a port weight (output channel
    first: ``(co, ci, kh, kw)`` or ``(co, ci)``): returns (w_q, scales
    (co,)).  JAX reduces its HWIO kernel over (kh, kw, ci); the same
    elements here are dims 1.."""
    dims = tuple(range(1, w.dim()))
    s = torch.maximum(w.abs().amax(dim=dims).float() / qk._f32(127.0, w),
                      qk._f32(_EPS, w))
    q = torch.clamp(torch.round(w.float() / s.reshape(-1, *[1] * len(dims))),
                    -127, 127)
    return q.to(torch.int8), s


def _same_padding(padding: Sequence, kh: int, kw: int) -> None:
    pads = [p if isinstance(p, int) else tuple(p) for p in padding]
    want = [((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2]
    if [(p, p) if isinstance(p, int) else p for p in pads] != want:
        raise ValueError(f"quant_conv2d: padding {padding} is not SAME for "
                         f"a {kh}x{kw} kernel")


def quant_conv2d(x: torch.Tensor, w: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], padding: Sequence,
                 out_dtype: torch.dtype = torch.bfloat16,
                 w_q: Optional[torch.Tensor] = None,
                 w_scale: Optional[torch.Tensor] = None,
                 a_scale: Optional[torch.Tensor] = None, *,
                 observe=None) -> torch.Tensor:
    """int8 NHWC SAME conv with per-tensor activation and per-channel
    weight quantization (JAX ``quant_conv2d``).

    ``x`` (N, H, W, Ci) float; ``w`` (Co, Ci, kh, kw) float, or ``w_q``
    (Co, kh, kw, Ci or Ci_pad) int8 with ``w_scale`` (Co,); ``a_scale`` a
    calibrated activation scale (static) or None (dynamic); ``bias`` is
    added after the dequantize in float32.  ``observe(amax)`` receives the
    dynamic abs-max (calibration).  Returns (N, H, W, Co) in
    ``out_dtype``."""
    xq, sx, amax = qk.quantize(x, a_scale, qk.conv_align(x.shape[-1]))
    if observe is not None and amax is not None:
        observe(amax)
    if w_q is None:
        wq, sw = quantize_weight(w)
        wq = wq.permute(0, 2, 3, 1)
    else:
        wq, sw = w_q, w_scale
    _same_padding(padding, wq.shape[1], wq.shape[2])
    wq = qk.pad_last(wq, qk.conv_align(x.shape[-1])).contiguous()
    b = None if bias is None else bias.float()
    return qk.quant_conv(xq, wq, sw, b, out_dtype, x_scale=sx)


def quant_dense(x: torch.Tensor, w: Optional[torch.Tensor],
                bias: Optional[torch.Tensor],
                out_dtype: torch.dtype = torch.bfloat16,
                w_q: Optional[torch.Tensor] = None,
                w_scale: Optional[torch.Tensor] = None,
                a_scale: Optional[torch.Tensor] = None, *,
                observe=None) -> torch.Tensor:
    """int8 dense ``x (..., Ci) @ w^T``, ``w`` (Co, Ci) float or ``w_q``
    (Co, Ci or Ci_pad) int8 (JAX ``quant_dense``): the activation
    quantized by K4 into rows of ``round_up(Ci, 8)``, the product by
    ``torch._int_mm``, the dequantize in JAX's order."""
    ci = x.shape[-1]
    xq, sx, amax = qk.quantize(x.reshape(-1, ci), a_scale, MM_ALIGN)
    if observe is not None and amax is not None:
        observe(amax)
    if w_q is None:
        wq, sw = quantize_weight(w)
    else:
        wq, sw = w_q, w_scale
    y = qk.int8_mm(xq, qk.pad_last(wq, MM_ALIGN))
    out = y.float() * (sx * sw.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).reshape(*x.shape[:-1], wq.shape[0])


class QuantModule(CastsWeights):
    """What the int8 modules share: the compute dtype (the bias's without
    ``set_compute_dtype``; a prequantized module has no float weight),
    float32 scales through any cast of the model, a ``kernel_q`` buffer
    of ``in_channels`` zero-padded channels, and calibration."""

    prequant = False
    static_act = False
    calibrating = False
    a_max: Optional[torch.Tensor] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.bias.dtype

    def _init_quant(self, in_channels: int, out_channels: int, wshape,
                    qshape, prequant: bool, static_act: bool) -> None:
        self.in_channels = in_channels
        self.prequant, self.static_act = prequant, static_act
        if prequant:
            self.register_buffer("kernel_q", torch.zeros(qshape,
                                                         dtype=torch.int8))
            self.register_buffer("w_scale", torch.ones(out_channels))
        else:
            self.weight = nn.Parameter(torch.empty(wshape))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if static_act:
            self.register_buffer("a_scale", torch.ones(()))

    def _apply(self, fn, recurse=True):
        """nn.Module._apply that moves the scale buffers with the module
        but keeps them float32 (JAX's to_inference_dtype)."""
        keep = {n: self._buffers[n] for n in SCALES if n in self._buffers}
        super()._apply(fn, recurse)
        for name, val in keep.items():
            self._buffers[name] = val.to(self._buffers[name].device)
        return self

    def quant_args(self) -> dict:
        """The keyword arguments of quant_conv2d / quant_dense."""
        return dict(out_dtype=self.dtype,
                    w_q=self.kernel_q if self.prequant else None,
                    w_scale=self.w_scale if self.prequant else None,
                    a_scale=self.a_scale if self.static_act else None,
                    observe=self.observe if self.calibrating else None)

    def observe(self, amax: torch.Tensor) -> None:
        self.a_max = amax if self.a_max is None else torch.maximum(
            self.a_max, amax)


class QuantDense(QuantModule, nn.Module):
    """Drop-in int8 replacement for ``Dense`` (JAX ``QuantDense``): the
    same ``weight`` (out, in) and ``bias``, or with ``prequant`` the
    buffers ``kernel_q`` (out, round_up(in, 8)) int8 and ``w_scale``
    (out,), and with ``static_act`` ``a_scale`` ().  Inference-only."""

    def __init__(self, in_features: int, out_features: int, *,
                 prequant: bool = False, static_act: bool = False):
        super().__init__()
        self._init_quant(in_features, out_features,
                         (out_features, in_features),
                         (out_features, qk.round_up(in_features, MM_ALIGN)),
                         prequant, static_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_dense(x, getattr(self, "weight", None), self.bias,
                           **self.quant_args())


def dense(in_features: int, out_features: int, quant: Optional[str] = None,
          prequant: bool = False, static_act: bool = False) -> nn.Module:
    """``Dense``, or :class:`QuantDense` with ``quant='int8'``."""
    if quant == "int8":
        return QuantDense(in_features, out_features, prequant=prequant,
                          static_act=static_act)
    if quant is not None:
        raise ValueError(f"quant {quant!r}: only 'int8'")
    from ..models.nn import Dense
    return Dense(in_features, out_features)


_RESBLOCK = re.compile(
    r"^(enc_\d+_res|dec_\d+_res|dec_\d+_up|mid_res[01])$")
_QCONVS = ("in_conv", "out_conv", "skip_conv")
_ATTNBLOCK = re.compile(r"^(enc_\d+_attn|dec_\d+_attn|mid_attn)$")
_QDENSES = ("adaLN", "q", "k", "v", "proj", "fc1", "fc2")


def prequantize_params(params: Mapping, attn: bool = False) -> Dict:
    """Pre-quantize a PACKED flax-named tree (numpy leaves, from
    ``pack_unet_params``) for ``PackedTeraUNet(conf, quant='int8',
    prequant=True)``, as JAX's ``prequantize_params`` (:179) does: every
    ResBlock conv's ``kernel`` (and with ``attn`` every DiT dense kernel)
    becomes ``kernel_q`` (int8, JAX's layout) and ``w_scale`` (float32),
    from :func:`quantize_weight`, so the result equals dynamic weight
    quantization bit for bit.  The root ``stem`` and ``out_conv`` stay."""
    col = params["params"] if "params" in params else params

    def quantized(sub):
        w = np.asarray(sub["kernel"], np.float32)
        wq, sw = quantize_weight(torch.from_numpy(
            np.ascontiguousarray(jax_to_torch_array("kernel", w))))
        new = {k: v for k, v in sub.items() if k != "kernel"}
        new["kernel_q"] = np.ascontiguousarray(
            torch_to_jax_array(wq.numpy())[1])
        new["w_scale"] = sw.numpy()
        return new

    def walk(tree, parent, in_attn):
        out = {}
        for name, sub in tree.items():
            if (isinstance(sub, Mapping) and name in _QCONVS
                    and _RESBLOCK.match(parent or "")
                    and "kernel" in sub and np.ndim(sub["kernel"]) == 4):
                out[name] = quantized(sub)
            elif (attn and in_attn and isinstance(sub, Mapping)
                    and name in _QDENSES and "kernel" in sub
                    and np.ndim(sub["kernel"]) == 2):
                out[name] = quantized(sub)
            elif isinstance(sub, Mapping):
                out[name] = walk(sub, name,
                                 in_attn or bool(_ATTNBLOCK.match(name)))
            else:
                out[name] = sub
        return out

    new_col = walk(col, None, False)
    if "params" in params:
        return {**params, "params": new_col}
    return new_col


def to_inference_dtype(model: nn.Module,
                       dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """JAX's ``to_inference_dtype`` (:234) on a module: its float
    parameters in ``dtype``, computing in ``dtype``, while the
    quantization leaves stay exactly as they are (``kernel_q`` int8,
    ``w_scale`` and ``a_scale`` float32: :class:`QuantModule`)."""
    return set_compute_dtype(model, dtype)


def bake_act_scales(params: Mapping, accum: Mapping, margin: float = 1.0
                    ) -> Dict:
    """Insert calibrated ``a_scale`` leaves (amax / 127 * margin, float32
    numpy) into a flax-named (pre-quantized) tree, for
    ``PackedTeraUNet(..., static_act=True)``.  ``accum``: module-path
    tuples ``('calib', ..., 'a_max')`` -> abs-max (:func:`recording`, or
    JAX's calibration)."""
    col = dict(params["params"]) if "params" in params else dict(params)

    def scale_of(val):
        # f32 arithmetic in the dynamic path's exact order (quantize:
        # max(amax/127, eps)), so a static scale calibrated on an input
        # reproduces the dynamic result bit-exactly
        s = np.float32(val) / np.float32(127.0)
        s = np.maximum(s, np.float32(_EPS))
        if margin != 1.0:
            s = s * np.float32(margin)
        return np.asarray(s, np.float32)

    def insert(tree, path, val):
        tree = dict(tree)
        if len(path) == 1:
            tree["a_scale"] = scale_of(val)
        else:
            tree[path[0]] = insert(tree[path[0]], path[1:], val)
        return tree

    for key, amax in accum.items():
        if key[0] != "calib" or key[-1] != "a_max":
            raise ValueError(f"not a calibration key: {key}")
        col = insert(col, key[1:], amax)

    if "params" in params:
        return {**params, "params": col}
    return col


@contextmanager
def recording(model: nn.Module):
    """Calibration: while open, every dynamic quant module of ``model``
    keeps the max of its activation abs-maxes (on the device); on exit the
    yielded dict holds them as ``{('calib', *path, 'a_max'): float}``."""
    mods = {name: m for name, m in model.named_modules()
            if isinstance(m, QuantModule) and not m.static_act}
    for m in mods.values():
        m.a_max, m.calibrating = None, True
    accum: Dict = {}
    try:
        yield accum
    finally:
        for name, m in mods.items():
            if m.a_max is not None:
                path = tuple(name.split(".")) if name else ()
                accum[("calib", *path, "a_max")] = float(m.a_max)
            m.a_max, m.calibrating = None, False


def calibrate_generator(gen, model: nn.Module, params: Mapping, gene_grid,
                        *, steps: int, state=None, row0: int = 1,
                        col0: int = 1, grid_w: int = 416,
                        margin: float = 1.0) -> Dict:
    """Calibrate ``static_act`` int8 on one chain (JAX
    ``calibrate_generator``, :327): ``gen`` is a ``TeraGenerator`` of the
    DYNAMIC quant ``model`` (``quant='int8'``), ``params`` that model's
    flax-named tree.  Runs ``steps`` block-major DDIM steps over
    ``gene_grid`` with :func:`recording` open and returns ``params`` with
    the baked ``a_scale`` leaves (:func:`bake_act_scales`).

    The step is built (and with ``window_chunk`` -1 planned, whose probe
    calls would otherwise be recorded) before recording starts, and the
    generator's own window loop then runs every z-window: the trap JAX's
    comment at :363-368 describes (a raw -1 chunk, no windows, no
    records) cannot arise, and an empty record still raises."""
    rows, cols = gene_grid.shape[:2]
    step = gen.compile_step(rows, cols, block_major=True)
    if state is None:
        state = gen.init_state(rows, cols, row0=row0, col0=col0,
                               grid_w=grid_w)
    dev_state = torch.as_tensor(state, device=gen.device)
    dev_gene = gen._device_gene(gene_grid, rows, cols)
    with recording(model) as accum:
        for t in range(steps - 1, -1, -1):
            dev_state = step(dev_state, dev_gene, t)
    if not accum:
        raise RuntimeError("calibration recorded no activation amaxes: "
                           "the model has no dynamic quant module, or no "
                           "window ran")
    return bake_act_scales(params, accum, margin=margin)
