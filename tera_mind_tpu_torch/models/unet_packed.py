"""z-packed TeraUNet: the 5D model with z folded into channels.

Port of ``tera_mind_tpu/models/unet_packed.py``.  Same architecture and parameters as
:class:`~.unet.TeraUNet`, but every voxel map ``(B, Z, H, W, C)`` is
carried as ``(B, H, W, Z*C)``, z-major, so the ResBlock convs are 2D
convs over twice the channels (``ops/zpack.py``).

Layout: segment-major.  Every single tensor is z-major packed; the
skip and RNA concats are plain ``torch.cat`` along channels, which leaves
each concatenated segment z-major inside.  The channel permutation that
implies (against a z-major view of the concatenated 5D channels) is
absorbed into the consuming conv kernels when the parameters are packed
(:func:`pack_unet_params`, ``seg_perm``), so the forward needs no
interleaving copies.  The DiT blocks and the RNA tower keep their 5D
parameters; ``packed_attn`` runs the DiT blocks on the packed layout's
(h, w, z) tokens instead of unpacking around each block.

``from_5d=True`` declares the parameters in TeraUNet's shapes (3D conv
kernels, per-C norm weights) and builds the packed kernels in the
forward (:class:`Conv3DAsPacked`), so a 5D tree loads as it is; with
``from_5d=False`` the tree comes packed from :func:`pack_unet_params`.
Module and parameter names follow the flax ones, so
``convert.load_jax_params`` maps either tree one for one.

int8 inference (``quant='int8'``, ``ops/quant.py``), as in JAX: the
ResBlock convs become :class:`QuantConv2p` (or, ``from_5d``, the quant
branch of :class:`Conv3DAsPacked`), with ``prequant`` (``kernel_q`` and
``w_scale`` buffers from ``prequantize_params``) and ``static_act``
(calibrated ``a_scale`` buffers); ``quant_attn`` also makes the DiT
blocks' denses ``QuantDense``.  The stem and the output conv stay in the
compute dtype (they touch raw pixels).  Inference-only.

In generation (no gradient to record) on the card, each bf16 or float32
``PackedResBlock`` hands its convs' biases to the kernels that read
their products: ``in_conv``'s bias to ``out_norm`` (K5's prologue), and
``out_conv``'s and ``skip_conv``'s, with the residual sum, to one K6
launch (``ops/residual_kernel.py``), where eager PyTorch adds each bias
in a pass of its own after cuDNN's convolution (``PackedResBlock.fold``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _build
from ..ops.collage import to_collage
from ..ops.grouped_rmsnorm_kernel import grouped_rmsnorm_act
from ..ops.quant import QuantModule, quant_conv2d
from ..ops.quant_kernel import conv_align, round_up
from ..ops.residual_kernel import residual
from ..ops.zpack import (pack_channel_param, pack_conv3d_bias,
                         pack_conv3d_kernel, pack_conv3d_kernel_t,
                         pack_features, packed_to_pixel, pixel_to_packed,
                         unpack_features)
from .attention import DiTBlock
from .nn import (Conv2d, Conv3d, Dense, RMSNorm, TimeEmbed, downsample_2x,
                 dropout, set_compute_dtype, timestep_embedding, upsample_2x)
from .rna import RNATower, rna_grid_from_dense
from .unet import TeraUNetConfig, _rna_channels


class GroupedRMSNorm(RMSNorm):
    """RMSNorm over each z-plane's channels of a packed ``(..., Z*Ctot)``
    map whose channels are plainly concatenated z-major ``segments``
    (per-z channel counts summing to Ctot): the 5D norm of the
    concatenated channels at each (z, h, w).

    The weight is ``(Z*Ctot,)`` in the segment-major runtime layout, or
    the 5D model's ``(Ctot,)`` with ``from_5d``.  Runs through
    ``ops/grouped_rmsnorm_kernel.grouped_rmsnorm_act``, with the norm's
    consumer ``act`` (``silu``, or the adaLN ``modulate_silu`` by (B, C)
    ``scale`` and ``shift``), after the prologue ``bias`` (a conv's
    bias, added to x first): one launch of K5 with them on a
    CUDA tensor; where autograd records, K5, then the eager epilogue
    (K5b records the norm's backward); the plain multi-pass version on a
    CPU tensor."""

    def __init__(self, z: int, segments: Sequence[int], eps: float = 1e-6,
                 from_5d: bool = False):
        segments = tuple(int(c) for c in segments)
        super().__init__(sum(segments) * (1 if from_5d else z), eps)
        self.z, self.segments, self.from_5d = z, segments, from_5d

    def forward(self, x: torch.Tensor, act: str = "none",
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return grouped_rmsnorm_act(x, self.weight, self.z, self.segments,
                                   self.eps, self.from_5d, act, scale,
                                   shift, bias)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of a packed (B, H, W, C) map."""
    return upsample_2x(x[:, None])[:, 0]


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of a packed (B, H, W, C) map."""
    return downsample_2x(x[:, None])[:, 0]


def conv2p(in_channels: int, out_channels: int, kernel: Sequence[int], *,
           zero_init: bool = False, quant: Optional[str] = None,
           prequant: bool = False, static_act: bool = False) -> nn.Module:
    """The packed model's 2D conv (JAX ``conv2p``): symmetric padding,
    bias, NHWC activations; cuDNN runs it channels-last once
    ``models.nn.channels_last_`` has stored the kernel so.  With
    ``quant='int8'`` a :class:`QuantConv2p`."""
    if quant == "int8":
        return QuantConv2p(in_channels, out_channels, kernel,
                           zero_init=zero_init, prequant=prequant,
                           static_act=static_act)
    if quant is not None:
        raise ValueError(f"quant {quant!r}: only 'int8'")
    return Conv2d(in_channels, out_channels, kernel, zero_init=zero_init)


class QuantConv2p(QuantModule, nn.Module):
    """Drop-in int8 replacement for conv2p's ``Conv2d`` (JAX
    ``QuantConv2p``): the same ``weight`` (co, ci, kh, kw) and ``bias``,
    so packed trees load unchanged, run through ``quant_conv2d`` (K4 and
    K3 on the card).  ``prequant``: buffers ``kernel_q`` (co, kh, kw,
    round_up(ci, conv_align(ci))) int8 and ``w_scale`` (co,) instead of
    the weight;
    ``static_act``: a calibrated ``a_scale`` () buffer instead of the
    dynamic abs-max.  Inference-only."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], *, zero_init: bool = False,
                 prequant: bool = False, static_act: bool = False):
        super().__init__()
        kh, kw = kernel
        self.padding = ((kh - 1) // 2, (kw - 1) // 2)
        self.zero_init = zero_init
        self._init_quant(in_channels, out_channels,
                         (out_channels, in_channels, kh, kw),
                         (out_channels, kh, kw,
                          round_up(in_channels, conv_align(in_channels))),
                         prequant, static_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_conv2d(x, getattr(self, "weight", None), self.bias,
                            self.padding, **self.quant_args())


class Conv3DAsPacked(Conv3d):
    """Packed 2D conv whose parameter is the 5D model's 3D kernel
    ``(co, ci, kz, kh, kw)`` with bias ``(co,)``: a 5D tree loads as it
    is, and the packed kernel ``(z*co, z*ci, kh, kw)`` is built per call
    (:func:`~..ops.zpack.pack_conv3d_kernel_t`).  ``quant='int8'``: the
    float32 kernel is packed, then quantized at each call (dynamic only,
    as in JAX) and the bias tiled z times."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], z: int, *,
                 segments: Optional[Sequence[int]] = None,
                 zero_init: bool = False, quant: Optional[str] = None):
        super().__init__(in_channels, out_channels, kernel,
                         zero_init=zero_init)
        if quant not in (None, "int8"):
            raise ValueError(f"quant {quant!r}: only 'int8'")
        self.z, self.quant = z, quant
        self.segments = None if segments is None else tuple(segments)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "int8":
            w2 = pack_conv3d_kernel_t(self.weight.float(), self.z,
                                      self.segments)
            return quant_conv2d(x, w2, self.bias.float().repeat(self.z),
                                self.padding[1:], out_dtype=self.dtype)
        return self._conv(x, self.packed_bias())

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The packed convolution without its bias (not int8)."""
        return self._conv(x, None)

    def packed_bias(self) -> torch.Tensor:
        """The bias tiled over the z planes, (z*co,) in the compute
        dtype, as :meth:`forward` adds it."""
        return self.cast(self.bias).repeat(self.z)

    def _conv(self, x: torch.Tensor, bias) -> torch.Tensor:
        w2 = pack_conv3d_kernel_t(self.cast(self.weight), self.z,
                                  self.segments)
        x = self.cast(x).permute(0, 3, 1, 2)
        y = F.conv2d(x, w2, bias, padding=self.padding[1:])
        return y.permute(0, 2, 3, 1)


class PackedResBlock(nn.Module):
    """ResBlock3D on the packed layout, with its parameter names.

    ``in_channels`` and ``out_channels`` count channels per z plane;
    ``in_segments`` splits the input's per-z channels into the plainly
    concatenated segments it is made of (skip and RNA concats).

    ``fold`` (:meth:`folds`): whether the block hands its convs' biases
    and its residual sum to the kernels that read the conv products (K5's
    prologue adds ``in_conv``'s bias, one K6 launch adds ``out_conv``'s
    and ``skip_conv``'s and the skip path), where no gradient is recorded
    and the convs are bf16 or float32 (not int8): None (the default) on
    a CUDA tensor (and on the meta device, which stands in for the card
    in ``scripts/kernel_shapes.py``), True also on the CPU (through the
    kernels' plain versions), False never.  On the card the folded block
    gives the eager sequence's bits; on the CPU a conv adds its bias
    inside the convolution, so there it rounds once less."""

    fold: Optional[bool] = None

    def __init__(self, in_channels: int, out_channels: int, z: int,
                 emb_channels: Optional[int] = None, *,
                 in_segments: Optional[Sequence[int]] = None,
                 up: bool = False, down: bool = False,
                 use_zero_module: bool = True, from_5d: bool = False,
                 dropout: float = 0.0, quant: Optional[str] = None,
                 prequant: bool = False, static_act: bool = False):
        super().__init__()
        segs = tuple(in_segments or (in_channels,))
        assert sum(segs) == in_channels, (segs, in_channels)
        self.z, self.up, self.down = z, up, down
        self.dropout = dropout

        def conv(cin, cout, k, segments=None, zero_init=False):
            if from_5d:
                return Conv3DAsPacked(cin, cout, (k, k, k), z,
                                      segments=segments, zero_init=zero_init,
                                      quant=quant)
            return conv2p(z * cin, z * cout, (k, k), zero_init=zero_init,
                          quant=quant, prequant=prequant,
                          static_act=static_act)

        self.in_norm = GroupedRMSNorm(z, segs, from_5d=from_5d)
        self.in_conv = conv(in_channels, out_channels, 3, segs)
        self.out_norm = GroupedRMSNorm(z, (out_channels,), from_5d=from_5d)
        if emb_channels is not None:
            self.emb_proj = Dense(emb_channels, 2 * out_channels)
        self.out_conv = conv(out_channels, out_channels, 3,
                             zero_init=use_zero_module)
        if in_channels != out_channels:
            self.skip_conv = conv(in_channels, out_channels, 1, segs)

    def plain_convs(self) -> bool:
        """Whether every conv of the block is a bf16 or float32 one
        (``Conv2d`` or ``Conv3DAsPacked``, not int8): the convs whose
        biases the block can fold."""
        convs = [self.in_conv, self.out_conv,
                 getattr(self, "skip_conv", None)]
        return all(c is None or isinstance(c, Conv2d) or (
            isinstance(c, Conv3DAsPacked) and c.quant is None)
            for c in convs) and self.in_conv.dtype in (torch.bfloat16,
                                                       torch.float32)

    def folds(self, x: torch.Tensor,
              emb: Optional[torch.Tensor] = None) -> bool:
        """Whether this call folds the convs' biases and the residual
        sum into K5 and K6 (see the class docstring)."""
        tensors = [x] + ([] if emb is None else [emb])
        return (self.fold is not False and self.plain_convs()
                and (hasattr(self, "skip_conv")
                     or x.dtype == self.in_conv.dtype)
                and (self.fold or x.device.type != "cpu")
                and not _build.autograd_required(*tensors,
                                                 *self.parameters()))

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None,
                *, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        dt = self.in_conv.dtype
        fold = self.folds(x, emb)
        h = self.in_norm(x.to(dt), act="silu")
        if self.up:
            h, x = _up2(h), _up2(x)
        elif self.down:
            h, x = _down2(h), _down2(x)
        # folded: the bias-free product; out_norm adds in_conv's bias
        h = self.in_conv.product(h) if fold else self.in_conv(h)
        bias = self.in_conv.packed_bias() if fold else None
        if emb is not None:
            emb_out = self.emb_proj(F.silu(emb.to(dt))).to(h.dtype)
            # per-C scale and shift, the same on every z plane: the norm
            # applies silu(h * (1 + scale) + shift) before its store
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_norm(h, act="modulate_silu", scale=scale,
                              shift=shift, bias=bias)
        else:
            h = self.out_norm(h, act="silu", bias=bias)
        if self.training and self.dropout > 0 and generator is not None:
            h = dropout(h, self.dropout, generator)   # on the packed map
        skip = getattr(self, "skip_conv", None)
        if fold:   # one K6 launch: both biases and the residual sum
            return residual(
                self.out_conv.product(h), self.out_conv.packed_bias(),
                x if skip is None else skip.product(x),
                None if skip is None else skip.packed_bias())
        h = self.out_conv(h)
        if skip is not None:
            x = skip(x)
        return (x + h).to(dt)


def _collage4(x: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """``to_collage`` of a packed (B*p1*p2, H, W, C) batch."""
    return to_collage(x[:, None], p1, p2)[:, 0]


class PackedTeraUNet(nn.Module):
    """See the module docstring; called as :class:`~.unet.TeraUNet`."""

    def __init__(self, conf: TeraUNetConfig, *, from_5d: bool = False,
                 packed_attn: bool = False, quant: Optional[str] = None,
                 prequant: bool = False, static_act: bool = False,
                 quant_attn: bool = False):
        super().__init__()
        require_unet_config(conf, "PackedTeraUNet")
        self.conf = conf
        self.from_5d, self.packed_attn = from_5d, packed_attn
        self.quant, self.prequant, self.static_act = quant, prequant, \
            static_act
        z = conf.z_size
        mc, nrb = conf.model_channels, conf.num_res_blocks
        nlvl = len(conf.channel_mult)
        rna_och = _rna_channels(conf.rna_num)
        emb = conf.embed_channels
        # JAX's routing: the ResBlock convs take quant, prequant and
        # static_act; the DiT blocks only with quant_attn
        qa = quant if (quant_attn and quant) else None
        self.quant_attn = qa is not None

        def res(name, cin, cout, **kw):
            self.add_module(name, PackedResBlock(
                cin, cout, z, emb, use_zero_module=conf.use_zero_module,
                from_5d=from_5d, dropout=conf.dropout, quant=quant,
                prequant=prequant, static_act=static_act, **kw))

        def dit(name, c, cond):
            self.add_module(name, DiTBlock(
                c, cond, conf.num_heads, n_win=2, packed_tokens=packed_attn,
                quant=qa, prequant=qa is not None and prequant,
                static_act=qa is not None and static_act))

        def pixel_conv(cin, cout):        # the (1, 3, 3) stem and out_conv
            if from_5d:
                return Conv3DAsPacked(cin, cout, (1, 3, 3), z)
            return conv2p(z * cin, z * cout, (3, 3))

        self.time_embed = TimeEmbed(mc, emb, use_pos=conf.use_pos)
        self.rna_tower = RNATower(conf.rna_num, len(conf.rna_tpl),
                                  conf.gn_sz)
        self.stem = pixel_conv(conf.stains, mc)

        # encoder (channel bookkeeping mirrors forward)
        ch, resolution, k = mc, conf.image_size, 1
        skips = [[ch]]
        for lvl, mult in enumerate(conf.channel_mult):
            if lvl > 0:
                res(f"enc_{k}_res", ch, ch, down=True)
                resolution //= 2
                k += 1
                skips.append([ch])
            rch = rna_och[nlvl - 1 - lvl]
            for _ in range(nrb):
                res(f"enc_{k}_res", ch + rch, mult * mc,
                    in_segments=(ch, rch))
                ch = mult * mc
                if resolution in conf.attention_resolutions:
                    dit(f"enc_{k}_attn", ch, rch)
                skips[lvl].append(ch)
                k += 1

        res("mid_res0", ch + rna_och[0], ch, in_segments=(ch, rna_och[0]))
        dit("mid_attn", ch, rna_och[0])
        res("mid_res1", ch, ch)

        # decoder (shared by the collage and the original pass)
        k = 0
        for i in range(nlvl):
            lvl = nlvl - 1 - i
            mult = conf.channel_mult[lvl]
            for j in range(nrb + 1):
                sk = skips[lvl].pop()
                res(f"dec_{k}_res", ch + sk + rna_och[i], mult * mc,
                    in_segments=(ch, sk, rna_och[i]))
                ch = mult * mc
                if resolution in conf.attention_resolutions:
                    dit(f"dec_{k}_attn", ch, rna_och[i])
                if lvl > 0 and j == nrb:
                    res(f"dec_{k}_up", ch, ch, up=True)
                    resolution *= 2
                k += 1
        self.out_norm = GroupedRMSNorm(z, (ch,), from_5d=from_5d)
        self.out_conv = pixel_conv(ch, conf.stains)

    def _get(self, name: str) -> Optional[nn.Module]:
        return getattr(self, name, None)

    def _attn(self, block: DiTBlock, h: torch.Tensor,
              cond: torch.Tensor) -> torch.Tensor:
        """A DiT block on packed h and cond: on the (h, w, z) tokens with
        ``packed_attn``, else unpacked to 5D around the block."""
        z = self.conf.z_size
        if self.packed_attn:
            return block(h, cond, z)
        return pack_features(block(unpack_features(h, z),
                                   unpack_features(cond, z)), z)

    def forward(self, x: torch.Tensor, t: torch.Tensor, rna: torch.Tensor,
                p1: int, p2: int, *, decode_original: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        conf = self.conf
        dt = self.stem.dtype
        z = conf.z_size
        nrb = conf.num_res_blocks
        nlvl = len(conf.channel_mult)

        emb_b = self.time_embed(timestep_embedding(t, conf.model_channels))
        emb_orig = emb_b.repeat_interleave(p1 * p2, dim=0)
        emb_col = emb_b.repeat_interleave((p1 - 1) * (p2 - 1), dim=0)

        rna_grid = rna_grid_from_dense(rna.to(dt), len(conf.rna_tpl),
                                       conf.rna_num)
        feats5, pres5, _ = self.rna_tower(rna_grid)
        rna_feats = [pack_features(f, z) for f in feats5]
        rna_pres = [pack_features(f, z) for f in pres5]

        # ---- encoder
        h = self.stem(pixel_to_packed(x.to(dt), z))
        hid: List[List[torch.Tensor]] = [[h]]
        k = 1
        for lvl in range(nlvl):
            if lvl > 0:
                h = self._get(f"enc_{k}_res")(h, emb_orig,
                                              generator=generator)
                k += 1
                hid.append([h])
            rfeat = rna_feats[nlvl - 1 - lvl]
            for _ in range(nrb):
                h = self._get(f"enc_{k}_res")(torch.cat([h, rfeat], -1),
                                              emb_orig, generator=generator)
                attn = self._get(f"enc_{k}_attn")
                if attn is not None:
                    h = self._attn(attn, h, rfeat)
                hid[lvl].append(h)
                k += 1

        # ---- middle
        h = self.mid_res0(torch.cat([h, rna_feats[0]], -1), emb_orig,
                          generator=generator)
        h = self._attn(self.mid_attn, h, rna_feats[0])
        h = self.mid_res1(h, emb_orig, generator=generator)

        # ---- dual decoder: o=0 collage pass, o=1 original patches
        preds = []
        for o in range(2 if decode_original else 1):
            hdec = h
            emb = emb_col if o == 0 else emb_orig
            skips = [list(level) for level in hid]
            k = 0
            for i in range(nlvl):
                lvl = nlvl - 1 - i
                if o == 0:
                    if i == 0:
                        hdec = _collage4(hdec, p1, p2)
                    # collage the pre-upsample rna stage, then upsample
                    rcnd = _up2(_collage4(rna_pres[i], p1, p2))
                else:
                    rcnd = rna_feats[i]
                for _ in range(nrb + 1):
                    hcnd = skips[lvl].pop()
                    if o == 0:
                        hcnd = _collage4(hcnd, p1, p2)
                    hdec = self._get(f"dec_{k}_res")(
                        torch.cat([hdec, hcnd, rcnd], -1), emb,
                        generator=generator)
                    attn = self._get(f"dec_{k}_attn")
                    if attn is not None:
                        hdec = self._attn(attn, hdec, rcnd)
                    up = self._get(f"dec_{k}_up")
                    if up is not None:
                        hdec = up(hdec, emb, generator=generator)
                    k += 1

            out = self.out_conv(self.out_norm(hdec, act="silu"))
            preds.append(packed_to_pixel(out, z).float())

        return preds[0], (preds[1] if decode_original else None)


def require_unet_config(conf, what: str) -> None:
    """Refuse a baseline's config: the packed layout re-parameterizes
    TeraUNet only.  The JAX package fails on the baselines there too
    (``pack_unet_params``: a GroupNorm has no ``weight``, a SinfNet config
    no ``num_res_blocks``; ``PackedTeraUNet``: patch-dm's ``use_pos``
    assertion)."""
    if not isinstance(conf, TeraUNetConfig):
        raise ValueError(
            f"{what}: the packed layout re-parameterizes TeraUNet ('ours') "
            f"only, not {type(conf).__name__} (the JAX package fails there "
            "too); run the baseline as its 5D model (cli.generate "
            "--no_packed, cli.train without --packed)")


def make_packed_model(conf: TeraUNetConfig,
                      param_dtype: Optional[torch.dtype] = None,
                      **kw) -> PackedTeraUNet:
    """:class:`PackedTeraUNet` computing in the compute dtype on the CPU,
    its parameters in ``param_dtype`` and its ``time_embed`` float32, as
    ``TeraUNetConfig.make_model`` does for the 5D model; ``kw``:
    ``from_5d``, ``packed_attn``, ``quant``, ``prequant``, ``static_act``,
    ``quant_attn``.  The quant modules' scales stay float32."""
    return set_compute_dtype(PackedTeraUNet(conf, **kw), conf.dtype,
                             param_dtype=param_dtype)


# --------------------------------------------------------------------- #
# 5D -> packed parameter transform (numpy, flax-named trees)             #
# --------------------------------------------------------------------- #
def _block_segments(conf: TeraUNetConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-block input segments (per-z channel counts) at the forward's
    plain-concat sites; blocks absent from the map have one segment."""
    mc = conf.model_channels
    nrb = conf.num_res_blocks
    nlvl = len(conf.channel_mult)
    rna_och = _rna_channels(conf.rna_num)
    segs: Dict[str, Tuple[int, ...]] = {}
    ch = mc
    hid_ch: List[List[int]] = [[mc]]
    k = 1
    for lvl, mult in enumerate(conf.channel_mult):
        if lvl > 0:
            k += 1
            hid_ch.append([ch])
        rch = rna_och[nlvl - 1 - lvl]
        for _ in range(nrb):
            segs[f"enc_{k}_res"] = (ch, rch)
            ch = mult * mc
            hid_ch[lvl].append(ch)
            k += 1
    segs["mid_res0"] = (ch, rna_och[0])
    dch = ch
    k = 0
    skips = [list(level) for level in hid_ch]
    for i in range(nlvl):
        lvl = nlvl - 1 - i
        mult = conf.channel_mult[lvl]
        for _ in range(nrb + 1):
            sk = skips[lvl].pop()
            segs[f"dec_{k}_res"] = (dch, sk, rna_och[i])
            dch = mult * mc
            k += 1
    return segs


def pack_unet_params(params5: Dict, conf: TeraUNetConfig) -> Dict:
    """A TeraUNet flax-named tree (numpy leaves) -> PackedTeraUNet's.

    Conv kernels become block-structured 2D kernels with input rows
    permuted to the segment-major runtime layout; norm weights tile over
    z (segment-aware for concat inputs); the attention, RNA tower and
    time-embed subtrees pass through."""
    require_unet_config(conf, "pack_unet_params")
    z = conf.z_size
    segmap = _block_segments(conf)
    p5 = params5["params"] if "params" in params5 else params5
    out: Dict = {}
    for name, sub in p5.items():
        if name.endswith("_res") or name in ("mid_res0", "mid_res1") \
                or name.endswith("_up"):
            segs = segmap.get(name)
            blk = {}
            for lname, lv in sub.items():
                if lname in ("in_conv", "out_conv", "skip_conv"):
                    in_segs = segs if lname in ("in_conv",
                                                "skip_conv") else None
                    blk[lname] = {
                        "kernel": pack_conv3d_kernel(
                            np.asarray(lv["kernel"]), z, segments=in_segs),
                        "bias": pack_conv3d_bias(lv["bias"], z)}
                elif lname in ("in_norm", "out_norm"):
                    in_segs = segs if lname == "in_norm" else None
                    blk[lname] = {"weight": pack_channel_param(
                        lv["weight"], z, segments=in_segs)}
                else:
                    blk[lname] = lv
            out[name] = blk
        elif name in ("stem", "out_conv"):
            out[name] = {"kernel": pack_conv3d_kernel(
                np.asarray(sub["kernel"]), z),
                "bias": pack_conv3d_bias(sub["bias"], z)}
        elif name == "out_norm":
            out[name] = {"weight": pack_channel_param(sub["weight"], z)}
        else:
            out[name] = sub
    return {"params": out}
