"""TeraUNet: dual-decoder ("collage") 3D patch UNet with mRNA conditioning.

Port of ``tera_mind_tpu/models/unet.py``.  The network decodes twice with
shared weights: once on a half-patch-shifted collage reassembled from
neighbouring patches (what sampling reads) and, optionally, once on the
original patch grid (training's second loss).  Module names follow the
flax names (``stem``, ``enc_{k}_res``, ``enc_{k}_attn``, ``mid_res0``,
``dec_{k}_res``, ``dec_{k}_up``, ``rna_tower.gene_attn``, ...), so
``convert.load_jax_params`` maps a flax tree one for one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.collage import to_collage
from .attention import DiTBlock
from .blocks import ResBlock3D
from .nn import (Conv3d, RMSNorm, TimeEmbed, set_compute_dtype,
                 timestep_embedding, upsample_2x)
from .rna import RNA_CHANNELS, RNATower, rna_grid_from_dense


@dataclasses.dataclass(frozen=True)
class TeraUNetConfig:
    """Structural hyperparameters (the JAX package's TeraUNetConfig).
    ``use_pos`` is refused when the model is built (``TimeEmbed``): the
    JAX model asserts at its first call that a position embedding was
    passed, and no caller passes one."""

    image_size: int = 64          # patch size the UNet operates on
    in_channels: int = 4          # pixel channels = stains * z_size
    model_channels: int = 64
    out_channels: int = 4
    num_res_blocks: int = 2
    embed_channels: int = 512
    attention_resolutions: Tuple[int, ...] = (16,)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_heads: int = 1
    rna_tpl: Tuple[int, ...] = (0, 1, 2, 3)
    rna_num: int = 500
    gn_sz: int = 4                # gene bins per patch side
    use_zero_module: bool = True  # zero-init residual out-convs
    dropout: float = 0.1          # ResBlock dropout (training mode only)
    use_pos: bool = False         # position half of the time embedding
    dtype_name: str = "float32"   # compute dtype: float32 | bfloat16

    @property
    def z_size(self) -> int:
        """Image z-voxels per patch = ceil(len(rna_tpl)/2)."""
        return math.ceil(len(self.rna_tpl) / 2)

    @property
    def stains(self) -> int:
        return self.in_channels // self.z_size

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_name == "bfloat16" \
            else torch.float32

    def make_model(self, param_dtype: Optional[torch.dtype] = None
                   ) -> "TeraUNet":
        """The model computing in the compute dtype, on the CPU (weights
        uninitialised: see ``models.nn.init_weights`` and
        ``convert.load_jax_params``), its parameters in ``param_dtype``
        (default: the compute dtype, for generation; float32 master
        weights for training).  ``time_embed`` keeps float32 weights, as
        the JAX module (no ``dtype=``) computes in float32 on its float32
        params."""
        return set_compute_dtype(TeraUNet(self), self.dtype,
                                 param_dtype=param_dtype)


def _rna_channels(rna_num: int) -> List[int]:
    return [rna_num, *RNA_CHANNELS]


class TeraUNet(nn.Module):
    """Forward on a patch batch:

    x:   (B*p1*p2, ps, ps, in_channels) noisy pixel patches (stain-major
         channels: c = s*z_size + z)
    t:   (B,) timesteps on the ORIGINAL T scale
    rna: (B*p1*p2, gn_sz, gn_sz, z_rna*G) dense binned gene counts (z-major)
    p1, p2: patch-grid dims

    Returns (pred_collage (B*(p1-1)*(p2-1), ps, ps, out_channels),
             pred_original (B*p1*p2, ps, ps, out_channels) or None), f32.

    ``generator``: in training mode, the ResBlocks' dropout masks come
    from it (without one, or in eval mode, no dropout).
    """

    def __init__(self, conf: TeraUNetConfig):
        super().__init__()
        self.conf = conf
        mc, nrb = conf.model_channels, conf.num_res_blocks
        nlvl = len(conf.channel_mult)
        rna_och = _rna_channels(conf.rna_num)
        emb = conf.embed_channels
        zero = conf.use_zero_module

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock3D(cin, cout, emb,
                                             use_zero_module=zero,
                                             dropout=conf.dropout, **kw))

        def dit(name, c, cond):
            self.add_module(name, DiTBlock(c, cond, conf.num_heads, n_win=2))

        self.time_embed = TimeEmbed(mc, emb, use_pos=conf.use_pos)
        self.rna_tower = RNATower(conf.rna_num, len(conf.rna_tpl),
                                  conf.gn_sz)
        self.stem = Conv3d(conf.stains, mc, (1, 3, 3))

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
                res(f"enc_{k}_res", ch + rch, mult * mc)
                ch = mult * mc
                if resolution in conf.attention_resolutions:
                    dit(f"enc_{k}_attn", ch, rch)
                skips[lvl].append(ch)
                k += 1

        res("mid_res0", ch + rna_och[0], ch)
        dit("mid_attn", ch, rna_och[0])
        res("mid_res1", ch, ch)

        # decoder (shared by the collage and the original pass)
        k = 0
        for i in range(nlvl):
            lvl = nlvl - 1 - i
            mult = conf.channel_mult[lvl]
            for j in range(nrb + 1):
                res(f"dec_{k}_res", ch + skips[lvl].pop() + rna_och[i],
                    mult * mc)
                ch = mult * mc
                if resolution in conf.attention_resolutions:
                    dit(f"dec_{k}_attn", ch, rna_och[i])
                if lvl > 0 and j == nrb:
                    res(f"dec_{k}_up", ch, ch, up=True)
                    resolution *= 2
                k += 1
        self.out_norm = RMSNorm(ch)
        self.out_conv = Conv3d(ch, conf.stains, (1, 3, 3))

    def _get(self, name: str) -> Optional[nn.Module]:
        return getattr(self, name, None)

    def forward(self, x: torch.Tensor, t: torch.Tensor, rna: torch.Tensor,
                p1: int, p2: int, *, decode_original: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        conf = self.conf
        dt = self.stem.dtype
        z_size = conf.z_size
        nrb = conf.num_res_blocks
        nlvl = len(conf.channel_mult)

        emb_b = self.time_embed(timestep_embedding(t, conf.model_channels))
        emb_orig = emb_b.repeat_interleave(p1 * p2, dim=0)
        emb_col = emb_b.repeat_interleave((p1 - 1) * (p2 - 1), dim=0)

        rna_grid = rna_grid_from_dense(rna.to(dt), len(conf.rna_tpl),
                                       conf.rna_num)
        rna_feats, rna_pres, _ = self.rna_tower(rna_grid)

        bp, ps = x.shape[:2]
        h = x.to(dt).reshape(bp, ps, ps, conf.stains, z_size)
        h = h.permute(0, 4, 1, 2, 3)                    # (Bp, Z, ps, ps, S)

        # ---- encoder
        h = self.stem(h)
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
                    h = attn(h, rfeat)
                hid[lvl].append(h)
                k += 1

        # ---- middle
        h = self.mid_res0(torch.cat([h, rna_feats[0]], -1), emb_orig,
                          generator=generator)
        h = self.mid_attn(h, rna_feats[0])
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
                        hdec = to_collage(hdec, p1, p2)
                    # collage the pre-upsample rna stage, then upsample
                    rcnd = upsample_2x(to_collage(rna_pres[i], p1, p2))
                else:
                    rcnd = rna_feats[i]
                for _ in range(nrb + 1):
                    hcnd = skips[lvl].pop()
                    if o == 0:
                        hcnd = to_collage(hcnd, p1, p2)
                    hdec = self._get(f"dec_{k}_res")(
                        torch.cat([hdec, hcnd, rcnd], -1), emb,
                        generator=generator)
                    attn = self._get(f"dec_{k}_attn")
                    if attn is not None:
                        hdec = attn(hdec, rcnd)
                    up = self._get(f"dec_{k}_up")
                    if up is not None:
                        hdec = up(hdec, emb, generator=generator)
                    k += 1

            out = self.out_conv(F.silu(self.out_norm(hdec)))
            # voxel -> pixel: (B, Z, ps, ps, S) -> (B, ps, ps, S*Z)
            out = out.permute(0, 2, 3, 4, 1).reshape(
                out.shape[0], ps, ps, conf.out_channels)
            preds.append(out.float())

        return preds[0], (preds[1] if decode_original else None)
