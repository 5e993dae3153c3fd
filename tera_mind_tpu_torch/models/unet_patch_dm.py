"""Patch-DM baseline UNet (method='patch-dm').

Port of ``tera_mind_tpu/models/unet_patch_dm.py`` (the reference baseline
CTPLab/Tera-MIND model/unet_patch_dm.py): the flagship model's
dual-decoder collage scheme with the original Patch-DM design choices:

- GroupNorm residual blocks and 8x8-window single-head self-attention
  (``models/legacy_blocks.py``) instead of RMSNorm / DiT blocks;
- RNA features concatenated in the decoder only, with no adaLN
  conditioning and no gene cross-attention;
- per-patch sinusoidal position embeddings beside the time embedding
  (``[time_half | pos_half]``): the original decoder uses the caller's
  patch grid, the collage decoder the shifted (p1-1) x (p2-1) grid.

``forward(x, t, rna, p1, p2) -> (pred_col, pred_orig)`` as the flagship
model's, so it plugs into the sampler and the generator unchanged.  No
kernel of the port runs here but K1, in the RNA tower's two RMSNorms (the
flagship model's tower); the rest is stock PyTorch.

Dtypes follow the JAX module's promotions: the RNA tower computes in the
compute dtype, every other module in its weights' dtype (float32 master
weights in training: float32 compute; the compute dtype in generation),
``time_embed`` in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.collage import to_collage
from .legacy_blocks import GroupNorm32, LegacyResBlock3D, WindowSelfAttention
from .nn import Conv3d, TimeEmbed, set_compute_dtype, timestep_embedding
from .rna import RNA_CHANNELS, RNATower, rna_grid_from_dense

POS_DIM = 64    # sinusoid width per grid axis of the position embedding


@dataclasses.dataclass(frozen=True)
class PatchDMUNetConfig:
    """Structural hyperparameters (reference unet_patch_dm.py:30-106)."""

    image_size: int = 64
    in_channels: int = 4
    model_channels: int = 64
    out_channels: int = 4
    num_res_blocks: int = 2
    embed_channels: int = 512
    attention_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.1
    channel_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_heads: int = 1
    rna_tpl: Tuple[int, ...] = (0, 1, 2, 3)
    rna_num: int = 500
    gn_sz: int = 4
    use_pos: bool = True          # patch-dm default (unet_patch_dm.py:142)
    use_zero_module: bool = True
    dtype_name: str = "float32"

    @property
    def z_size(self) -> int:
        return math.ceil(len(self.rna_tpl) / 2)

    @property
    def stains(self) -> int:
        return self.in_channels // self.z_size

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_name == "bfloat16" \
            else torch.float32

    def make_model(self, param_dtype: Optional[torch.dtype] = None
                   ) -> "PatchDMUNet":
        """The model on the CPU (weights uninitialised), its parameters in
        ``param_dtype`` (default: the compute dtype) with ``time_embed``
        float32, the RNA tower computing in the compute dtype."""
        return baseline_dtypes(PatchDMUNet(self), self.dtype, param_dtype)


def baseline_dtypes(model: nn.Module, dtype: torch.dtype,
                    param_dtype: Optional[torch.dtype]) -> nn.Module:
    """A baseline's parameters in ``param_dtype`` (default ``dtype``),
    each module computing in its weights' dtype but ``time_embed``
    (float32) and ``rna_tower`` (``dtype``, as JAX's ``RNATower(dtype=)``)."""
    param_dtype = param_dtype or dtype
    set_compute_dtype(model, param_dtype)
    set_compute_dtype(model.rna_tower, dtype, param_dtype=param_dtype)
    return model


def _grid_pos_emb(p1: int, p2: int, b: int, dim: int = POS_DIM,
                  device=None) -> torch.Tensor:
    """Sinusoidal embedding of patch-center positions (i+0.5, j+0.5) for a
    (p1 x p2) grid, tiled over the batch (unet_patch_dm.py:430-435)."""
    xs = torch.arange(p1, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(p2, dtype=torch.float32, device=device) + 0.5
    px = timestep_embedding(xs.repeat_interleave(p2), dim)
    py = timestep_embedding(ys.repeat(p1), dim)
    return torch.cat([px, py], dim=-1).repeat(b, 1)    # (b*p1*p2, 2*dim)


class PatchDMUNet(nn.Module):
    """See the module docstring.  ``generator``: in training mode the
    ResBlocks' dropout masks come from it (none without one)."""

    def __init__(self, conf: PatchDMUNetConfig):
        super().__init__()
        self.conf = conf
        mc, nrb, emb = (conf.model_channels, conf.num_res_blocks,
                        conf.embed_channels)
        nlvl = len(conf.channel_mult)
        rna_och = [conf.rna_num, *RNA_CHANNELS]

        def res(name, cin, cout, **kw):
            self.add_module(name, LegacyResBlock3D(
                cin, cout, emb, dropout=conf.dropout,
                use_zero_module=conf.use_zero_module, **kw))

        self.time_embed = TimeEmbed(mc, emb, use_pos=conf.use_pos,
                                    pos_channels=2 * POS_DIM)
        self.rna_tower = RNATower(conf.rna_num, len(conf.rna_tpl),
                                  conf.gn_sz)
        self.stem = Conv3d(conf.stains, mc, (1, 3, 3))

        # encoder (no RNA; channel bookkeeping mirrors forward)
        ch, resolution, k = mc, conf.image_size, 1
        skips = [[ch]]
        for lvl, mult in enumerate(conf.channel_mult):
            if lvl > 0:
                res(f"enc_{k}_res", ch, ch, down=True)
                resolution //= 2
                k += 1
                skips.append([ch])
            for _ in range(nrb):
                res(f"enc_{k}_res", ch, mult * mc)
                ch = mult * mc
                if resolution in conf.attention_resolutions:
                    self.add_module(f"enc_{k}_attn", WindowSelfAttention(ch))
                skips[lvl].append(ch)
                k += 1

        res("mid_res0", ch, ch)
        self.mid_attn = WindowSelfAttention(ch)
        res("mid_res1", ch, ch)

        # decoder, shared by the collage and the original pass
        k = 0
        for i in range(nlvl):
            lvl = nlvl - 1 - i
            mult = conf.channel_mult[lvl]
            for j in range(nrb + 1):
                res(f"dec_{k}_res", ch + skips[lvl].pop() + rna_och[i],
                    mult * mc)
                ch = mult * mc
                if resolution in conf.attention_resolutions:
                    self.add_module(f"dec_{k}_attn", WindowSelfAttention(ch))
                if lvl > 0 and j == nrb:
                    res(f"dec_{k}_up", ch, ch, up=True)
                    resolution *= 2
                k += 1
        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv3d(ch, conf.stains, (1, 3, 3),
                               zero_init=conf.use_zero_module)

    def _get(self, name: str) -> Optional[nn.Module]:
        return getattr(self, name, None)

    def forward(self, x: torch.Tensor, t: torch.Tensor, rna: torch.Tensor,
                p1: int, p2: int, *, decode_original: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        conf = self.conf
        dt = conf.dtype
        nrb = conf.num_res_blocks
        nlvl = len(conf.channel_mult)
        b = t.shape[0]

        # time(+pos) embeddings, one per decoder grid
        def grid_emb(g1: int, g2: int) -> torch.Tensor:
            te = timestep_embedding(t.repeat_interleave(g1 * g2),
                                    conf.model_channels)
            pe = _grid_pos_emb(g1, g2, b, device=t.device) \
                if conf.use_pos else None
            return self.time_embed(te, pe)

        emb_orig = grid_emb(p1, p2)
        emb_col = grid_emb(p1 - 1, p2 - 1)

        # RNA tower (decoder-only conditioning)
        rna_grid = rna_grid_from_dense(rna.to(dt), len(conf.rna_tpl),
                                       conf.rna_num)
        rna_feats = self.rna_tower(rna_grid)[0]

        # pixel -> voxel: (Bp, Z, ps, ps, S)
        bp, ps = x.shape[:2]
        h = x.to(dt).reshape(bp, ps, ps, conf.stains, conf.z_size)
        h = h.permute(0, 4, 1, 2, 3)

        # encoder
        h = self.stem(h)
        hid: List[List[torch.Tensor]] = [[h]]
        k = 1
        for lvl in range(nlvl):
            if lvl > 0:
                h = self._get(f"enc_{k}_res")(h, emb_orig,
                                              generator=generator)
                k += 1
                hid.append([h])
            for _ in range(nrb):
                h = self._get(f"enc_{k}_res")(h, emb_orig,
                                              generator=generator)
                attn = self._get(f"enc_{k}_attn")
                if attn is not None:
                    h = attn(h)
                hid[lvl].append(h)
                k += 1

        # middle
        h = self.mid_res0(h, emb_orig, generator=generator)
        h = self.mid_attn(h)
        h = self.mid_res1(h, emb_orig, generator=generator)

        # dual decoder: o=0 collage pass, o=1 original patches
        preds = []
        for o in range(2 if decode_original else 1):
            hdec = h
            emb = emb_col if o == 0 else emb_orig
            skips = [list(level) for level in hid]
            k = 0
            for i in range(nlvl):
                lvl = nlvl - 1 - i
                rcnd = rna_feats[i]
                if o == 0:
                    if i == 0:
                        hdec = to_collage(hdec, p1, p2)
                    rcnd = to_collage(rcnd, p1, p2)
                for _ in range(nrb + 1):
                    hcnd = skips[lvl].pop()
                    if o == 0:
                        hcnd = to_collage(hcnd, p1, p2)
                    hdec = self._get(f"dec_{k}_res")(
                        torch.cat([hdec, hcnd, rcnd.to(hdec.dtype)], -1),
                        emb, generator=generator)
                    attn = self._get(f"dec_{k}_attn")
                    if attn is not None:
                        hdec = attn(hdec)
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
