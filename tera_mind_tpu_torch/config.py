"""Experiment configuration for the port's generation path.

Port of ``tera_mind_tpu/config.py``: ``TrainConfig`` with the fields the
generation slice reads, the canonical preset ``prep_config`` (reference
config_parm.py:5-59), ``config_from_name`` and the model / eval-sampler
factories.  Only the ``ours`` model is ported; training, data-loading and
run-naming fields come with the slices that read them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .constants import MOUSE
from .diffusion.sampler import DiffusionSampler, SamplerConfig
from .diffusion.schedule import spaced_schedule
from .models.unet import TeraUNetConfig


@dataclasses.dataclass
class TrainConfig:
    seed: int = 0

    # data
    mouse: str = "638850"
    stain: str = "all"                # 'DAPI' | 'PolyT' | 'all'
    rna_num: int = 500                # gene panel size the model uses
    rna_slices: int = 4               # srna: RNA z-slices per window
    image_size: int = 64              # patch size

    # diffusion
    T: int = 1000
    T_eval: int = 15
    beta_scheduler: str = "linear"

    # model
    net_ch: int = 64
    net_ch_mult: Tuple[int, ...] = (1, 2, 4, 8)
    net_attn: Tuple[int, ...] = (16,)
    net_num_res_blocks: int = 2
    embed_channels: int = 512

    # runtime
    compute_dtype: str = "bfloat16"   # model compute dtype

    @property
    def rna_tpl(self) -> Tuple[int, ...]:
        return tuple(range(self.rna_slices))

    @property
    def gn_sz(self) -> int:
        """Gene bins per patch side."""
        return self.image_size // 16

    @property
    def z_size(self) -> int:
        return math.ceil(self.rna_slices / 2)

    @property
    def in_channels(self) -> int:
        """Pixel channels = ceil(srna/2), x2 for stain='all'."""
        return self.z_size * 2 if self.stain == "all" else self.z_size

    def make_model_conf(self) -> TeraUNetConfig:
        return TeraUNetConfig(
            image_size=self.image_size,
            in_channels=self.in_channels,
            out_channels=self.in_channels,
            model_channels=self.net_ch,
            num_res_blocks=self.net_num_res_blocks,
            embed_channels=self.embed_channels,
            attention_resolutions=tuple(self.net_attn),
            channel_mult=tuple(self.net_ch_mult),
            rna_tpl=self.rna_tpl,
            rna_num=self.rna_num,
            gn_sz=self.gn_sz,
            dtype_name=self.compute_dtype,
        )

    def make_eval_sampler(self, T: Optional[int] = None) -> DiffusionSampler:
        """Deterministic DDIM over T (default ``T_eval``) respaced steps."""
        sched = spaced_schedule(self.beta_scheduler, self.T,
                                f"ddim{T or self.T_eval}")
        return DiffusionSampler(
            sched, SamplerConfig(patch_size=self.image_size, gn_sz=self.gn_sz))


def prep_config(mouse: str, *, size: int = 64, stain: str = "all",
                nrna: Optional[int] = None, srna: int = 4) -> TrainConfig:
    """Canonical preset: nrna defaults to 229 for 638850 and 500 for the
    other mice; 81 selects human-brain transfer."""
    if mouse not in MOUSE:
        raise ValueError(f"unknown mouse {mouse!r}, not in {sorted(MOUSE)}")
    if size not in (32, 64, 128):
        raise ValueError(f"patch size {size} not in (32, 64, 128)")
    if nrna is None:
        nrna = 229 if mouse == "638850" else 500
    return TrainConfig(mouse=mouse, image_size=size, stain=stain,
                       rna_num=nrna, rna_slices=srna)


def config_from_name(name: str) -> TrainConfig:
    """Re-derive a config from a run or checkpoint directory name,
    ``{mouse}_{size}_{nrna}_{stain}_{srna}[_{method}]`` (reference
    test_brn.py:337-344).  Only the ``ours`` method is ported."""
    parts = name.split("_")
    if len(parts) < 5:
        raise ValueError(f"run name {name!r} is not "
                         "mouse_size_nrna_stain_srna[_method]")
    mouse, size, nrna, stain, srna = parts[:5]
    method = parts[5] if len(parts) > 5 else "ours"
    if method != "ours":
        raise NotImplementedError(f"method {method!r}: only 'ours' is "
                                  "ported (the baselines are not)")
    return prep_config(mouse, size=int(size), stain=stain, nrna=int(nrna),
                       srna=int(srna))
