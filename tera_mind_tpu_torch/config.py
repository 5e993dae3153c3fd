"""Experiment configuration: typed dataclass + JSON serde + presets.

Port of ``tera_mind_tpu/config.py``: ``TrainConfig`` with the JAX
dataclass's fields (a ``config.json`` written by either package loads
in the other: each ignores the other's extra fields), the canonical
preset ``prep_config`` (reference config_parm.py:5-59) with the run-name
convention ``{mouse}_{size}_{nrna}_{stain}_{srna}_{method}``,
``config_from_name`` and the model / sampler factories.  Only the
``ours`` model is ported, with deterministic DDIM sampling; the JAX
package's fields for the TPU mesh and prefetching and its sampler choice
(``mesh_shape``, ``prefetch_depth``, ``gen_type``) are not kept.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional, Tuple

from .constants import MOUSE
from .diffusion.sampler import DiffusionSampler, SamplerConfig
from .diffusion.schedule import spaced_schedule, train_schedule
from .models.unet import TeraUNetConfig


@dataclasses.dataclass
class TrainConfig:
    # identity
    name: str = "test"
    method: str = "ours"              # only 'ours' is ported
    seed: int = 0

    # data
    mouse: str = "638850"
    data_path: str = ""
    stain: str = "all"                # 'DAPI' | 'PolyT' | 'all'
    rna_num: int = 500                # gene panel size the model uses
    rna_slices: int = 4               # srna: RNA z-slices per window
    image_size: int = 64              # patch size
    gn_blk: int = 16                  # px per gene bin
    train_crop: int = 256             # spatial crop fed to training
    repeat: int = 10
    use_exl: bool = False

    # diffusion
    T: int = 1000
    T_eval: int = 15
    beta_scheduler: str = "linear"
    loss_type: str = "mse"

    # model
    net_ch: int = 64
    net_ch_mult: Tuple[int, ...] = (1, 2, 4, 8)
    net_attn: Tuple[int, ...] = (16,)
    net_num_res_blocks: int = 2
    embed_channels: int = 512
    dropout: float = 0.1
    use_pos: bool = False

    # optimization
    lr: float = 2e-5
    warmup: int = 0
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    batch_size: int = 32              # global batch
    accum_batches: int = 2            # 64 // batch (config_parm.py:45)
    total_samples: int = 10_000_000
    ema_decay: float = 0.9999

    # runtime
    compute_dtype: str = "bfloat16"   # model compute dtype
    remat: bool = False               # activation checkpointing of the UNet
                                      # forward (reference use_checkpoint,
                                      # config.py:101, off by default)
    packed_compute: bool = False      # the z-packed layout on 5D params
    packed_attn: bool = False         # with packed_compute: DiT blocks on
                                      # the packed (h, w, z) tokens
    sample_every_steps: int = 2500
    save_every_steps: int = 10_000
    sample_size: int = 4
    base_dir: str = "checkpoints"

    # ---- derived -----------------------------------------------------
    @property
    def rna_tpl(self) -> Tuple[int, ...]:
        return tuple(range(self.rna_slices))

    @property
    def gn_sz(self) -> int:
        """Gene bins per patch side (config_parm.py:47)."""
        return self.image_size // 16

    @property
    def z_size(self) -> int:
        return math.ceil(self.rna_slices / 2)

    @property
    def in_channels(self) -> int:
        """Pixel channels = ceil(srna/2), x2 for stain='all'."""
        return self.z_size * 2 if self.stain == "all" else self.z_size

    @property
    def logdir(self) -> str:
        return f"{self.base_dir}/{self.name}"

    @property
    def batch_size_effective(self) -> int:
        return self.batch_size * self.accum_batches

    # ---- factories -----------------------------------------------------
    def make_model_conf(self) -> TeraUNetConfig:
        if self.method not in ("ours", "ours_vis"):
            raise NotImplementedError(f"method {self.method!r}: only 'ours' "
                                      "is ported (the baselines are not)")
        if self.use_pos:
            raise NotImplementedError("use_pos: the position embedding "
                                      "serves the patch-dm baseline, not "
                                      "ported")
        return TeraUNetConfig(
            image_size=self.image_size,
            in_channels=self.in_channels,
            out_channels=self.in_channels,
            model_channels=self.net_ch,
            num_res_blocks=self.net_num_res_blocks,
            embed_channels=self.embed_channels,
            attention_resolutions=tuple(self.net_attn),
            dropout=self.dropout,
            channel_mult=tuple(self.net_ch_mult),
            rna_tpl=self.rna_tpl,
            rna_num=self.rna_num,
            gn_sz=self.gn_sz,
            dtype_name=self.compute_dtype,
        )

    def make_train_sampler(self) -> DiffusionSampler:
        return DiffusionSampler(
            train_schedule(self.beta_scheduler, self.T),
            SamplerConfig(patch_size=self.image_size, gn_sz=self.gn_sz,
                          loss_type=self.loss_type))

    def make_eval_sampler(self, T: Optional[int] = None) -> DiffusionSampler:
        """Deterministic DDIM over T (default ``T_eval``) respaced steps."""
        sched = spaced_schedule(self.beta_scheduler, self.T,
                                f"ddim{T or self.T_eval}")
        return DiffusionSampler(
            sched, SamplerConfig(patch_size=self.image_size, gn_sz=self.gn_sz,
                                 loss_type=self.loss_type))

    # ---- serde ---------------------------------------------------------
    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.as_dict(), indent=2,
                                         default=str))

    @classmethod
    def load(cls, path: str | Path) -> "TrainConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for k in ("net_ch_mult", "net_attn"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


def prep_config(mouse: str, *, batch: int = 32, size: int = 64,
                stain: str = "all", nrna: Optional[int] = None,
                srna: int = 4, method: str = "ours",
                data_path: str = "") -> TrainConfig:
    """Canonical preset (reference config_parm.py:5-59): nrna defaults to
    229 for 638850 and 500 for the other mice; 81 selects human-brain
    transfer; ``accum_batches`` is 64 // batch (at least 1)."""
    if mouse not in MOUSE:
        raise ValueError(f"unknown mouse {mouse!r}, not in {sorted(MOUSE)}")
    if size not in (32, 64, 128):
        raise ValueError(f"patch size {size} not in (32, 64, 128)")
    if nrna is None:
        nrna = 229 if mouse == "638850" else 500
    return TrainConfig(
        mouse=mouse,
        data_path=data_path or mouse,
        batch_size=batch,
        image_size=size,
        stain=stain,
        rna_num=nrna,
        rna_slices=srna,
        method=method,
        accum_batches=max(1, 64 // batch),
        use_exl=(size == 32),
        name=f"{mouse}_{size}_{nrna}_{stain}_{srna}_{method}",
    )


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
