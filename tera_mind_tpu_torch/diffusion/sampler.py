"""Patch-wise diffusion sampler: the single-step denoise that the
tera-scale generator runs.

Port of ``tera_mind_tpu/diffusion/sampler.py`` (``SamplerConfig``,
``_assemble_eps``, ``denoise_step``; deterministic DDIM).  The training
loss and the full sampling loop belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..ops.collage import patchify, unpatchify
from .schedule import Schedule

# model(x_patches, t_model, rna_patches, p1, p2) -> (pred_collage, pred_orig)
ModelFn = Callable[..., tuple]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Geometry of the deterministic DDIM (eta 0) sampler; the JAX
    config's loss type and DDPM / eta > 0 options are not ported."""

    patch_size: int = 64
    gn_sz: int = 4            # gene bins per patch side


class DiffusionSampler:
    """Stateless sampler bound to a schedule + static geometry config."""

    def __init__(self, schedule: Schedule, conf: SamplerConfig):
        self.schedule = schedule
        self.conf = conf

    def to(self, device) -> "DiffusionSampler":
        return DiffusionSampler(self.schedule.to(device), self.conf)

    def _assemble_eps(self, pred_col: torch.Tensor, p1: int,
                      p2: int) -> torch.Tensor:
        """Collage-decoder output ((p1-1)*(p2-1) patches) -> (p1*p2)
        patches: the shifted patches tile the interior of the padded
        image, and the outer half-patch border is filled with -1."""
        ps = self.conf.patch_size
        half = ps // 2
        img = unpatchify(pred_col, p1 - 1, p2 - 1)
        img = F.pad(img, (0, 0, half, half, half, half), value=-1.0)
        return patchify(img, ps)

    def denoise_step(self, model: ModelFn, x_pad: torch.Tensor,
                     rna_pat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One reverse DDIM (eta 0) step.

        x_pad:   (B, H+ps, W+ps, C) half-patch-padded state (halo included)
        rna_pat: (B*p1*p2, gn_sz, gn_sz, Zrna*G) dense per-patch gene grids
        t:       (B,) integer spaced timestep indices
        Returns the updated unpadded interior (B, H, W, C).
        """
        ps = self.conf.patch_size
        half = ps // 2
        _, hp, wp, _ = x_pad.shape
        p1, p2 = hp // ps, wp // ps

        x_patches = patchify(x_pad, ps)
        pred_col, _ = model(x_patches, self.schedule.model_t(t), rna_pat,
                            p1, p2)
        eps = self._assemble_eps(pred_col, p1, p2)
        sample, _ = self.schedule.ddim_step(
            x_patches, t.repeat_interleave(p1 * p2), eps)
        img = unpatchify(sample, p1, p2)
        return img[:, half:-half, half:-half, :]
