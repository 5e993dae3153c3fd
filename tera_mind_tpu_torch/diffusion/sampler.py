"""Patch-wise diffusion sampler: the training loss, the single-step
denoise that the tera-scale generator runs, and the full sampling loop.

Port of ``tera_mind_tpu/diffusion/sampler.py`` (``SamplerConfig``,
``_assemble_eps``, ``denoise_step``, ``sample``, ``training_loss``), with
deterministic DDIM (eta 0) for sampling; the JAX config's DDPM and
eta > 0 options are not ported.

Parity reference (CTPLab/Tera-MIND):
- training loss w/ random 2x2 patch-block crop + dual-decoder loss:
  diffusion/base.py:181-289
- collage round-trip of the model eps: diffusion/base.py:386-393
- full sampling loop (pad 0 -> patchify -> step -> crop): base.py:597-631
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.collage import patchify, unpatchify
from .schedule import Schedule

# model(x_patches, t_model, rna_patches, p1, p2) -> (pred_collage, pred_orig)
ModelFn = Callable[..., tuple]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Geometry of the sampler and the training loss's type; sampling is
    deterministic DDIM (eta 0)."""

    patch_size: int = 64
    gn_sz: int = 4            # gene bins per patch side
    loss_type: str = "mse"    # 'mse' | 'l1'


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

    def sample(self, model: ModelFn, noise: torch.Tensor,
               rna_pat: torch.Tensor, *,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Generate from pure noise with deterministic DDIM.

        noise:   (B, H, W, C) initial x_T for the unpadded region
        rna_pat: per-patch gene grids covering the PADDED (H+ps, W+ps) grid
        mask:    optional (B, H, W, 1|C) 0/1 gene-coverage mask; after every
                 reverse step masked-out pixels are pinned to -1 (background),
                 the reference's ``rna_msk`` path (base.py:592, 629-630)
        Returns (B, H, W, C).
        """
        half = self.conf.patch_size // 2
        img = noise
        for step in range(self.schedule.num_timesteps - 1, -1, -1):
            t = torch.full((noise.shape[0],), step, dtype=torch.long,
                           device=noise.device)
            x_pad = F.pad(img, (0, 0, half, half, half, half))
            img = self.denoise_step(model, x_pad, rna_pat, t)
            if mask is not None:
                img = img * mask + mask - 1.0
        return img

    def training_loss(self, model: ModelFn, x_start_pad: torch.Tensor,
                      rna_pad: torch.Tensor, t: torch.Tensor, *,
                      noise: torch.Tensor,
                      block_idx: tuple[int, int]) -> torch.Tensor:
        """Dual-decoder patch loss on a 2x2 patch block (reference
        base.py:181-289), a float32 scalar.

        x_start_pad: (B, H+ps, W+ps, C) zero-padded training image
        rna_pad:     (B, gh+gn, gw+gn, Zrna*G) zero-padded dense gene grid
        t:           (B,) integer timesteps on the TRAIN schedule
        noise:       Gaussian noise of x_start_pad's shape
        block_idx:   the batch's shared 2x2-block origin (ix, iy), in
                     patches: 0 <= ix < (H+ps)/ps - 1, likewise iy
        The caller draws noise, t and the origin (the JAX function draws
        them from its rng unless given; the trainer draws them from its
        generators, and the parity tests inject the JAX draws).
        """
        ps = self.conf.patch_size
        gn = self.conf.gn_sz
        half = ps // 2
        _, hp, wp, _ = x_start_pad.shape
        ix, iy = (int(v) for v in block_idx)
        if not (0 <= ix < hp // ps - 1 and 0 <= iy < wp // ps - 1):
            raise ValueError(f"block_idx {block_idx} outside the "
                             f"{hp // ps - 1}x{wp // ps - 1} block origins")
        x_t = self.schedule.q_sample(x_start_pad, t, noise)

        # interior mask: 1 inside the original image, 0 on the pad border
        # (reference experiment.py:167-168, base.py:217-218)
        mask = torch.zeros(hp, wp, dtype=x_start_pad.dtype,
                           device=x_start_pad.device)
        mask[half:-half, half:-half] = 1.0
        mask = mask[None, :, :, None]
        x_t = x_t * mask

        def crop(img, scale):
            return img[:, ix * scale:(ix + 2) * scale,
                       iy * scale:(iy + 2) * scale]

        x_p = patchify(crop(x_t, ps), ps)
        n_p = patchify(crop(noise, ps), ps)
        m_p = patchify(crop(mask.expand(x_start_pad.shape), ps), ps)
        r_p = patchify(crop(rna_pad, gn), gn)

        pred_col, pred_orig = model(x_p, self.schedule.model_t(t), r_p, 2, 2)

        # collage target: interior of the 2x2 noise block (base.py:273-278)
        n_shift = unpatchify(n_p, 2, 2)[:, half:-half, half:-half, :]
        if self.conf.loss_type == "mse":
            loss = torch.mean((n_shift - pred_col) ** 2)
            loss = loss + torch.mean((n_p - pred_orig) ** 2 * m_p)
        elif self.conf.loss_type == "l1":
            loss = torch.mean(torch.abs(n_shift - pred_col))
            loss = loss + torch.mean(torch.abs(n_p - pred_orig) * m_p)
        else:
            raise ValueError(f"loss_type {self.conf.loss_type!r}")
        return loss
