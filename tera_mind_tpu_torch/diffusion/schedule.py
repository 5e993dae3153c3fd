"""Gaussian-diffusion schedule math.

Port of ``tera_mind_tpu/diffusion/schedule.py``.  The constants are derived
in float64 with numpy and stored as float32 tensors (on the CPU; ``to``
moves them); the step math runs in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


def named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    """Named beta schedules (linear / cosine / const*), float64."""
    scale = 1000.0 / num_timesteps
    if name == "linear":
        return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps,
                           dtype=np.float64)
    if name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = []
        for i in range(num_timesteps):
            t1 = i / num_timesteps
            t2 = (i + 1) / num_timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.array(betas, dtype=np.float64)
    if name.startswith("const"):
        value = float(name[len("const"):])
        return np.full(num_timesteps, scale * value, dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """Sorted subset of timesteps of the original process: ``'ddimN'`` /
    ``'fdpmN'`` takes the integer stride giving exactly N steps, otherwise
    per-section step counts over equal partitions."""
    if isinstance(section_counts, str):
        if section_counts.startswith(("ddim", "fdpm")):
            desired = int(section_counts[4:])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return list(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return sorted(set(all_steps))


_F32_FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
               "alphas_cumprod_next", "sqrt_alphas_cumprod",
               "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
               "sqrt_recipm1_alphas_cumprod", "posterior_variance",
               "posterior_log_variance_clipped", "posterior_mean_coef1",
               "posterior_mean_coef2", "fixed_large_variance",
               "fixed_large_log_variance")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion constants (float32 tensors, f64-derived).

    ``timestep_map`` maps spaced t indices back to original-T indices for
    the model's time embedding (identity when not respaced)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_timesteps: int

    @classmethod
    def create(cls, betas: np.ndarray,
               timestep_map: Sequence[int] | None = None,
               original_num_timesteps: int | None = None) -> "Schedule":
        betas = np.asarray(betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        T = len(betas)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar = np.log(np.append(post_var[1], post_var[1:]))
        fl_var = np.append(post_var[1], betas[1:])
        if timestep_map is None:
            timestep_map = np.arange(T)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32))

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_next=f32(acp_next),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(post_logvar),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas)
                                     / (1.0 - acp)),
            fixed_large_variance=f32(fl_var),
            fixed_large_log_variance=f32(np.log(fl_var)),
            timestep_map=torch.as_tensor(np.asarray(timestep_map, np.int64)),
            num_timesteps=T,
            original_num_timesteps=original_num_timesteps or T,
        )

    def to(self, device) -> "Schedule":
        """The same schedule with every tensor on ``device``."""
        moved = {f: getattr(self, f).to(device)
                 for f in _F32_FIELDS + ("timestep_map",)}
        return dataclasses.replace(self, **moved)

    # ---- step math (integer timestep tensors `t`, shape (B,)) ----------

    def _at(self, arr: torch.Tensor, t: torch.Tensor,
            ndim: int) -> torch.Tensor:
        """Gather per-timestep constants, broadcast to an ndim-rank tensor."""
        out = arr[t]
        return out.reshape(out.shape + (1,) * (ndim - out.ndim))

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Map a spaced t to the original-T value the model embeds."""
        return self.timestep_map[t]

    def q_sample(self, x0, t, noise):
        """Sample q(x_t | x_0) (reference base.py:141-158)."""
        return (self._at(self.sqrt_alphas_cumprod, t, x0.ndim) * x0
                + self._at(self.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
                * noise)

    def predict_xstart_from_eps(self, x_t, t, eps):
        return (self._at(self.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - self._at(self.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)
                * eps)

    def predict_eps_from_xstart(self, x_t, t, x0):
        return ((self._at(self.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                 - x0)
                / self._at(self.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def ddim_step(self, x_t, t, eps):
        """One deterministic (eta 0) DDIM update x_t -> x_{t-1} given
        model eps.  Clips pred_xstart to [-1, 1] and re-derives eps from
        it first.  Returns (sample, pred_xstart)."""
        x0 = torch.clamp(self.predict_xstart_from_eps(x_t, t, eps), -1.0, 1.0)
        eps = self.predict_eps_from_xstart(x_t, t, x0)
        abar_prev = self._at(self.alphas_cumprod_prev, t, x_t.ndim)
        return x0 * torch.sqrt(abar_prev) + torch.sqrt(1 - abar_prev) * eps, x0


def spaced_schedule(beta_name: str, num_train_timesteps: int,
                    section_counts) -> Schedule:
    """Respaced schedule (e.g. ``'ddim15'`` from T=1000): new betas keep
    the cumulative alphas of the kept subset of the original chain."""
    base_betas = named_beta_schedule(beta_name, num_train_timesteps)
    acp = np.cumprod(1.0 - base_betas)
    keep = space_timesteps(num_train_timesteps, section_counts)
    last = 1.0
    new_betas, tmap = [], []
    for i in keep:
        new_betas.append(1 - acp[i] / last)
        last = acp[i]
        tmap.append(i)
    return Schedule.create(np.array(new_betas), timestep_map=tmap,
                           original_num_timesteps=num_train_timesteps)


def train_schedule(beta_name: str, num_timesteps: int) -> Schedule:
    """Full (un-respaced) training schedule."""
    return Schedule.create(named_beta_schedule(beta_name, num_timesteps))
