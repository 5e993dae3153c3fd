"""Timestep samplers for training (reference diffusion/resample.py:8-63).

Port of ``tera_mind_tpu/diffusion/resample.py``.  The canonical config
uses the uniform sampler only (config.py:225-229); the importance-weighted
variant is kept for capability parity.  Draws come from a
``torch.Generator`` (the JAX versions take a PRNG key), so the same seed
gives other timesteps than the JAX package; the weights and the history
update are the same arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch


class UniformSampler:
    """t ~ U[0, T), weights 1 (reference resample.py:58-63)."""

    def __init__(self, num_timesteps: int):
        self.T = num_timesteps

    def sample(self, generator: torch.Generator, batch: int):
        dev = generator.device
        t = torch.randint(0, self.T, (batch,), generator=generator,
                          device=dev)
        return t, torch.ones(batch, dtype=torch.float32, device=dev)


class LossSecondMomentResampler:
    """Importance-sample timesteps by the history of per-t loss second
    moments (the ScheduleSampler family the reference's abstract base
    describes, resample.py:8-55).  Host-side state; call ``update`` with
    (t, loss) after each step."""

    def __init__(self, num_timesteps: int, history: int = 10,
                 uniform_prob: float = 0.001):
        self.T = num_timesteps
        self.history = history
        self.uniform_prob = uniform_prob
        self._losses = np.zeros((num_timesteps, history), np.float64)
        self._counts = np.zeros(num_timesteps, np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.T) / self.T
        w = np.sqrt((self._losses ** 2).mean(-1))
        w /= w.sum()
        w = w * (1 - self.uniform_prob) + self.uniform_prob / self.T
        return w

    def sample(self, generator: torch.Generator, batch: int):
        """(t, importance weights 1 / (T w[t])) on the generator's device;
        the choice runs on the host from a seed the generator draws."""
        w = self.weights()
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                 device=generator.device))
        t = np.random.default_rng(seed).choice(self.T, size=batch, p=w)
        weights = 1.0 / (self.T * w[t])
        return (torch.as_tensor(t, device=generator.device),
                torch.as_tensor(weights, dtype=torch.float32,
                                device=generator.device))

    def update(self, ts: np.ndarray, losses: np.ndarray) -> None:
        for t, l in zip(np.asarray(ts), np.asarray(losses)):
            i = int(self._counts[t]) % self.history
            self._losses[t, i] = float(l)
            self._counts[t] = min(self._counts[t] + 1, self.history)
