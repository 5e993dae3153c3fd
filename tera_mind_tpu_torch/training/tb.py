"""Metric writer (reference TensorBoardLogger usage, experiment.py:186-191,
360-370).

Port of ``tera_mind_tpu/training/tb.py``, host-side only: it always
appends to ``metrics.jsonl`` and also writes TensorBoard events when
``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package), so training never depends on it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricWriter:
    """Scalar/image writer: TensorBoard events + always a metrics.jsonl."""

    def __init__(self, logdir: str):
        self.dir = Path(logdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"[tb] tensorboard unavailable ({e}); jsonl only",
                  flush=True)
        else:
            self._tb = SummaryWriter(log_dir=str(self.dir))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"ts": time.time(), "step": step, tag: float(value)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: (H, W) or (H, W, C) uint8."""
        if self._tb is not None:
            if img.ndim == 2:
                img = img[..., None]
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
