"""Observability: profiler traces, named spans, throughput counters and a
FLOP count.

Port of ``tera_mind_tpu/utils.py`` on ``torch.profiler``: ``trace``
writes a Chrome trace (``chrome://tracing``, Perfetto) where JAX writes an
XProf one, ``annotate`` is a ``record_function`` span, and ``model_flops``
counts with ``torch.utils.flop_counter.FlopCounterMode`` where JAX asks
XLA's cost analysis (``None`` when the count fails, as JAX's).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    its Chrome trace to ``{log_dir}/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """A named span of host-side work in the trace."""
    return torch.profiler.record_function(name)


class Throughput:
    """Items/s meter (tiles, patches, samples) since :meth:`start` (or the
    first :meth:`add`)."""

    def __init__(self, unit: str = "tiles"):
        self.unit = unit
        self.t0: Optional[float] = None
        self.count = 0.0

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.count = 0.0

    def add(self, n: float) -> None:
        if self.t0 is None:
            self.start()
        self.count += n

    @property
    def per_sec(self) -> float:
        if self.t0 is None or self.count == 0:
            return 0.0
        return self.count / (time.perf_counter() - self.t0)

    def report(self) -> str:
        return f"{self.per_sec:.4f} {self.unit}/s"


def model_flops(fn, *args) -> Optional[float]:
    """The floating-point operations of one ``fn(*args)`` call, as
    PyTorch's FLOP counter counts them (2 m n k a matmul); ``None`` when
    the call or the count fails."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None
