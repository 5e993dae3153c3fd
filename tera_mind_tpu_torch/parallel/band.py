"""Band-parallel streaming: each rank streams a row band of the grid.

Port of ``tera_mind_tpu/parallel/band.py``.  The host-streaming generator
(``parallel/streaming.py``) keeps the whole-grid state in one host's
memory; over several ranks the grid is cut into horizontal row bands
(:func:`band_partition`), one a rank, and after every window visit each
band's top and bottom ``pad``-px edge rows must reach the neighbouring
bands (the reference's cross-worker filesystem halo,
MBADataset_tst.py:91-123).  :class:`StripExchange` does that over the
default process group with one ``batch_isend_irecv`` (gloo moves host
memory, NCCL the strips staged on the rank's card).

Strip volume per step per band: 2 * pad * width * channels values, in
the caller's dtype (a bfloat16 host state moves half the bytes).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .halo import wire
from .mesh import world

stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        stats.update(calls=0, bytes=0, seconds=0.0)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


class StripExchange:
    """Exchanges band edge strips between neighbouring ranks.

    ``__call__(top_edge, bot_edge) -> (ghost_top, ghost_bot)``: ghost_top
    is the upper neighbour's bottom ``pad`` rows (None for the first
    band), ghost_bot the lower neighbour's top rows (None for the last
    band); ``(None, None)`` in one process.  Edges are (pad, W, C) numpy
    arrays or CPU tensors; the ghosts come back as numpy arrays (a
    bfloat16 strip as a CPU tensor, numpy having no bfloat16).  Strips
    move in ``dtype`` (float32, bfloat16 or float16)."""

    def __init__(self, pad: int, width: int, channels: int,
                 dtype=np.float32, *, device=None):
        """``device``: where NCCL stages the strips (the rank's card); a
        gloo group moves host memory and ignores it."""
        self.rank, self.nproc = world()
        self.shape = (pad, width, channels)
        self.dtype = _torch_dtype(dtype)
        self.group = dist.group.WORLD if self.nproc > 1 else None
        self.nccl = (self.group is not None
                     and dist.get_backend(self.group) == "nccl")
        if not self.nccl:
            device = "cpu"      # gloo reads and writes host memory only
        elif device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        if self.nccl and self.device.type != "cuda":
            raise ValueError("an NCCL group exchanges CUDA strips")

    def _out(self, edge) -> torch.Tensor:
        t = torch.as_tensor(edge)
        if tuple(t.shape) != self.shape:
            raise ValueError(f"edge strip {tuple(t.shape)}, expected "
                             f"{self.shape}")
        return t.to(self.device, self.dtype).contiguous()

    def __call__(self, top_edge, bot_edge
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        if self.nproc == 1:
            return None, None
        t0 = time.perf_counter()
        up = self.rank - 1 if self.rank > 0 else None
        down = self.rank + 1 if self.rank < self.nproc - 1 else None
        ops, got = [], {}
        for peer, edge in ((up, top_edge), (down, bot_edge)):
            if peer is None:
                continue
            out = self._out(edge)
            buf = torch.empty_like(out)
            backend = "nccl" if self.nccl else "gloo"
            ops += [dist.P2POp(dist.isend, wire(out, backend), peer,
                               self.group),
                    dist.P2POp(dist.irecv, wire(buf, backend), peer,
                               self.group)]
            got[peer] = buf
        for work in dist.batch_isend_irecv(ops):
            work.wait()

        def host(peer):
            if peer is None:
                return None
            t = got[peer].cpu()
            return t if t.dtype == torch.bfloat16 else t.numpy()
        n = len(ops) // 2 * int(np.prod(self.shape)) * self.dtype.itemsize
        with _stats_lock:
            stats["calls"] += 1
            stats["bytes"] += n
            stats["seconds"] += time.perf_counter() - t0
        return host(up), host(down)


def band_partition(total_rows: int, nproc: int, rank: int
                   ) -> Tuple[int, int]:
    """(first_row, n_rows) of this rank's band (balanced, remainder to the
    leading bands; every process must get >= 1 row)."""
    if total_rows < nproc:
        raise ValueError(f"{total_rows} tile rows for {nproc} bands")
    base, rem = divmod(total_rows, nproc)
    r0 = rank * base + min(rank, rem)
    return r0, base + (1 if rank < rem else 0)
