"""Halo padding of the spatial state: one device, or exchanged over ranks.

Port of ``tera_mind_tpu/parallel/halo.py``.  ``pad_halo_single`` pads the
whole grid with ``fill`` (-1, the reference's empty background).
``exchange_halo_2d`` pads one rank's block of a grid split over a
:class:`~.mesh.Mesh` of ranks with its neighbours' edge strips, in two
phases as in JAX: columns first, then rows of the widened block, so the
corners come along.  Each phase is one ``batch_isend_irecv`` with the two
neighbours on that axis, waited on in full; a mesh edge, and both sides
of an axis of one rank, get ``fill``.

Transport: NCCL moves CUDA strips as they are.  Gloo's point-to-point ops
read and write host memory, so with gloo a CUDA strip is copied into a
pinned host buffer before its send, and a received strip from a pinned
buffer to the device after the wait; no device pointer reaches gloo.
Over gloo bfloat16 strips travel as their 16 bits (``int16``, which NCCL
has no type for).

``stats`` counts the calls, the bytes this rank sends and the seconds
spent in the exchange (device synchronised before and after), by route:
``nccl``, ``gloo`` (CPU strips), ``gloo_staged`` (CUDA strips through
host memory).
"""

from __future__ import annotations

import threading
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import ROUTES, route

stats = {"calls": 0, "bytes": 0, "seconds": 0.0,
         "by_route": dict.fromkeys(ROUTES, 0)}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        stats.update(calls=0, bytes=0, seconds=0.0,
                     by_route=dict.fromkeys(ROUTES, 0))


def pad_halo_single(block: torch.Tensor, pad: int,
                    fill: float = -1.0) -> torch.Tensor:
    """(H, W, C) -> (H+2p, W+2p, C), constant ``fill`` border."""
    return F.pad(block, (0, 0, pad, pad, pad, pad), value=fill)


def wire(t: torch.Tensor, backend: str) -> torch.Tensor:
    """What a point-to-point op of ``backend`` moves for ``t``: gloo
    moves a bfloat16 tensor's bits as int16."""
    if backend == "gloo" and t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _swap(send_prev: torch.Tensor, send_next: torch.Tensor,
          neighbors, mesh, how: str, fill: float):
    """(strip from the previous rank, strip from the next rank) along one
    axis: ``send_prev`` goes to the previous rank, ``send_next`` to the
    next; a missing neighbour's strip is ``fill``."""
    prev, nxt = neighbors
    staged = how == "gloo_staged"
    recv = {}
    ops = []
    for peer, out in ((nxt, send_next), (prev, send_prev)):
        if peer is None:
            continue
        out = out.contiguous()
        if staged:
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out)          # a synchronous device -> host copy
            out = host
        else:
            buf = torch.empty_like(out)
        backend = "nccl" if how == "nccl" else "gloo"
        ops.append(dist.P2POp(dist.isend, wire(out, backend), peer,
                              mesh.group))
        ops.append(dist.P2POp(dist.irecv, wire(buf, backend), peer,
                              mesh.group))
        recv[peer] = buf
    sent = sum(op.tensor.numel() * op.tensor.element_size()
               for op in ops if op.op is dist.isend)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def got(peer, like):
        if peer is None:
            return torch.full_like(like, fill)
        buf = recv[peer]
        return buf.to(like.device) if staged else buf
    return got(prev, send_next), got(nxt, send_prev), sent


def exchange_halo_2d(block: torch.Tensor, pad: int, mesh, *,
                     fill: float = -1.0, row_axis: str = "gr",
                     col_axis: str = "gc") -> torch.Tensor:
    """(H, W, C) local block -> (H+2p, W+2p, C) with the neighbours'
    strips, ``fill`` past the mesh edge.  Every rank of the mesh must call
    it, in the same order as the others."""
    if mesh is None or mesh.size == 1:
        return pad_halo_single(block, pad, fill)
    how = route(mesh.backend, block.is_cuda)
    if block.is_cuda:
        torch.cuda.synchronize(block.device)
    t0 = time.perf_counter()
    cols = mesh.neighbors[mesh.axis(col_axis)]
    rows = mesh.neighbors[mesh.axis(row_axis)]
    # phase 1: columns; my last columns go right, my first go left
    left, right, n1 = _swap(block[:, :pad], block[:, -pad:], cols, mesh,
                            how, fill)
    wide = torch.cat([left, block, right], dim=1)
    # phase 2: rows of the widened block, corners included
    up, down, n2 = _swap(wide[:pad], wide[-pad:], rows, mesh, how, fill)
    out = torch.cat([up, wide, down], dim=0)
    if block.is_cuda:
        torch.cuda.synchronize(block.device)
    with _stats_lock:
        stats["calls"] += 1
        stats["bytes"] += n1 + n2
        stats["seconds"] += time.perf_counter() - t0
        stats["by_route"][how] += 1
    return out


def exchange_bytes(block_shape, pad: int, itemsize: int, coords, shape
                   ) -> int:
    """The bytes :func:`exchange_halo_2d` sends from the rank at
    ``coords`` of a mesh of ``shape`` for an (H, W, C) block."""
    h, w, c = block_shape
    (r, cc), (nr, nc) = coords, shape
    n_cols = (cc > 0) + (cc < nc - 1)
    n_rows = (r > 0) + (r < nr - 1)
    return itemsize * c * pad * (n_cols * h + n_rows * (w + 2 * pad))
