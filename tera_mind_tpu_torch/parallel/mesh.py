"""Process groups and the rank mesh.

Port of ``tera_mind_tpu/parallel/mesh.py``.  JAX runs one controller per
host over a mesh of that host's devices; PyTorch runs one rank per
device, so the mesh here is a grid of ranks:

- :func:`multihost_init` starts ``torch.distributed`` from an explicit
  ``host:port``, world size and rank (the reference's ddp_setup,
  test_brn.py:26-35), and picks the backend by :func:`choose_backend`:
  NCCL where every rank of the host has a card of its own, gloo on the
  CPU or where ranks share a card (NCCL refuses two ranks on one card).
- :func:`make_mesh` lays the ranks out row-major over ``('gr', 'gc')``:
  rank r*C + c owns tile block (r, c) of the grid, each rank knows its
  neighbour on each side of each axis.
- :func:`is_primary`, :func:`host_barrier` and :func:`host_broadcast`
  are no-ops in one process, as in JAX;
- :func:`all_reduce_mean_` and :func:`broadcast_` are data-parallel
  training's collectives (the JAX trainer's compiled psum and its
  replicated state): tensors flattened into float32 buckets of
  ``BUCKET_BYTES``, each bucket one collective.  With gloo a bucket of
  CUDA tensors is staged through pinned host memory, as the halo
  exchange's strips are; NCCL takes it on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800   # a band's sweep of a brain takes minutes
BUCKET_BYTES = 32 * 2 ** 20   # float32 bytes a collective of the trainer


def choose_backend(device_type: str, ranks_on_host: int,
                   cards_on_host: int) -> str:
    """``'nccl'`` when the ranks run on CUDA and each rank of the host has
    a card of its own, else ``'gloo'`` (the CPU, or ranks sharing a card,
    whose strips then go through host memory)."""
    if device_type == "cuda" and 0 < ranks_on_host <= cards_on_host:
        return "nccl"
    return "gloo"


def rank_device(device, process_id: int) -> torch.device:
    """The rank's device: ``cuda`` becomes ``cuda:{rank % cards}``, a CPU
    device stays as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass "
                           "--device cpu")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device="cuda",
                   backend: Optional[str] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group at ``tcp://{coordinator}`` as rank
    ``process_id`` of ``num_processes`` and return this rank's device.
    A no-op returning ``device`` when ``coordinator`` is None.

    ``backend`` overrides :func:`choose_backend` (which assumes all ranks
    on one host).  A failed init raises with the backend's message; it is
    not retried on another backend.  Every collective and point-to-point
    wait of the group fails after ``timeout_s`` seconds."""
    if coordinator is None:
        return torch.device(device)
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num_processes and "
                         "--process_id")
    dev = rank_device(device, process_id)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend or choose_backend(dev.type, num_processes, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    devices = [None] * num_processes
    dist.all_gather_object(devices, str(dev))
    if process_id == 0:
        print(f"[mesh] {num_processes} ranks, backend {backend}, devices "
              f"{devices} ({cards} cards on this host)", flush=True)
    return dev


def free_port() -> int:
    """A TCP port of localhost that is free now, for a coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks.  ``coords`` are this rank's index along each axis;
    ``neighbors[axis]`` the (previous, next) rank along it, None at the
    mesh edge.  ``group`` is None for a one-rank mesh."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...]
    neighbors: Tuple[Tuple[Optional[int], Optional[int]], ...]
    device: torch.device
    group: Optional[object] = None

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(axis_names: Sequence[str] = ("gr", "gc"),
              shape: Optional[Sequence[int]] = None, *, device=None,
              group=None) -> Mesh:
    """The mesh of the process group's ranks (``group``: the default
    group), row-major: rank ``sum(coord_i * stride_i)``.  ``shape``
    entries of -1 are inferred (at most one); without a shape, one axis
    over every rank.  Without a process group the mesh has one rank.
    ``device``: this rank's card (``rank_device('cuda', rank)``) unless
    given; the CPU only when asked for."""
    rank, n = world()
    if group is not None:
        rank, n = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        device = (rank_device("cuda", rank) if torch.cuda.is_available()
                  else torch.device("cuda"))
    names = tuple(axis_names)
    if shape is None:
        if len(names) != 1:
            raise ValueError("shape required for a multi-axis mesh")
        shape = (-1,)
    shape = list(shape)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} for axes {names}")
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {shape}: at most one -1")
    if -1 in shape:
        known = 1
        for s in shape:
            known *= s if s != -1 else 1
        shape[shape.index(-1)] = n // known
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh shape {tuple(shape)} holds {size} ranks, "
                         f"the process group {n}")
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    coords = tuple((rank // st) % s for st, s in zip(strides, shape))
    neighbors = tuple(
        (rank - st if c > 0 else None, rank + st if c < s - 1 else None)
        for c, st, s in zip(coords, strides, shape))
    if n > 1 and group is None:
        group = dist.group.WORLD
    return Mesh(tuple(shape), names, coords, neighbors,
                torch.device(device), group if n > 1 else None)


def is_primary() -> bool:
    """Rank 0 gate for host-side IO (reference gpu_id == 0 checks)."""
    return world()[0] == 0


def _device_ids() -> Optional[list]:
    if dist.get_backend() == "nccl":
        return [torch.cuda.current_device()]
    return None


def host_barrier(name: str = "barrier") -> None:
    """Every rank waits here (torch.distributed.barrier; reference
    utils/dist_utils.py:5-15).  ``name`` labels the wait in errors.  A
    no-op in one process."""
    if world()[1] == 1:
        return
    try:
        dist.barrier(device_ids=_device_ids())
    except RuntimeError as e:
        raise RuntimeError(f"host_barrier {name!r}: {e}") from e


def host_broadcast(value, root: int = 0):
    """``value`` of rank ``root`` on every rank (broadcast_object_list;
    reference utils/dist_utils.py:18-24).  The value itself in one
    process."""
    if world()[1] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def shutdown(barrier: bool = True) -> None:
    """Leave the process group, after a barrier (so that no rank tears it
    down while a neighbour still waits on it) unless this rank is failing;
    a no-op without one."""
    if dist.is_available() and dist.is_initialized():
        if barrier:
            host_barrier("shutdown")
        dist.destroy_process_group()


# ------------------------------------------------------------------ #
# data-parallel training's collectives                                 #
# ------------------------------------------------------------------ #
ROUTES = ("nccl", "gloo", "gloo_staged")
# the all-reduces (not the broadcasts): calls, buckets, bytes reduced
# (float32), seconds (the device synchronised before and after)
reduce_stats = {"calls": 0, "buckets": 0, "bytes": 0, "seconds": 0.0,
                "by_route": dict.fromkeys(ROUTES, 0)}


def reset_reduce_stats() -> None:
    reduce_stats.update(calls=0, buckets=0, bytes=0, seconds=0.0,
                        by_route=dict.fromkeys(ROUTES, 0))


def route(backend: str, is_cuda: bool) -> str:
    """How ``backend`` moves a tensor (``ROUTES``): NCCL on the card (CUDA
    tensors only), gloo a CPU tensor as it is and a CUDA tensor through
    pinned host memory (gloo's ops read and write host memory)."""
    if backend == "nccl":
        if not is_cuda:
            raise ValueError("NCCL moves CUDA tensors only")
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"no route over backend {backend!r}")
    return "gloo_staged" if is_cuda else "gloo"


def buckets(tensors: Sequence[torch.Tensor],
            bucket_bytes: int = BUCKET_BYTES) -> List[List[int]]:
    """The indices of ``tensors`` in collective order, cut into runs of
    at most ``bucket_bytes`` float32 bytes (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        n = 4 * t.numel()
        if cur and size + n > bucket_bytes:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        out.append(cur)
    return out


def _collective(tensors: Sequence[torch.Tensor], group, op, *,
                mean: bool, bucket_bytes: int) -> None:
    """Run ``op(flat float32 bucket)`` over ``tensors``' buckets and copy
    each result back (divided by the group's size where ``mean``, and
    counted in ``reduce_stats``)."""
    if not tensors:
        return
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    device = tensors[0].device
    how = route(dist.get_backend(group), device.type == "cuda")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    nbytes = 0
    runs = buckets(tensors, bucket_bytes)
    for run in runs:
        flat = torch.cat([tensors[i].detach().reshape(-1).float()
                          for i in run])
        if how == "gloo_staged":
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            host.copy_(flat)            # a synchronous device -> host copy
            op(host, group)
            flat.copy_(host)
        else:
            op(flat, group)
        if mean:
            flat.div_(n)
        nbytes += flat.numel() * 4
        o = 0
        for i in run:
            t = tensors[i]
            t.copy_(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if not mean:
        return
    reduce_stats["calls"] += 1
    reduce_stats["buckets"] += len(runs)
    reduce_stats["bytes"] += nbytes
    reduce_stats["seconds"] += time.perf_counter() - t0
    reduce_stats["by_route"][how] += 1


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None, *,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the group's ranks, in place:
    summed in float32 buckets, then divided by the group's size.  Every
    rank gets the same bits.  Every rank of the group must call it with
    tensors of the same shapes, in the same order."""
    _collective(tensors, group,
                lambda t, g: dist.all_reduce(t, dist.ReduceOp.SUM, group=g),
                mean=True, bucket_bytes=bucket_bytes)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], group=None, src: int = 0, *,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Give each tensor, in place, rank ``src``'s values (float32 tensors
    keep their bits).  Every rank of the group must call it alike."""
    _collective(tensors, group,
                lambda t, g: dist.broadcast(t, src, group=g),
                mean=False, bucket_bytes=bucket_bytes)


def host_all_gather(value) -> list:
    """Every rank's ``value`` (all_gather_object), in rank order; a
    one-item list in one process."""
    if world()[1] == 1:
        return [value]
    out = [None] * world()[1]
    dist.all_gather_object(out, value)
    return out
