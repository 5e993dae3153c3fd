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
  are no-ops in one process, as in JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800   # a band's sweep of a brain takes minutes


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
              shape: Optional[Sequence[int]] = None, *, device="cpu",
              group=None) -> Mesh:
    """The mesh of the process group's ranks (``group``: the default
    group), row-major: rank ``sum(coord_i * stride_i)``.  ``shape``
    entries of -1 are inferred (at most one); without a shape, one axis
    over every rank.  Without a process group the mesh has one rank."""
    rank, n = world()
    if group is not None:
        rank, n = dist.get_rank(group), dist.get_world_size(group)
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
