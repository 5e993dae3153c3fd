"""Host-streaming whole-brain generation: state larger than the device.

Port of ``tera_mind_tpu/parallel/streaming.py``.  The
in-memory :class:`~.generator.TeraGenerator` keeps the whole tile-grid
state on the card, which holds a few thousand tiles; a brain is 286 x 414.
Here the state stays on the host and windows of tiles stream through the
card:

- Double-buffered host state (read = timestep t, write = t+1): CPU
  tensors (pinned when the card is used) or disk-backed ``.npy`` memmaps,
  so halos always read the previous timestep whatever the sweep order.
- Per timestep the grid is swept in fixed (block_rows x block_cols)-tile
  windows: the host assembles each window plus its halo from the read
  buffer (grid border -1), the card denoises it one step, and the result
  lands in the write buffer.  Edge windows are shifted inward so every
  window has one shape; where they overlap a neighbour, the later window
  of the sweep writes the overlap, so windows write disjoint tiles.
- Gene data comes through a per-tile provider behind an LRU cache, and
  up to ``gene_device_cache_gb`` of window gene blocks stay on the card
  across sweeps.
- ``steps_per_window`` K > 1 advances K steps per visit on an enlarged
  halo (exact; see ``_multistep_window``).
- ``inflight`` worker threads keep windows in flight, each window on a
  CUDA stream of its own (from a pool kept for the process) with the
  worker's pinned staging buffers, so one window's assembly and
  transfers overlap another's compute.
- Resume and spills through :class:`StateCheckpoint`.
- ``devices``: one replica of the model on each device; the windows of a
  sweep go round-robin over them, each device with its own streams and
  gene cache (the several-cards-per-host mode).
- Band-parallel runs over ranks (``parallel/band.py``): ``rows`` is the
  rank's band, ``strip_exchange`` trades the band's edge rows with the
  neighbouring bands after every visit, and they feed the halos of the
  windows at the band's edge.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..data.noise import tile_init_noise
from ..data.tilestore import StateCheckpoint
from .generator import TeraGenerator, replicate

GeneProvider = Callable[[int, int], np.ndarray]  # (row, col) -> per-tile gene

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# numpy types of the memmap files: bfloat16 is stored as its 16 bits
_STORAGE = {torch.float32: np.float32, torch.bfloat16: np.uint16}


_streams: dict = {}   # device -> idle CUDA streams of the window workers
_streams_lock = threading.Lock()


@contextlib.contextmanager
def _side_stream(device: torch.device):
    """Run the body on a CUDA stream of a pool kept for the process (a
    no-op off the card); the body synchronises it before it leaves.
    Streams are reused across runs because PyTorch keeps a cuBLAS
    workspace for every stream that ever ran a matmul."""
    if device.type != "cuda":
        yield None
        return
    with _streams_lock:
        free = _streams.setdefault(device, [])
        stream = free.pop() if free else torch.cuda.Stream(device)
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        with _streams_lock:
            free.append(stream)


def _as_provider(gene: Union[np.ndarray, GeneProvider]) -> GeneProvider:
    if callable(gene):
        return gene
    return lambda r, c: gene[r, c]


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else DTYPES[str(dtype)]


class HostState:
    """Double-buffered (read/write) whole-grid state on the host.

    Each buffer is a (rows*tile, cols*tile, channels) CPU tensor of
    ``dtype`` (float32 or bfloat16), pinned with ``pin``.  With
    ``memmap_dir`` the buffers are ``state_{0,1}.npy`` memmaps (bfloat16
    as uint16 bits) with a ``state_dtype.txt`` sidecar naming the dtype.
    """

    def __init__(self, rows: int, cols: int, tile: int, channels: int,
                 memmap_dir: Optional[str] = None, dtype=torch.float32,
                 pin: bool = False):
        self.rows, self.cols, self.tile, self.channels = \
            rows, cols, tile, channels
        self.dtype = _dtype(dtype)
        shape = (rows * tile, cols * tile, channels)
        if memmap_dir is None:
            self.bufs = [torch.zeros(shape, dtype=self.dtype, pin_memory=pin)
                         for _ in range(2)]
        else:
            d = Path(memmap_dir)
            d.mkdir(parents=True, exist_ok=True)
            self.bufs = [
                torch.from_numpy(np.lib.format.open_memmap(
                    d / f"state_{i}.npy", mode="w+",
                    dtype=_STORAGE[self.dtype], shape=shape)).view(self.dtype)
                for i in range(2)]
            (d / "state_dtype.txt").write_text(
                f"{str(self.dtype).split('.')[-1]}\n{shape}\n")
        self.read_idx = 0

    @property
    def read(self) -> torch.Tensor:
        return self.bufs[self.read_idx]

    @property
    def write(self) -> torch.Tensor:
        return self.bufs[1 - self.read_idx]

    def swap(self) -> None:
        self.read_idx = 1 - self.read_idx

    def padded_window(self, r0: int, c0: int, br: int, bc: int, pad: int,
                      fill: float = -1.0,
                      ghost_top: Optional[torch.Tensor] = None,
                      ghost_bot: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Window of (br x bc) tiles at tile-origin (r0, c0) with a
        ``pad``-px halo from the read buffer; outside the grid ``fill``,
        unless a ghost strip (a neighbour band's previous-timestep edge
        rows, (>= pad, W, C)) covers it.

        ``out``: a reusable staging buffer of the window's shape (any
        float dtype: the copy casts).  Only the strips outside the grid
        are filled, so an interior window skips the fill."""
        t = self.tile
        h0, w0 = r0 * t - pad, c0 * t - pad
        h1, w1 = (r0 + br) * t + pad, (c0 + bc) * t + pad
        shape = (h1 - h0, w1 - w0, self.channels)
        sh0, sw0 = max(h0, 0), max(w0, 0)
        sh1 = min(h1, self.rows * t)
        sw1 = min(w1, self.cols * t)
        if out is None:
            out = torch.full(shape, fill, dtype=self.dtype)
        else:
            if tuple(out.shape) != shape:
                raise ValueError(f"staging buffer {tuple(out.shape)}, "
                                 f"window {shape}")
            if sh0 - h0:
                out[:sh0 - h0] = fill
            if h1 - sh1:
                out[-(h1 - sh1):] = fill
            if sw0 - w0:
                out[:, :sw0 - w0] = fill
            if w1 - sw1:
                out[:, -(w1 - sw1):] = fill
        out[sh0 - h0:sh1 - h0, sw0 - w0:sw1 - w0] = \
            self.read[sh0:sh1, sw0:sw1]
        if ghost_top is not None and h0 < 0:
            out[:-h0, sw0 - w0:sw1 - w0] = torch.as_tensor(
                ghost_top)[ghost_top.shape[0] + h0:, sw0:sw1]
        if ghost_bot is not None and h1 > self.rows * t:
            over = h1 - self.rows * t
            out[-over:, sw0 - w0:sw1 - w0] = torch.as_tensor(
                ghost_bot)[:over, sw0:sw1]
        return out


@dataclasses.dataclass
class StreamConfig:
    block_rows: int = 2     # tiles per device window (rows)
    block_cols: int = 2     # tiles per device window (cols)
    checkpoint_every: int = 0
    memmap_dir: Optional[str] = None
    progress: bool = True
    block_major: bool = False  # one patch grid per window
                               # (TeraGenerator._window_update): the same
                               # result, fewer patches, bigger batches
    gene_cache_windows: int = 8  # LRU bound on cached per-window gene
                                 # blocks on the host; 0 = unbounded
                                 # (small grids only: a brain's gene stack
                                 # is about 1.2 TB)
    transfer_dtype: str = "float32"  # host<->device state dtype;
                                 # "bfloat16" halves the state's round
                                 # trip (the reference round-trips float16
                                 # through disk every step)
    pipeline: bool = True        # `inflight` worker threads, each with its
                                 # own stream: one window's assembly and
                                 # transfers overlap another's compute;
                                 # windows write disjoint regions and read
                                 # the immutable read buffer, so results
                                 # are identical
    inflight: int = 3            # windows in flight when pipeline=True;
                                 # each worker holds one pinned staging
                                 # window in and one out
    gene_device_cache_gb: float = 4.0
                                 # device budget (GB) for keeping window
                                 # gene blocks on the card across sweeps:
                                 # pin-first (an LRU would thrash under
                                 # the cyclic sweep); 0 disables
    state_dtype: Optional[str] = None
                                 # dtype of the host state buffers; None =
                                 # transfer_dtype (bit-identical: an f32
                                 # buffer is cast to bf16 at every upload
                                 # anyway); "float32" keeps an f32 master
                                 # copy under bf16 transfers
    steps_per_window: int = 1    # temporal halo blocking: K DDIM steps per
                                 # window visit on a halo of
                                 # pad + patch*(K-1) px, cropped by
                                 # `patch` px per side per inner step;
                                 # exact (needs field-consistent gene
                                 # halos), cuts the state traffic K-fold


class StreamingGenerator:
    """Whole-brain reverse diffusion with host-resident state.

    Wraps a :class:`TeraGenerator` (its per-tile and block-major window
    updates and geometry) and adds the block-streaming outer loops.
    """

    def __init__(self, gen: TeraGenerator, sconf: StreamConfig,
                 devices: Optional[list] = None):
        """``devices``: the devices that sweep the windows (default: the
        generator's); each gets a replica of the generator's model
        (``generator.replicate``), and all of them sweep disjoint windows
        of the same double-buffered host state."""
        self.gen = gen
        self.sconf = sconf
        self.devices = ([_indexed(d) for d in devices] if devices
                        else [gen.device])
        self.device = self.devices[0]
        self.timing = None   # TMT_STREAM_TIMING's phase seconds, last run
        c = gen.conf
        if c.window_chunk < 0:
            # streaming does not plan: take the largest z-window chunk
            # whose patch batch stays under TMT_MAX_PATCHES (5 at a 2x2
            # block-major window, 405 patches; 1 at 4x4; 5 tile-major)
            p_max = int(os.environ.get("TMT_MAX_PATCHES", "600"))
            tpp = c.tile // c.patch
            ppw = ((sconf.block_rows * tpp + 1)
                   * (sconf.block_cols * tpp + 1)
                   if sconf.block_major else (tpp + 1) ** 2)
            wc = 1
            for d in range(1, c.n_win + 1):
                if c.n_win % d == 0 and d * ppw <= p_max:
                    wc = d
            gen.conf = c = dataclasses.replace(c, window_chunk=wc)
            print(f"streaming: window_chunk auto -> {wc} "
                  f"({ppw} patches/z-window)", flush=True)
        k = sconf.steps_per_window
        if k > 1 and c.patch * (k - 1) > c.tile + c.pad:
            raise ValueError(
                f"steps_per_window={k} needs a gene halo of "
                f"{c.pad + c.patch * (k - 1)} px; one neighbor-tile ring "
                f"provides at most {c.tile + c.pad} px (max K = "
                f"tile//patch + 1)")
        # one generator (model replica, sampler) per entry of devices
        self._gens = [gen if d == _indexed(gen.device)
                      else replicate(gen, d) for d in self.devices]

    def _halo_px(self, k: int) -> int:
        """Input halo (px) a k-step window visit needs."""
        c = self.gen.conf
        return c.pad + c.patch * (k - 1)

    def make_state(self, rows: int, cols: int) -> HostState:
        """An empty :class:`HostState` for this run's dtype and backend,
        pinned when the card is used and the buffers are in RAM."""
        c, s = self.gen.conf, self.sconf
        return HostState(rows, cols, c.tile, c.channels,
                         memmap_dir=s.memmap_dir,
                         dtype=s.state_dtype or s.transfer_dtype,
                         pin=self.device.type == "cuda"
                         and s.memmap_dir is None)

    # ---- device step over one halo-padded window ----------------------
    def _window_step(self, gen: TeraGenerator, padded: torch.Tensor,
                     gene_blk: torch.Tensor, t: int) -> torch.Tensor:
        """padded: (br*tile+2p, bc*tile+2p, ch); gene_blk: (br, bc, ...).
        Returns (br*tile, bc*tile, ch) in the transfer dtype.  ``gen``:
        the replica of the device the window runs on."""
        br, bc = gene_blk.shape[:2]
        padded = padded.float()
        out_dt = DTYPES[self.sconf.transfer_dtype]
        if self.sconf.block_major:
            return gen._window_update(padded, gene_blk, t).to(out_dt)
        return torch.cat([
            torch.cat([gen._tile_update(padded, gene_blk[r, cc], r, cc, t)
                       for cc in range(bc)], dim=1)
            for r in range(br)]).to(out_dt)

    # ---- temporal halo blocking: k steps per window visit ---------------
    def _multistep_window(self, gen: TeraGenerator, padded: torch.Tensor,
                          bin_grid: torch.Tensor, t0: int, oy: int, ox: int,
                          *, k: int, bounds: tuple) -> torch.Tensor:
        """Advance ``k`` DDIM steps on one window (trapezoid time-tiling).

        padded:   (B + 2*halo, ...) window, halo = pad + patch*(k-1); its
                  interior B px come out valid at t0-k.
        bin_grid: gene bins covering exactly the padded extent.
        oy/ox:    grid px origin of ``padded`` (negative at the border);
                  pixels outside ``bounds`` (ylo, yhi, xlo, xhi) are
                  re-pinned to -1 before EVERY inner step, as the
                  reference refills the halo each epoch; in a
                  band-parallel run they reach into the neighbouring
                  bands.  ``gen``: the replica of the window's device.

        Exact: a step's output pixel depends only on inputs inside its
        patch and the neighbour patch of its collage patch, so each inner
        step consumes 2*pad px of border and crops 2*pad more to keep the
        next patch grid on the reference's alignment."""
        c = self.gen.conf
        p, pad = c.patch, c.pad
        bshift = p // c.gn_blk
        x = padded.float()
        n0, m0 = bin_grid.shape[:2]
        for j in range(k):
            h, w = x.shape[:2]
            gy = oy + p * j + torch.arange(h, device=x.device)[:, None]
            gx = ox + p * j + torch.arange(w, device=x.device)[None, :]
            outside = ((gy < bounds[0]) | (gy >= bounds[1]) |
                       (gx < bounds[2]) | (gx >= bounds[3]))
            x = x.masked_fill(outside[:, :, None], -1.0)
            bins_j = bin_grid[j * bshift:n0 - j * bshift,
                              j * bshift:m0 - j * bshift]
            core = gen._window_update_bins(x, bins_j, t0 - j)
            x = core if j == k - 1 else core[pad:-pad, pad:-pad]
        return x.to(DTYPES[self.sconf.transfer_dtype])

    # ---- init ----------------------------------------------------------
    def init_state(self, state: HostState, *, row0: int = 1, col0: int = 1,
                   grid_w: int = 416) -> None:
        """Fill the read buffer with the per-tile LCG init noise."""
        c = self.gen.conf
        for r in range(state.rows):
            for cc in range(state.cols):
                state.read[r * c.tile:(r + 1) * c.tile,
                           cc * c.tile:(cc + 1) * c.tile] = torch.from_numpy(
                    tile_init_noise(row0 + r, col0 + cc, grid_w,
                                    (c.tile, c.tile, c.channels),
                                    backend=c.noise_backend))

    # ---- the outer loop -------------------------------------------------
    def run(self, rows: int, cols: int,
            gene: Union[np.ndarray, GeneProvider], *,
            row0: int = 1, col0: int = 1, grid_w: int = 416,
            checkpoint: Optional[StateCheckpoint] = None,
            state: Optional[HostState] = None,
            start_t: Optional[int] = None,
            strip_exchange=None,
            rows_above: int = 0, rows_below: int = 0) -> HostState:
        """Generate the (rows x cols) grid; returns the final HostState
        (result in ``.read``).  ``state`` + ``start_t`` resume from an
        explicit timestep (the reference's --cur_epoch); otherwise from
        the latest spill of ``checkpoint``, if any.  A worker's exception
        propagates.

        Band-parallel runs: ``rows`` is this rank's band of the grid
        (``row0`` its absolute first tile row) and ``strip_exchange`` a
        :class:`~.band.StripExchange` of ``pad + patch*(K-1)`` px: the
        band's top and bottom edge rows are traded with the neighbouring
        bands for the initial state and after every visit, and feed the
        halos of the windows at the band's edge.  ``rows_above`` and
        ``rows_below`` count the tile rows of the grid beyond the band:
        the K > 1 border mask then pins only pixels outside the grid, and
        the provider is asked for the neighbouring bands' ring tiles (it
        must accept r in [-1, rows] there)."""
        c = self.gen.conf
        s = self.sconf
        br = min(s.block_rows, rows)
        bc = min(s.block_cols, cols)
        provider = _as_provider(gene)
        T = self.gen.sampler.schedule.num_timesteps
        K = s.steps_per_window
        if strip_exchange is not None and self._halo_px(K) > rows * c.tile:
            raise ValueError(
                f"band of {rows} tile rows is shorter than the "
                f"{self._halo_px(K)}-px ghost strip steps_per_window={K} "
                f"needs")
        if state is not None and start_t is None:
            # an explicit state with no timestep would restart the whole
            # reverse process from T on top of it
            raise ValueError("explicit `state` requires `start_t` (the "
                             "remaining timestep count); pass start_t=T to "
                             "really restart from pure noise")
        if start_t is None:
            start_t = T

        if state is None:
            state = self.make_state(rows, cols)
            resumed = False
            if checkpoint is not None:
                latest = checkpoint.latest()
                if latest is not None:
                    grid, meta = checkpoint.load_grid(latest)
                    got = (meta["rows"], meta["cols"], meta["size"],
                           meta["channels"])
                    if got != (rows, cols, c.tile, c.channels):
                        raise ValueError(
                            f"spill at t={latest} holds (rows, cols, size, "
                            f"channels) {got}, not "
                            f"{(rows, cols, c.tile, c.channels)}")
                    for r in range(rows):
                        for cc in range(cols):
                            state.read[r * c.tile:(r + 1) * c.tile,
                                       cc * c.tile:(cc + 1) * c.tile] = \
                                torch.from_numpy(grid[r, cc])
                    start_t = T - latest
                    resumed = True
            if not resumed:
                self.init_state(state, row0=row0, col0=col0, grid_w=grid_w)

        # window origins, shifted inward at the edges: one window shape.
        # Where an edge window overlaps its neighbour, the later window of
        # the sweep writes the overlap (as a sequential sweep would), so
        # windows write disjoint tiles and the worker pool's finishing
        # order cannot change a bit of the result.
        r_orig = sorted({min(r, rows - br) for r in range(0, rows, br)})
        c_orig = sorted({min(cc, cols - bc) for cc in range(0, cols, bc)})
        windows = [(r0, c0) for r0 in r_orig for c0 in c_orig]

        def spans(origins, size):
            return {o: (o, origins[i + 1] if i + 1 < len(origins)
                        else o + size) for i, o in enumerate(origins)}
        r_span, c_span = spans(r_orig, br), spans(c_orig, bc)

        # per-window host gene cache (timestep-invariant), LRU-bounded;
        # provider reads stay outside the lock (a window appears once a
        # sweep, so concurrent builds of one key do not arise)
        gene_cache: OrderedDict = OrderedDict()
        cache_lock = threading.Lock()

        def _cache_put(key, blk):
            with cache_lock:
                gene_cache[key] = blk
                if s.gene_cache_windows and \
                        len(gene_cache) > s.gene_cache_windows:
                    gene_cache.popitem(last=False)
            return blk

        def _cache_get(key):
            with cache_lock:
                blk = gene_cache.get(key)
                if blk is not None:
                    gene_cache.move_to_end(key)
                return blk

        def gene_block(r0: int, c0: int) -> np.ndarray:
            hit = _cache_get((r0, c0))
            if hit is not None:
                return hit
            return _cache_put((r0, c0), np.stack([
                np.stack([provider(r0 + i, c0 + j) for j in range(bc)])
                for i in range(br)]))

        nb, hb = c.tile // c.gn_blk, c.pad // c.gn_blk

        def gene_block_ext(r0: int, c0: int, k: int) -> np.ndarray:
            """Assembled bin grid covering the k-step padded window: the
            core tiles plus the in-grid part of their one-tile ring;
            out-of-grid bins stay zero (they condition only pixels the
            border mask pins to -1).  Ring first, then core, so the grid
            border keeps the border tiles' own halo bins, as
            ``assemble_bins`` does."""
            key = (r0, c0, k)
            hit = _cache_get(key)
            if hit is not None:
                return hit
            Hb = self._halo_px(k) // c.gn_blk
            gh, gw = br * nb + 2 * Hb, bc * nb + 2 * Hb
            canvas = None
            core = [(i, j) for i in range(br) for j in range(bc)]
            ring = [(i, j) for i in range(-1, br + 1)
                    for j in range(-1, bc + 1) if (i, j) not in core]
            r_lo = -1 if rows_above else 0
            r_hi = rows + (1 if rows_below else 0)
            for i, j in ring + core:
                ti, tj = r0 + i, c0 + j
                if not (r_lo <= ti < r_hi and 0 <= tj < cols):
                    continue
                arr = np.asarray(provider(ti, tj))
                if canvas is None:
                    canvas = np.zeros((gh, gw) + arr.shape[2:], arr.dtype)
                oy, ox = i * nb - hb + Hb, j * nb - hb + Hb
                sy0, sx0 = max(0, -oy), max(0, -ox)
                sy1 = min(arr.shape[0], gh - oy)
                sx1 = min(arr.shape[1], gw - ox)
                if sy0 >= sy1 or sx0 >= sx1:
                    continue
                canvas[oy + sy0:oy + sy1, ox + sx0:ox + sx1] = \
                    arr[sy0:sy1, sx0:sx1]
            return _cache_put(key, canvas)

        # device gene cache, pin-first under the budget of each device.  A
        # block uploaded on one worker's stream is read on others' streams,
        # so the upload is synchronised before the block enters the cache.
        dev_gene: dict = {}
        dev_used = dict.fromkeys(self.devices, 0)   # bytes a device
        dev_budget = int(s.gene_device_cache_gb * 1e9)

        def gene_on_device(r0: int, c0: int, k: int,
                           dev: torch.device) -> torch.Tensor:
            key = (r0, c0, k, dev)
            with cache_lock:
                arr = dev_gene.get(key)
            if arr is not None:
                return arr
            blk = gene_block(r0, c0) if k == 1 else gene_block_ext(r0, c0, k)
            arr = torch.from_numpy(np.ascontiguousarray(blk)).to(
                dev, non_blocking=True)
            nbytes = arr.numel() * arr.element_size()
            if dev_budget and dev_used[dev] + nbytes <= dev_budget:
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                with cache_lock:
                    if dev_used[dev] + nbytes <= dev_budget:
                        dev_gene[key] = arr
                        dev_used[dev] += nbytes
            return arr

        # band-parallel: the neighbouring bands' edge rows of the state in
        # the read buffer (exchanged for the initial state, then after
        # every swap)
        ghosts = [None, None]

        def exchange_ghosts() -> None:
            if strip_exchange is None:
                return
            p = self._halo_px(K)
            ghosts[0], ghosts[1] = strip_exchange(state.read[:p],
                                                  state.read[-p:])

        exchange_ghosts()

        tdt = DTYPES[s.transfer_dtype]
        cuda = any(d.type == "cuda" for d in self.devices)
        cur = {"t": start_t - 1, "k": 1}   # the visit the workers run
        bounds = (-rows_above * c.tile, (rows + rows_below) * c.tile,
                  0, cols * c.tile)        # the grid's px, band-relative

        # each worker thread: reusable pinned staging buffers (a worker
        # finishes a window before it starts the next)
        tls = threading.local()

        def _staging(key, shape) -> torch.Tensor:
            bufs = tls.__dict__.setdefault("bufs", {})
            buf = bufs.get((key, shape))
            if buf is None:
                buf = bufs[(key, shape)] = torch.empty(
                    shape, dtype=tdt, pin_memory=cuda)
            return buf

        # TMT_STREAM_TIMING=1: per-phase wall time (host assembly, H2D,
        # dispatch, device queue, D2H), printed at the end of the run and
        # kept in ``self.timing``.  Each phase waits on a CUDA event, so
        # the sweep runs on one worker: a breakdown, not a benchmark.
        tim = ({"asm": 0.0, "h2d": 0.0, "disp": 0.0, "queue": 0.0,
                "d2h": 0.0, "n": 0}
               if os.environ.get("TMT_STREAM_TIMING") else None)

        def _wait(stream):
            if stream is not None:
                ev = torch.cuda.Event()
                ev.record(stream)
                ev.synchronize()

        def do_window(r0: int, c0: int, slot: int) -> None:
            """Assemble, upload, denoise on ``devices[slot]``, fetch and
            write back one window on a stream of its own."""
            t0, k = cur["t"], cur["k"]
            halo = self._halo_px(k)
            dev, gen = self.devices[slot], self._gens[slot]
            tw = time.perf_counter()
            with torch.inference_mode(), _side_stream(dev) as stream:
                padded = state.padded_window(
                    r0, c0, br, bc, halo, ghost_top=ghosts[0],
                    ghost_bot=ghosts[1],
                    out=_staging("in", (br * c.tile + 2 * halo,
                                        bc * c.tile + 2 * halo,
                                        c.channels)))
                gblk = gene_on_device(r0, c0, k, dev)
                if tim is not None:
                    tim["asm"] += time.perf_counter() - tw
                    tw = time.perf_counter()
                dpad = padded.to(dev, non_blocking=True)
                if tim is not None:
                    _wait(stream)
                    tim["h2d"] += time.perf_counter() - tw
                    tim["n"] += 1
                    tw = time.perf_counter()
                if k == 1:
                    out = self._window_step(gen, dpad, gblk, t0)
                else:
                    out = self._multistep_window(
                        gen, dpad, gblk, t0, r0 * c.tile - halo,
                        c0 * c.tile - halo, k=k, bounds=bounds)
                if tim is not None:
                    tim["disp"] += time.perf_counter() - tw
                    tw = time.perf_counter()
                    _wait(stream)
                    tim["queue"] += time.perf_counter() - tw
                    tw = time.perf_counter()
                host = _staging("out", tuple(out.shape))
                host.copy_(out, non_blocking=True)
                if stream is not None:
                    stream.synchronize()
                if tim is not None:
                    tim["d2h"] += time.perf_counter() - tw
                (ra, rb), (ca, cb) = r_span[r0], c_span[c0]
                ts = c.tile
                state.write[ra * ts:rb * ts, ca * ts:cb * ts] = \
                    host[(ra - r0) * ts:(rb - r0) * ts,
                         (ca - c0) * ts:(cb - c0) * ts]

        # `inflight` workers a device; windows go round-robin over the
        # devices (they write disjoint tiles and read the immutable read
        # buffer, so the assignment cannot change a bit of the result)
        ndev = len(self.devices)
        n_workers = (max(1, s.inflight) * ndev
                     if s.pipeline and tim is None else 1)
        pool = ThreadPoolExecutor(n_workers) if n_workers > 1 else None
        t = start_t - 1
        prev_epoch = T - start_t  # epochs completed before this run
        try:
            while t >= 0:
                k = min(K, t + 1)
                cur["t"], cur["k"] = t, k
                if pool is None:
                    for i, (r0, c0) in enumerate(windows):
                        do_window(r0, c0, i % ndev)
                else:
                    futs = [pool.submit(do_window, r0, c0, i % ndev)
                            for i, (r0, c0) in enumerate(windows)]
                    for f in futs:
                        f.result()
                state.swap()
                exchange_ghosts()
                t_last = t - k + 1        # deepest timestep just completed
                epoch = T - t_last        # epochs completed
                if s.progress:
                    span = f"t={t}" if k == 1 else f"t={t}..{t_last}"
                    print(f"[stream] step {span} done ({epoch}/{T})",
                          flush=True)
                if checkpoint is not None and s.checkpoint_every and \
                        t_last > 0 and (epoch // s.checkpoint_every >
                                        prev_epoch // s.checkpoint_every):
                    grid = state.read.float().reshape(
                        rows, c.tile, cols, c.tile, c.channels).permute(
                            0, 2, 1, 3, 4)
                    checkpoint.save_grid(epoch, grid.numpy(),
                                         hst=row0 * c.tile,
                                         wst=col0 * c.tile, size=c.tile)
                    checkpoint.prune(keep_t=epoch)
                prev_epoch = epoch
                t -= k
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        if tim is not None and tim["n"]:
            self.timing = dict(tim)
            phases = {k2: v for k2, v in tim.items() if k2 != "n"}
            print(f"[stream timing] windows={tim['n']} " +
                  " ".join(f"{k2}={v:.2f}s" for k2, v in phases.items()) +
                  f" total={sum(phases.values()):.2f}s", flush=True)
        return state
