"""Tera-scale generation: the timestep-major tile-grid sampling loop.

Port of ``tera_mind_tpu/parallel/generator.py`` for one device.  The whole
tile-grid state lives on the device as one channels-last image; each DDIM
step pads it with a -1 halo and cuts it into z windows.  Two steps give
the same result:

- tile-major (``_block_step``): every tile's 320x320 halo window is
  denoised on its own, ``(tile/patch + 1)^2`` patches per z-window;
- block-major (``_block_major_step``): one patch grid over the whole block
  (or over row strips of it), ``window_chunk`` z-windows per model call.

The Python loops over tiles and window chunks take the place of the JAX
``lax.scan``s.  With ``window_chunk`` -1 the block-major step is planned
(``auto_plan``): on the card each candidate plan's peak device memory is
measured with one model call at its largest patch batch, where JAX reads
XLA's memory analysis.

z-window semantics: image channels are (stain, window, z) stain-major;
image windows are NON-overlapping groups of ``snum//2`` slices; RNA windows
are OVERLAPPING groups of ``snum`` slices with stride ``snum//2`` over the
z-padded gene stack.

``run`` resumes from a given state or from the latest spill of a
``StateCheckpoint`` and spills every ``checkpoint_every`` steps.  Host
streaming of grids larger than the device is ``parallel/streaming.py``.

With a ``mesh`` of ranks (``parallel/mesh.py``, one rank per device) the
grid is split into equal tile blocks, rank (r, c) of an (R, C) mesh owning
block (r, c): each rank builds only its block's genes and initial noise,
every step pads its block with its neighbours' edge strips
(``exchange_halo_2d``) where one device pads with -1, and ``run`` returns
the rank's block, its pixel offset in ``_local_offset``.  A grid that the
mesh does not divide is refused, as JAX's sharding refuses it.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..data.noise import tile_init_noise
from ..data.tilestore import StateCheckpoint
from ..diffusion.sampler import DiffusionSampler
from ..ops.collage import patchify
from .halo import exchange_halo_2d, pad_halo_single


def assemble_bins(tiles: torch.Tensor, nb: int, hb: int) -> torch.Tensor:
    """Per-tile padded gene-bin arrays -> one padded global bin grid.

    tiles: (R, C, g, g, ...) with g = nb + 2*hb (each tile's bins plus an
    ``hb``-bin halo).  Output (R*nb + 2*hb, C*nb + 2*hb, ...): interiors
    from their owner tile, the border ring from the edge tiles' halos.
    """
    R, C, g1, g2 = tiles.shape[:4]
    if not g1 == g2 == nb + 2 * hb:
        raise ValueError(f"tile bins {g1}x{g2}, expected {nb} + 2*{hb} "
                         "per side")
    trail = tiles.shape[4:]

    def grid(block):  # (R, C, a, b, ...) -> (R*a, C*b, ...)
        r, c, a, b = block.shape[:4]
        x = block.permute(0, 2, 1, 3, *range(4, block.dim()))
        return x.reshape(r * a, c * b, *trail)

    inner = grid(tiles[:, :, hb:hb + nb, hb:hb + nb])
    left = grid(tiles[:, :1, hb:hb + nb, :hb])
    right = grid(tiles[:, -1:, hb:hb + nb, hb + nb:])
    mid = torch.cat([left, inner, right], dim=1)
    top = torch.cat(
        [tiles[0, 0, :hb, :hb], grid(tiles[:1, :, :hb, hb:hb + nb])[:hb],
         tiles[0, -1, :hb, hb + nb:]], dim=1)
    bot = torch.cat(
        [tiles[-1, 0, hb + nb:, :hb],
         grid(tiles[-1:, :, hb + nb:, hb:hb + nb])[:hb],
         tiles[-1, -1, hb + nb:, hb + nb:]], dim=1)
    return torch.cat([top, mid, bot], dim=0)


def grid_to_image(grid: np.ndarray) -> np.ndarray:
    """(rows, cols, tile, tile, C) tile grid -> (rows*tile, cols*tile, C)."""
    r, c, th, tw, ch = grid.shape
    return grid.transpose(0, 2, 1, 3, 4).reshape(r * th, c * tw, ch)


def image_to_grid(img: np.ndarray, tile: int) -> np.ndarray:
    """Inverse of :func:`grid_to_image`."""
    h, w, ch = img.shape
    return img.reshape(h // tile, tile, w // tile, tile, ch).transpose(
        0, 2, 1, 3, 4)


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    tile: int = 256
    patch: int = 64
    gn_blk: int = 16           # px per gene bin
    snum: int = 4              # RNA z-window size
    n_slices: int = 50         # total z slices
    stains: int = 2
    gdim: int = 500            # gene panel carried in the gene stack
    noise_backend: str = "torch"  # initial noise: 'torch' (the
                               # reference's LCG-seeded randn) or 'jax'
                               # (JAX's threefry normal, data/noise.py)
    window_chunk: int = 0      # z-windows per model call (0 = all at
                               # once, -1 = planned by auto_plan);
                               # bounds activation memory
    strip_rows: int = 0        # tile rows per block-major strip (0 =
                               # whole block); strips read their halo from
                               # the previous-step state, so results equal
                               # the whole-block grid

    @property
    def pad(self) -> int:
        return self.patch // 2

    @property
    def spad(self) -> int:
        return {1: 0, 4: 1, 8: 1, 16: 3}[self.snum]

    @property
    def zi(self) -> int:
        """Image z-voxels per window (= model z_size)."""
        return max(1, self.snum // 2)

    @property
    def n_win(self) -> int:
        """Number of z windows (= RNA windows = image windows)."""
        z_use = self.n_slices if self.snum in (1, 4) else 48
        return z_use // self.zi

    @property
    def z_use(self) -> int:
        return self.n_win * self.zi

    @property
    def channels(self) -> int:
        return self.stains * self.z_use

    @property
    def z_pad(self) -> int:
        """RNA stack depth incl. z padding."""
        return self.n_slices + 2 * self.spad

    @property
    def gsz(self) -> int:
        """Gene bins per padded tile side ((256+64)/16 = 20)."""
        return (self.tile + 2 * self.pad) // self.gn_blk


Plan = tuple  # (tile_major, strip_rows, window_chunk)


def plan_candidates(rows: int, cols: int, conf: GeneratorConfig
                    ) -> list[Plan]:
    """The plans ``auto_plan`` tries, best first, as the JAX package
    orders them: block-major row strips by distance of their patches per
    z-window from ``TMT_TARGET_PATCHES`` (160), none above
    ``TMT_MAX_PATCHES`` (600), then the largest tile-major window chunk
    under that bound (tile-major with chunk 1 if nothing fits)."""
    p_max = int(os.environ.get("TMT_MAX_PATCHES", "600"))
    p_tgt = int(os.environ.get("TMT_TARGET_PATCHES", "160"))
    tpp = conf.tile // conf.patch

    def ppw(sr: int) -> int:    # patches per z-window of a strip
        return (sr * tpp + 1) * (cols * tpp + 1)

    cands = []
    for sr in sorted((s for s in range(1, rows + 1) if rows % s == 0),
                     key=lambda s: (abs(ppw(s) - p_tgt), -s)):
        if ppw(sr) <= p_max:
            cands.append((False, 0 if sr == rows else sr, 1))
    ppt = (tpp + 1) ** 2
    for wc in sorted((w for w in range(1, conf.n_win + 1)
                      if conf.n_win % w == 0), reverse=True):
        if wc * ppt <= p_max:
            cands.append((True, 0, wc))
            break
    if not cands:
        cands.append((True, 0, 1))
    return cands


def walk_plans(cands: Sequence[Plan], need: Callable[[Plan], int],
               budget: int, *, verbose: bool = True) -> tuple[Plan, int]:
    """(the first candidate whose ``need`` fits ``budget``, its need).

    A candidate whose probe runs out of device memory is passed over, as
    a compile-time RESOURCE_EXHAUSTED is in JAX; when none fits, the last
    (safest) candidate is taken with need -1.  Any other error raises."""
    for cand in cands:
        tm, sr, wc = cand
        try:
            n = need(cand)
        except torch.cuda.OutOfMemoryError:
            if verbose:
                print(f"auto_plan: candidate strip={sr} wc={wc} "
                      f"tile_major={tm} rejected (out of device memory)",
                      flush=True)
            continue
        if n <= budget:
            if verbose:
                print(f"auto_plan: strip={sr} wc={wc} tile_major={tm} "
                      f"needs {n / 1e9:.1f} GB <= {budget / 1e9:.1f} GB",
                      flush=True)
            return cand, n
        if verbose:
            print(f"auto_plan: candidate strip={sr} wc={wc} tile_major={tm}"
                  f" needs {n / 1e9:.1f} GB > {budget / 1e9:.1f} GB",
                  flush=True)
    return cands[-1], -1


class ModuleFn:
    """The generator's ``model_fn`` of a generation model: its collage
    decode, ``module(xp, tm, rp, p1, p2, decode_original=False)``.
    ``to(device)`` makes a replica of the model on another device."""

    def __init__(self, module: torch.nn.Module):
        self.module = module

    def __call__(self, xp, tm, rp, p1, p2):
        return self.module(xp, tm, rp, p1, p2, decode_original=False)

    def to(self, device) -> "ModuleFn":
        return ModuleFn(copy.deepcopy(self.module).to(device))


def replicate(gen: "TeraGenerator", device) -> "TeraGenerator":
    """``gen`` on another device: its model function's ``to(device)``
    replica (a function without ``to``, holding no weights, as it is)."""
    fn = gen.model_fn
    return TeraGenerator(gen.sampler, fn.to(device) if hasattr(fn, "to")
                         else fn, gen.conf, device=device)


class TeraGenerator:
    """Runs the tile-grid reverse diffusion on one device, or on this
    rank's block of a grid split over a mesh of ranks.

    model_fn(x_patches, t_model, rna_patches, p1, p2) -> (pred_col, _)
    gene grids are (R, C, gsz, gsz, z_pad, G) per-tile dense gene z-stacks.
    """

    def __init__(self, sampler: DiffusionSampler, model_fn: Callable,
                 conf: GeneratorConfig, *, device=None, mesh=None):
        """``device``: default the mesh's device, else ``cuda``.  ``mesh``
        (``parallel/mesh.py``): every rank of it builds a generator and
        calls ``run`` with the same grid.  The sampler must be
        deterministic DDIM (eta 0), as JAX's generator requires: its
        steps take no noise (``DiffusionSampler.sample`` samples
        stochastically)."""
        sc = sampler.conf
        if sc.stochastic:
            raise ValueError(
                f"TeraGenerator supports eta=0 DDIM only, got "
                f"gen_type={sc.gen_type!r} eta={sc.eta}; stochastic "
                "sampling is available via DiffusionSampler.sample")
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        self.device = torch.device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"device {self.device} is not the mesh's "
                             f"{mesh.device}")
        self.sampler = sampler.to(self.device)
        self.model_fn = model_fn
        self.conf = conf
        self.mesh = mesh
        self.plan_probe = None   # {"need", "budget"} bytes of the last
                                 # auto_plan on the card
        self._local_offset = (0, 0)   # px origin of run's result

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def local_block(self, rows: int, cols: int) -> tuple:
        """(first tile row, first tile col, rows, cols) of this rank's
        block of a (rows x cols) grid; the whole grid without a mesh."""
        if not self.sharded:
            return 0, 0, rows, cols
        (mr, mc), (r, c) = self.mesh.shape, self.mesh.coords
        if rows % mr or cols % mc:
            raise ValueError(f"a {rows}x{cols}-tile grid does not split "
                             f"into equal blocks over a {mr}x{mc} mesh "
                             "of ranks")
        lr, lc = rows // mr, cols // mc
        return r * lr, c * lc, lr, lc

    def _pad(self, state: torch.Tensor) -> torch.Tensor:
        c = self.conf
        if self.sharded:
            return exchange_halo_2d(state, c.pad, self.mesh, fill=-1.0)
        return pad_halo_single(state, c.pad, fill=-1.0)

    def init_state(self, rows: int, cols: int, *, row0: int = 1,
                   col0: int = 1, grid_w: int = 416) -> np.ndarray:
        """(R*tile, C*tile, chn) LCG-seeded initial noise image (host).

        row0/col0 are the tiles' ABSOLUTE grid coordinates, so any
        sub-grid reproduces the same brain."""
        c = self.conf
        out = np.empty((rows * c.tile, cols * c.tile, c.channels), np.float32)
        for r in range(rows):
            for cc in range(cols):
                out[r * c.tile:(r + 1) * c.tile,
                    cc * c.tile:(cc + 1) * c.tile] = tile_init_noise(
                        row0 + r, col0 + cc, grid_w,
                        (c.tile, c.tile, c.channels),
                        backend=c.noise_backend)
        return out

    def _wchunk(self) -> int:
        """window_chunk: 0 = all windows at once, -1 (not planned) = 1."""
        wc, n_win = self.conf.window_chunk, self.conf.n_win
        chunk = n_win if wc == 0 else (1 if wc < 0 else wc)
        if n_win % chunk:
            raise ValueError(f"window_chunk {wc} does not divide the "
                             f"{n_win} z-windows")
        return chunk

    def _tile_update(self, padded: torch.Tensor, gene_tile: torch.Tensor,
                     r: int, cc: int, t: int) -> torch.Tensor:
        """Denoise tile (r, cc) of the halo-padded local image on its own:
        its (tile + 2*pad)^2 window, unfolded into z-windows, through the
        model ``window_chunk`` z-windows a call.  Returns (tile, tile,
        channels)."""
        c = self.conf
        size = c.tile + 2 * c.pad
        win = padded[r * c.tile:r * c.tile + size,
                     cc * c.tile:cc * c.tile + size]
        x = win.reshape(size, size, c.stains, c.n_win, c.zi)
        x = x.permute(3, 0, 1, 2, 4).reshape(c.n_win, size, size,
                                             c.stains * c.zi)
        g = gene_tile.float()                       # (gsz, gsz, z_pad, G)
        rna = torch.stack([g[:, :, w * c.zi:w * c.zi + c.snum]
                           for w in range(c.n_win)])
        rna = rna.reshape(c.n_win, c.gsz, c.gsz, c.snum * g.shape[-1])
        chunk = self._wchunk()
        t_b = torch.full((chunk,), t, dtype=torch.long, device=padded.device)
        outs = [self.sampler.denoise_step(
                    self.model_fn, x[w0:w0 + chunk],
                    patchify(rna[w0:w0 + chunk], c.patch // c.gn_blk), t_b)
                for w0 in range(0, c.n_win, chunk)]
        out = torch.cat(outs).reshape(c.n_win, c.tile, c.tile, c.stains,
                                      c.zi)
        return out.permute(1, 2, 3, 0, 4).reshape(c.tile, c.tile, c.channels)
    def _window_update(self, padded: torch.Tensor, gene_tiles: torch.Tensor,
                       t: int) -> torch.Tensor:
        """Denoise every tile of a halo-padded block in ONE patch grid.

        padded:     (R*tile + 2*pad, C*tile + 2*pad, channels)
        gene_tiles: (R, C, gsz, gsz, z_pad, G) per-tile padded gene bins
        Returns (R*tile, C*tile, channels)."""
        c = self.conf
        assert c.pad % c.gn_blk == 0, (c.pad, c.gn_blk)
        g = assemble_bins(gene_tiles, c.tile // c.gn_blk, c.pad // c.gn_blk)
        return self._window_update_bins(padded, g, t)

    def _window_update_bins(self, padded: torch.Tensor,
                            bin_grid: torch.Tensor, t: int) -> torch.Tensor:
        """:meth:`_window_update` with the bin grid already assembled
        (``bin_grid`` covers exactly the padded extent)."""
        c = self.conf
        hp, wp = padded.shape[:2]
        H, W = hp - 2 * c.pad, wp - 2 * c.pad

        # z-window unfold of the whole padded block (stain-major channels)
        x = padded.reshape(hp, wp, c.stains, c.n_win, c.zi)
        x = x.permute(3, 0, 1, 2, 4).reshape(c.n_win, hp, wp,
                                             c.stains * c.zi)
        g = bin_grid                                   # (GH, GW, z_pad, G)
        GH, GW = g.shape[:2]
        assert GH == hp // c.gn_blk and GW == wp // c.gn_blk, \
            (GH, GW, hp, wp, c.gn_blk)

        chunk = self._wchunk()
        t_b = torch.full((chunk,), t, dtype=torch.long, device=padded.device)
        gn_per_patch = c.patch // c.gn_blk
        outs = []
        for w0 in range(0, c.n_win, chunk):
            rw = torch.stack([g[:, :, (w0 + j) * c.zi:(w0 + j) * c.zi + c.snum]
                              for j in range(chunk)]).float()
            rw = rw.reshape(chunk, GH, GW, c.snum * g.shape[-1])
            outs.append(self.sampler.denoise_step(
                self.model_fn, x[w0:w0 + chunk],
                patchify(rw, gn_per_patch), t_b))
        out = torch.cat(outs).reshape(c.n_win, H, W, c.stains, c.zi)
        return out.permute(1, 2, 3, 0, 4).reshape(H, W, c.channels)

    @torch.inference_mode()
    def _block_major_step(self, state: torch.Tensor, gene: torch.Tensor,
                          t: int) -> torch.Tensor:
        """One block-major timestep over the (R*tile, C*tile, chn) state.

        With ``conf.strip_rows`` below the block height the block runs in
        row strips, each its own patch grid whose halo rows come from the
        previous-step padded state: equal results, activation memory
        scaling with strip_rows."""
        c = self.conf
        padded = self._pad(state)
        rows = gene.shape[0]
        sr = c.strip_rows or rows
        if sr >= rows:
            out = self._window_update(padded, gene, t)
        else:
            if rows % sr:
                raise ValueError(f"strip_rows {sr} does not divide the "
                                 f"{rows} tile rows")
            nb, hb = c.tile // c.gn_blk, c.pad // c.gn_blk
            g = assemble_bins(gene, nb, hb)
            strip_px = sr * c.tile + 2 * c.pad
            strip_bins = sr * nb + 2 * hb
            out = torch.cat([
                self._window_update_bins(
                    padded[i * sr * c.tile:i * sr * c.tile + strip_px],
                    g[i * sr * nb:i * sr * nb + strip_bins], t)
                for i in range(rows // sr)])
        return out.to(state.dtype)

    @torch.inference_mode()
    def _block_step(self, state: torch.Tensor, gene: torch.Tensor,
                    t: int) -> torch.Tensor:
        """One tile-major timestep over the (R*tile, C*tile, chn) state:
        each tile denoised from its own halo window (``_tile_update``)."""
        c = self.conf
        padded = self._pad(state)
        rows, cols = gene.shape[:2]
        out = torch.cat([
            torch.cat([self._tile_update(padded, gene[r, cc], r, cc, t)
                       for cc in range(cols)], dim=1)
            for r in range(rows)])
        return out.to(state.dtype)

    def compile_pieces(self) -> Callable:
        """The JAX package's piece-wise step: a pad, then one call per tile
        from a Python loop.  PyTorch runs eagerly, so that is the
        tile-major step itself."""
        return self._block_step

    def auto_plan(self, rows: int, cols: int, *,
                  state_dtype=torch.float32, gene_dtype=torch.uint8,
                  verbose: bool = True) -> dict:
        """Pick (strip_rows, window_chunk), or the tile-major fallback, so
        the step fits the device; sets ``self.conf`` to the plan and
        returns it.

        Off the card the first candidate of ``plan_candidates`` is taken.
        On the card each candidate's peak memory is measured
        (``_plan_bytes``) against 92 % of the card's memory
        (``TMT_HBM_BYTES`` overrides the card's total), best first.
        With a mesh the plan is for this rank's block (``rows`` and
        ``cols`` are the whole grid's)."""
        c = self.conf
        rows, cols = self.local_block(rows, cols)[2:]
        cands = plan_candidates(rows, cols, c)
        if self.device.type != "cuda":
            (tm, sr, wc), self.plan_probe = cands[0], None
        else:
            total = torch.cuda.mem_get_info(self.device)[1]
            budget = int(os.environ.get("TMT_HBM_BYTES", total)) * 92 // 100
            (tm, sr, wc), need = walk_plans(
                cands, lambda cand: self._plan_bytes(
                    cand, rows, cols, state_dtype, gene_dtype),
                budget, verbose=verbose)
            self.plan_probe = {"need": need, "budget": budget}
        self.conf = dataclasses.replace(c, strip_rows=sr, window_chunk=wc)
        return {"tile_major": tm, "strip_rows": sr, "window_chunk": wc}

    def _plan_bytes(self, cand: Plan, rows: int, cols: int, state_dtype,
                    gene_dtype) -> int:
        """Peak device bytes of one candidate plan, measured: the grid's
        state, gene and padded buffers are allocated, the peak counter is
        reset, and one model call runs at the candidate's largest patch
        batch on zero inputs.  Raises ``torch.cuda.OutOfMemoryError`` when
        that does not fit."""
        tm, sr, wc = cand
        c, dev = self.conf, self.device
        tpp = c.tile // c.patch
        if tm:       # one tile's halo window
            p1 = p2 = tpp + 1
        else:        # a strip of sr (0: all) tile rows across the block
            p1, p2 = (sr or rows) * tpp + 1, cols * tpp + 1
        chunk = c.n_win if wc == 0 else wc
        gn = c.patch // c.gn_blk
        bufs = []
        try:
            bufs += [torch.zeros((rows * c.tile, cols * c.tile, c.channels),
                                 dtype=state_dtype, device=dev),
                     torch.zeros((rows, cols, c.gsz, c.gsz, c.z_pad,
                                  c.gdim), dtype=gene_dtype, device=dev),
                     torch.zeros((rows * c.tile + 2 * c.pad,
                                  cols * c.tile + 2 * c.pad, c.channels),
                                 dtype=state_dtype, device=dev)]
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            with torch.inference_mode():
                x = torch.zeros((chunk, p1 * c.patch, p2 * c.patch,
                                 c.stains * c.zi), dtype=state_dtype,
                                device=dev)
                rna = torch.zeros((chunk * p1 * p2, gn, gn,
                                   c.snum * c.gdim), device=dev)
                t_b = torch.zeros((chunk,), dtype=torch.long, device=dev)
                bufs.append(self.sampler.denoise_step(self.model_fn, x, rna,
                                                      t_b))
            torch.cuda.synchronize(dev)
            return torch.cuda.max_memory_allocated(dev)
        finally:
            del bufs
            torch.cuda.empty_cache()

    def compile_step(self, rows: int, cols: int, *,
                     block_major: bool = False, state_dtype=torch.float32,
                     gene_dtype=torch.uint8) -> Callable:
        """The per-step function ``(state, gene, t) -> state`` for a grid
        (the JAX package's entry point; PyTorch runs eagerly, so nothing
        is compiled).  ``block_major``: one patch grid over the block
        instead of the per-tile windows, the same result with fewer
        patches.  With ``conf.window_chunk`` -1 the block-major step is
        planned first (``auto_plan``), which may fall back to tile-major.
        With a mesh the step takes this rank's block of the (rows x cols)
        grid and exchanges its halo with the neighbouring ranks."""
        if block_major and self.conf.window_chunk < 0:
            plan = self.auto_plan(rows, cols, state_dtype=state_dtype,
                                  gene_dtype=gene_dtype)
            block_major = not plan["tile_major"]
        return self._block_major_step if block_major else self._block_step

    def _device_gene(self, gene: Union[np.ndarray, Callable], rows: int,
                     cols: int, r0: int = 0, c0: int = 0) -> torch.Tensor:
        """The (rows, cols, gsz, gsz, z_pad, G) gene block at tile (r0, c0)
        of the grid on the device.  A provider ``(r, c) -> (gsz, gsz,
        z_pad, G)`` (grid indices) is read one tile row at a time into the
        device buffer, so the host holds one row."""
        if not callable(gene):
            return torch.as_tensor(
                np.ascontiguousarray(gene[r0:r0 + rows, c0:c0 + cols]),
                device=self.device)
        c = self.conf

        def band(r):
            return np.stack([gene(r0 + r, c0 + cc) for cc in range(cols)])
        row = band(0)
        want = (c.gsz, c.gsz, c.z_pad)
        if row.shape[1:4] != want:
            raise ValueError(f"gene tiles {row.shape[1:]}, expected "
                             f"{want} + (genes,)")
        dev = torch.empty((rows,) + row.shape,
                          dtype=torch.from_numpy(row).dtype,
                          device=self.device)
        for r in range(rows):
            dev[r] = torch.from_numpy(row if r == 0 else band(r))
        return dev

    def run(self, gene_grid: Union[np.ndarray, Callable], *,
            rows: Optional[int] = None, cols: Optional[int] = None,
            row0: int = 1, col0: int = 1, grid_w: int = 416,
            state: Optional[np.ndarray] = None,
            start_t: Optional[int] = None,
            checkpoint: Optional[StateCheckpoint] = None,
            checkpoint_every: int = 0, fused: bool = True,
            block_major: bool = False, progress: bool = True) -> np.ndarray:
        """Generate the (rows x cols) tile grid; returns the final image,
        or with a mesh this rank's block of it (``_local_offset`` its px
        origin in the grid).

        ``gene_grid``: a host array (R, C, gsz, gsz, z_pad, G), or a
        provider ``(r, c) -> (gsz, gsz, z_pad, G)`` (grid-local indices)
        with ``rows`` and ``cols`` given; with a mesh each rank reads only
        its block's tiles.  The grid starts from its initial noise, or
        resumes: from ``state`` (the rank's block with a mesh) at
        ``start_t`` steps left, or else from the latest spill of
        ``checkpoint`` (each rank spills and reads its own block, with its
        own ``hst``/``wst``).  With ``checkpoint_every`` the state is
        spilled to ``checkpoint`` after every that many steps (not after
        the last) and older spills are pruned.  ``block_major`` and
        ``fused`` choose the step as in JAX: ``compile_step(block_major=
        ...)``, or with ``fused=False`` the tile-major
        ``compile_pieces``."""
        c = self.conf
        if callable(gene_grid):
            if rows is None or cols is None:
                raise ValueError("a gene provider needs rows and cols")
        else:
            rows, cols = gene_grid.shape[:2]
        r0, c0, lr, lc = self.local_block(rows, cols)
        self._local_offset = (r0 * c.tile, c0 * c.tile)
        T = self.sampler.schedule.num_timesteps
        if state is None and checkpoint is not None:
            latest = checkpoint.latest()
            if latest is not None:
                grid, meta = checkpoint.load_grid(latest)
                # the state-protocol guard (reference test_brn.py:178)
                got = (meta["rows"], meta["cols"], meta["size"],
                       meta["channels"])
                if got != (lr, lc, c.tile, c.channels):
                    raise ValueError(f"spill at t={latest} holds (rows, "
                                     f"cols, size, channels) {got}, not "
                                     f"{(lr, lc, c.tile, c.channels)}")
                state = grid_to_image(grid)
                start_t = T - latest          # epochs done = latest
        if start_t is None:
            start_t = T
        if state is not None and tuple(np.shape(state)) != (
                lr * c.tile, lc * c.tile, c.channels):
            raise ValueError(f"state {tuple(np.shape(state))}, expected the "
                             f"{lr}x{lc}-tile block "
                             f"{(lr * c.tile, lc * c.tile, c.channels)}")
        step = (self.compile_step(
                    rows, cols, block_major=block_major,
                    state_dtype=(torch.as_tensor(state).dtype
                                 if state is not None else torch.float32))
                if fused else self.compile_pieces())
        dev_gene = self._device_gene(gene_grid, lr, lc, r0, c0)
        if state is None:
            state = self.init_state(lr, lc, row0=row0 + r0, col0=col0 + c0,
                                    grid_w=grid_w)
        dev_state = torch.as_tensor(state, device=self.device)
        t_start = None
        for t in range(start_t - 1, -1, -1):
            dev_state = step(dev_state, dev_gene, t)
            epoch = T - t
            if progress:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                if t_start is None:   # first step includes warm-up
                    t_start, e_start, rate = now, epoch, ""
                else:
                    done = (epoch - e_start) * lr * lc
                    rate = f"  {done / (now - t_start):.4f} tile-steps/s"
                print(f"[tera] step t={t} done ({epoch}/{T}){rate}",
                      flush=True)
            if checkpoint is not None and checkpoint_every and t > 0 \
                    and epoch % checkpoint_every == 0:
                checkpoint.save_grid(
                    epoch, image_to_grid(dev_state.cpu().numpy(), c.tile),
                    hst=row0 * c.tile + self._local_offset[0],
                    wst=col0 * c.tile + self._local_offset[1], size=c.tile)
                checkpoint.prune(keep_t=epoch)
        assert dev_state.shape == (lr * c.tile, lc * c.tile, c.channels)
        return dev_state.cpu().numpy()
