"""Tera-scale generation: the timestep-major tile-grid sampling loop.

Port of ``tera_mind_tpu/parallel/generator.py`` for one device, block-major
steps only.  The whole tile-grid state lives on the device as one
channels-last image; each DDIM step pads it with a -1 halo, cuts it into z
windows and denoises each window's whole patch grid in one batch
(``_window_update_bins``), ``window_chunk`` windows per model call.  The
Python loop over window chunks takes the place of the JAX ``lax.scan``.

z-window semantics: image channels are (stain, window, z) stain-major;
image windows are NON-overlapping groups of ``snum//2`` slices; RNA windows
are OVERLAPPING groups of ``snum`` slices with stride ``snum//2`` over the
z-padded gene stack.

``run`` resumes from a given state or from the latest spill of a
``StateCheckpoint`` and spills every ``checkpoint_every`` steps.  Not
ported yet: the tile-major step, ``auto_plan`` (XLA memory analysis),
meshes, multi-process runs and streaming.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..data.noise import tile_init_noise
from ..data.tilestore import StateCheckpoint
from ..diffusion.sampler import DiffusionSampler
from ..ops.collage import patchify
from .halo import pad_halo_single


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
    window_chunk: int = 0      # z-windows per model call (0 = all at
                               # once); bounds activation memory
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


class TeraGenerator:
    """Runs the tile-grid reverse diffusion on one device.

    model_fn(x_patches, t_model, rna_patches, p1, p2) -> (pred_col, _)
    gene grids are (R, C, gsz, gsz, z_pad, G) per-tile dense gene z-stacks.
    """

    def __init__(self, sampler: DiffusionSampler, model_fn: Callable,
                 conf: GeneratorConfig, *, device="cuda"):
        self.device = torch.device(device)
        self.sampler = sampler.to(self.device)
        self.model_fn = model_fn
        self.conf = conf

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
                        (c.tile, c.tile, c.channels))
        return out

    def _wchunk(self) -> int:
        """window_chunk: 0 = all windows at once, -1 = 1."""
        wc, n_win = self.conf.window_chunk, self.conf.n_win
        chunk = n_win if wc == 0 else (1 if wc < 0 else wc)
        if n_win % chunk:
            raise ValueError(f"window_chunk {wc} does not divide the "
                             f"{n_win} z-windows")
        return chunk

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
        padded = pad_halo_single(state, c.pad, fill=-1.0)
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

    def compile_step(self, rows: int, cols: int, *,
                     block_major: bool = True) -> Callable:
        """The per-step function ``(state, gene, t) -> state`` for a grid
        (the JAX package's entry point; PyTorch runs eagerly, so nothing
        is compiled and any grid shape works)."""
        if not block_major:
            raise NotImplementedError("the tile-major step is not ported "
                                      "yet; use block_major=True")
        return self._block_major_step

    def _device_gene(self, gene: Union[np.ndarray, Callable], rows: int,
                     cols: int) -> torch.Tensor:
        """The (R, C, gsz, gsz, z_pad, G) gene grid on the device.  A
        provider ``(r, c) -> (gsz, gsz, z_pad, G)`` is read one tile row at
        a time into the device buffer, so the host holds one row."""
        if not callable(gene):
            return torch.as_tensor(gene, device=self.device)
        c = self.conf
        band = np.stack([gene(0, cc) for cc in range(cols)])
        want = (c.gsz, c.gsz, c.z_pad)
        if band.shape[1:4] != want:
            raise ValueError(f"gene tiles {band.shape[1:]}, expected "
                             f"{want} + (genes,)")
        dev = torch.empty((rows,) + band.shape,
                          dtype=torch.from_numpy(band).dtype,
                          device=self.device)
        for r in range(rows):
            if r:
                band = np.stack([gene(r, cc) for cc in range(cols)])
            dev[r] = torch.from_numpy(band)
        return dev

    def run(self, gene_grid: Union[np.ndarray, Callable], *,
            rows: Optional[int] = None, cols: Optional[int] = None,
            row0: int = 1, col0: int = 1, grid_w: int = 416,
            state: Optional[np.ndarray] = None,
            start_t: Optional[int] = None,
            checkpoint: Optional[StateCheckpoint] = None,
            checkpoint_every: int = 0, progress: bool = True) -> np.ndarray:
        """Generate the (rows x cols) tile grid; returns the final image.

        ``gene_grid``: a host array (R, C, gsz, gsz, z_pad, G), or a
        provider ``(r, c) -> (gsz, gsz, z_pad, G)`` (grid-local indices)
        with ``rows`` and ``cols`` given.  The grid starts from its LCG
        noise, or resumes: from ``state`` (R*tile, C*tile, channels) at
        ``start_t`` steps left, or else from the latest spill of
        ``checkpoint``.  With ``checkpoint_every`` the state is spilled to
        ``checkpoint`` after every that many steps (not after the last)
        and older spills are pruned."""
        c = self.conf
        if callable(gene_grid):
            if rows is None or cols is None:
                raise ValueError("a gene provider needs rows and cols")
        else:
            rows, cols = gene_grid.shape[:2]
        T = self.sampler.schedule.num_timesteps
        if state is None and checkpoint is not None:
            latest = checkpoint.latest()
            if latest is not None:
                grid, meta = checkpoint.load_grid(latest)
                # the state-protocol guard (reference test_brn.py:178)
                got = (meta["rows"], meta["cols"], meta["size"],
                       meta["channels"])
                if got != (rows, cols, c.tile, c.channels):
                    raise ValueError(f"spill at t={latest} holds (rows, "
                                     f"cols, size, channels) {got}, not "
                                     f"{(rows, cols, c.tile, c.channels)}")
                state = grid_to_image(grid)
                start_t = T - latest          # epochs done = latest
        if start_t is None:
            start_t = T
        dev_gene = self._device_gene(gene_grid, rows, cols)
        if state is None:
            state = self.init_state(rows, cols, row0=row0, col0=col0,
                                    grid_w=grid_w)
        dev_state = torch.as_tensor(state, device=self.device)
        step = self.compile_step(rows, cols)
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
                    rate = (f"  {(epoch - e_start) * rows * cols / (now - t_start):.4f}"
                            " tile-steps/s")
                print(f"[tera] step t={t} done ({epoch}/{T}){rate}",
                      flush=True)
            if checkpoint is not None and checkpoint_every and t > 0 \
                    and epoch % checkpoint_every == 0:
                checkpoint.save_grid(
                    epoch, image_to_grid(dev_state.cpu().numpy(), c.tile),
                    hst=row0 * c.tile, wst=col0 * c.tile, size=c.tile)
                checkpoint.prune(keep_t=epoch)
        assert dev_state.shape == (rows * c.tile, cols * c.tile, c.channels)
        return dev_state.cpu().numpy()
