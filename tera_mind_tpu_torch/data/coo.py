"""Host-side sparse COO array with the ops the MERFISH gene pipeline
needs (crop, block-sum binning, z padding, rotation and flip, densify).

Port of ``tera_mind_tpu/data/coo.py`` (numpy only, as there).  The
``.npz`` format is pydata/sparse-compatible (keys ``coords``, ``data``,
``shape``, ``fill_value``), so the published per-tile gene files load
directly (reference utils/MBADataset.py:69-98 uses ``sparse.load_npz``).
The gene grid is densified on the host and sent to the device dense; the
sparsity matters only on disk.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class COO:
    coords: np.ndarray  # (ndim, nnz) int
    data: np.ndarray    # (nnz,)
    shape: Tuple[int, ...]

    # ---------- IO ----------
    @classmethod
    def load_npz(cls, path: str | Path) -> "COO":
        with np.load(path, allow_pickle=False) as f:
            return cls(coords=np.asarray(f["coords"]),
                       data=np.asarray(f["data"]),
                       shape=tuple(int(s) for s in f["shape"]))

    def save_npz(self, path: str | Path) -> None:
        np.savez_compressed(path, coords=self.coords, data=self.data,
                            shape=np.asarray(self.shape),
                            fill_value=np.zeros((), dtype=self.data.dtype))

    @classmethod
    def from_dense(cls, arr: np.ndarray) -> "COO":
        coords = np.stack(np.nonzero(arr))
        return cls(coords=coords, data=arr[tuple(coords)], shape=arr.shape)

    def todense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        np.add.at(out, tuple(self.coords), self.data.astype(dtype))
        return out

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    # ---------- spatial ops (dims 0, 1 are H, W; dim 2 is channels) ----------
    def crop2d(self, top: int, left: int, h: int, w: int) -> "COO":
        r, c = self.coords[0], self.coords[1]
        m = (r >= top) & (r < top + h) & (c >= left) & (c < left + w)
        coords = self.coords[:, m].copy()
        coords[0] -= top
        coords[1] -= left
        return COO(coords, self.data[m], (h, w) + self.shape[2:])

    def block_sum(self, blk: int) -> "COO":
        """Sum blk x blk spatial bins (reference MBADataset.py:78-81);
        duplicate (bin, channel) entries are merged."""
        dims = (self.shape[0] // blk, self.shape[1] // blk) + self.shape[2:]
        coords = self.coords.copy()
        coords[0] //= blk
        coords[1] //= blk
        # merge duplicates through a linear key
        key = np.zeros(self.nnz, dtype=np.int64)
        mult = 1
        for d in range(coords.shape[0] - 1, -1, -1):
            key += coords[d].astype(np.int64) * mult
            mult *= dims[d]
        uniq, inv = np.unique(key, return_inverse=True)
        data = np.zeros(len(uniq), dtype=self.data.dtype)
        np.add.at(data, inv, self.data)
        new_coords = np.zeros((coords.shape[0], len(uniq)), dtype=coords.dtype)
        rem = uniq.copy()
        for d in range(len(dims) - 1, -1, -1):
            new_coords[d] = rem % dims[d]
            rem //= dims[d]
        return COO(new_coords, data, dims)

    def pad_channels(self, before: int, after: int) -> "COO":
        """Shift channel coords by ``before`` and extend the channel dim
        (reference MBADataset.py:86-90: z padding of the flat z*G
        channels)."""
        coords = self.coords.copy()
        coords[2] += before
        shape = list(self.shape)
        shape[2] += before + after
        return COO(coords, self.data.copy(), tuple(shape))

    def slice_channels(self, start: int, stop: int) -> "COO":
        m = (self.coords[2] >= start) & (self.coords[2] < stop)
        coords = self.coords[:, m].copy()
        coords[2] -= start
        shape = list(self.shape)
        shape[2] = stop - start
        return COO(coords, self.data[m], tuple(shape))

    def pad_spatial(self, pad: int) -> "COO":
        """Zero-pad the two spatial dims by ``pad`` on each side."""
        coords = self.coords.copy()
        coords[0] += pad
        coords[1] += pad
        shape = (self.shape[0] + 2 * pad, self.shape[1] + 2 * pad) \
            + self.shape[2:]
        return COO(coords, self.data.copy(), shape)

    def rot90(self) -> "COO":
        """One counter-clockwise 90-degree rotation of the (H, W) plane,
        as ``np.rot90(dense, 1, axes=(0, 1))``: (r, c) -> (W-1-c, r)."""
        coords = self.coords.copy()
        r, c = coords[0].copy(), coords[1].copy()
        coords[0] = self.shape[1] - 1 - c
        coords[1] = r
        shape = (self.shape[1], self.shape[0]) + self.shape[2:]
        return COO(coords, self.data.copy(), shape)

    def flip_w(self) -> "COO":
        """Horizontal flip (reverse the W axis)."""
        coords = self.coords.copy()
        coords[1] = self.shape[1] - 1 - coords[1]
        return COO(coords, self.data.copy(), self.shape)
