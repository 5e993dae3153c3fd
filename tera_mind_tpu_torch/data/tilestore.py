"""Tile store: the on-disk format of per-tile brain state and outputs.

Port of ``tera_mind_tpu/data/tilestore.py``.  The reference writes one
file per 256^2 tile named ``{h0}_{h1}_{w0}_{w1}`` (test_brn.py:219-226)
and one directory ``{base}_{t}`` per timestep; this store keeps that
naming, so the assembly and evaluation tools read either package's
output.  Format ``npy`` (raw numpy per tile) only: the JAX package's
``tensorstore`` (zarr) format needs a package the port does not use.

The generator keeps the state in device memory and spills it here only
for resume (``--cur_epoch``, test_brn.py:291-292) and the final export.
"""

from __future__ import annotations

import json
import shutil
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

FORMATS = ("npy",)


def tile_name(h0: int, h1: int, w0: int, w1: int) -> str:
    return f"{h0}_{h1}_{w0}_{w1}"


def _check_format(fmt: str, allowed) -> None:
    if fmt == "tensorstore":
        raise NotImplementedError("the tensorstore (zarr) format is not "
                                  "ported: it needs the tensorstore package")
    if fmt not in allowed:
        raise ValueError(f"format {fmt!r} not in {allowed}")


class TileStore:
    """One ``.npy`` file per tile under ``root``."""

    def __init__(self, root: str | Path, fmt: str = "npy"):
        _check_format(fmt, FORMATS)
        self.root = Path(root)
        self.fmt = fmt

    def _path(self, name: str) -> Path:
        return self.root / f"{name}.npy"

    def create(self) -> "TileStore":
        self.root.mkdir(parents=True, exist_ok=True)
        return self

    def delete(self) -> None:
        if self.root.is_dir():
            shutil.rmtree(self.root)

    def exists(self) -> bool:
        return self.root.is_dir()

    def write(self, name: str, arr: np.ndarray) -> None:
        """Write through a temporary file, so a reader never sees half a
        tile."""
        p = self._path(name)
        tmp = p.with_suffix(".tmp.npy")
        np.save(tmp, arr)
        tmp.replace(p)

    def read(self, name: str) -> np.ndarray:
        return np.load(self._path(name))

    def has(self, name: str) -> bool:
        return self._path(name).exists()

    def names(self) -> list[str]:
        return sorted(p.name[:-len(".npy")] for p in self.root.glob("*.npy")
                      if not p.name.endswith(".tmp.npy"))


class StateCheckpoint:
    """Timestep-indexed spill of the sampling state: ``{base}_{t}/`` per
    spilled timestep (the reference's per-epoch directories,
    test_brn.py:241-250), each holding the whole tile grid and a manifest
    with a CRC32 of every file, so a resume detects a torn or corrupted
    spill.

    fmt: ``npy`` = one file per tile (what the assembly tools read);
    ``grid`` = one state file per timestep, the fast resume format."""

    def __init__(self, base: str | Path, fmt: str = "npy"):
        _check_format(fmt, FORMATS + ("grid",))
        self.base = Path(base)
        self.fmt = fmt

    def _root(self, t: int) -> Path:
        return Path(f"{self.base}_{t}")

    def store_for(self, t: int) -> TileStore:
        assert self.fmt != "grid"
        return TileStore(self._root(t), self.fmt)

    def save_grid(self, t: int, state: np.ndarray, *, hst: int, wst: int,
                  size: int = 256, dtype=np.float16) -> None:
        """state: (rows, cols, size, size, C) channels-last tile grid,
        stored as ``dtype``; the manifest is written last."""
        rows, cols = state.shape[:2]
        meta = {"t": t, "rows": rows, "cols": cols, "hst": hst, "wst": wst,
                "size": size, "channels": int(state.shape[-1])}
        if self.fmt == "grid":
            root = self._root(t)
            root.mkdir(parents=True, exist_ok=True)
            arr = np.ascontiguousarray(state.astype(dtype))
            tmp = root / "state.tmp.npy"
            np.save(tmp, arr)
            tmp.replace(root / "state.npy")
            meta["crc32"] = {"state": zlib.crc32(arr.tobytes())}
        else:
            store = self.store_for(t).create()
            root = store.root
            sums = {}
            for r in range(rows):
                for c in range(cols):
                    h0, w0 = hst + r * size, wst + c * size
                    arr = np.ascontiguousarray(state[r, c].astype(dtype))
                    nm = tile_name(h0, h0 + size, w0, w0 + size)
                    store.write(nm, arr)
                    sums[nm] = zlib.crc32(arr.tobytes())
            meta["crc32"] = sums
        mtmp = root / "manifest.json.tmp"
        mtmp.write_text(json.dumps(meta))
        mtmp.replace(root / "manifest.json")

    def load_grid(self, t: int, *, verify: bool = True
                  ) -> Tuple[np.ndarray, dict]:
        """(state (rows, cols, size, size, C) float32, manifest) of the
        spill at ``t``; with ``verify`` each file's CRC32 is checked
        against the manifest and a mismatch raises ``IOError``."""
        root = self._root(t)
        meta = json.loads((root / "manifest.json").read_text())
        sums = meta.get("crc32", {})

        def checked(name: str, arr: np.ndarray) -> np.ndarray:
            if verify and name in sums:
                got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if got != sums[name]:
                    raise IOError(f"checkpoint {name} at t={t} is corrupted "
                                  f"(crc {got:#x} != manifest "
                                  f"{sums[name]:#x})")
            return arr

        if self.fmt == "grid":
            arr = checked("state", np.load(root / "state.npy"))
            return arr.astype(np.float32), meta
        store = self.store_for(t)
        rows, cols, size = meta["rows"], meta["cols"], meta["size"]
        state = np.zeros((rows, cols, size, size, meta["channels"]),
                         np.float32)
        for r in range(rows):
            for c in range(cols):
                h0 = meta["hst"] + r * size
                w0 = meta["wst"] + c * size
                nm = tile_name(h0, h0 + size, w0, w0 + size)
                state[r, c] = checked(nm, store.read(nm))
        return state, meta

    def _spills(self):
        """(t, directory) of every ``{base}_{t}`` directory."""
        for p in self.base.parent.glob(f"{self.base.name}_*"):
            try:
                yield int(p.name.rsplit("_", 1)[1]), p
            except ValueError:
                continue

    def latest(self) -> Optional[int]:
        """The largest t with a complete spill (its manifest written)."""
        done = [t for t, p in self._spills()
                if (p / "manifest.json").exists()]
        return max(done) if done else None

    def prune(self, keep_t: int) -> None:
        """Delete every spill but the one at ``keep_t`` (the reference
        deletes the previous epoch's directory once the next one is
        complete, test_brn.py:241-244, 270-273)."""
        for t, p in self._spills():
            if t != keep_t:
                shutil.rmtree(p)
