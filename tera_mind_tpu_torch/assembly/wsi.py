"""WSI assembly: generated tile store -> pyramidal OME-BigTIFF per slice.

Port of ``tera_mind_tpu/assembly/wsi.py``.  A native C++ writer
(``cpp/wsi_tiff.cc``, the JAX package's file byte for byte) streams 256^2
tiles into a tiled pyramidal BigTIFF while Python walks the tile grid row
strip by row strip and builds the pyramid levels incrementally (2x box
downsample), so nothing holds a 73k x 106k px slice in memory.  Host code
only: numpy and the writer through ``ctypes``.

The writer is built at first use with ``g++ -O2 -shared -fPIC ... -lz
-ljpeg`` into ``tera_mind_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags; a failed build raises with
g++'s message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "cpp" / "wsi_tiff.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]
LINK_FLAGS = ["-lz", "-ljpeg"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib_path() -> Path:
    """The writer library's path: a hash of the source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libwsitiff_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the writer into its hashed .so (no-op if it exists),
    through a temporary file renamed into place."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SRC), *LINK_FLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        os.unlink(tmp)
        raise RuntimeError("g++ not found: the WSI writer builds with g++, "
                           "zlib and libjpeg") from None
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees a whole file
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.wsi_open.restype = ctypes.c_void_p
            lib.wsi_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint64, ctypes.c_uint32,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_char_p]
            lib.wsi_write_tile.restype = ctypes.c_int
            lib.wsi_write_tile.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_uint32, ctypes.c_uint32,
                                           ctypes.c_char_p]
            lib.wsi_close.restype = ctypes.c_int
            lib.wsi_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def ome_xml(width: int, height: int, channels: int = 1,
            dtype: str = "uint8") -> str:
    """Minimal OME metadata QuPath accepts (reference infer_brn.py:11-54)."""
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06"
    xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
    xsi:schemaLocation="http://www.openmicroscopy.org/Schemas/OME/2016-06 http://www.openmicroscopy.org/Schemas/OME/2016-06/ome.xsd">
    <Image ID="Image:0">
        <Pixels DimensionOrder="XYCZT"
                ID="Pixels:0"
                SizeC="{channels}"
                SizeT="1"
                SizeX="{width}"
                SizeY="{height}"
                SizeZ="1"
                Type="{dtype}">
        </Pixels>
    </Image>
</OME>"""


def pyramid_levels(width: int, height: int, tile: int = 256) -> int:
    """Levels of the full pyramid: halve (rounding up) until both sides
    fit in one tile."""
    levels, w, h = 1, width, height
    while max(w, h) > tile:
        w, h = (w + 1) // 2, (h + 1) // 2
        levels += 1
    return levels


class WsiWriter:
    """Streaming pyramidal BigTIFF writer (grayscale uint8, square tiles).

    Feed level 0 a row strip at a time (:meth:`write_row_strip`); each
    deeper level is the 2x box mean of the one above (an odd width repeats
    its last column), accumulated in a float32 strip of ``tile`` rows and
    written, clipped and truncated to uint8, whenever the strip fills and
    at :meth:`close`."""

    def __init__(self, path: str | Path, width: int, height: int, *,
                 tile: int = 256, levels: Optional[int] = None,
                 compression: str = "deflate", zlevel: int = 6,
                 quality: int = 90,
                 description: Optional[str] = None):
        self.tile = tile
        self.width, self.height = width, height
        self.levels = levels if levels is not None \
            else pyramid_levels(width, height, tile)
        comp = {"none": 1, "jpeg": 7, "deflate": 8}[compression]
        if compression == "jpeg":
            zlevel = quality  # the native writer reuses the level slot
        desc = description if description is not None \
            else ome_xml(width, height)
        self._h = _lib().wsi_open(str(path).encode(), width, height, tile,
                                  self.levels, comp, zlevel, desc.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        # per level: a strip accumulator, its filled rows, tile rows written
        self._strips = {lv: np.zeros((tile, self._level_w(lv)), np.float32)
                        for lv in range(1, self.levels)}
        self._strip_rows = dict.fromkeys(self._strips, 0)
        self._emitted = dict.fromkeys(self._strips, 0)

    def _level_w(self, lv: int) -> int:
        w = self.width
        for _ in range(lv):
            w = (w + 1) // 2
        return w

    def _level_h(self, lv: int) -> int:
        h = self.height
        for _ in range(lv):
            h = (h + 1) // 2
        return h

    def write_tile(self, tx: int, ty: int, data: np.ndarray,
                   level: int = 0) -> None:
        """One tile at column ``tx``, row ``ty`` of ``level``; a smaller
        array is zero-padded to the tile (a tile never written stays 0)."""
        data = np.ascontiguousarray(data, np.uint8)
        if data.shape != (self.tile, self.tile):
            padded = np.zeros((self.tile, self.tile), np.uint8)
            padded[:data.shape[0], :data.shape[1]] = data
            data = padded
        rc = _lib().wsi_write_tile(self._h, level, tx, ty,
                                   data.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise OSError(f"wsi_write_tile failed rc={rc}")

    def _write_row(self, lv: int, ty: int, u8: np.ndarray) -> None:
        t = self.tile
        for tx in range(0, (self._level_w(lv) + t - 1) // t):
            self.write_tile(tx, ty, u8[:, tx * t:(tx + 1) * t], level=lv)

    def write_row_strip(self, ty: int, strip: np.ndarray) -> None:
        """strip: (tile, width) uint8, one full row of level-0 tiles."""
        self._write_row(0, ty, strip)
        self._cascade(1, strip.astype(np.float32))

    def _emit(self, lv: int, rows: np.ndarray) -> None:
        """Write ``rows`` (float32, at most ``tile``) as level ``lv``'s
        next tile row and push them on into level ``lv + 1``."""
        self._write_row(lv, self._emitted[lv],
                        np.clip(rows, 0, 255).astype(np.uint8))
        self._emitted[lv] += 1
        self._cascade(lv + 1, rows.copy())

    def _cascade(self, lv: int, rows: np.ndarray) -> None:
        """Push level-(lv-1) rows into level lv's accumulator."""
        if lv >= self.levels:
            return
        h, w = rows.shape
        h2, w2 = h // 2, self._level_w(lv)
        we = w // 2 * 2
        ds = rows[: h2 * 2, :we].reshape(h2, 2, we // 2, 2).mean((1, 3))
        if ds.shape[1] < w2:  # odd width: replicate last column
            ds = np.concatenate([ds, ds[:, -1:]], axis=1)
        ds = ds[:, :w2]
        strip = self._strips[lv]
        r = self._strip_rows[lv]
        take = min(self.tile - r, ds.shape[0])
        strip[r: r + take] = ds[:take]
        self._strip_rows[lv] = r + take
        if self._strip_rows[lv] == self.tile:
            self._emit(lv, strip)
            self._strip_rows[lv] = 0
        if take < ds.shape[0]:  # leftover rows
            rest = ds[take:]
            strip[: rest.shape[0]] = rest
            self._strip_rows[lv] = rest.shape[0]

    def close(self) -> None:
        """Flush the partial strips (bottom edge) and write the IFDs."""
        for lv in range(1, self.levels):
            r = self._strip_rows[lv]
            if r > 0 and self._emitted[lv] * self.tile < self._level_h(lv):
                self._emit(lv, self._strips[lv][:r])
                self._strip_rows[lv] = 0
        rc = _lib().wsi_close(self._h)
        self._h = None
        if rc != 0:
            raise OSError(f"wsi_close failed rc={rc}")


def assemble_slice(read_tile: Callable[[int, int], np.ndarray],
                   out_path: str | Path, rows: int, cols: int, *,
                   tile: int = 256, channel: int = 0,
                   to_uint8: bool = True) -> None:
    """Assemble one z-slice WSI from a (rows x cols) tile grid.

    ``read_tile(r, c)`` -> (tile, tile) float in [-1, 1] or uint8 for the
    chosen slice channel; tiles are streamed row by row.  ``channel`` is
    unused, as in the JAX function (``read_tile`` picks the channel)."""
    writer = WsiWriter(out_path, cols * tile, rows * tile)
    for r in range(rows):
        strip = np.zeros((tile, cols * tile), np.uint8)
        for c in range(cols):
            d = read_tile(r, c)
            if to_uint8 and d.dtype != np.uint8:
                d = np.clip((d.astype(np.float32) + 1) * 127.5, 0,
                            255).astype(np.uint8)
            strip[:, c * tile:(c + 1) * tile] = d
        writer.write_row_strip(r, strip)
    writer.close()
