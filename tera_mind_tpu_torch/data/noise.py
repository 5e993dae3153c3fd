"""Deterministic per-tile initial noise.

Port of ``tera_mind_tpu/data/noise.py``: every tile's t=0 noise is drawn
from a seed that an LCG makes of its grid position (reference
utils/MBADataset_tst.py:11-14), so any worker regenerates a neighbour's
noise without communication.  Two backends, as in JAX:

- ``'torch'``: ``torch.randn`` on a CPU generator seeded by the LCG (the
  reference's own draw).  A CUDA generator would give other numbers, so
  the noise is drawn on the CPU and moved to the card by the caller.
- ``'jax'``: ``jax.random.normal(jax.random.PRNGKey(seed), shape,
  float32)`` rebuilt in numpy (:func:`jax_normal`): threefry-2x32 over a
  flat 64-bit counter, JAX's bits-to-uniform step, then ``sqrt(2)`` times
  XLA's float32 ``erf_inv`` (Giles' polynomial on XLA's ``log1p``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BACKENDS = ("torch", "jax")


def lcg(x: int, a: int = 1103515245, c: int = 12345, m: int = 2 ** 31) -> int:
    """glibc-style linear congruential step."""
    return (a * x + c) % m


def tile_seed(row: int, col: int, grid_w: int) -> int:
    return lcg(row * grid_w + col)


def tile_init_noise(row: int, col: int, grid_w: int,
                    shape: Tuple[int, ...], backend: str = "torch"
                    ) -> np.ndarray:
    """Initial N(0,1) state for tile (row, col); channels-last shape."""
    seed = tile_seed(row, col, grid_w)
    if backend == "torch":
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g).numpy()
    if backend == "jax":
        return jax_normal(seed, shape)
    raise ValueError(f"noise backend {backend!r}, expected one of "
                     f"{BACKENDS}")


def grid_init_noise_jax(rows: int, cols: int, grid_w: int,
                        tile_shape: Tuple[int, ...], *, row0: int = 0,
                        col0: int = 0) -> np.ndarray:
    """(rows, cols, *tile_shape) float32 ``'jax'`` noise of a block of
    tiles, tile (r, c) seeded from its ABSOLUTE grid position (row0 + r,
    col0 + c), as JAX's vmapped ``grid_init_noise_jax``."""
    out = np.empty((rows, cols) + tuple(tile_shape), np.float32)
    for r in range(rows):
        for c in range(cols):
            out[r, c] = tile_init_noise(row0 + r, col0 + c, grid_w,
                                        tile_shape, backend="jax")
    return out


# ---- jax.random.normal in numpy --------------------------------------------

_U32 = np.uint32
_F32 = np.float32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under key (k1, k2), uint32 arithmetic modulo 2^32 (JAX
    ``prng._threefry2x32_lowering``)."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def jax_random_bits(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(jax.random.PRNGKey(seed), shape, uint32)``.

    The key of a seed below 2^32 is (0, seed) (``threefry_seed``).  The
    bits follow JAX 0.9's default key derivation,
    ``jax_threefry_partitionable=True`` (``_threefry_random_bits_
    partitionable``): element i hashes the counter pair (i >> 32, i &
    0xffffffff) and keeps the XOR of the two output words.  The older
    mode (partitionable False) hashes a split counter array and gives
    other bits."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    a, b = threefry2x32(0, seed, hi, lo)
    return (a ^ b).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c with one rounding to float32 (XLA's CPU code contracts
    these into fused multiply-adds).  The product of two float32 values
    is exact in float64; the float64 sum's rounding then moves a result
    only where it lies within 2^-29 of a float32 rounding boundary."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


# XLA's float32 log: Cephes' logf (Eigen's plog), with its multiply-adds
# fused as XLA's CPU code fuses them
_LOG_P = [_F32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]


def _xla_log(x: np.ndarray) -> np.ndarray:
    x = np.maximum(x, _F32(1.17549435e-38)).astype(_F32)
    bits = x.view(np.int32)
    e = _F32(1) + ((bits >> 23) - 0x7F).astype(_F32)
    m = ((bits & ~0x7F800000) | np.int32(0x3F000000)).view(_F32)
    small = m < _F32(0.707106781186547524)
    m = (m - _F32(1)) + np.where(small, m, _F32(0))
    e = e - np.where(small, _F32(1), _F32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    m = (m - _F32(0.5) * x2) + y
    return m + _F32(0.693359375) * e


# XLA's float32 log1p: the Cephes rational approximation below
# sqrt(2) - 1, log(1 + x) above (ElementalIrEmitter::EmitLog1p)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1., 1.5062909083469192198422e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _xla_log1p(x: np.ndarray) -> np.ndarray:
    def poly(cs):
        p = np.zeros_like(x)
        for c in cs:
            p = _fma(p, x, _F32(c))
        return p
    x2 = x * x
    small = x + ((_F32(-0.5) * x2) + (x * x2) * (poly(_LOG1P_NUM)
                                                   / poly(_LOG1P_DEN)))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _xla_log(x + _F32(1)))


# Giles' single-precision erfinv, the coefficients of XLA's ErfInv32
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], _F32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], _F32)


def xla_erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (CHLO's ``erf_inv`` legalization)."""
    w = -_xla_log1p(x * -x)
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, np.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]))
    return np.where(np.abs(x) == _F32(1), x * _F32(np.inf), p * x)


def jax_normal(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``:
    the bits' top 23 as the mantissa of a float in [1, 2), minus 1, scaled
    to [nextafter(-1, 0), 1) (JAX ``_uniform``; the scale is exactly 2 in
    float32), then ``sqrt(2) * erf_inv(u)`` (``_normal_real``)."""
    bits = jax_random_bits(seed, tuple(shape))
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1)
    lo = np.nextafter(_F32(-1), _F32(0))
    u = np.maximum(lo, f * _F32(2) + lo)
    return (_F32(np.sqrt(2)) * xla_erf_inv(u)).astype(_F32)
