"""z-packed layout: the z axis folded into channels.

Port of ``tera_mind_tpu/ops/zpack.py``.  A ``(B, Z, H, W, C)`` voxel map
is carried as ``(B, H, W, Z*C)``, z-major (packed channel ``zi*C + c``).
A 3D conv over z with kernel kz and symmetric z padding is exactly a 2D
conv on the packed layout with a block-structured kernel: for output
plane zo, input plane zi contributes the 3D kernel's slice
``zi - zo + (kz - 1)//2`` (:func:`pack_conv3d_kernel`).  So the packed
model is a re-parameterization of the 5D one.

The parameter-time functions work on numpy arrays in flax's layouts
(kernels ``(kz, ky, kx, ci, co)`` -> ``(ky, kx, z*ci, z*co)``), as the
JAX package's do, so ``pack_unet_params`` maps flax-named trees one for
one.  The activation functions, and :func:`pack_conv3d_kernel_t` (the
``from_5d`` model's per-call kernel build, in the port's
``(out, in, ...)`` layout), work on tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def seg_perm(z: int, segments) -> np.ndarray:
    """Map segment-major packed channel indices to z-major ones.

    A plain concat of per-segment z-major packed tensors gives the
    segment-major layout ``z*off_s + zi*c_s + c``; the z-major layout of
    the same concatenated channels is ``zi*Ctot + off_s + c``.  Returns
    ``perm`` with ``new[n] = old[perm[n]]``: conv kernel input rows are
    reordered by it, so the runtime concats need no interleaving."""
    ctot = int(sum(segments))
    perm = np.empty(z * ctot, np.int64)
    n = 0
    off = 0
    for cs in segments:
        for zi in range(z):
            for c in range(cs):
                perm[n] = zi * ctot + off + c
                n += 1
        off += cs
    return perm


def pack_conv3d_kernel(w3, z: int, segments=None) -> np.ndarray:
    """(kz, ky, kx, ci, co) 3D kernel (z padding (kz-1)//2) ->
    (ky, kx, z*ci, z*co) packed 2D kernel.

    ``segments``: per-z channel counts of plainly concatenated z-major
    inputs; when given, the kernel's input rows are permuted to that
    segment-major runtime layout (:func:`seg_perm`)."""
    kz, ky, kx, ci, co = w3.shape
    pad = (kz - 1) // 2
    w2 = np.zeros((ky, kx, z * ci, z * co), w3.dtype)
    for zo in range(z):
        for zi in range(z):
            k = zi - zo + pad
            if 0 <= k < kz:
                w2[:, :, zi * ci:(zi + 1) * ci, zo * co:(zo + 1) * co] = \
                    np.asarray(w3[k])
    if segments is not None:
        assert int(sum(segments)) == ci, (segments, ci)
        w2 = w2[:, :, seg_perm(z, segments), :]
    return w2


def pack_conv3d_kernel_t(w3: torch.Tensor, z: int,
                         segments=None) -> torch.Tensor:
    """Tensor version of :func:`pack_conv3d_kernel` in the port's layout:
    (co, ci, kz, kh, kw) -> (z*co, z*ci, kh, kw), for a model whose
    parameter is the 3D kernel (``from_5d``).  Concats and one gather over
    kernel-sized tensors, on the kernel's device and dtype."""
    co, ci, kz = w3.shape[:3]
    pad = (kz - 1) // 2
    zero = torch.zeros_like(w3[:, :, 0])
    rows = []
    for zo in range(z):
        cols = [w3[:, :, zi - zo + pad] if 0 <= zi - zo + pad < kz
                else zero for zi in range(z)]
        rows.append(torch.cat(cols, dim=1))           # (co, z*ci, kh, kw)
    w2 = torch.cat(rows, dim=0)                       # (z*co, z*ci, kh, kw)
    if segments is not None:
        assert int(sum(segments)) == ci, (segments, ci)
        w2 = w2[:, torch.from_numpy(seg_perm(z, segments)).to(w2.device)]
    return w2


def pack_conv3d_bias(b, z: int) -> np.ndarray:
    """(co,) -> (z*co,): the same bias on every z plane."""
    return np.tile(np.asarray(b), z)


def pack_channel_param(p, z: int, segments=None) -> np.ndarray:
    """Per-channel vector (C,) (a norm weight) -> (z*C,) tiled.

    With ``segments`` the output follows the segment-major layout of a
    plain concat (each segment's C-slice tiled z times, segments
    concatenated)."""
    p = np.asarray(p)
    if segments is None:
        return np.tile(p, z)
    out, off = [], 0
    for cs in segments:
        out.append(np.tile(p[off:off + cs], z))
        off += cs
    assert off == p.shape[0], (segments, p.shape)
    return np.concatenate(out)


def pack_features(x: torch.Tensor, z: int) -> torch.Tensor:
    """(B, Z, H, W, C) -> (B, H, W, Z*C), z-major channels."""
    b, zz, h, w, c = x.shape
    assert zz == z, (x.shape, z)
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, z * c)


def unpack_features(x: torch.Tensor, z: int) -> torch.Tensor:
    """Inverse of :func:`pack_features`: (B, H, W, Z*C) -> (B, Z, H, W, C)."""
    b, h, w, zc = x.shape
    return x.reshape(b, h, w, z, zc // z).permute(0, 3, 1, 2, 4)


def pixel_to_packed(x: torch.Tensor, z: int) -> torch.Tensor:
    """(B, H, W, S*Z) stain-major pixel channels (c = s*z + zi) ->
    z-major packed (B, H, W, Z*S)."""
    b, h, w, sz = x.shape
    x = x.reshape(b, h, w, sz // z, z)
    return x.transpose(3, 4).reshape(b, h, w, sz)


def packed_to_pixel(x: torch.Tensor, z: int) -> torch.Tensor:
    """Inverse of :func:`pixel_to_packed`."""
    b, h, w, zs = x.shape
    x = x.reshape(b, h, w, z, zs // z)
    return x.transpose(3, 4).reshape(b, h, w, zs)
