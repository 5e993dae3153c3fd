"""K1: RMSNorm forward, y = x * rsqrt(mean(x^2, -1) + eps) * w.

Replaces the Pallas TPU kernel ``tera_mind_tpu/ops/rmsnorm_kernel.py``
(``rmsnorm_fused``, ``_kernel``).  On Hopper it is bound by memory: one
read and one write of ``rows * C`` elements.  ``rmsnorm_variant`` picks
one of two CUDA kernels (``csrc/rmsnorm.cu``) from C, dtype and pointer
alignment before the launch:

- ``vector``: C % 8 == 0, a row of at most 2,048 bytes (C <= 1024 in bf16,
  512 in float32), and x, w, y 16-byte aligned.  A group of lanes sized to
  C holds the row in registers from 16-byte loads, reduces it with warp
  shuffles and writes y from the same registers.
- ``strided``: any other C (741 and 1,253 on the main path) or pointer;
  one warp per row with a strided loop.

Any row count works, so the TPU kernel's fallback for rows that do not
block has no counterpart: a CUDA tensor always goes through a kernel.

Statistics are float32.  For bf16 the rounding follows the TPU kernel
(inv and w cast to bf16 before the two multiplies); for float32 the
result is ``w * (x * inv)``, the JAX package's f32 formula.
"""

from __future__ import annotations

import torch

from . import _build

VEC_MAX_ROW_BYTES = 2048   # csrc/rmsnorm.cu kVecMaxBytes
VARIANTS = ("strided", "vector")   # csrc/rmsnorm.cu codes

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for name in VARIANTS:
        launches_by_variant[name] = 0


def rmsnorm_variant(c: int, itemsize: int, aligned: bool) -> str:
    """The variant a CUDA call with rows of C elements of ``itemsize``
    bytes launches; ``aligned``: x, w and y all start on 16 bytes."""
    if aligned and c % 8 == 0 and c * itemsize <= VEC_MAX_ROW_BYTES:
        return "vector"
    return "strided"


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's check."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    if x.dtype == torch.float32:
        return weight * (x * inv)
    return weight.to(x.dtype) * (x * inv.to(x.dtype))


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch K1 on a CUDA tensor (weight is cast to x's dtype).  Raises
    when autograd would need a backward (``_build.autograd_required``)."""
    global launches
    _build.refuse_autograd("rmsnorm", x, weight)
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    w = weight.to(device=x.device, dtype=x.dtype).contiguous()
    if w.shape != (c,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} != ({c},)")
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    code = _build.dtype_code(x, "rmsnorm")
    variant = rmsnorm_variant(
        c, x.element_size(), all(t.data_ptr() % 16 == 0 for t in (x2, w, y)))
    err = _build.lib().tmt_rmsnorm(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                                   x2.shape[0], c, eps, code,
                                   VARIANTS.index(variant),
                                   _build.stream_ptr(x))
    _build.check(err, f"tmt_rmsnorm ({variant})")
    launches += 1
    launches_by_variant[variant] += 1
    return y.reshape(x.shape)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, weight, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    raise RuntimeError(f"rmsnorm: no path for device {x.device}")
