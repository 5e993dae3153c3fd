"""K1: RMSNorm forward, y = x * rsqrt(mean(x^2, -1) + eps) * w.

Replaces the Pallas TPU kernel ``tera_mind_tpu/ops/rmsnorm_kernel.py``
(``rmsnorm_fused``, ``_kernel``).  On Hopper it is bound by memory: one
read and one write of ``rows * C`` elements.  The CUDA kernel
(``csrc/rmsnorm.cu``) gives each row one warp, so any row count and any C
work (C here runs from 64 to 1253, e.g. 741 = 512 + 229) and the TPU
kernel's fallback for rows that do not block has no counterpart: a CUDA
tensor always goes through the kernel.

Statistics are float32.  For bf16 the rounding follows the TPU kernel
(inv and w cast to bf16 before the two multiplies); for float32 the
result is ``w * (x * inv)``, the JAX package's f32 formula.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


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
    """Launch K1 on a CUDA tensor (weight is cast to x's dtype)."""
    global launches
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
    err = _build.lib().tmt_rmsnorm(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                                   x2.shape[0], c, eps, code,
                                   _build.stream_ptr(x))
    _build.check(err, "tmt_rmsnorm")
    launches += 1
    return y.reshape(x.shape)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, weight, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    raise RuntimeError(f"rmsnorm: no path for device {x.device}")
