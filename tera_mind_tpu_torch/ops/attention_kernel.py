"""K2: windowed attention forward, ``softmax(q k^T * scale) v``.

Replaces the Pallas TPU kernel ``tera_mind_tpu/ops/attention_kernel.py``
(``fused_attention``, ``_attn_kernel``).  q, k, v are ``(B, N, D)`` with
batch, heads and the 2x2 spatial windows folded into B; on the flagship
path N is 128 or 32 and D is 256 or 512, in bf16.  The model's scale is
``1 / head_dim`` (not 1/sqrt), passed by the caller.

The TPU kernel keeps one batch index's q, k, v and N x N logits in VMEM,
which does not fit a Hopper block's 227 KB at N = 128, D = 256.  The CUDA
kernel (``csrc/attention.cu``) takes one batch index and 16 query rows per
block, stages K and V through shared memory in chunks of 64 rows, and
keeps the block's full rows of f32 logits on chip, so the softmax is the
TPU's exact two-pass form (max-subtract, normalise, then round p to v's
dtype) with no online rescaling.  It runs on CUDA cores, so it is bound by
operations (4*B*N*N*D) rather than by the bytes it moves.
"""

from __future__ import annotations

import torch

from . import _build

MAX_N = 512
MAX_D = 512

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 logits and softmax, p rounded to v's
    dtype, f32 accumulation of p.v, output in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors of shape (B, N, D) and one dtype."""
    global launches
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"window_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "equal (B, N, D)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("window_attention: q, k, v dtypes differ")
    b, n, d = q.shape
    if n > MAX_N or d > MAX_D:
        raise ValueError(f"window_attention: N={n}, D={d} above the "
                         f"kernel's limits N<={MAX_N}, D<={MAX_D}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    if b == 0:
        return o
    code = _build.dtype_code(q, "window_attention")
    err = _build.lib().tmt_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, d,
        scale, code, _build.stream_ptr(q))
    _build.check(err, "tmt_window_attention")
    launches += 1
    return o


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """K2 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return attention_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    raise RuntimeError(f"window_attention: no path for device {q.device}")
