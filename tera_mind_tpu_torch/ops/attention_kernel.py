"""K2: windowed attention forward, ``softmax(q k^T * scale) v``.

Replaces the Pallas TPU kernel ``tera_mind_tpu/ops/attention_kernel.py``
(``fused_attention``, ``_attn_kernel``).  q, k, v are ``(B, N, D)`` with
batch, heads and the 2x2 spatial windows folded into B; on the flagship
path N is 128 or 32 and D is 256 or 512, in bf16.  The model's scale is
``1 / head_dim`` (not 1/sqrt), passed by the caller.

Every variant keeps the TPU kernel's rounding: f32 logits, the exact
softmax (max-subtract, exp, divide by the row sum), p rounded to v's dtype
after it is normalised, f32 accumulation of p.v, one rounding of the
output.  ``attention_variant`` picks the variant from dtype, shape and
alignment before the launch (``csrc/attention.cu`` holds the designs):

- ``tensor_core``: bf16 with D % 16 == 0, N <= 128, 16-byte aligned
  q, k, v, and ``tc_smem_bytes(N, D)`` within a block's 227 KB.  One block
  per batch index keeps q, k, v in shared memory as bf16, computes q.k^T
  and p.v with ``mma.sync`` on the tensor cores and the softmax in
  registers.  All three main-path shapes take it.
- ``cuda_core``: everything else (float32; bf16 with N > 128, D not a
  multiple of 16, or too large for shared memory).  Float arithmetic on
  CUDA cores, 16 query rows per block, logits in shared memory.
"""

from __future__ import annotations

import torch

from . import _build

MAX_N = 512
MAX_D = 512
TC_MAX_N = 128
SMEM_LIMIT = 232_448       # bytes of shared memory a block may use (H100)
VARIANTS = ("cuda_core", "tensor_core")   # csrc/attention.cu codes

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for name in VARIANTS:
        launches_by_variant[name] = 0


def tc_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the tensor-core variant (``tc_layout`` in
    csrc/attention.cu): q, k, v tiles of round16(N) rows of D + 8 bf16,
    and p (round16(N) rows of round16(N) + 8) over q when it fits."""
    np_ = (n + 15) // 16 * 16
    tile = np_ * (d + 8)
    p = np_ * (np_ + 8)
    return 2 * (3 * tile + (0 if p <= tile else p))


def attention_variant(n: int, d: int, dtype: torch.dtype,
                      aligned: bool) -> str:
    """The variant a CUDA call with these N, D, dtype and pointer
    alignment (all 16-byte aligned or not) launches."""
    if (dtype == torch.bfloat16 and aligned and n <= TC_MAX_N
            and d % 16 == 0 and d <= MAX_D
            and tc_smem_bytes(n, d) <= SMEM_LIMIT):
        return "tensor_core"
    return "cuda_core"


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 logits and softmax, p rounded to v's
    dtype, f32 accumulation of p.v, output in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors of shape (B, N, D) and one dtype.  Raises
    when autograd would need a backward (``_build.autograd_required``)."""
    global launches
    _build.refuse_autograd("window_attention", q, k, v)
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
    variant = attention_variant(
        n, d, q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v, o)))
    err = _build.lib().tmt_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, d,
        scale, code, VARIANTS.index(variant), _build.stream_ptr(q))
    _build.check(err, f"tmt_window_attention ({variant})")
    launches += 1
    launches_by_variant[variant] += 1
    return o


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """K2 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return attention_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    raise RuntimeError(f"window_attention: no path for device {q.device}")
