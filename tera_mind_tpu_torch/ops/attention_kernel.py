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

K2b, the backward (``csrc/attention_bwd.cu``), replaces the TPU kernel's
``custom_vjp`` rule ``_bwd``: p recomputed in float32 and never rounded,
float32 sums, one rounding of dq, dk, dv; a dq pass over query tiles
that also writes each row's softmax statistics, then a dk/dv pass over
key tiles, each dk and dv row summed inside one block (deterministic).
``window_attention`` dispatches as ``rmsnorm`` does: the raw K2 launch
without a gradient to record, :class:`AttentionFunction` (K2 and K2b, or
the plain versions on the CPU) with one.
"""

from __future__ import annotations

import sys

import torch

from . import _build

MAX_N = 512
MAX_D = 512
TC_MAX_N = 128
SMEM_LIMIT = 232_448       # bytes of shared memory a block may use (H100)
VARIANTS = ("cuda_core", "tensor_core")   # csrc/attention.cu codes

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_variant = dict.fromkeys(VARIANTS, 0)
bwd = _build.Counters(("cuda_core",))   # K2b's launches


def reset_launches() -> None:
    """Set K2's and K2b's launch counters to 0."""
    _build.reset_launches(sys.modules[__name__])
    _build.reset_launches(bwd)


def _calc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


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
    f = _calc_dtype(q.dtype)
    logits = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.to(f), v.to(f)).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2b, the JAX rule ``_bwd`` term for term:
    (dq, dk, dv) in the inputs' dtypes, computed in float32 with p
    recomputed and not rounded."""
    f = _calc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(f) for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be equal (B, N, D)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    _, n, d = q.shape
    if n > MAX_N or d > MAX_D:
        raise ValueError(f"{name}: N={n}, D={d} above the kernel's limits "
                         f"N<={MAX_N}, D<={MAX_D}")


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors of shape (B, N, D) and one dtype.  Raises
    when autograd would need a backward (``_build.autograd_required``)."""
    _build.refuse_autograd("window_attention", q, k, v)
    _check_qkv("window_attention", q, k, v)
    b, n, d = q.shape
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
    _build.count_launch(sys.modules[__name__], variant)
    return o


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2b on CUDA tensors of shape (B, N, D) and one dtype:
    (dq, dk, dv).  g, which reaches the backward through the window
    fold's reshapes and transposes, is made contiguous first."""
    _check_qkv("window_attention_bwd", q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"window_attention_bwd: g {tuple(g.shape)} "
                         f"{g.dtype} is not q's {tuple(q.shape)} {q.dtype}")
    b, n, d = q.shape
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if b == 0:
        return dq, dk, dv
    stats = torch.empty(b, n, 3, device=q.device, dtype=torch.float32)
    err = _build.lib().tmt_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, n, d, scale, _build.dtype_code(q, "window_attention_bwd"),
        _build.stream_ptr(q))
    _build.check(err, "tmt_window_attention_bwd")
    _build.count_launch(bwd, "cuda_core")
    return dq, dk, dv


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"window_attention: no path for device {q.device}")
    return q.device.type


class AttentionFunction(torch.autograd.Function):
    """K2 forward and K2b backward on CUDA tensors; the plain forward and
    the plain ``_bwd`` formula on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if _device_type(q) == "cuda":
            return attention_cuda(q, k, v, scale)
        return attention_plain(q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bwd_fn = attention_bwd_cuda if q.device.type == "cuda" \
            else attention_bwd_plain
        grads = bwd_fn(q, k, v, g.to(q.dtype), ctx.scale)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """K2 for CUDA tensors, the plain version for CPU tensors; through
    :class:`AttentionFunction` (K2b or the plain backward) when autograd
    has a gradient to record."""
    dev = _device_type(q)
    if _build.autograd_required(q, k, v):
        return AttentionFunction.apply(q, k, v, scale)
    if dev == "cuda":
        return attention_cuda(q, k, v, scale)
    return attention_plain(q, k, v, scale)
