"""Attention blocks: DiT-style adaLN image->gene cross-attention with 2x2
spatial windowing, and the symmetric gene-gene attention block.

Port of ``tera_mind_tpu/models/attention.py`` (both token orders).
Logits are ``(q . k) / d``, NOT ``/ sqrt(d)`` (the reference's scaling
quirk).  The windowed cross-attention runs K2
(``ops/attention_kernel``) on CUDA tensors; the DiT block's adaLN
modulate runs as K1's epilogue (``ops/rmsnorm_kernel.rmsnorm_modulate``)
and its gated residual as K7 (``ops/gated_residual_kernel``) where no
gradient is recorded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import window_attention
from ..ops.gated_residual_kernel import gated_residual
from ..ops.rmsnorm_kernel import rmsnorm_modulate
from .nn import Conv3d, Dense, Mlp, RMSNorm


def _window_fold(t: torch.Tensor, z: int, n_win: int,
                 order: str = "zhw") -> torch.Tensor:
    """(B, heads, n, d) -> (B, heads*n_win^2, z*(h/n)*(w/n), d), windows
    head-major.  ``order`` is the incoming token order: 'zhw' (5D layout,
    token (zi*h + hr)*w + wc) or 'hwz' (z-packed layout, token
    (hr*w + wc)*z + zi, a reshape of the z-major packed channels); tokens
    keep that order inside a window."""
    b, nh, n, d = t.shape
    s = int(round((n // z) ** 0.5))
    hw = s // n_win
    if order == "hwz":
        t = t.reshape(b, nh, n_win, hw, n_win, hw, z, d)
        t = t.permute(0, 1, 2, 4, 3, 5, 6, 7)  # b nh n_h n_w h w z d
    else:
        t = t.reshape(b, nh, z, n_win, hw, n_win, hw, d)
        t = t.permute(0, 1, 3, 5, 2, 4, 6, 7)  # b nh n_h n_w z h w d
    return t.reshape(b, nh * n_win * n_win, z * hw * hw, d)


def _window_unfold(t: torch.Tensor, z: int, n_win: int, num_heads: int,
                   order: str = "zhw") -> torch.Tensor:
    """Inverse of :func:`_window_fold`."""
    b, nhw, n, d = t.shape
    hw = int(round((n // z) ** 0.5))
    if order == "hwz":
        t = t.reshape(b, num_heads, n_win, n_win, hw, hw, z, d)
        t = t.permute(0, 1, 2, 4, 3, 5, 6, 7)  # b nh n_h h n_w w z d
    else:
        t = t.reshape(b, num_heads, n_win, n_win, z, hw, hw, d)
        t = t.permute(0, 1, 4, 2, 5, 3, 6, 7)  # b nh z n_h h n_w w d
    return t.reshape(b, num_heads, z * (n_win * hw) ** 2, d)


class CrossAttention(nn.Module):
    """Multi-head (optionally windowed) cross-attention, q from x, k/v
    from y (self-attention when y is None), per-head RMS-normed q and k.
    ``token_order`` is the order of the n tokens ('zhw' or, from the
    z-packed layout, 'hwz'; see :func:`_window_fold`)."""

    def __init__(self, dim: int, num_heads: int = 1,
                 n_win: Optional[int] = None, token_order: str = "zhw", *,
                 quant: Optional[str] = None, prequant: bool = False,
                 static_act: bool = False):
        super().__init__()
        from ..ops.quant import dense
        if token_order not in ("zhw", "hwz"):
            raise ValueError(f"token_order {token_order!r}")
        self.dim, self.num_heads, self.n_win = dim, num_heads, n_win
        self.token_order = token_order
        hd = dim // num_heads
        self.q, self.k, self.v, self.proj = (
            dense(dim, dim, quant, prequant, static_act) for _ in range(4))
        self.q_norm = RMSNorm(hd)
        self.k_norm = RMSNorm(hd)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor],
                z_size: int) -> torch.Tensor:
        b, n, _ = x.shape
        nh = self.num_heads
        hd = self.dim // nh
        src = x if y is None else y

        def heads(t):
            t = t.reshape(b, n, nh, hd).transpose(1, 2)
            if self.n_win is not None:
                t = _window_fold(t, z_size, self.n_win, self.token_order)
            return t

        q = self.q_norm(heads(self.q(x)))
        k = self.k_norm(heads(self.k(src)))
        v = heads(self.v(src))
        bh, nt = q.shape[0] * q.shape[1], q.shape[2]
        out = window_attention(q.reshape(bh, nt, hd), k.reshape(bh, nt, hd),
                               v.reshape(bh, nt, hd), 1.0 / hd)
        out = out.reshape(q.shape)
        if self.n_win is not None:
            out = _window_unfold(out, z_size, self.n_win, nh,
                                 self.token_order)
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out)


class DiTBlock(nn.Module):
    """adaLN-zero DiT block with 7-way modulation and gene cross-attention
    within 2x2 spatial windows.  ``cond_channels`` is the width of the
    per-token conditioning (the RNA feature map).

    ``packed_tokens``: x and cond are z-major packed ``(B, H, W, Z*C)``
    (``ops/zpack.py``) and ``z_size`` is given; tokens then flatten in
    (h, w, z) order by a reshape alone.  Same parameters; outputs equal the
    5D order's up to float reassociation in the attention sums.

    ``quant='int8'`` runs adaLN, q, k, v, proj, fc1 and fc2 as
    ``QuantDense`` (``prequant``, ``static_act`` as there); the logits,
    the value product and the norms stay in the compute dtype.

    Each sub-layer reads ``norm(xt) * (scale + 1.0) + shift`` through
    :func:`rmsnorm_modulate` and ends in ``xt + gate * out`` through
    :func:`gated_residual`: on a CUDA tensor with no gradient to record
    one K1 launch with the modulate and one K7 launch, elsewhere the eager
    sequence (the same bits on the card)."""

    def __init__(self, hidden_size: int, cond_channels: int,
                 num_heads: int = 1, n_win: Optional[int] = 2,
                 mlp_ratio: float = 4.0, packed_tokens: bool = False, *,
                 quant: Optional[str] = None, prequant: bool = False,
                 static_act: bool = False):
        super().__init__()
        from ..ops.quant import dense
        c = hidden_size
        q = dict(quant=quant, prequant=prequant, static_act=static_act)
        self.hidden_size = c
        self.packed_tokens = packed_tokens
        self.adaLN = dense(cond_channels, 7 * c, **q)
        self.norm1 = RMSNorm(c)
        self.norm2 = RMSNorm(c)
        self.attn = CrossAttention(c, num_heads, n_win,
                                   "hwz" if packed_tokens else "zhw", **q)
        self.mlp = Mlp(c, int(c * mlp_ratio), **q)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                z_size: Optional[int] = None) -> torch.Tensor:
        c = self.hidden_size
        if self.packed_tokens:
            b, h, w, zc = x.shape
            z = z_size
            assert z is not None and zc == z * c, (x.shape, z, c)
            xt = x.reshape(b, h * w * z, c)
            ct = cond.reshape(b, h * w * z, cond.shape[-1] // z)
        else:
            b, z, h, w, _ = x.shape
            assert x.shape[-1] == c, (x.shape, c)
            xt = x.reshape(b, z * h * w, c)
            ct = cond.reshape(b, z * h * w, cond.shape[-1])
        (shift_msa, scale_msa, gate_msa, crss_cnd,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN(F.silu(ct)).chunk(7, -1)
        h = rmsnorm_modulate(xt, self.norm1.weight, scale_msa, shift_msa,
                             self.norm1.eps)
        xt = gated_residual(xt, gate_msa, self.attn(h, crss_cnd, z))
        h = rmsnorm_modulate(xt, self.norm2.weight, scale_mlp, shift_mlp,
                             self.norm2.eps)
        xt = gated_residual(xt, gate_mlp, self.mlp(h))
        return xt.reshape(x.shape)


# z-collapse conv kernel size per RNA z depth (reference MBAblocks.py:472).
DOWN_Z_KERNEL = {1: 1, 4: 3, 8: 5, 16: 9}


class GeneGeneBlock(nn.Module):
    """Symmetric gene-gene self-attention over gene tokens + z-collapse conv.

    Input (B, Z, H, W, G): tokens are the G genes, each with a
    D = Z*H*W-dimensional feature.  k IS q (shared projection and q-norm);
    the MLP output replaces the attention output; ``down_z`` collapses z
    with a valid conv.  The G x G attention stays a plain matmul (a plain
    einsum in the JAX package too).  Returns (features, attn or None)."""

    def __init__(self, hidden_size: int, z_size: int, genes: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        d = hidden_size
        self.hidden_size, self.z_size = d, z_size
        self.q = Dense(d, d)
        self.v = Dense(d, d)
        self.q_norm = RMSNorm(d)
        self.proj = Dense(d, d)
        self.norm2 = RMSNorm(d)
        self.mlp = Mlp(d, int(d * mlp_ratio))
        ker = DOWN_Z_KERNEL[z_size]
        self.down_z = Conv3d(genes, genes, (ker, 3, 3), padding=(0, 1, 1))

    def _tokens(self, rna: torch.Tensor) -> torch.Tensor:
        """(B, Z, H, W, G) -> the (B, G, D) gene tokens."""
        b, z, h, w, g = rna.shape
        d = z * h * w
        assert d == self.hidden_size, (d, self.hidden_size)
        return rna.reshape(b, d, g).transpose(1, 2)

    def attention(self, rna: torch.Tensor) -> torch.Tensor:
        """The (B, 1, G, G) float32 attention alone: ``q`` -> ``q_norm``
        (K1 on a CUDA tensor) -> ``qn qn^T / D`` -> softmax.  What the
        gene-gene extraction (``models/unet_attn.py``) reads; the JAX
        extractor's jit drops the rest of the block as dead code."""
        x = self._tokens(rna)
        qn = self.q_norm(self.q(x)[:, None]).float()      # (B, 1, G, D)
        logits = torch.matmul(qn, qn.transpose(-1, -2)) / x.shape[-1]
        return torch.softmax(logits, dim=-1)

    def forward(self, rna: torch.Tensor, *, return_attn: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, z, h, w, g = rna.shape
        attn = self.attention(rna)
        v = self.v(self._tokens(rna))
        out = torch.matmul(attn.to(v.dtype), v[:, None])[:, 0]
        out = self.mlp(self.norm2(self.proj(out)))
        out = out.transpose(1, 2).reshape(b, z, h, w, g)
        return self.down_z(out), (attn if return_attn else None)
