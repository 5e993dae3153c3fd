"""RNA tower: binned gene grids -> multiscale conditioning features.

Port of ``tera_mind_tpu/models/rna.py``.  Stage 0 is a gene-gene attention
block (z-collapse conv inside); stages 1-3 are SiLU + Conv3d(1,3,3)
chains, with a 2x spatial upsample after every stage, producing channels
(rna_num, 128, 64, 32) at the four UNet resolutions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import M2H
from .attention import GeneGeneBlock
from .nn import Conv3d, upsample_2x


def rna_grid_from_dense(rna_dense: torch.Tensor, z_rna: int,
                        rna_num: int) -> torch.Tensor:
    """(B, gh, gw, Z*G) z-major gene channels -> (B, Z, gh, gw, G').

    If the model's panel is smaller than the data's, keep the M2H genes
    (81-gene human transfer) or the first ``rna_num`` genes (229-plex mice
    carried in 500-gene arrays)."""
    b, gh, gw, zg = rna_dense.shape
    g = zg // z_rna
    x = rna_dense.reshape(b, gh, gw, z_rna, g).permute(0, 3, 1, 2, 4)
    if rna_num != g:
        if rna_num == len(M2H):
            x = x[..., torch.as_tensor(M2H, device=x.device)]
        else:
            x = x[..., :rna_num]
    return x


RNA_CHANNELS = (128, 64, 32)  # stages 1-3 (reference unet_ours.py:278-279)


class RNATower(nn.Module):
    """Four-stage conditioning tower; ``forward`` returns
    (feats, pres, attn) with ``feats[i] == upsample_2x(pres[i])``."""

    def __init__(self, rna_num: int, z_rna: int, gn_sz: int):
        super().__init__()
        self.gene_attn = GeneGeneBlock(gn_sz * gn_sz * z_rna, z_rna, rna_num)
        och = (rna_num,) + RNA_CHANNELS
        for rid in range(1, 4):
            self.add_module(f"conv_{rid}",
                            Conv3d(och[rid - 1], och[rid], (1, 3, 3)))

    def forward(self, rna_grid: torch.Tensor, *, return_attn: bool = False
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           Optional[torch.Tensor]]:
        h, attn = self.gene_attn(rna_grid, return_attn=return_attn)
        pres = [h]
        h = upsample_2x(h)
        feats = [h]
        for rid in range(1, 4):
            h = getattr(self, f"conv_{rid}")(F.silu(h))
            pres.append(h)
            h = upsample_2x(h)
            feats.append(h)
        return feats, pres, attn
