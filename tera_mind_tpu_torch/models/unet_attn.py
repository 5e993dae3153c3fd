"""Gene-gene attention extraction (``method='ours_vis'``).

Port of ``tera_mind_tpu/models/unet_attn.py``.  Runs only the trained
gene-gene attention block of the RNA tower and returns the raw G x G
attention matrices for pathway analysis, for the sliding z-pairs plus the
full z ensemble (reference model/unet_attn.py:137-173).

The block's parameters keep the trained UNet's names under
``rna_tower.gene_attn``: :func:`extractor_state_from_unet` slices them out
of a port model (or its named state), :func:`extractor_params_from_unet`
out of a flax-named tree (``convert.load_jax_params`` then fills the
extractor).  The extractor computes in float32, as the JAX CLI's does, and
reads only :meth:`GeneGeneBlock.attention`: K1 (the q-norm) is the one
kernel it launches on the card.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

from .attention import GeneGeneBlock
from .rna import rna_grid_from_dense

UNET_PREFIX = "rna_tower.gene_attn."


class GeneAttnExtractor(nn.Module):
    """``forward(rna_dense)`` -> (attn_stack, rna_core).

    attn_stack: (z_rna, B, G, G): the gene-gene attention of each sliding
      z-pair [i, i+2) (the other slices zeroed), then of all z slices.
    rna_core: (B, Z-2, gh, gw, G): the gene grid minus its boundary slices.
    """

    def __init__(self, rna_num: int, z_rna: int, gn_sz: int):
        super().__init__()
        self.rna_num, self.z_rna = rna_num, z_rna
        self.gene_attn = GeneGeneBlock(gn_sz * gn_sz * z_rna, z_rna, rna_num)

    def forward(self, rna_dense: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        rna_h = rna_grid_from_dense(rna_dense.float(), self.z_rna,
                                    self.rna_num)
        attns = []
        for i in range(self.z_rna - 1):
            masked = torch.zeros_like(rna_h)
            masked[:, i:i + 2] = rna_h[:, i:i + 2]
            attns.append(self.gene_attn.attention(masked)[:, 0])
        attns.append(self.gene_attn.attention(rna_h)[:, 0])
        return torch.stack(attns), rna_h[:, 1:-1]


def extractor_state_from_unet(
        unet: Union[nn.Module, Mapping[str, torch.Tensor]]
) -> Dict[str, torch.Tensor]:
    """The extractor's state dict out of a trained UNet (a ``TeraUNet`` or
    ``PackedTeraUNet``, or a mapping of its parameter names to tensors):
    ``rna_tower.gene_attn.*`` renamed ``gene_attn.*``."""
    named = unet.state_dict() if isinstance(unet, nn.Module) else unet
    out = {"gene_attn." + k[len(UNET_PREFIX):]: v for k, v in named.items()
           if k.startswith(UNET_PREFIX)}
    if not out:
        raise KeyError(f"no {UNET_PREFIX}* parameters in the UNet state")
    return out


def extractor_params_from_unet(unet_params: Mapping) -> dict:
    """Slice a flax-named TeraUNet tree down to the extractor's tree (the
    JAX function of the same name)."""
    p = unet_params["params"] if "params" in unet_params else unet_params
    return {"params": {"gene_attn": p["rna_tower"]["gene_attn"]}}
