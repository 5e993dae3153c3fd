"""Parameter conversion into the port's modules.

``load_jax_params`` fills a port model from the JAX package's flax param
tree, given as nested dicts of numpy arrays (``{"params": {...}}`` or the
inner dict).  The port's module and parameter names are the flax names,
with ``kernel`` -> ``weight``:

- Dense kernels ``(in, out)`` become ``(out, in)``;
- Conv kernels ``(kz, kh, kw, in, out)`` become ``(out, in, kz, kh, kw)``.

The match is strict both ways: a flax leaf with no port parameter, a port
parameter with no flax leaf, or a shape mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def jax_to_torch_array(leaf: str, arr: np.ndarray) -> np.ndarray:
    """Re-layout one flax leaf for the port (``leaf`` is its last key)."""
    if leaf != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a flax param tree into ``model`` in place (each tensor keeps
    its device, dtype and memory format); returns ``model``."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    targets = dict(model.named_parameters())
    seen = set()
    for path, arr in flat.items():
        prefix, _, leaf = path.rpartition(".")
        name = "weight" if leaf == "kernel" else leaf
        name = f"{prefix}.{name}" if prefix else name
        if name not in targets:
            raise KeyError(f"flax leaf {path} has no port parameter {name}")
        val = np.ascontiguousarray(jax_to_torch_array(leaf, arr))
        dst = targets[name]
        if tuple(dst.shape) != val.shape:
            raise ValueError(f"{path}: flax {val.shape} vs port "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(val.astype(np.float32)))
        seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"port parameters without a flax leaf: {missing}")
    return model
