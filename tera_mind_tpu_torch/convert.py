"""Parameter conversion into and out of the port's modules.

``load_jax_params`` fills a port model from a flax-named param tree, given
as nested dicts of numpy arrays (``{"params": {...}}`` or the inner
dict); ``export_params`` is its exact inverse.  The port's module and
parameter names are the flax names, with ``kernel`` -> ``weight``:

- Dense kernels ``(in, out)`` become ``(out, in)``;
- 2D conv kernels ``(kh, kw, in, out)`` become ``(out, in, kh, kw)``;
- 3D conv kernels ``(kz, kh, kw, in, out)`` become ``(out, in, kz, kh, kw)``.

The match is strict both ways: a flax leaf with no port parameter, a port
parameter with no flax leaf, or a shape mismatch raises.

``load_torch_state_dict`` and ``convert_unet_params`` (port of
``tera_mind_tpu/convert.py``) turn the reference's Lightning ``.ckpt``
(keys like ``model.input_blocks.3.0.in_layers.2.weight``) into the 5D
``TeraUNet`` flax-named tree, in numpy:

- Linear ``(out, in)`` -> Dense kernel ``(in, out)``;
- Conv3d ``(O, I, kz, kh, kw)`` -> conv kernel ``(kz, kh, kw, I, O)``;
- RMSNorm ``(1, C, 1, 1)`` or ``(C,)`` -> ``(C,)``.
"""

from __future__ import annotations

from pathlib import Path
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
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def torch_to_jax_array(arr: np.ndarray) -> tuple[str, np.ndarray]:
    """Inverse of :func:`jax_to_torch_array` for a port ``weight``: (flax
    leaf name, array).  Kernels are the weights of rank 2 or more; norm
    weights (rank 1) keep their name."""
    if arr.ndim == 1:
        return "weight", arr
    if arr.ndim == 2:
        return "kernel", arr.T
    if arr.ndim == 4:
        return "kernel", arr.transpose(2, 3, 1, 0)
    if arr.ndim == 5:
        return "kernel", arr.transpose(2, 3, 4, 1, 0)
    raise ValueError(f"unexpected weight rank {arr.ndim}")


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


@torch.no_grad()
def export_params(model: nn.Module) -> Dict:
    """The flax-named tree ``{"params": {...}}`` of ``model``'s parameters
    as float32 numpy arrays: the exact inverse of :func:`load_jax_params`
    (bf16 values widen to float32 without change)."""
    out: Dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        arr = p.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf, arr = torch_to_jax_array(arr)
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": out}


# --------------------------------------------------------------------- #
# reference Lightning checkpoints                                        #
# --------------------------------------------------------------------- #
def _lin(sd, name):
    return {"kernel": sd[f"{name}.weight"].T.copy(),
            "bias": sd[f"{name}.bias"].copy()}


def _conv(sd, name):
    w = sd[f"{name}.weight"]
    return {"kernel": np.transpose(w, (2, 3, 4, 1, 0)).copy(),
            "bias": sd[f"{name}.bias"].copy()}


def _norm(sd, name):
    return {"weight": sd[f"{name}.weight"].reshape(-1).copy()}


def _resblock(sd, pfx) -> Dict:
    out = {
        "in_norm": _norm(sd, f"{pfx}.in_layers.0"),
        "in_conv": _conv(sd, f"{pfx}.in_layers.2"),
        "emb_proj": _lin(sd, f"{pfx}.emb_layers.1"),
        "out_norm": _norm(sd, f"{pfx}.out_layers.0"),
        "out_conv": _conv(sd, f"{pfx}.out_layers.3"),
    }
    if f"{pfx}.skip_connection.weight" in sd:
        out["skip_conv"] = _conv(sd, f"{pfx}.skip_connection")
    return out


def _attn_common(sd, pfx) -> Dict:
    return {
        "q": _lin(sd, f"{pfx}.attn.q"),
        "v": _lin(sd, f"{pfx}.attn.v"),
        "proj": _lin(sd, f"{pfx}.attn.proj"),
        "q_norm": _norm(sd, f"{pfx}.attn.q_norm"),
    }


def _dit_block(sd, pfx) -> Dict:
    attn = _attn_common(sd, pfx)
    attn["k"] = _lin(sd, f"{pfx}.attn.k")
    attn["k_norm"] = _norm(sd, f"{pfx}.attn.k_norm")
    return {
        "attn": attn,
        "norm1": _norm(sd, f"{pfx}.norm1"),
        "norm2": _norm(sd, f"{pfx}.norm2"),
        "mlp": {"fc1": _lin(sd, f"{pfx}.mlp.fc1"),
                "fc2": _lin(sd, f"{pfx}.mlp.fc2")},
        "adaLN": _lin(sd, f"{pfx}.adaLN_modulation.1"),
    }


def _gene_block(sd, pfx) -> Dict:
    return {
        **_attn_common(sd, pfx),
        "norm2": _norm(sd, f"{pfx}.norm2"),
        "mlp": {"fc1": _lin(sd, f"{pfx}.mlp.fc1"),
                "fc2": _lin(sd, f"{pfx}.mlp.fc2")},
        "down_z": _conv(sd, f"{pfx}.down_z"),
    }


def load_torch_state_dict(path: str | Path) -> Dict[str, np.ndarray]:
    """Load a reference Lightning ``.ckpt`` (its ``state_dict``, or a bare
    state dict) as numpy arrays, with the ``model.`` prefix stripped and
    the ``ema_model`` keys dropped.  A Lightning checkpoint pickles more
    than tensors, so it is unpickled in full: load only trusted files."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state["state_dict"] if "state_dict" in state else state
    out = {}
    for k, v in sd.items():
        if "ema_model" in k:
            continue
        out[k.removeprefix("model.")] = v.detach().cpu().numpy()
    return out


def convert_unet_params(sd: Dict[str, np.ndarray], conf) -> Dict:
    """The 5D TeraUNet flax-named tree of a reference state dict;
    ``conf`` is the model's ``TeraUNetConfig``."""
    nrb = conf.num_res_blocks
    nlvl = len(conf.channel_mult)
    p: Dict = {}

    # time embed (no position half in the ported preset)
    p["time_embed"] = {"time_0": _lin(sd, "time_embed.time_embed.0"),
                       "time_2": _lin(sd, "time_embed.time_embed.2")}

    # RNA tower
    tower: Dict = {"gene_attn": _gene_block(sd, "rna_blocks.0.0")}
    for rid in range(1, 4):
        tower[f"conv_{rid}"] = _conv(sd, f"rna_blocks.{rid}.1")
    p["rna_tower"] = tower

    # encoder
    p["stem"] = _conv(sd, "input_blocks.0.0")
    resolution = conf.image_size
    k = 1
    for lvl in range(nlvl):
        if lvl > 0:
            p[f"enc_{k}_res"] = _resblock(sd, f"input_blocks.{k}.0")
            resolution //= 2
            k += 1
        for _ in range(nrb):
            p[f"enc_{k}_res"] = _resblock(sd, f"input_blocks.{k}.0")
            if resolution in conf.attention_resolutions:
                p[f"enc_{k}_attn"] = _dit_block(sd, f"input_blocks.{k}.1")
            k += 1

    # middle
    p["mid_res0"] = _resblock(sd, "middle_block.0")
    p["mid_attn"] = _dit_block(sd, "middle_block.1")
    p["mid_res1"] = _resblock(sd, "middle_block.2")

    # decoder
    res = resolution
    k = 0
    for i in range(nlvl):
        lvl = nlvl - 1 - i
        for j in range(nrb + 1):
            p[f"dec_{k}_res"] = _resblock(sd, f"output_blocks.{k}.0")
            li = 1
            if res in conf.attention_resolutions:
                p[f"dec_{k}_attn"] = _dit_block(sd, f"output_blocks.{k}.{li}")
                li += 1
            if lvl > 0 and j == nrb:
                p[f"dec_{k}_up"] = _resblock(sd, f"output_blocks.{k}.{li}")
                res *= 2
            k += 1

    p["out_norm"] = _norm(sd, "out.0")
    p["out_conv"] = _conv(sd, "out.2")
    return {"params": p}
