"""InceptionV3 feature extractor (pool3, 2048-d) for d-FID, in PyTorch.

Port of ``tera_mind_tpu/metrics/inception.py``.  :class:`InceptionV3Features`
is the backbone up to the global average pool, with the submodule names of
the torchscript export the reference loads (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, ..., the torchvision layout): the export's
``named_parameters()`` / ``named_buffers()`` load with ``load_state_dict``
(:func:`load_torch_inception`).  ``fid_variant`` keeps the NVlabs pooling
semantics of the JAX module: average pools that exclude the padding, and a
max pool in Mixed_7c's pool branch.  :func:`inception_state_from_flax`
carries the JAX module's ``{'params', 'batch_stats'}`` across (the inverse
of JAX's ``convert_torch_inception``).

Input convention: (B, 3, 299, 299) in [-1, 1], the export's.
:class:`InceptionFeatures` (the counterpart of JAX's
``FlaxInceptionFeatures``) resizes tiles to 299^2 with an antialiased
bilinear filter (``jax.image.resize``'s "bilinear" antialiases when it
shrinks) and runs on the caller's device, cuDNN's TF32 off.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .features import no_tf32, to_nchw3

Pad = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Pad, stride: int = 1,
                 padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x: torch.Tensor, exclude_pad: bool) -> torch.Tensor:
    """3x3 stride-1 average pool, SAME; ``exclude_pad`` divides by the
    window's in-image pixels (the NVlabs FID blocks), else by 9."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not exclude_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, exclude_pad: bool):
        super().__init__()
        self.exclude_pad = exclude_pad
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool_3x3(x, self.exclude_pad))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, exclude_pad: bool):
        super().__init__()
        self.exclude_pad = exclude_pad
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(
            _avg_pool_3x3(x, self.exclude_pad))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, exclude_pad: bool, pool_max: bool = False):
        super().__init__()
        self.exclude_pad, self.pool_max = exclude_pad, pool_max
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        # NVlabs FIDInceptionE_2: a SAME max pool in the pool branch
        bp = (F.max_pool2d(x, 3, 1, 1) if self.pool_max
              else _avg_pool_3x3(x, self.exclude_pad))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class InceptionV3Features(nn.Module):
    """Backbone up to the 2048-d global-average pool (FID features);
    ``fid_variant``: the NVlabs pooling semantics."""

    def __init__(self, fid_variant: bool = True):
        super().__init__()
        ep = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, ep)
        self.Mixed_5c = InceptionA(256, 64, ep)
        self.Mixed_5d = InceptionA(288, 64, ep)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, ep)
        self.Mixed_6c = InceptionC(768, 160, ep)
        self.Mixed_6d = InceptionC(768, 160, ep)
        self.Mixed_6e = InceptionC(768, 192, ep)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, ep)
        self.Mixed_7c = InceptionE(2048, ep, pool_max=fid_variant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # (B, 2048)


def strip_wrapper(named: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``named`` without an optional leading wrapper attribute (such as
    ``layers.``) before ``Conv2d_1a_3x3``, keeping only the names under it
    (the JAX loader's rule)."""
    strip = ""
    for k in named:
        if k.startswith("Conv2d_1a_3x3"):
            break
        if ".Conv2d_1a_3x3" in k:
            strip = k.split("Conv2d_1a_3x3")[0]
            break
    return {k[len(strip):]: v for k, v in named.items()
            if k.startswith(strip)}


@torch.no_grad()
def load_torch_inception(model: InceptionV3Features,
                         named: Mapping[str, torch.Tensor]
                         ) -> InceptionV3Features:
    """Fill ``model`` from an export's named parameters and buffers (a
    wrapper prefix stripped): every conv and BatchNorm tensor of the model
    must be there; names the model lacks (an ``fc``, aux logits) and the
    BatchNorm step counters are ignored, as the JAX converter ignores
    them."""
    named = strip_wrapper(named)
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(named))
    if missing:
        raise KeyError(f"Inception export lacks {len(missing)} tensors, "
                       f"e.g. {missing[:3]}")
    for k, dst in own.items():
        src = torch.as_tensor(np.asarray(named[k]))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: export {tuple(src.shape)} vs model "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
    return model


def inception_state_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``InceptionV3Features`` variables ``{'params', 'batch_stats'}``
    as this module's named tensors (the inverse of JAX's
    ``convert_torch_inception``): conv kernels (kh, kw, I, O) ->
    (O, I, kh, kw); BatchNorm scale, bias, mean, var -> weight, bias,
    running_mean, running_var."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, path, names):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [k], names)
            elif k in names:
                val = np.asarray(v, np.float32)
                if k == "kernel":
                    val = val.transpose(3, 2, 0, 1)
                out[".".join(path + [names[k]])] = np.ascontiguousarray(val)

    walk(variables["params"], [], {"kernel": "weight", "scale": "weight",
                                   "bias": "bias"})
    walk(variables["batch_stats"], [], {"mean": "running_mean",
                                        "var": "running_var"})
    return out


class InceptionFeatures:
    """metrics.features-compatible extractor on ``device``: the port's
    InceptionV3 (``fid_variant``) filled from a torchscript InceptionV3
    export (NVlabs FID weights) in a local file."""

    dim = 2048

    def __init__(self, weights: str, device: str | torch.device = "cuda"):
        ts = torch.jit.load(str(weights), map_location="cpu")
        named = {k: v.detach() for k, v in ts.named_parameters()}
        named.update({k: v.detach() for k, v in ts.named_buffers()})
        self.device = torch.device(device)
        self.model = load_torch_inception(InceptionV3Features(), named).to(
            self.device).eval()

    @torch.no_grad()
    def __call__(self, batch: np.ndarray) -> np.ndarray:
        x = F.interpolate(to_nchw3(batch).to(self.device), size=(299, 299),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        with no_tf32():
            return self.model(x).cpu().numpy()
