"""Feature extraction + d-FID evaluation over tile stores.

Port of ``tera_mind_tpu/metrics/features.py``: walk the generated and real
tile grids, extract per-tile features, accumulate STREAMING masked moments
(tiles with empty gene content are skipped, reference feat_mba.py:343-357),
then d-FID via the eigenvalue trick (``metrics/fid.py``).

Extractors are pluggable.  The reference uses a torchscript InceptionV3
(NVlabs weights) and CLIP ViT-B/32 (feat_mba.py:57-179), both downloaded
at run time; here every network reads local weights only:

- :class:`PoolFeatures`: weight-free multi-scale pooled statistics (numpy,
  the JAX class's copy; always available, deterministic).
- :class:`TorchscriptFeatures`: a local torchscript feature model on the
  caller's device.
- :class:`CLIPFeatures`: transformers' torch CLIP from a local directory;
  refused with a message naming ``transformers`` where it is missing.
- ``metrics/inception.py``'s :class:`InceptionFeatures`: the port's own
  InceptionV3 on a torchscript export's weights.

The networks run with cuDNN's TF32 off (:func:`no_tf32`), so features on
the card hold to the CPU's.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Iterable, Optional, Protocol, Tuple

import numpy as np
import torch

from .fid import StreamingMoments, frechet_distance


class FeatureExtractor(Protocol):
    dim: int

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """(B, H, W) or (B, H, W, C) uint8/float -> (B, dim) features."""
        ...


def no_tf32() -> contextlib.AbstractContextManager:
    """cuDNN on, its TF32 off: float32 convolutions in float32 (PyTorch's
    default lets cuDNN round their inputs to TF32 on Hopper)."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


class PoolFeatures:
    """Weight-free features: multi-scale local mean/std/gradient pooled
    statistics.  Not Inception — but a consistent embedding for relative
    comparisons and pipeline tests."""

    def __init__(self, grid: int = 8):
        self.grid = grid
        self.dim = grid * grid * 4

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        x = np.asarray(batch, np.float32)
        if x.ndim == 4:
            x = x.mean(-1)
        b, h, w = x.shape
        g = self.grid

        def cell_mean(v):
            return v.reshape(b, g, h // g, g, w // g).mean((2, 4))

        cells = x.reshape(b, g, h // g, g, w // g)
        mean = cells.mean((2, 4))
        std = cells.std((2, 4))
        gy = np.zeros_like(x)
        gy[:, 1:, :] = np.abs(np.diff(x, axis=1))
        gx = np.zeros_like(x)
        gx[:, :, 1:] = np.abs(np.diff(x, axis=2))
        feats = np.stack([mean, std, cell_mean(gy), cell_mean(gx)], -1)
        return feats.reshape(b, -1)


def to_nchw3(batch: np.ndarray) -> torch.Tensor:
    """(B, H, W) or (B, H, W, C) -> float32 (B, C, H, W), one channel
    repeated to three."""
    x = torch.from_numpy(np.asarray(batch, np.float32))
    if x.ndim == 3:
        return x[:, None].repeat(1, 3, 1, 1)
    x = x.permute(0, 3, 1, 2)
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


class TorchscriptFeatures:
    """A torchscript feature model (e.g. the NVlabs InceptionV3 export the
    reference uses, feat_mba.py:29-42) from a local file, on ``device``."""

    def __init__(self, path: str | Path, dim: int = 2048, resize: int = 299,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = torch.jit.load(str(path),
                                    map_location=self.device).eval()
        self.dim = dim
        self.resize = resize

    @torch.no_grad()
    def __call__(self, batch: np.ndarray) -> np.ndarray:
        x = torch.nn.functional.interpolate(
            to_nchw3(batch).to(self.device), size=(self.resize, self.resize),
            mode="bilinear", align_corners=False)
        with no_tf32():
            return self.model(x).float().cpu().numpy()


# OpenAI CLIP image-normalization constants (reference CLIP_fx.__call__,
# feat_mba.py:170-172)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(batch: np.ndarray, size: int = 224) -> np.ndarray:
    """Reference-exact CLIP image preprocessing (the JAX function's copy).

    The reference's ``fn_resize(mode='clip')`` -> ``post_dim`` ->
    ``CLIP_fx`` normalize chain (feat_mba.py:199-208, 182-196, 164-179)
    on a [0,255]-range float batch: truncate to uint8; antialiased bicubic
    resize to ``size`` with a round+clamp back to the integer range
    (torchvision's tensor path); ``/255``; one channel repeated to three,
    two channels (DAPI+PolyT) with a zero channel PREPENDED; CLIP
    mean/std.  Input (B, H, W) or (B, H, W, C); output (B, 3, size, size)
    float32, computed on the CPU."""
    x = np.asarray(batch, np.float32)
    if x.ndim == 3:
        x = x[..., None]
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    t = t.to(torch.uint8).float()
    t = torch.nn.functional.interpolate(t, (size, size), mode="bicubic",
                                        antialias=True)
    t = t.round_().clamp_(0, 255).div_(255.0)
    c = t.shape[1]
    if c == 1:
        t = t.repeat(1, 3, 1, 1)
    elif c == 2:
        t = torch.cat((torch.zeros_like(t[:, :1]), t), 1)
    mean = torch.tensor(CLIP_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD).view(1, 3, 1, 1)
    return ((t - mean) / std).numpy()


class CLIPFeatures:
    """CLIP image features (reference CLIP_fx, feat_mba.py:164-179) from
    transformers' torch ``CLIPModel`` in a local directory, on ``device``,
    after :func:`clip_preprocess`.  Needs the ``transformers`` package."""

    def __init__(self, model_dir: str, device: str | torch.device = "cuda"):
        try:
            from transformers import CLIPModel
        except ImportError as e:
            raise ImportError(
                "CLIP features need the transformers package, which is not "
                "installed: install transformers, or use --features "
                "inception / torchscript / pool") from e
        self.device = torch.device(device)
        self.model = CLIPModel.from_pretrained(model_dir).to(
            self.device).eval()
        self.dim = int(self.model.config.projection_dim)
        self.size = int(self.model.config.vision_config.image_size)

    @torch.no_grad()
    def __call__(self, batch: np.ndarray) -> np.ndarray:
        pix = torch.from_numpy(clip_preprocess(batch, self.size))
        with no_tf32():
            out = self.model.get_image_features(
                pixel_values=pix.to(self.device))
        return out.float().cpu().numpy()


def collect_moments(tiles: Iterable[np.ndarray], extractor: FeatureExtractor,
                    *, mask_fn: Optional[Callable[[np.ndarray], bool]] = None,
                    batch: int = 16) -> StreamingMoments:
    sm = StreamingMoments(extractor.dim)
    buf = []
    for t in tiles:
        if mask_fn is not None and not mask_fn(t):
            continue
        buf.append(t)
        if len(buf) == batch:
            sm.add(extractor(np.stack(buf)))
            buf = []
    if buf:
        sm.add(extractor(np.stack(buf)))
    return sm


def d_fid_between_stores(gen_tiles: Iterable[np.ndarray],
                         real_tiles: Iterable[np.ndarray],
                         extractor: Optional[FeatureExtractor] = None,
                         **kw) -> float:
    """d-FID between two tile streams (reference calc_d_fid,
    metrics.py:71-97)."""
    extractor = extractor or PoolFeatures()
    a = collect_moments(gen_tiles, extractor, **kw)
    b = collect_moments(real_tiles, extractor, **kw)
    mu1, c1 = a.finalize()
    mu2, c2 = b.finalize()
    return frechet_distance(mu1, c1, mu2, c2)


def d_fid_per_slice(gen_reader: Callable[[int], Iterable[np.ndarray]],
                    real_reader: Callable[[int], Iterable[np.ndarray]],
                    slices: Iterable[int],
                    extractor: Optional[FeatureExtractor] = None
                    ) -> Tuple[dict, float]:
    """Per-slice + aggregate d-FID (reference calc_d_fid3/calc_slc_all_fid,
    metrics.py:100-135)."""
    extractor = extractor or PoolFeatures()
    per = {}
    agg_a, agg_b = StreamingMoments(extractor.dim), \
        StreamingMoments(extractor.dim)
    for s in slices:
        a = collect_moments(gen_reader(s), extractor)
        b = collect_moments(real_reader(s), extractor)
        mu1, c1 = a.finalize()
        mu2, c2 = b.finalize()
        per[s] = frechet_distance(mu1, c1, mu2, c2)
        agg_a.merge(a)
        agg_b.merge(b)
    mu1, c1 = agg_a.finalize()
    mu2, c2 = agg_b.finalize()
    return per, frechet_distance(mu1, c1, mu2, c2)
