"""PSNR / SSIM / MS-SSIM in PyTorch (channels-last images).

Port of ``tera_mind_tpu/metrics/ssim.py``: Wang et al. SSIM with separable
Gaussian windows and the 5-scale MS-SSIM weighting (capability parity with
the reference's utils/metrics.py:201-541).  Inputs are (B, H, W, C)
tensors (numpy arrays are taken as they are); everything runs in float32
on the inputs' device.

The blur is two ``F.conv2d`` (rows, then columns, VALID), as JAX's
``conv_general_dilated`` pair.  Each runs with cuDNN's TF32 off: PyTorch's
cuDNN convolutions default to TF32 on Hopper, and ``var = blur(a^2) -
mu^2`` then loses about 1e-3 of SSIM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .features import no_tf32

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def psnr(a, b, data_range: float = 2.0) -> torch.Tensor:
    """Peak SNR per batch element; default range 2.0 for [-1,1] images."""
    a, b = _f32(a), _f32(b)
    mse = ((a - b) ** 2).mean(dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian blur of (B, H, W, C)."""
    k = kernel.shape[0]
    b, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    with no_tf32():
        x = F.conv2d(x, kernel.reshape(1, 1, k, 1))
        x = F.conv2d(x, kernel.reshape(1, 1, 1, k))
    _, _, h2, w2 = x.shape
    return x.reshape(b, c, h2, w2).permute(0, 2, 3, 1)


def ssim(a, b, *, data_range: float = 2.0, win_size: int = 11,
         sigma: float = 1.5, full: bool = False):
    """Mean SSIM over (B, H, W, C) image pairs; returns (B,) scores (and
    the contrast-structure term if ``full``, which MS-SSIM needs)."""
    a, b = _f32(a), _f32(b)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    kern = _gaussian_kernel(win_size, sigma, a.device)
    mu_a = _blur(a, kern)
    mu_b = _blur(b, kern)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _blur(a * a, kern) - mu_aa
    var_b = _blur(b * b, kern) - mu_bb
    cov = _blur(a * b, kern) - mu_ab
    cs_map = (2 * cov + c2) / (var_a + var_b + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs_map
    axes = tuple(range(1, a.ndim))
    if full:
        return ssim_map.mean(axes), cs_map.mean(axes)
    return ssim_map.mean(axes)


def _downsample(img: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    h2, w2 = h // 2 * 2, w // 2 * 2
    x = img[:, :h2, :w2].reshape(b, h2 // 2, 2, w2 // 2, 2, c)
    return x.mean(dim=(2, 4))


def ms_ssim(a, b, *, data_range: float = 2.0,
            win_size: int = 11) -> torch.Tensor:
    """Multi-scale SSIM, 5 scales (needs H, W >= 11 * 2^4)."""
    a, b = _f32(a), _f32(b)
    weights = torch.tensor(MS_WEIGHTS, dtype=torch.float32, device=a.device)
    vals = []
    for i in range(len(MS_WEIGHTS)):
        s, cs = ssim(a, b, data_range=data_range, win_size=win_size,
                     full=True)
        vals.append(s if i == len(MS_WEIGHTS) - 1 else cs)
        if i < len(MS_WEIGHTS) - 1:
            a, b = _downsample(a), _downsample(b)
    vals = torch.stack(vals)  # (scales, B)
    return torch.prod(vals.clamp_min(1e-6) ** weights[:, None], dim=0)
