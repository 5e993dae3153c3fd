"""Evaluation metrics (port of ``tera_mind_tpu/metrics``): d-FID and its
streaming moments, PSNR / SSIM / MS-SSIM, online gene statistics; feature
extractors, InceptionV3, gene tables and morphology in the submodules."""

from .fid import frechet_distance, StreamingMoments, d_fid_from_moments
from .ssim import psnr, ssim, ms_ssim
from .stats import OnlineVariance

__all__ = ["frechet_distance", "StreamingMoments", "d_fid_from_moments",
           "psnr", "ssim", "ms_ssim", "OnlineVariance"]
