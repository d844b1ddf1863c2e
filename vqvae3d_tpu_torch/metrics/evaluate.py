"""Reconstruction quality metrics: NMSE, PSNR and slice-wise 3D SSIM.

Counterpart of ``vqvae3d_tpu/metrics/evaluate.py:21-103`` on the port's
(B, C, H, W, D) layout: ``ssim3d_slices`` is the mean 2D SSIM over the depth
slices, the 2D SSIM that of pytorch-lightning 1.2's functional ssim
(gaussian 11x11 window, sigma 1.5, k1 = 0.01, k2 = 0.03, VALID filtering).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def nmse(orig: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Normalized mean squared error: ||pred - orig||² / ||orig||²."""
    orig, pred = orig.float(), pred.float()
    return torch.sum((pred - orig) ** 2) / torch.sum(orig ** 2)


def psnr(orig: torch.Tensor, pred: torch.Tensor, data_range: float) -> torch.Tensor:
    orig, pred = orig.float(), pred.float()
    return 10.0 * torch.log10(data_range ** 2 / torch.mean((pred - orig) ** 2))


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise separable gaussian filter of (N, C, H, W), VALID."""
    c = img.shape[1]
    out = F.conv2d(img, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(out, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim2d(pred: torch.Tensor, target: torch.Tensor, data_range: Optional[float] = None,
           kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
           k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over a batch of 2D images (N, C, H, W)."""
    pred, target = pred.float(), target.float()
    if data_range is None:
        data_range = torch.max(target) - torch.min(target)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    k = torch.from_numpy(_gaussian_kernel1d(kernel_size, sigma)).to(pred.device)
    mu_p = _filter2d_separable(pred, k)
    mu_t = _filter2d_separable(target, k)
    mu_pp = _filter2d_separable(pred * pred, k)
    mu_tt = _filter2d_separable(target * target, k)
    mu_pt = _filter2d_separable(pred * target, k)
    var_p = mu_pp - mu_p ** 2
    var_t = mu_tt - mu_t ** 2
    cov = mu_pt - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    )
    return torch.mean(ssim_map)


def ssim3d_slices(pred: torch.Tensor, target: torch.Tensor,
                  data_range: Optional[float] = None, **kw) -> torch.Tensor:
    """3D SSIM as the mean 2D SSIM over depth slices: (B, C, H, W, D) ->
    slices (B·D, C, H, W)."""

    def to_slices(x):
        b, c, h, w, d = x.shape
        return x.permute(0, 4, 1, 2, 3).reshape(b * d, c, h, w)

    return ssim2d(to_slices(pred), to_slices(target), data_range=data_range, **kw)
