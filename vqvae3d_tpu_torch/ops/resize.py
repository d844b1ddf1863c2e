"""Resampling ops on (B, C, H, W, D) volumes.

Counterpart of ``vqvae3d_tpu/ops/resize.py`` (which works on (B, H, W, D, C)):

  * ``trilinear_upsample2x`` — x2 trilinear upsampling, half-pixel centres,
    edge-clamped: torch ``F.interpolate(mode='trilinear',
    align_corners=False)``, as the reference ResizeConv3D uses.
  * ``space_to_depth`` / ``depth_to_space`` — the stem's f x f x f voxel
    blocks packed into channels, channel order (ph, pw, pd, c) with c
    fastest, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def trilinear_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x2 trilinear upsample of the three spatial dims of (B, C, H, W, D)."""
    return F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, H, W, D) -> (B, C·f³, H/f, W/f, D/f); channel order (ph, pw, pd, c)."""
    if factor == 1:
        return x
    b, c, h, w, d = x.shape
    f = factor
    if h % f or w % f or d % f:
        raise ValueError(f"space_to_depth: {tuple(x.shape)} not divisible by {f}")
    x = x.reshape(b, c, h // f, f, w // f, f, d // f, f)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, f * f * f * c, h // f, w // f, d // f)


def depth_to_space(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Inverse of ``space_to_depth``."""
    if factor == 1:
        return x
    b, cf, h, w, d = x.shape
    f = factor
    c = cf // (f * f * f)
    if c * f * f * f != cf:
        raise ValueError(f"depth_to_space: {cf} channels not divisible by {f}³")
    x = x.reshape(b, f, f, f, c, h, w, d)
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(b, c, h * f, w * f, d * f)
