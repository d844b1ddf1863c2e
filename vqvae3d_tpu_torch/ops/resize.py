"""Resampling ops on (B, C, H, W, D) volumes.

Counterpart of ``vqvae3d_tpu/ops/resize.py`` (which works on (B, H, W, D, C)):

  * ``trilinear_upsample2x`` — x2 trilinear upsampling, half-pixel centres,
    edge-clamped: torch ``F.interpolate(mode='trilinear',
    align_corners=False)``, as the reference ResizeConv3D uses. When autograd
    needs its gradient it runs as three separable passes of shifted slices
    (in fp32, the same function to fp32 rounding): that backward is slicing
    and adds, so a train step is deterministic, where the CUDA backward of
    ``F.interpolate`` scatters with atomics, in another order each run.
  * ``trilinear_resize`` — upsampling to any size (the prior's coarse
    condition grid), ``F.interpolate`` in fp32.
  * ``space_to_depth`` / ``depth_to_space`` — the stem's f x f x f voxel
    blocks packed into channels, channel order (ph, pw, pd, c) with c
    fastest, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _upsample2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x2 linear upsampling along one axis, half-pixel centres, edges clamped:
    out[2i] = x[i-1]/4 + 3x[i]/4, out[2i+1] = 3x[i]/4 + x[i+1]/4."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def trilinear_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x2 trilinear upsample of the three spatial dims of (B, C, H, W, D)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)
    out = x.float()
    for dim in (2, 3, 4):
        out = _upsample2x_axis(out, dim)
    return out.to(x.dtype)


def trilinear_resize(x: torch.Tensor, size) -> torch.Tensor:
    """Trilinear upsampling of the three spatial dims of (B, C, s0, s1, s2) to
    ``size``, in fp32, half-pixel centres (the prior's conditioning grid).

    ``jax.image.resize(method='trilinear')`` drops the taps that fall outside
    the input and renormalises the rest; torch clamps the source coordinate
    to the edge. When no axis shrinks both give the same values, so a
    shrinking size raises (there the JAX resize antialiases)."""
    size = tuple(int(s) for s in size)
    if any(o < i for o, i in zip(size, x.shape[2:])):
        raise ValueError(f"trilinear_resize upsamples only: {tuple(x.shape[2:])} -> {size}")
    out = F.interpolate(x.float(), size=size, mode="trilinear", align_corners=False)
    return out.to(x.dtype)


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
