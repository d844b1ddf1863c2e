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
  * ``area_resize`` — area downscaling to any size, torch
    ``F.interpolate(mode='area')`` (adaptive average pooling), computed in
    fp32 as one mean over boxes for integer factors and otherwise as three
    per-axis averaging matrices, as the JAX package computes it.
  * ``space_to_depth`` / ``depth_to_space`` — the stem's f x f x f voxel
    blocks packed into channels, channel order (ph, pw, pd, c) with c
    fastest, as in the JAX package.

Under a space group (``parallel/halo.py``) volumes are H slabs: the x2
upsample takes one row from each neighbouring slab (its separable passes
serve eval too), and space_to_depth / depth_to_space work per slab, whose
H holds whole stride groups.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.parallel import halo


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
    """x2 trilinear upsample of the three spatial dims of (B, C, H, W, D).
    Under a space group x is an H slab: its H pass reads one row from each
    neighbouring slab (the volume's ends clamped), and the result is the
    rows of the whole volume's upsample that the slab owns."""
    if halo.active():
        rows = 2 * x.shape[2]
        out = _upsample2x_axis(halo.exchange(x, 1, "clamp").float(), 2).narrow(2, 2, rows)
        for dim in (3, 4):
            out = _upsample2x_axis(out, dim)
        return out.to(x.dtype)
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


def _adaptive_avg_matrix(in_dim: int, out_dim: int) -> torch.Tensor:
    """(out_dim, in_dim) fp32 averaging matrix of adaptive average pooling:
    bin i covers [floor(i in / out), ceil((i + 1) in / out))."""
    m = torch.zeros(out_dim, in_dim)
    for i in range(out_dim):
        start, end = (i * in_dim) // out_dim, -(-((i + 1) * in_dim) // out_dim)
        m[i, start:end] = 1.0 / (end - start)
    return m


def area_resize(x: torch.Tensor, size) -> torch.Tensor:
    """Area downscale of the three spatial dims of (B, C, s0, s1, s2) to
    ``size`` (``vqvae3d_tpu/ops/resize.py::area_resize``), in fp32, returned
    in x's dtype. Axes whose sizes divide take the mean over boxes; any
    other size separates into per-axis averaging matrices. Upsampling
    raises."""
    size = tuple(int(s) for s in size)
    spatial = tuple(x.shape[2:])
    if size == spatial:
        return x
    if any(o > i for o, i in zip(size, spatial)):
        raise ValueError(f"area_resize only downscales: {spatial} -> {size}")
    out = x.float()
    if all(i % o == 0 for i, o in zip(spatial, size)):
        box = [d for o, i in zip(size, spatial) for d in (o, i // o)]
        out = out.reshape(*x.shape[:2], *box).mean(dim=(3, 5, 7))
        return out.to(x.dtype)
    for dim, (i, o) in enumerate(zip(spatial, size), 2):
        if i != o:
            mat = _adaptive_avg_matrix(i, o).to(out.device)
            out = torch.movedim(torch.tensordot(mat, out, dims=([1], [dim])), 0, dim)
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
