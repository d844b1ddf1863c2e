"""Naive ancestral sampling of code grids, and the sampling helpers.

Counterpart of ``vqvae3d_tpu/sample/ar_sample.py``: a loop over the voxels
in raster order, one full-grid forward per voxel (causality keeps the
unsampled voxels out of the current logit), one sampled voxel per step.
O(V²): kept as the plain reference of the cached sampler and used at tiny
grids only.

Sampling is ``argmax(logits / tau + g)`` with Gumbel noise ``g`` and the
lowest index on ties, which is what ``jax.random.categorical`` computes. The
noise is an input: a table in raster order (``gumbel``, shape (s0, s1, s2, B,
K)), or draws from a ``torch.Generator`` on the model's device. A JAX key
sequence cannot be reproduced here, so grids equal the JAX sampler's only
when both take the same table.

Every sampler computes in true fp32: ``fp32_exact`` turns TF32 off for
cuDNN and matmuls while it runs and restores both flags after.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
from vqvae3d_tpu_torch.ops.resize import trilinear_resize


@contextlib.contextmanager
def fp32_exact():
    """True fp32 convolutions and matmuls inside the block (TF32 off)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def draw_gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise: -log(E) with E ~ Exp(1), one device call."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return e.exponential_(generator=generator).log_().neg_()


def gumbel_argmax(logits: torch.Tensor, gumbel: torch.Tensor, tau: float) -> torch.Tensor:
    """argmax over the last dim of logits / tau + gumbel; ties to the lowest index."""
    return torch.argmax(logits / tau + gumbel, dim=-1)


def check_gumbel(gumbel, dims, batch_size, k):
    want = (*dims, batch_size, k)
    if gumbel is not None and tuple(gumbel.shape) != want:
        raise ValueError(f"gumbel table {tuple(gumbel.shape)}, expected {want}")


def model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def ancestral_sample(
    model,
    dims: Tuple[int, int, int],
    batch_size: int,
    condition_idx: Optional[torch.Tensor] = None,
    tau: float = 1.0,
    *,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample (batch_size, *dims) int32 code grids.

    condition_idx: (batch_size, *coarser_dims) int grid of the next-coarser
    level, or None for an unconditioned prior."""
    cfg = model.config
    k = cfg.input_dim
    dev = model_device(model)
    check_gumbel(gumbel, dims, batch_size, k)
    condition = None
    if cfg.use_conditioning:
        if condition_idx is None:
            raise ValueError("a conditioned prior needs condition_idx")
        one_hot = idx_to_one_hot(condition_idx.to(dev), cfg.condition_dim)
        condition = trilinear_resize(one_hot, dims)
    elif condition_idx is not None:
        raise ValueError("an unconditioned prior takes no condition_idx")

    x = torch.zeros(batch_size, k, *dims, device=dev)
    with fp32_exact():
        for v in range(math.prod(dims)):
            i0, i1, i2 = (v // (dims[1] * dims[2]), (v // dims[2]) % dims[1], v % dims[2])
            logits = model(x, condition, dtype=torch.float32)[:, :, i0, i1, i2]  # (B, K)
            g = (gumbel[i0, i1, i2].to(dev) if gumbel is not None
                 else draw_gumbel((batch_size, k), generator, dev))
            idx = gumbel_argmax(logits, g, tau)
            x[:, :, i0, i1, i2] = F.one_hot(idx, k).float()
    return torch.argmax(x, dim=1).to(torch.int32)
