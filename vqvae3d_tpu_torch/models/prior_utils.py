"""Shared helpers of the autoregressive priors.

Counterpart of ``vqvae3d_tpu/models/prior_utils.py:18-142`` (reference
pixel_model/train_helpers.py): bits/dim, the one-hot encoding, the per-voxel
cross-entropy, and mixup with a Sattolo derangement pairing. Grids are
channels-first here: logits (B, K, *grid), one-hots (B, K, *grid). The random
draws take an explicit ``torch.Generator``; λ and the pairing can also be
given, so that two implementations can be fed the same ones.
``generate_background`` is PixelSNAIL's coordinate background (JAX
``prior_utils.py:145-160``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def bits_per_dim(mean_nll: torch.Tensor) -> torch.Tensor:
    """Natural-log NLL -> bits/dim."""
    return mean_nll / math.log(2.0)


def idx_to_one_hot(data: torch.Tensor, num_classes: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, *spatial) int grid -> (B, num_classes, *spatial) one-hot."""
    return F.one_hot(data.long(), num_classes).to(dtype).movedim(-1, 1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-voxel NLL in fp32: logsumexp(logits) − logits[target], gradient
    g·(softmax − onehot). logits (B, K, *grid), targets (B, *grid) int ->
    (B, *grid)."""
    return F.cross_entropy(logits.float(), targets.long(), reduction="none")


def sattolo_cycle(batch_size: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A random cyclic permutation (a derangement for batch_size ≥ 2) by
    Sattolo's algorithm (reference train_helpers.py:22-37): for i from B−1
    down to 1, swap i with a uniform j < i."""
    out = list(range(batch_size))
    dev = generator.device if generator is not None else None
    for i in range(batch_size - 1, 0, -1):
        j = int(torch.randint(0, i, (1,), generator=generator, device=dev))
        out[i], out[j] = out[j], out[i]
    return torch.tensor(out, dtype=torch.int64)


def draw_beta(alpha: float, generator: Optional[torch.Generator] = None) -> float:
    """One Beta(alpha, alpha) draw, seeded from ``generator``."""
    dev = generator.device if generator is not None else None
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev))
    return float(np.random.default_rng(seed).beta(alpha, alpha))


def mixup_data(x: torch.Tensor, y: torch.Tensor, alpha: float,
               condition: Optional[torch.Tensor] = None, *,
               generator: Optional[torch.Generator] = None, lam: Optional[float] = None,
               index: Optional[torch.Tensor] = None):
    """Mixup over the batch with a derangement pairing: λ ~ Beta(α, α) and
    ``index`` from ``sattolo_cycle`` unless given. Returns (mixed_x,
    mixed_condition, (y_a, y_b), λ)."""
    if lam is None:
        lam = draw_beta(alpha, generator)
    if index is None:
        index = sattolo_cycle(x.shape[0], generator)
    index = index.to(x.device)
    mixed_x = lam * x + (1 - lam) * x[index]
    mixed_cond = None
    if condition is not None:
        mixed_cond = lam * condition + (1 - lam) * condition[index]
    return mixed_x, mixed_cond, (y, y[index]), lam


def mixup_cross_entropy(logits: torch.Tensor, targets, lam: float) -> torch.Tensor:
    """λ·CE(y_a) + (1 − λ)·CE(y_b), per voxel."""
    y_a, y_b = targets
    return lam * cross_entropy(logits, y_a) + (1 - lam) * cross_entropy(logits, y_b)


def generate_background(batch: int, dims, device=None) -> torch.Tensor:
    """PixelSNAIL's positional background (reference pixelsnail.py:283-293):
    (B, 3, s0, s1, s2) fp32, channel a holding linspace(−1, 1, s_a) along
    axis a."""
    s0, s1, s2 = dims
    axes = [torch.linspace(-1, 1, n, device=device) for n in (s0, s1, s2)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))
    return grid[None].expand(batch, 3, s0, s1, s2)
