"""Baur-style reconstruction loss on (B, C, H, W, D) volumes.

Counterpart of ``vqvae3d_tpu/metrics/baur.py`` (reference metrics/baur.py):
per-sample L1 and L2 distances of the flattened volumes, an optional
gradient-difference loss over the three spatial forward differences
(``lambda_gdl``, 0 by default as in the reference), plus the summed
quantization losses.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _image_gradients(image: torch.Tensor):
    """Forward differences along the three spatial axes, zero at the
    trailing edge."""
    grads = []
    for dim in (2, 3, 4):
        d = torch.diff(image, dim=dim)
        edge = torch.zeros_like(image.narrow(dim, 0, 1))
        grads.append(torch.cat([d, edge], dim=dim))
    return grads


def _pairwise_distance(x: torch.Tensor, y: torch.Tensor, p: int) -> torch.Tensor:
    """The sum over the batch of the per-sample p-norm distances of the
    flattened volumes (``nn.PairwiseDistance`` with eps 1e-6)."""
    b = x.shape[0]
    diff = torch.abs(x.reshape(b, -1) - y.reshape(b, -1)) + 1e-6
    if p == 1:
        return torch.sum(diff)
    return torch.sum(torch.sqrt(torch.sum(diff ** 2, dim=1)))


def baur_loss_3d(recon: torch.Tensor, target: torch.Tensor,
                 quantization_losses: Sequence[torch.Tensor],
                 lambda_reconstruction: float = 1.0, lambda_gdl: float = 0.0) -> torch.Tensor:
    recon, target = recon.float(), target.float()
    l1 = _pairwise_distance(target, recon, p=1) * lambda_reconstruction
    l2 = _pairwise_distance(target, recon, p=2) * lambda_reconstruction
    gdl = 0.0
    if lambda_gdl:
        g_t, g_r = _image_gradients(target), _image_gradients(recon)
        l1_gdl = sum(_pairwise_distance(a, b, p=1) for a, b in zip(g_t, g_r))
        l2_gdl = sum(_pairwise_distance(a, b, p=2) for a, b in zip(g_t, g_r))
        gdl = (l1_gdl + l2_gdl) * lambda_gdl
    q = sum(torch.as_tensor(loss) for loss in quantization_losses)
    return l1 + l2 + gdl + q
