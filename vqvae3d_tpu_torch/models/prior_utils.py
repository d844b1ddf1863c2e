"""Shared helpers of the autoregressive priors.

Counterpart of ``vqvae3d_tpu/models/prior_utils.py``; only the one-hot
encoding is ported so far (sampling needs nothing else). The training
losses, mixup and the PixelSNAIL background come with prior training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def idx_to_one_hot(data: torch.Tensor, num_classes: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, *spatial) int grid -> (B, num_classes, *spatial) one-hot."""
    return F.one_hot(data.long(), num_classes).to(dtype).movedim(-1, 1)
