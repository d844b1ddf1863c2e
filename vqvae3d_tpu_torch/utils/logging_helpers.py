"""Metric-distribution logging (``vqvae3d_tpu/utils/logging_helpers.py``):
the median that the train log takes (``train.vqvae_train.weighted_log``
computes the rest of the distribution's statistics, global over ranks)."""
from __future__ import annotations

import torch


def median(v: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle ones for an even
    count (``jnp.median``; ``torch.median`` would return the lower one)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2

