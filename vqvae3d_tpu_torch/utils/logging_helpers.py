"""Metric-distribution logging (``vqvae3d_tpu/utils/logging_helpers.py``)."""
from __future__ import annotations

import torch


def median(v: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle ones for an even
    count (``jnp.median``; ``torch.median`` would return the lower one)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def sub_metric_log_dict(metric_name: str, metric: torch.Tensor) -> dict:
    """A tensor metric -> its min/max/mean/median/std (population std)."""
    return {
        f"{metric_name}_min": torch.min(metric),
        f"{metric_name}_max": torch.max(metric),
        f"{metric_name}_mean": torch.mean(metric),
        f"{metric_name}_median": median(metric),
        f"{metric_name}_std": torch.std(metric, correction=0),
    }
