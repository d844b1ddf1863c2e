"""Host-side volume transforms of the CT pipeline (numpy only).

The port's copy of ``vqvae3d_tpu/data/transforms.py``, trimmed to what the
port calls:

  * ``hu_window_normalize`` — clamp HU to [-1500, 3000], /1000, +1 -> [-0.5, 4];
  * ``hu_unnormalize`` — back to integer HU;
  * ``depth_pad_and_crop`` — post-pad or truncate depth to ``output_depth``
    and return the number of valid slices (the loss-mask label);
  * ``create_cylinder_xy_mask`` — the CT gantry cylinder over (x, y), the
    loss's pre-filter.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

HU_MIN, HU_MAX, HU_SCALE = -1500.0, 3000.0, 1000.0


def hu_window_normalize(volume: np.ndarray) -> np.ndarray:
    """HU -> normalized [-0.5, 4] float32, in one allocation."""
    v = np.asarray(volume).astype(np.float32, copy=True)
    np.clip(v, HU_MIN, HU_MAX, out=v)
    v /= HU_SCALE
    v += 1.0
    return v


def hu_unnormalize(volume: np.ndarray) -> np.ndarray:
    """Normalized -> integer HU."""
    v = np.asarray(volume, dtype=np.float32) * HU_SCALE - HU_SCALE
    return np.rint(v).astype(np.int32)


def depth_pad_and_crop(
    volume: np.ndarray, output_depth: int = 128, pad_value: float = 0.0
) -> Tuple[np.ndarray, int]:
    """Post-pad/truncate the last axis to ``output_depth``; returns
    (volume, num_valid_slices)."""
    d = volume.shape[-1]
    num_valid = min(d, output_depth)
    if d < output_depth:
        pad = [(0, 0)] * (volume.ndim - 1) + [(0, output_depth - d)]
        volume = np.pad(volume, pad, constant_values=pad_value)
    else:
        volume = volume[..., :output_depth]
    return volume, num_valid


@lru_cache(maxsize=8)
def create_cylinder_xy_mask(size: Tuple[int, int]) -> np.ndarray:
    """Boolean (H, W) mask of the inscribed cylinder (gantry field of view)."""
    x_size, y_size = size
    radius = min(x_size, y_size) / 2
    x, y = np.ogrid[:x_size, :y_size]
    return np.sqrt((x - x_size / 2) ** 2 + (y - y_size / 2) ** 2) <= radius
