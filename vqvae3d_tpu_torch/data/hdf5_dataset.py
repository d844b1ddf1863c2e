"""HDF5 volume dataset (fastMRI-style ``reconstruction_rss``), gated on h5py.

The port's copy of ``vqvae3d_tpu/data/hdf5_dataset.py`` (reference
utils/load_hdf5_dataset.py): float32 volumes shaped (H, W, D). Without
``h5py`` the constructor raises ``RuntimeError``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np

try:
    import h5py

    HAS_H5PY = True
except ImportError:
    HAS_H5PY = False


class HDF5VolumeDataset:
    def __init__(
        self,
        root: str,
        key: str = "reconstruction_rss",
        ext: str = ".h5",
        transform: Optional[Callable] = None,
    ):
        if not HAS_H5PY:
            raise RuntimeError("h5py is not available")
        self.files = sorted(str(p) for p in Path(root).glob(f"**/*{ext}"))
        self.key = key
        self.transform = transform

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> np.ndarray:
        with h5py.File(self.files[index], "r") as f:
            vol = np.asarray(f[self.key], dtype=np.float32)
        # fastMRI stores (slices, H, W) -> (H, W, D)
        if vol.ndim == 3:
            vol = np.moveaxis(vol, 0, -1)
        if self.transform is not None:
            vol = self.transform(vol)
        return vol
