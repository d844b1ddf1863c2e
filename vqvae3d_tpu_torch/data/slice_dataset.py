"""2-D slice dataset and semi-random slice sampler (numpy only).

The port's copy of ``vqvae3d_tpu/data/slice_dataset.py`` (reference
utils/load_nrrd_dataset.py:176-248, CTSliceDataset + SliceSampler): not
used by the 3D pipeline, part of its capability surface. Slices index into
scans through a cumulative-size table; the sampler shuffles between scans
('inter'), within scans ('intra'), both, or neither, to bound the I/O cost
of random slice access. Its order is numpy's ``default_rng(seed + epoch)``,
so the index streams equal the JAX package's.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.ct_dataset import CTScanDataset
from vqvae3d_tpu_torch.data.transforms import hu_window_normalize


class CTSliceDataset:
    """Per-slice access over a directory of NRRD scans: item i is the slice
    (H, W, 1) float32 (HU-normalized unless ``normalize`` is off)."""

    def __init__(
        self,
        root: str,
        size: Tuple[Optional[int], Optional[int], Optional[int]] = (512, 512, None),
        spacing: Optional[Tuple[float, float, float]] = (0.976, 0.976, 3),
        normalize: bool = True,
    ):
        self.scan_ds = CTScanDataset(root, size=size, spacing=spacing)
        self.normalize = normalize
        self.scan_heights = np.asarray(
            [int(nrrd_io.read_header(scan)["sizes"][-1]) for scan in self.scan_ds.scans],
            np.int64)
        self.cumsum = np.cumsum(np.insert(self.scan_heights, 0, 0))
        self.num_slices = int(self.cumsum[-1])
        self.idx = np.repeat(np.arange(len(self.scan_heights), dtype=np.int64),
                             self.scan_heights)

    def __len__(self) -> int:
        return self.num_slices

    def __getitem__(self, index: int) -> np.ndarray:
        scan_index = int(self.idx[index])
        offset = index - int(self.cumsum[scan_index])
        data, _ = nrrd_io.read(self.scan_ds.scans[scan_index])
        sl = data[..., offset].astype(np.float32)
        if self.normalize:
            sl = hu_window_normalize(sl)
        return sl[..., None]


class SliceSampler:
    """Index iterator with 'none' | 'inter' | 'intra' | 'both' shuffling
    (reference :217-248); each iteration is a new epoch."""

    def __init__(self, dataset: CTSliceDataset, mode: str = "both", seed: int = 0):
        if mode not in ("none", "inter", "intra", "both"):
            raise ValueError(f"mode must be none/inter/intra/both, got {mode}")
        self.mode = mode
        self.dataset = dataset
        self.seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        cumsum = self.dataset.cumsum
        scan_order = np.arange(len(self.dataset.scan_heights))
        if self.mode in ("inter", "both"):
            rng.shuffle(scan_order)
        chunks = []
        for s in scan_order:
            chunk = np.arange(cumsum[s], cumsum[s + 1])
            if self.mode in ("intra", "both"):
                rng.shuffle(chunk)
            chunks.append(chunk)
        order = np.concatenate(chunks) if chunks else np.array([], np.int64)
        return iter(order.tolist())

    def __len__(self) -> int:
        return len(self.dataset)
