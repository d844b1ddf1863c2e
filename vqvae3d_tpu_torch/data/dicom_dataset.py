"""DICOM slice dataset, gated on pydicom.

The port's copy of ``vqvae3d_tpu/data/dicom_dataset.py`` (reference
utils/load_dicom_dataset.py): per-file ``pixel_array`` slices as float32.
Without ``pydicom`` the constructor raises ``RuntimeError``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np

try:
    import pydicom

    HAS_PYDICOM = True
except ImportError:
    HAS_PYDICOM = False


class DICOMSliceDataset:
    def __init__(self, root: str, ext: str = ".dcm", transform: Optional[Callable] = None):
        if not HAS_PYDICOM:
            raise RuntimeError(
                "pydicom is not available in this environment; install it to "
                "use the DICOM reader"
            )
        self.files = sorted(str(p) for p in Path(root).glob(f"**/*{ext}"))
        self.transform = transform

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> np.ndarray:
        arr = pydicom.dcmread(self.files[index]).pixel_array.astype(np.float32)
        if self.transform is not None:
            arr = self.transform(arr)
        return arr
