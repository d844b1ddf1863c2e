"""CT scan dataset and a batched, prefetching data module (numpy only).

The port's copy of ``vqvae3d_tpu/data/ct_dataset.py``, trimmed to what the
port calls (full-resolution volumes: the port computes the loss at full
resolution, so the JAX module's space-to-depth pre-fold is not carried
over):

  * ``CTScanDataset`` — globs ``**/*.nrrd``, keeps scans whose header matches
    the wanted (H, W) size and voxel spacing, reads volumes as float32 and
    applies HU window/scale/shift -> depth pad + valid-slice count ->
    optional area rescale. An optional decode-once cache keeps the
    preprocessed volumes as ``.npz``.
  * ``CTDataModule`` — seeded train/val split, shuffled drop-last batches,
    background decode threads and a prefetch queue; under several processes
    each decodes only its contiguous slice of every global batch, and under
    a space axis keeps only its H slab of it.

Batches are dicts {'volume': (B, H, W, D, 1) float32, 'num_valid_slices':
(B,) int32}, as the JAX loader yields them.
"""
from __future__ import annotations

import os
import queue
import tempfile
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.transforms import depth_pad_and_crop, hu_window_normalize


class CTScanDataset:
    """NRRD CT volumes with header-based compatibility filtering."""

    def __init__(
        self,
        root: str,
        size: Tuple[Optional[int], Optional[int], Optional[int]] = (512, 512, None),
        spacing: Optional[Tuple[float, float, float]] = (0.976, 0.976, 3),
        ext: str = ".nrrd",
        output_depth: int = 128,
        rescale_input: Optional[Tuple[int, int, int]] = None,
        cache_dir: Optional[str] = None,
    ):
        keep = []
        for scan in sorted(str(p) for p in Path(root).glob(f"**/*{ext}")):
            try:
                header = nrrd_io.read_header(scan)
            except (OSError, ValueError) as e:
                warnings.warn(f"Skipping unreadable scan {scan}: {e}")
                continue
            sizes = header["sizes"]
            if any(want is not None and int(got) != want for want, got in zip(size, sizes)):
                warnings.warn(f"Scan {scan} size {tuple(sizes)} doesn't match {size}; ignoring")
                continue
            if spacing is not None:
                sp = _header_spacing(header)
                if sp is None or not np.allclose(sp, spacing, atol=1e-3):
                    warnings.warn(f"Scan {scan} spacing {sp} doesn't match {spacing}; ignoring")
                    continue
            keep.append(scan)
        self.scans = keep
        self.output_depth = output_depth
        self.rescale_input = tuple(rescale_input) if rescale_input else None
        # decode-once cache of preprocessed volumes; off for rescaled inputs
        self.cache_dir = cache_dir or os.environ.get("VQVAE3D_VOLUME_CACHE")
        if self.cache_dir and self.rescale_input is None:
            Path(self.cache_dir).mkdir(parents=True, exist_ok=True)
        else:
            self.cache_dir = None

    def _cache_path(self, index: int) -> Path:
        scan = self.scans[index]
        st = os.stat(scan)
        key = f"{Path(scan).stem}_{st.st_size}_{int(st.st_mtime)}_d{self.output_depth}_f1"
        return Path(self.cache_dir) / f"{key}.npz"

    def __len__(self) -> int:
        return len(self.scans)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        """-> (volume (H, W, D, 1) float32 normalized, num_valid_slices)."""
        cache = self._cache_path(index) if self.cache_dir else None
        if cache is not None and cache.exists():
            with np.load(cache) as z:
                return z["vol"], int(z["num_valid"])
        data, _ = nrrd_io.read(self.scans[index])
        vol, num_valid = depth_pad_and_crop(hu_window_normalize(data), self.output_depth)
        if self.rescale_input is not None:
            vol = _area_rescale_np(vol, self.rescale_input)
        vol = vol[..., None]
        if cache is not None:
            fd, tmp = tempfile.mkstemp(dir=str(cache.parent), suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, vol=vol, num_valid=np.int32(num_valid))
            os.replace(tmp, cache)  # atomic: a concurrent reader never sees half a file
        return vol, num_valid


def _header_spacing(header) -> Optional[np.ndarray]:
    if "space directions" in header:
        sd = np.asarray(header["space directions"], dtype=np.float64)
        return np.array([sd[i, i] for i in range(min(3, sd.shape[0]))])
    if "spacings" in header:
        return np.asarray(header["spacings"], dtype=np.float64)
    return None


def _adaptive_avg_matrix_np(in_dim: int, out_dim: int) -> np.ndarray:
    """(out_dim, in_dim) torch-adaptive-avg-pool bin-averaging matrix."""
    m = np.zeros((out_dim, in_dim), np.float32)
    for i in range(out_dim):
        start = (i * in_dim) // out_dim
        end = -(-((i + 1) * in_dim) // out_dim)
        m[i, start:end] = 1.0 / (end - start)
    return m


def _area_rescale_np(vol: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Area downscale with torch ``F.interpolate(mode='area')`` semantics:
    integer shrink factors by a reshape-mean, other sizes by separable
    adaptive-average-pool matmuls."""
    h, w, d = vol.shape
    th, tw, td = size
    if (th, tw, td) == (h, w, d):
        return vol
    if h % th == 0 and w % tw == 0 and d % td == 0:
        fh, fw, fd = h // th, w // tw, d // td
        return vol.reshape(th, fh, tw, fw, td, fd).mean(axis=(1, 3, 5)).astype(vol.dtype)
    out = vol.astype(np.float32)
    for axis, (in_dim, out_dim) in enumerate(((h, th), (w, tw), (d, td))):
        if in_dim == out_dim:
            continue
        if in_dim < out_dim:
            raise ValueError(f"area rescale only downscales ({in_dim}->{out_dim})")
        mat = _adaptive_avg_matrix_np(in_dim, out_dim)
        out = np.moveaxis(np.tensordot(mat, out, axes=(1, axis)), 0, axis)
    return out.astype(vol.dtype)


def h_slab(volumes: np.ndarray, index: int, count: int) -> np.ndarray:
    """Rows [i H/s, (i + 1) H/s) of (B, H, W, D, C) volumes (a view)."""
    h = volumes.shape[1]
    if h % count:
        raise ValueError(f"H {h} does not split into {count} slabs")
    return volumes[:, index * h // count:(index + 1) * h // count]


class CTDataModule:
    """Seeded split + batched iteration with background decode and prefetch."""

    def __init__(
        self,
        path: str,
        batch_size: int = 1,
        train_frac: float = 0.95,
        num_workers: int = 5,
        rescale_input: Optional[Tuple[int, int, int]] = None,
        seed: int = 42,
        output_depth: int = 128,
        size: Tuple[Optional[int], Optional[int], Optional[int]] = (512, 512, None),
        spacing: Optional[Tuple[float, float, float]] = (0.976, 0.976, 3),
        cache_dir: Optional[str] = None,
    ):
        if not 0 <= train_frac <= 1:
            raise ValueError(f"train_frac {train_frac} outside [0, 1]")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = CTScanDataset(path, size=size, spacing=spacing, output_depth=output_depth,
                                     rescale_input=rescale_input, cache_dir=cache_dir)
        n = len(self.dataset)
        perm = np.random.default_rng(seed).permutation(n)
        self.train_indices = perm[: int(n * train_frac)]
        self.val_indices = perm[int(n * train_frac):]

    def _iter(self, indices, shuffle: bool, epoch: int = 0, process_index: int = 0,
              process_count: int = 1, space_index: int = 0,
              space_count: int = 1) -> Iterator[dict]:
        """Iterate global batches of ``batch_size``; under ``process_count``
        processes each decodes only its contiguous slice of every global
        batch (the per-rank DistributedSampler of the reference's DDP). The
        shuffle is keyed on (seed, epoch) alone, so every process draws the
        same permutation and the slices' union is the global batch (JAX
        ct_dataset.py:305-330). With ``space_count`` > 1 the volumes keep
        only their H slab ``space_index`` of ``space_count`` (the rows
        [i H/s, (i + 1) H/s)), as the JAX package's volume sharding on its
        mesh's 'space' axis places them."""
        idx = np.array(indices)
        if shuffle:
            idx = np.random.default_rng(self.seed + 1 + epoch).permutation(idx)
        if self.batch_size % process_count:
            raise ValueError(f"batch size {self.batch_size} does not divide over "
                             f"{process_count} processes")
        bs = self.batch_size // process_count
        lo = process_index * bs
        n_batches = len(idx) // self.batch_size  # drop_last
        if n_batches == 0:
            return
        # A decode pool for samples and a separate assembly pool: assembly
        # tasks block on their sample futures, so sharing one pool could
        # deadlock. The prefetch depth keeps every decode worker busy.
        prefetch = max(2, -(-max(1, self.num_workers) // bs) + 1)
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool, \
                ThreadPoolExecutor(max_workers=2) as asm:

            def submit_batch(b):
                start = b * self.batch_size + lo
                futs = [pool.submit(self.dataset.__getitem__, int(i))
                        for i in idx[start:start + bs]]

                def assemble():
                    samples = [f.result() for f in futs]
                    vols = samples[0][0][None] if bs == 1 else np.stack([s[0] for s in samples])
                    if space_count > 1:
                        vols = np.ascontiguousarray(h_slab(vols, space_index, space_count))
                    nvs = np.array([s[1] for s in samples], np.int32)
                    return {"volume": vols, "num_valid_slices": nvs}

                return asm.submit(assemble)

            futures = queue.Queue()
            for b in range(min(prefetch, n_batches)):
                futures.put(submit_batch(b))
            for b in range(n_batches):
                batch = futures.get().result()
                if b + prefetch < n_batches:
                    futures.put(submit_batch(b + prefetch))
                yield batch

    def train_dataloader(self, epoch: int = 0, process_index: int = 0, process_count: int = 1,
                         space_index: int = 0, space_count: int = 1) -> Iterator[dict]:
        return self._iter(self.train_indices, True, epoch, process_index, process_count,
                          space_index, space_count)

    def val_dataloader(self, process_index: int = 0, process_count: int = 1,
                       space_index: int = 0, space_count: int = 1) -> Iterator[dict]:
        return self._iter(self.val_indices, False, 0, process_index, process_count,
                          space_index, space_count)

    @property
    def train_len(self) -> int:
        return len(self.train_indices)

    @property
    def val_len(self) -> int:
        return len(self.val_indices)
