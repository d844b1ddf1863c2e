"""Offline per-intensity histogram over the (cylinder-masked) dataset.

Counterpart of ``vqvae3d_tpu/cli/data_marginal.py`` (reference
utils/data_marginal.py:9-38), with its flags plus ``--device`` (default
``cuda``; no fallback to the CPU when CUDA is absent): a histogram of the
normalized intensities of every scan (the port's ``CTDataModule``, one scan
a batch, no split), restricted to the CT gantry cylinder, saved as ``.npz``
with the same keys (``bin_edges``, ``counts``, ``num_scans``). Each scan's
voxels are binned on the device: ``torch.bucketize`` against the fp64 edges
bins as ``np.histogram`` does (bin i holds [e_i, e_i+1), the last bin its
right edge too, values outside the range dropped), so the counts equal the
JAX CLI's.

    python -m vqvae3d_tpu_torch.cli.data_marginal /data/ct --out marginal.npz
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.data.transforms import create_cylinder_xy_mask


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_path", type=Path)
    parser.add_argument("--out", type=Path, default=Path("data_marginal.npz"))
    parser.add_argument("--bins", type=int, default=512)
    parser.add_argument("--range", type=float, nargs=2, default=[-0.5, 4.0])
    parser.add_argument("--scan-size", type=int, nargs=2, default=[512, 512])
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def histogram(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``np.histogram(values, bins=edges)[0]`` (int64) for increasing fp64
    ``edges``, on ``values``' device."""
    v = values.double()
    nbins = edges.numel() - 1
    inside = (v >= edges[0]) & (v <= edges[-1])
    idx = torch.clamp(torch.bucketize(v[inside], edges, right=True) - 1, max=nbins - 1)
    return torch.bincount(idx, minlength=nbins)


def main(args):
    device = resolve_device(args.device)
    dm = CTDataModule(
        str(args.dataset_path),
        batch_size=1,
        train_frac=1.0,
        size=(*args.scan_size, None),
    )
    edges = np.linspace(args.range[0], args.range[1], args.bins + 1)
    edges_dev = torch.from_numpy(edges).to(device)
    counts = torch.zeros(args.bins, dtype=torch.int64, device=device)
    mask = None
    n = 0
    for batch in dm.train_dataloader(epoch=0):
        vol = torch.from_numpy(batch["volume"][0, ..., 0]).to(device)
        if mask is None:
            mask = torch.from_numpy(create_cylinder_xy_mask(tuple(vol.shape[:2]))).to(device)
        counts += histogram(vol[mask], edges_dev)
        n += 1
    counts = counts.cpu().numpy()
    np.savez(args.out, bin_edges=edges, counts=counts, num_scans=n)
    print(f"histogram over {n} scans -> {args.out}")
    return counts


if __name__ == "__main__":
    main(parse_arguments())
