"""Evaluation CLI: reconstruction SSIM over the train and val splits.

Counterpart of ``vqvae3d_tpu/cli/calc_ssim_from_checkpoint.py`` (reference
vqvae/calc_ssim_from_checkpoint.py), with its flags plus ``--device``
(default ``cuda``; no fallback to the CPU when CUDA is absent): per batch
the slice-wise 3D SSIM (``metrics.evaluate.ssim3d_slices``) of the ELU of
the reconstruction against the input, data range 4.24 (the normalised HU
range [-0.24, 4]); per split the mean ± std, then a JSON summary
``{split: {"ssim_mean", "ssim_std", "n"}}``. Whole volumes go through the
model (the JAX CLI's folded serving of the literal stem exists for a 16 GB
TPU and is not needed here). Reads a port checkpoint; runs under
``torch.inference_mode()``.

    python -m vqvae3d_tpu_torch.cli.calc_ssim_from_checkpoint CKPT CT_DIR
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.checkpoint import load_model
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.metrics.evaluate import ssim3d_slices

SSIM_DATA_RANGE = 4.24  # reference calc_ssim_from_checkpoint.py:32


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ckpt_path", type=Path)
    parser.add_argument("dataset_path", type=Path)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--rescale-input", type=int, nargs="+", default=None)
    parser.add_argument("--scan-size", type=int, nargs=2, default=[512, 512])
    parser.add_argument("--output-depth", type=int, default=128)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def recon_ssim(model, volume: torch.Tensor) -> torch.Tensor:
    """SSIM of the model's reconstruction of (B, 1, H, W, D) against it."""
    decoded, _ = model(volume)
    return ssim3d_slices(F.elu(decoded.float()), volume.float(), data_range=SSIM_DATA_RANGE)


@torch.inference_mode()
def main(args):
    device = resolve_device(args.device)
    rescale = tuple(args.rescale_input) if args.rescale_input else None
    dm = CTDataModule(
        str(args.dataset_path), batch_size=args.batch_size, rescale_input=rescale,
        size=(*args.scan_size, None), output_depth=args.output_depth,
    )
    model, _ = load_model(args.ckpt_path, device)
    out = {}
    for split, loader in (("train", dm.train_dataloader(epoch=0)), ("val", dm.val_dataloader())):
        vals = [float(recon_ssim(model, torch.from_numpy(b["volume"]).to(device).movedim(-1, 1)))
                for b in loader]
        if vals:
            out[split] = {"ssim_mean": float(np.mean(vals)), "ssim_std": float(np.std(vals)),
                          "n": len(vals)}
            print(f"{split}: SSIM {out[split]['ssim_mean']:.4f} "
                  f"± {out[split]['ssim_std']:.4f} over {len(vals)} batches")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(parse_arguments())
