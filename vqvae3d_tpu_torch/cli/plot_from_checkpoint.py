"""Visual-check CLI: reconstruct one dataset volume and write it as NRRD.

Counterpart of ``vqvae3d_tpu/cli/plot_from_checkpoint.py`` (reference
vqvae/plot_from_checkpoint.py), with its flags plus ``--device`` (default
``cuda``; no fallback to the CPU when CUDA is absent): the volume at
``--sample-index`` goes through the model, then ELU and
``hu_unnormalize``; ``<out_path>_orig.nrrd`` and ``<out_path>_recon.nrrd``
are written with spacings (0.976, 0.976, 3). Reads a port checkpoint; runs
under ``torch.inference_mode()``.

    python -m vqvae3d_tpu_torch.cli.plot_from_checkpoint CKPT CT_DIR OUT_PREFIX
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.checkpoint import load_model
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.data.transforms import hu_unnormalize


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ckpt_path", type=Path)
    parser.add_argument("dataset_path", type=Path)
    parser.add_argument("out_path", type=Path, help="output prefix (no extension)")
    parser.add_argument("--sample-index", type=int, default=0)
    parser.add_argument("--rescale-input", type=int, nargs="+", default=None)
    parser.add_argument("--scan-size", type=int, nargs=2, default=[512, 512])
    parser.add_argument("--output-depth", type=int, default=128)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


@torch.inference_mode()
def main(args):
    device = resolve_device(args.device)
    rescale = tuple(args.rescale_input) if args.rescale_input else None
    dm = CTDataModule(
        str(args.dataset_path), batch_size=1, train_frac=1.0, rescale_input=rescale,
        size=(*args.scan_size, None), output_depth=args.output_depth,
    )
    vol, _ = dm.dataset[args.sample_index]
    model, _ = load_model(args.ckpt_path, device)
    decoded, _ = model(torch.from_numpy(vol)[None].to(device).movedim(-1, 1))
    recon = F.elu(decoded.float())[0, 0].cpu().numpy()
    written = []
    for name, arr in (("orig", vol[..., 0]), ("recon", recon)):
        out = str(args.out_path) + f"_{name}.nrrd"
        nrrd_io.write(out, hu_unnormalize(arr), header={"spacings": (0.976, 0.976, 3)})
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main(parse_arguments())
