"""Stage-1.5 CLI: run the encoder over a CT dataset and write per-level code
grids into a multi-level code store.

Counterpart of ``vqvae3d_tpu/cli/extract_embeddings.py``, with the same flags
and the same code-store output (the port's copy,
``vqvae3d_tpu_torch.data.code_store``), plus
``--device`` (default ``cuda``; no fallback to the CPU when CUDA is absent).
Reads a port checkpoint (``vqvae3d_tpu_torch.checkpoint``). Runs under
``torch.inference_mode()``.

    python -m vqvae3d_tpu_torch.cli.extract_embeddings --checkpoint-path CKPT \\
        --dataset-path CT_DIR --output-path OUT --rescale-input 0
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from vqvae3d_tpu_torch.checkpoint import load_model
from vqvae3d_tpu_torch.data.code_store import CodeStore, CodeStoreWriter
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output-path", type=Path, default=Path("."))
    parser.add_argument("--output-name", type=str, default="codes")
    parser.add_argument("--checkpoint-path", type=Path, required=True)
    parser.add_argument("--dataset-path", type=Path, required=True)
    parser.add_argument("--rescale-input", type=int, nargs="+",
                        default=[256, 256, 128],
                        help="pass a single 0 to disable rescaling")
    parser.add_argument("--backend", choices=["auto", "lmdb", "file"], default="auto")
    parser.add_argument("--scan-size", type=int, nargs=2, default=[512, 512])
    parser.add_argument("--output-depth", type=int, default=128)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def read_codes(store_path) -> list:
    """The code grids written to ``store_path``: one list per sample, finest
    level first, each an int32 (H, W, D) array."""
    store = CodeStore(str(store_path))
    return [[store.get(i, lvl) for lvl in range(store.num_levels)]
            for i in range(store.length)]


@torch.inference_mode()
def main(args):
    device = resolve_device(args.device)
    rescale = tuple(args.rescale_input) if args.rescale_input else None
    if rescale is not None and 0 in rescale:
        rescale = None
    dm = CTDataModule(
        str(args.dataset_path),
        batch_size=1,
        train_frac=1.0,
        num_workers=5,
        rescale_input=rescale,
        size=(*args.scan_size, None),
        output_depth=args.output_depth,
    )
    if dm.train_len == 0:
        raise ValueError(f"no compatible scans found under {args.dataset_path}")
    model, config = load_model(args.checkpoint_path, device)

    out_path = str(args.output_path / args.output_name)
    writer = CodeStoreWriter(
        out_path,
        num_levels=config.n_bottleneck_blocks,
        num_embeddings=list(config.num_embeddings),
        backend=args.backend,
    )
    n = 0
    for i, batch in enumerate(dm.train_dataloader(epoch=0)):
        # (B, H, W, D, 1) host volume -> (B, 1, H, W, D) on the device
        vol = torch.from_numpy(np.asarray(batch["volume"])).to(device).movedim(-1, 1)
        results = model.encode(vol)
        writer.write_sample(
            i, [idx[0].to(torch.int32).cpu().numpy() for (_, _, idx) in results]
        )
        n += 1
    writer.close()
    print(f"wrote {n} samples × {config.n_bottleneck_blocks} levels to {out_path}")
    return out_path


if __name__ == "__main__":
    main(parse_arguments())
