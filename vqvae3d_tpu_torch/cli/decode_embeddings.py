"""Stage-3 CLI: decode code grids from a sample DB into CT volumes (.nrrd).

Counterpart of ``vqvae3d_tpu/cli/decode_embeddings.py``, with the same
positional arguments and output: for each finest-level sample in the sample
DB, fetch its coarser grids by following the ``condition`` uuids, look the
indices up in the codebooks, run the decoder + ELU, un-normalize to integer
HU and write NRRD with spacings (0.976, 0.976, 3). Samples whose last
finest-grid slice is all zero are tagged 'failure'. The walk follows the
condition chain through as many levels as the checkpoint has (the JAX CLI
stops at two). ``--device`` defaults to ``cuda``; runs under
``torch.inference_mode()``.

``code_store_to_sample_db`` turns the code store written by
``extract_embeddings`` into such a DB, so extracted codes can be decoded.

    python -m vqvae3d_tpu_torch.cli.decode_embeddings DB CKPT OUT_PREFIX
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.checkpoint import load_model
from vqvae3d_tpu_torch.cli.extract_embeddings import read_codes, resolve_device
from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.sample_db import add_samples, create_or_load_db, save_db
from vqvae3d_tpu_torch.data.transforms import hu_unnormalize


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("db_path", type=Path)
    parser.add_argument("ckpt_path", type=Path)
    parser.add_argument("out_path", type=Path, help="output prefix without extension")
    parser.add_argument("--volume-shape", type=int, nargs=3, default=[256, 256, 128],
                        help="decoded volume shape (kept for flag parity; the "
                             "code grids set the shape)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def code_store_to_sample_db(store_path, db_path) -> int:
    """Copy every sample of a code store into a sample DB, coarsest level
    first, each finer grid conditioned on the coarser one's uuid. Returns
    the number of samples."""
    samples = read_codes(store_path)
    num_levels = len(samples[0]) if samples else 0
    db = create_or_load_db(db_path, level=0)
    for lvl in range(num_levels):
        db.setdefault(lvl, {})
    for grids in samples:
        cond = None
        for lvl in reversed(range(num_levels)):
            (cond,) = add_samples(db, lvl, grids[lvl][None],
                                  None if cond is None else [cond])
    for lvl in range(num_levels):
        save_db(db, db_path, lvl)
    return len(samples)


def decode_samples(model, sample_db, device):
    """Yield (name, volume (H, W, D) ndarray) per finest-level sample."""
    n_levels = model.config.n_bottleneck_blocks
    for key0, entry0 in sample_db[0].items():
        grids, keys, entry = [np.asarray(entry0["data"])], [key0], entry0
        while len(grids) < n_levels:
            key = entry["condition"]
            if key is None or key not in sample_db.get(len(grids), {}):
                raise ValueError(
                    f"sample {key0}: condition chain ends at level {len(grids) - 1}, "
                    f"the model has {n_levels} levels"
                )
            entry = sample_db[len(grids)][key]
            grids.append(np.asarray(entry["data"]))
            keys.append(key)
        success = "failure" if np.all(grids[0][..., -1] == 0) else "success"
        embeddings = [
            model.embed_code(lvl, torch.from_numpy(g.astype(np.int64)).to(device)[None])
            .movedim(-1, 1)
            for lvl, g in enumerate(grids)
        ]
        out = F.elu(model.decode(embeddings).float())
        vol = out[0, 0].cpu().numpy()
        key1 = keys[1] if len(keys) > 1 else None
        yield f"{success}_{key1}_{key0}", vol


@torch.inference_mode()
def main(args):
    device = resolve_device(args.device)
    args.out_path.parent.mkdir(parents=True, exist_ok=True)
    model, _ = load_model(args.ckpt_path, device)
    db = create_or_load_db(args.db_path, level=0)
    n = 0
    for name, vol in decode_samples(model, db, device):
        hu = hu_unnormalize(vol)
        out_file = str(args.out_path) + f"_{name}.nrrd"
        nrrd_io.write(out_file, hu.astype(np.int32), header={"spacings": (0.976, 0.976, 3)})
        print(f"wrote {out_file}")
        n += 1
    print(f"decoded {n} samples")
    return n


if __name__ == "__main__":
    main(parse_arguments())
