"""Stage-2.5 CLI: ancestral sampling of code grids into the sample DB.

Counterpart of ``vqvae3d_tpu/cli/sample_embeddings.py``, with its flags plus
``--device`` (default ``cuda``; no fallback to the CPU): load a trained prior
(a port checkpoint, ``checkpoint.save_prior``; PixelCNN or PixelSNAIL, which
``--use-model`` must name), sample ``--num-samples`` grids of ``--size`` in
batches of ``--batch-size``, each conditioned on a random grid of the
next-coarser level in the DB (the pool repeats when it is small) when the
prior is conditioned, and store {uuid: {'data', 'condition'}} under the
level with merge-on-save. A conditioned prior needs that level in the DB, an
unconditioned one refuses it. ``--sampler cached`` runs the exact cached
sampler of the prior's class (PixelCNN: kernel K6 per row on a card at
kernel size 3, its own row steps at any other odd size, and a Fixup or
concat-activation PixelCNN refused with ``ValueError``; PixelSNAIL:
``sample/cached_snail.py``, appended K/V per stream), ``naive`` the O(V²)
full-forward loop, which samples every prior (PixelSNAIL's forward takes
kernel K8 on a card).

    python -m vqvae3d_tpu_torch.cli.sample_embeddings --model-checkpoint CKPT \\
        --db-path samples.db --level 0 --size 128 128 32 --tau 0.1
    python -m vqvae3d_tpu_torch.cli.sample_embeddings --model-checkpoint SNAIL \\
        --db-path samples.db --level 1 --size 32 32 8 --num-samples 10 \\
        --batch-size 10 --use-model pixelsnail --tau 0.1
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from vqvae3d_tpu_torch.checkpoint import load_prior
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data.sample_db import (
    add_samples,
    create_or_load_db,
    get_condition_uuids,
    get_conditions,
    save_db,
)
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL
from vqvae3d_tpu_torch.sample.ar_sample import ancestral_sample
from vqvae3d_tpu_torch.sample.cached_sample import make_cached_sampler
from vqvae3d_tpu_torch.sample.cached_snail import make_cached_snail_sampler


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-checkpoint", type=Path, required=True)
    parser.add_argument("--db-path", type=Path, required=True)
    parser.add_argument("--level", type=int, required=True)
    parser.add_argument("--size", type=int, nargs=3, required=True,
                        help="code-grid spatial dims (s0 s1 s2)")
    parser.add_argument("--num-samples", type=int, default=1)
    parser.add_argument("--use-model", choices=["pixelcnn", "pixelsnail"], default="pixelcnn")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--tau", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds a torch.Generator on the device; the grids differ "
                             "from the JAX CLI's for the same seed (another generator)")
    parser.add_argument("--sampler", choices=["cached", "naive"], default="cached",
                        help="'cached' = exact incremental sampler; 'naive' = one "
                             "full forward per voxel (tiny grids only)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not 1 <= args.batch_size <= args.num_samples:
        parser.error("need 1 <= --batch-size <= --num-samples")
    if args.tau <= 0 or args.level < 0:
        parser.error("need --tau > 0 and --level >= 0")
    return args


def main(args):
    """Sample and store the grids; returns their new uuids."""
    device = resolve_device(args.device)
    dims = tuple(args.size)
    db = create_or_load_db(args.db_path, args.level)
    model, config = load_prior(args.model_checkpoint, device)
    snail = isinstance(model, PixelSNAIL)
    if snail != (args.use_model == "pixelsnail"):
        raise ValueError(f"--use-model {args.use_model}, but the checkpoint holds a "
                         f"{type(model).__name__} prior")
    has_cond_pool = bool(db.get(args.level + 1))
    if config.use_conditioning != has_cond_pool:
        raise ValueError("a conditioned prior needs coarser-level samples in the DB, and an "
                         "unconditioned one none")
    if args.sampler == "cached":
        make = make_cached_snail_sampler if snail else make_cached_sampler
        sampler = make(model, dims, args.batch_size, args.tau)
    else:
        def sampler(cond, generator):
            return ancestral_sample(model, dims, args.batch_size, cond, args.tau,
                                    generator=generator)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    new = []
    for i in range(args.num_samples // args.batch_size):
        t0 = time.perf_counter()
        cond_uuids, cond = None, None
        if has_cond_pool:
            cond_uuids = get_condition_uuids(db, args.level, args.batch_size)
            cond = torch.from_numpy(get_conditions(db, args.level, cond_uuids).astype(np.int64))
        grids = sampler(cond, generator=generator).cpu().numpy()
        new += add_samples(db, args.level, grids, cond_uuids)
        print(f"batch {i}: sampled {len(grids)} grids at level {args.level} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    save_db(db, args.db_path, args.level)
    print(f"saved {len(db[args.level])} total level-{args.level} samples")
    return new


if __name__ == "__main__":
    main(parse_arguments())
