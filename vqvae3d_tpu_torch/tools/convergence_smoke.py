"""Stage-1 convergence run: several hundred steps of the downscaled 2-level
config on synthetic CT-like volumes, logging the loss and each level's
codebook perplexity and utilisation to JSONL, then a save and, in a fresh
process, a restore and more steps.

Counterpart of ``tools/convergence_smoke.py`` of the JAX package: the same
config (2 levels, codebooks 128 / 256, ``--blocks`` pre- and
post-quantization blocks a level, 5 + 5 post-resize blocks, bf16, the
space-to-depth stem 2, base 8, lr ``--lr``), the same synthetic scans from
the same seed (``make_diverse_ct_dir``), the same data
(``CTDataModule(train_frac=1.0)`` at (``--res``, ``--res``) over depth-110
scans padded to 128, batch 1) and the same loop: ``--steps`` on a fresh
start, ``--resume-steps`` after a checkpoint is found in ``--out`` (the
loader restarts at epoch 0, as in JAX), a log line every ``--log-every``
steps and at step 1, one save at the end. Each log line of
``<out>/metrics.jsonl`` holds the step's log under ``train_`` and its time:
``wall_step_ms`` (host clock around the step, which ends synchronised) and,
on a card, ``cuda_step_ms`` (CUDA events). The weights start from seed 42.
``--device`` defaults to ``cuda`` and never falls back to the CPU.

    python -m vqvae3d_tpu_torch.tools.convergence_smoke --data ct_conv \\
        --out conv_run --steps 300                  # leg 1: 0 -> 300, saves
    python -m vqvae3d_tpu_torch.tools.convergence_smoke --data ct_conv \\
        --out conv_run --resume-steps 200           # leg 2 (fresh process): 300 -> 500
    python -m vqvae3d_tpu_torch.tools.convergence_smoke --data ct_conv \\
        --out conv_step0 --steps 0                  # the step-0 weights, saved
    python -m vqvae3d_tpu_torch.cli.calc_ssim_from_checkpoint conv_run ct_conv \\
        --scan-size 256 256
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from vqvae3d_tpu_torch.checkpoint import latest_step, restore_train_state, save_train_state
from vqvae3d_tpu_torch.cli.common import MetricLogger
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.data.device_feed import device_prefetch
from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig
from vqvae3d_tpu_torch.train.state import AMSGrad
from vqvae3d_tpu_torch.train.vqvae_train import make_train_step
from vqvae3d_tpu_torch.utils.profiling import StepTimer

DEPTH = 110  # slices a synthetic scan
SEED = 42  # the weights' seed (the JAX tool's PRNGKey(42))
PRINTED = ("train_loss", "train_recon_loss_mean", "train_commitment_loss",
           "train_codebook_perplexity_0", "train_codebook_perplexity_1",
           "train_codebook_util_0", "train_codebook_util_1")


def make_diverse_ct_dir(root, n_vols: int, res: int, depth: int, seed: int = 0) -> str:
    """Synthetic CT scans with content diversity: air background, a random
    soft-tissue body cylinder, 20-60 random ellipsoids spanning the HU range
    (air pockets, fat, soft tissue, contrast, bone), a smooth gain field and
    quantized noise; int16 NRRDs with the loader's spacing. The JAX tool's
    draws, in its order, from the same seed."""
    d = Path(root)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    zz = np.arange(depth, dtype=np.float32)
    for i in range(n_vols):
        vol = np.full((res, res, depth), -1000.0, np.float32)  # air
        cy, cx = rng.uniform(0.4, 0.6, 2) * res
        r_body = rng.uniform(0.3, 0.45) * res
        body = ((yy - cy) ** 2 + (xx - cx) ** 2) < r_body**2
        vol[body] = rng.uniform(-80, 80)
        for _ in range(int(rng.integers(20, 60))):
            ey, ex = rng.uniform(0.2, 0.8, 2) * res
            ez = rng.uniform(0.1, 0.9) * depth
            ry, rx = rng.uniform(4, res * 0.12, 2)
            rz = rng.uniform(2, depth * 0.25)
            hu = rng.choice([rng.uniform(-950, -700), rng.uniform(-120, -60),
                             rng.uniform(0, 120), rng.uniform(150, 400),
                             rng.uniform(500, 1500)])
            dist = (((yy - ey) / ry) ** 2 + ((xx - ex) / rx) ** 2)[:, :, None] \
                + (((zz - ez) / rz) ** 2)[None, None, :]
            vol[dist < 1.0] = hu
        gain = 1.0 + 0.1 * np.sin(yy / res * np.pi * rng.uniform(1, 3))
        vol = vol * gain[:, :, None]
        vol += (rng.integers(-2, 3, size=vol.shape) * 15).astype(np.float32)
        nrrd_io.write(d / f"scan{i}.nrrd", np.clip(vol, -1200, 2800).astype(np.int16),
                      header={"spacings": (0.976, 0.976, 3)})
    return str(d)


def downscaled_config(blocks: int = 150, lr: float = 1e-4) -> VQVAEConfig:
    """The JAX tool's config: the published downscaled config with the
    space-to-depth stem 2 at base 8, bf16."""
    return VQVAEConfig(n_bottleneck_blocks=2, num_embeddings=(128, 256),
                       n_pre_quantization_blocks=blocks, n_post_quantization_blocks=blocks,
                       n_post_upscale_blocks=5, n_post_downscale_blocks=5,
                       dtype=torch.bfloat16, stem_space_to_depth=2, base_network_channels=8,
                       base_lr=lr)


def run(config: VQVAEConfig, dm: CTDataModule, out, *, steps: int, resume_steps: int,
        log_every: int = 10, device="cuda", state_dict=None):
    """Train from seed ``SEED`` (or ``state_dict``) for ``steps``, or, when
    ``out`` holds a checkpoint, from it for ``resume_steps``; log to
    ``<out>/metrics.jsonl`` and save the train state there at the end.
    Returns (model, optimizer, step)."""
    device = resolve_device(device)
    if dm.train_len < dm.batch_size:
        raise ValueError("not enough scans for one batch")
    model = VQVAE(config, generator=torch.Generator().manual_seed(SEED), device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    optimizer = AMSGrad(model.parameters(), lr=config.base_lr)
    step = 0
    if latest_step(out) is not None:
        step = restore_train_state(out, model, optimizer)
        print(f"RESUMED from step {step}", flush=True)
    train_step = make_train_step(model, optimizer)
    logger = MetricLogger(out)
    timer = StepTimer(device)
    target = step + (steps if step == 0 else resume_steps)
    t0, wall = time.perf_counter(), []
    epoch = 0
    while step < target:
        for batch in device_prefetch(dm.train_dataloader(epoch=epoch), device):
            t_step = time.perf_counter()
            with timer:  # ends synchronised on a card
                log = train_step(batch)
            step += 1
            wall.append(1e3 * (time.perf_counter() - t_step))
            if step % log_every == 0 or step == 1:
                times = {"wall_step_ms": wall[-1]}
                if timer.cuda:
                    times["cuda_step_ms"] = timer.last_ms
                flat = logger.log(step, {**{f"train_{k}": v for k, v in log.items()}, **times})
                msg = " ".join(f"{k.removeprefix('train_')}={flat[k]:.4g}" for k in PRINTED
                               if k in flat)
                print(f"[step {step}] {msg} ({wall[-1] / 1e3:.2f}s)", flush=True)
            if step >= target:
                break
        epoch += 1
    save_train_state(out, model, optimizer, config, step, max_to_keep=2)
    events = f", CUDA events {timer.mean_ms:.2f}" if timer.cuda else ""
    print(f"done at step {step} in {time.perf_counter() - t0:.0f}s; ms a step after the first: "
          f"wall {np.mean(wall[1:] or wall):.2f}{events}; checkpoint saved to {out}", flush=True)
    return model, optimizer, step


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", default="ct_conv")
    p.add_argument("--out", default="conv_run")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--resume-steps", type=int, default=200)
    p.add_argument("--blocks", type=int, default=150)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--workers", type=int, default=5)
    p.add_argument("--res", type=int, default=256,
                   help="generate and read scans at this (H, W); 256 = the downscaled "
                        "config's resolution without a host rescale")
    p.add_argument("--n-vols", type=int, default=12)
    p.add_argument("--cache", default=None, help="volume-cache dir (default <data>_cache)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(args):
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    if not list(Path(args.data).glob("*.nrrd")):
        print(f"generating {args.n_vols} diverse synthetic scans...", flush=True)
        make_diverse_ct_dir(args.data, args.n_vols, args.res, DEPTH)
    cache = args.cache or (str(args.data).rstrip("/") + "_cache")
    dm = CTDataModule(args.data, batch_size=1, train_frac=1.0, num_workers=args.workers,
                      size=(args.res, args.res, None), cache_dir=cache)
    print(f"dataset: {dm.train_len} scans (cache: {cache})", flush=True)
    return run(downscaled_config(args.blocks, args.lr), dm, args.out, steps=args.steps,
               resume_steps=args.resume_steps, log_every=args.log_every, device=device)


if __name__ == "__main__":
    main(parse_arguments())
