"""Prior convergence run: several hundred steps of the published top prior
(PixelCNN 50 x 16d over 128 codes, conditioned on 256; grid 128x128x32 on
32x32x8) on structured synthetic code grids, logging the loss, bits/dim and
the held-out accuracy to JSONL, then a save and, in a fresh process, a
restore and more steps.

Counterpart of ``tools/prior_convergence_smoke.py`` of the JAX package: the
same config (dropout 0, bf16, lr ``--lr``), the same grids from the same
seeds (``synth_codes``: ``--n-samples`` training samples from seeds 1000,
1001, ..., the held-out one from 9999) and the same loop: step ``s`` (0 for
the first) trains on sample ``s % n``, a log line every ``--log-every``
steps and at step 1, a validation on the held-out grid every
``--eval-every`` steps and at the end, ``--steps`` on a fresh start,
``--resume-steps`` after a checkpoint is found in ``--out``, one save at the
end. Each step draws from ``prior_train.step_generator(7, step)`` (nothing
at dropout 0 and no mixup), so a resumed run replays the uninterrupted one.
Each train line of ``<out>/metrics.jsonl`` also holds ``wall_step_ms`` (host
clock around the step, which ends synchronised) and, on a card,
``cuda_step_ms`` (CUDA events). The weights start from seed 0. ``--device``
defaults to ``cuda`` and never falls back to the CPU.

    python -m vqvae3d_tpu_torch.tools.prior_convergence_smoke --out prior_conv \\
        --steps 300            # leg 1: 0 -> 300, saves
    python -m vqvae3d_tpu_torch.tools.prior_convergence_smoke --out prior_conv \\
        --resume-steps 200     # leg 2 (fresh process): 300 -> 500
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vqvae3d_tpu_torch.checkpoint import (latest_step, restore_prior_train_state,
                                          save_prior_train_state)
from vqvae3d_tpu_torch.cli.common import MetricLogger
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.train.prior_train import make_prior_eval_step, make_prior_train_step
from vqvae3d_tpu_torch.train.state import AMSGrad
from vqvae3d_tpu_torch.utils.profiling import StepTimer

DIMS, COND_DIMS = (128, 128, 32), (32, 32, 8)
SEED = 0  # the weights' seed (the JAX tool's PRNGKey(0))
STEP_SEED = 7  # the steps' generator (the JAX tool's PRNGKey(7))
HELDOUT_SEED = 9999


def _upsample_np(lo: np.ndarray, dims) -> np.ndarray:
    """Nearest upsample (np.repeat) and one box smoothing pass per axis
    (moving average, window = the factor): smooth enough for spatial
    correlation, cheap on one core."""
    f = [dims[i] // lo.shape[i] for i in range(3)]
    up = lo
    for ax, fa in enumerate(f):
        up = np.repeat(up, fa, axis=ax)
    for ax, fa in enumerate(f):
        if fa <= 1:
            continue
        kernel = np.ones(fa, np.float32) / fa
        up = np.apply_along_axis(lambda m: np.convolve(m, kernel, mode="same"), ax, up)
    return up[: dims[0], : dims[1], : dims[2]]


def synth_codes(seed: int, dims, k: int, cond_dims, k_cond: int):
    """(data, condition) int32 grids of one sample: a smooth random field
    (low-resolution normal noise upsampled, plus 0.15 of white noise) cut
    into ``k`` equal-probability bins, and the field's block means over
    ``cond_dims`` cut into ``k_cond`` bins, so the condition carries real
    information. The JAX tool's draws from the same seed."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(max(dims[0] // 8, 1), max(dims[1] // 8, 1),
                          max(dims[2] // 4, 1))).astype(np.float32)
    field = _upsample_np(lo, dims) + 0.15 * rng.normal(size=dims).astype(np.float32)
    qs = np.quantile(field, np.linspace(0, 1, k + 1)[1:-1])
    data = np.searchsorted(qs, field).astype(np.int32)
    cfield = field.reshape(cond_dims[0], dims[0] // cond_dims[0], cond_dims[1],
                           dims[1] // cond_dims[1], cond_dims[2],
                           dims[2] // cond_dims[2]).mean(axis=(1, 3, 5))
    cqs = np.quantile(cfield, np.linspace(0, 1, k_cond + 1)[1:-1])
    cond = np.searchsorted(cqs, cfield).astype(np.int32)
    return data, cond


def top_prior_config(lr: float = 1e-4) -> PixelCNNConfig:
    """The published top prior (the JAX tool's config), bf16."""
    return PixelCNNConfig(input_dim=128, condition_dim=256, model_dim=16, num_resblocks=50,
                          dropout_prob=0.0, lr=lr, dtype=torch.bfloat16)


def run(config: PixelCNNConfig, samples, heldout, out, *, steps: int, resume_steps: int,
        log_every: int = 10, eval_every: int = 50, device="cuda", state_dict=None):
    """Train from seed ``SEED`` (or ``state_dict``) for ``steps``, or, when
    ``out`` holds a checkpoint, from it for ``resume_steps``, on ``samples``
    (a list of (data, condition) grids); validate on ``heldout``; log to
    ``<out>/metrics.jsonl`` and save the train state there at the end.
    Returns (model, optimizer, step)."""
    device = resolve_device(device)
    model = PixelCNN(config, generator=torch.Generator().manual_seed(SEED), device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    optimizer = AMSGrad(model.parameters(), lr=config.lr)
    step = 0
    resumed = latest_step(out) is not None
    if resumed:
        step = restore_prior_train_state(out, model, optimizer)
        print(f"RESUMED from step {step}", flush=True)
    train_step = make_prior_train_step(model, optimizer, seed=STEP_SEED)
    eval_step = make_prior_eval_step(model)
    logger = MetricLogger(out)
    timer = StepTimer(device)

    def batch(sample):
        return {"data": torch.from_numpy(sample[0][None]).to(device),
                "condition": torch.from_numpy(sample[1][None]).to(device)}

    val_batch = batch(heldout)
    target = step + (resume_steps if resumed else steps)
    t0, wall = time.perf_counter(), []
    while step < target:
        train_batch = batch(samples[step % len(samples)])
        t_step = time.perf_counter()
        with timer:  # ends synchronised on a card
            log = train_step(train_batch)
        step += 1
        wall.append(1e3 * (time.perf_counter() - t_step))
        if step % log_every == 0 or step == 1:
            times = {"wall_step_ms": wall[-1]}
            if timer.cuda:
                times["cuda_step_ms"] = timer.last_ms
            flat = logger.log(step, {**{f"train_{k}": v for k, v in log.items()}, **times})
            print(f"[step {step}] loss={flat['train_loss_mean']:.4f} "
                  f"bits/dim={flat['train_bits_per_dim']:.4f} ({wall[-1] / 1e3:.2f}s)",
                  flush=True)
        if step % eval_every == 0 or step == target:
            flat = logger.log(step, eval_step(val_batch), prefix="val")
            print(f"[step {step}] VAL bits/dim={flat['val_bits_per_dim']:.4f} "
                  f"acc={flat['val_accuracy']:.4f} (chance {1 / config.input_dim:.4f})",
                  flush=True)
    save_prior_train_state(out, model, optimizer, step, max_to_keep=2)
    events = f", CUDA events {timer.mean_ms:.2f}" if timer.cuda else ""
    print(f"done at step {step} in {time.perf_counter() - t0:.0f}s; ms a step after the first: "
          f"wall {np.mean(wall[1:] or wall):.2f}{events}; checkpoint saved to {out}", flush=True)
    return model, optimizer, step


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="prior_conv")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--resume-steps", type=int, default=200)
    p.add_argument("--n-samples", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(args):
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    config = top_prior_config(args.lr)
    print(f"generating {args.n_samples} synthetic code samples...", flush=True)
    samples = [synth_codes(1000 + i, DIMS, config.input_dim, COND_DIMS, config.condition_dim)
               for i in range(args.n_samples)]
    heldout = synth_codes(HELDOUT_SEED, DIMS, config.input_dim, COND_DIMS, config.condition_dim)
    return run(config, samples, heldout, args.out, steps=args.steps,
               resume_steps=args.resume_steps, log_every=args.log_every,
               eval_every=args.eval_every, device=device)


if __name__ == "__main__":
    main(parse_arguments())
