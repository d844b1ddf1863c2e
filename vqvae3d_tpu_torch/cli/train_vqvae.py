"""Stage-1 CLI: train the hierarchical 3D VQ-VAE on CT volumes.

Counterpart of ``vqvae3d_tpu/cli/train_vqvae.py``, with the same flags plus
``--device`` (default ``cuda``; no fallback to the CPU when CUDA is absent):
the model's config fields, ``--rescale-input``, ``--batch-size``, seed 42,
validation every ``--val-every-steps`` (0: every half train epoch), the last
checkpoint in ``--ckpt-dir`` and the best on ``val_recon_loss_mean`` under
``--ckpt-dir``/best. ``--resume`` continues from the newest checkpoint there
(params, EMA codebooks, optimizer state, step). ``--profile-dir`` writes a
``torch.profiler`` trace of steps 10-15. The mesh and multi-host flags
(``--mesh-shape``, ``--multihost``, ``--coordinator``) raise
``NotImplementedError``: multi-GPU training is not ported yet.

    python -m vqvae3d_tpu_torch.cli.train_vqvae /data/ct \\
        --batch-size 1 --num-embeddings 128 256 512 \\
        --n-pre-quantization-blocks 50 --n-post-quantization-blocks 50 \\
        --n-post-upscale-blocks 3 --n-post-downscale-blocks 2 \\
        --stem-space-to-depth 2 --base-network-channels 8 \\
        --max-steps 100000 --ckpt-dir ckpts/vqvae
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from vqvae3d_tpu_torch.checkpoint import latest_step, restore_train_state, save_train_state
from vqvae3d_tpu_torch.cli.common import MetricLogger, add_dataclass_args, dataclass_from_args
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.data.device_feed import device_prefetch
from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig
from vqvae3d_tpu_torch.train.state import AMSGrad
from vqvae3d_tpu_torch.train.vqvae_train import make_eval_step, make_train_step


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser = add_dataclass_args(parser, VQVAEConfig)
    parser.add_argument("dataset_path", type=Path)
    parser.add_argument("--rescale-input", type=int, nargs="+", default=None)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--max-steps", type=int, default=int(1e5))
    parser.add_argument("--val-every-steps", type=int, default=0,
                        help="0 = validate every half train epoch")
    parser.add_argument("--log-every-n-steps", type=int, default=50)
    parser.add_argument("--ckpt-dir", type=str, default="ckpts/vqvae")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-workers", type=int, default=5)
    parser.add_argument("--mesh-shape", type=int, nargs="+", default=None,
                        help="not ported (multi-GPU): raises")
    parser.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 10-15 here")
    parser.add_argument("--multihost", action="store_true", help="not ported: raises")
    parser.add_argument("--coordinator", type=str, default=None, help="not ported: raises")
    parser.add_argument("--scan-size", type=int, nargs=2, default=[512, 512],
                        help="expected (H, W) of input scans; others are dropped")
    parser.add_argument("--output-depth", type=int, default=128,
                        help="depth volumes are zero-padded/truncated to")
    parser.add_argument("--volume-cache", type=str, default=None,
                        help="decode-once cache dir of preprocessed volumes "
                             "(also via VQVAE3D_VOLUME_CACHE)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args):
    if args.mesh_shape or args.multihost or args.coordinator:
        raise NotImplementedError(
            "--mesh-shape / --multihost / --coordinator: multi-GPU training is not ported yet"
        )
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    config = dataclass_from_args(VQVAEConfig, args, overrides={"dtype": dtype})
    model = VQVAE(config, generator=torch.Generator().manual_seed(args.seed), device=device)
    dm = CTDataModule(
        str(args.dataset_path),
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        rescale_input=tuple(args.rescale_input) if args.rescale_input else None,
        seed=args.seed,
        size=(*args.scan_size, None),
        output_depth=args.output_depth,
        cache_dir=args.volume_cache,
    )
    print(f"dataset: {dm.train_len} train / {dm.val_len} val scans")
    if dm.train_len < args.batch_size:
        raise ValueError("not enough scans for one batch")
    optimizer = AMSGrad(model.parameters(), lr=config.base_lr)
    step = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        step = restore_train_state(args.ckpt_dir, model, optimizer)
        print(f"resumed from step {step}")

    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)
    logger = MetricLogger(args.ckpt_dir)
    val_every = args.val_every_steps or max(1, dm.train_len // (2 * args.batch_size))
    best_val = float("inf")
    epoch, profiler = 0, None
    t_mark, step_mark = time.perf_counter(), step
    while step < args.max_steps:
        for batch in device_prefetch(dm.train_dataloader(epoch=epoch), device):
            log = train_step(batch)
            step += 1
            if args.profile_dir and step == 10:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                profiler.start()
            if profiler is not None and step == 15:
                _sync(device)
                profiler.stop()
                Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(Path(args.profile_dir) / "train_trace.json"))
                profiler = None
            if step % args.log_every_n_steps == 0:
                _sync(device)
                now = time.perf_counter()
                flat = logger.log(step, log, prefix="train")
                flat["step_ms"] = 1e3 * (now - t_mark) / (step - step_mark)
                logger.print(step, flat)
                t_mark, step_mark = now, step

            if step % val_every == 0 or step >= args.max_steps:
                val_logs = [eval_step(vb) for vb in device_prefetch(dm.val_dataloader(), device)]
                if val_logs:
                    mean_log = {k: float(np.mean([float(v[k]) for v in val_logs]))
                                for k in val_logs[0]}
                    logger.print(step, logger.log(step, mean_log, prefix="val"))
                    save_train_state(args.ckpt_dir, model, optimizer, config, step, max_to_keep=1)
                    if mean_log["recon_loss_mean"] < best_val:
                        best_val = mean_log["recon_loss_mean"]
                        save_train_state(Path(args.ckpt_dir) / "best", model, optimizer, config,
                                         step, max_to_keep=1)
                t_mark, step_mark = time.perf_counter(), step
            if step >= args.max_steps:
                break
        epoch += 1

    save_train_state(args.ckpt_dir, model, optimizer, config, step, max_to_keep=1)
    print(f"done at step {step}; best val_recon_loss_mean={best_val:.5g}")
    return model, optimizer, step


if __name__ == "__main__":
    main(parse_arguments())
