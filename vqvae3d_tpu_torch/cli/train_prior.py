"""Stage-2 CLI: train a prior on one code-grid level.

Counterpart of ``vqvae3d_tpu/cli/train_prior.py``, with its flags plus
``--device`` (default ``cuda``; no fallback to the CPU when CUDA is absent):
two-phase parsing on ``--use-model``, the level's ``num_embeddings``
(input_dim, condition_dim) read from the code store, seed 42, validation
every ``--val-every-steps`` (0: every half train epoch), the last checkpoint
in ``--ckpt-dir`` and the best on ``val_loss_mean`` under ``--ckpt-dir``/best
(``checkpoint.save_prior_train_state``; ``load_prior`` reads either).
``--use-model`` picks the PixelCNN or the PixelSNAIL and its config's flags
(PixelSNAIL: ``--num-blocks``, ``--num-layers-per-block``, ``--num-heads``,
``--causal-dropout-prob``, ``--attention-dropout-prob`` …); the PixelCNN's
``--use-pre-activation False`` (Fixup blocks), ``--use-concat-activation
True`` and ``--kernel-size`` (any odd size) build those PixelCNNs, which run
no K4 (their small-channel causal convs take their weight gradients through
K7). Each step draws
its dropout masks and mixup from a generator seeded from (``--seed`` + 1,
step) (``prior_train.step_generator``). ``--resume`` continues from the
newest checkpoint there (params, optimizer state, step) at the batch the
uninterrupted run would take next, so a resumed run replays the
uninterrupted one (the JAX CLI restarts its loader at epoch 0).
``--profile-dir`` writes a ``torch.profiler`` trace of steps 10-15.
``--scan-stacks`` / ``--remat-scan`` are the JAX package's TPU layout
switches of the PixelCNN, accepted and ignored.

``--multihost`` trains data parallel, one process a card, as
``train_vqvae`` does (its docstring has both launch forms): ``--batch-size``
is the global batch, each rank trains on its contiguous slice of it and
draws its own dropout masks and mixup (``prior_train.step_generator`` folds
in the rank), the gradients are averaged over ranks, the logs are the
global batch's, and only rank 0 prints, writes the metrics, traces and
writes checkpoints.

The published top prior (reference slurm-jobs/train_pixelcnn_top.job), the
bottom PixelSNAIL (jobs/train_pixelsnail_bottom.sh) and the mid PixelSNAIL
conditioned on the bottom codes at the config's dropout defaults (causal and
attention dropout 0.5; bench_prior.py's "mid_pixelsnail"), whose attention
dropout at S = 8192 runs kernel K5:

    python -m vqvae3d_tpu_torch.cli.train_prior codes/ 0 --use-model pixelcnn \\
        --model-dim 16 --num-resblocks 50 --bottleneck-divisor 4 \\
        --dropout-prob 0 --batch-size 1
    python -m vqvae3d_tpu_torch.cli.train_prior codes/ 2 --use-model pixelsnail \\
        --model-dim 512 --num-blocks 3 --num-layers-per-block 5 \\
        --causal-dropout-prob 0.5 --attention-dropout-prob 0 --mixup-alpha 0.4 \\
        --use-conditioning False --batch-size 6
    python -m vqvae3d_tpu_torch.cli.train_prior codes/ 1 --use-model pixelsnail \\
        --model-dim 256 --num-blocks 8 --num-layers-per-block 5 --batch-size 1
"""
from __future__ import annotations

import argparse
import itertools
from pathlib import Path

import numpy as np
import torch

from vqvae3d_tpu_torch.checkpoint import (
    PRIOR_LAYOUT_FIELDS,
    latest_step,
    restore_prior_train_state,
    save_prior_train_state,
)
from vqvae3d_tpu_torch.cli.common import (
    MetricLogger,
    add_dataclass_args,
    booltype,
    dataclass_from_args,
)
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.data.code_store import CodeDataModule
from vqvae3d_tpu_torch.data.device_feed import device_prefetch
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.parallel.mesh import local_batch_size
from vqvae3d_tpu_torch.parallel.multihost import (initialize_multihost, is_primary, rank,
                                                  shutdown, world_size)
from vqvae3d_tpu_torch.train.prior_train import make_prior_eval_step, make_prior_train_step
from vqvae3d_tpu_torch.train.state import AMSGrad
from vqvae3d_tpu_torch.utils.profiling import StepTimer

MODELS = {"pixelcnn": (PixelCNN, PixelCNNConfig), "pixelsnail": (PixelSNAIL, PixelSNAILConfig)}
CONFIG_SKIP = ("dtype", "input_dim", "condition_dim")


def parse_arguments(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--use-model", choices=list(MODELS), default="pixelcnn")
    known, _ = pre.parse_known_args(argv)

    parser = argparse.ArgumentParser(description=__doc__, parents=[pre])
    parser = add_dataclass_args(parser, MODELS[known.use_model][1], skip=CONFIG_SKIP)
    if known.use_model == "pixelcnn":
        for name in PRIOR_LAYOUT_FIELDS:
            parser.add_argument("--" + name.replace("_", "-"), type=booltype, default=True,
                                help="the JAX package's TPU layout switch; ignored")
    parser.add_argument("dataset_path", type=Path)
    parser.add_argument("level", type=int, help="hierarchy level to train (0=finest)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-steps", type=int, default=int(5e4))
    parser.add_argument("--val-every-steps", type=int, default=0)
    parser.add_argument("--log-every-n-steps", type=int, default=50)
    parser.add_argument("--ckpt-dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 10-15 here")
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed process group (one process a card; "
                             "SLURM or torchrun env)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rendezvous host:port for --multihost (default env://)")
    parser.add_argument("--use-conditioning", type=str, default="True")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(args):
    if args.coordinator and not args.multihost:
        raise ValueError("--coordinator needs --multihost")
    device = (initialize_multihost(args.coordinator, device=args.device) if args.multihost
              else resolve_device(args.device))
    world = world_size()
    local_batch_size(args.batch_size, world)
    primary = is_primary()
    proc = dict(process_index=rank(), process_count=world)
    dm = CodeDataModule(str(args.dataset_path), embedding_id=args.level,
                        batch_size=args.batch_size, seed=args.seed)
    if len(dm.train_indices) < args.batch_size:
        raise ValueError("not enough training grids for one batch")
    input_dim, condition_dim = dm.num_embeddings
    use_cond = args.use_conditioning in ("True", "true", "1") and condition_dim > 0
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model_cls, config_cls = MODELS[args.use_model]
    config = dataclass_from_args(
        config_cls, args, skip=CONFIG_SKIP,
        overrides={"input_dim": input_dim, "condition_dim": condition_dim if use_cond else 0,
                   "dtype": dtype})
    model = model_cls(config, generator=torch.Generator().manual_seed(args.seed), device=device)
    ckpt_dir = args.ckpt_dir or f"ckpts/{args.use_model}_level{args.level}"
    if primary:
        print(f"model: {args.use_model}; input_dim={input_dim} "
              f"condition_dim={config.condition_dim}; device {device}; "
              f"{len(dm.train_indices)} train / {len(dm.val_indices)} val grids; "
              f"{world} process(es)")
    optimizer = AMSGrad(model.parameters(), lr=config.lr)
    step = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        step = restore_prior_train_state(ckpt_dir, model, optimizer)
        if primary:
            print(f"resumed from step {step}")

    train_step = make_prior_train_step(model, optimizer, seed=args.seed + 1)
    eval_step = make_prior_eval_step(model)
    logger = MetricLogger(ckpt_dir if primary else None)
    val_every = args.val_every_steps or max(1, len(dm.train_indices) // (2 * args.batch_size))
    best_val = float("inf")
    timer = StepTimer(device)
    # where the uninterrupted run would be: whole batches only, so an epoch
    # is len(train) // batch_size steps
    epoch, skip = divmod(step, len(dm.train_indices) // args.batch_size)
    profiler = None

    def clean(batch):
        if not use_cond:
            batch.pop("condition", None)
        return batch

    while step < args.max_steps:
        batches = itertools.islice(dm.train_dataloader(epoch=epoch, **proc), skip, None)
        skip = 0
        for batch in device_prefetch(batches, device):
            with timer:
                log = train_step(clean(batch))
            step += 1
            if args.profile_dir and primary and step == 10:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                profiler.start()
            if profiler is not None and step == 15:
                profiler.stop()
                Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(Path(args.profile_dir) / "train_trace.json"))
                profiler = None
            if primary and step % args.log_every_n_steps == 0:
                flat = logger.log(step, log, prefix="train")
                flat["step_ms"] = timer.mean_ms
                logger.print(step, flat)
            if step % val_every == 0 or step >= args.max_steps:
                val_logs = [eval_step(clean(vb))
                            for vb in device_prefetch(dm.val_dataloader(**proc), device)]
                if val_logs:
                    # global values, the same on every rank (the same branch below)
                    mean_log = {k: float(np.mean([float(v[k]) for v in val_logs]))
                                for k in val_logs[0]}
                    if primary:
                        logger.print(step, logger.log(step, mean_log, prefix="val"))
                    save_prior_train_state(ckpt_dir, model, optimizer, step, max_to_keep=1)
                    if mean_log["loss_mean"] < best_val:
                        best_val = mean_log["loss_mean"]
                        save_prior_train_state(Path(ckpt_dir) / "best", model, optimizer, step,
                                               max_to_keep=1)
            if step >= args.max_steps:
                break
        epoch += 1

    save_prior_train_state(ckpt_dir, model, optimizer, step, max_to_keep=1)
    if primary:
        print(f"done at step {step}; best val_loss_mean={best_val:.5g}")
    if args.multihost:
        shutdown()
    return model, optimizer, step


if __name__ == "__main__":
    main(parse_arguments())
