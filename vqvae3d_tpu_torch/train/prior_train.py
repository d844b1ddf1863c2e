"""Stage-2 (prior) loss and the train and eval steps.

Counterpart of ``vqvae3d_tpu/train/prior_train.py:81-191`` (reference
pixel_model/pixelcnn.py:102-148), with the same log-dict keys:

  * data -> one-hot in the model's dtype (fp32 under mixup, so that the
    λ-mixing is exact); the condition -> one-hot of the coarser grid, which
    the model upsamples;
  * optional mixup over the batch (Sattolo pairing, Beta(α, α) λ);
  * per-voxel cross-entropy, its min/max/mean/std, bits/dim, and in eval the
    argmax accuracy.

The JAX train path computes its loss on 2x-folded logits (a TPU layout
device, exact because the loss is voxel-pointwise); the port computes it at
full resolution. Batches are the loader's dicts {'data': (B, s0, s1, s2)
int, 'condition': optional coarser grid}. The optimizer is
``train.state.AMSGrad`` at the prior's ``lr``. Either prior trains here:
PixelCNN (channel dropout ``dropout_prob``) and PixelSNAIL (channel dropout
``causal_dropout_prob`` and attention dropout ``attention_dropout_prob``);
the model draws both from the step's generator.

Random draws per step: ``make_prior_train_step(..., seed=s)`` draws each
step's dropout masks and mixup from ``step_generator(s, step)``, a function
of the seed and the optimizer's step count only, as the JAX step folds the
step into its key (``vqvae3d_tpu/train/prior_train.py:153``): a resumed run
draws what an uninterrupted one does. Under a process group of more than
one rank the generator also folds in the rank, so the ranks draw their own
masks for their own samples (a step there differs from the one-process step
on the global batch by its draws only: JAX draws one λ and one pairing over
the global batch, each rank here its own over its slice); the gradients are
averaged over ranks and the log holds the global batch's values
(``parallel.mesh``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vqvae3d_tpu_torch.models.prior_utils import (
    bits_per_dim,
    cross_entropy,
    idx_to_one_hot,
    mixup_cross_entropy,
    mixup_data,
)
from vqvae3d_tpu_torch.parallel import mesh
from vqvae3d_tpu_torch.parallel.multihost import rank


def prior_loss_fn(model, batch: Dict[str, torch.Tensor], *, train: bool,
                  generator: Optional[torch.Generator] = None,
                  keep: Optional[torch.Tensor] = None, mix: Optional[tuple] = None):
    """Returns (loss, log). ``generator`` draws the dropout masks and the
    mixup λ and pairing; ``keep`` (L, B, 3·Cb) and ``mix`` (λ, index) give
    them instead."""
    cfg = model.config
    data = batch["data"]
    mixup = cfg.mixup_alpha != 0 and train
    model_input = idx_to_one_hot(data, cfg.input_dim,
                                 dtype=torch.float32 if mixup else cfg.dtype)
    condition = None
    if cfg.use_conditioning:
        condition = idx_to_one_hot(batch["condition"], cfg.condition_dim)
    targets = data
    if mixup:
        lam, index = mix if mix is not None else (None, None)
        model_input, condition, targets, lam = mixup_data(
            model_input, data, cfg.mixup_alpha, condition, generator=generator, lam=lam,
            index=index)
    logits = model(model_input, condition, train=train, keep=keep, generator=generator)
    unreduced = (mixup_cross_entropy(logits, targets, lam) if mixup
                 else cross_entropy(logits, targets))
    loss = torch.mean(unreduced)
    log = _global_log(unreduced.detach(), loss, None if train else logits, data)
    log["bits_per_dim"] = bits_per_dim(log["loss_mean"])
    return loss, {k: v.detach() for k, v in log.items()}


@torch.no_grad()
def _global_log(unreduced, loss, logits, data) -> Dict[str, torch.Tensor]:
    """The log over the global batch from each rank's slice (an equal count
    of voxels a rank; at world size 1 the batch's own): means averaged over
    ranks, the std two-pass from the global mean, min and max over ranks;
    with ``logits`` the accuracy."""
    mean = {"loss_mean": loss}
    if logits is not None:
        mean["accuracy"] = torch.mean((logits.argmax(1) == data.long()).float())
    mean = mesh.all_reduce_dict(mean, "mean")
    var = mesh.all_reduce_dict(
        {"var": torch.mean(torch.square(unreduced - mean["loss_mean"]))}, "mean")["var"]
    return {**mesh.all_reduce_dict({"loss_min": torch.min(unreduced)}, "min"),
            **mesh.all_reduce_dict({"loss_max": torch.max(unreduced)}, "max"),
            "loss_mean": mean["loss_mean"], "loss_std": torch.sqrt(var),
            **({"accuracy": mean["accuracy"]} if logits is not None else {})}


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The generator of train step ``step`` (0 for the first) of a run
    seeded ``seed`` on process ``rank``: seeded from (seed, step) alone on
    rank 0 (and without a process group), from (seed, step, rank) on the
    others."""
    entropy = [seed, step] + ([rank] if rank else [])
    mixed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device).manual_seed(mixed)


def make_prior_train_step(model, optimizer, seed: int = 0):
    """The train step: batch -> log dict (0-d tensors on the model's device).
    One forward in training mode (dropout, mixup), the backward, and one
    optimizer step; params and the optimizer state change in place. The
    random draws come from ``step_generator(seed, optimizer.count, rank)``.
    Under a process group AMSGrad averages the gradient over ranks before
    its update (a parameter that no loss reaches, such as a Fixup PixelCNN's
    ``embed_condition``, has no gradient on any rank and counts as zero)."""
    device = next(model.parameters()).device

    def train_step(batch):
        gen = step_generator(seed, optimizer.count, device, rank())
        optimizer.zero_grad()
        loss, log = prior_loss_fn(model, batch, train=True, generator=gen)
        loss.backward()
        optimizer.step()
        return log

    return train_step


def make_prior_eval_step(model):
    """The eval step: batch -> log dict including ``accuracy``."""

    @torch.no_grad()
    def eval_step(batch):
        return prior_loss_fn(model, batch, train=False)[1]

    return eval_step
