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
draws what an uninterrupted one does.
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
    log = {
        "loss_min": torch.min(unreduced),
        "loss_max": torch.max(unreduced),
        "loss_mean": loss,
        "loss_std": torch.std(unreduced, correction=0),
        "bits_per_dim": bits_per_dim(loss),
    }
    if not train:
        log["accuracy"] = torch.mean((logits.argmax(1) == data.long()).float())
    return loss, {k: v.detach() for k, v in log.items()}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` (0 for the first) of a run
    seeded ``seed``: seeded from (seed, step) alone."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device).manual_seed(mixed)


def make_prior_train_step(model, optimizer, seed: int = 0):
    """The train step: batch -> log dict (0-d tensors on the model's device).
    One forward in training mode (dropout, mixup), the backward, and one
    optimizer step; params and the optimizer state change in place. The
    random draws come from ``step_generator(seed, optimizer.count)``."""
    device = next(model.parameters()).device

    def train_step(batch):
        gen = step_generator(seed, optimizer.count, device)
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
