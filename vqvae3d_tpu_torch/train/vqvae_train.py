"""Stage-1 (VQ-VAE) loss and the train and eval steps.

Counterpart of ``vqvae3d_tpu/train/vqvae_train.py:44-374`` (reference
vqvae/model.py:95-163), with the same log-dict keys:

  * forward -> ELU on the reconstruction;
  * depth slices beyond each sample's ``num_valid_slices`` zeroed;
  * the center-cylinder weighting as the pre-loss filter (a mask-weighted
    mean, as the JAX package computes it);
  * smooth-L1 (huber, beta = 1) reconstruction loss plus the summed
    per-level commitment losses;
  * min/max/mean/std (and in eval the median) of the per-voxel loss and the
    reconstruction, NMSE, PSNR, and in training the EMA codebooks'
    perplexity and utilization per level.

The JAX train path computes its loss in the stem's space-to-depth layout
(a TPU layout device, exact because every term is voxel-pointwise); the port
computes the same loss at full resolution. ``metric='mixture-nll'`` is not
ported (the model refuses it). Batches are the loader's dicts
{'volume': (B, H, W, D, C) fp32, 'num_valid_slices': (B,) int}, the JAX
step's contract; the model runs on (B, C, H, W, D).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.data.transforms import create_cylinder_xy_mask
from vqvae3d_tpu_torch.metrics.evaluate import nmse, psnr, ssim3d_slices
from vqvae3d_tpu_torch.utils.logging_helpers import median, sub_metric_log_dict

PSNR_DATA_RANGE = 4.0  # reference vqvae/model.py:25


def huber_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (``F.smooth_l1_loss(reduction='none')``)."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def depth_valid_mask(num_valid_slices: torch.Tensor, depth: int) -> torch.Tensor:
    """(B,) ints -> (B, 1, 1, 1, depth) bool mask of the valid depth slices
    (the port's (B, C, H, W, D) layout)."""
    ar = torch.arange(depth, device=num_valid_slices.device)
    return (ar[None, :] < num_valid_slices[:, None])[:, None, None, None, :]


def cylinder_mask(h: int, w: int, device) -> torch.Tensor:
    """(1, 1, H, W, 1) bool: the gantry cylinder over (x, y)."""
    return torch.from_numpy(create_cylinder_xy_mask((h, w))).to(device)[None, None, :, :, None]


def _codebook_health(model) -> Dict[str, torch.Tensor]:
    """Per level, from the EMA cluster sizes: perplexity exp(H(p)) and the
    fraction of codes above 1 % of the uniform share."""
    log = {}
    for i, q in enumerate(model.encoder.quantize):
        cs = q.cluster_size
        p = cs / torch.clamp(torch.sum(cs), min=1e-9)
        ent = -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-20)), 0.0))
        log[f"codebook_perplexity_{i}"] = torch.exp(ent)
        log[f"codebook_util_{i}"] = torch.mean((p > 0.01 / cs.shape[0]).float())
    return log


def vqvae_loss_fn(model, batch: Dict[str, torch.Tensor], *, train: bool,
                  extract_cylinder: bool = True, with_median: bool = False):
    """Returns (loss, log_dict, loc); ``loc`` is the masked reconstruction
    (B, C, H, W, D) fp32. With ``train`` the quantizers take their train
    path (their EMA buffers change in place)."""
    x = batch["volume"].movedim(-1, 1)
    num_valid = batch["num_valid_slices"]
    decoded, (c_losses, _, _) = model(x, train=train)
    xf = x.float()
    dmask = depth_valid_mask(num_valid, x.shape[-1]).float()
    loc = F.elu(decoded.float()) * dmask
    pointwise = huber_loss(loc, xf)
    commitment_loss = sum(c_losses)
    b, c, h, w, d = x.shape

    if extract_cylinder:
        mask = cylinder_mask(h, w, x.device)
        wgt = mask.float()
        count = torch.sum(wgt) * b * d * c
        big = float("inf")

        def wstats(name, v, std_from_square=False):
            m = torch.sum(v * wgt) / count
            if std_from_square:  # the JAX train path's form
                std = torch.sqrt(torch.clamp(torch.sum(v ** 2 * wgt) / count - m ** 2, min=0.0))
            else:
                std = torch.sqrt(torch.sum((v - m) ** 2 * wgt) / count)
            out = {
                f"{name}_min": torch.min(torch.where(mask, v, big)),
                f"{name}_max": torch.max(torch.where(mask, v, -big)),
                f"{name}_mean": m,
                f"{name}_std": std,
            }
            if with_median:
                out[f"{name}_median"] = median(v[mask.expand_as(v)])
            return out

        recon_loss = torch.sum(pointwise * wgt) / count
        err2 = torch.sum((loc - xf) ** 2 * wgt)
        log = {
            **wstats("recon_loss", pointwise, std_from_square=train),
            **wstats("loc", loc),
            "nmse": err2 / torch.sum(xf ** 2 * wgt),
            "psnr": 10.0 * torch.log10(PSNR_DATA_RANGE ** 2 / (err2 / count)),
        }
    else:
        recon_loss = torch.mean(pointwise)
        log = {
            **sub_metric_log_dict("recon_loss", pointwise),
            **sub_metric_log_dict("loc", loc),
            "nmse": nmse(xf, loc),
            "psnr": psnr(xf, loc, data_range=PSNR_DATA_RANGE),
        }
        if not with_median:
            log.pop("recon_loss_median")
            log.pop("loc_median")

    loss = recon_loss + commitment_loss
    log["commitment_loss"] = commitment_loss
    log["loss"] = loss
    for i, cl in enumerate(c_losses):
        log[f"commitment_loss_{i}"] = cl
    if train:
        log.update(_codebook_health(model))
    return loss, {k: v.detach() for k, v in log.items()}, loc


def make_train_step(model, optimizer, extract_cylinder: bool = True):
    """The train step: batch -> log dict (0-d tensors on the model's device).
    One forward with the quantizers' train path, the backward, and one
    optimizer step (``train.state.AMSGrad``); params, EMA buffers and the
    optimizer state change in place."""

    def train_step(batch):
        optimizer.zero_grad()
        loss, log, _ = vqvae_loss_fn(model, batch, train=True,
                                     extract_cylinder=extract_cylinder)
        loss.backward()
        optimizer.step()
        return log

    return train_step


def make_eval_step(model, extract_cylinder: bool = True):
    """The eval step: batch -> log dict including the slice-wise ``ssim``
    (the reference logs SSIM only at validation)."""

    @torch.no_grad()
    def eval_step(batch):
        _, log, loc = vqvae_loss_fn(model, batch, train=False,
                                    extract_cylinder=extract_cylinder, with_median=True)
        log["ssim"] = ssim3d_slices(loc, batch["volume"].movedim(-1, 1).float())
        return log

    return eval_step
