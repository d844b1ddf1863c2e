"""Stage-1 (VQ-VAE) loss and the train and eval steps.

Counterpart of ``vqvae3d_tpu/train/vqvae_train.py:44-374`` (reference
vqvae/model.py:95-163), with the same log-dict keys:

  * forward -> ELU on the reconstruction;
  * depth slices beyond each sample's ``num_valid_slices`` zeroed;
  * the center-cylinder weighting as the pre-loss filter (a mask-weighted
    mean, as the JAX package computes it);
  * smooth-L1 (huber, beta = 1) reconstruction loss plus the summed
    per-level commitment losses; or, with ``metric='mixture-nll'``, the
    per-voxel NLL of a discretized-logistic mixture head (the point estimate
    the argmax component's loc);
  * min/max/mean/std (and in eval the median) of the per-voxel loss and the
    reconstruction, NMSE, PSNR, and in training the EMA codebooks'
    perplexity and utilization per level.

The JAX train path computes its loss in the stem's space-to-depth layout
(a TPU layout device, exact because every term is voxel-pointwise); the port
computes the same loss at full resolution. Batches are the loader's dicts
{'volume': (B, H, W, D, C) fp32, 'num_valid_slices': (B,) int}, the JAX
step's contract; the model runs on (B, C, H, W, D).

Under a process group (``parallel/``) the batch is the rank's slice of the
global batch, as the JAX step's batch is sharded on the mesh's 'data' axis:
the loss is the rank's mean over an equal count, the gradients are averaged
over ranks, the quantizers' statistics are global, and the log holds the
global batch's values (``weighted_log``). Under ``--mesh-shape d s`` with
s > 1 the batch is also cut along H, as the JAX step's volumes are sharded
on 'space': each rank of a space group holds one H slab of its batch slice
and its loss is the slab's part of its space group's mean (sums over the
slab over the whole volume's count), so the gradients summed over 'space'
and averaged over 'data' are the global batch's; the cylinder mask takes
the slab's rows; the eval step gathers the space group's slabs for the
slice-wise SSIM, which needs whole H x W slices (the one gather of a whole
volume, in eval only). The coarse levels that run whole on every rank of a
space group (``models/vqvae.py``) each add 1/s of their commitment loss a
rank, so the sum over 'space' counts it once, as it does the slabs' parts
of the reconstruction loss.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.data.transforms import create_cylinder_xy_mask
from vqvae3d_tpu_torch.metrics.distribution import mixture_nll_loss
from vqvae3d_tpu_torch.metrics.evaluate import ssim3d_slices
from vqvae3d_tpu_torch.parallel import mesh
from vqvae3d_tpu_torch.utils.logging_helpers import median

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


def mixture_head(decoded: torch.Tensor, n_mix: int, valid: torch.Tensor, x: torch.Tensor):
    """The mixture head's (loc, per-voxel NLL), both (B, C, H, W, D) fp32 and
    zero beyond the valid depth (``valid``, a float mask). The decoder's
    channels split as (c_out, [logits | locs | log-scales] x n_mix), the JAX
    head's order (``reshape(..., c_out, 3 n_mix)`` on its channels axis, per
    stem phase). loc = ELU, scale = softplus + 1e-4; the point estimate is
    the loc of the argmax component."""
    b, ch, *spatial = decoded.shape
    d = decoded.float().reshape(b, ch // (3 * n_mix), 3, n_mix, *spatial)
    d = d.movedim((2, 3), (-2, -1))  # (B, c_out, H, W, D, 3, n_mix)
    logits, mloc, mlog_scale = d.unbind(-2)
    mloc = F.elu(mloc)
    mscale = F.softplus(mlog_scale) + 1e-4
    comp = torch.argmax(logits, dim=-1, keepdim=True)
    loc = torch.gather(mloc, -1, comp)[..., 0] * valid
    nll = mixture_nll_loss(x, logits, mloc, mscale, reduce_sum=False) * valid
    return loc, nll


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


@torch.no_grad()
def weighted_log(pointwise, loc, xf, mask, count, *, recon_from_square: bool,
                 with_median: bool) -> Dict[str, torch.Tensor]:
    """min / max / mean / std (and with ``with_median`` the median) of the
    per-voxel loss and of the reconstruction over ``mask`` (``count``
    voxels a batch slice), NMSE and PSNR, global over ranks
    (``parallel.mesh``): each rank's sums over its voxels divided by its
    batch slice's count, so their 'mean' (summed over the space axis,
    averaged over the data axis) is the global mean; the two-pass std takes
    the global mean first; NMSE and PSNR take the global sums; the medians
    gather every rank's voxels. At world size 1 the rank's own
    statistics."""
    wgt = mask.float()
    big = float("inf")
    values = {"recon_loss": pointwise, "loc": loc}
    mean = {f"{k}_mean": torch.sum(v * wgt) / count for k, v in values.items()}
    if recon_from_square:
        mean["recon_loss_sq"] = torch.sum(pointwise ** 2 * wgt) / count
    err2 = torch.sum((loc - xf) ** 2 * wgt)
    mean = mesh.all_reduce_dict({**mean, "err2": err2, "x2": torch.sum(xf ** 2 * wgt)}, "mean")
    lo = mesh.all_reduce_dict({f"{k}_min": torch.min(torch.where(mask, v, big))
                               for k, v in values.items()}, "min")
    hi = mesh.all_reduce_dict({f"{k}_max": torch.max(torch.where(mask, v, -big))
                               for k, v in values.items()}, "max")
    two_pass = [k for k in values if not (recon_from_square and k == "recon_loss")]
    var = mesh.all_reduce_dict({k: torch.sum((values[k] - mean[f"{k}_mean"]) ** 2 * wgt) / count
                                for k in two_pass}, "mean")
    log = {}
    for k, v in values.items():
        m = mean[f"{k}_mean"]
        std = (torch.sqrt(var[k]) if k in var else
               torch.sqrt(torch.clamp(mean["recon_loss_sq"] - m ** 2, min=0.0)))
        log.update({f"{k}_min": lo[f"{k}_min"], f"{k}_max": hi[f"{k}_max"], f"{k}_mean": m,
                    f"{k}_std": std})
        if with_median:
            log[f"{k}_median"] = median(mesh.all_gather_flat(v[mask.expand_as(v)]))
    log["nmse"] = mean["err2"] / mean["x2"]
    log["psnr"] = 10.0 * torch.log10(PSNR_DATA_RANGE ** 2 / (mean["err2"] / count))
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
    if model.config.metric == "mixture-nll":
        loc, pointwise = mixture_head(decoded, model.config.n_mix, dmask, xf)
    else:
        loc = F.elu(decoded.float()) * dmask
        pointwise = huber_loss(loc, xf)
    commitment_loss = sum(c_losses)
    b, c, h, w, d = x.shape

    # under a space axis x holds the rows [i h, (i + 1) h) of volumes of s h
    s, i = mesh.space_size(), mesh.space_index()
    mask = (cylinder_mask(s * h, w, x.device) if extract_cylinder
            else torch.ones(1, 1, s * h, w, 1, dtype=torch.bool, device=x.device))
    count = torch.sum(mask.float()) * b * d * c
    mask = mask[:, :, i * h:(i + 1) * h] if s > 1 else mask
    recon_loss = torch.sum(pointwise * mask.float()) / count
    # the JAX train path's std of the loss is from its square
    log = weighted_log(pointwise.detach(), loc.detach(), xf, mask, count,
                       recon_from_square=train and extract_cylinder, with_median=with_median)

    loss = recon_loss + commitment_loss
    # each rank's part of its batch slice's mean: their 'mean' is global
    log.update(mesh.all_reduce_dict({
        "commitment_loss": commitment_loss, "loss": loss,
        **{f"commitment_loss_{i}": cl for i, cl in enumerate(c_losses)}}, "mean"))
    if train:
        log.update(_codebook_health(model))
    return loss, {k: v.detach() for k, v in log.items()}, loc


def make_train_step(model, optimizer, extract_cylinder: bool = True):
    """The train step: batch -> log dict (0-d tensors on the model's device).
    One forward with the quantizers' train path, the backward, and one
    optimizer step (``train.state.AMSGrad``); params, EMA buffers and the
    optimizer state change in place. Under a process group the batch is the
    rank's slice of the global batch (and under a space axis its H slab):
    AMSGrad sums the gradient over the space axis and averages it over the
    data axis before its update, and the log holds the global batch's
    values."""

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
        # whole H x W slices: the space group's slabs gathered (eval only)
        ssim = ssim3d_slices(mesh.space_gather(loc),
                             mesh.space_gather(batch["volume"].movedim(-1, 1).float()))
        if mesh.space_size() > 1:  # every rank of the space group holds it
            ssim = ssim / mesh.space_size()
        # a mean over as many slices on every batch slice
        log["ssim"] = mesh.all_reduce_dict({"ssim": ssim}, "mean")["ssim"]
        return log

    return eval_step
