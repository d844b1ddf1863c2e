"""EMA vector quantizer (fp32-pinned): eval and train paths.

Counterpart of ``vqvae3d_tpu/models/quantizer.py`` (``quantize``,
``ema_first_pass_init``, ``ema_update`` and ``Quantizer``). The codebook
state lives in buffers under the reference keys — ``embed`` (K, D),
``embed_avg`` (K, D), ``cluster_size`` (K,) and ``first_pass`` (a bool, True
until the first training pass; the JAX package stores its inverse as
``initialized``).

The eval lookup is kernel K1a on a card (``ops.quantizer_ops.l2_argmin``),
the train lookup kernel K1b (``l2_argmin_stats``: the lookup fused with the
EMA cluster statistics). ``Quantizer.forward(train=True)`` updates the
buffers in place under ``torch.no_grad()``, as the reference module does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed
import torch.nn as nn

from vqvae3d_tpu_torch.ops.quantizer_ops import l2_argmin, l2_argmin_stats
from vqvae3d_tpu_torch.parallel import halo, mesh


class QuantizerState(NamedTuple):
    """The EMA state as tensors (``vqvae3d_tpu.models.quantizer.QuantizerState``
    with ``first_pass = not initialized``)."""

    embed: torch.Tensor  # (K, D)
    embed_avg: torch.Tensor  # (K, D)
    cluster_size: torch.Tensor  # (K,)
    first_pass: torch.Tensor  # () bool


def row_stats(flat: torch.Tensor):
    """(N, mean, population std) over the rows of every rank: under a
    process group of more than one rank (``parallel.mesh``) the global N,
    and the mean and the two-pass std from sums all-reduced through
    ``AllReduceSum``, so each rank's rows get the gradient that every rank's
    loss sends back through them (the JAX package's "global N under
    jit+GSPMD", quantizer.py:59-71). A whole level under a space axis
    (``halo.replicated()``) holds the same rows on every rank of a space
    group: the group's first rank alone adds them, and N counts each batch
    slice once. At world size 1 torch's mean and std."""
    if not mesh.data_parallel():
        return flat.shape[0], torch.mean(flat, dim=0), torch.std(flat, dim=0, correction=0)
    # every rank holds as many rows; a whole level's, one copy a batch slice
    n = flat.shape[0] * (mesh.data_size() if halo.replicated() else mesh.world_size())
    counted = halo.counted()
    mean = mesh.AllReduceSum.apply(torch.sum(flat, dim=0), None, counted) / n
    var = mesh.AllReduceSum.apply(torch.sum(torch.square(flat - mean), dim=0), None,
                                  counted) / n
    return n, mean, torch.sqrt(var)


def ema_first_pass_init(state: QuantizerState, flat: torch.Tensor, stats=None) -> QuantizerState:
    """Data-dependent codebook init where ``first_pass`` is set:
    embed <- embed * std + mean over the rows (population std), embed_avg <-
    embed, cluster_size += N / K (JAX quantizer.py:59-71); ``stats`` is
    ``row_stats(flat)`` where the caller has it. Selected with
    ``torch.where``, so no host sync. ``quantize_train`` passes detached
    statistics and carries the init's gradient itself."""
    k = state.embed.shape[0]
    n, mean, std = stats if stats is not None else row_stats(flat)
    init = state.embed * std + mean
    first = state.first_pass
    embed = torch.where(first, init, state.embed)
    return QuantizerState(
        embed=embed,
        embed_avg=torch.where(first, init, state.embed_avg),
        cluster_size=torch.where(first, state.cluster_size + n / k, state.cluster_size),
        first_pass=torch.zeros_like(first),
    )


def ema_update(state: QuantizerState, counts: torch.Tensor, dw: torch.Tensor,
               decay: float, laplace_alpha: float) -> QuantizerState:
    """EMA codebook update with Laplace smoothing from the cluster stats
    (counts (K,), dw (K, D) = per-code sums of the rows; JAX
    quantizer.py:74-101). fp32 throughout."""
    cluster_size = state.cluster_size * decay + counts * (1.0 - decay)
    embed_avg = state.embed_avg * decay + dw * (1.0 - decay)
    return QuantizerState(
        embed=embed_avg / _smoothed(cluster_size, laplace_alpha)[:, None],
        embed_avg=embed_avg,
        cluster_size=cluster_size,
        first_pass=state.first_pass,
    )


def _smoothed(cluster_size: torch.Tensor, laplace_alpha: float) -> torch.Tensor:
    """Laplace-smoothed cluster sizes, the EMA codebook's row divisors."""
    k = cluster_size.shape[0]
    n = torch.sum(cluster_size)
    return n * (cluster_size + laplace_alpha) / (n + k * laplace_alpha)


def quantize(inputs: torch.Tensor, embed: torch.Tensor, *, commitment_cost: float = 0.1):
    """Eval-path quantization of (B, D, H, W, Z) inputs (channel dim 1)
    against the (K, D) codebook (JAX ``quantize(train=False)``).

    Returns (loss, quantized, indices): the commitment loss
    ``commitment_cost · mse(quantized, x)``, the straight-through value
    ``x + (quantized - x)`` in fp32, and int64 indices (B, H, W, Z)."""
    x = inputs.float()
    x_last = x.movedim(1, -1)
    indices = l2_argmin(x_last.reshape(-1, embed.shape[1]), embed)
    return _finish(x, x_last, embed.float()[indices], indices, commitment_cost)


def quantize_train(inputs: torch.Tensor, state: QuantizerState, *,
                   commitment_cost: float = 0.1, decay: float = 0.99,
                   laplace_alpha: float = 1e-5):
    """Train-path quantization (JAX ``quantize(train=True)``,
    quantizer.py:184-229): returns (loss, quantized, indices, new_state).

    The lookup and its statistics (kernel K1b) use the post-init, pre-EMA
    codebook; ``quantized`` is read from the post-EMA codebook. The first-pass
    init sees x with its gradient (the JAX package does not stop it there),
    so on the pass that initialises the codebook the commitment loss has a
    gradient through the init's mean and std; on every later pass it has
    none. The codebook itself takes no gradient: post-EMA row k is
    (decay (E_k std + mean) + (1 - decay) dw_k) / smoothed_k on that pass,
    where only std and mean depend on x, so the rows carry the term
    ``t - t.detach()`` (value 0) of t = decay / smoothed_k (E_k std + mean),
    selected by ``first_pass`` on the device: the backward reduces over rows
    and scatters nothing into the codebook.

    Under a process group of more than one rank the statistics are global:
    the init's N, mean and std (``row_stats``), and K1b's counts and dw,
    sum-all-reduced before the EMA update (the psums of JAX
    quantizer.py:139-145; counts are integers in fp32, so their sum is
    exact). Every rank then holds the same EMA state. Under a space axis
    (``--mesh-shape d s``) x is the rank's H slab: the same sums over the
    world count each voxel once, and the commitment loss is the slab's part
    of its space group's mean. A whole level (``halo.replicated()``: every
    rank of the space group holds the same x) enters those sums from the
    group's first rank only, the others sending zeros (the counts stay
    exact), and its commitment loss is split evenly over the group."""
    x = inputs.float()
    x_last = x.movedim(1, -1)
    flat = x_last.reshape(-1, x_last.shape[-1])
    n, mean, std = row_stats(flat)
    init = ema_first_pass_init(state, flat, (n, mean.detach(), std.detach()))
    indices, counts, dw = l2_argmin_stats(flat.detach(), init.embed)
    if mesh.data_parallel():
        stats = torch.cat([counts[:, None], dw], dim=1)
        if not halo.counted():
            stats = torch.zeros_like(stats)
        torch.distributed.all_reduce(stats)
        counts, dw = stats[:, 0], stats[:, 1:]
    new = ema_update(init, counts, dw, decay, laplace_alpha)
    scale = (decay / _smoothed(new.cluster_size, laplace_alpha))[indices, None]
    t = scale * (state.embed[indices] * std + mean)
    rows = new.embed[indices] + torch.where(state.first_pass, t - t.detach(), 0.0)
    return (*_finish(x, x_last, rows, indices, commitment_cost), new)


def _finish(x, x_last, rows, indices, commitment_cost):
    quantized = rows.reshape(x_last.shape).movedim(-1, 1)
    loss = commitment_cost * torch.mean(torch.square(quantized - x.detach()))
    # the slab's part of its space group's mean; of a whole level, a copy's share
    if mesh.space_size() > 1:
        loss = loss / mesh.space_size()
    quantized_st = x + (quantized - x).detach()
    return loss, quantized_st, indices.reshape(x_last.shape[:-1])


class Quantizer(nn.Module):
    """Module owning one level's codebook buffers (reference layers.py:602-728)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.1, decay: float = 0.99,
                 laplace_alpha: float = 1e-5):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.laplace_alpha = laplace_alpha
        self.register_buffer("embed", torch.empty(num_embeddings, embedding_dim))
        self.register_buffer("embed_avg", torch.empty(num_embeddings, embedding_dim))
        self.register_buffer("cluster_size", torch.zeros(num_embeddings))
        self.register_buffer("first_pass", torch.tensor(True))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.copy_(torch.randn(self.embed.shape, generator=generator))
            self.embed_avg.copy_(self.embed)
            self.cluster_size.zero_()
            self.first_pass.fill_(True)

    def state(self) -> QuantizerState:
        return QuantizerState(self.embed, self.embed_avg, self.cluster_size, self.first_pass)

    def forward(self, inputs: torch.Tensor, train: bool = False):
        if not train:
            loss, quantized, indices = quantize(inputs, self.embed,
                                                commitment_cost=self.commitment_cost)
        else:
            # first_pass cloned: the backward's where reads it, and the buffers
            # change below
            old = self.state()._replace(first_pass=self.first_pass.clone())
            loss, quantized, indices, new = quantize_train(
                inputs, old, commitment_cost=self.commitment_cost,
                decay=self.decay, laplace_alpha=self.laplace_alpha,
            )
            with torch.no_grad():
                for buf, value in zip(self.state(), new):
                    buf.copy_(value)
        # back to the surrounding compute dtype (JAX quantizer.py:283-285)
        return loss, quantized.to(inputs.dtype), indices

    def embed_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook lookup: (...,) int -> (..., D) fp32 (reference layers.py:633)."""
        return self.embed[indices]
