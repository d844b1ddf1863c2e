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
import torch.nn as nn

from vqvae3d_tpu_torch.ops.quantizer_ops import l2_argmin, l2_argmin_stats


class QuantizerState(NamedTuple):
    """The EMA state as tensors (``vqvae3d_tpu.models.quantizer.QuantizerState``
    with ``first_pass = not initialized``)."""

    embed: torch.Tensor  # (K, D)
    embed_avg: torch.Tensor  # (K, D)
    cluster_size: torch.Tensor  # (K,)
    first_pass: torch.Tensor  # () bool


def ema_first_pass_init(state: QuantizerState, flat: torch.Tensor) -> QuantizerState:
    """Data-dependent codebook init where ``first_pass`` is set:
    embed <- embed * std + mean over the rows (population std), embed_avg <-
    embed, cluster_size += N / K (JAX quantizer.py:59-71). Selected with
    ``torch.where``, so no host sync. ``quantize_train`` passes detached rows
    and carries the init's gradient itself."""
    k = state.embed.shape[0]
    n = flat.shape[0]
    init = state.embed * torch.std(flat, dim=0, correction=0) + torch.mean(flat, dim=0)
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
    and scatters nothing into the codebook."""
    x = inputs.float()
    x_last = x.movedim(1, -1)
    flat = x_last.reshape(-1, x_last.shape[-1])
    init = ema_first_pass_init(state, flat.detach())
    indices, counts, dw = l2_argmin_stats(flat.detach(), init.embed)
    new = ema_update(init, counts, dw, decay, laplace_alpha)
    scale = (decay / _smoothed(new.cluster_size, laplace_alpha))[indices, None]
    t = scale * (state.embed[indices] * torch.std(flat, dim=0, correction=0)
                 + torch.mean(flat, dim=0))
    rows = new.embed[indices] + torch.where(state.first_pass, t - t.detach(), 0.0)
    return (*_finish(x, x_last, rows, indices, commitment_cost), new)


def _finish(x, x_last, rows, indices, commitment_cost):
    quantized = rows.reshape(x_last.shape).movedim(-1, 1)
    loss = commitment_cost * torch.mean(torch.square(quantized - x.detach()))
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
