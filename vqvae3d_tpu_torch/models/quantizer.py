"""EMA vector quantizer, eval path (fp32-pinned).

Counterpart of ``vqvae3d_tpu/models/quantizer.py`` (``quantize`` with
``train=False`` and ``Quantizer``). The codebook state lives in buffers
under the reference keys — ``embed`` (K, D), ``embed_avg`` (K, D),
``cluster_size`` (K,) and ``first_pass`` (a bool, True until the first
training pass; the JAX package stores its inverse as ``initialized``).

The lookup is kernel K1 on a card (``ops.quantizer_ops.l2_argmin``). The EMA
update and the data-dependent first-pass init belong to training (a later
slice): ``train=True`` raises.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from vqvae3d_tpu_torch.ops.quantizer_ops import l2_argmin


def quantize(inputs: torch.Tensor, embed: torch.Tensor, *, train: bool = False,
             commitment_cost: float = 0.1):
    """Eval-path quantization of (B, D, H, W, Z) inputs (channel dim 1).

    Returns (loss, quantized, indices): the commitment loss
    ``commitment_cost · mse(quantized, x)``, the straight-through value
    ``x + (quantized - x)`` in fp32, and int64 indices (B, H, W, Z)."""
    if train:
        raise NotImplementedError(
            "quantize(train=True): the EMA codebook update is not ported yet"
        )
    d = embed.shape[1]
    x = inputs.float()
    x_last = x.movedim(1, -1)
    indices = l2_argmin(x_last.reshape(-1, d), embed)
    quantized = embed.float()[indices].reshape(x_last.shape).movedim(-1, 1)
    loss = commitment_cost * torch.mean(torch.square(quantized - x))
    quantized_st = x + (quantized - x).detach()
    return loss, quantized_st, indices.reshape(x_last.shape[:-1])


class Quantizer(nn.Module):
    """Module owning one level's codebook buffers (reference layers.py:602-728)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.1):
        super().__init__()
        self.commitment_cost = commitment_cost
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

    def forward(self, inputs: torch.Tensor, train: bool = False):
        loss, quantized, indices = quantize(
            inputs, self.embed, train=train, commitment_cost=self.commitment_cost
        )
        # back to the surrounding compute dtype (JAX quantizer.py:283-285)
        return loss, quantized.to(inputs.dtype), indices

    def embed_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook lookup: (...,) int -> (..., D) fp32 (reference layers.py:633)."""
        return self.embed[indices]
