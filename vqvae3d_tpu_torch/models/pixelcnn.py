"""PixelCNN prior over one hierarchy level's code grid.

Counterpart of ``vqvae3d_tpu/models/pixelcnn.py`` (reference
pixel_model/pixelcnn.py): one-hot codes → 1x1x1 ``parse_input`` → N+1
causal blocks (the first mask 'A', the rest 'B'), each conditioned on the
embedded, trilinearly upsampled one-hot of the next-coarser grid → 1x1x1
``parse_output`` logits.

The forward is the JAX module's stock path (``pixelcnn.py:215-269``); a
condition at the coarser grid is upsampled as a one-hot, then embedded, in
that order. It computes in fp32 whatever ``dtype`` says: in this port it
serves the naive sampler and the tests (the cached sampler reads the
weights and runs its own decomposition), and ``dtype`` is kept for the
config file and for prior training, which is not ported yet. The JAX
module's block-space scan and kernel K4 are a TPU layout of the same math
and are not used here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from vqvae3d_tpu_torch.models.causal_blocks import (
    PreActFixupCausalResBlock,
    input_to_stack,
    stack_to_output,
)
from vqvae3d_tpu_torch.ops.conv3d import Conv3D
from vqvae3d_tpu_torch.ops.resize import trilinear_resize


@dataclasses.dataclass(frozen=True)
class PixelCNNConfig:
    """The JAX PixelCNNConfig's fields, less the TPU layout switches
    (``scan_stacks``, ``remat_scan``), which the config reader drops."""

    input_dim: int = 256  # codebook size of this level
    condition_dim: int = 0  # codebook size of the coarser level (0 = none)
    model_dim: int = 32
    kernel_size: int = 3
    num_resblocks: int = 18
    dropout_prob: float = 0.5
    use_pre_activation: bool = True
    bottleneck_divisor: int = 4
    use_concat_activation: bool = False
    mixup_alpha: float = 0.0
    lr: float = 1e-5
    dtype: Any = torch.bfloat16

    @property
    def use_conditioning(self) -> bool:
        return self.condition_dim > 0

    @property
    def num_layers(self) -> int:
        return self.num_resblocks + 1


class PixelCNN(nn.Module):
    """Parameters are initialized on the CPU from ``generator`` (a fixed seed
    when None), then moved to ``device``."""

    def __init__(self, config: PixelCNNConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if not config.use_pre_activation:
            raise NotImplementedError("FixupCausalResBlock (use_pre_activation=False) "
                                      "is not ported")
        self.config = config
        c = config.model_dim
        self.parse_input = Conv3D(config.input_dim, c, 1)
        self.embed_condition = (Conv3D(config.condition_dim, c, 1)
                                if config.use_conditioning else None)
        self.layers = nn.ModuleList(
            PreActFixupCausalResBlock(
                c, c, config.kernel_size, "A" if i == 0 else "B",
                condition_dim=c if config.use_conditioning else 0,
                dropout_prob=config.dropout_prob,
                bottleneck_divisor=config.bottleneck_divisor,
                concat_activation=config.use_concat_activation,
                num_layers=config.num_layers,
            )
            for i in range(config.num_layers)
        )
        self.parse_output = Conv3D(c, config.input_dim, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, data: torch.Tensor, condition: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """data (B, input_dim, s0, s1, s2) one-hot; condition (B, condition_dim,
        *grid) one-hot at this grid or the coarser one. Returns fp32 logits
        (B, input_dim, s0, s1, s2)."""
        cfg = self.config
        if (condition is not None) != cfg.use_conditioning:
            raise ValueError("a condition is needed exactly when condition_dim > 0")
        h = self.parse_input(data.float())
        stack = input_to_stack(h)
        cond = None
        if cfg.use_conditioning:
            condition = condition.float()
            if condition.shape[2:] != data.shape[2:]:
                condition = trilinear_resize(condition, data.shape[2:])
            cond = self.embed_condition(condition)
        for layer in self.layers:
            stack = layer(stack, cond, train=train)
        return self.parse_output(stack_to_output(stack))
