"""PixelSNAIL prior: causal convs and causal attention over the code grid.

Counterpart of ``vqvae3d_tpu/models/pixelsnail.py`` (reference
pixel_model/pixelsnail.py): one-hot codes → 1x1x1 ``parse_input`` → a
mask-'A' ``to_causal`` block → ``num_blocks`` ``CausalAttentionPixelBlock``s
(each ``num_layers_per_block`` causal blocks, causal attention keyed on the
stack, the blocks' output and a coordinate background, and an ``out_proj``
block with the attention as aux) → 1x1x1 ``parse_output`` logits. A coarse
condition is upsampled as a one-hot (fp32, no gradient), then embedded, and
every causal block adds its projection.

The forward computes in ``config.dtype`` (or the ``dtype`` it is given), as
the JAX module does, and returns fp32 logits. Its causal blocks are the stock
modules (the PixelSNAIL widths, 256 and 512, are past kernel K4's); its
attention takes kernel K8 on a card when attention dropout is off, and in
training with attention dropout kernel K5 beyond S = 2048 (the mid level's
32x32x8, S = 8192) and the dense path up to it
(``causal_blocks.CausalAttention``). Two kinds of dropout in training:

  * channel dropout of the causal blocks: one (L, B, 3·Cb) 0/1 keep mask for
    the L = 1 + num_blocks·(num_layers_per_block + 1) blocks in order
    (to_causal, then per attention block its inner blocks and out_proj),
    passed in as data or drawn from ``generator``;
  * attention dropout (the reference's pre-mask logit dropout): one Philox
    seed per attention block, drawn from the same ``generator`` in block
    order; the keep mask is a function of that seed alone, whichever route
    the block takes.

Module attributes follow the reference torch tree (``to_causal``,
``layers.N.causal_layers.M``, ``layers.N.key_value_proj``,
``layers.N.query_proj``, ``layers.N.out_proj.aux`` …), so ``state_dict`` keys
are the reference checkpoint keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from vqvae3d_tpu_torch.models.causal_blocks import (
    CausalAttentionPixelBlock,
    PreActFixupCausalResBlock,
    draw_keep_masks,
    input_to_stack,
    stack_to_output,
)
from vqvae3d_tpu_torch.models.prior_utils import generate_background
from vqvae3d_tpu_torch.ops.conv3d import Conv3D
from vqvae3d_tpu_torch.ops.resize import trilinear_resize


@dataclasses.dataclass(frozen=True)
class PixelSNAILConfig:
    """The JAX PixelSNAILConfig's fields and defaults (reference
    pixelsnail.py:193-217's argparse surface)."""

    input_dim: int = 256
    condition_dim: int = 0
    model_dim: int = 32
    kernel_size: int = 3
    num_layers_per_block: int = 5
    num_blocks: int = 5
    causal_dropout_prob: float = 0.5
    attention_dropout_prob: float = 0.5
    bottleneck_divisor: int = 4
    num_heads: int = 8
    mixup_alpha: float = 0.0
    lr: float = 1e-5
    dtype: Any = torch.bfloat16

    @property
    def use_conditioning(self) -> bool:
        return self.condition_dim > 0

    @property
    def num_layers(self) -> int:
        """The Fixup depth (JAX's ``num_layers``)."""
        return self.num_blocks * self.num_layers_per_block + 1

    @property
    def num_causal_blocks(self) -> int:
        """The causal blocks that take a channel-dropout mask."""
        return 1 + self.num_blocks * (self.num_layers_per_block + 1)


class PixelSNAIL(nn.Module):
    """Parameters are initialized on the CPU from ``generator`` (a fixed seed
    when None), then moved to ``device``."""

    def __init__(self, config: PixelSNAILConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.config = config
        c = config.model_dim
        cond_dim = c if config.use_conditioning else 0
        self.parse_input = Conv3D(config.input_dim, c, 1)
        self.embed_condition = (Conv3D(config.condition_dim, c, 1)
                                if config.use_conditioning else None)
        self.to_causal = PreActFixupCausalResBlock(
            c, c, config.kernel_size, "A", condition_dim=cond_dim,
            dropout_prob=config.causal_dropout_prob,
            bottleneck_divisor=config.bottleneck_divisor, num_layers=config.num_layers)
        self.layers = nn.ModuleList(
            CausalAttentionPixelBlock(
                c, config.kernel_size, config.num_layers_per_block, config.bottleneck_divisor,
                cond_dim, config.num_heads, config.causal_dropout_prob,
                config.attention_dropout_prob, config.num_layers)
            for _ in range(config.num_blocks))
        self.parse_output = Conv3D(c, config.input_dim, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, data: torch.Tensor, condition: Optional[torch.Tensor] = None,
                train: bool = False, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dtype=None) -> torch.Tensor:
        """data (B, input_dim, s0, s1, s2) one-hot; condition (B, condition_dim,
        *grid) one-hot at this grid or a coarser one. ``keep`` (L, B, 3·Cb):
        the channel-dropout masks of a training forward (drawn from
        ``generator`` when None); ``generator`` also draws the attention
        dropout. ``dtype`` overrides ``config.dtype``. Returns fp32 logits
        (B, input_dim, s0, s1, s2)."""
        cfg = self.config
        dt = dtype or cfg.dtype
        if (condition is not None) != cfg.use_conditioning:
            raise ValueError("a condition is needed exactly when condition_dim > 0")
        p = cfg.causal_dropout_prob if train else 0.0
        if p > 0 and keep is None:
            cb = max(cfg.model_dim // cfg.bottleneck_divisor, 1)
            keep = draw_keep_masks((cfg.num_causal_blocks, data.shape[0], 3 * cb), p, generator,
                                   data.device)
        if p == 0:
            keep = None
        b, _, s0, s1, s2 = data.shape
        background = generate_background(b, (s0, s1, s2), data.device)
        stack = input_to_stack(self.parse_input(data.to(dt)))
        cond = None
        if cfg.use_conditioning:
            if condition.shape[2:] != data.shape[2:]:
                condition = trilinear_resize(condition.float(), data.shape[2:])
            cond = self.embed_condition(condition.to(dt))
        stack = self.to_causal(stack, cond, train=train, keep=None if keep is None else keep[0])
        n = cfg.num_layers_per_block + 1  # the masks of one attention block
        for i, layer in enumerate(self.layers):
            stack = layer(stack, background, cond, train=train,
                          keep=None if keep is None else keep[1 + i * n:1 + (i + 1) * n],
                          generator=generator)
        return self.parse_output(stack_to_output(stack)).float()
