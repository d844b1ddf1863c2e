"""PixelCNN prior over one hierarchy level's code grid.

Counterpart of ``vqvae3d_tpu/models/pixelcnn.py`` (reference
pixel_model/pixelcnn.py): one-hot codes → 1x1x1 ``parse_input`` → N+1
causal blocks (the first mask 'A', the rest 'B'), each conditioned on the
embedded, trilinearly upsampled one-hot of the next-coarser grid → 1x1x1
``parse_output`` logits.

The forward computes in ``config.dtype`` (or the ``dtype`` it is given), as
the JAX module does, and returns fp32 logits. A condition at the coarser grid
is upsampled as a one-hot (fp32, no gradient), then embedded, in that order,
so the upsample never needs a backward. The mask-'A' block runs the stock
modules. The mask-'B' segment runs as one union stream through
``ops/causal_kernel.py::causal_stack_fused`` (kernel K4 on the card, forward
and backward) where the JAX module takes its block-space path, on the
conditions that are about function: pre-activation, no concat-activation,
``kernel_size`` 3, ``model_dim`` ≤ 32 and at least one mask-'B' block
(``uses_union_stack``; the JAX ``pixelcnn.py:90-101`` and
``ops/causal_stack.py:61-85`` less their TPU lane, VMEM and grid-size gates).
Wider models (the 256/512-d mid and bottom PixelCNNs) run the stock block
modules, as the JAX package does. This is a dispatch on the config, decided
before any launch.

The block type follows the config as in JAX (``pixelcnn.py:239-263``):
``PreActFixupCausalResBlock`` (with ``use_concat_activation`` its branch
convs grouped over concatenated ELUs), or ``FixupCausalResBlock`` when
``use_pre_activation`` is off. A Fixup model keeps ``embed_condition`` in its
parameters (its checkpoints carry the JAX tree's) but passes its blocks no
condition, as the JAX module does; its output is not computed.

Channel dropout in training: one (L, B, 3·Cb) 0/1 keep mask for the L
blocks, passed in as data or drawn from ``generator``; Cb is the blocks'
``branch`` width (``model_dim`` for Fixup blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from vqvae3d_tpu_torch.models.causal_blocks import (
    FixupCausalResBlock,
    PreActFixupCausalResBlock,
    draw_keep_masks,
    input_to_stack,
    stack_to_output,
)
from vqvae3d_tpu_torch.ops.causal_kernel import causal_stack_fused, pack_causal_union
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
        self.config = config
        c = config.model_dim
        self.parse_input = Conv3D(config.input_dim, c, 1)
        self.embed_condition = (Conv3D(config.condition_dim, c, 1)
                                if config.use_conditioning else None)

        def block(i):
            mask = "A" if i == 0 else "B"
            if not config.use_pre_activation:
                return FixupCausalResBlock(c, c, config.kernel_size, mask,
                                           dropout_prob=config.dropout_prob,
                                           num_layers=config.num_layers)
            return PreActFixupCausalResBlock(
                c, c, config.kernel_size, mask,
                condition_dim=c if config.use_conditioning else 0,
                dropout_prob=config.dropout_prob,
                bottleneck_divisor=config.bottleneck_divisor,
                concat_activation=config.use_concat_activation,
                num_layers=config.num_layers,
            )

        self.layers = nn.ModuleList(block(i) for i in range(config.num_layers))
        self.parse_output = Conv3D(c, config.input_dim, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    @property
    def uses_union_stack(self) -> bool:
        """Whether the mask-'B' segment runs through ``causal_stack_fused``:
        pre-activation blocks without concat-activation (the union's
        structure), ``kernel_size`` 3, ``model_dim`` <= 32, at least one
        mask-'B' block."""
        cfg = self.config
        return (cfg.use_pre_activation and not cfg.use_concat_activation
                and cfg.kernel_size == 3 and cfg.model_dim <= 32 and cfg.num_resblocks >= 1)

    def forward(self, data: torch.Tensor, condition: Optional[torch.Tensor] = None,
                train: bool = False, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dtype=None) -> torch.Tensor:
        """data (B, input_dim, s0, s1, s2) one-hot; condition (B, condition_dim,
        *grid) one-hot at this grid or the coarser one. ``keep`` (L, B, 3·Cb):
        the dropout keep masks of a training forward (drawn from ``generator``
        when None). ``dtype`` overrides ``config.dtype``. Returns fp32 logits
        (B, input_dim, s0, s1, s2)."""
        cfg = self.config
        dt = dtype or cfg.dtype
        if (condition is not None) != cfg.use_conditioning:
            raise ValueError("a condition is needed exactly when condition_dim > 0")
        p = cfg.dropout_prob if train else 0.0
        if p > 0 and keep is None:
            keep = draw_keep_masks((cfg.num_layers, data.shape[0], 3 * self.layers[0].branch), p,
                                   generator, data.device)
        if p == 0:
            keep = None
        h = self.parse_input(data.to(dt))
        stack = input_to_stack(h)
        cond = None
        # Fixup blocks take no condition: embed_condition stays, unused (JAX :230-263)
        if cfg.use_conditioning and cfg.use_pre_activation:
            if condition.shape[2:] != data.shape[2:]:
                condition = trilinear_resize(condition.float(), data.shape[2:])
            cond = self.embed_condition(condition.to(dt))
        stack = self.layers[0](stack, cond, train=train, keep=None if keep is None else keep[0])
        if self.uses_union_stack:
            c = cfg.model_dim
            x = torch.cat([s.permute(0, 2, 3, 4, 1) for s in stack], -1)  # (B, *grid, 3C)
            cl = None if cond is None else cond.permute(0, 2, 3, 4, 1).contiguous()
            y = causal_stack_fused(x, cl, None if keep is None else keep[1:], p,
                                   pack_causal_union(self.layers[1:]))
            stack = tuple(y[..., s * c:(s + 1) * c].permute(0, 4, 1, 2, 3) for s in range(3))
        else:
            for i in range(1, cfg.num_layers):
                stack = self.layers[i](stack, cond, train=train,
                                       keep=None if keep is None else keep[i])
        return self.parse_output(stack_to_output(stack)).float()
