"""Causal 3D convolution stack of the PixelCNN prior on (B, C, s0, s1, s2).

Counterpart of the PixelCNN parts of ``vqvae3d_tpu/models/causal_blocks.py``
(reference pixel_model/layers.py). The raster order is (s0, s1, s2); a
stack is a 3-tuple of streams (depth, height, width):

  * depth  sees every voxel of the earlier s0-slices,
  * height sees the earlier s1-rows of the current slice,
  * width  sees the earlier s2-positions of the current row.

Mask 'A' (the first block) shifts each stream by one along its own axis,
after the activation, so that a voxel never sees itself; mask 'B' may see
the current voxel's already-computed streams.

Every conv pads explicitly (front-only on the causal axis, symmetric on the
others) and then runs VALID. ``PreActFixupCausalResBlock`` computes in its
activations' dtype, as the JAX module does with ``dtype`` set, and in
training applies channel dropout (torch ``Dropout3d``: one keep decision per
(sample, channel) and stream, kept values divided by 1 − p, after
``branch_conv2`` and before the condition add). ``aux`` inputs,
``concat_activation`` and ``FixupCausalResBlock`` raise
``NotImplementedError``. Module attributes follow the reference torch tree,
so ``state_dict`` keys are the reference checkpoint keys
(``branch_conv1.depth_conv.weight``, ``expand_rf.height_conv.bias``,
``condition.weight``, ``skip_conv.width_conv.bias``, ``bias1a`` …).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops.conv3d import (
    Conv3D,
    conv3d,
    fixup_branch_init,
    kaiming_normal_init,
    torch_conv_default_init,
    xavier_normal_init,
    zeros_init,
)

Stack = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
SCALARS = ("1a", "1b", "2a", "2b", "3a", "3b", "4")


def _shift_one(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Front-pad by one and drop the last element along ``dim``."""
    n = x.shape[dim]
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)), x.narrow(dim, 0, n - 1)], dim)


def shift_backwards_3d(x: torch.Tensor) -> torch.Tensor:  # s0 (depth)
    return _shift_one(x, 2)


def shift_down_3d(x: torch.Tensor) -> torch.Tensor:  # s1 (height)
    return _shift_one(x, 3)


def shift_right_3d(x: torch.Tensor) -> torch.Tensor:  # s2 (width)
    return _shift_one(x, 4)


def draw_keep_masks(shape, p: float, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """0/1 fp32 channel-dropout keep decisions, each kept with probability
    1 - p (``shape`` ends in the union's 3·Cb channels, [d|h|w])."""
    u = torch.rand(shape, generator=generator,
                   device=generator.device if generator is not None else device)
    return (u < 1.0 - p).float()


def input_to_stack(x: torch.Tensor) -> Stack:
    return (x, x, x)


def stack_to_output(stack: Stack) -> torch.Tensor:
    d, h, w = stack
    return d + h + w


def causal_conv_geometry(kernel_size: int, mask: str):
    """(kernel shape, ((front, back) pads per axis)) of the depth, height and
    width convs of a CausalConv3dAdd (reference layers.py:193-215)."""
    k = kernel_size
    if k <= 0 or k % 2 == 0:
        raise ValueError(f"causal convs take an odd kernel size, got {k}")
    half = k // 2
    d_size = h_size = max(k - 1, 1)
    w_size = max(half + (1 if mask == "B" else 0), 1)
    return (
        ((d_size, k, k), ((d_size - 1, 0), (half, half), (half, half))),
        ((1, h_size, k), ((0, 0), (h_size - 1, 0), (half, half))),
        ((1, 1, w_size), ((0, 0), (0, 0), (w_size - 1, 0))),
    )


class CausalConv(nn.Module):
    """One stream's conv: ``weight`` (O, I, k0, k1, k2), optional ``bias``;
    the input is padded by ``pads`` ((front, back) per spatial axis), then
    convolved VALID."""

    def __init__(self, in_channels: int, features: int, kernel_shape: Sequence[int],
                 pads, use_bias: bool, kernel_init: Callable):
        super().__init__()
        self.pads = tuple(tuple(p) for p in pads)
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(features, in_channels, *kernel_shape))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(self.kernel_init(tuple(self.weight.shape), generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (f0, b0), (f1, b1), (f2, b2) = self.pads
        if any((f0, b0, f1, b1, f2, b2)):
            x = F.pad(x, (f2, b2, f1, b1, f0, b0))
        return conv3d(x, self.weight, self.bias)


class CausalConv3dAdd(nn.Module):
    """Three parallel causal convs, one per stream (reference layers.py:122-222):
    depth (k−1, k, k), height (1, k−1, k), width (1, 1, k//2 + [mask 'B'])."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 mask: str = "B", use_bias: bool = True,
                 kernel_init: Optional[Callable] = None):
        super().__init__()
        if mask not in ("A", "B"):
            raise ValueError(f"mask must be 'A' or 'B', got {mask!r}")
        self.mask = mask
        init = kernel_init or torch_conv_default_init()
        for name, (shape, pads) in zip(("depth_conv", "height_conv", "width_conv"),
                                       causal_conv_geometry(kernel_size, mask)):
            setattr(self, name, CausalConv(in_channels, features, shape, pads, use_bias, init))

    def forward(self, stack: Stack) -> Stack:
        depth, height, width = stack
        if self.mask == "A":
            depth, height, width = (shift_backwards_3d(depth), shift_down_3d(height),
                                    shift_right_3d(width))
        return self.depth_conv(depth), self.height_conv(height), self.width_conv(width)


class ExpandRFConv(nn.Module):
    """Cross-stream mixing (reference layers.py:225-248): depth feeds height
    and width, height feeds width. h2w is taken from the height stream
    before d2h is added to it."""

    def __init__(self, channels: int):
        super().__init__()
        init = torch_conv_default_init()
        one = ((1, 1, 1), ((0, 0),) * 3)
        self.depth_conv = CausalConv(channels, 2 * channels, *one, True, init)
        self.height_conv = CausalConv(channels, channels, *one, True, init)

    def forward(self, stack: Stack) -> Stack:
        depth, height, width = stack
        d2h, d2w = self.depth_conv(depth).chunk(2, dim=1)
        h2w = self.height_conv(height)
        return depth, height + d2h, width + h2w + d2w


class PreActFixupCausalResBlock(nn.Module):
    """Pre-activation bottleneck Fixup causal block (reference
    layers.py:338-497): 1x1x1 (mask) → ExpandRF → k (mask 'B') →
    (+ condition) → 1x1x1, 7 scalar biases and a scale, and a skip 1x1x1
    (with bias) only for mask 'A' or a change of width."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 mask: str = "B", condition_dim: int = 0, condition_kernel_size: int = 1,
                 dropout_prob: float = 0.5, bottleneck_divisor: int = 4,
                 concat_activation: bool = False, use_aux: bool = False,
                 num_layers: int = 1):
        super().__init__()
        if concat_activation:
            raise NotImplementedError("concat_activation is not ported")
        if use_aux:
            raise NotImplementedError("aux inputs are not ported")
        self.dropout_prob = dropout_prob
        branch = max(max(in_channels, out_channels) // bottleneck_divisor, 1)
        for n in SCALARS:
            setattr(self, f"bias{n}", nn.Parameter(torch.zeros(1)))
        self.scale = nn.Parameter(torch.ones(1))
        self.branch_conv1 = CausalConv3dAdd(in_channels, branch, 1, mask, False,
                                            fixup_branch_init(num_layers))
        self.expand_rf = ExpandRFConv(branch)
        self.branch_conv2 = CausalConv3dAdd(branch, branch, kernel_size, "B", False,
                                            kaiming_normal_init())
        self.condition = None
        if condition_dim > 0:
            self.condition = Conv3D(condition_dim, branch, condition_kernel_size,
                                    pad=condition_kernel_size // 2)
        self.branch_conv3 = CausalConv3dAdd(branch, out_channels, 1, "B", False, zeros_init())
        self.skip_conv = None
        if in_channels != out_channels or mask == "A":
            self.skip_conv = CausalConv3dAdd(in_channels, out_channels, 1, mask, True,
                                             xavier_normal_init())

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for n in SCALARS:
                getattr(self, f"bias{n}").zero_()
            self.scale.fill_(1.0)

    def forward(self, stack: Stack, condition: Optional[torch.Tensor] = None,
                train: bool = False, keep: Optional[torch.Tensor] = None) -> Stack:
        """``keep``: (B, 3·Cb) 0/1 dropout keep mask, [d|h|w], used when
        ``train`` and dropout_prob > 0 (drawn from torch's default generator
        when None)."""
        if (condition is None) != (self.condition is None):
            raise ValueError("a condition is needed exactly when condition_dim > 0")
        dt = stack[0].dtype

        def pre(x, a, b):
            return F.elu(x + a.to(dt)) + b.to(dt)

        out = self.branch_conv1(tuple(pre(x, self.bias1a, self.bias1b) for x in stack))
        out = self.expand_rf(out)
        out = self.branch_conv2(tuple(pre(x, self.bias2a, self.bias2b) for x in out))
        p = self.dropout_prob
        if train and p > 0:
            cb = out[0].shape[1]
            if keep is None:
                keep = draw_keep_masks((out[0].shape[0], 3 * cb), p, device=out[0].device)
            out = tuple(torch.where(keep[:, s * cb:(s + 1) * cb, None, None, None] > 0,
                                    o / (1.0 - p), 0.0) for s, o in enumerate(out))
        if self.condition is not None:
            cond = self.condition(condition)
            out = tuple(o + cond.to(dt) for o in out)
        out = self.branch_conv3(tuple(pre(x, self.bias3a, self.bias3b) for x in out))
        out = tuple(o * self.scale.to(dt) + self.bias4.to(dt) for o in out)
        skip = stack if self.skip_conv is None else self.skip_conv(stack)
        return tuple(o + s for o, s in zip(out, skip))
