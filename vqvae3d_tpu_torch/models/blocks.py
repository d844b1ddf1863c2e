"""Residual blocks of the hierarchical 3D VQ-VAE on (B, C, H, W, D) volumes.

Counterpart of ``vqvae3d_tpu/models/blocks.py`` for the pre-activation block
type (the default, reference vqvae/layers.py:102-216):

  * ``PreActFixupResBlock`` in modes same/down/up, with skip convs and
    ``bias1c``/``bias1d`` where the shape changes;
  * ``ResizeConv3D`` — trilinear x2 upsample + conv (the JAX stock path);
  * ``DownBlock`` / ``UpBlock`` / ``PreQuantizationConditioning``;
  * ``apply_same_stack`` — the one call site of kernel K3: every 'same'
    stack runs through ``ops.stack_kernel.preact_stack_fused`` (on a CUDA
    tensor the K3 forward and, in training, its backward; on a CPU tensor
    the plain block).

Module attributes follow the reference torch module tree, so ``state_dict``
keys are the reference checkpoint keys that
``vqvae3d_tpu/train/checkpoint.py::convert_reference_vqvae_state_dict``
reads (``layers.{seq}``, ``branch_conv{1,2,3}.weight``, ``skip_conv.weight``,
``bias1a`` …). The Fixup scalars are shape-(1,) fp32 parameters; compute runs
in the block's ``dtype``. The JAX module's TPU layout paths (packed stacks,
folded I/O, block-space convs, stack folds) compute the same math and are
not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops.conv3d import (
    Conv3D,
    fixup_branch_init,
    kaiming_normal_init,
    xavier_normal_init,
    zeros_init,
)
from vqvae3d_tpu_torch.ops.resize import trilinear_upsample2x
from vqvae3d_tpu_torch.ops.stack_kernel import preact_fixup_same, preact_stack_fused

SCALARS = ("1a", "1b", "2a", "2b", "3a", "3b", "4")


class ResizeConv3D(Conv3D):
    """Trilinear x2 upsample followed by a conv (reference layers.py:591-597):
    a checkerboard-free upscale. Holds ``weight`` directly, as the reference
    module does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return super().forward(trilinear_upsample2x(x))


def _mode_conv(mode, cin, features, pad_mode, kernel_init, dtype):
    """The mode's spatial conv: down = k4s2p1, same = k3s1p1, up = ResizeConv3D k3s1p1."""
    if mode == "down":
        return Conv3D(cin, features, 4, stride=2, pad=1, pad_mode=pad_mode,
                      use_bias=False, kernel_init=kernel_init, dtype=dtype)
    if mode == "same":
        return Conv3D(cin, features, 3, stride=1, pad=1, pad_mode=pad_mode,
                      use_bias=False, kernel_init=kernel_init, dtype=dtype)
    if mode == "up":
        return ResizeConv3D(cin, features, 3, stride=1, pad=1, pad_mode=pad_mode,
                            use_bias=False, kernel_init=kernel_init, dtype=dtype)
    raise NotImplementedError(f"block mode {mode!r} is not ported")


def _mode_skip_conv(mode, cin, features, dtype):
    """Skip path: k2s2 for 'down', upsampling 1x1x1 for 'up', else 1x1x1."""
    init = xavier_normal_init()
    if mode == "down":
        return Conv3D(cin, features, 2, stride=2, pad=0, use_bias=False,
                      kernel_init=init, dtype=dtype)
    if mode == "up":
        return ResizeConv3D(cin, features, 1, pad=0, use_bias=False,
                            kernel_init=init, dtype=dtype)
    return Conv3D(cin, features, 1, use_bias=False, kernel_init=init, dtype=dtype)


class PreActFixupResBlock(nn.Module):
    """Pre-activation bottleneck Fixup block: 1x1x1 -> mode conv -> 1x1x1,
    bottleneck_divisor 2, 7 scalar biases + 1 scale, and a skip conv with
    ``bias1c``/``bias1d`` when the shape changes (reference layers.py:102-216)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        mode: str = "same",
        num_layers: int = 1,
        bottleneck_divisor: int = 2,
        pad_mode: str = "wrap",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if mode not in ("same", "down", "up"):
            raise NotImplementedError(f"block mode {mode!r} is not ported")
        self.mode = mode
        self.pad_mode = pad_mode
        self.dtype = dtype
        cb = max(max(in_channels, out_channels) // bottleneck_divisor, 1)
        for n in SCALARS:
            setattr(self, f"bias{n}", nn.Parameter(torch.zeros(1)))
        self.scale = nn.Parameter(torch.ones(1))
        self.branch_conv1 = Conv3D(in_channels, cb, 1, use_bias=False,
                                   kernel_init=fixup_branch_init(num_layers), dtype=dtype)
        self.branch_conv2 = _mode_conv(mode, cb, cb, pad_mode, kaiming_normal_init(), dtype)
        self.branch_conv3 = Conv3D(cb, out_channels, 1, use_bias=False,
                                   kernel_init=zeros_init(), dtype=dtype)
        self.needs_skip = not (mode == "same" and in_channels == out_channels)
        if self.needs_skip:
            self.bias1c = nn.Parameter(torch.zeros(1))
            self.bias1d = nn.Parameter(torch.zeros(1))
            self.skip_conv = _mode_skip_conv(mode, in_channels, out_channels, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for n in SCALARS + (("1c", "1d") if self.needs_skip else ()):
                getattr(self, f"bias{n}").zero_()
            self.scale.fill_(1.0)

    def scalars8(self) -> torch.Tensor:
        """(8,) fp32: (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale)."""
        return torch.cat([getattr(self, f"bias{n}") for n in SCALARS] + [self.scale])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        if not self.needs_skip:
            return preact_fixup_same(
                x, self.branch_conv1.weight, self.branch_conv2.weight,
                self.branch_conv3.weight, self.scalars8(), pad_mode=self.pad_mode,
            )
        dt = x.dtype

        def s(p):  # scalar in compute dtype
            return p.to(dt)

        out = F.elu(x + s(self.bias1a))
        out = self.branch_conv1(out + s(self.bias1b))
        out = F.elu(out + s(self.bias2a))
        out = self.branch_conv2(out + s(self.bias2b))
        out = F.elu(out + s(self.bias3a))
        out = self.branch_conv3(out + s(self.bias3b))
        out = out * s(self.scale) + s(self.bias4)
        skip = self.skip_conv(x + s(self.bias1c))
        return out + skip + s(self.bias1d)


def apply_same_stack(
    x: torch.Tensor,
    blocks: Sequence[PreActFixupResBlock],
    *,
    pad_mode: str,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Run shape-preserving 'same' blocks over x (``apply_same_stack``,
    vqvae3d_tpu/models/blocks.py:688-908): the stack's weights are stacked per
    block and handed to ``preact_stack_fused`` — kernel K3 on a CUDA tensor,
    the plain block loop on a CPU tensor. In training its backward returns
    the gradients of the stacked tensors, and ``torch.stack`` takes them on
    to each block's parameters."""
    if not blocks:
        return x
    if dtype is not None:
        x = x.to(dtype)
    w1s = torch.stack([blk.branch_conv1.weight for blk in blocks])
    w2s = torch.stack([blk.branch_conv2.weight for blk in blocks])
    w3s = torch.stack([blk.branch_conv3.weight for blk in blocks])
    sc8 = torch.stack([blk.scalars8() for blk in blocks])
    return preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode)


def _resize_layers(mode, schedule, n_post, num_layers, pad_mode, dtype):
    """For each (cin, cout) of ``schedule``: a resize block of ``mode``, then
    ``n_post`` 'same' blocks at cout — the reference Sequential's order."""
    layers: List[nn.Module] = []
    for cin, cout in schedule:
        layers.append(PreActFixupResBlock(cin, cout, mode, num_layers,
                                          pad_mode=pad_mode, dtype=dtype))
        layers += [PreActFixupResBlock(cout, cout, "same", num_layers,
                                       pad_mode=pad_mode, dtype=dtype)
                   for _ in range(n_post)]
    return nn.ModuleList(layers)


class DownBlock(nn.Module):
    """n_down x (stride-2 'down' block doubling channels, then
    ``n_post_downscale_blocks`` 'same' blocks). Reference layers.py:306-324."""

    def __init__(self, in_channels, n_down=2, n_post_downscale_blocks=0,
                 num_layers=1, pad_mode="wrap", dtype=None):
        super().__init__()
        self.n_post, self.pad_mode, self.dtype = n_post_downscale_blocks, pad_mode, dtype
        schedule = [(in_channels * 2**i, in_channels * 2 ** (i + 1)) for i in range(n_down)]
        self.layers = _resize_layers("down", schedule, self.n_post, num_layers, pad_mode, dtype)

    def forward(self, x):
        return _run_resize_then_stacks(self, x)


class UpBlock(nn.Module):
    """Mirror of DownBlock with ResizeConv upsampling (reference
    layers.py:327-354): layer i, from n_up-1 down to 0, maps
    ``in_channels if i == n_up-1 else out·2^(i+1)`` -> ``out·2^i``."""

    def __init__(self, in_channels, out_channels, n_up=2, n_post_upscale_blocks=0,
                 num_layers=1, pad_mode="wrap", dtype=None):
        super().__init__()
        self.n_post, self.pad_mode, self.dtype = n_post_upscale_blocks, pad_mode, dtype
        outs = [out_channels * 2**i for i in range(n_up - 1, -1, -1)]
        schedule = list(zip([in_channels] + outs[:-1], outs))
        self.layers = _resize_layers("up", schedule, self.n_post, num_layers, pad_mode, dtype)

    def forward(self, x):
        return _run_resize_then_stacks(self, x)


def _run_resize_then_stacks(block, x):
    """Down/UpBlock body: each resize block, then its 'same' stack."""
    step = 1 + block.n_post
    for seq in range(0, len(block.layers), step):
        x = block.layers[seq](x)
        x = apply_same_stack(x, block.layers[seq + 1 : seq + step],
                             pad_mode=block.pad_mode, dtype=block.dtype)
    return x


class PreQuantizationConditioning(nn.Module):
    """Top-down conditioning in the encoder (reference layers.py:357-387):
    upsample the coarser level's quantization, concat, 1x1x1 proj, then a
    'same' block down to the embedding width. ``has_aux`` is False only for
    the deepest level."""

    def __init__(self, in_channels, out_channels, has_aux, n_up=2,
                 n_post_upscale_blocks=0, num_layers=1, pad_mode="wrap", dtype=None):
        super().__init__()
        self.has_aux = has_aux
        if has_aux:
            self.upsample = UpBlock(out_channels * 2 ** n_up, out_channels, n_up,
                                    n_post_upscale_blocks, num_layers,
                                    pad_mode=pad_mode, dtype=dtype)
            self.proj = Conv3D(in_channels, in_channels, 1, dtype=dtype)
        self.pre_q = PreActFixupResBlock(in_channels, out_channels, "same", num_layers,
                                         pad_mode=pad_mode, dtype=dtype)

    def forward(self, x, aux=None):
        if (aux is not None) != self.has_aux:
            raise ValueError("aux must be given exactly for levels with a coarser level")
        if aux is not None:
            up = self.upsample(aux)
            x = self.proj(torch.cat([x.to(up.dtype), up], dim=1))
        return self.pre_q(x)
