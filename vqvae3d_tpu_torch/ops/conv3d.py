"""3D convolution with explicit 'zeros' / 'wrap' padding, and the init functions.

Counterpart of ``vqvae3d_tpu/ops/conv3d.py``. Layout is the reference torch
one: activations (B, C, H, W, D), weights (O, I, kH, kW, kD). Padding is
applied explicitly and the conv runs unpadded, which reproduces the
reference's symmetric torch padding (k4s2 pads (1, 1)); 'wrap' is circular
padding on all three spatial axes (reference ``padding_mode='circular'``).

These are the plain convolutions XLA computed outside any Pallas kernel, so
they go to ``F.conv3d`` (cuDNN on a card). Weights are kept fp32 and cast to
the activation dtype at call time; the bias is added after the conv, as the
JAX package does, so the conv output rounds before the bias add.

The TPU-only rewrites of the JAX module (block-space s2d convs, folded
weights, the small-channel custom backward) are exact re-expressions of this
math for 128-lane layouts and are not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

def pad3d(x: torch.Tensor, pad: int, mode: str = "zeros") -> torch.Tensor:
    """Pad the three spatial dims (H, W, D) of (B, C, H, W, D) by ``pad`` on
    each side."""
    if pad == 0:
        return x
    if mode == "zeros":
        return F.pad(x, (pad,) * 6)
    if mode == "wrap":
        return F.pad(x, (pad,) * 6, mode="circular")
    raise ValueError(f"unknown pad mode {mode!r}")


def conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    pad_mode: str = "zeros",
) -> torch.Tensor:
    """x: (B, Cin, H, W, D); w: (Cout, Cin, kH, kW, kD) -> (B, Cout, H', W', D')."""
    x = pad3d(x, padding, pad_mode)
    out = F.conv3d(x, w.to(x.dtype), stride=stride)
    if b is not None:
        out = out + b.to(out.dtype)[:, None, None, None]
    return out


# ---------------------------------------------------------------------------
# Initializers of the reference's Fixup scheme, on (O, I, kH, kW, kD) shapes.
# Each returns init(shape, generator) -> fp32 tensor, like the JAX package's
# init(key, shape, dtype).
# ---------------------------------------------------------------------------


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * std


def fixup_branch_init(num_layers: int) -> Callable:
    """N(0, sqrt(2 / (C_out · prod(kernel))) · num_layers^-1/2)."""

    def init(shape, generator):
        fan = shape[0] * math.prod(shape[2:])
        return _normal(shape, math.sqrt(2.0 / fan) * num_layers ** -0.5, generator)

    return init


def kaiming_normal_init() -> Callable:
    """torch.nn.init.kaiming_normal_ default: std = sqrt(2 / fan_in)."""

    def init(shape, generator):
        fan_in = shape[1] * math.prod(shape[2:])
        return _normal(shape, math.sqrt(2.0 / fan_in), generator)

    return init


def xavier_normal_init() -> Callable:
    """torch.nn.init.xavier_normal_: std = sqrt(2 / (fan_in + fan_out))."""

    def init(shape, generator):
        rf = math.prod(shape[2:])
        return _normal(shape, math.sqrt(2.0 / (shape[1] * rf + shape[0] * rf)), generator)

    return init


def torch_conv_default_init() -> Callable:
    """torch Conv3d default (kaiming_uniform, a=sqrt(5)): U(-1/sqrt(fan_in), +)."""

    def init(shape, generator):
        bound = 1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return init


def zeros_init() -> Callable:
    def init(shape, generator):
        return torch.zeros(shape)

    return init


class Conv3D(nn.Module):
    """3D conv with torch-compatible explicit padding; parameters ``weight``
    (O, I, k, k, k) and optional ``bias`` (O,). ``dtype`` is the compute
    dtype the input is cast to (None keeps the input's)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 1,
        stride: int = 1,
        pad: int = 0,
        pad_mode: str = "zeros",
        use_bias: bool = True,
        kernel_init: Optional[Callable] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.pad = pad
        self.pad_mode = pad_mode
        self.dtype = dtype
        self.kernel_init = kernel_init or torch_conv_default_init()
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(self.kernel_init(tuple(self.weight.shape), generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return conv3d(
            x, self.weight, self.bias,
            stride=self.stride, padding=self.pad, pad_mode=self.pad_mode,
        )
