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

Training: a stride-1 conv with a kernel other than 1x1x1 and at most
``SMALLC_MAX`` channels in and out runs through ``_SmallConv3d``, the JAX
package's ``_conv3d_valid_smallc`` (vqvae3d_tpu/ops/conv3d.py:287-336):
forward ``F.conv3d``, dx the transposed conv (cuDNN, as XLA computes it in
the JAX package), dW ``dw_conv3d`` — kernel K7 (``csrc/dw_conv3d.cu``) on a
CUDA tensor, ``dw_conv3d_plain`` on a CPU tensor. Every other conv keeps the
plain autograd.

The TPU-only rewrites of the JAX module (block-space s2d convs, folded
weights) are exact re-expressions of this math for 128-lane layouts and are
not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops import _build

SMALLC_MAX = 32  # the custom backward takes max(Cin, Cout) <= this


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
    if (stride == 1 and tuple(w.shape[2:]) != (1, 1, 1) and max(w.shape[:2]) <= SMALLC_MAX
            and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        out = _SmallConv3d.apply(x, w)
    else:
        out = F.conv3d(x, w.to(x.dtype), stride=stride)
    if b is not None:
        out = out + b.to(out.dtype)[:, None, None, None]
    return out


def dw_conv3d_plain(xp: torch.Tensor, g: torch.Tensor, ksize) -> torch.Tensor:
    """dW of a stride-1 VALID conv, one fp32 contraction per tap:
    dW[:, :, i, j, l] = sum_{b, pos} g[b, :, pos] x[b, :, pos + (i, j, l)]^T.
    xp (B, Cin, Hp, Wp, Dp), g (B, Cout, Ho, Wo, Do) -> (Cout, Cin, kH, kW, kD)."""
    kh, kw, kd = ksize
    _, _, ho, wo, do = g.shape
    gf, xf = g.float(), xp.float()
    taps = [
        torch.einsum("bohwd,bihwd->oi", gf, xf[:, :, i: i + ho, j: j + wo, l: l + do])
        for i in range(kh) for j in range(kw) for l in range(kd)
    ]
    return torch.stack(taps, -1).reshape(*g.shape[1:2], xp.shape[1], kh, kw, kd)


DW_TILE = 64  # output positions per shared-memory tile of K7 (csrc/dw_conv3d.cu)


def dw_conv3d(xp: torch.Tensor, g: torch.Tensor, ksize) -> torch.Tensor:
    """fp32 weight gradient of a stride-1 VALID conv (see ``dw_conv3d_plain``).

    CPU tensors take ``dw_conv3d_plain``; CUDA tensors launch kernel K7
    (fp32 or bf16 inputs, at most ``SMALLC_MAX`` channels each way) and add
    one to ``dw_conv3d.launches``. Deterministic: the same inputs give a
    bit-identical dW."""
    if xp.device.type == "cpu":
        return dw_conv3d_plain(xp, g, ksize)
    if xp.device.type != "cuda":
        raise NotImplementedError(f"dw_conv3d: no kernel for device {xp.device}")
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dw_conv3d takes fp32 or bf16, got {xp.dtype}")
    kh, kw, kd = ksize
    b, cin, hp, wp, dp = xp.shape
    cout = g.shape[1]
    if tuple(g.shape) != (b, cout, hp - kh + 1, wp - kw + 1, dp - kd + 1) or max(cin, cout) > SMALLC_MAX:
        raise ValueError(f"dw_conv3d: x {tuple(xp.shape)}, g {tuple(g.shape)}, kernel {ksize}")
    x = xp.contiguous()
    gg = g.to(xp.dtype).contiguous()
    npos = g[:, 0].numel()
    kvol = kh * kw * kd
    nchunks = max(1, min(-(-npos // (DW_TILE * 8)), 4096 // kvol))
    part = torch.empty(nchunks * kvol * cin * cout, dtype=torch.float32, device=xp.device)
    dw = torch.empty(cout, cin, kh, kw, kd, dtype=torch.float32, device=xp.device)
    _build.check(
        _build.library().vq_dw_conv3d(
            int(xp.dtype == torch.bfloat16), x.data_ptr(), gg.data_ptr(), dw.data_ptr(),
            part.data_ptr(), nchunks, b, cin, cout, hp, wp, dp, kh, kw, kd,
            _build.stream_ptr(xp.device),
        ),
        "dw_conv3d",
    )
    dw_conv3d.launches += 1
    return dw


dw_conv3d.launches = 0


class _SmallConv3d(torch.autograd.Function):
    """Stride-1 VALID conv of a pre-padded input with the small-channel
    backward: dx by the transposed conv, dW by ``dw_conv3d`` (fp32)."""

    @staticmethod
    def forward(ctx, xp, w):
        ctx.save_for_backward(xp, w)
        return F.conv3d(xp, w.to(xp.dtype))

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(xp.shape, w.to(g.dtype), g)
        if ctx.needs_input_grad[1]:
            dw = dw_conv3d(xp, g, tuple(w.shape[2:])).to(w.dtype)
        return dx, dw


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
