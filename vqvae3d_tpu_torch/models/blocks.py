"""Residual blocks of the hierarchical 3D VQ-VAE on (B, C, H, W, D) volumes.

Counterpart of ``vqvae3d_tpu/models/blocks.py`` (reference
vqvae/layers.py:14-387, vqvae/evonorm.py), the three block types of
``RESBLOCKS``:

  * ``PreActFixupResBlock`` ('pre-activation', the default, reference
    layers.py:102-216) in modes same/down/up, with skip convs and
    ``bias1c``/``bias1d`` where the shape changes;
  * ``FixupResBlock`` ('regular', layers.py:219-303): two convs, the first
    the mode's (zero padding whatever the config's pad mode), four scalar
    biases and a scale, a skip conv with a bias always, an ELU after the
    sum except in mode 'out';
  * ``EvonormResBlock`` ('evonorm', layers.py:14-98) of three
    ``EvoNorm3DS0`` + conv pairs with biases, its SiLU-velocity
    (``silu_velocity``, an autograd Function with the reference's hand-written
    backward) over ``group_std``;
  * ``ResizeConv3D`` — trilinear x2 upsample + conv (the JAX stock path);
  * ``DownBlock`` / ``UpBlock`` / ``PreQuantizationConditioning``, of any
    block type (``make_block``);
  * ``apply_same_stack`` — the one call site of kernel K3: every
    pre-activation 'same' stack runs through
    ``ops.stack_kernel.preact_stack_fused`` (on a CUDA tensor the K3 forward
    and, in training, its backward; on a CPU tensor the plain block). The
    other block types run their stacks as a loop of blocks, the choice the
    JAX package makes from the config (its scan and kernel paths take
    pre-activation blocks only).

Module attributes follow the reference torch module tree, so ``state_dict``
keys of pre-activation blocks are the reference checkpoint keys that
``vqvae3d_tpu/train/checkpoint.py::convert_reference_vqvae_state_dict``
reads (``layers.{seq}``, ``branch_conv{1,2,3}.weight``, ``skip_conv.weight``,
``bias1a`` …). The 'regular' and 'evonorm' blocks keep the JAX parameter
names (``bias1a``, ``scale``, ``evonorm_1.v``, ``branch_conv1.bias``,
``skip_conv.bias`` …). The Fixup scalars are shape-(1,) fp32 parameters,
EvoNorm's ``v``, ``gamma`` and ``beta`` (C,) fp32; compute runs in the
block's ``dtype`` (EvoNorm in fp32 inside it). The JAX module's TPU layout
paths (packed stacks, folded I/O, block-space convs, stack folds) compute the
same math and are not ported.
"""
from __future__ import annotations

import math
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
from vqvae3d_tpu_torch.parallel import halo, mesh

SCALARS = ("1a", "1b", "2a", "2b", "3a", "3b", "4")


class ResizeConv3D(Conv3D):
    """Trilinear x2 upsample followed by a conv (reference layers.py:591-597):
    a checkerboard-free upscale. Holds ``weight`` directly, as the reference
    module does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return super().forward(trilinear_upsample2x(x))


def _mode_conv(mode, cin, features, pad_mode, kernel_init, dtype, use_bias=False):
    """The mode's spatial conv: down = k4s2p1, same/out = k3s1p1, up =
    ResizeConv3D k3s1p1."""
    kw = dict(pad_mode=pad_mode, use_bias=use_bias, kernel_init=kernel_init, dtype=dtype)
    if mode == "down":
        return Conv3D(cin, features, 4, stride=2, pad=1, **kw)
    if mode in ("same", "out"):
        return Conv3D(cin, features, 3, stride=1, pad=1, **kw)
    if mode == "up":
        return ResizeConv3D(cin, features, 3, stride=1, pad=1, **kw)
    raise ValueError(f"unknown block mode {mode!r}")


def _mode_skip_conv(mode, cin, features, dtype, use_bias=False,
                    kernel_init=xavier_normal_init()):
    """Skip path: k2s2 for 'down', upsampling 1x1x1 for 'up', else 1x1x1."""
    kw = dict(use_bias=use_bias, kernel_init=kernel_init, dtype=dtype)
    if mode == "down":
        return Conv3D(cin, features, 2, stride=2, pad=0, **kw)
    if mode == "up":
        return ResizeConv3D(cin, features, 1, pad=0, **kw)
    return Conv3D(cin, features, 1, **kw)


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


FIXUP_SCALARS = ("1a", "1b", "2a", "2b")


class FixupResBlock(nn.Module):
    """Two-conv Fixup block (reference layers.py:219-303): the mode's conv
    (Fixup init) -> ELU -> a zero-init 3x3x3 conv, scaled, plus a skip conv
    with a bias (kaiming init), then an ELU unless the mode is 'out'. Both
    branch convs pad with zeros whatever the model's pad mode (the JAX
    package passes the pad mode to pre-activation blocks only)."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "same",
                 num_layers: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in ("same", "down", "up", "out"):
            raise ValueError(f"unknown block mode {mode!r}")
        self.mode = mode
        self.dtype = dtype
        for n in FIXUP_SCALARS:
            setattr(self, f"bias{n}", nn.Parameter(torch.zeros(1)))
        self.scale = nn.Parameter(torch.ones(1))
        self.branch_conv1 = _mode_conv(mode, in_channels, out_channels, "zeros",
                                       fixup_branch_init(num_layers), dtype)
        self.branch_conv2 = Conv3D(out_channels, out_channels, 3, stride=1, pad=1,
                                   use_bias=False, kernel_init=zeros_init(), dtype=dtype)
        self.skip_conv = _mode_skip_conv(mode, in_channels, out_channels, dtype, use_bias=True,
                                         kernel_init=kaiming_normal_init())

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for n in FIXUP_SCALARS:
                getattr(self, f"bias{n}").zero_()
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        dt = x.dtype
        out = self.branch_conv1(x + self.bias1a.to(dt))
        out = F.elu(out + self.bias1b.to(dt))
        out = self.branch_conv2(out + self.bias2a.to(dt))
        out = out * self.scale.to(dt) + self.bias2b.to(dt)
        out = out + self.skip_conv(x)
        return out if self.mode == "out" else F.elu(out)


def group_std(x: torch.Tensor, groups: Optional[int] = None, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel group) std over the group's channels and every
    spatial voxel of (B, C, ...), broadcast back to x's shape (a view: the
    (B, C, 1, ...) stds expanded). About 8 channels a group; the population
    variance; right for any batch (the reference's evonorm.py:8-26 reshapes
    to batch 1). On an H slab (``parallel/halo.py``) the two-pass
    statistics are summed over the space group, so they are the whole
    volume's."""
    b, c = x.shape[:2]
    if groups is None:
        groups = max(c // 8, 1)
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    xg = x.reshape(b, groups, c // groups, *x.shape[2:])
    dims = tuple(range(2, xg.ndim))
    if halo.active():
        n = math.prod(xg.shape[2:]) * mesh.space_size()
        group = mesh.space_group()
        mean = mesh.AllReduceSum.apply(xg.sum(dims, keepdim=True), group) / n
        var = mesh.AllReduceSum.apply(torch.square(xg - mean).sum(dims, keepdim=True), group) / n
    else:
        var = torch.var(xg, dim=dims, keepdim=True, correction=0)
    std = torch.sqrt(var + eps)
    per_channel = std.expand(b, groups, c // groups, *std.shape[3:]).reshape(
        b, c, *std.shape[3:])
    return per_channel.expand(x.shape)


class _SiluVelocity(torch.autograd.Function):
    """x sigmoid(v x), its backward recomputing the sigmoid from the saved
    inputs (the reference's SiLUVelocityFunc, evonorm.py:29-47; JAX
    ``_silu_velocity_bwd``)."""

    @staticmethod
    def forward(ctx, x, v):
        ctx.save_for_backward(x, v)
        return x * torch.sigmoid(x * v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        xv = x * v
        s = torch.sigmoid(xv)
        d_sig = s * (1.0 - s)
        dx = g * (s + xv * d_sig)
        dv = g * (x * x * d_sig)
        # v broadcasts over the batch and spatial axes: sum its gradient back
        dv = dv.sum_to_size(v.shape) if dv.shape != v.shape else dv
        return dx, dv


def silu_velocity(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(v · x) with the reference's hand-written backward; v
    broadcasts against x."""
    return _SiluVelocity.apply(x, v)


class EvoNorm3DS0(nn.Module):
    """EvoNorm-S0: silu_velocity(x, v) · gamma / group_std(x) + beta, in fp32
    whatever the model's dtype; parameters (C,) with the reference's inits
    (v ones, gamma and beta zeros; evonorm.py:59-76)."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.v = nn.Parameter(torch.ones(channels))
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.v.fill_(1.0)
            self.gamma.zero_()
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        xf = x.float()
        shape = (-1,) + (1,) * (x.ndim - 2)
        num = silu_velocity(xf, self.v.float().view(shape))
        out = num * self.gamma.view(shape) / group_std(xf) + self.beta.view(shape)
        return out.to(x.dtype)


class EvonormResBlock(nn.Module):
    """EvoNorm-S0 bottleneck block (reference layers.py:14-98): three
    (EvoNorm, conv with bias) pairs — 1x1x1, the mode's conv (zero padding),
    1x1x1 — at ``max(max(in, out) // 4, 1)`` branch channels, plus the input,
    or a skip conv with a bias where the shape changes. Mode 'out' is 'same'.
    Every conv kaiming-initialised (the blocks self-initialise; no Fixup
    scale)."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "same",
                 num_layers: int = 1, bottleneck_divisor: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in ("same", "down", "up", "out"):
            raise ValueError(f"unknown block mode {mode!r}")
        mode = "same" if mode == "out" else mode
        self.mode = mode
        cb = max(max(in_channels, out_channels) // bottleneck_divisor, 1)
        init = kaiming_normal_init()
        self.evonorm_1 = EvoNorm3DS0(in_channels, dtype)
        self.branch_conv1 = Conv3D(in_channels, cb, 1, kernel_init=init, dtype=dtype)
        self.evonorm_2 = EvoNorm3DS0(cb, dtype)
        self.branch_conv2 = _mode_conv(mode, cb, cb, "zeros", init, dtype, use_bias=True)
        self.evonorm_3 = EvoNorm3DS0(cb, dtype)
        self.branch_conv3 = Conv3D(cb, out_channels, 1, kernel_init=init, dtype=dtype)
        self.needs_skip = not (mode == "same" and in_channels == out_channels)
        if self.needs_skip:
            self.skip_conv = _mode_skip_conv(mode, in_channels, out_channels, dtype,
                                             use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.branch_conv1(self.evonorm_1(x))
        out = self.branch_conv2(self.evonorm_2(out))
        out = self.branch_conv3(self.evonorm_3(out))
        return out + (self.skip_conv(x) if self.needs_skip else x)


RESBLOCKS = {
    "regular": FixupResBlock,
    "pre-activation": PreActFixupResBlock,
    "evonorm": EvonormResBlock,
}


def make_block(block_type: str, in_channels: int, out_channels: int, mode: str,
               num_layers: int, pad_mode: str = "wrap", dtype=None) -> nn.Module:
    """A block of ``RESBLOCKS[block_type]``; only pre-activation blocks take
    the model's pad mode (as in the JAX package)."""
    if block_type not in RESBLOCKS:
        raise ValueError(f"unknown block_type {block_type!r}")
    kw = dict(pad_mode=pad_mode) if block_type == "pre-activation" else {}
    return RESBLOCKS[block_type](in_channels, out_channels, mode, num_layers, dtype=dtype, **kw)


def apply_same_stack(
    x: torch.Tensor,
    blocks: Sequence[nn.Module],
    *,
    pad_mode: str,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Run shape-preserving 'same' blocks over x (``apply_same_stack``,
    vqvae3d_tpu/models/blocks.py:688-908). Pre-activation blocks: the
    stack's weights are stacked per block and handed to
    ``preact_stack_fused`` — kernel K3 on a CUDA tensor, the plain block loop
    on a CPU tensor; in training its backward returns the gradients of the
    stacked tensors, and ``torch.stack`` takes them on to each block's
    parameters. Blocks of the other types run one after another."""
    if not blocks:
        return x
    if dtype is not None:
        x = x.to(dtype)
    if not isinstance(blocks[0], PreActFixupResBlock):
        for blk in blocks:
            x = blk(x)
        return x
    w1s = torch.stack([blk.branch_conv1.weight for blk in blocks])
    w2s = torch.stack([blk.branch_conv2.weight for blk in blocks])
    w3s = torch.stack([blk.branch_conv3.weight for blk in blocks])
    sc8 = torch.stack([blk.scalars8() for blk in blocks])
    return preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode)


def _resize_layers(block_type, mode, schedule, n_post, num_layers, pad_mode, dtype):
    """For each (cin, cout) of ``schedule``: a resize block of ``mode``, then
    ``n_post`` 'same' blocks at cout — the reference Sequential's order."""
    layers: List[nn.Module] = []
    for cin, cout in schedule:
        layers.append(make_block(block_type, cin, cout, mode, num_layers, pad_mode, dtype))
        layers += [make_block(block_type, cout, cout, "same", num_layers, pad_mode, dtype)
                   for _ in range(n_post)]
    return nn.ModuleList(layers)


class DownBlock(nn.Module):
    """n_down x (stride-2 'down' block doubling channels, then
    ``n_post_downscale_blocks`` 'same' blocks). Reference layers.py:306-324."""

    def __init__(self, in_channels, n_down=2, n_post_downscale_blocks=0,
                 num_layers=1, pad_mode="wrap", dtype=None, block_type="pre-activation"):
        super().__init__()
        self.n_post, self.pad_mode, self.dtype = n_post_downscale_blocks, pad_mode, dtype
        schedule = [(in_channels * 2**i, in_channels * 2 ** (i + 1)) for i in range(n_down)]
        self.layers = _resize_layers(block_type, "down", schedule, self.n_post, num_layers,
                                     pad_mode, dtype)

    def forward(self, x):
        return _run_resize_then_stacks(self, x)


class UpBlock(nn.Module):
    """Mirror of DownBlock with ResizeConv upsampling (reference
    layers.py:327-354): layer i, from n_up-1 down to 0, maps
    ``in_channels if i == n_up-1 else out·2^(i+1)`` -> ``out·2^i``."""

    def __init__(self, in_channels, out_channels, n_up=2, n_post_upscale_blocks=0,
                 num_layers=1, pad_mode="wrap", dtype=None, block_type="pre-activation"):
        super().__init__()
        self.n_post, self.pad_mode, self.dtype = n_post_upscale_blocks, pad_mode, dtype
        outs = [out_channels * 2**i for i in range(n_up - 1, -1, -1)]
        schedule = list(zip([in_channels] + outs[:-1], outs))
        self.layers = _resize_layers(block_type, "up", schedule, self.n_post, num_layers,
                                     pad_mode, dtype)

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
                 n_post_upscale_blocks=0, num_layers=1, pad_mode="wrap", dtype=None,
                 block_type="pre-activation"):
        super().__init__()
        self.has_aux = has_aux
        if has_aux:
            self.upsample = UpBlock(out_channels * 2 ** n_up, out_channels, n_up,
                                    n_post_upscale_blocks, num_layers,
                                    pad_mode=pad_mode, dtype=dtype, block_type=block_type)
            self.proj = Conv3D(in_channels, in_channels, 1, dtype=dtype)
        self.pre_q = make_block(block_type, in_channels, out_channels, "same", num_layers,
                                pad_mode, dtype)

    def forward(self, x, aux=None, whole_aux: bool = False):
        """``whole_aux``: x is an H slab and aux the quantization of a coarser
        level that runs whole on every rank of the space group
        (``models/vqvae.py``): aux is upsampled whole and the rank keeps its
        slab of the result."""
        if (aux is not None) != self.has_aux:
            raise ValueError("aux must be given exactly for levels with a coarser level")
        if aux is not None:
            if whole_aux:
                with halo.whole():
                    up = self.upsample(aux)
                up = mesh.space_slab(up)
            else:
                up = self.upsample(aux)
            x = self.proj(torch.cat([x.to(up.dtype), up], dim=1))
        return self.pre_q(x)
