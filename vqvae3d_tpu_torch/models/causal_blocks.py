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
``branch_conv2`` and before the condition add). With ``use_aux`` a block
takes an ``aux`` stack (PixelSNAIL's attention output, ``branch`` channels):
a 1x1x1 ``CausalConv3dAdd`` with bias over elu(aux), added after ExpandRF.
With ``concat_activation`` the block's three pre-activations are
``ConcatActivation`` (cat[elu(x), −elu(−x)] on channels, reference
layers.py:112-119) and its three branch convs are grouped (``groups=2``)
over the doubled inputs, as JAX ``causal_blocks.py:216-324``: ExpandRF, the
condition and the skip conv stay ungrouped, and the branch is at least 2
channels. ``FixupCausalResBlock`` is the reference's simpler two-conv
variant (layers.py:251-335; JAX ``:481-567``): two k-sized causal convs at
``max(in, out)`` channels, four scalar biases and a scale, channel dropout
after the first ELU, a trailing ELU unless ``out``; it takes no condition
and no aux. ``GatedResBlock`` (JAX ``:570-666``) is ported for parity only:
no model of either package calls it. Module attributes follow the reference
torch tree, so ``state_dict`` keys are the reference checkpoint keys
(``branch_conv1.depth_conv.weight``, ``expand_rf.height_conv.bias``,
``condition.weight``, ``skip_conv.width_conv.bias``, ``aux.depth_conv.weight``,
``bias1a`` …).

PixelSNAIL's parts (JAX ``causal_blocks.py:666-920``):

  * ``CausalAttention``: multi-head causal self-attention over the raster
    sequence, per stream, no parameters. Its path is decided from the device,
    the dropout and S before any launch (``attention_path``): with attention
    dropout off, kernel K8 (``ops/flash_attention.py``) on a card and the
    dense path at the JAX dense path's rounding on the CPU (what the JAX
    package runs off the TPU); with dropout on, the reference's pre-mask
    logit dropout (kept logits × 1/(1 − p), dropped ones −1e3) on the dense
    path up to S = 2048 on either device (as JAX does on the TPU too), and
    beyond that kernel K5 (``ops/flash_dropout_attention.py``) on a card and
    its plain version, O(S·chunk) memory, on the CPU. Every dropout route
    draws one Philox seed per call from the step's generator and takes its
    keep mask from ``flash_dropout_attention.keep_mask``, so the routes of
    one step see the same mask.
  * ``CausalAttentionPixelBlock``: N causal blocks, then attention keyed on
    [stack | out | background] and queried on [out | background], with the
    reference's swapped roles, then an ``out_proj`` block with the attention
    as ``aux``.
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
from vqvae3d_tpu_torch.ops.flash_attention import flash_causal_attention
from vqvae3d_tpu_torch.ops.flash_dropout_attention import (
    draw_seed,
    flash_causal_dropout_attention,
    keep_mask,
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
    """One stream's conv: ``weight`` (O, I / groups, k0, k1, k2), optional
    ``bias``; the input is padded by ``pads`` ((front, back) per spatial
    axis), then convolved VALID."""

    def __init__(self, in_channels: int, features: int, kernel_shape: Sequence[int],
                 pads, use_bias: bool, kernel_init: Callable, groups: int = 1):
        super().__init__()
        self.pads = tuple(tuple(p) for p in pads)
        self.kernel_init = kernel_init
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(features, in_channels // groups, *kernel_shape))
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
        return conv3d(x, self.weight, self.bias, groups=self.groups)


class CausalConv3dAdd(nn.Module):
    """Three parallel causal convs, one per stream (reference layers.py:122-222):
    depth (k−1, k, k), height (1, k−1, k), width (1, 1, k//2 + [mask 'B'])."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 mask: str = "B", use_bias: bool = True,
                 kernel_init: Optional[Callable] = None, groups: int = 1):
        super().__init__()
        if mask not in ("A", "B"):
            raise ValueError(f"mask must be 'A' or 'B', got {mask!r}")
        self.mask = mask
        init = kernel_init or torch_conv_default_init()
        for name, (shape, pads) in zip(("depth_conv", "height_conv", "width_conv"),
                                       causal_conv_geometry(kernel_size, mask)):
            setattr(self, name, CausalConv(in_channels, features, shape, pads, use_bias, init,
                                           groups))

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


class ConcatActivation(nn.Module):
    """cat[elu(x), −elu(−x)] on the channel dim (reference layers.py:112-119;
    JAX ``causal_blocks.py:180-185``); no parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([F.elu(x), -F.elu(-x)], 1)


def _channel_dropout(stack: Stack, keep: Optional[torch.Tensor], p: float) -> Stack:
    """torch Dropout3d on each stream: ``keep`` (B, 3·C) 0/1, [d|h|w] (drawn
    from torch's default generator when None); kept channels × 1/(1 − p)."""
    c = stack[0].shape[1]
    if keep is None:
        keep = draw_keep_masks((stack[0].shape[0], 3 * c), p, device=stack[0].device)
    return tuple(torch.where(keep[:, s * c:(s + 1) * c, None, None, None] > 0, o / (1.0 - p), 0.0)
                 for s, o in enumerate(stack))


class PreActFixupCausalResBlock(nn.Module):
    """Pre-activation bottleneck Fixup causal block (reference
    layers.py:338-497): 1x1x1 (mask) → ExpandRF → k (mask 'B') →
    (+ condition) → 1x1x1, 7 scalar biases and a scale, and a skip 1x1x1
    (with bias) only for mask 'A' or a change of width. With
    ``concat_activation`` the three branch convs are grouped (2 groups) over
    ``ConcatActivation``'s doubled channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 mask: str = "B", condition_dim: int = 0, condition_kernel_size: int = 1,
                 dropout_prob: float = 0.5, bottleneck_divisor: int = 4,
                 concat_activation: bool = False, use_aux: bool = False,
                 num_layers: int = 1):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.act = ConcatActivation() if concat_activation else nn.ELU()
        g = 2 if concat_activation else 1
        branch = max(max(in_channels, out_channels) // bottleneck_divisor, g)
        self.branch = branch  # the keep mask's channels a stream
        for n in SCALARS:
            setattr(self, f"bias{n}", nn.Parameter(torch.zeros(1)))
        self.scale = nn.Parameter(torch.ones(1))
        self.branch_conv1 = CausalConv3dAdd(g * in_channels, branch, 1, mask, False,
                                            fixup_branch_init(num_layers), groups=g)
        self.expand_rf = ExpandRFConv(branch)
        self.aux = (CausalConv3dAdd(branch, branch, 1, "B", True, torch_conv_default_init())
                    if use_aux else None)
        self.branch_conv2 = CausalConv3dAdd(g * branch, branch, kernel_size, "B", False,
                                            kaiming_normal_init(), groups=g)
        self.condition = None
        if condition_dim > 0:
            self.condition = Conv3D(condition_dim, branch, condition_kernel_size,
                                    pad=condition_kernel_size // 2)
        self.branch_conv3 = CausalConv3dAdd(g * branch, out_channels, 1, "B", False, zeros_init(),
                                            groups=g)
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
                train: bool = False, keep: Optional[torch.Tensor] = None,
                aux: Optional[Stack] = None) -> Stack:
        """``keep``: (B, 3·Cb) 0/1 dropout keep mask, [d|h|w], used when
        ``train`` and dropout_prob > 0 (drawn from torch's default generator
        when None). ``aux``: a (B, Cb, ...) stack, given exactly when the
        block was built with ``use_aux``."""
        if (condition is None) != (self.condition is None):
            raise ValueError("a condition is needed exactly when condition_dim > 0")
        if (aux is None) != (self.aux is None):
            raise ValueError("an aux stack is needed exactly when use_aux")
        dt = stack[0].dtype

        def pre(x, a, b):
            return self.act(x + a.to(dt)) + b.to(dt)

        out = self.branch_conv1(tuple(pre(x, self.bias1a, self.bias1b) for x in stack))
        out = self.expand_rf(out)
        if self.aux is not None:
            out = tuple(o + a for o, a in zip(out, self.aux(tuple(F.elu(x) for x in aux))))
        out = self.branch_conv2(tuple(pre(x, self.bias2a, self.bias2b) for x in out))
        if train and self.dropout_prob > 0:
            out = _channel_dropout(out, keep, self.dropout_prob)
        if self.condition is not None:
            cond = self.condition(condition)
            out = tuple(o + cond.to(dt) for o in out)
        out = self.branch_conv3(tuple(pre(x, self.bias3a, self.bias3b) for x in out))
        out = tuple(o * self.scale.to(dt) + self.bias4.to(dt) for o in out)
        skip = stack if self.skip_conv is None else self.skip_conv(stack)
        return tuple(o + s for o, s in zip(out, skip))


FIXUP_SCALARS = ("1a", "1b", "2a", "2b")


class FixupCausalResBlock(nn.Module):
    """The two-conv causal Fixup block (reference layers.py:251-335; JAX
    ``causal_blocks.py:481-567``): k (mask) → ELU → (dropout) → k (mask 'B')
    at ``branch = max(in, out)`` channels, scalars ``bias1a/1b/2a/2b`` and
    ``scale``, a skip 1x1x1 (with bias; Kaiming init, Xavier when ``out``)
    for mask 'A' or a change of width, and an ELU after the residual unless
    ``out``. No condition, no aux."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 mask: str = "B", out: bool = False, dropout_prob: float = 0.5,
                 num_layers: int = 1):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.out = out
        branch = max(in_channels, out_channels)
        self.branch = branch  # the keep mask's channels a stream
        for n in FIXUP_SCALARS:
            setattr(self, f"bias{n}", nn.Parameter(torch.zeros(1)))
        self.scale = nn.Parameter(torch.ones(1))
        self.branch_conv1 = CausalConv3dAdd(in_channels, branch, kernel_size, mask, False,
                                            fixup_branch_init(num_layers))
        self.branch_conv2 = CausalConv3dAdd(branch, out_channels, kernel_size, "B", False,
                                            zeros_init())
        self.skip_conv = None
        if in_channels != out_channels or mask == "A":
            self.skip_conv = CausalConv3dAdd(
                in_channels, out_channels, 1, mask, True,
                xavier_normal_init() if out else kaiming_normal_init())

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for n in FIXUP_SCALARS:
                getattr(self, f"bias{n}").zero_()
            self.scale.fill_(1.0)

    def forward(self, stack: Stack, condition: Optional[torch.Tensor] = None,
                train: bool = False, keep: Optional[torch.Tensor] = None,
                aux: Optional[Stack] = None) -> Stack:
        """``keep``: (B, 3·branch) 0/1 dropout keep mask, [d|h|w], used when
        ``train`` and dropout_prob > 0 (drawn from torch's default generator
        when None)."""
        if condition is not None or aux is not None:
            raise ValueError("FixupCausalResBlock takes neither a condition nor an aux stack")
        dt = stack[0].dtype

        def s(name):
            return getattr(self, f"bias{name}").to(dt)

        out = self.branch_conv1(tuple(x + s("1a") for x in stack))
        out = tuple(F.elu(x + s("1b")) for x in out)
        if train and self.dropout_prob > 0:
            out = _channel_dropout(out, keep, self.dropout_prob)
        out = self.branch_conv2(tuple(x + s("2a") for x in out))
        out = tuple(x * self.scale.to(dt) + s("2b") for x in out)
        skip = stack if self.skip_conv is None else self.skip_conv(stack)
        out = tuple(o + sk for o, sk in zip(out, skip))
        return out if self.out else tuple(F.elu(x) for x in out)


def tanh_glu(x: torch.Tensor) -> torch.Tensor:
    """PixelCNN++'s gate over the channel halves: tanh(a)·sigmoid(b)."""
    a, b = x.chunk(2, dim=1)
    return torch.tanh(a) * torch.sigmoid(b)


class GatedResBlock(nn.Module):
    """PixelCNN++-style tanh·sigmoid gated causal block (reference
    layers.py:504-610; JAX ``causal_blocks.py:570-666``), ported for parity
    only: no model of either package calls it (the reference disables it).
    A k-sized ``causal_conv`` to 2·C a stream; the cross-stream feeds are
    shifted explicitly: depth → height one s0-slice back, height → width one
    s1-row down, depth → width both; an optional 1x1x1 condition conv a
    stream (``condition_conv_{i}``); the gate; a 1x1x1 ``res_conv_{i}`` onto
    the skip (the input, or a mask-'A' 1x1x1 ``skip_conv``)."""

    def __init__(self, in_channels: int, kernel_size: int = 3, mask: str = "B",
                 condition_dim: int = 0, condition_kernel_size: int = 1):
        super().__init__()
        c = in_channels
        self.causal_conv = CausalConv3dAdd(c, 2 * c, kernel_size, mask, True)
        self.depth_conv = Conv3D(2 * c, 4 * c, 1, groups=2)
        self.height_conv = Conv3D(2 * c, 2 * c, 1)
        self.conditioned = condition_dim > 0
        if self.conditioned:
            for i in range(3):
                setattr(self, f"condition_conv_{i}",
                        Conv3D(condition_dim, 2 * c, condition_kernel_size,
                               pad=condition_kernel_size // 2))
        self.skip_conv = CausalConv3dAdd(c, c, 1, "A", True) if mask == "A" else None
        for i in range(3):
            setattr(self, f"res_conv_{i}", Conv3D(c, c, 1))

    def forward(self, stack: Stack, condition: Optional[torch.Tensor] = None) -> Stack:
        if (condition is not None) != self.conditioned:
            raise ValueError("a condition is needed exactly when condition_dim > 0")
        depth, height, width = self.causal_conv(stack)
        d2h, d2w = self.depth_conv(depth).chunk(2, dim=1)
        height = height + shift_backwards_3d(d2h)
        h2w = self.height_conv(height)
        width = width + shift_down_3d(h2w) + shift_down_3d(shift_backwards_3d(d2w))
        streams = [depth, height, width]
        if condition is not None:
            streams = [x + getattr(self, f"condition_conv_{i}")(condition).to(x.dtype)
                       for i, x in enumerate(streams)]
        skip = stack if self.skip_conv is None else self.skip_conv(stack)
        return tuple(sk + getattr(self, f"res_conv_{i}")(tanh_glu(x))
                     for i, (sk, x) in enumerate(zip(skip, streams)))


# Above this sequence length the dense path's O(S²) logits give way to a
# flash kernel (JAX ``causal_blocks.py:666-669``).
DENSE_MAX_SEQ = 2048


def attention_path(device_type: str, dropout_active: bool, seq: int) -> str:
    """Which path ``CausalAttention`` takes: 'flash' (kernel K8),
    'flash_dropout' (kernel K5 on a card, its plain version on the CPU) or
    'dense'; raises for a device with no path."""
    if device_type not in ("cpu", "cuda"):
        raise NotImplementedError(f"CausalAttention: no path for device {device_type}")
    if dropout_active:
        return "dense" if seq <= DENSE_MAX_SEQ else "flash_dropout"
    return "flash" if device_type == "cuda" else "dense"


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, C, s0, s1, s2) -> (B, nh, S, C / nh), channel c = head·dh + d."""
    b, c = x.shape[:2]
    return x.reshape(b, nh, c // nh, -1).transpose(-1, -2)


def dense_causal_attention(q, k, v, sm_scale: float, dropout_prob: float = 0.0,
                           seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX dense path (``causal_blocks.py:815-831``) on (N, S, dh) heads,
    at its rounding: q scaled in its dtype, the logits' product in the input
    dtype then fp32, the optional pre-mask logit dropout (the keep mask of
    ``keep_mask(seed, ...)``), the causal mask, an fp32 softmax, the weights
    cast to v's dtype for the product."""
    n, s = q.shape[:2]
    logits = ((q * sm_scale) @ k.transpose(-1, -2)).float()
    if dropout_prob > 0:
        keep = keep_mask(seed, n, torch.arange(s, device=q.device), s, dropout_prob)
        logits = torch.where(keep, logits * (1.0 / (1.0 - dropout_prob)), -1e3)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    weights = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return weights.to(v.dtype) @ v


class CausalAttention(nn.Module):
    """Multi-head causal self-attention over the flattened (s0, s1, s2)
    sequence, applied per stream (reference layers.py:613-647). No
    parameters. The three streams and the heads fold into N of an (N, S, dh)
    call (n = stream·B·nh + batch·nh + head), so one attention block is one
    K8 or K5 launch. In training with dropout, one seed per call (two 32-bit
    words, a device tensor: no host sync) is drawn from ``generator`` before
    the path is chosen (JAX's ``seed_from_rng(make_rng('dropout'))``,
    ``causal_blocks.py:779-785``)."""

    def __init__(self, num_heads: int = 8, dropout_prob: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_prob = dropout_prob

    def forward(self, keys: Stack, queries: Stack, values: Stack, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Stack:
        nh = self.num_heads
        ck, cv = keys[0].shape[1], values[0].shape[1]
        if ck % nh or cv % nh:
            raise ValueError(f"{ck} key and {cv} value channels over {nh} heads")
        seq = keys[0][0, 0].numel()
        dev = keys[0].device
        p = self.dropout_prob if train else 0.0
        seed = draw_seed(generator, dev) if p > 0 else None
        sm_scale = (ck // nh) ** -0.5
        path = attention_path(dev.type, p > 0, seq)

        def fold(stack):  # 3 x (B, C, ...) -> (3·B·nh, S, dh)
            return torch.stack([_heads(x, nh) for x in stack]).flatten(0, 2)

        q, k, v = fold(queries), fold(keys), fold(values)
        if path == "dense":
            out = dense_causal_attention(q, k, v, sm_scale, p, seed)
        elif path == "flash":
            out = flash_causal_attention(q, k, v, sm_scale)
        else:
            out = flash_causal_dropout_attention(q, k, v, sm_scale, p, seed)
        b = keys[0].shape[0]
        out = out.reshape(3, b, nh, seq, cv // nh)
        # (B, nh, S, dv) -> (B, nh·dv, *grid)
        return tuple(out[i].transpose(-1, -2).reshape(b, cv, *values[i].shape[2:])
                     for i in range(3))


class CausalAttentionPixelBlock(nn.Module):
    """PixelSNAIL block (reference layers.py:650-703; JAX
    ``causal_blocks.py:834-920``): ``num_layers_per_block`` mask-'B' causal
    blocks, then causal attention over (stack, out, background), then the
    ``out_proj`` block with the attention as aux. The condition is passed to
    every inner block (the reference's ``condition_cache`` slip is not
    copied, as in JAX)."""

    def __init__(self, model_dim: int, kernel_size: int = 3, num_layers_per_block: int = 5,
                 bottleneck_divisor: int = 4, condition_dim: int = 0, num_heads: int = 8,
                 causal_dropout_prob: float = 0.5, attention_dropout_prob: float = 0.5,
                 num_layers: int = 1):
        super().__init__()
        branch = model_dim // bottleneck_divisor

        def block(use_aux=False):
            return PreActFixupCausalResBlock(
                model_dim, model_dim, kernel_size, "B", condition_dim=condition_dim,
                dropout_prob=causal_dropout_prob, bottleneck_divisor=bottleneck_divisor,
                use_aux=use_aux, num_layers=num_layers)

        self.causal_layers = nn.ModuleList(block() for _ in range(num_layers_per_block))
        init = torch_conv_default_init()
        self.key_value_proj = CausalConv3dAdd(2 * model_dim + 3, 2 * branch, 1, "B", True, init)
        self.query_proj = CausalConv3dAdd(model_dim + 3, branch, 1, "B", True, init)
        self.causal_attention = CausalAttention(num_heads, attention_dropout_prob)
        self.out_proj = block(use_aux=True)

    def forward(self, stack: Stack, background: torch.Tensor,
                condition: Optional[torch.Tensor] = None, train: bool = False,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Stack:
        """``background`` (B, 3, *grid); ``keep`` (N + 1, B, 3·Cb): the
        channel-dropout masks of the N inner blocks and ``out_proj``;
        ``generator`` draws the attention dropout."""
        out = stack
        for i, layer in enumerate(self.causal_layers):
            out = layer(out, condition, train=train, keep=None if keep is None else keep[i])
        bg = background.to(out[0].dtype)
        kv = self.key_value_proj(tuple(torch.cat([s, o, bg], 1) for s, o in zip(stack, out)))
        branch = kv[0].shape[1] // 2
        keys = tuple(x[:, :branch] for x in kv)
        values = tuple(x[:, branch:] for x in kv)
        queries = self.query_proj(tuple(torch.cat([o, bg], 1) for o in out))
        # the reference's swapped roles (JAX :897-907): the output position's
        # vector comes from the key/value projection, the attended positions'
        # from the query projection; converted checkpoints depend on it
        attn = self.causal_attention(keys=queries, queries=keys, values=values, train=train,
                                     generator=generator)
        return self.out_proj(out, condition, train=train,
                             keep=None if keep is None else keep[-1], aux=attn)
