"""Hierarchical 3D VQ-VAE-2: config, encoder, decoder and the combined model.

Counterpart of ``vqvae3d_tpu/models/vqvae.py`` (reference vqvae/layers.py:
463-588 and vqvae/model.py). ``encode`` returns per-level (loss, quantized,
indices) ordered FINE -> COARSE; the encoder runs deepest-first, feeding each
level's quantization top-down into the next-finer level.

Layout: input and output volumes are (B, C, H, W, D); code grids are
(B, H, W, D). The module tree reproduces the reference torch module tree, so
``state_dict()`` carries the reference checkpoint keys (``encoder.down.0.
layers.0.branch_conv1.weight``, ``encoder.quantize.0.embed``,
``decoder.up.0.1.layers.0 …``).

``VQVAEConfig`` keeps the JAX config's field names, so either package reads
the other's ``step_N_config.json``. Fields that select TPU layout devices
(``remat*``, ``packed_stacks``, ``scan_stacks``, ``argmin_method``) change no
result and are carried only for that interchange. Options outside this
port's slice raise ``NotImplementedError`` when the model is built or run:
``block_type`` other than 'pre-activation', ``encoder_variant='encoder'``,
``metric='mixture-nll'``.

``train=True`` runs the quantizers' train path: the first-pass codebook init
and the EMA update, in place on their buffers (kernel K1b on a card); the
encoder and decoder compute the same values as in eval, and autograd runs
the 'same' stacks' backward through kernel K3's (``ops/stack_kernel.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vqvae3d_tpu_torch.models.blocks import (
    PreActFixupResBlock,
    PreQuantizationConditioning,
    UpBlock,
    DownBlock,
    apply_same_stack,
)
from vqvae3d_tpu_torch.models.quantizer import Quantizer
from vqvae3d_tpu_torch.ops.conv3d import Conv3D
from vqvae3d_tpu_torch.ops.resize import depth_to_space, space_to_depth


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    """Hyperparameters; the same fields as the JAX package's VQVAEConfig."""

    input_channels: int = 1
    output_channels: int = 1
    base_network_channels: int = 4
    n_bottleneck_blocks: int = 3
    n_blocks_per_bottleneck: int = 2
    n_pre_quantization_blocks: int = 0
    n_post_quantization_blocks: int = 0
    n_post_upscale_blocks: int = 0
    n_post_downscale_blocks: int = 0
    num_embeddings: Tuple[int, ...] = (256, 256, 256)
    block_type: str = "pre-activation"
    encoder_variant: str = "encoder2"
    commitment_cost: float = 0.1
    ema_decay: float = 0.99
    laplace_alpha: float = 1e-5
    metric: str = "huber"
    n_mix: int = 2
    base_lr: float = 1e-5
    extract_center_cylinder: bool = True
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_blocks: bool = False
    argmin_method: str = "auto"
    pad_mode: str = "wrap"
    remat_policy: Any = None
    stem_space_to_depth: int = 1
    packed_stacks: str = "auto"
    scan_stacks: bool = True

    def __post_init__(self):
        f = self.stem_space_to_depth
        if f < 1 or f & (f - 1):
            raise ValueError("stem factor must be a power of 2")
        if 2 ** self.stem_log2 > 2 ** self.n_blocks_per_bottleneck:
            raise ValueError("stem factor cannot exceed the first level's downscale")
        if self.pad_mode not in ("wrap", "zeros"):
            raise ValueError(f"unknown pad_mode {self.pad_mode!r}")
        if len(self.num_embeddings) not in (1, self.n_bottleneck_blocks):
            raise ValueError("num_embeddings needs 1 or n_bottleneck_blocks entries")
        ne = tuple(self.num_embeddings)
        if len(ne) == 1:
            ne = ne * self.n_bottleneck_blocks
        object.__setattr__(self, "num_embeddings", ne)

    def check_ported(self) -> None:
        """Raise for options outside the port's slice."""
        if self.block_type != "pre-activation":
            raise NotImplementedError(
                f"block_type={self.block_type!r}: only 'pre-activation' is ported"
            )
        if self.encoder_variant != "encoder2":
            raise NotImplementedError(
                f"encoder_variant={self.encoder_variant!r}: only 'encoder2' is ported"
            )
        if self.metric != "huber":
            raise NotImplementedError(
                f"metric={self.metric!r}: the mixture-nll head is not ported"
            )

    @property
    def n_enc(self) -> int:
        return self.n_bottleneck_blocks

    @property
    def head_channels(self) -> int:
        if self.metric == "mixture-nll":
            return 3 * self.n_mix * self.output_channels
        return self.output_channels

    @property
    def stem_log2(self) -> int:
        return int(self.stem_space_to_depth).bit_length() - 1

    def level_n_down(self, i: int) -> int:
        """Stride-2 halvings inside level i's Down/UpBlock."""
        nd = self.n_blocks_per_bottleneck
        return nd - self.stem_log2 if i == 0 else nd

    @property
    def level_channels(self) -> List[int]:
        """Feature channels after each level's DownBlock (fine -> coarse)."""
        out, ch = [], self.base_network_channels
        for i in range(self.n_enc):
            ch = ch * 2 ** self.level_n_down(i)
            out.append(ch)
        return out

    @property
    def embedding_dims(self) -> List[int]:
        """Codebook embedding dim per level (fine -> coarse): channels // 8."""
        for ch in self.level_channels:
            if ch % 8:
                raise ValueError(f"level channels {ch} not divisible by 8")
        return [ch // 8 for ch in self.level_channels]

    @property
    def downscale_factor(self) -> int:
        return 2 ** self.n_blocks_per_bottleneck

    @property
    def num_layers(self) -> int:
        """Longest path through the model — the Fixup init scale."""
        n_down = self.n_bottleneck_blocks * self.n_blocks_per_bottleneck
        return (
            2
            + 2 * n_down
            + self.n_pre_quantization_blocks
            + self.n_post_quantization_blocks
            + self.n_post_downscale_blocks * n_down
            + self.n_post_upscale_blocks * n_down
            + 1
        )

    def code_grid_shapes(self, volume_shape: Sequence[int]) -> List[Tuple[int, ...]]:
        """Code-grid spatial shapes (fine -> coarse) for an input volume."""
        shapes, cur, f = [], tuple(volume_shape), self.downscale_factor
        for _ in range(self.n_enc):
            cur = tuple(s // f for s in cur)
            shapes.append(cur)
        return shapes

    def same_stacks(self, volume_shape: Sequence[int]):
        """Every 'same' stack one volume runs through, in order:
        [(part, channels, spatial, n_blocks)] with part 'encode' or 'decode'
        and spatial the stack's (H, W, D). Each block is one launch of kernel
        K3 on a card."""
        f, emb, chans = self.stem_space_to_depth, self.embedding_dims, self.level_channels
        cur = tuple(s // f for s in volume_shape)
        stacks, grids = [], []

        def up_stacks(part, out_ch, n_up, spatial):
            for k in range(n_up - 1, -1, -1):
                spatial = tuple(2 * s for s in spatial)
                stacks.append((part, out_ch * 2 ** k, spatial, self.n_post_upscale_blocks))

        ch = self.base_network_channels
        for i in range(self.n_enc):  # DownBlocks
            for _ in range(self.level_n_down(i)):
                ch, cur = ch * 2, tuple(s // 2 for s in cur)
                stacks.append(("encode", ch, cur, self.n_post_downscale_blocks))
            grids.append(cur)
        for i in reversed(range(self.n_enc)):  # top-down conditioning, pre-q
            if i != self.n_enc - 1:
                up_stacks("encode", emb[i], self.n_blocks_per_bottleneck, grids[i + 1])
            stacks.append(("encode", emb[i], grids[i], self.n_pre_quantization_blocks))
        for i in reversed(range(self.n_enc)):  # post-q, UpBlocks
            in_ch = emb[i] + (chans[i] if i != self.n_enc - 1 else 0)
            stacks.append(("decode", in_ch, grids[i], self.n_post_quantization_blocks))
            out_ch = self.base_network_channels if i == 0 else chans[i - 1]
            up_stacks("decode", out_ch, self.level_n_down(i), grids[i])
        return [s for s in stacks if s[3] > 0]


def _same_stack(n, channels, cfg):
    return nn.ModuleList(
        PreActFixupResBlock(channels, channels, "same", cfg.num_layers,
                            pad_mode=cfg.pad_mode, dtype=cfg.dtype)
        for _ in range(n)
    )


class Encoder(nn.Module):
    """Hierarchical encoder ('encoder2', reference layers.py:519-588): per
    level a DownBlock, then (deepest first) PreQuantizationConditioning on
    the coarser quantization, the pre-q 'same' stack at embedding width and
    the quantizer."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        nl, f = cfg.num_layers, cfg.stem_space_to_depth
        self.parse_input = Conv3D(cfg.input_channels * f ** 3, cfg.base_network_channels,
                                  1, dtype=cfg.dtype)
        downs, before = [], cfg.base_network_channels
        for i in range(cfg.n_enc):
            downs.append(DownBlock(before, cfg.level_n_down(i), cfg.n_post_downscale_blocks,
                                   nl, pad_mode=cfg.pad_mode, dtype=cfg.dtype))
            before *= 2 ** cfg.level_n_down(i)
        self.down = nn.ModuleList(downs)
        chans, emb = cfg.level_channels, cfg.embedding_dims
        self.pre_quantize_cond = nn.ModuleList(
            PreQuantizationConditioning(
                chans[i] + (emb[i] if i != cfg.n_enc - 1 else 0), emb[i],
                has_aux=i != cfg.n_enc - 1, n_up=cfg.n_blocks_per_bottleneck,
                n_post_upscale_blocks=cfg.n_post_upscale_blocks, num_layers=nl,
                pad_mode=cfg.pad_mode, dtype=cfg.dtype,
            )
            for i in range(cfg.n_enc)
        )
        self.pre_quantize = nn.ModuleList(
            _same_stack(cfg.n_pre_quantization_blocks, emb[i], cfg) for i in range(cfg.n_enc)
        )
        self.quantize = nn.ModuleList(
            Quantizer(cfg.num_embeddings[i], emb[i], cfg.commitment_cost,
                      decay=cfg.ema_decay, laplace_alpha=cfg.laplace_alpha)
            for i in range(cfg.n_enc)
        )

    def forward(self, x, train: bool = False):
        cfg = self.cfg
        x = self.parse_input(space_to_depth(x, cfg.stem_space_to_depth))
        downs = []
        for down in self.down:
            x = down(x)
            downs.append(x)
        aux, results = None, []
        for i in reversed(range(cfg.n_enc)):
            h = self.pre_quantize_cond[i](downs[i], aux)
            h = apply_same_stack(h, self.pre_quantize[i], pad_mode=cfg.pad_mode,
                                 dtype=cfg.dtype)
            loss, quantized, indices = self.quantize[i](h, train=train)
            results.append((loss, quantized, indices))
            aux = quantized
        return list(reversed(results))  # fine -> coarse


class Decoder(nn.Module):
    """Hierarchical decoder (reference layers.py:463-517): coarse -> fine,
    concat the level's quantization with the upsampled previous output
    (1x1x1 proj), the post-q 'same' stack, then an UpBlock; a 1x1x1 out conv
    and the stem's depth_to_space at the end. ``up[i]`` holds the post-q
    blocks followed by the UpBlock, as the reference Sequential does."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        nl, emb, f = cfg.num_layers, cfg.embedding_dims, cfg.stem_space_to_depth
        self.proj = nn.ModuleList()
        ups = []
        for i in range(cfg.n_enc):
            out_ch = cfg.base_network_channels if i == 0 else cfg.level_channels[i - 1]
            in_ch = emb[i] + (cfg.level_channels[i] if i != cfg.n_enc - 1 else 0)
            if i != cfg.n_enc - 1:
                self.proj.append(Conv3D(in_ch, in_ch, 1, dtype=cfg.dtype))
            up = _same_stack(cfg.n_post_quantization_blocks, in_ch, cfg)
            up.append(UpBlock(in_ch, out_ch, cfg.level_n_down(i), cfg.n_post_upscale_blocks,
                              nl, pad_mode=cfg.pad_mode, dtype=cfg.dtype))
            ups.append(up)
        self.up = nn.ModuleList(ups)
        self.out = Conv3D(cfg.base_network_channels, cfg.head_channels * f ** 3, 1,
                          dtype=cfg.dtype)

    def forward(self, quantizations, train: bool = False):
        """``train`` changes nothing in the decoder (the JAX signature's flag)."""
        cfg = self.cfg
        out = None
        for i in reversed(range(cfg.n_enc)):
            q = quantizations[i].to(cfg.dtype) if cfg.dtype else quantizations[i]
            h = self.proj[i](torch.cat([q, out], dim=1)) if i != cfg.n_enc - 1 else q
            *post, up = self.up[i]
            h = apply_same_stack(h, post, pad_mode=cfg.pad_mode, dtype=cfg.dtype)
            out = up(h)
        return depth_to_space(self.out(out), cfg.stem_space_to_depth)


class VQVAE(nn.Module):
    """Encoder + decoder. ``forward`` returns
    (decoded, (losses, quantizations, indices)), per-level tuples fine -> coarse.

    Parameters are initialized on the CPU from ``generator`` (a fixed seed
    when None) with the reference's Fixup scheme, then moved to ``device``."""

    def __init__(self, config: VQVAEConfig, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        config.check_ported()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x, train: bool = False):
        results = self.encode(x, train=train)
        losses, quantizations, indices = zip(*results)
        decoded = self.decode(quantizations, train=train)
        return decoded, (losses, quantizations, indices)

    def encode(self, x, train: bool = False):
        return self.encoder(x, train=train)

    def decode(self, quantizations, train: bool = False):
        return self.decoder(quantizations, train=train)

    def embed_code(self, level: int, indices: torch.Tensor) -> torch.Tensor:
        """(...,) int code grid -> (..., D) fp32 embeddings of that level."""
        return self.encoder.quantize[level].embed_code(indices)
