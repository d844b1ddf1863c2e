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
the other's ``step_N_config.json``; the JAX fields that select TPU layout
devices (``JAX_LAYOUT_FIELDS``: remat, packed and scanned stacks, the argmin
method) change no result and are dropped when a config is read
(``checkpoint.config_from_json``). Every option the JAX config accepts is
built: the block types of ``RESBLOCKS`` ('pre-activation', 'regular',
'evonorm'), both encoder variants ('encoder2'; the legacy 'encoder', whose
pre-quantization stacks run at the level's full feature width before the
top-down conditioning) and both metrics ('huber'; 'mixture-nll', whose
decoder head emits ``3 n_mix`` channels per output channel).

``train=True`` runs the quantizers' train path: the first-pass codebook init
and the EMA update, in place on their buffers (kernel K1b on a card); the
encoder and decoder compute the same values as in eval, and autograd runs
the 'same' stacks' backward through kernel K3's (``ops/stack_kernel.py``).

Under a space axis of s ranks (``--mesh-shape d s``, ``parallel/``) each
rank holds an H slab of the volume. A level whose code grid's H s does not
divide runs whole on every rank of the space group, and so does every
coarser level (``VQVAEConfig.first_whole_level``): its DownBlock, its
conditioning, its pre-quantization stack, its quantizer, its
post-quantization stack and its UpBlock. That is the JAX quantizer's
``_shardable`` fallback (vqvae3d_tpu/models/quantizer.py:116-122), which
there covers the lookup alone because GSPMD re-partitions the convs; the
port's convs exchange halos, which need whole stride-2 windows in every
slab. The slabs are gathered (``mesh.gather_slabs``) into the first whole
level's DownBlock, and each rank takes its slab (``mesh.space_slab``) of
the UpBlocks out of that level, in the encoder's conditioning and in the
decoder. With 32x32x16 volumes at stem 2 and s = 4, for instance: stem
slabs of 4 rows, level 0 (H 8) slabs of 2 rows, level 1 (H 2) whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vqvae3d_tpu_torch.models.blocks import (
    RESBLOCKS,
    PreQuantizationConditioning,
    UpBlock,
    DownBlock,
    apply_same_stack,
    make_block,
)
from vqvae3d_tpu_torch.models.quantizer import Quantizer
from vqvae3d_tpu_torch.ops.conv3d import Conv3D
from vqvae3d_tpu_torch.ops.resize import depth_to_space, space_to_depth
from vqvae3d_tpu_torch.parallel import halo, mesh


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
    pad_mode: str = "wrap"
    stem_space_to_depth: int = 1

    def __post_init__(self):
        if self.block_type not in RESBLOCKS:
            raise ValueError(f"unknown block_type {self.block_type!r}")
        if self.encoder_variant not in ("encoder2", "encoder"):
            raise ValueError(f"unknown encoder_variant {self.encoder_variant!r}")
        if self.metric not in ("huber", "mixture-nll"):
            raise ValueError(f"unknown metric {self.metric!r}")
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

    def first_whole_level(self, volume_h: int, space: int) -> int:
        """Under a space axis of ``space`` ranks, the finest level whose code
        grid's H (of volumes ``volume_h`` high) the axis does not divide:
        it and every coarser level run whole on each rank of the space
        group. ``n_enc`` where the axis divides every level's H (and at
        ``space`` 1). Where it divides level i's H, level i's input slabs
        hold whole stride-2 windows of each of its DownBlock's convs."""
        for i, (h,) in enumerate(self.code_grid_shapes((volume_h,))):
            if h % space:
                return i
        return self.n_enc

    def same_stacks(self, volume_shape: Sequence[int]):
        """Every 'same' stack one volume runs through, in order:
        [(part, channels, spatial, n_blocks)] with part 'encode' or 'decode'
        and spatial the stack's (H, W, D). With pre-activation blocks each
        block is one launch of kernel K3 on a card."""
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
        legacy = self.encoder_variant == "encoder"
        for i in reversed(range(self.n_enc)):  # (legacy pre-q,) conditioning, pre-q
            if legacy:
                stacks.append(("encode", chans[i], grids[i], self.n_pre_quantization_blocks))
            if i != self.n_enc - 1:
                up_stacks("encode", emb[i], self.n_blocks_per_bottleneck, grids[i + 1])
            if not legacy:
                stacks.append(("encode", emb[i], grids[i], self.n_pre_quantization_blocks))
        for i in reversed(range(self.n_enc)):  # post-q, UpBlocks
            in_ch = emb[i] + (chans[i] if i != self.n_enc - 1 else 0)
            stacks.append(("decode", in_ch, grids[i], self.n_post_quantization_blocks))
            out_ch = self.base_network_channels if i == 0 else chans[i - 1]
            up_stacks("decode", out_ch, self.level_n_down(i), grids[i])
        return [s for s in stacks if s[3] > 0]


JAX_LAYOUT_FIELDS = ("remat", "remat_blocks", "remat_policy", "argmin_method",
                     "packed_stacks", "scan_stacks")  # the JAX config's; dropped on load


def whole_levels(cfg: VQVAEConfig, x: torch.Tensor) -> int:
    """The first level of ``cfg`` that runs whole for the volume x, an H
    slab of a volume s times as high under a space axis of s ranks
    (``VQVAEConfig.first_whole_level``; ``n_enc`` without one). Decided from
    shapes before any launch."""
    s = mesh.space_size() if halo.active() else 1
    return cfg.first_whole_level(x.shape[2] * s, s)


def _level(i: int, whole_from: int):
    """The context level i runs in: ``halo.whole()`` from ``whole_from`` on."""
    return halo.whole() if i >= whole_from else contextlib.nullcontext()


def _same_stack(n, channels, cfg):
    return nn.ModuleList(
        make_block(cfg.block_type, channels, channels, "same", cfg.num_layers,
                   cfg.pad_mode, cfg.dtype)
        for _ in range(n)
    )


class Encoder(nn.Module):
    """Hierarchical encoder (reference layers.py:390-588): per level a
    DownBlock, then (deepest first) PreQuantizationConditioning on the
    coarser quantization, the pre-q 'same' stack and the quantizer. The
    pre-q stack runs after the conditioning at embedding width ('encoder2'),
    or before it at the level's feature width (the legacy 'encoder')."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        nl, f = cfg.num_layers, cfg.stem_space_to_depth
        self.parse_input = Conv3D(cfg.input_channels * f ** 3, cfg.base_network_channels,
                                  1, dtype=cfg.dtype)
        downs, before = [], cfg.base_network_channels
        for i in range(cfg.n_enc):
            downs.append(DownBlock(before, cfg.level_n_down(i), cfg.n_post_downscale_blocks,
                                   nl, pad_mode=cfg.pad_mode, dtype=cfg.dtype,
                                   block_type=cfg.block_type))
            before *= 2 ** cfg.level_n_down(i)
        self.down = nn.ModuleList(downs)
        chans, emb = cfg.level_channels, cfg.embedding_dims
        self.pre_quantize_cond = nn.ModuleList(
            PreQuantizationConditioning(
                chans[i] + (emb[i] if i != cfg.n_enc - 1 else 0), emb[i],
                has_aux=i != cfg.n_enc - 1, n_up=cfg.n_blocks_per_bottleneck,
                n_post_upscale_blocks=cfg.n_post_upscale_blocks, num_layers=nl,
                pad_mode=cfg.pad_mode, dtype=cfg.dtype, block_type=cfg.block_type,
            )
            for i in range(cfg.n_enc)
        )
        pre_q_width = chans if cfg.encoder_variant == "encoder" else emb
        self.pre_quantize = nn.ModuleList(
            _same_stack(cfg.n_pre_quantization_blocks, pre_q_width[i], cfg)
            for i in range(cfg.n_enc)
        )
        self.quantize = nn.ModuleList(
            Quantizer(cfg.num_embeddings[i], emb[i], cfg.commitment_cost,
                      decay=cfg.ema_decay, laplace_alpha=cfg.laplace_alpha)
            for i in range(cfg.n_enc)
        )

    def forward(self, x, train: bool = False, whole_from: Optional[int] = None):
        """``whole_from``: the first level that runs whole under a space axis
        (``whole_levels``; found from x when None)."""
        cfg = self.cfg
        if whole_from is None:
            whole_from = whole_levels(cfg, x)
        x = self.parse_input(space_to_depth(x, cfg.stem_space_to_depth))
        downs = []
        for i, down in enumerate(self.down):
            if i == whole_from:
                x = mesh.gather_slabs(x)
            with _level(i, whole_from):
                x = down(x)
            downs.append(x)
        aux, results = None, []
        legacy = cfg.encoder_variant == "encoder"
        for i in reversed(range(cfg.n_enc)):
            with _level(i, whole_from):
                h = downs[i]
                if legacy:
                    h = apply_same_stack(h, self.pre_quantize[i], pad_mode=cfg.pad_mode,
                                         dtype=cfg.dtype)
                h = self.pre_quantize_cond[i](h, aux, whole_aux=i + 1 == whole_from)
                if not legacy:
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
                              nl, pad_mode=cfg.pad_mode, dtype=cfg.dtype,
                              block_type=cfg.block_type))
            ups.append(up)
        self.up = nn.ModuleList(ups)
        self.out = Conv3D(cfg.base_network_channels, cfg.head_channels * f ** 3, 1,
                          dtype=cfg.dtype)

    def forward(self, quantizations, train: bool = False, whole_from: Optional[int] = None):
        """``train`` changes nothing in the decoder (the JAX signature's flag).
        Under a space axis ``whole_from`` is the encoder's (``whole_levels``):
        the quantizations of the levels from it on are whole, the finer ones
        slabs, which their shapes alone do not tell apart."""
        cfg = self.cfg
        if whole_from is None:
            if halo.active():
                raise ValueError("decoding H slabs needs the first whole level (whole_from)")
            whole_from = cfg.n_enc
        out = None
        for i in reversed(range(cfg.n_enc)):
            with _level(i, whole_from):
                q = quantizations[i].to(cfg.dtype) if cfg.dtype else quantizations[i]
                h = self.proj[i](torch.cat([q, out], dim=1)) if i != cfg.n_enc - 1 else q
                *post, up = self.up[i]
                h = apply_same_stack(h, post, pad_mode=cfg.pad_mode, dtype=cfg.dtype)
                out = up(h)
            if i == whole_from:
                out = mesh.space_slab(out)
        return depth_to_space(self.out(out), cfg.stem_space_to_depth)


class VQVAE(nn.Module):
    """Encoder + decoder. ``forward`` returns
    (decoded, (losses, quantizations, indices)), per-level tuples fine -> coarse.

    Parameters are initialized on the CPU from ``generator`` (a fixed seed
    when None) with the reference's Fixup scheme, then moved to ``device``."""

    def __init__(self, config: VQVAEConfig, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
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
        whole_from = whole_levels(self.config, x)
        results = self.encode(x, train=train, whole_from=whole_from)
        losses, quantizations, indices = zip(*results)
        decoded = self.decode(quantizations, train=train, whole_from=whole_from)
        return decoded, (losses, quantizations, indices)

    def encode(self, x, train: bool = False, whole_from: Optional[int] = None):
        return self.encoder(x, train=train, whole_from=whole_from)

    def decode(self, quantizations, train: bool = False, whole_from: Optional[int] = None):
        return self.decoder(quantizations, train=train, whole_from=whole_from)

    def embed_code(self, level: int, indices: torch.Tensor) -> torch.Tensor:
        """(...,) int code grid -> (..., D) fp32 embeddings of that level."""
        return self.encoder.quantize[level].embed_code(indices)
