"""Cached incremental ancestral sampling for PixelSNAIL: appended K/V, exact.

Counterpart of ``vqvae3d_tpu/sample/cached_snail.py`` (its incremental
form). The PixelCNN sampler's decomposition (``cached_sample.py``) survives
the attention blocks because each stream's values, and so its attention keys
and values, become final at a granularity of their own:

  * depth: slice i0's values depend on the earlier slices only. One pass per
    slice (``_depth_step``), fed by per-layer caches of the causal depth taps,
    gives every layer's depth→height and depth→width injections (d2h, d2w),
    the depth stream's final slice, and the slice's depth K/V;
  * height: row (i0, i1)'s values depend on the earlier slices and rows. One
    pass per row (``_height_step``), fed by the d2h injections and per-layer
    caches of the causal height taps, gives the h2w injections, the height
    stream's final row, and the row's height K/V;
  * width: one step per voxel (``_width_step``) through every layer's width
    stream, fed by d2w + h2w and a one-voxel tap cache a layer, appends the
    voxel's width K/V and gives its logits.

Attention keeps the reference's swapped roles, as the one-shot model does
(``models/causal_blocks.py::CausalAttentionPixelBlock``): the query at a
position comes from the keys-half of ``key_value_proj(stack, out,
background)``, the attended keys from ``query_proj(out, background)``, the
values from the values-half of ``key_value_proj``. Each stream attends only
within its own keys and values. Per stream and block one cache (B, nh, V,
2·dh) holds each head's keys and values side by side; a step writes its
positions' entries, then its queries attend the valid prefix, with a causal
mask only inside the step's own slice or row. One projection a block and
stream gives the queries, keys and values together (``_BlockAttention``; the
query side pre-scaled by dh^-0.5).

The condition is precomputed once per grid (``cached_sample.layer_conditions``).
Sampled codes live in an int index grid; ``parse_input`` of a code is the row
gather ``w_in[idx] + b_in``. The sampler computes in true fp32 (``fp32_exact``)
under ``inference_mode`` on the model's device, with plain PyTorch ops (the
JAX sampler reaches no Pallas kernel). Noise: a Gumbel table in raster order
(s0, s1, s2, B, K), or one draw per slice from a ``torch.Generator`` on the
model's device.

Not ported: the JAX sampler's full-recompute form (``VQVAE3D_SNAIL_INC=0``)
and its host-sliced executions, TPU runtime devices. The incremental depth step
reads exactly two depth taps, so a ``kernel_size`` other than 3 raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.models.prior_utils import generate_background
from vqvae3d_tpu_torch.sample.ar_sample import (
    check_gumbel,
    draw_gumbel,
    fp32_exact,
    gumbel_argmax,
    model_device,
)
from vqvae3d_tpu_torch.sample.cached_sample import (
    STREAMS,
    _LayerParams,
    _stream_layer,
    layer_conditions,
)


def _flat(w: torch.Tensor) -> torch.Tensor:
    """A 1x1x1 conv's weight (O, I, 1, 1, 1) as (O, I)."""
    return w.reshape(w.shape[:2])


class _WidthLayer:
    """One layer's width-stream weights as matrices for ``torch.addmm``, the
    scalar biases after each product folded into a bias vector: ``inj_bias``
    (what t adds besides d2w + h2w: s2a, aux's bias, and s1b through
    branch_conv1 but in to_causal, whose input is zero at a row's first
    voxel), ``tap_bias`` (what b2 adds besides the condition: s3a, and s2b
    through this voxel's tap), ``prev_bias`` (s2b through the previous
    voxel's tap, none at a row's first) and ``bias3`` (s4, s3b through
    branch_conv3, and to_causal's skip bias)."""

    def __init__(self, lp: _LayerParams):
        s = lp.s
        self.is_first = lp.is_first
        self.s1a, self.s1b = s["1a"], s["1b"]
        self.w1 = _flat(lp.c1["width_conv"]).t()
        wk = lp.c2["width_conv"][:, :, 0, 0]  # (br, br, 2): the previous voxel, this one
        self.w2_prev, self.w2 = wk[..., 0].t(), wk[..., 1].t()
        self.w3 = (_flat(lp.c3["width_conv"]) * lp.scale).t()
        self.aux = None if lp.aux is None else _flat(lp.aux["width_conv"][0]).t()
        self.inj_bias = s["2a"] + torch.zeros_like(self.w2[0])
        if lp.aux is not None:
            self.inj_bias = self.inj_bias + lp.aux["width_conv"][1]
        if not lp.is_first:
            self.inj_bias = self.inj_bias + s["1b"] * self.w1.sum(0)
        self.tap_bias = s["3a"] + s["2b"] * self.w2.sum(0)
        self.prev_bias = s["2b"] * self.w2_prev.sum(0)
        self.bias3 = s["4"] + s["3b"] * self.w3.sum(0)
        self.skip = None
        if lp.skip is not None:  # to_causal's mask-'A' skip
            w, b = lp.skip["width_conv"]
            self.skip = _flat(w).t()
            self.bias3 = self.bias3 + b


class _BlockAttention:
    """One CausalAttentionPixelBlock's projections, per stream one (3·br,
    2C + 3) matrix over [stack | out | background]: rows [0, br) the queries
    (key_value_proj's keys-half, times dh^-0.5), then per head its dh keys
    (query_proj, zero over the stack) and dh values (key_value_proj's
    values-half), so a step's keys and values go to the cache in one copy."""

    def __init__(self, blk, index: int, first: int, out: int, c: int, br: int, nh: int):
        self.index = index  # the block's place, its caches' index
        self.first, self.out = first, out  # flat indices of its first layer and out_proj
        dh = br // nh
        self.proj = {}
        for stream in STREAMS:
            kv, q = getattr(blk.key_value_proj, stream), getattr(blk.query_proj, stream)
            kv_w, kv_b = _flat(kv.weight.detach().float()), kv.bias.detach().float()
            q_w, q_b = _flat(q.weight.detach().float()), q.bias.detach().float()
            k_w = torch.cat([torch.zeros(br, c, device=q_w.device), q_w], 1)
            w = torch.cat([kv_w[:br] * dh**-0.5,
                           torch.stack([k_w.view(nh, dh, -1), kv_w[br:].view(nh, dh, -1)],
                                       1).reshape(2 * br, -1)])
            b = torch.cat([kv_b[:br] * dh**-0.5,
                           torch.stack([q_b.view(nh, dh), kv_b[br:].view(nh, dh)], 1).flatten()])
            self.proj[stream] = (w, b)
        w = self.proj["width_conv"][0]  # the width step's, by input: stack, out, background
        self.width_stack, self.width_out = w[:, :c].t(), w[:, c:2 * c].t()


class _Program:
    """The prior's causal layers in the flat order of the JAX ``_Program``
    (to_causal, then per block its causal layers and out_proj) and its
    attention blocks."""

    def __init__(self, model):
        cfg = model.config
        c, self.nh = cfg.model_dim, cfg.num_heads
        self.br = c // cfg.bottleneck_divisor
        self.half = cfg.kernel_size // 2
        self.b_in = model.parse_input.bias.detach().float()
        self.emb = _flat(model.parse_input.weight.detach().float()).t() + self.b_in  # (K, C)
        self.w_out = _flat(model.parse_output.weight.detach().float()).t()
        self.b_out = model.parse_output.bias.detach().float()
        self.layers = [_LayerParams(model.to_causal, True)]
        self.blocks = []
        for blk in model.layers:
            first = len(self.layers)
            self.layers += [_LayerParams(lp, False) for lp in blk.causal_layers]
            self.layers.append(_LayerParams(blk.out_proj, False))
            self.blocks.append(_BlockAttention(blk, len(self.blocks), first,
                                               len(self.layers) - 1, c, self.br, self.nh))
        self.width = [_WidthLayer(lp) for lp in self.layers]
        self.width_inj_bias, self.width_tap_bias, self.width_prev_bias = (
            torch.stack([getattr(lw, n) for lw in self.width])
            for n in ("inj_bias", "tap_bias", "prev_bias"))
        # every block's width projection of the background, and its bias
        self.width_bg = torch.cat([blk.proj["width_conv"][0][:, 2 * c:] for blk in self.blocks])
        self.width_bg_bias = torch.cat([blk.proj["width_conv"][1] for blk in self.blocks])


def _tower(prog: _Program, x, layer, attend):
    """x through one stream of every layer: ``layer(li, x, aux)`` -> x and
    ``attend(block, stack, out)`` -> the block's attention output, where stack
    is the block's input and out its causal layers' output."""
    x = layer(0, x, None)
    for blk in prog.blocks:
        stack = x
        for li in range(blk.first, blk.out):
            x = layer(li, x, None)
        x = layer(blk.out, x, attend(blk, stack, x))
    return x


def _attend(proj, cache, off: int, nh: int, mask):
    """proj (B, n, 3·br): the queries, keys and values of the n raster
    positions [off, off + n). Their keys and values go into ``cache`` (B, nh,
    V, 2·dh) at ``off``; each query attends the keys [0, off + n) up to its
    own position (``mask``: the (n, n) strict upper triangle, None for n = 1).
    Returns (B, n, br)."""
    b, n, br3 = proj.shape
    br = br3 // 3
    dh = br // nh
    end = off + n
    cache[:, :, off:end] = proj[..., br:].view(b, n, nh, 2 * dh).transpose(1, 2)
    q = proj[..., :br].view(b, n, nh, dh).transpose(1, 2)
    logits = q @ cache[:, :, :end, :dh].transpose(-1, -2)  # (B, nh, n, end)
    if mask is not None:
        logits[..., off:].masked_fill_(mask, float("-inf"))
    o = torch.softmax(logits, -1) @ cache[:, :, :end, dh:]  # (B, nh, n, dh)
    return o.transpose(1, 2).reshape(b, n, br)


def _block_attention(blk: _BlockAttention, stream: str, stack, out, bg, cache, off: int,
                     nh: int, mask):
    """A slice (B, C, s1, s2) or a row (B, C, s2) of one stream's attention
    (its keys and values appended at ``off``); returns (B, br, ...)."""
    xin = torch.cat([stack, out, bg], 1)
    proj = F.linear(xin.flatten(2).transpose(1, 2), *blk.proj[stream])
    o = _attend(proj, cache, off, nh, mask)
    return o.transpose(1, 2).reshape(o.shape[0], -1, *xin.shape[2:])


def _depth_step(prog: _Program, sprev, at_start: bool, bg, cond, dvc, kv, off: int, mask):
    """Slice i0 of the depth stream. sprev: parse_input of slice i0-1 (B, C,
    s1, s2); bg: (B, 3, s1, s2); cond: per layer (B, br, s1, s2) or None; dvc:
    per layer the depth taps of slice i0-1 (B, 1, br, s1, s2); kv: per block
    the depth caches, written at ``off`` = i0·s1·s2. dvc is updated in place.
    Returns (d2h|d2w per layer (B, 2·br, s1, s2), the final depth slice)."""
    b, _, s1, s2 = sprev.shape
    erf = [None] * len(prog.layers)

    def layer(li, d, aux):
        d, erf[li], dvc[li] = _stream_layer(prog.layers[li], "depth_conv", d, sprev, at_start,
                                            None, None if cond is None else cond[li], aux,
                                            dvc[li], prog.half)
        return d

    def attend(blk, stack, out):
        return _block_attention(blk, "depth_conv", stack, out, bg, kv[blk.index], off,
                                prog.nh, mask)

    d = _tower(prog, prog.b_in.view(1, -1, 1, 1).expand(b, -1, s1, s2), layer, attend)
    return erf, d


def _height_step(prog: _Program, rprev, at_start: bool, d2h, bg, cond, hvc, kv, off: int,
                 mask):
    """Row (i0, i1) of the height stream: rprev, parse_input of row i1-1 (B,
    C, s2); d2h and cond per layer (B, br, s2) (cond None when unconditioned);
    bg (B, 3, s2); hvc: per layer the height taps of row i1-1 (B, 1, br, s2),
    updated in place; kv: per block the height caches, written at ``off``.
    Returns (h2w per layer (B, br, s2), the final height row)."""
    b, _, s2 = rprev.shape
    h2w = [None] * len(prog.layers)

    def layer(li, h, aux):
        h, h2w[li], hvc[li] = _stream_layer(prog.layers[li], "height_conv", h, rprev, at_start,
                                            d2h[li], None if cond is None else cond[li], aux,
                                            hvc[li], prog.half)
        return h

    def attend(blk, stack, out):
        return _block_attention(blk, "height_conv", stack, out, bg, kv[blk.index], off,
                                prog.nh, mask)

    h = _tower(prog, prog.b_in.view(1, -1, 1).expand(b, -1, s2), layer, attend)
    return h2w, h


def _width_step(prog: _Program, s_prev, inj, c3, proj, vprev, kv, pos: int):
    """Voxel ``pos``'s width stream through every layer. s_prev: parse_input of
    the previous voxel (B, C), None at the row's first voxel; inj: per layer
    (B, br) d2w + h2w + the layer's ``inj_bias``; c3: per layer (B, br) the
    condition + ``tap_bias`` (+ ``prev_bias`` but at the row's first voxel);
    proj: per block (B, 3·br) the projection of the background and its bias;
    inj, c3 and proj are this voxel's scratch, the products accumulate into
    them. vprev: per layer the previous voxel's elu(t) (None at the row's
    first), updated in place; kv: per block the width caches, written at
    ``pos``. Returns the width stream's output (B, C)."""

    def layer(li, w, aux):
        lw = prog.width[li]
        t = inj[li]
        if not lw.is_first:
            t.addmm_(F.elu(w + lw.s1a), lw.w1)
        elif s_prev is not None:  # mask 'A': the previous voxel's embedding, zeros at the first
            t.addmm_(F.elu(s_prev + lw.s1a).add_(lw.s1b), lw.w1)
        if aux is not None:
            t.addmm_(F.elu(aux), lw.aux)
        v = F.elu(t)
        b2 = c3[li]
        if vprev[li] is not None:
            b2.addmm_(vprev[li], lw.w2_prev)
        vprev[li] = v
        w3 = F.elu(b2.addmm_(v, lw.w2))
        if lw.skip is None:
            return (w + lw.bias3).addmm_(w3, lw.w3)
        out = torch.addmm(lw.bias3, w3, lw.w3)
        return out if s_prev is None else out.addmm_(s_prev, lw.skip)

    def attend(blk, stack, out):
        p = proj[blk.index].addmm_(stack, blk.width_stack).addmm_(out, blk.width_out)
        return _attend(p[:, None], kv[blk.index], pos, prog.nh, None)[:, 0]

    return _tower(prog, None, layer, attend)


@torch.inference_mode()
def cached_snail_sample(
    model,
    dims: Tuple[int, int, int],
    batch_size: int,
    condition_idx: Optional[torch.Tensor] = None,
    tau: float = 1.0,
    *,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    forced: Optional[torch.Tensor] = None,
):
    """Sample (batch_size, *dims) int32 code grids from a PixelSNAIL prior.

    ``forced`` (B, n, s1, s2) int, n <= s0, teacher-forces the grid's first n
    slices (every voxel when n = s0): the sampler then returns (forced,
    logits (B, K, n, s1, s2)), the exactness check against the one-shot
    forward."""
    cfg = model.config
    if cfg.kernel_size != 3:
        raise NotImplementedError("the cached PixelSNAIL sampler's depth step reads two depth "
                                  "taps: kernel_size=3 only")
    dev = model_device(model)
    s0, s1, s2 = dims
    b, k = batch_size, cfg.input_dim
    sv = s1 * s2
    check_gumbel(gumbel, dims, b, k)

    with fp32_exact():
        prog = _Program(model)
        c, br, nh, n_layers = cfg.model_dim, prog.br, prog.nh, len(prog.layers)
        cond_full = layer_conditions(model, prog.layers, condition_idx, dims, dev)
        bg = generate_background(b, dims, dev)
        caches = {stream: [torch.zeros(b, nh, s0 * sv, 2 * (br // nh), device=dev)
                           for _ in prog.blocks] for stream in STREAMS}
        masks = [torch.ones(n, n, dtype=torch.bool, device=dev).triu(1) for n in (sv, s2)]
        dvc = [torch.zeros(b, 1, br, s1, s2, device=dev) for _ in range(n_layers)]
        x = torch.zeros(b, s0, s1, s2, dtype=torch.int64, device=dev)
        n0 = s0
        if forced is not None:
            n0 = forced.shape[1]
            if forced.shape[0] != b or n0 > s0 or tuple(forced.shape[2:]) != (s1, s2):
                raise ValueError(f"forced {tuple(forced.shape)}: not the first slices of "
                                 f"{(b, *dims)}")
            x[:, :n0] = forced.to(dev)
            logits_out = torch.empty(n0, s1, s2, b, k, device=dev)
        else:
            logits_row = torch.empty(s2, b, k, device=dev)
            nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        zeros_row = torch.zeros(b, c, s2, device=dev)
        not_first = (torch.arange(s2, device=dev) > 0).float()
        for i0 in range(n0):
            sprev = (F.embedding(x[:, i0 - 1], prog.emb).permute(0, 3, 1, 2) if i0 > 0
                     else torch.zeros(b, c, s1, s2, device=dev))
            cond_sl = None if cond_full is None else cond_full[:, :, :, i0]
            erf, d_fin = _depth_step(prog, sprev, i0 == 0, bg[:, :, i0], cond_sl, dvc,
                                     caches["depth_conv"], i0 * sv, masks[0])
            d2h, d2w = zip(*(e.chunk(2, 1) for e in erf))
            # per row and voxel (s1, s2, L, B, br): d2w + the width's injection
            # bias, and the width's tap bias (+ the condition)
            d2w_rows = (torch.stack(d2w) + prog.width_inj_bias[:, None, :, None, None]
                        ).permute(3, 4, 0, 1, 2).contiguous()
            c3_slice = prog.width_tap_bias + prog.width_prev_bias * not_first[:, None, None]
            c3_slice = c3_slice[None, :, :, None].expand(s1, s2, n_layers, b, br)
            if cond_sl is not None:
                c3_slice = c3_slice + cond_sl.permute(3, 4, 0, 1, 2)
            gum = (gumbel[i0].to(dev, torch.float32) if gumbel is not None
                   else draw_gumbel((s1, s2, b, k), generator, dev))
            hvc = [torch.zeros(b, 1, br, s2, device=dev) for _ in range(n_layers)]
            for i1 in range(s1):
                off = i0 * sv + i1 * s2
                rprev = (F.embedding(x[:, i0, i1 - 1], prog.emb).transpose(1, 2) if i1 > 0
                         else zeros_row)
                h2w, h_fin = _height_step(
                    prog, rprev, i1 == 0, [a[:, :, i1] for a in d2h], bg[:, :, i0, i1],
                    None if cond_sl is None else cond_sl[:, :, :, i1], hvc,
                    caches["height_conv"], off, masks[1])
                inj = d2w_rows[i1] + torch.stack(h2w).permute(3, 0, 1, 2)  # (s2, L, B, br)
                c3 = c3_slice[i1].contiguous()  # (s2, L, B, br): this row's scratch
                proj = F.linear(bg[:, :, i0, i1].permute(2, 0, 1), prog.width_bg,
                                prog.width_bg_bias)  # (s2, B, nb·3·br)
                proj = proj.view(s2, b, len(prog.blocks), -1).transpose(1, 2).contiguous()
                # the logits' depth and height terms: each voxel adds its width's
                lg_row = logits_row if forced is None else logits_out[i0, i1]  # (s2, B, K)
                torch.addmm(prog.b_out, (d_fin[:, :, i1] + h_fin).permute(2, 0, 1).flatten(0, 1),
                            prog.w_out, out=lg_row.view(s2 * b, k))
                vprev = [None] * n_layers
                s_prev = None
                for i2 in range(s2):
                    w = _width_step(prog, s_prev, inj[i2].unbind(0), c3[i2].unbind(0),
                                    proj[i2].unbind(0), vprev, caches["width_conv"], off + i2)
                    logits = lg_row[i2].addmm_(w, prog.w_out)
                    if forced is None:
                        x[:, i0, i1, i2] = gumbel_argmax(logits, gum[i1, i2], tau)
                    s_prev = F.embedding(x[:, i0, i1, i2], prog.emb)
                if forced is None:
                    nonfinite += (~torch.isfinite(logits_row)).any(-1).sum()
    if forced is not None:
        return x[:, :n0].to(torch.int32), logits_out.permute(3, 4, 0, 1, 2)
    if int(nonfinite):
        raise FloatingPointError(f"cached PixelSNAIL sampling: {int(nonfinite)} voxels had "
                                 "non-finite logits")
    return x.to(torch.int32)


def make_cached_snail_sampler(model, dims: Tuple[int, int, int], batch_size: int,
                              tau: float = 1.0):
    """``sampler(condition_idx=None, *, generator=None, gumbel=None)`` ->
    (batch_size, *dims) int32 grids (``cached_snail_sample``)."""

    def sampler(condition_idx=None, *, generator=None, gumbel=None):
        return cached_snail_sample(model, dims, batch_size, condition_idx, tau,
                                   gumbel=gumbel, generator=generator)

    return sampler
