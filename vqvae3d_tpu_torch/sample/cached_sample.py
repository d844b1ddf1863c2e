"""Cached incremental ancestral sampling for PixelCNN: exact, O(V) conv work.

Counterpart of ``vqvae3d_tpu/sample/cached_sample.py``. The causal 3-stream
stack (depth → height → width) decomposes sampling into cached phases:

  * per slice i0, the incremental depth tower (``_depth_tower_slice``): the
    depth stream at slice i0 depends only on earlier slices, so one pass over
    the slice, fed by per-layer caches of the causal depth taps, gives every
    layer's depth→height and depth→width injections (d2h, d2w) and the depth
    stream's final slice;
  * per row i1, one ``ops.decode_row.row_decode`` call: the height-row step
    and the voxel chain with the Gumbel-argmax samples (kernel K6 on a card,
    its plain version on the CPU). The height v-row caches thread through the
    row loop.

The condition is precomputed once per grid: the coarse one-hot upsampled to
the grid, embedded, and projected per layer (the JAX sampler's order).
Sampled codes live in an int index grid; ``parse_input`` of a one-hot is the
row gather ``w_in[idx] + b_in`` (exact in fp32).

The JAX package's TPU runtime devices (the full-grid recompute form,
host-sliced executions, the XLA voxel loop and their switches) are not
ported. The row function hardcodes the k=3 height taps, so a
``kernel_size`` other than 3 raises ``NotImplementedError``. The sampler
computes in true fp32 (``fp32_exact``) and runs under ``inference_mode``.
Noise: a Gumbel table in raster order (s0, s1, s2, B, K), or one draw per
slice from a ``torch.Generator`` on the model's device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
from vqvae3d_tpu_torch.ops import decode_row
from vqvae3d_tpu_torch.ops.resize import trilinear_resize
from vqvae3d_tpu_torch.sample.ar_sample import (
    check_gumbel,
    draw_gumbel,
    fp32_exact,
    model_device,
)

STREAMS = ("depth_conv", "height_conv", "width_conv")


class _LayerParams:
    """fp32 view of one PreActFixupCausalResBlock's parameters."""

    def __init__(self, blk, is_first: bool):
        def f(t):
            return t.detach().float()

        self.s = {n: f(getattr(blk, f"bias{n}"))[0] for n in ("1a", "1b", "2a", "2b", "3a",
                                                              "3b", "4")}
        self.scale = f(blk.scale)[0]
        self.c1, self.c2, self.c3 = (
            {n: f(getattr(conv, n).weight) for n in STREAMS}
            for conv in (blk.branch_conv1, blk.branch_conv2, blk.branch_conv3))
        self.erf_d = (f(blk.expand_rf.depth_conv.weight), f(blk.expand_rf.depth_conv.bias))
        self.erf_h = (f(blk.expand_rf.height_conv.weight), f(blk.expand_rf.height_conv.bias))
        self.cond = None if blk.condition is None else (f(blk.condition.weight),
                                                         f(blk.condition.bias))
        self.skip, self.aux = ({n: (f(getattr(conv, n).weight), f(getattr(conv, n).bias))
                                for n in STREAMS} if conv is not None else None
                               for conv in (blk.skip_conv, blk.aux))
        self.is_first = is_first


def _extract_layers(model):
    return [_LayerParams(blk, i == 0) for i, blk in enumerate(model.layers)]


def _mm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 1x1x1 conv (O, I, 1, 1, 1) on a slice (B, I, s1, s2) or a row (B, I, s2)."""
    conv = F.conv2d if x.dim() == 4 else F.conv1d
    return conv(x, w.reshape(*w.shape[:2], *(1,) * (x.dim() - 2)), b)


def _stream_layer(lp, stream: str, x, shifted, at_start: bool, inj, cond, aux, vprev, half: int):
    """One PreActFixupCausalResBlock on a slice of the depth stream (B, C, s1,
    s2) or a row of the height stream (B, C, s2), its causal branch taps read
    from ``vprev`` (B, k-2, br, ...), the post-activation branch values of the
    k-2 earlier slices or rows.

    shifted: parse_input of the previous slice or row, the first layer's
    mask-'A' input (zeros when ``at_start``); inj: what the earlier stream adds
    after branch_conv1 (the height stream's d2h), or None; cond: the layer's
    projected condition, or None; aux: PixelSNAIL's attention output (out_proj
    only), or None. Returns (x', this stream's ExpandRF output (depth: d2h|d2w,
    height: h2w), vprev')."""
    if lp.is_first:
        u = F.elu(shifted + lp.s["1a"]) + lp.s["1b"]
        if at_start:
            u = torch.zeros_like(u)
    else:
        u = F.elu(x + lp.s["1a"]) + lp.s["1b"]
    t = _mm(u, lp.c1[stream])
    side = _mm(t, *(lp.erf_d if stream == "depth_conv" else lp.erf_h))
    if inj is not None:
        t = t + inj
    if aux is not None:
        t = t + _mm(F.elu(aux), *lp.aux[stream])
    v = F.elu(t + lp.s["2a"]) + lp.s["2b"]
    # the causal taps: depth (br, br, k-1, k, k), height (br, br, 1, k-1, k)
    conv, wk = (F.conv2d, lp.c2[stream]) if x.dim() == 4 else (F.conv1d, lp.c2[stream][:, :, 0])
    taps = torch.cat([vprev, v[:, None]], 1)  # (B, k-1, br, ...)
    b2 = conv(taps[:, 0], wk[:, :, 0], padding=half)
    for ti in range(1, wk.shape[2]):
        b2 = b2 + conv(taps[:, ti], wk[:, :, ti], padding=half)
    if cond is not None:
        b2 = b2 + cond
    w3 = F.elu(b2 + lp.s["3a"]) + lp.s["3b"]
    out = _mm(w3, lp.c3[stream]) * lp.scale + lp.s["4"]
    if lp.skip is None:
        return out + x, side, taps[:, 1:]
    sk_in = (torch.zeros_like(shifted) if at_start else shifted) if lp.is_first else x
    return out + _mm(sk_in, *lp.skip[stream]), side, taps[:, 1:]


def _depth_tower_slice(layers, b_in, sprev_emb, i0: int, cond_sl, dvc, half: int):
    """Slice i0 of the depth stream from per-layer causal-tap caches.

    sprev_emb: parse_input of slice i0-1, (B, C, s1, s2) (unused at i0 = 0);
    cond_sl: per layer (B, br, s1, s2), or None; dvc: per layer the post-
    activation branch values of the previous k-2 slices, (B, k-2, br, s1, s2).
    Returns (d2h [L], d2w [L], d_final (B, C, s1, s2), dvc')."""
    b, _, s1, s2 = sprev_emb.shape
    d = b_in.view(1, -1, 1, 1).expand(b, -1, s1, s2)
    d2h_all, d2w_all, new_dvc = [], [], list(dvc)
    for li, lp in enumerate(layers):
        d, erf, new_dvc[li] = _stream_layer(lp, "depth_conv", d, sprev_emb, i0 == 0, None,
                                            None if cond_sl is None else cond_sl[li], None,
                                            dvc[li], half)
        d2h, d2w = erf.chunk(2, dim=1)
        d2h_all.append(d2h)
        d2w_all.append(d2w)
    return d2h_all, d2w_all, d, new_dvc


def layer_conditions(model, layers, condition_idx, dims, dev):
    """Each causal layer's projected condition over the grid, (L, B, br, s0,
    s1, s2), computed once a grid: the coarse one-hot upsampled to ``dims``,
    embedded, then projected per layer (the JAX sampler's order); None for an
    unconditioned prior."""
    cfg = model.config
    if not cfg.use_conditioning:
        if condition_idx is not None:
            raise ValueError("an unconditioned prior takes no condition_idx")
        return None
    if condition_idx is None:
        raise ValueError("a conditioned prior needs condition_idx")
    one_hot = idx_to_one_hot(condition_idx.to(dev), cfg.condition_dim)
    cond_emb = F.conv3d(trilinear_resize(one_hot, dims),
                        model.embed_condition.weight.detach().float(),
                        model.embed_condition.bias.detach().float())
    return torch.stack([F.conv3d(cond_emb, *lp.cond) for lp in layers])


def _rows(per_layer) -> torch.Tensor:
    """Per-layer (B, X, s1, s2) slices -> (s1, L, B, s2, X), each row contiguous."""
    return torch.stack(per_layer).permute(3, 0, 1, 4, 2).contiguous()


@torch.inference_mode()
def cached_ancestral_sample(
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
    """Sample (batch_size, *dims) int32 code grids from a PixelCNN prior.

    ``forced`` (B, *dims) int teacher-forces every voxel: the sampler then
    returns (forced grid, logits (B, K, *dims)), the exactness check against
    the one-shot forward."""
    cfg = model.config
    if cfg.kernel_size != 3:
        raise NotImplementedError("the cached sampler's row step hardcodes kernel_size=3")
    if not cfg.use_pre_activation or cfg.use_concat_activation:
        raise NotImplementedError("cached sampling supports the PreActFixupCausalResBlock "
                                  "PixelCNN only")
    dev = model_device(model)
    s0, s1, s2 = dims
    b, k = batch_size, cfg.input_dim
    half = cfg.kernel_size // 2
    check_gumbel(gumbel, dims, b, k)

    with fp32_exact():
        layers = _extract_layers(model)
        n_layers = len(layers)
        w_in, b_in = model.parse_input.weight.detach(), model.parse_input.bias.detach().float()
        st = decode_row.stack_row_weights(layers, w_in, b_in, model.parse_output.weight.detach(),
                                          model.parse_output.bias.detach())
        emb = st["w_in"] + b_in  # parse_input of each one-hot code, (K, C)
        c = emb.shape[1]
        br = st["w1"].shape[-1]

        cond_full = layer_conditions(model, layers, condition_idx, dims, dev)

        x = torch.zeros(b, s0, s1, s2, dtype=torch.int64, device=dev)
        logits_out = None
        if forced is not None:
            x = forced.to(device=dev, dtype=torch.int64).clone()
            logits_out = torch.empty(s0, s1, b, s2, k, device=dev)
        dvc = [torch.zeros(b, lp.c2["depth_conv"].shape[2] - 1, br, s1, s2, device=dev)
               for lp in layers]
        zeros_row = torch.zeros(b, s2, c, device=dev)
        for i0 in range(s0):
            sprev = (F.embedding(x[:, i0 - 1].clamp(min=0), emb).permute(0, 3, 1, 2) if i0 > 0
                     else torch.zeros(b, c, s1, s2, device=dev))
            cond_sl = None if cond_full is None else cond_full[:, :, :, i0].unbind(0)
            d2h, d2w, dfin, dvc = _depth_tower_slice(layers, b_in, sprev, i0, cond_sl, dvc,
                                                     half)
            d2h_rows, d2w_rows = _rows(d2h), _rows(d2w)
            cnd_rows = None if cond_sl is None else _rows(cond_sl)
            dfin_rows = dfin.permute(2, 0, 3, 1).contiguous()  # (s1, B, s2, C)
            gum = (gumbel[i0].to(dev, torch.float32).contiguous() if gumbel is not None
                   else draw_gumbel((s1, s2, b, k), generator, dev))
            vhc = torch.zeros(n_layers, b, s2, br, device=dev)
            for i1 in range(s1):
                sprev_row = (F.embedding(x[:, i0, i1 - 1].clamp(min=0), emb) if i1 > 0
                             else zeros_row)
                res = decode_row.row_decode(
                    st, d2h_rows[i1], d2w_rows[i1], None if cnd_rows is None else cnd_rows[i1],
                    dfin_rows[i1], sprev_row, vhc, gum[i1], i1, tau,
                    forced_idx=None if forced is None else x[:, i0, i1],
                )
                if forced is None:
                    x[:, i0, i1] = res[0]
                else:
                    logits_out[i0, i1] = res[2]
    if forced is not None:
        return x.to(torch.int32), logits_out.permute(2, 4, 0, 1, 3)
    if int(x.min()) < 0:  # row_decode marks a voxel with non-finite logits -1
        raise FloatingPointError(f"cached sampling: {int((x < 0).sum())} voxels had "
                                 "non-finite logits")
    return x.to(torch.int32)


def make_cached_sampler(model, dims: Tuple[int, int, int], batch_size: int, tau: float = 1.0):
    """``sampler(condition_idx=None, *, generator=None, gumbel=None)`` ->
    (batch_size, *dims) int32 grids (``cached_ancestral_sample``)."""

    def sampler(condition_idx=None, *, generator=None, gumbel=None):
        return cached_ancestral_sample(model, dims, batch_size, condition_idx, tau,
                                       gumbel=gumbel, generator=generator)

    return sampler
