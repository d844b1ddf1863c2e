"""Cached incremental ancestral sampling for PixelCNN: exact, O(V) conv work.

Counterpart of ``vqvae3d_tpu/sample/cached_sample.py``. The causal 3-stream
stack (depth → height → width) decomposes sampling into cached phases:

  * per slice i0, the incremental depth tower (``_depth_tower_slice``): the
    depth stream at slice i0 depends only on earlier slices, so one pass over
    the slice, fed by per-layer caches of the causal depth taps, gives every
    layer's depth→height and depth→width injections (d2h, d2w) and the depth
    stream's final slice;
  * per row i1, at ``kernel_size`` 3, one ``ops.decode_row.row_decode``
    call: the height-row step and the voxel chain with the Gumbel-argmax
    samples (kernel K6 on a card, its plain version on the CPU). The height
    v-row caches thread through the row loop. At any other odd
    ``kernel_size`` the row runs here, as the JAX sampler's XLA row body
    (``_height_tower``, ``_width_step``, ``row_body``) with no kernel, as in
    JAX (its Pallas row kernel takes k = 3 only): ``_height_row`` (the
    height stream's row from caches of the k − 2 earlier rows a layer), then
    ``_width_row`` (the voxel chain, caches of k // 2 voxels a layer), the
    two held by ``AnyKRowStep``, which replays them as CUDA graphs on a card.
    The route is chosen from ``kernel_size`` before any launch.

The condition is precomputed once per grid: the coarse one-hot upsampled to
the grid, embedded, and projected per layer (the JAX sampler's order).
Sampled codes live in an int index grid; ``parse_input`` of a one-hot is the
row gather ``w_in[idx] + b_in`` (exact in fp32).

The JAX package's TPU runtime devices (the full-grid recompute form,
host-sliced executions and their switches) are not ported. As in JAX, the
sampler takes the pre-activation PixelCNN only: a Fixup or concat-activation
model raises ``ValueError`` (``--sampler naive`` samples them). The sampler
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


def _height_row(layers, b_in, sprev_row, first: bool, d2h_row, cnd_row, hvc, half: int):
    """A row of the height stream at any odd kernel size (the JAX
    ``_height_tower`` restricted to one row), rows (B, X, s2).

    sprev_row: parse_input of the row before (unread for a slice's
    ``first`` row, whose mask-'A' input is the zero pad); d2h_row, cnd_row:
    per layer (B, br, s2) (cnd_row None when unconditioned); hvc: per layer
    the post-activation branch values of the k-2 earlier rows, (B, k-2, br,
    s2). Returns (h2w [L], the height stream's final row (B, C, s2), hvc')."""
    b, _, s2 = sprev_row.shape
    h = b_in.view(1, -1, 1).expand(b, -1, s2)
    h2w_all, new_hvc = [], list(hvc)
    for li, lp in enumerate(layers):
        h, h2w, new_hvc[li] = _stream_layer(lp, "height_conv", h, sprev_row, first, d2h_row[li],
                                            None if cnd_row is None else cnd_row[li], None,
                                            hvc[li], half)
        h2w_all.append(h2w)
    return h2w_all, h, new_hvc


class AnyKRowStep:
    """One row at a kernel size other than 3: ``_height_row`` then
    ``_width_row``, on fixed buffers that each row's inputs are copied into,
    the height caches held across the rows of a slice (``hvc``, zeroed at
    each slice). On a card each of its two variants (a slice's first row,
    whose mask-'A' input is the zero pad, and the others) is captured once as
    a CUDA graph and replayed a row: the row is ~18 small operations a
    layer-step, whose host launch cost a replay takes off, as the JAX sampler
    compiles the same row body with XLA. On the CPU it runs eagerly. The
    outputs (indices, or indices and logits when forced) are the graph's own
    tensors: copy them out before the next row."""

    def __init__(self, layers, chain: dict, b_in, emb, w_out, b_out, batch: int, s2: int,
                 cond: bool, forced: bool, tau: float, half: int):
        dev = emb.device
        n, br, k = len(layers), layers[0].c1["width_conv"].shape[0], w_out.shape[1]
        c, rows = emb.shape[1], layers[0].c2["height_conv"].shape[3]  # k - 1 tap rows
        self.layers, self.chain, self.b_in, self.emb = layers, chain, b_in, emb
        self.w_out, self.b_out, self.tau, self.half = w_out, b_out, tau, half

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(*shape, dtype=dtype, device=dev)

        self.buf = dict(sprev=zeros(batch, c, s2), d2h=zeros(n, batch, br, s2),
                        d2w=zeros(n, batch, br, s2), dfin=zeros(batch, c, s2),
                        gum=zeros(s2, batch, k))
        if cond:
            self.buf["cnd"] = zeros(n, batch, br, s2)
        if forced:
            self.buf["forced"] = zeros(batch, s2, dtype=torch.int64)
        self.hvc = zeros(n, batch, rows - 1, br, s2)
        self.graphs = {} if dev.type == "cuda" else None

    def _run(self, first: bool):
        buf = self.buf
        cnd = buf.get("cnd")
        h2w, hfin, hvc = _height_row(self.layers, self.b_in, buf["sprev"], first,
                                     buf["d2h"].unbind(0), None if cnd is None else cnd.unbind(0),
                                     self.hvc.unbind(0), self.half)
        self.hvc.copy_(torch.stack(hvc))
        return _width_row(self.chain, self.emb, self.w_out, self.b_out,
                          (buf["d2w"] + torch.stack(h2w)).transpose(2, 3),
                          None if cnd is None else cnd.transpose(2, 3),
                          (buf["dfin"] + hfin).transpose(1, 2), buf["gum"], self.tau,
                          forced_idx=buf.get("forced"))

    def _capture(self, first: bool):
        saved = self.hvc.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up: library handles, workspaces
            self._run(first)
        torch.cuda.current_stream().wait_stream(side)
        self.hvc.copy_(saved)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._run(first)
        return graph, out

    def __call__(self, first: bool, **row):
        for name, t in row.items():
            self.buf[name].copy_(t)
        if self.graphs is None:
            return self._run(first)
        if first not in self.graphs:
            self.graphs[first] = self._capture(first)
        graph, out = self.graphs[first]
        graph.replay()
        return out


def _width_chain_weights(layers) -> dict:
    """The voxel chain's per-layer operands of ``_width_row``, prepared once
    a grid: the 1x1x1 convs as (I, O) matrices, the width conv's taps as one
    (ws·br, br) matrix (tap-major, as the cache), the eight scalars (1a … 4,
    scale) as floats, layer 0's skip conv (mask 'A' always has one)."""
    br = layers[0].c1["width_conv"].shape[0]
    return dict(
        w1=[lp.c1["width_conv"][:, :, 0, 0, 0].t() for lp in layers],
        # (br, br, 1, 1, ws) -> (ws·br, br)
        wk=[lp.c2["width_conv"][:, :, 0, 0].permute(2, 1, 0).reshape(-1, br).contiguous()
            for lp in layers],
        w3=[lp.c3["width_conv"][:, :, 0, 0, 0].t() for lp in layers],
        sc=[[float(lp.s[n]) for n in ("1a", "1b", "2a", "2b", "3a", "3b", "4")]
            + [float(lp.scale)] for lp in layers],
        skw=layers[0].skip["width_conv"][0][:, :, 0, 0, 0].t(),
        skb=layers[0].skip["width_conv"][1],
    )


def _width_row(ch: dict, emb, w_out, b_out, side, cnd_row, dh_row, gumbel, tau: float,
               forced_idx: Optional[torch.Tensor] = None):
    """The voxel chain of one row at any odd kernel size (the JAX
    ``_width_step`` a voxel, then the logits and the sample), vectors (B, X).

    ch: ``_width_chain_weights``; emb (K, C): parse_input of each code;
    w_out (C, K), b_out (K,): parse_output; side (L, B, s2, br): d2w + h2w;
    cnd_row (L, B, s2, br) or None; dh_row (B, s2, C): the depth and height
    streams' final row; gumbel (s2, B, K). Returns (B, s2) indices, and the
    (B, s2, K) logits when ``forced_idx`` (B, s2) teacher-forces the row. A
    voxel whose logits are not all finite gets index -1."""
    n, b, s2, br = side.shape
    dev = side.device
    vc = [torch.zeros(b, w.shape[0] // br - 1, br, device=dev) for w in ch["wk"]]
    s_prev = torch.zeros(b, emb.shape[1], device=dev)
    idx_all = torch.empty(b, s2, dtype=torch.int64, device=dev)
    logits_all = []
    for i2 in range(s2):
        for li in range(n):
            a = ch["sc"][li]
            if li == 0:  # mask 'A': the previous voxel, and its 0 pad at i2 = 0
                u = (torch.zeros_like(s_prev) if i2 == 0 else F.elu(s_prev + a[0]) + a[1])
            else:
                u = F.elu(w + a[0]) + a[1]
            v = F.elu(u @ ch["w1"][li] + side[li, :, i2] + a[2]) + a[3]
            taps = torch.cat([vc[li], v[:, None]], 1)  # (B, ws, br)
            b2 = taps.flatten(1) @ ch["wk"][li]
            vc[li] = taps[:, 1:]
            if cnd_row is not None:
                b2 = b2 + cnd_row[li, :, i2]
            out = (F.elu(b2 + a[4]) + a[5]) @ ch["w3"][li] * a[7] + a[6]
            w = out + (s_prev @ ch["skw"] + ch["skb"] if li == 0 else w)
        logits = (dh_row[:, i2] + w) @ w_out + b_out
        if forced_idx is not None:
            logits_all.append(logits)
            idx = forced_idx[:, i2].long()
        else:
            idx = torch.argmax(logits / tau + gumbel[i2], dim=-1)
            idx = torch.where(torch.isfinite(logits).all(-1), idx, -1)
        idx_all[:, i2] = idx
        s_prev = emb[idx.clamp(min=0)]
    if forced_idx is not None:
        return idx_all, torch.stack(logits_all, 1)
    return idx_all


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
    if not cfg.use_pre_activation or cfg.use_concat_activation:
        raise ValueError("the cached sampler takes the pre-activation PixelCNN without "
                         "concat-activation (as the JAX sampler asserts); --sampler naive "
                         "samples Fixup and concat-activation models")
    dev = model_device(model)
    s0, s1, s2 = dims
    b, k = batch_size, cfg.input_dim
    half = cfg.kernel_size // 2
    row_kernel = cfg.kernel_size == 3  # K6's height step takes the k = 3 taps
    check_gumbel(gumbel, dims, b, k)

    with fp32_exact():
        layers = _extract_layers(model)
        n_layers = len(layers)
        w_in, b_in = model.parse_input.weight.detach(), model.parse_input.bias.detach().float()
        w_out = model.parse_output.weight.detach()[:, :, 0, 0, 0].t().float()
        b_out = model.parse_output.bias.detach().float()
        emb = w_in[:, :, 0, 0, 0].t().float() + b_in  # parse_input of each one-hot code, (K, C)
        if row_kernel:
            st = decode_row.stack_row_weights(layers, w_in, b_in, model.parse_output.weight.detach(),
                                              model.parse_output.bias.detach())
        else:
            step = AnyKRowStep(layers, _width_chain_weights(layers), b_in, emb, w_out, b_out, b,
                               s2, cfg.use_conditioning, forced is not None, tau, half)
        c = emb.shape[1]
        br = layers[0].c1["width_conv"].shape[0]

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
            gum = (gumbel[i0].to(dev, torch.float32).contiguous() if gumbel is not None
                   else draw_gumbel((s1, s2, b, k), generator, dev))
            if not row_kernel:
                step.hvc.zero_()
                d2h_s, d2w_s = torch.stack(d2h), torch.stack(d2w)  # (L, B, br, s1, s2)
                cnd_s = None if cond_sl is None else torch.stack(cond_sl)
                for i1 in range(s1):
                    row = dict(d2h=d2h_s[:, :, :, i1], d2w=d2w_s[:, :, :, i1],
                               dfin=dfin[:, :, i1], gum=gum[i1])
                    if i1 > 0:  # the first row's mask-'A' input is the zero pad
                        row["sprev"] = emb[x[:, i0, i1 - 1].clamp(min=0)].transpose(1, 2)
                    if cnd_s is not None:
                        row["cnd"] = cnd_s[:, :, :, i1]
                    if forced is not None:
                        row["forced"] = x[:, i0, i1]
                    res = step(i1 == 0, **row)
                    if forced is None:
                        x[:, i0, i1] = res
                    else:
                        logits_out[i0, i1] = res[1]
                continue
            d2h_rows, d2w_rows = _rows(d2h), _rows(d2w)
            cnd_rows = None if cond_sl is None else _rows(cond_sl)
            dfin_rows = dfin.permute(2, 0, 3, 1).contiguous()  # (s1, B, s2, C)
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
