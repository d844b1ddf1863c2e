"""Kernel wrappers of the port (K1a/K1b codebook lookup, K3 'same'-block
stack forward and backward, K4 PixelCNN causal segment forward and
backward, K7 small-channel conv weight gradient, K6 one row of cached
PixelCNN sampling, narrow and wide, K8 causal flash attention forward and
backward, K5 causal flash attention with logit dropout forward and
backward).

This file imports no jax, so its card tests also run on a machine that has
only PyTorch and CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU:
  * a CPU tensor takes the plain version and counts no launch;
  * ``pack_stack_weights`` + a numpy transcription of the CUDA kernel's loops
    (csrc/preact_stack.cu: flat weight offsets, halo indices, wrap/zero
    handling) against the plain block, to 1e-5 in float64 vs fp32: the layout
    the kernel reads is checked here, where no card runs it;
  * likewise the K3 backward (csrc/preact_stack_bwd.cu: the transposed packs
    of ``pack_stack_weights_t``, the transposed conv's source voxels, the
    dW2 tap layout, the scalar shares), K1b's order of the statistics' sums
    (csrc/l2_argmin_stats.cu: tiles, owner lanes grouped by code, slabs in
    warp turns, partials in CTA order) and K7's position offsets and output layout
    (csrc/dw_conv3d.cu), each against its plain version;
  * K4 forward and backward (csrc/causal_stack.cu, csrc/causal_stack_bwd.cu):
    ``pack_kernel_weights`` / ``pack_kernel_weights_t`` read through the
    kernels' flat offsets, the union conv's 18 taps and zero pads, the
    transposed conv's sources one row ahead, the dropout mask, the
    condition's accumulated gradient and the output layouts
    (``kernel_grads_to_union``), against ``causal_block_plain`` and
    ``causal_stack_bwd_plain``, to 1e-5 (float64 vs fp32);
  * K8 (csrc/flash_attention*.cu): the tile loops, chunked online softmax,
    masks and backward ranges, transcribed in float64, against the autograd
    of ``flash_causal_attention_plain`` to 1e-5, at S = 1, 77 and 130;
  * the narrow K6 (csrc/row_decode.cu): phase 1's precomputed addends, the
    lane groups and channel ownership of the voxel chain, the cached tap
    halves and the shared-memory exchanges, transcribed, against
    ``row_decode_plain``;
  * the wide K6 (csrc/row_decode_wide.cu): its cluster partition (each
    CTA's column slices, the exchanges and gathers, the strided parts of
    each product, the argmax across the CTAs) at cluster sizes 8 and 16 and
    widths they do not divide, transcribed, against ``row_decode_plain``;
  * K5 (csrc/flash_dropout_attention*.cu): K8's loops with the Philox
    counters of each chunk (forward), the (64 x 64) tile of keep bits in
    shared memory (dk/dv) and the groups of 4 keys (dq), transcribed in
    float64, against the autograd of ``flash_causal_dropout_attention_plain``
    to 1e-5, at S = 1, 77 and 130, p = 0.5 and 0.9.
On a card (marker ``gpu``; skipped here with the reason):
  * K1 against ``l2_argmin_plain``: equal indices wherever the two best
    codes are more than 1e-5 apart (relative), exact ties planted across
    the work split to the lowest code, one launch a call, at the path's
    three shapes, ragged N, K = 1 and D up to 64;
  * K3 against ``preact_stack_plain``: fp32 within 1e-4 of max|ref| (TF32
    off), bf16 within 3e-2 of max|ref| (both round at the same points; the
    fp32 sums run in another order, which can flip a bf16 rounding, 2^-8
    relative, and a flip carries through the following blocks);
  * K1b against ``l2_argmin_stats_plain``: indices equal except at genuine
    ties (the planted ties to the lowest code), counts exact and dw within
    1e-5 of max|dw| against the plain statistics of its own indices, and
    bit-identical on a second call, at K1's shapes up to D = 32;
  * the K3 backward (bf16: its weight contractions on the tensor cores)
    against the autograd of ``preact_stack_plain``: dx, dW1-3
    and the scalar grads of a 3-block stack, per tensor within 1e-4 of
    max|ref| in fp32 and 6e-2 in bf16 (the reference rounds its gradients
    and cuDNN's dW to bf16, the kernel sums dW in fp32), bit-identical on a
    second call;
  * K7 against ``dw_conv3d_plain`` within 1e-5 of max|ref| in fp32 (the
    CUDA-core route) and bf16 (the tensor-core route; bf16 products are exact
    in fp32, only the order of the fp32 sums differs), bit-identical on a
    second call, at Cin != Cout, C = 32, and a main-path-like C = 9 over
    (66, 66, 18) outputs, ragged against the 4x4x16 bricks;
  * K4 against ``causal_stack_plain`` and its autograd, 3 blocks, at odd
    grid sizes, B = 1 and 2, with and without a condition, and with a
    p = 0.5 keep mask: the no-save forward within 1e-4 (fp32) and 3e-2
    (bf16) of max|ref| as K3's; the saving forward, dx, the condition's
    gradient and every union-weight gradient per tensor within 1e-4 (fp32)
    and 6e-2 (bf16: the reference rounds its gradients to bf16, the kernel
    sums in fp32), bit-identical on a second call; and the causality check
    of ``causal_reach`` on the kernel's forward (impulses) and backward
    (gradients), fp32 and bf16 (the tensor-core forward and backward);
  * K4 at p = 0.5 over 12 blocks at the top prior's widths, conditioned, the
    keep masks as data: output and every gradient within 1e-4 (fp32) and
    2^-4 (bf16) of max|ref|; K7 at the causal convs of the Fixup (16 -> 16,
    kernels (2, 3, 3), (1, 2, 3), (1, 1, 2)) and k = 5 (4 -> 4, kernels
    past 3) PixelCNNs within 1e-5;
  * the cached sampler at kernel size 5 (its row step replayed as CUDA
    graphs, no K6) gives the grids of the eager step and of the naive
    sampler for one Gumbel table;
  * K4's bf16 tensor-core forward at the top prior's widths, conditioned or
    not, p = 0 and 0.5, no-save and saving, against ``causal_stack_plain``
    within 2^-6 (one block) and 2^-4 (three) of max|ref|, bit-identical on a
    second call, the parent's kernels within the same tolerance;
  * K3's bf16 backward on the brick route at every (C, spatial) of the
    stem-2 step that takes it, both pad modes, one block, against the
    autograd of the plain block within 2^-6 of max|ref| per tensor,
    bit-identical on a second call, the parent's five elementwise kernels
    within the same tolerance;
  * K8 at S ∈ {1, 63, 64, 65, 77, 128, 300, 4096}, D ∈ {8, 16, 32}: fp32
    (the CUDA-core routes) against the autograd of
    ``flash_causal_attention_plain`` within 1e-5 of max|ref|, bf16 (the
    tensor-core routes) against ``flash_causal_attention_plain`` (o) and
    ``flash_attention_bwd_plain`` (dq, dk, dv on the kernel's o) within 1e-2
    (both round P for P.V, P and ds in the backward, o and the gradients
    once; at S = 1, where dq and dk are zero in exact arithmetic, within the
    fp32 residue of the two sums in ds), bit-identical on a second call; its
    causality (gradients and a forward impulse);
  * the wide K6 against ``row_decode_plain`` at C=256/br=64/K=256
    conditioned, C=512/br=128/K=512 and the CPU transcription's widths, at
    cluster sizes 8 and 16: teacher-forced logits and caches within 1e-5 of
    max|ref|, free-running indices except near ties, a second call
    bit-identical; a non-finite logit gives -1;
  * K5 against the autograd of ``flash_causal_dropout_attention_plain`` at
    S in {1, 77, 128, 300, 2049}, D in {8, 16, 32}, p = 0.5: fp32 within
    1e-5 (o) and 1e-4 (gradients) of max|ref|, bf16 within 1e-2 (o) and
    4e-2 (gradients: the kernel's delta reads the bf16-rounded o where the
    plain autograd differentiates the fp32 softmax, and each ds = P (dP -
    delta) is a difference of two nearly equal sums), bit-identical on a
    second call; the collected mask equals
    the plain Philox mask bit for bit; at p = 0 it equals K8 within K8's
    tolerance; its causality;
    rows whose every key is dropped (p = 0.999) average their past values.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.models import blocks as tblocks
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.ops import (
    causal_kernel,
    conv3d,
    decode_row,
    flash_attention,
    flash_dropout_attention,
    quantizer_ops,
    stack_kernel,
)
from vqvae3d_tpu_torch.sample import cached_sample
from vqvae3d_tpu_torch.sample.ar_sample import ancestral_sample, draw_gumbel
from vqvae3d_tpu_torch.sample.cached_sample import _extract_layers, cached_ancestral_sample


def _stack(rng, nb, c, std=0.2):
    """Random reference-layout stack weights (w1s, w2s, w3s, sc8) as torch."""
    cb = max(c // 2, 1)
    sc8 = rng.standard_normal((nb, 8)) * std
    sc8[:, 7] += 1.0
    return tuple(
        torch.from_numpy(a.astype(np.float32))
        for a in (
            rng.standard_normal((nb, cb, c, 1, 1, 1)) * std,
            rng.standard_normal((nb, cb, cb, 3, 3, 3)) * std,
            rng.standard_normal((nb, c, cb, 1, 1, 1)) * std,
            sc8,
        )
    )


def _elu(v):
    return np.where(v > 0, v, np.expm1(np.minimum(v, 0)))


def _emulate_k3_block(x, w1p, w2p, w3p, sc, cb, wrap):
    """numpy transcription of csrc/preact_stack.cu (fp32 path): x is
    channels-last (B, H, W, D, C); w*p are one block's packed weights read
    through the same flat offsets the kernels compute."""
    b, h, w, d, c = x.shape
    xv = x.reshape(-1, c).astype(np.float64)
    w1f, w2f, w3f = (np.asarray(t, np.float64).reshape(-1) for t in (w1p, w2p, w3p))
    cob1, cob2, cob3 = w1p.shape[-1], w2p.shape[-1], w3p.shape[-1]
    # pre_kernel
    a1 = _elu(xv + sc[0]) + sc[1]
    a2 = np.zeros((xv.shape[0], cb))
    for g in range(-(-cb // cob1)):
        for j in range(cob1):
            k = g * cob1 + j
            if k < cb:
                a2[:, k] = _elu(a1 @ w1f[g * c * cob1 + np.arange(c) * cob1 + j] + sc[2]) + sc[3]
    # conv_kernel
    v = np.arange(xv.shape[0])
    iid, t = v % d, v // d
    iw, t = t % w, t // w
    ih, ib = t % h, t // h
    acc = np.zeros((xv.shape[0], cb))
    for kh in range(3):
        for kw in range(3):
            for kd in range(3):
                hh, ww, dd = ih + kh - 1, iw + kw - 1, iid + kd - 1
                inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w) & (dd >= 0) & (dd < d)
                src = ((ib * h + hh % h) * w + ww % w) * d + dd % d
                nbr = a2[src] * (1.0 if wrap else inside[:, None])
                tap = (kh * 3 + kw) * 3 + kd
                for g in range(-(-cb // cob2)):
                    for j in range(cob2):
                        k = g * cob2 + j
                        if k < cb:
                            idx = g * 27 * cb * cob2 + tap * cb * cob2 + np.arange(cb) * cob2 + j
                            acc[:, k] += nbr @ w2f[idx]
    a3 = _elu(acc + sc[4]) + sc[5]
    # post_kernel
    y = np.zeros_like(xv)
    for g in range(-(-c // cob3)):
        for j in range(cob3):
            co = g * cob3 + j
            if co < c:
                u = a3 @ w3f[g * cb * cob3 + np.arange(cb) * cob3 + j]
                y[:, co] = u * sc[7] + sc[6] + xv[:, co]
    return y.reshape(x.shape)


def _elu_grad(t):
    return np.where(t > 0, 1.0, np.exp(np.minimum(t, 0)))


def _shifted(shape, tap, s, wrap):
    """csrc/preact_stack_bwd.cu:shifted for every voxel: the index of
    v + s·(tap - 1) per axis, and where 'zeros' drops it."""
    b, h, w, d = shape
    v = np.arange(b * h * w * d)
    iid, t = v % d, v // d
    iw, t = t % w, t // w
    ih, ib = t % h, t // h
    hh, ww, dd = ih + s * (tap // 9 - 1), iw + s * ((tap // 3) % 3 - 1), iid + s * (tap % 3 - 1)
    inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w) & (dd >= 0) & (dd < d)
    idx = ((ib * h + hh % h) * w + ww % w) * d + dd % d
    return idx, (np.ones_like(inside) if wrap else inside)


def _grouped(mat_rows, packed, n_out, inner, tap=None, ntaps=27):
    """out[:, o] = mat_rows @ packed[g·G + tap·inner·cob + arange(inner)·cob + j]
    for o = g·cob + j, G = the group's slab (ntaps·inner·cob with taps, else
    inner·cob): how every kernel reads a [G][(ntaps)][inner][cob] pack."""
    cob = packed.shape[-1]
    flat = np.asarray(packed, np.float64).reshape(-1)
    slab, off = (inner * cob, 0) if tap is None else (ntaps * inner * cob, tap * inner * cob)
    out = np.zeros((mat_rows.shape[0], n_out))
    for o in range(n_out):
        g, j = divmod(o, cob)
        out[:, o] = mat_rows @ flat[g * slab + off + np.arange(inner) * cob + j]
    return out


def _emulate_k3_bwd_block(x, gy, packs, tpacks, sc, cb, wrap):
    """numpy transcription of csrc/preact_stack_bwd.cu (fp32 path) for one
    block: x, gy channels-last (B, H, W, D, C). Returns dx (same layout),
    dw1 (Cb, C), dw2 (27, Cb_out, Cb_in), dw3 (C, Cb), dsc (8,)."""
    b, h, w, d, c = x.shape
    w1p, w2p, w3p = packs
    w1t, w2t, w3t = tpacks
    xv, gv = x.reshape(-1, c).astype(np.float64), gy.reshape(-1, c).astype(np.float64)
    n = xv.shape[0]
    t1 = xv + sc[0]
    a1 = _elu(t1) + sc[1]
    t2 = _grouped(a1, w1p, cb, c) + sc[2]  # bwd_pre
    a2 = _elu(t2) + sc[3]
    u2 = np.zeros((n, cb))  # bwd_mid: the forward conv, recomputed
    for tap in range(27):
        nb, ok = _shifted((b, h, w, d), tap, 1, wrap)
        u2 += _grouped(a2[nb] * ok[:, None], w2p, cb, cb, tap)
    t3 = u2 + sc[4]
    a3 = _elu(t3) + sc[5]
    gu = gv * sc[7]
    ga3 = _grouped(gu, w3t, cb, c)
    gt3 = ga3 * _elu_grad(t3)
    u3 = _grouped(a3, w3p, c, cb)  # bwd_post
    ga2 = np.zeros((n, cb))  # bwd_dgrad: sources v - (tap - 1)
    for tap in range(27):
        src, ok = _shifted((b, h, w, d), tap, -1, wrap)
        ga2 += _grouped(gt3[src] * ok[:, None], w2t, cb, cb, tap)
    gt2 = ga2 * _elu_grad(t2)
    ga1 = _grouped(gt2, w1t, c, cb)  # bwd_dx
    gt1 = ga1 * _elu_grad(t1)
    dw2 = np.zeros((27, cb, cb))
    for tap in range(27):  # contract_partial<NT = 27>
        nb, ok = _shifted((b, h, w, d), tap, 1, wrap)
        dw2[tap] = gt3.T @ (a2[nb] * ok[:, None])
    dsc = np.array([gt1.sum(), ga1.sum(), gt2.sum(), ga2.sum(), gt3.sum(), ga3.sum(),
                    gv.sum(), (gv * u3).sum()])
    return (gv + gt1).reshape(x.shape), gt2.T @ a1, dw2, gu.T @ a3, dsc


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18])
def test_k3_bwd_packed_layout_and_indexing(c, pad_mode):
    rng = np.random.default_rng(400 + c)
    nb = 2
    x = torch.from_numpy(rng.standard_normal((2, c, 5, 4, 3)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((2, c, 5, 4, 3)).astype(np.float32))
    w1s, w2s, w3s, sc8 = _stack(rng, nb, c)
    cb = w1s.shape[1]
    saves = torch.empty((nb, 2, 5, 4, 3, c))
    cur = x
    for j in range(nb):
        saves[j] = cur.permute(0, 2, 3, 4, 1)
        cur = stack_kernel.preact_fixup_same(cur, w1s[j], w2s[j], w3s[j], sc8[j],
                                             pad_mode=pad_mode)
    want = stack_kernel.preact_stack_bwd_plain(saves, gy, w1s, w2s, w3s, sc8, pad_mode)
    packs = stack_kernel.pack_stack_weights(w1s, w2s, w3s, torch.float32)
    tpacks = stack_kernel.pack_stack_weights_t(w1s, w2s, w3s, torch.float32)
    g = gy.permute(0, 2, 3, 4, 1).numpy()
    got = [None] * nb
    for j in reversed(range(nb)):
        g, *got[j] = _emulate_k3_bwd_block(
            saves[j].numpy(), g, [t[j] for t in packs], [t[j] for t in tpacks],
            sc8[j].numpy().astype(np.float64), cb, pad_mode == "wrap")
    np.testing.assert_allclose(g, want[0].permute(0, 2, 3, 4, 1).numpy(), atol=1e-4, rtol=0)
    dw1, dw2, dw3, dsc = (np.stack(t) for t in zip(*got))
    # the wrapper's map from the kernel's outputs to the reference layouts
    dw2 = dw2.transpose(0, 2, 3, 1).reshape(nb, cb, cb, 3, 3, 3)
    for name, a, b in (("dw1", dw1.reshape(w1s.shape), want[1]), ("dw2", dw2, want[2]),
                       ("dw3", dw3.reshape(w3s.shape), want[3]), ("dsc", dsc, want[4])):
        np.testing.assert_allclose(a, b.numpy(), atol=2e-4 * float(b.abs().max()), rtol=0,
                                   err_msg=name)


def _k1b_stats_in_kernel_order(flat, idx, k, plan):
    """csrc/l2_argmin_stats.cu's sums in its order: CTA b takes tiles b,
    b + ctas, ...; in each tile, round by round (warp w in round w // slabs,
    on slab w % slabs), row slot by row slot, the owner lanes (lane s = 0 of
    each row group) grouped by code, each group's rows summed in lane order
    from 0 and added to the slab; a CTA's partial is its slabs summed in
    slab order; the reduce's warp w sums the partials of CTAs w, w + 8, ...
    in order, then the 8 warps' sums in warp order. All fp32."""
    lk, (n, d) = plan.lookup, flat.shape
    x = flat.astype(np.float32)
    threads = quantizer_ops.THREADS
    warps = threads // 32
    part = np.zeros((plan.ctas, k, 1 + d), np.float32)
    seen = np.zeros(n, np.int64)
    for b in range(plan.ctas):
        slabs = np.zeros((plan.slabs, k, 1 + d), np.float32)
        for t in range(b, lk.tiles, plan.ctas):
            for rnd in range(warps // plan.slabs):
                for warp in range(rnd * plan.slabs, (rnd + 1) * plan.slabs):
                    slab = slabs[warp % plan.slabs]
                    for r in range(lk.rows):
                        owners = []  # (lane, row) of the owner lanes, in lane order
                        for lane in range(0, 32, lk.lanes):
                            row = (t * lk.tile_rows + r * (threads // lk.lanes)
                                   + (warp * 32 + lane) // lk.lanes)
                            if row < n:
                                owners.append(row)
                        for c in dict.fromkeys(int(idx[row]) for row in owners):
                            group = [row for row in owners if idx[row] == c]
                            acc = np.zeros(d, np.float32)
                            for row in group:
                                acc = acc + x[row]
                                seen[row] += 1
                            slab[c, 0] += np.float32(len(group))
                            slab[c, 1:] += acc
        part[b] = slabs[0]
        for g in range(1, plan.slabs):
            part[b] = part[b] + slabs[g]
    sums = np.zeros((warps, k, 1 + d), np.float32)
    for w in range(warps):
        for b in range(w, plan.ctas, warps):
            sums[w] = sums[w] + part[b]
    total = sums[0]
    for w in range(1, warps):
        total = total + sums[w]
    assert (seen == 1).all(), "a row counted twice or never"
    return total[:, 0], total[:, 1:]


@pytest.mark.parametrize("rows,lanes,ctas,slabs", [(4, 1, 2, 8), (1, 4, 3, 8), (1, 32, 5, 2),
                                                   (1, 8, 2, 1), (4, 1, 7, 4)])
def test_k1b_tile_partition(rows, lanes, ctas, slabs):
    """csrc/l2_argmin_stats.cu's statistics order, transcribed (tiles of
    the lookup's split, the owner lanes grouped by code, slabs shared by
    warps in turn, partials reduced in CTA order), against the plain
    statistics: counts exact, dw within 1e-6 of max|dw|; rows past N count
    nowhere. The split of ``stats_plan`` at this shape is one of them."""
    rng = np.random.default_rng(3 + rows + lanes)
    n, k, d = 1000, 19, 3  # ragged tiles, k not a multiple of the lanes
    flat = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    embed = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    tile_rows = quantizer_ops.THREADS // lanes * rows
    lookup = quantizer_ops.LookupPlan(4, rows, lanes, -(-n // tile_rows))  # d = 3: DT 4
    plan = quantizer_ops.StatsPlan(lookup, ctas, slabs)
    idx = quantizer_ops.l2_argmin_plain(flat, embed).numpy()
    counts, dw = _k1b_stats_in_kernel_order(flat.numpy(), idx, k, plan)
    _, p_counts, p_dw = quantizer_ops.l2_argmin_stats_plain(flat, embed)
    np.testing.assert_array_equal(counts, p_counts.numpy())
    np.testing.assert_allclose(dw, p_dw.numpy(), atol=1e-6 * float(p_dw.abs().max()), rtol=0)
    auto = quantizer_ops.stats_plan(n, k, d)
    assert (auto.lookup.rows, auto.lookup.lanes, auto.slabs) == (1, 4, 8)


def test_k7_offsets_and_layout():
    """csrc/dw_conv3d.cu: output position o -> (b, oh, ow, od), the g and x
    offsets goff / xoff + channel planes, tap = (i·kw + j)·kd + l, and the
    (Cout, Cin, kh, kw, kd) output index (co·Cin + ci)·kvol + tap."""
    rng = np.random.default_rng(4)
    b, cin, cout, (hp, wp, dp), (kh, kw, kd) = 2, 3, 5, (6, 5, 4), (3, 2, 3)
    x = rng.standard_normal((b, cin, hp, wp, dp)).astype(np.float32)
    ho, wo, do = hp - kh + 1, wp - kw + 1, dp - kd + 1
    g = rng.standard_normal((b, cout, ho, wo, do)).astype(np.float32)
    xf, gf = x.reshape(-1).astype(np.float64), g.reshape(-1).astype(np.float64)
    kvol = kh * kw * kd
    out = np.zeros(cout * cin * kvol)
    for tap in range(kvol):
        ti, tj, tl = tap // (kw * kd), (tap // kd) % kw, tap % kd
        for o in range(b * ho * wo * do):
            od, r = o % do, o // do
            ow, r = r % wo, r // wo
            oh, bb = r % ho, r // ho
            goff = bb * cout * ho * wo * do + (oh * wo + ow) * do + od
            xoff = bb * cin * hp * wp * dp + ((oh + ti) * wp + (ow + tj)) * dp + (od + tl)
            for e in range(cin * cout):
                co, ci = divmod(e, cin)
                out[e * kvol + tap] += xf[xoff + ci * hp * wp * dp] * gf[goff + co * ho * wo * do]
    want = conv3d.dw_conv3d_plain(torch.from_numpy(x), torch.from_numpy(g), (kh, kw, kd))
    np.testing.assert_allclose(out.reshape(want.shape), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18])
def test_k3_packed_layout_and_indexing(c, pad_mode):
    rng = np.random.default_rng(200 + c)
    x = rng.standard_normal((2, 5, 4, 3, c)).astype(np.float32)
    w1s, w2s, w3s, sc8 = _stack(rng, 2, c)
    w1p, w2p, w3p = stack_kernel.pack_stack_weights(w1s, w2s, w3s, torch.float32)
    cb = w1s.shape[1]
    assert w1p.shape[-1] == stack_kernel._cob(cb) and w3p.shape[-1] == stack_kernel._cob(c)
    got = x
    for j in range(2):
        got = _emulate_k3_block(got, w1p[j], w2p[j], w3p[j], sc8[j].numpy(), cb,
                                pad_mode == "wrap")
    want = stack_kernel.preact_stack_plain(
        torch.from_numpy(x).movedim(-1, 1), w1s, w2s, w3s, sc8, pad_mode=pad_mode
    )
    np.testing.assert_allclose(got, want.movedim(1, -1).numpy(), atol=1e-5, rtol=0)


def _counts():
    return (quantizer_ops.l2_argmin.launches, quantizer_ops.l2_argmin_stats.launches,
            stack_kernel.preact_stack_fused.launches, stack_kernel.preact_stack_bwd.launches,
            conv3d.dw_conv3d.launches, decode_row.row_decode.launches,
            causal_kernel.causal_stack_fused.launches, causal_kernel.causal_stack_bwd.launches,
            flash_attention.flash_causal_attention.launches,
            flash_attention.flash_attention_bwd.launches, decode_row.row_decode.wide_launches,
            flash_dropout_attention.flash_causal_dropout_attention.launches,
            flash_dropout_attention.flash_dropout_attention_bwd.launches)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    w1s, w2s, w3s, sc8 = _stack(rng, 2, 4)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 2)).astype(np.float32))
    flat, embed = torch.randn(50, 3), torch.randn(7, 3)
    before = _counts()
    np.testing.assert_array_equal(
        quantizer_ops.l2_argmin(flat, embed), quantizer_ops.l2_argmin_plain(flat, embed)
    )
    for a, b in zip(quantizer_ops.l2_argmin_stats(flat, embed),
                    quantizer_ops.l2_argmin_stats_plain(flat, embed)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        stack_kernel.preact_stack_fused(x, w1s, w2s, w3s, sc8, "zeros"),
        stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode="zeros"),
    )
    # the training path: the saving forward and the backward on the CPU
    xg = x.clone().requires_grad_()
    ws = [t.clone().requires_grad_() for t in (w1s, w2s, w3s, sc8)]
    y = stack_kernel.preact_stack_fused(xg, *ws, "zeros")
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, [xg, *ws], gy)
    xr = x.clone().requires_grad_()
    wr = [t.clone().requires_grad_() for t in (w1s, w2s, w3s, sc8)]
    want = torch.autograd.grad(
        stack_kernel.preact_stack_plain(xr, *wr, pad_mode="zeros"), [xr, *wr], gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # K4: the no-save forward and the autograd.Function on CPU tensors
    uw = _union_weights(rng, 2, 4, 2, 3)
    xu = torch.from_numpy(rng.standard_normal((1, 3, 4, 2, 12)).astype(np.float32))
    cu_ = torch.from_numpy(rng.standard_normal((1, 3, 4, 2, 3)).astype(np.float32))
    np.testing.assert_array_equal(causal_kernel.causal_stack_fused(xu, cu_, None, 0.0, uw),
                                  causal_kernel.causal_stack_plain(xu, cu_, None, 0.0, uw))
    xg = xu.clone().requires_grad_()
    (causal_kernel.causal_stack_fused(xg, cu_, None, 0.0, uw) ** 2).sum().backward()
    assert torch.isfinite(xg.grad).all()
    # K8: the dispatcher on CPU tensors is the plain version, autograd included
    q, k, v = (torch.randn(3, 9, 8, requires_grad=True) for _ in range(3))
    o = flash_attention.flash_causal_attention(q, k, v, 0.3)
    np.testing.assert_array_equal(o.detach(), flash_attention.flash_causal_attention_plain(
        q, k, v, 0.3).detach())
    o.sum().backward()
    assert torch.isfinite(q.grad).all()
    # K5: likewise, with its seed
    seed = torch.tensor([3, 4])
    o = flash_dropout_attention.flash_causal_dropout_attention(q, k, v, 0.3, 0.5, seed)
    np.testing.assert_array_equal(o.detach(), flash_dropout_attention.
                                  flash_causal_dropout_attention_plain(q, k, v, 0.3, 0.5, seed)
                                  .detach())
    o.sum().backward()
    assert torch.isfinite(k.grad).all()
    # K6 at a wide width: the plain row
    st, rows, dfin, sprev = _k6_row(64, 16, 32, 2, 1, 3, False, True, 5, "cpu")
    assert decode_row.uses_wide_kernel(64, 16, 32, 3)
    gum = torch.rand(3, 1, 32)
    got = decode_row.row_decode(st, rows[0], rows[1], None, dfin, sprev, rows[3].clone(), gum,
                                1, 0.5)
    want = decode_row.row_decode_plain(st, rows[0], rows[1], None, dfin, sprev, rows[3].clone(),
                                       gum, 1, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _counts() == before


def test_plain_block_is_the_module_math():
    """``preact_fixup_same`` equals the 'same' block module it stands for."""
    rng = np.random.default_rng(1)
    w1s, w2s, w3s, sc8 = _stack(rng, 1, 6)
    blk = tblocks.PreActFixupResBlock(6, 6, "same", pad_mode="wrap")
    sd = {f"bias{n}": sc8[0, i : i + 1] for i, n in enumerate(tblocks.SCALARS)}
    sd.update(scale=sc8[0, 7:8], **{"branch_conv1.weight": w1s[0],
                                   "branch_conv2.weight": w2s[0],
                                   "branch_conv3.weight": w3s[0]})
    blk.load_state_dict(sd)
    x = torch.from_numpy(rng.standard_normal((1, 6, 4, 3, 2)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_array_equal(
            blk(x), stack_kernel.preact_fixup_same(x, w1s[0], w2s[0], w3s[0], sc8[0],
                                                   pad_mode="wrap")
        )


def _emulate_k8_fwd(q, k, v, scale, bq=64, bk=64, ch=16):
    """numpy transcription of csrc/flash_attention.cu (float64): per block of
    bq query rows, the key tiles up to its diagonal, staged with zero fill
    past S, the online softmax over chunks of ch keys, masked at j > i."""
    n_, s_, d_ = q.shape
    o, lse = np.zeros_like(q), np.zeros((n_, s_))
    for n in range(n_):
        for q0 in range(0, s_, bq):
            rows = np.arange(q0, min(q0 + bq, s_))
            m = np.full(len(rows), -np.inf)
            l, acc = np.zeros(len(rows)), np.zeros((len(rows), d_))
            for k0 in range(0, min(q0 + bq, s_), bk):
                ks, vs = np.zeros((bk, d_)), np.zeros((bk, d_))
                ks[:min(bk, s_ - k0)] = k[n, k0:k0 + bk]
                vs[:min(bk, s_ - k0)] = v[n, k0:k0 + bk]
                jn = np.minimum(bk, rows - k0 + 1)  # keys j <= i of this tile
                for c0 in range(0, bk, ch):
                    act = c0 < jn
                    j = c0 + np.arange(ch)
                    sc = (q[n, rows] @ ks[j].T) * scale
                    sc = np.where(j[None] < jn[:, None], sc, -np.inf)
                    mn = np.maximum(m, sc.max(1))
                    alpha = np.exp(np.where(act, m - mn, 0.0))
                    p = np.where(j[None] < jn[:, None], np.exp(sc - mn[:, None]), 0.0)
                    l = np.where(act, l * alpha + p.sum(1), l)
                    acc = np.where(act[:, None], acc * alpha[:, None] + p @ vs[j], acc)
                    m = np.where(act, mn, m)
            o[n, rows] = acc / l[:, None]
            lse[n, rows] = m + np.log(l)
    return o, lse


def _emulate_k8_bwd(q, k, v, o, lse, do, scale, bq=64, bk=64):
    """numpy transcription of csrc/flash_attention_bwd.cu (float64): delta;
    dk, dv per key tile over the query tiles from its diagonal, rows
    max(j - q0, 0) .. min(bq, S - q0); dq per query tile over the key tiles
    up to its diagonal, keys < min(bk, i - k0 + 1)."""
    n_, s_, d_ = q.shape
    delta = (do * o).sum(-1)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for n in range(n_):
        for k0 in range(0, s_, bk):
            for j in range(k0, min(k0 + bk, s_)):
                for q0 in range(k0, s_, bq):
                    ii = np.arange(max(j - q0, 0), min(bq, s_ - q0)) + q0
                    p = np.exp((q[n, ii] @ k[n, j]) * scale - lse[n, ii])
                    ds = p * (do[n, ii] @ v[n, j] - delta[n, ii])
                    dv[n, j] += p @ do[n, ii]
                    dk[n, j] += ds @ q[n, ii]
            dk[n, k0:k0 + bk] *= scale
        for q0 in range(0, s_, bq):
            for i in range(q0, min(q0 + bq, s_)):
                for k0 in range(0, min(q0 + bq, s_), bk):
                    jj = np.arange(min(bk, i - k0 + 1)) + k0
                    p = np.exp((k[n, jj] @ q[n, i]) * scale - lse[n, i])
                    ds = p * (v[n, jj] @ do[n, i] - delta[n, i])
                    dq[n, i] += ds @ k[n, jj]
            dq[n, q0:q0 + bq] *= scale
    return dq, dk, dv


@pytest.mark.parametrize("s,d", [(1, 8), (77, 16), (130, 8)])
def test_k8_tiles_and_masks(s, d):
    """The tile loops, masks and ranges of K8's forward and backward (a
    transcription in float64) against the autograd of the plain version (fp32),
    to 1e-5 of max|ref|: at S = 1, one ragged tile and three tiles."""
    rng = np.random.default_rng(s + d)
    q, k, v, g = (rng.standard_normal((2, s, d)) for _ in range(4))
    scale = d ** -0.5
    o, lse = _emulate_k8_fwd(q, k, v, scale)
    got = (o, *_emulate_k8_bwd(q, k, v, o, lse, g, scale))
    qt, kt, vt = (torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (q, k, v))
    ot = flash_attention.flash_causal_attention_plain(qt, kt, vt, scale)
    want = (ot, *torch.autograd.grad(ot, (qt, kt, vt), torch.tensor(g, dtype=torch.float32)))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        b = b.detach().numpy()
        # the scale at least 1 (the inputs' own): at S = 1, dq and dk are zero
        err, ref = float(np.abs(a - b).max()), max(float(np.abs(b).max()), 1.0)
        assert err <= 1e-5 * ref, f"{name}: max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def _k5_bits(seed, n, rows, groups, p):
    """The keep bits of csrc/philox.cuh::keep4 for rows x groups of 4 keys:
    (len(rows), 4 len(groups)) bool, key 4 g + r in column 4 (g - g0) + r."""
    words = flash_dropout_attention.philox4x32_10(
        torch.as_tensor(groups, dtype=torch.int64)[None, :],
        torch.as_tensor(rows, dtype=torch.int64)[:, None], n, 0, int(seed[0]), int(seed[1]))
    bits = torch.stack(torch.broadcast_tensors(*words), -1).flatten(-2)
    return (bits >= flash_dropout_attention.keep_threshold(p)).numpy()


def _emulate_k5_fwd(q, k, v, scale, seed, p, bq=64, bk=64, ch=16):
    """numpy transcription of csrc/flash_dropout_attention.cu (float64): K8's
    forward loops; per chunk of ch keys, the 4 Philox groups (k0 + c0) / 4 +
    g of each row; kept logits scaled by 1 / (1 - p), dropped ones -1e3."""
    n_, s_, d_ = q.shape
    o, lse = np.zeros_like(q), np.zeros((n_, s_))
    for n in range(n_):
        for q0 in range(0, s_, bq):
            rows = np.arange(q0, min(q0 + bq, s_))
            m = np.full(len(rows), -np.inf)
            l, acc = np.zeros(len(rows)), np.zeros((len(rows), d_))
            for k0 in range(0, min(q0 + bq, s_), bk):
                ks, vs = np.zeros((bk, d_)), np.zeros((bk, d_))
                ks[:min(bk, s_ - k0)] = k[n, k0:k0 + bk]
                vs[:min(bk, s_ - k0)] = v[n, k0:k0 + bk]
                jn = np.minimum(bk, rows - k0 + 1)
                for c0 in range(0, bk, ch):
                    act = c0 < jn
                    j = c0 + np.arange(ch)
                    kept = _k5_bits(seed, n, rows, (k0 + c0) // 4 + np.arange(ch // 4), p)
                    sc = np.where(kept, (q[n, rows] @ ks[j].T) * scale / (1 - p), -1e3)
                    sc = np.where(j[None] < jn[:, None], sc, -np.inf)
                    mn = np.maximum(m, sc.max(1))
                    alpha = np.exp(np.where(act, m - mn, 0.0))
                    pr = np.where(j[None] < jn[:, None], np.exp(sc - mn[:, None]), 0.0)
                    l = np.where(act, l * alpha + pr.sum(1), l)
                    acc = np.where(act[:, None], acc * alpha[:, None] + pr @ vs[j], acc)
                    m = np.where(act, mn, m)
            o[n, rows] = acc / l[:, None]
            lse[n, rows] = m + np.log(l)
    return o, lse


def _emulate_k5_bwd(q, k, v, o, lse, do, scale, seed, p, bq=64, bk=64):
    """numpy transcription of csrc/flash_dropout_attention_bwd.cu (float64):
    delta; dk, dv per key tile over the query tiles from its diagonal, each
    tile's bits built row by row (16 groups of the tile's 64 keys) and read
    by column; dq per query row over groups of 4 keys, dropped keys
    skipped."""
    n_, s_, d_ = q.shape
    inv = 1 / (1 - p)
    delta = (do * o).sum(-1)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for n in range(n_):
        for k0 in range(0, s_, bk):
            for q0 in range(k0, s_, bq):
                tile_rows = np.arange(q0, min(q0 + bq, s_))
                bits = _k5_bits(seed, n, tile_rows, k0 // 4 + np.arange(bk // 4), p)
                for j in range(k0, min(k0 + bk, s_)):
                    ii = np.arange(max(j - q0, 0), min(bq, s_ - q0))
                    kept = bits[ii, j - k0]
                    i = ii + q0
                    pr = np.exp(np.where(kept, (q[n, i] @ k[n, j]) * scale * inv, -1e3)
                                - lse[n, i])
                    ds = np.where(kept, pr * (do[n, i] @ v[n, j] - delta[n, i]) * inv, 0.0)
                    dv[n, j] += pr @ do[n, i]
                    dk[n, j] += ds @ q[n, i]
            dk[n, k0:k0 + bk] *= scale
        for i in range(s_):
            for k0 in range(0, (i // bq) * bq + 1, bk):
                jn = min(bk, i - k0 + 1)
                for g0 in range(0, jn, 4):
                    kept = _k5_bits(seed, n, [i], [(k0 + g0) // 4], p)[0]
                    for r in range(4):
                        j = k0 + g0 + r
                        if g0 + r < jn and kept[r]:
                            pr = np.exp((q[n, i] @ k[n, j]) * scale * inv - lse[n, i])
                            dq[n, i] += pr * (do[n, i] @ v[n, j] - delta[n, i]) * inv * k[n, j]
            dq[n, i] *= scale
    return dq, dk, dv


@pytest.mark.parametrize("s,d,p", [(1, 8, 0.5), (77, 16, 0.9), (130, 8, 0.5)])
def test_k5_tiles_counters_and_masks(s, d, p):
    """K5's loops, Philox counters and bit layouts (a transcription in float64)
    against the autograd of the plain version (fp32), to 1e-5 of max|ref|."""
    rng = np.random.default_rng(s + d)
    q, k, v, g = (rng.standard_normal((2, s, d)) for _ in range(4))
    scale, seed = d ** -0.5, (123456789, 2**32 - 5)
    o, lse = _emulate_k5_fwd(q, k, v, scale, seed, p)
    got = (o, *_emulate_k5_bwd(q, k, v, o, lse, g, scale, seed, p))
    qt, kt, vt = (torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (q, k, v))
    ot = flash_dropout_attention.flash_causal_dropout_attention_plain(
        qt, kt, vt, scale, p, torch.tensor(seed))
    want = (ot, *torch.autograd.grad(ot, (qt, kt, vt), torch.tensor(g, dtype=torch.float32)))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        b = b.detach().numpy()
        err, ref = float(np.abs(a - b).max()), max(float(np.abs(b).max()), 1.0)
        assert err <= 1e-5 * ref, f"{name}: max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def _emulate_k6_wide(st, d2h, d2w, cnd, dfin, sprev, vhc, gum, i1, tau, forced=None, n=16,
                     nt=256):
    """numpy transcription of csrc/row_decode_wide.cu (float64): one cluster
    of n CTAs. Phase 1 (the height-row step): CTA r takes batch rows r,
    r + n, ... at full width, its products in tasks of 8 or 4 rows whose
    inputs are split over lp lanes (``lanes_rows``: from the rows and
    columns alone), the six height taps one product over their inputs side
    by side, and stores h2w and the final row into the columns' owners. Phase 2 (the
    voxel chain): CTA r owns columns [r jb, r jb + jb) of br (jc of C, jk of
    K; ceil splits, zero-filled past the width, never stored); each product
    computes its own columns for all B rows in warp tasks whose inputs are
    split over LP lanes (``lanes_for``, k = part + LP i) and summed by the
    xor shuffles' tree; the activations a product needs in full are each
    CTA's own columns, stored into every CTA (the ``gather`` points below);
    the argmax per CTA over its columns, then over the CTAs' winners in rank
    order."""
    f = {k: np.asarray(t, np.float64) for k, t in st.items()}
    L, B, s2, br = d2w.shape
    C, K = dfin.shape[-1], gum.shape[-1]
    R = B * s2
    d2h, d2w = (np.asarray(t, np.float64).reshape(L, R, br) for t in (d2h, d2w))
    vhc = np.asarray(vhc, np.float64).reshape(L, R, br).copy()
    cnd = np.zeros((L, R, br)) if cnd is None else np.asarray(cnd, np.float64).reshape(L, R, br)
    dfin, sprev = (np.asarray(t, np.float64).reshape(R, C) for t in (dfin, sprev))
    gum = np.asarray(gum, np.float64)
    elu, skip0 = _elu, "skw" in f
    jb, jc, jk = -(-br // n), -(-C // n), -(-K // n)
    nw = nt // 32

    def lanes_for(rows, kd, cols):  # the lanes a warp task splits its inputs over
        njt = -(-cols // 4)
        costs = [(-(-(-(-rows // 2) * -(-njt * lp // 32)) // nw) * (14 * -(-kd // lp) + 16 * lg), -lp)
                 for lp, lg in ((32, 5), (16, 4), (8, 3), (4, 2))]
        return -min(costs)[1]

    def butterfly(parts):  # the lane of part 0 after the xor shuffles over the parts
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[2 * i] + parts[2 * i + 1] for i in range(half)]
        return parts[0]

    def product(x, w, cols=None):  # warp tasks: the inputs split over LP lanes, then the shuffles
        lp = lanes_for(x.shape[0], x.shape[1], w.shape[1] if cols is None else cols)
        return butterfly([x[:, part::lp] @ w[part::lp] for part in range(lp)])

    def lanes_rows(rows, cols):  # phase 1: the most lanes that keep every task in one pass
        nrc, lp = -(-rows // (8 if rows > 4 else 4)), 32
        while lp > 4 and nrc * (cols // 4) * lp > nt:
            lp //= 2
        return lp

    def product_rows(x, w):  # phase 1: tasks of 8 or 4 rows, the inputs over lp lanes
        lp = lanes_rows(x.shape[0], w.shape[1])
        return butterfly([x[:, part::lp] @ w[part::lp] for part in range(lp)])

    def own(a, r, j):  # columns [r j, r j + j) of a's last axis, zero past it
        o = np.zeros(a.shape[:-1] + (j,))
        v = min(max(a.shape[-1] - r * j, 0), j)
        o[..., :v] = a[..., r * j:r * j + v]
        return o

    def gather(xs, width):  # every CTA's own columns, in rank order
        return np.concatenate(xs, -1)[..., :width]

    sc = f["sc"]
    hw = [np.zeros((L, R, jb)) for _ in range(n)]  # the owners' columns
    hf = [np.zeros((R, jc)) for _ in range(n)]
    for r in range(n):  # ---- phase 1: CTA r's batch rows b = r, r + n, ... at full width
        nb_ = len(range(r, B, n))
        rows = np.array([b * s2 + p for b in range(r, B, n) for p in range(s2)], int)
        if not nb_:
            continue
        h = np.tile(f["b_in"], (len(rows), 1))
        for li in range(L):
            s = sc[li]
            u = elu((sprev[rows] if li == 0 else h) + s[0]) + s[1]
            if li == 0 and i1 == 0:
                u = np.zeros_like(u)
            vp = vhc[li][rows].copy()  # read before this CTA writes its rows
            tp = product_rows(u, f["hw1"][li])
            v1 = elu(tp + d2h[li][rows] + s[2]) + s[3]
            hwv = f["herfb"][li] + product_rows(tp, f["herf"][li])
            for q in range(n):  # h2w into the columns' owners
                hw[q][li][rows] = own(hwv, q, jb)
            xs = []  # the six tap inputs side by side: [cached v-row, v1] at p + j1 - 1
            for src in (vp, v1):
                for j1 in range(3):
                    x = np.zeros((nb_, s2, br))
                    lo, hi = max(0, 1 - j1), min(s2, s2 + 1 - j1)
                    x[:, lo:hi] = src.reshape(nb_, s2, br)[:, lo + j1 - 1:hi + j1 - 1]
                    xs.append(x.reshape(-1, br))
            b2 = product_rows(np.concatenate(xs, 1), f["hwk"][li].reshape(6 * br, br))
            w3v = elu(b2 + cnd[li][rows] + s[4]) + s[5]
            vhc[li][rows] = v1
            po = product_rows(w3v, f["hw3"][li])
            if li == 0 and skip0:  # accumulated onto the same lanes' outputs
                h = f["hb3"][li] + (po + product_rows(sprev[rows], f["hskw"]))
            else:
                h = f["hb3"][li] + po + h
        for q in range(n):  # the final row into the owners' columns
            hf[q][rows] = own(h, q, jc)
    out = np.zeros((B, s2), np.int64)
    logits = np.zeros((B, s2, K))
    vc = [np.zeros((L, B, jb)) for _ in range(n)]
    idx = None
    for i2 in range(s2):  # ---- phase 2
        xw = [own(np.tile(f["b_in"], (B, 1)), r, jc) for r in range(n)]
        sv = np.zeros((B, C)) if i2 == 0 else f["w_in"][np.maximum(idx, 0)] + f["b_in"]
        for li in range(L):
            s = sc[li]
            rows = np.arange(B) * s2 + i2
            xu = []
            for r in range(n):
                u = elu((own(sv, r, jc) if li == 0 else xw[r]) + s[0]) + s[1]
                u[:, min(max(C - r * jc, 0), jc):] = 0
                xu.append(np.zeros_like(u) if li == 0 and i2 == 0 else u)
            u = gather(xu, C)  # barrier, gather
            xv = [elu(product(u, own(f["w1"][li], r, jb))
                      + own(d2w[li][rows], r, jb) + hw[r][li][rows] + s[2]) + s[3]
                  for r in range(n)]
            v = gather(xv, br)  # barrier, gather
            x3 = []
            for r in range(n):
                both = product(v, np.concatenate([own(f["wk"][li, 1], r, jb),
                                                  own(f["wk"][li, 0], r, jb)], 1),
                               2 * (-(-jb // 4) * 4))
                b2 = vc[r][li] + both[:, :jb]  # one task: the tap now and the cached half
                vc[r][li] = both[:, jb:]
                x3.append(elu(b2 + own(cnd[li][rows], r, jb) + s[4]) + s[5])
            w3v = gather(x3, br)  # barrier, gather
            for r in range(n):
                acc = own(f["b3"][li], r, jc) + product(w3v, own(f["w3"][li], r, jc))
                if li == 0 and skip0:  # w_in[idx] . skw, then b_in . skw (0 before voxel 0)
                    if i2:
                        acc = acc + product(f["w_in"][np.maximum(idx, 0)], own(f["skw"], r, jc))
                        acc = acc + product(f["b_in"][None], own(f["skw"], r, jc))
                else:
                    acc = acc + xw[r]
                xw[r] = acc
        tot = gather([own(dfin[rows], r, jc) + hf[r][rows] + xw[r] for r in range(n)], C)
        best, bk, bad = np.full(B, -np.inf), np.full(B, K), np.zeros(B, bool)
        for r in range(n):  # barrier; each CTA's columns, then its winners in rank order
            lg = own(f["b_out"], r, jk) + product(tot, own(f["w_out"], r, jk))
            nk = min(max(K - r * jk, 0), jk)
            lg = lg[:, :nk]
            logits[:, i2, r * jk:r * jk + nk] = lg
            z = lg / tau + gum[i2][:, r * jk:r * jk + nk]
            for b in range(B):
                bad[b] |= not np.isfinite(lg[b]).all()
                if nk and z[b].max() > best[b]:  # the first of equal z stays
                    best[b], bk[b] = z[b].max(), r * jk + int(np.argmax(z[b]))
        idx = np.asarray(forced)[:, i2].astype(np.int64) if forced is not None \
            else np.where(bad, -1, bk)
        out[:, i2] = idx
    return out, vhc.reshape(L, B, s2, br), logits


def _emulate_k6(st, d2h, d2w, cnd, dfin, sprev, vhc, gum, i1, tau, forced=None):
    """numpy transcription of csrc/row_decode.cu (float64). Phase 1 per
    position, leaving pre2 = d2w + h2w + s[2] over d2w and pre4 = cond + s[4]
    over the condition (flat offsets (li s2 + p) br). Phase 2 in a group of
    MAXC / 2 lanes (MAXC 16 at C=16 br=4 K=128, else 32), lane q holding
    channels 2q and 2q + 1: the C -> br partial sums per lane,
    summed over the group; the width taps' cached half v . wk[0] written by
    the voxel before into the part buffer of the next voxel's parity (slots of
    (br + 3) & ~3); layer 0's skip conv over the embedding in shared memory;
    the final channels through shared memory into the logits."""
    f = {k: np.asarray(t, np.float64).ravel() for k, t in st.items()}
    L, B, s2, br = d2w.shape
    C, K = dfin.shape[-1], gum.shape[-1]
    exact = (C, br, K) == (16, 4, 128)
    nl = (16 if exact else 32) // 2
    cpl = 2
    bs = (br + 3) & ~3
    ch = np.arange(nl)[:, None] * cpl + np.arange(cpl)[None]  # (lane q, register) -> channel
    cv = ch < C
    chc = np.minimum(ch, C - 1)
    d2h, d2w, vhc = (np.asarray(t, np.float64).copy() for t in (d2h, d2w, vhc))
    cnd = None if cnd is None else np.asarray(cnd, np.float64)
    dfin, sprev, gum = (np.asarray(t, np.float64) for t in (dfin, sprev, gum))
    elu, skip0 = _elu, "skw" in f
    w1, w3 = f["w1"].reshape(L, C, br), f["w3"].reshape(L, br, C)
    wk, b3 = f["wk"].reshape(L, 2, br, br), f["b3"].reshape(L, C)
    out = np.zeros((B, s2), np.int64)
    logits = np.zeros((B, s2, K))
    for b in range(B):
        pre2 = d2w[:, b].ravel().copy()  # staged d2w rows, (li s2 + p) br + j
        pre4 = cnd[:, b].ravel().copy() if cnd is not None else np.zeros(L * s2 * br)
        sp = sprev[b]
        h = np.tile(f["b_in"], (s2, 1))
        pos = (np.arange(s2)[:, None] * br + np.arange(br))  # + li s2 br
        for li in range(L):
            sc = f["sc"][li * 8:li * 8 + 8]
            r = li * s2 * br + pos
            u1 = elu((sp if li == 0 else h) + sc[0]) + sc[1]
            if li == 0 and i1 == 0:
                u1 = np.zeros_like(u1)
            tp = u1 @ f["hw1"].reshape(L, C, br)[li]
            hw = f["herfb"].reshape(L, br)[li] + tp @ f["herf"].reshape(L, br, br)[li]
            pre2[r] = pre2[r] + hw + sc[2]
            v1 = elu(tp + d2h[li, b] + sc[2]) + sc[3]
            vp = vhc[li, b].copy()
            vhc[li, b] = v1
            b2 = np.zeros((s2, br))
            hwk = f["hwk"].reshape(L, 2, 3, br, br)[li]
            for j1 in range(3):
                lo, hi = max(0, 1 - j1), min(s2, s2 + 1 - j1)  # positions p with 0 <= p + j1 - 1 < s2
                b2[lo:hi] += vp[lo + j1 - 1:hi + j1 - 1] @ hwk[0, j1]
                b2[lo:hi] += v1[lo + j1 - 1:hi + j1 - 1] @ hwk[1, j1]
            c2 = pre4[r]
            w3v1 = elu(b2 + c2 + sc[4]) + sc[5]
            pre4[r] = c2 + sc[4]
            h = f["hb3"].reshape(L, C)[li] + w3v1 @ f["hw3"].reshape(L, br, C)[li] + (
                sp @ f["hskw"].reshape(C, C) if li == 0 and skip0 else h)
        part = np.zeros((2, L * bs))
        emb = np.zeros(C)
        bin_r = np.where(cv, f["b_in"][chc], 0.0)
        sprev_r = np.zeros((nl, cpl))
        for i2 in range(s2):
            rd, wr = i2 & 1, (i2 + 1) & 1
            w = bin_r.copy()
            for li in range(L):
                sc = f["sc"][li * 8:li * 8 + 8]
                u = elu((sprev_r if li == 0 else w) + sc[0]) + sc[1]
                if li == 0 and i2 == 0:
                    u = np.zeros_like(u)
                t = np.einsum("qc,qcj->qj", u, np.where(cv[..., None], w1[li][chc], 0.0)).sum(0)
                r = (li * s2 + i2) * br + np.arange(br)
                v = elu(t + pre2[r]) + sc[3]
                b2 = part[rd, li * bs:li * bs + br] + v @ wk[li, 1]
                part[wr, li * bs:li * bs + br] = v @ wk[li, 0]
                w3v = elu(b2 + pre4[r]) + sc[5]
                o = np.where(cv, b3[li][chc], 0.0) + np.einsum(
                    "o,oqc->qc", w3v, np.where(cv[None], w3[li][:, chc], 0.0))
                if li == 0 and skip0:
                    w = o + np.einsum("c,cqk->qk", emb,
                                      np.where(cv[None], f["skw"].reshape(C, C)[:, chc], 0.0))
                else:
                    w = np.where(cv, o + w, 0.0)
            tot = np.zeros(C)
            tot[ch[cv]] = dfin[b, i2, ch[cv]] + h[i2, ch[cv]] + w[cv]
            lg = f["b_out"] + tot @ f["w_out"].reshape(C, K)
            logits[b, i2] = lg
            if forced is not None:
                idx = int(forced[b, i2])
            else:
                idx = int(np.argmax(lg / tau + gum[i2, b])) if np.isfinite(lg).all() else -1
            out[b, i2] = idx
            e = max(idx, 0)
            sprev_r = np.where(cv, f["w_in"].reshape(K, C)[e][chc] + bin_r, 0.0)
            emb[ch[cv]] = sprev_r[cv]
    return out, vhc, logits


@pytest.mark.parametrize("c,br,k,b,cond,l0_skip", [(16, 4, 128, 1, True, True),
                                                   (16, 4, 128, 2, False, False),
                                                   (12, 3, 40, 1, False, True),
                                                   (12, 3, 40, 2, True, True)])
def test_k6_chain_lanes_and_offsets(c, br, k, b, cond, l0_skip):
    """The narrow K6's phase-1 addends, lane groups (8 lanes of 2 channels at
    the published widths, 16 of 2 otherwise), cached tap halves, shared
    embedding and final channels, transcribed, against row_decode_plain at
    3 layers: teacher-forced logits and caches within 1e-5 of max|ref|,
    free-running indices equal."""
    st, rows, dfin, sprev = _k6_row(c, br, k, 3, b, 5, cond, l0_skip, 3 * c + b, "cpu")
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    gum = draw_gumbel((5, b, k), torch.Generator().manual_seed(6), "cpu")
    forced = torch.randint(0, k, (b, 5), generator=torch.Generator().manual_seed(7))
    for frc, i1 in ((forced, 2), (None, 2), (None, 0)):
        vp = vhc0.clone()
        sp = sprev if i1 else torch.zeros_like(sprev)
        want = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sp, vp, gum, i1, 0.5,
                                           forced_idx=frc)
        idx, vh, lg = _emulate_k6(st, d2h, d2w, cnd, dfin, sp, vhc0, gum, i1, 0.5, frc)
        np.testing.assert_array_equal(idx, want[0].numpy())
        assert np.abs(vh - vp.numpy()).max() <= 1e-5 * float(vp.abs().max())
        if frc is not None:
            assert np.abs(lg - want[2].numpy()).max() <= 1e-5 * float(want[2].abs().max())


@pytest.mark.parametrize("c,br,k,cond,s2", [(64, 16, 32, True, 3), (96, 32, 40, False, 2)])
def test_k6_wide_offsets_and_partials(c, br, k, cond, s2):
    """The wide K6's partition at the cluster size the wrapper picks (column
    slices, exchanges, strided parts, the argmax across the CTAs),
    transcribed, against row_decode_plain: teacher-forced logits and caches
    within 1e-5 of max|ref|, free-running indices equal."""
    st, rows, dfin, sprev = _k6_row(c, br, k, 3, 2, s2, cond, True, c + br, "cpu")
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    gum = draw_gumbel((s2, 2, k), torch.Generator().manual_seed(4), "cpu")
    forced = torch.randint(0, k, (2, s2), generator=torch.Generator().manual_seed(5))
    n = decode_row.WIDE_CLUSTER
    for frc in (forced, None):
        vp = vhc0.clone()
        want = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sprev, vp, gum, 2, 0.5,
                                           forced_idx=frc)
        idx, vh, lg = _emulate_k6_wide(st, d2h, d2w, cnd, dfin, sprev, vhc0, gum, 2, 0.5, frc, n)
        np.testing.assert_array_equal(idx, want[0].numpy())
        assert np.abs(vh - vp.numpy()).max() <= 1e-5 * float(vp.abs().max())
        if frc is not None:
            assert np.abs(lg - want[2].numpy()).max() <= 1e-5 * float(want[2].abs().max())


@pytest.mark.parametrize("c,br,k,b,cond,s2,n,l0_skip", [
    (64, 16, 32, 3, True, 3, 16, True),
    (96, 32, 40, 1, False, 1, 8, True),
    (64, 32, 32, 3, False, 3, 8, False),
    (96, 16, 40, 1, True, 3, 16, True),
    (72, 24, 30, 3, True, 3, 16, True),   # n divides none of C, br, K: ranks 12-15 own no br column
    (40, 20, 30, 1, False, 3, 8, True),   # br and K past n's multiple
])
def test_k6_wide_cluster_partition(c, br, k, b, cond, s2, n, l0_skip):
    """The wide K6's cluster partition, transcribed, at both cluster sizes:
    ceil column splits (widths n does not divide leave the last CTAs short
    or empty), the gathers after each exchange, phase 1 a few positions at a
    time, the products' strided parts, the cached tap halves, the argmax per
    CTA and across the CTAs in rank order, the caches written in place, at
    i1 = 0 and 2; against row_decode_plain: teacher-forced logits and caches
    within 1e-5 of max|ref|, free-running indices equal."""
    st, rows, dfin, sprev = _k6_row(c, br, k, 3, b, s2, cond, l0_skip, c * b + br, "cpu")
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    gum = draw_gumbel((s2, b, k), torch.Generator().manual_seed(8), "cpu")
    forced = torch.randint(0, k, (b, s2), generator=torch.Generator().manual_seed(9))
    for frc, i1 in ((forced, 2), (None, 2), (None, 0)):
        vp = vhc0.clone()
        sp = sprev if i1 else torch.zeros_like(sprev)
        want = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sp, vp, gum, i1, 0.5,
                                           forced_idx=frc)
        idx, vh, lg = _emulate_k6_wide(st, d2h, d2w, cnd, dfin, sp, vhc0, gum, i1, 0.5, frc, n)
        np.testing.assert_array_equal(idx, want[0].numpy())
        assert np.abs(vh - vp.numpy()).max() <= 1e-5 * float(vp.abs().max())
        if frc is not None:
            assert np.abs(lg - want[2].numpy()).max() <= 1e-5 * float(want[2].abs().max())


def test_k6_wide_cluster_size_and_layout():
    """The wide kernel's cluster size, CTA width and mbarrier count are the
    CUDA source's constants; a row it does not take as it is (C or br no
    multiple of 4, more batch rows than a CTA's threads) is padded to
    multiples of 4 and split into sub-batches of at most a CTA's threads by
    the wrapper before any launch."""
    src = (Path(decode_row.__file__).parent.parent / "csrc" / "row_decode_wide.cu").read_text()
    assert f"constexpr int NT = {decode_row.WIDE_THREADS};" in src
    assert f"constexpr int kCluster = {decode_row.WIDE_CLUSTER};" in src
    assert f"constexpr int kMbars = {decode_row.WIDE_MBARS};" in src
    assert decode_row.wide_row_batches(51, 20, 2, 512, 128, 512) == ((0, 20),)
    for (b, c, br), plan in (((2, 66, 16), ((0, 2),)), ((2, 64, 18), ((0, 2),)),
                             ((257, 64, 16), ((0, 256), (256, 257)))):
        cp, brp = decode_row._align4(c), decode_row._align4(br)
        assert cp % 4 == 0 and brp % 4 == 0 and cp - c < 4 and brp - br < 4
        assert decode_row.wide_row_batches(2, b, 1, cp, brp, 32) == plan


def test_k6_wide_batch_plan_at_the_published_widths():
    """The transcription of layout() at an H100's 232,448 bytes: the mid
    prior (46 layers, C 256, br 64, s2 8, K 256) takes B <= 21, the bottom
    prior (51, 512, 128, 2, 512) B <= 20 (228,016 bytes); the published
    batches (10, 20) run as one call, larger ones as the largest sub-batches
    that fit, in order; a row that does not fit at B = 1 stays one call,
    which the kernel refuses."""
    mid, bottom = (46, 8, 256, 64, 256), (51, 2, 512, 128, 512)
    lay = decode_row.wide_layout_bytes
    assert decode_row.WIDE_SMEM_OPTIN == 232448
    assert lay(51, 20, 2, 512, 128, 512) == 228016
    for (L, s2, c, br, k), most in ((mid, 21), (bottom, 20)):
        assert lay(L, most, s2, c, br, k) <= 232448 < lay(L, most + 1, s2, c, br, k)
    plan = decode_row.wide_row_batches
    assert plan(46, 10, 8, 256, 64, 256) == ((0, 10),)
    assert plan(51, 20, 2, 512, 128, 512) == ((0, 20),)
    assert plan(46, 32, 8, 256, 64, 256) == ((0, 21), (21, 32))
    assert plan(51, 24, 2, 512, 128, 512) == ((0, 20), (20, 24))
    assert plan(3, 20, 256, 128, 64, 40) == ((0, 20),)  # does not fit at B = 1


@pytest.mark.parametrize("c,br,k,b,cond,s2,limit", [
    (40, 10, 30, 3, True, 8, None),     # br padded to 12
    (66, 16, 32, 2, False, 3, None),    # C padded to 68
    (63, 21, 32, 2, True, 3, None),     # C and br padded to 64 and 24
    (64, 16, 32, 257, False, 1, None),  # more batch rows than a CTA's threads
    (64, 16, 32, 7, True, 3, 3),        # a shared memory that fits 3 rows: 3 + 3 + 1
    (40, 10, 30, 5, True, 4, 2),        # padded and split
])
def test_k6_wide_split_and_padded_rows_equal_one_call(c, br, k, b, cond, s2, limit):
    """``wide_row_decode`` with ``row_decode_plain`` as its step (the
    kernel's launch on a card) against one unpadded, unsplit
    ``row_decode_plain`` call on the whole batch: indices equal, logits
    and caches within 1e-5 of max|ref| (zero-padded channels add zeros;
    batch rows are independent), teacher-forced and free-running."""
    st, rows, dfin, sprev = _k6_row(c, br, k, 3, b, s2, cond, True, c + b + s2, "cpu")
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    lim = decode_row.WIDE_SMEM_OPTIN if limit is None else decode_row.wide_layout_bytes(
        3, limit, s2, decode_row._align4(c), decode_row._align4(br), k)
    plan = decode_row.wide_row_batches(3, b, s2, decode_row._align4(c), decode_row._align4(br),
                                       k, lim)
    assert len(plan) == (1 if limit is None and b <= 256 else -(-b // (limit or 256)))
    gum = draw_gumbel((s2, b, k), torch.Generator().manual_seed(5), "cpu")
    forced = torch.randint(0, k, (b, s2), generator=torch.Generator().manual_seed(6))
    for frc in (forced, None):
        vs, vp = vhc0.clone(), vhc0.clone()
        got = decode_row.wide_row_decode(decode_row.row_decode_plain, st, d2h, d2w, cnd, dfin,
                                         sprev, vs, gum, 2, 0.5, frc, lim)
        want = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sprev, vp, gum, 2, 0.5,
                                           forced_idx=frc)
        assert got[1] is vs
        assert torch.equal(got[0], want[0])
        pairs = [(vs, vp)] + ([(got[2], want[2])] if frc is not None else [])
        for a, r in pairs:
            assert a.shape == r.shape
            assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c,shape", [(2, (9, 7, 20)), (8, (5, 6, 17)), (10, (4, 4, 8)),
                                     (18, (9, 7, 20)), (72, (5, 3, 6)), (256, (3, 2, 2)),
                                     (32, (8, 8, 2))])
def test_k3_fused_forward_on_card(cuda_device, c, shape, pad_mode, monkeypatch):
    """K3's bf16 forward on its fused routes (``stack_fwd_route``: the tensor
    cores for Cb >= 5, the CUDA cores below) against the plain stack within
    3e-2 of max|ref| (as the three kernels), bit-identical on a second call;
    the CUDA-core brick computes in the three kernels' order, so it equals
    them bit for bit."""
    rng = np.random.default_rng(400 + c)
    ws = tuple(t.to(cuda_device) for t in _stack(rng, 3, c, std=0.1))
    x = torch.from_numpy(rng.standard_normal((2, c, *shape)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    cb = max(c // 2, 1)
    route = conv3d.stack_fwd_route(torch.bfloat16, cb)
    assert route == ("fused_tc" if cb >= 5 else "fused_cc")
    launches = stack_kernel.preact_stack_fused.launches
    with torch.inference_mode():
        got = stack_kernel.preact_stack_fused(x, *ws, pad_mode)
        again = stack_kernel.preact_stack_fused(x, *ws, pad_mode)
        with monkeypatch.context() as m:  # the three kernels' route
            m.setattr(stack_kernel, "stack_fwd_route", lambda dtype, cb: "three_kernels")
            parent = stack_kernel.preact_stack_fused(x, *ws, pad_mode)
        want = stack_kernel.preact_stack_plain(x, *ws, pad_mode=pad_mode)
    torch.cuda.synchronize()
    assert stack_kernel.preact_stack_fused.launches == launches + 9  # 3 calls x 3 blocks
    assert torch.equal(got, again), "two identical calls differ"
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 3e-2 * scale
    if route == "fused_cc":
        assert torch.equal(got, parent)


# the three lookups of a 512x512x128 volume, then ragged N, K = 1 and D in {1, 3, 32}
K1_CARD_SHAPES = [(524288, 128, 2), (8192, 256, 8), (128, 512, 32), (1, 1, 1), (255, 1, 3),
                  (257, 1, 32), (100003, 1, 3), (1, 7, 32), (255, 37, 3), (257, 300, 1),
                  (100003, 200, 3), (100003, 64, 32), (257, 512, 32)]


def _k1_planted(n, k, d, seed, device):
    """Random rows and codes with exact ties planted: codes 0 and 2 set to
    +6 and -6 in every column (far from the random codes) and copied to
    k - 1 and 3 (other lanes' codes at every split), and every third row of
    the first 64 next to one of them: (flat, embed, tie rows, their code)."""
    gen = torch.Generator().manual_seed(seed)
    flat = torch.randn(n, d, generator=gen)
    embed = torch.randn(k, d, generator=gen)
    pairs = [(a, b) for a, b in ((0, k - 1), (2, 3)) if a < b < k]
    for (a, b), v in zip(pairs, (6.0, -6.0)):
        embed[a] = v
        embed[b] = embed[a]
    rows = torch.arange(0, min(n, 64), 3) if pairs else torch.arange(0)
    codes = torch.tensor([pairs[i % len(pairs)][0] for i in range(len(rows))], dtype=torch.long)
    flat[rows] = embed[codes] + 1e-3 * torch.randn(len(rows), d, generator=gen)
    return flat.to(device), embed.to(device), rows.to(device), codes.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", K1_CARD_SHAPES + [(257, 100, 64), (100003, 512, 64)])
def test_k1_kernel_matches_plain_on_card(cuda_device, n, k, d):
    """K1a: indices equal to the plain version's except at genuine ties, the
    planted exact ties to the lowest code as the plain version, one launch a
    call."""
    flat, embed, rows, codes = _k1_planted(n, k, d, n + d, cuda_device)
    launches = quantizer_ops.l2_argmin.launches
    got = quantizer_ops.l2_argmin(flat, embed)
    want = quantizer_ops.l2_argmin_plain(flat, embed)
    torch.cuda.synchronize()
    assert quantizer_ops.l2_argmin.launches == launches + 1
    assert got.dtype == torch.int64 and tuple(got.shape) == (n,)
    assert torch.equal(got[rows], codes) and torch.equal(want[rows], codes)
    _, real = quantizer_ops.genuine_ties(flat, embed, got, want)
    assert real.numel() == 0, f"{real.numel()} rows disagree beyond a tie"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18, 72, 256])
def test_k3_kernel_matches_plain_on_card(cuda_device, c, pad_mode, dtype):
    rng = np.random.default_rng(300 + c)
    w1s, w2s, w3s, sc8 = (t.to(cuda_device) for t in _stack(rng, 4, c, std=0.1))
    x = torch.from_numpy(rng.standard_normal((1, c, 12, 10, 6)).astype(np.float32))
    x = x.to(cuda_device, dtype)
    launches = stack_kernel.preact_stack_fused.launches
    with torch.inference_mode():
        got = stack_kernel.preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode)
        want = stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode)
    torch.cuda.synchronize()
    assert stack_kernel.preact_stack_fused.launches == launches + 4
    assert got.dtype == dtype and got.shape == x.shape
    scale = float(want.float().abs().max())
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", K1_CARD_SHAPES)
def test_k1b_kernel_matches_plain_on_card(cuda_device, n, k, d):
    """K1b: indices as K1a's test; counts exact and dw within 1e-5 of
    max|dw| against the plain statistics of the kernel's own indices (and
    equal counts where the indices agree); bit-identical on a second call."""
    flat, embed, rows, codes = _k1_planted(n, k, d, n + d + 1, cuda_device)
    launches = quantizer_ops.l2_argmin_stats.launches
    idx, counts, dw = quantizer_ops.l2_argmin_stats(flat, embed)
    again = quantizer_ops.l2_argmin_stats(flat, embed)
    p_idx, p_counts, p_dw = quantizer_ops.l2_argmin_stats_plain(flat, embed)
    torch.cuda.synchronize()
    assert quantizer_ops.l2_argmin_stats.launches == launches + 2
    for a, b in zip((idx, counts, dw), again):
        assert torch.equal(a, b), "two identical calls differ"
    assert torch.equal(idx[rows], codes) and torch.equal(p_idx[rows], codes)
    _, real = quantizer_ops.genuine_ties(flat, embed, idx, p_idx)
    assert real.numel() == 0, f"{real.numel()} rows disagree beyond a tie"
    if torch.equal(idx, p_idx):
        assert torch.equal(counts, p_counts)
    assert torch.equal(counts, torch.bincount(idx, minlength=k).float())
    own_dw = torch.zeros(k, d, device=cuda_device).index_add_(0, idx, flat)
    assert float((dw - own_dw).abs().max()) <= 1e-5 * float(own_dw.abs().max())
    assert float((dw - p_dw).abs().max()) <= 1e-5 * float(p_dw.abs().max()) or not torch.equal(
        idx, p_idx)


def _plain_grads(x, ws, gy, pad_mode, monkeypatch):
    monkeypatch.setattr(conv3d, "dw_conv3d", conv3d.dw_conv3d_plain)
    xr = x.detach().clone().requires_grad_()
    wr = [t.detach().clone().requires_grad_() for t in ws]
    y = stack_kernel.preact_stack_plain(xr, *wr, pad_mode=pad_mode)
    grads = torch.autograd.grad(y, [xr, *wr], gy)
    monkeypatch.undo()
    return grads


# the (C, spatial) of the stem-2 step's stacks whose Cb takes the brick route
# (VQVAEConfig.same_stacks of the published full config, bench.py:117-128)
K3_BRICK_SHAPES = [(16, (128, 128, 32)), (18, (128, 128, 32)), (32, (64, 64, 16)),
                   (64, (32, 32, 8)), (72, (32, 32, 8)), (16, (16, 16, 4)), (128, (16, 16, 4)),
                   (32, (8, 8, 2)), (256, (8, 8, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c,spatial", K3_BRICK_SHAPES)
def test_k3_bwd_brick_route_at_the_stem2_shapes_on_card(cuda_device, c, spatial, pad_mode,
                                                        monkeypatch):
    """K3's bf16 backward on the brick route (``stack_bwd_brick_route``) for
    one block at every (C, spatial) of the stem-2 step that takes it, against
    the autograd of the plain block per tensor within chip_smoke.py's
    K3_BWD_TOL for one bf16 block, 2^-6 of max|ref| (the plain reference
    rounds each gradient and the dW of its conv to bf16 where the kernels sum
    in fp32); a second call bit-identical; the parent's five elementwise
    kernels agree within the same tolerance."""
    cb = c // 2
    assert conv3d.stack_bwd_brick_route(torch.bfloat16, cb)
    rng = np.random.default_rng(700 + c + spatial[-1])
    ws = [t.to(cuda_device) for t in _stack(rng, 1, c, std=0.1)]
    x = torch.from_numpy(rng.standard_normal((1, c, *spatial)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    gy = torch.from_numpy(rng.standard_normal((1, c, *spatial)).astype(np.float32))
    gy = gy.to(cuda_device, torch.bfloat16)

    def grads():
        xg = x.clone().requires_grad_()
        wg = [t.clone().requires_grad_() for t in ws]
        return torch.autograd.grad(stack_kernel.preact_stack_fused(xg, *wg, pad_mode),
                                   [xg, *wg], gy)

    before = stack_kernel.preact_stack_bwd.launches
    runs = [grads(), grads()]
    with monkeypatch.context() as m:  # the parent's five elementwise kernels
        m.setattr(stack_kernel, "stack_bwd_brick_route", lambda dtype, cb: False)
        parent = grads()
    want = _plain_grads(x, ws, gy, pad_mode, monkeypatch)
    torch.cuda.synchronize()
    assert stack_kernel.preact_stack_bwd.launches == before + 3
    for name, a, a2, p, b in zip(("dx", "dw1", "dw2", "dw3", "dsc"), *runs, parent, want):
        assert torch.equal(a, a2), f"{name}: two identical backward passes differ"
        scale = float(b.float().abs().max())
        for route, g in (("brick", a), ("parent", p)):
            err = float((g.float() - b.float()).abs().max())
            assert err <= 2**-6 * scale, \
                f"{route} {name}: max|d|={err:.3g} > 2^-6 x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18, 72, 80, 256])
def test_k3_bwd_kernel_matches_plain_on_card(cuda_device, c, pad_mode, dtype, monkeypatch):
    """bf16 takes the tensor-core contractions (Cb = 1 to 128: tiles of 32
    past 32, Cb = 40 ragged against them), fp32 the CUDA cores; a volume
    inside one brick and a batch of 2 ragged against the 4 x 4 x 16 bricks
    on every axis."""
    rng = np.random.default_rng(500 + c)
    ws = [t.to(cuda_device) for t in _stack(rng, 3, c, std=0.1)]
    for shape in ((1, c, 12, 10, 6), (2, c, 9, 7, 19)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        x = x.to(cuda_device, dtype)
        gy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        gy = gy.to(cuda_device, dtype)
        before = stack_kernel.preact_stack_bwd.launches
        runs = []
        for _ in range(2):
            xg = x.clone().requires_grad_()
            wg = [t.clone().requires_grad_() for t in ws]
            y = stack_kernel.preact_stack_fused(xg, *wg, pad_mode)
            runs.append(torch.autograd.grad(y, [xg, *wg], gy))
        want = _plain_grads(x, ws, gy, pad_mode, monkeypatch)
        torch.cuda.synchronize()
        assert stack_kernel.preact_stack_bwd.launches == before + 6
        tol = 1e-4 if dtype == torch.float32 else 6e-2
        for name, a, a2, b in zip(("dx", "dw1", "dw2", "dw3", "dsc"), *runs, want):
            assert torch.equal(a, a2), f"{shape} {name}: two identical backward passes differ"
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            assert err <= tol * scale, f"{shape} {name}: max|d|={err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,spatial", [(9, 9, (18, 18, 10)), (2, 4, (34, 34, 18)),
                                              (16, 16, (10, 10, 6)), (32, 32, (6, 6, 4)),
                                              (9, 9, (68, 68, 20)), (5, 3, (9, 11, 17))])
@pytest.mark.parametrize("ksize", [(3, 3, 3), (2, 3, 3), (1, 2, 3), (1, 1, 2)])
def test_k7_kernel_matches_plain_on_card(cuda_device, cin, cout, spatial, dtype, ksize):
    """K7 (bf16: the tensor-core route) against the plain dW within 1e-5 of
    max|ref|, bit-identical on a second call; ``spatial`` is the padded
    input's, so the C = 9 case's 3x3x3 outputs are 66 x 66 x 18, ragged
    against the 4 x 4 x 16 bricks, and the last case's D extents are odd
    (staged a position a load, the others two). The kernels smaller than
    3x3x3 are the top prior's causal convs (mask 'A' and 'B')."""
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 100 + cout)
    xp = torch.randn(2, cin, *spatial, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(2, cout, *(s - k + 1 for s, k in zip(spatial, ksize)), device=cuda_device,
                    generator=gen).to(dtype)
    launches = conv3d.dw_conv3d.launches
    got = conv3d.dw_conv3d(xp, g, ksize)
    again = conv3d.dw_conv3d(xp, g, ksize)
    want = conv3d.dw_conv3d_plain(xp, g, ksize)
    torch.cuda.synchronize()
    assert conv3d.dw_conv3d.launches == launches + 2
    assert torch.equal(got, again) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _k6_row(c, br, k, n_layers, b, s2, cond, l0_skip, seed, device):
    """Stacked weights of a random PixelCNN and one row's random inputs."""
    gen = torch.Generator().manual_seed(seed)
    model = PixelCNN(PixelCNNConfig(input_dim=k, condition_dim=8 if cond else 0, model_dim=c,
                                    num_resblocks=n_layers - 1, dropout_prob=0.0,
                                    bottleneck_divisor=c // br), generator=gen)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if "branch_conv3" in name or ".bias" in name:  # Fixup zero inits
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.2)
    model.to(device)
    layers = _extract_layers(model)
    st = decode_row.stack_row_weights(layers, model.parse_input.weight, model.parse_input.bias,
                                      model.parse_output.weight, model.parse_output.bias)
    if not l0_skip:  # layer 0 as a mask-'B' layer: no skip conv, the residual added
        del st["skw"], st["hskw"]
    rows = [(torch.randn(n_layers, b, s2, br, generator=gen) * 0.5).to(device)
            for _ in range(4)]
    dfin, sprev = ((torch.randn(b, s2, c, generator=gen) * 0.5).to(device) for _ in range(2))
    return st, rows, dfin, sprev


@pytest.mark.gpu
@pytest.mark.parametrize("c,br,k", [(16, 4, 128), (12, 3, 256)])
@pytest.mark.parametrize("b,cond,l0_skip", [(1, True, True), (2, False, True), (2, True, False)])
def test_k6_kernel_matches_plain_on_card(cuda_device, c, br, k, b, cond, l0_skip):
    st, rows, dfin, sprev = _k6_row(c, br, k, 6, b, 32, cond, l0_skip, c * 10 + b, cuda_device)
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    gum = draw_gumbel((32, b, k), torch.Generator(cuda_device).manual_seed(1), cuda_device)
    forced = torch.randint(0, k, (b, 32), device=cuda_device)
    before = decode_row.row_decode.launches
    for i1 in (0, 3):
        sp = sprev if i1 else torch.zeros_like(sprev)
        vk, vp = vhc0.clone(), vhc0.clone()
        idx_k, _, lg_k = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sp, vk, gum, i1, 0.1,
                                               forced_idx=forced)
        idx_p, _, lg_p = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sp, vp, gum, i1,
                                                     0.1, forced_idx=forced)
        torch.cuda.synchronize()
        assert torch.equal(idx_k, forced.int()) and torch.equal(idx_p, forced.int())
        for name, got, want in (("logits", lg_k, lg_p), ("vhc", vk, vp)):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            assert err <= 1e-5 * scale, f"{name}: max|d|={err:.3g} > 1e-5 x {scale:.3g}"
        # free-running, the same table: the kernel's picks against the plain
        # logits along the kernel's own path
        free, _ = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sp, vhc0.clone(), gum, i1, 0.1)
        _, _, lg_path = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sp, vhc0.clone(),
                                                    gum, i1, 0.1, forced_idx=free)
        ties, beyond = decode_row.sampling_disagreements(lg_path, gum, 0.1, free)
        assert beyond == 0, f"{beyond} indices disagree beyond a near tie ({ties} ties)"
        assert int(free.min()) >= 0 and int(free.max()) < k
    assert decode_row.row_decode.launches == before + 4


@pytest.mark.gpu
def test_k6_kernel_reports_non_finite_logits(cuda_device):
    st, rows, dfin, sprev = _k6_row(16, 4, 128, 3, 1, 32, False, True, 7, cuda_device)
    st["b_out"][5] = float("nan")
    gum = draw_gumbel((32, 1, 128), torch.Generator(cuda_device).manual_seed(2), cuda_device)
    idx, _ = decode_row.row_decode(st, rows[0], rows[1], None, dfin, sprev, rows[3], gum, 2, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), torch.full((1, 32), -1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K4: the causal segment on the union stream
# ---------------------------------------------------------------------------


def _union_weights(rng, nb, c, cb8, cc, std=1.0):
    """Random stacked ``UnionWeights`` for a union of Cu = 3c, Cb = 3·cb8
    (dense: the kernels take any union weights), condition width cc (0:
    none), at a Fixup-like scale that stays stable over a few blocks."""
    cu, cb = 3 * c, 3 * cb8

    def t(*shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale * std).astype(np.float32))

    sc = t(nb, 8, scale=0.1)
    sc[:, 7] += 0.3
    return causal_kernel.UnionWeights(
        t(nb, cu, cb, scale=cu ** -0.5), t(nb, cb, scale=0.1),
        t(nb, 2, 3, 3, cb, cb, scale=(18 * cb) ** -0.5), t(nb, cb, cu, scale=cb ** -0.5),
        t(nb, cc, cb, scale=cc ** -0.5) if cc else None, t(nb, cb, scale=0.1) if cc else None,
        sc)


def _union_shifted(shape, tap, s):
    """csrc/causal_union.cuh:tap_voxel for every voxel: the index of
    v + s·(j - 1) per axis and whether it lies inside the grid."""
    b, s0, s1, s2 = shape
    v = np.arange(b * s0 * s1 * s2)
    i2, t = v % s2, v // s2
    i1, t = t % s1, t // s1
    i0, ib = t % s0, t // s0
    a, bb, c = i0 + s * (tap // 9 - 1), i1 + s * ((tap // 3) % 3 - 1), i2 + s * (tap % 3 - 1)
    inside = (a >= 0) & (a < s0) & (bb >= 0) & (bb < s1) & (c >= 0) & (c < s2)
    return ((ib * s0 + a % s0) * s1 + bb % s1) * s2 + c % s2, inside


def _k4_recompute(xv, cond, keep, denom, pk, j, vshape):
    """The forward of csrc/causal_stack.cu (and the backward's recompute)
    for block j, float64 on (nvox, C) rows: (t1, a1, t2, a2, t3, a3)."""
    b, s0, s1, s2 = vshape
    cu = xv.shape[1]
    cb = pk.be.shape[1]
    sc = pk.sc[j].numpy().astype(np.float64)
    t1 = xv + sc[0]
    a1 = _elu(t1) + sc[1]
    t2 = _grouped(a1, pk.w1[j], cb, cu) + pk.be[j].numpy() + sc[2]
    a2 = _elu(t2) + sc[3]
    acc = np.zeros((xv.shape[0], cb))
    for tap in range(18):
        nb, ok = _union_shifted(vshape, tap, 1)
        acc += _grouped(a2[nb] * ok[:, None], pk.wu[j], cb, cb, tap, ntaps=18)
    bidx = np.arange(xv.shape[0]) // (s0 * s1 * s2)
    if keep is not None:
        acc = np.where(keep[j].numpy()[bidx] > 0, acc / denom, 0.0)
    if cond is not None:
        acc = acc + _grouped(cond, pk.wc[j], cb, cond.shape[1]) + pk.bc[j].numpy()
    t3 = acc + sc[4]
    return t1, a1, t2, a2, t3, _elu(t3) + sc[5]


@pytest.mark.parametrize("c,cb8,cc,b,p", [(16, 4, 16, 1, 0.0), (3, 1, 0, 2, 0.0),
                                          (8, 4, 5, 2, 0.5)])
def test_k4_packed_layout_and_indexing(c, cb8, cc, b, p):
    rng = np.random.default_rng(700 + c)
    nb, vshape = 2, (b, 3, 4, 5)
    w = _union_weights(rng, nb, c, cb8, cc)
    cu, cb = 3 * c, 3 * cb8
    x = torch.from_numpy(rng.standard_normal((*vshape, cu)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((*vshape, cu)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((*vshape, cc)).astype(np.float32)) if cc else None
    keep = torch.from_numpy((rng.random((nb, b, cb)) < 0.5).astype(np.float32)) if p else None
    denom = 1.0 - p
    pk = causal_kernel.pack_kernel_weights(w, torch.float32)
    w1t, wut, w3t, wct = causal_kernel.pack_kernel_weights_t(w, torch.float32)
    cv = None if cond is None else cond.reshape(-1, cc).numpy().astype(np.float64)
    # forward: fwd_pre, fwd_conv, fwd_post block by block
    saves, cur = [], x.reshape(-1, cu).numpy().astype(np.float64)
    for j in range(nb):
        saves.append(cur)
        *_, a3 = _k4_recompute(cur, cv, keep, denom, pk, j, vshape)
        sc = pk.sc[j].numpy()
        cur = _grouped(a3, pk.w3[j], cu, cb) * sc[7] + sc[6] + cur
    want = causal_kernel.causal_stack_plain(x, cond, keep, p, w)
    np.testing.assert_allclose(cur.reshape(want.shape), want.numpy(), atol=1e-5, rtol=0)
    # backward: bwd_pre .. bwd_dx and the contractions, last block first
    g = gy.reshape(-1, cu).numpy().astype(np.float64)
    gcond = None if cond is None else np.zeros_like(cv)
    outs = [None] * nb
    bidx = np.arange(g.shape[0]) // (vshape[1] * vshape[2] * vshape[3])
    for j in reversed(range(nb)):
        t1, a1, t2, a2, t3, a3 = _k4_recompute(saves[j], cv, keep, denom, pk, j, vshape)
        sc = pk.sc[j].numpy()
        gu = g * sc[7]
        ga3 = _grouped(gu, w3t[j], cb, cu)
        gt3 = ga3 * _elu_grad(t3)
        gm = gt3 if keep is None else np.where(keep[j].numpy()[bidx] > 0, gt3 / denom, 0.0)
        if cond is not None:
            gcond = gcond + _grouped(gt3, wct[j], cc, cb)
        u3 = _grouped(a3, pk.w3[j], cu, cb)
        ga2 = np.zeros_like(gm)
        dwu = np.zeros((18, cb, cb))
        for tap in range(18):
            src, ok = _union_shifted(vshape, tap, -1)
            ga2 += _grouped(gm[src] * ok[:, None], wut[j], cb, cb, tap, ntaps=18)
            nbr, ok = _union_shifted(vshape, tap, 1)
            dwu[tap] = gm.T @ (a2[nbr] * ok[:, None])
        gt2 = ga2 * _elu_grad(t2)
        ga1 = _grouped(gt2, w1t[j], cu, cb)
        gt1 = ga1 * _elu_grad(t1)
        dsc = [gt1.sum(), ga1.sum(), gt2.sum(), ga2.sum(), gt3.sum(), ga3.sum(), g.sum(),
               (g * u3).sum()]
        outs[j] = (gt2.T @ a1, gt2.sum(0), dwu, gu.T @ a3,
                   gt3.T @ cv if cond is not None else np.zeros((cb, 1)), gt3.sum(0), dsc)
        g = g + gt1
    got = causal_kernel.kernel_grads_to_union(
        *(torch.from_numpy(np.stack(t)) for t in zip(*outs)), cond is not None)
    saved = torch.stack([torch.from_numpy(sv.reshape(*vshape, cu).astype(np.float32))
                         for sv in saves])
    ref = causal_kernel.causal_stack_bwd_plain(saved, gy, cond, keep, p, w)
    np.testing.assert_allclose(g.reshape(gy.shape), ref[0].numpy(), atol=1e-5, rtol=0)
    if cond is not None:
        np.testing.assert_allclose(gcond.reshape(cond.shape), ref[1].numpy(), atol=1e-5,
                                   rtol=0)
    for name, a, r in zip(("dw1e", "dbe", "dwu", "dw3", "dwc", "dbc", "dsc"), got, ref[2:]):
        if r is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5 * float(r.abs().max()),
                                   rtol=0, err_msg=name)


K4_CASES = [  # (c, cb8, cc, batch, grid, p): the top prior's widths, odd grids, B=2,
    (16, 4, 16, 1, (7, 6, 5), 0.0),  # no condition, a keep mask, a narrow union
    (16, 4, 0, 2, (4, 5, 3), 0.0),
    (8, 4, 8, 2, (5, 3, 6), 0.5),
    (6, 1, 6, 1, (3, 5, 4), 0.0),
]


def _k4_inputs(case, dtype, device, seed):
    c, cb8, cc, b, grid, p = case
    rng = np.random.default_rng(seed)
    w = causal_kernel.UnionWeights(*(None if t is None else t.to(device)
                                     for t in _union_weights(rng, 3, c, cb8, cc)))
    x = torch.from_numpy(rng.standard_normal((b, *grid, 3 * c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, *grid, 3 * c)).astype(np.float32))
    cond = (torch.from_numpy(rng.standard_normal((b, *grid, cc)).astype(np.float32))
            .to(device, dtype) if cc else None)
    keep = (torch.from_numpy((rng.random((3, b, 3 * cb8)) < 0.5).astype(np.float32)).to(device)
            if p else None)
    return x.to(device, dtype), g.to(device, dtype), cond, keep, p, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_k4_kernel_matches_plain_on_card(cuda_device, case, dtype):
    x, _, cond, keep, p, w = _k4_inputs(K4_CASES[case], dtype, cuda_device, 800 + case)
    launches = causal_kernel.causal_stack_fused.launches
    with torch.inference_mode():
        got = causal_kernel.causal_stack_fused(x, cond, keep, p, w)
        want = causal_kernel.causal_stack_plain(x, cond, keep, p, w)
    torch.cuda.synchronize()
    assert causal_kernel.causal_stack_fused.launches == launches + 3
    assert got.dtype == dtype and got.shape == x.shape
    scale = float(want.float().abs().max())
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_k4_bwd_kernel_matches_plain_on_card(cuda_device, case, dtype):
    x, gy, cond, keep, p, w = _k4_inputs(K4_CASES[case], dtype, cuda_device, 900 + case)

    def grads(run):
        xg = x.clone().requires_grad_()
        cg = None if cond is None else cond.clone().requires_grad_()
        wg = [None if t is None else t.clone().requires_grad_() for t in w]
        y = run(xg, cg, keep, p, causal_kernel.UnionWeights(*wg))
        ins = [xg] + ([cg] if cg is not None else []) + [t for t in wg if t is not None]
        return (y.detach(), *torch.autograd.grad(y, ins, gy))

    before = causal_kernel.causal_stack_bwd.launches
    runs = [grads(causal_kernel.causal_stack_fused) for _ in range(2)]
    want = grads(causal_kernel.causal_stack_plain)
    torch.cuda.synchronize()
    assert causal_kernel.causal_stack_bwd.launches == before + 6
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for i, (a, a2, b) in enumerate(zip(*runs, want)):
        assert torch.equal(a, a2), f"output {i}: two identical passes differ"
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * scale, f"output {i}: max|d|={err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_dropout_over_a_deep_segment_on_card(cuda_device, dtype):
    """K4 at p = 0.5 over 12 blocks at the top prior's widths (C 16, Cb 4,
    conditioned), one keep mask a block passed as data: the output and every
    gradient against the plain segment's autograd, within 1e-4 (fp32) and
    2^-4 (bf16, the rounding flips of a deep segment) of max|ref|."""
    rng = np.random.default_rng(990)
    b, grid, nb = 1, (6, 5, 7), 12
    w = causal_kernel.UnionWeights(*(None if t is None else t.to(cuda_device)
                                     for t in _union_weights(rng, nb, 16, 4, 16, std=0.5)))
    x, gy, cond = (torch.from_numpy(rng.standard_normal((b, *grid, n)).astype(np.float32))
                   .to(cuda_device, dtype) for n in (48, 48, 16))
    keep = torch.from_numpy((rng.random((nb, b, 12)) < 0.5).astype(np.float32)).to(cuda_device)

    def grads(run):
        xg, cg = x.clone().requires_grad_(), cond.clone().requires_grad_()
        wg = [None if t is None else t.clone().requires_grad_() for t in w]
        y = run(xg, cg, keep, 0.5, causal_kernel.UnionWeights(*wg))
        return (y.detach(), *torch.autograd.grad(y, [xg, cg] + [t for t in wg if t is not None],
                                                  gy))

    launches = (causal_kernel.causal_stack_fused.launches,
                causal_kernel.causal_stack_bwd.launches)
    got = grads(causal_kernel.causal_stack_fused)
    want = grads(causal_kernel.causal_stack_plain)
    torch.cuda.synchronize()
    assert (causal_kernel.causal_stack_fused.launches,
            causal_kernel.causal_stack_bwd.launches) == (launches[0] + nb, launches[1] + nb)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -4
    for i, (a, r) in enumerate(zip(got, want)):
        scale = float(r.float().abs().max())
        err = float((a.float() - r.float()).abs().max())
        assert torch.isfinite(a).all() and err <= tol * scale, f"output {i}: {err:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ksize,grid", [
    (16, (2, 3, 3), (8, 10, 9)), (16, (1, 2, 3), (8, 9, 9)), (16, (1, 1, 2), (8, 8, 9)),
    (4, (4, 5, 5), (10, 12, 11)), (4, (1, 4, 5), (7, 11, 11)), (4, (1, 1, 3), (7, 8, 9))])
def test_k7_at_the_prior_variant_shapes_on_card(cuda_device, c, ksize, grid, dtype):
    """K7 at the causal convs of the PixelCNN options at the top width: the
    Fixup blocks' C 16 -> 16 branch convs (k 3) and the k = 5 blocks' C 4 ->
    4 (kernels past 3 take the CUDA-core route in bf16 too), ``grid`` the
    padded input; within 1e-5 of max|ref|, one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(ksize) * 10 + c)
    xp = torch.randn(2, c, *grid, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(2, c, *(s - k + 1 for s, k in zip(grid, ksize)), device=cuda_device,
                    generator=gen).to(dtype)
    launches = conv3d.dw_conv3d.launches
    got = conv3d.dw_conv3d(xp, g, ksize)
    want = conv3d.dw_conv3d_plain(xp, g, ksize)
    torch.cuda.synchronize()
    assert conv3d.dw_conv3d.launches == launches + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_k4_bwd_routes_agree_on_card(cuda_device, case, monkeypatch):
    """bf16 takes the tensor-core backward at the cases' widths; it agrees with
    the CUDA-core kernels per tensor within 6e-2 of max|ref| (both round where
    the plain autograd rounds; their fp32 sums run in other orders)."""
    x, gy, cond, keep, p, w = _k4_inputs(K4_CASES[case], torch.bfloat16, cuda_device, 950 + case)
    nb, cu, cb = w.w1e.shape
    assert conv3d.causal_bwd_tensor_core_route(torch.bfloat16, cu, cb,
                                               0 if cond is None else cond.shape[-1])
    saves = torch.empty((nb, *x.shape), dtype=x.dtype, device=cuda_device)
    with torch.no_grad():
        causal_kernel._forward_cuda(x, cond, keep, p, w, saves=saves)
        tc = causal_kernel.causal_stack_bwd(saves, gy, cond, keep, p, w)
        with monkeypatch.context() as m:  # the CUDA-core kernels' route
            m.setattr(causal_kernel, "causal_bwd_tensor_core_route", lambda *shape: False)
            cc = causal_kernel.causal_stack_bwd(saves, gy, cond, keep, p, w)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(tc, cc)):
        assert (a is None) == (b is None)
        if a is not None:
            err, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
            assert err <= 6e-2 * scale, f"output {i}: max|d|={err:.3g} > 6e-2 x {scale:.3g}"


def _causal_blocks(c, bd, nb, seed):
    from vqvae3d_tpu_torch.models.causal_blocks import PreActFixupCausalResBlock

    gen = torch.Generator().manual_seed(seed)
    blocks = [PreActFixupCausalResBlock(c, c, 3, "B", bottleneck_divisor=bd, num_layers=nb + 1)
              for _ in range(nb)]
    with torch.no_grad():
        for blk in blocks:
            for prm in blk.parameters():
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.3)
    return blocks


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_is_causal_on_card(cuda_device, dtype):
    """The union tap embedding leaks no future: forward impulses through the
    no-save kernel, gradients through the backward kernel; fp32 on the
    CUDA-core kernels, bf16 on the tensor-core forward and backward."""
    c, dims = 16, (4, 5, 6)
    w = causal_kernel.UnionWeights(*(None if t is None else t.detach().to(cuda_device)
                                     for t in causal_kernel.pack_causal_union(
                                         _causal_blocks(c, 4, 3, 5))))
    assert conv3d.causal_fwd_tensor_core_route(dtype, 3 * c, 3 * c // 4, 0) == \
        (dtype == torch.bfloat16)
    x = torch.randn(1, *dims, 3 * c, device=cuda_device).to(dtype)
    with torch.inference_mode():
        base = causal_kernel.causal_stack_fused(x, None, None, 0.0, w)
    for v in [(0, 0, 0), (1, 2, 3), (3, 4, 5), (2, 0, 5)]:
        for si in range(3):
            x2 = x.clone()
            x2[0, v[0], v[1], v[2], si * c:(si + 1) * c] += 1.0
            with torch.inference_mode():
                diff = (causal_kernel.causal_stack_fused(x2, None, None, 0.0, w) - base).abs()
            moved = diff[0].reshape(*dims, 3, c).sum(-1).permute(3, 0, 1, 2).cpu() > 0
            leak = moved & ~causal_kernel.causal_influence(dims, v)[si]
            assert not leak.any(), f"input stream {si} at {v} moved {leak.nonzero()[:5].tolist()}"
            assert moved[si][v], "an input must move its own output"
    xg = x.clone().requires_grad_()
    y = causal_kernel.causal_stack_fused(xg, None, None, 0.0, w)
    for pos in [(0, 0, 0), (2, 3, 4), (3, 1, 2)]:
        reach = causal_kernel.causal_reach(dims, pos)
        for so in range(3):
            (gx,) = torch.autograd.grad(y[0, pos[0], pos[1], pos[2], so * c:(so + 1) * c].sum(),
                                        xg, retain_graph=True)
            dep = gx[0].float().abs().reshape(*dims, 3, c).sum(-1).permute(3, 0, 1, 2).cpu() > 0
            assert not (dep & ~reach[:, so]).any(), f"gradient of {pos} stream {so} leaks"


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("p", [0.0, 0.5])
@pytest.mark.parametrize("cc", [16, 0])
def test_k4_tensor_core_forward_on_card(cuda_device, cc, p, nb, monkeypatch):
    """K4's bf16 forward on the tensor-core route (tc_fwd_pre, tc_fwd_brick)
    at the top prior's widths (Cu 48, Cb 12, Cc 16 or unconditioned) over a
    9 x 10 x 33 grid (bricks overhanging every axis), p = 0 and 0.5: the
    no-save and the saving forward against ``causal_stack_plain`` within
    chip_smoke.py's K4_TOL (2^-6 of max|ref| for one block, 2^-4 for a
    stack: a flipped bf16 rounding carries through the blocks), equal to
    each other and bit-identical on a second call; the parent's CUDA-core
    kernels agree within the same tolerance."""
    rng = np.random.default_rng(1000 + cc + nb + int(10 * p))
    w = causal_kernel.UnionWeights(*(None if t is None else t.to(cuda_device)
                                     for t in _union_weights(rng, nb, 16, 4, cc)))
    b, grid = 2, (9, 10, 33)
    assert conv3d.causal_fwd_tensor_core_route(torch.bfloat16, 48, 12, cc)
    x = torch.from_numpy(rng.standard_normal((b, *grid, 48)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    cond = (torch.from_numpy(rng.standard_normal((b, *grid, cc)).astype(np.float32))
            .to(cuda_device, torch.bfloat16) if cc else None)
    keep = (torch.from_numpy((rng.random((nb, b, 12)) < 0.5).astype(np.float32)).to(cuda_device)
            if p else None)
    saves = torch.empty((nb, *x.shape), dtype=x.dtype, device=cuda_device)
    launches = causal_kernel.causal_stack_fused.launches
    with torch.inference_mode():
        got = causal_kernel.causal_stack_fused(x, cond, keep, p, w)
        again = causal_kernel.causal_stack_fused(x, cond, keep, p, w)
        saving = causal_kernel._forward_cuda(x, cond, keep, p, w, saves=saves)
        with monkeypatch.context() as m:  # the parent's CUDA-core kernels
            m.setattr(causal_kernel, "causal_fwd_tensor_core_route", lambda *shape: False)
            parent = causal_kernel.causal_stack_fused(x, cond, keep, p, w)
        want = causal_kernel.causal_stack_plain(x, cond, keep, p, w)
    torch.cuda.synchronize()
    assert causal_kernel.causal_stack_fused.launches == launches + 4 * nb
    assert torch.equal(got, again), "two identical calls differ"
    assert torch.equal(got, saving), "the saving forward differs from the no-save one"
    assert torch.equal(saves[0], x)
    tol = 2**-6 if nb == 1 else 2**-4
    scale = float(want.float().abs().max())
    for name, a in (("tensor-core route", got), ("parent kernels", parent)):
        err = float((a.float() - want.float()).abs().max())
        assert err <= tol * scale, f"{name}: max|d|={err:.3g} > {tol} x {scale:.3g}"


def _qkv(n, s, d, seed, device, dtype):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(n, s, d, generator=gen).to(device, dtype) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 77, 128, 300, 4096])
def test_k8_kernel_matches_plain_on_card(cuda_device, s, d, dtype):
    """K8 forward and backward against the plain versions: fp32 (the
    CUDA-core routes) against the autograd of ``flash_causal_attention_plain``
    within 1e-5 of max|ref| (the same fp32 math summed in another order);
    bf16 (the tensor-core routes) against ``flash_causal_attention_plain``
    (o) and ``flash_attention_bwd_plain`` on the kernel's o and
    ``causal_lse_plain`` (dq, dk, dv) within 1e-2 (both round P for P.V, P
    for dv and ds for dk and dq where the TPU kernel rounds them, and o and
    the gradients once; a flip of a rounding is 2^-8 of the value); a second
    call bit-identical.

    At S = 1 and bf16, dq and dk are zero in exact arithmetic (ds = P (do.v
    - delta), delta = do.o, o = v), and each side holds only the residue of
    two D-term fp32 sums of the same exact products taken in different
    orders: at most 2 (D - 1) 2^-24 sum|do v| on the plain side and twice
    that on the tensor cores (which may truncate), to first order. There the
    bound is that residue times sm_scale and max|k| (dq) or max|q| (dk), by
    1.01 for the roundings of ds and the output, when it exceeds the
    relative one."""
    q, k, v = _qkv(6, s, d, s * 10 + d, cuda_device, dtype)
    g = _qkv(6, s, d, s * 10 + d + 1, cuda_device, dtype)[0]
    scale = d ** -0.5
    tol = 1e-5 if dtype == torch.float32 else 1e-2

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv, scale)
        return (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), g))

    fwd, bwd = flash_attention.flash_causal_attention.launches, flash_attention.flash_attention_bwd.launches
    got, again = run(flash_attention.flash_causal_attention), run(flash_attention.flash_causal_attention)
    torch.cuda.synchronize()
    assert flash_attention.flash_causal_attention.launches == fwd + 2
    assert flash_attention.flash_attention_bwd.launches == bwd + 2
    if dtype == torch.float32:
        want = run(flash_attention.flash_causal_attention_plain)
    else:
        lse = flash_attention.causal_lse_plain(q, k, scale)
        want = (flash_attention.flash_causal_attention_plain(q, k, v, scale),
                *flash_attention.flash_attention_bwd_plain(q, k, v, got[0], lse, g, scale))
    residue = 6 * (d - 1) * 2**-24 * float((g.float() * v.float()).abs().sum(-1).max()) * scale * 1.01
    for name, a, b, r in zip(("o", "dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and torch.equal(a, b), f"{name} not bit-identical"
        err, scale_ = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
        bound = tol * scale_
        if s == 1 and dtype == torch.bfloat16 and name in ("dq", "dk"):
            bound = max(bound, residue * float((k if name == "dq" else q).float().abs().max()))
        assert err <= bound, f"{name}: max|d|={err:.3g} > {bound:.3g} (max|ref| {scale_:.3g})"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_is_causal_on_card(cuda_device, dtype):
    """The gradient of query row i is exactly zero on every key and value row
    after i, and a key or value after i never moves o[i]; at both dtypes, so
    both forward routes (bf16: the tensor cores) are held to it."""
    q, k, v = _qkv(2, 150, 8, 3, cuda_device, dtype)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attention.flash_causal_attention(qq, kk, vv, 8 ** -0.5)
    for i in (0, 63, 64, 149):
        dq, dk, dv = torch.autograd.grad(o[:, i].sum(), (qq, kk, vv), retain_graph=True)
        assert not dk[:, i + 1:].any() and not dv[:, i + 1:].any(), f"row {i} sees its future"
        assert dq[:, i + 1:].eq(0).all() and dv[:, i].abs().sum() > 0
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] += 1.0
    v2[:, 100:] -= 1.0
    with torch.no_grad():
        base = flash_attention.flash_causal_attention(q, k, v, 8 ** -0.5)
        moved = flash_attention.flash_causal_attention(q, k2, v2, 8 ** -0.5)
    assert torch.equal(base[:, :100], moved[:, :100])


@pytest.mark.gpu
@pytest.mark.parametrize("c,br,k,b,cond,s2", [(256, 64, 256, 3, True, 8),
                                              (512, 128, 512, 4, False, 2),
                                              (256, 64, 256, 10, True, 8),
                                              (512, 128, 512, 20, False, 2),
                                              (64, 16, 32, 3, True, 3),
                                              (96, 32, 40, 1, False, 1),
                                              (72, 24, 30, 3, True, 3)])
def test_k6_wide_kernel_matches_plain_on_card(cuda_device, c, br, k, b, cond, s2):
    """The wide K6 (the mid and bottom priors' widths, a few layers, at a
    small batch and at the published batches, which run the kernel's
    instantiations for those shapes; the CPU transcription's shapes, one
    whose widths the cluster of 16 does not divide) against ``row_decode_plain``: teacher-forced logits and caches
    within 1e-5 of max|ref|, free-running indices equal except at near ties,
    a second call bit-identical."""
    st, rows, dfin, sprev = _k6_row(c, br, k, 4, b, s2, cond, True, c + b, cuda_device)
    assert decode_row.uses_wide_kernel(c, br, k, s2)
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    gum = draw_gumbel((s2, b, k), torch.Generator(cuda_device).manual_seed(1), cuda_device)
    forced = torch.randint(0, k, (b, s2), device=cuda_device)
    before = decode_row.row_decode.wide_launches
    for i1 in (0, 3):
        sp = sprev if i1 else torch.zeros_like(sprev)
        vk, vp = vhc0.clone(), vhc0.clone()
        idx_k, _, lg_k = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sp, vk, gum, i1, 0.1,
                                               forced_idx=forced)
        _, _, lg_p = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sp, vp, gum, i1, 0.1,
                                                 forced_idx=forced)
        torch.cuda.synchronize()
        assert torch.equal(idx_k, forced.int())
        for name, got, want in (("logits", lg_k, lg_p), ("vhc", vk, vp)):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            assert err <= 1e-5 * scale, f"{name}: max|d|={err:.3g} > 1e-5 x {scale:.3g}"
        free, v1 = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sp, vhc0.clone(), gum, i1, 0.1)
        again, v2 = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sp, vhc0.clone(), gum, i1,
                                          0.1)
        assert torch.equal(free, again) and torch.equal(v1, v2), "two calls differ"
        _, _, lg_path = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sp, vhc0.clone(),
                                                    gum, i1, 0.1, forced_idx=free)
        ties, beyond = decode_row.sampling_disagreements(lg_path, gum, 0.1, free)
        assert beyond == 0, f"{beyond} indices disagree beyond a near tie ({ties} ties)"
    assert decode_row.row_decode.wide_launches == before + 6


@pytest.mark.gpu
@pytest.mark.parametrize("c,br,k,layers,b,cond,s2", [(256, 64, 256, 46, 32, True, 8),
                                                     (512, 128, 512, 51, 24, False, 2),
                                                     (40, 10, 64, 11, 10, True, 8),
                                                     (66, 16, 40, 4, 300, False, 3)])
def test_k6_wide_split_and_padded_rows_on_card(cuda_device, c, br, k, layers, b, cond, s2):
    """Rows the wide kernel runs as sub-batches (the mid and bottom priors at
    their full depth and B = 32, 24; B = 300 > a CTA's threads) or with
    widths padded to multiples of 4 (C 40 / br 10, C 66) against
    ``row_decode_plain`` on the whole batch: one launch per sub-batch,
    teacher-forced logits and caches within 1e-5 of max|ref|, free-running
    indices equal except at near ties, a second call bit-identical."""
    st, rows, dfin, sprev = _k6_row(c, br, k, layers, b, s2, cond, True, c + b, cuda_device)
    d2h, d2w, cnd, vhc0 = rows
    cnd = cnd if cond else None
    calls = len(decode_row.wide_row_batches(layers, b, s2, -(-c // 4) * 4, -(-br // 4) * 4, k))
    gum = draw_gumbel((s2, b, k), torch.Generator(cuda_device).manual_seed(4), cuda_device)
    forced = torch.randint(0, k, (b, s2), device=cuda_device)
    before = decode_row.row_decode.wide_launches
    vk, vp = vhc0.clone(), vhc0.clone()
    idx_k, _, lg_k = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sprev, vk, gum, 3, 0.1,
                                           forced_idx=forced)
    _, _, lg_p = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sprev, vp, gum, 3, 0.1,
                                             forced_idx=forced)
    torch.cuda.synchronize()
    assert decode_row.row_decode.wide_launches == before + calls
    assert torch.equal(idx_k, forced.int())
    for name, got, want in (("logits", lg_k, lg_p), ("vhc", vk, vp)):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 1e-5 * scale, f"{name}: max|d|={err:.3g} > 1e-5 x {scale:.3g}"
    free, v1 = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sprev, vhc0.clone(), gum, 3, 0.1)
    again, v2 = decode_row.row_decode(st, d2h, d2w, cnd, dfin, sprev, vhc0.clone(), gum, 3, 0.1)
    assert torch.equal(free, again) and torch.equal(v1, v2), "two calls differ"
    _, _, lg_path = decode_row.row_decode_plain(st, d2h, d2w, cnd, dfin, sprev, vhc0.clone(), gum,
                                                3, 0.1, forced_idx=free)
    ties, beyond = decode_row.sampling_disagreements(lg_path, gum, 0.1, free)
    assert beyond == 0, f"{beyond} indices disagree beyond a near tie ({ties} ties)"


@pytest.mark.gpu
def test_k6_wide_kernel_reports_non_finite_logits(cuda_device):
    st, rows, dfin, sprev = _k6_row(64, 16, 40, 3, 3, 3, False, True, 8, cuda_device)
    st["b_out"][39] = float("nan")  # K = 40 over 16 CTAs of 3 columns: the last owner, CTA 13
    gum = draw_gumbel((3, 3, 40), torch.Generator(cuda_device).manual_seed(2), cuda_device)
    idx, _ = decode_row.row_decode(st, rows[0], rows[1], None, dfin, sprev, rows[3].clone(), gum,
                                   2, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), torch.full((3, 3), -1, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("cond", [False, True])
def test_cached_sampler_at_kernel_size_5_on_card(cuda_device, cond, monkeypatch):
    """The k = 5 row step (no kernel; its two variants replayed as CUDA
    graphs on a card) gives the grids of the same step run eagerly and of the
    naive sampler for one Gumbel table, and launches no K6."""
    gen = torch.Generator().manual_seed(70 + cond)
    model = PixelCNN(PixelCNNConfig(input_dim=12, condition_dim=6 if cond else 0, model_dim=16,
                                    num_resblocks=3, dropout_prob=0.0, kernel_size=5),
                     generator=gen)
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(torch.randn(prm.shape, generator=gen) * 0.1)
    model = model.to(cuda_device).eval()
    dims = (3, 5, 6)
    ci = torch.randint(0, 6, (2, 1, 2, 2), generator=gen) if cond else None
    table = draw_gumbel((*dims, 2, 12), torch.Generator(cuda_device).manual_seed(71),
                        cuda_device)
    launches = decode_row.row_decode.launches
    graphs = cached_ancestral_sample(model, dims, 2, ci, 0.5, gumbel=table)
    assert decode_row.row_decode.launches == launches
    naive = ancestral_sample(model, dims, 2, ci, 0.5, gumbel=table)
    init = cached_sample.AnyKRowStep.__init__

    def eager(self, *args, **kw):
        init(self, *args, **kw)
        self.graphs = None

    monkeypatch.setattr(cached_sample.AnyKRowStep, "__init__", eager)
    assert torch.equal(graphs, cached_ancestral_sample(model, dims, 2, ci, 0.5, gumbel=table))
    assert torch.equal(graphs, naive)


@pytest.mark.gpu
def test_k6_wide_kernel_refuses_a_row_that_does_not_fit(cuda_device):
    """A row whose state does not fit a CTA's shared memory (here the h2w
    injections alone, 3 x 20 x 256 x 4 floats a CTA) is refused by the
    kernel's entry point, with no launch."""
    st, rows, dfin, sprev = _k6_row(128, 64, 40, 3, 20, 256, False, True, 9, cuda_device)
    gum = draw_gumbel((256, 20, 40), torch.Generator(cuda_device).manual_seed(3), cuda_device)
    before = decode_row.row_decode.wide_launches
    with pytest.raises(RuntimeError, match="row_decode"):
        decode_row.row_decode(st, rows[0], rows[1], None, dfin, sprev, rows[3].clone(), gum, 2,
                              0.1)
    assert decode_row.row_decode.wide_launches == before


def _k5_seed(device, a=987654321, b=2**32 - 11):
    return torch.tensor([a, b], dtype=torch.int64, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 77, 128, 300, 2049])
def test_k5_kernel_matches_plain_on_card(cuda_device, s, d, dtype):
    """K5 forward and backward against the autograd of the plain version at
    p = 0.5 (tolerances in the module docstring); a second call
    bit-identical; the collected mask equals the plain Philox mask."""
    fd = flash_dropout_attention
    q, k, v = _qkv(6, s, d, s * 10 + d, cuda_device, dtype)
    g = _qkv(6, s, d, s * 10 + d + 1, cuda_device, dtype)[0]
    scale, seed = d ** -0.5, _k5_seed(cuda_device)
    tols = (1e-5, 1e-4) if dtype == torch.float32 else (1e-2, 4e-2)

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv, scale, 0.5, seed)
        return (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), g))

    fwd, bwd = fd.flash_causal_dropout_attention.launches, fd.flash_dropout_attention_bwd.launches
    got, again = run(fd.flash_causal_dropout_attention), run(fd.flash_causal_dropout_attention)
    want = run(fd.flash_causal_dropout_attention_plain)
    torch.cuda.synchronize()
    assert fd.flash_causal_dropout_attention.launches == fwd + 2
    assert fd.flash_dropout_attention_bwd.launches == bwd + 2
    for name, a, b, r in zip(("o", "dq", "dk", "dv"), got, again, want):
        tol = tols[0] if name == "o" else tols[1]
        assert a.dtype == dtype and torch.equal(a, b), f"{name} not bit-identical"
        err, scale_ = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
        assert err <= tol * max(scale_, 1e-30), f"{name}: max|d|={err:.3g} > {tol} x {scale_:.3g}"
    if s <= 300:
        _, mask = fd.flash_causal_dropout_attention(q, k, v, scale, 0.5, seed, collect_mask=True)
        keep = fd.keep_mask(seed, 6, torch.arange(s, device=cuda_device), s, 0.5)
        tril = torch.ones(s, s, dtype=torch.bool, device=cuda_device).tril()
        assert torch.equal(mask.bool()[:, tril], keep[:, tril]) and mask[:, ~tril].eq(1).all()
        if dtype == torch.bfloat16:  # the tensor-core backward's packed tiles
            with torch.no_grad():
                o, lse = fd.flash_dropout_attention_fwd(q, k, v, seed, scale, 0.5)
                bits = fd.flash_dropout_attention_bwd(q, k, v, o, lse, g, seed, scale, 0.5,
                                                      keep_bits=True)[3]
            assert bits.shape == (6, fd.packed_tiles(s), fd.TILE_WORDS)
            assert torch.equal(fd.unpack_tile_bits(bits, s)[:, tril], keep[:, tril])


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.5, 0.9])
def test_k5_collected_mask_is_the_plain_mask_on_card(cuda_device, p):
    """Each route's collected mask (fp32: CUDA cores, bf16: tensor cores)
    equals the plain Philox mask at every logit, at three seeds."""
    fd = flash_dropout_attention
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(5, 333, 8, 1, cuda_device, dtype)
        for seed in (_k5_seed(cuda_device), _k5_seed(cuda_device, 0, 0),
                     _k5_seed(cuda_device, 7, 1)):
            _, mask = fd.flash_causal_dropout_attention(q, k, v, 0.3, p, seed, collect_mask=True)
            keep = fd.keep_mask(seed, 5, torch.arange(333, device=cuda_device), 333, p)
            want = keep | torch.ones(333, 333, dtype=torch.bool, device=cuda_device).triu(1)
            assert torch.equal(mask.bool(), want), dtype


@pytest.mark.gpu
def test_k5_at_p0_equals_k8_on_card(cuda_device):
    """At p = 0 K5 (no Philox call) is K8's function: fp32 within 1e-5 and
    bf16 within 1e-2 of max|K8| (K5's extra multiply by 1 / (1 - p) = 1 may
    round apart from K8's fused exponent argument)."""
    fd = flash_dropout_attention
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(6, 300, 16, 2, cuda_device, dtype)
        g = _qkv(6, 300, 16, 3, cuda_device, dtype)[0]

        def run(fn):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            o = fn(qq, kk, vv)
            return (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), g))

        got = run(lambda a, b, c: fd.flash_causal_dropout_attention(a, b, c, 0.25, 0.0))
        want = run(lambda a, b, c: flash_attention.flash_causal_attention(a, b, c, 0.25))
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            err, ref = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
            assert err <= tol * ref, f"{dtype} {name}: max|d|={err:.3g} > {tol} x {ref:.3g}"


@pytest.mark.gpu
def test_k5_is_causal_on_card(cuda_device):
    """The gradient of query row i is exactly zero on every key and value row
    after i, and a key or value after i never moves o[i] (the mask is a
    function of the seed alone); on both routes."""
    fd = flash_dropout_attention
    seed = _k5_seed(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(2, 150, 8, 3, cuda_device, dtype)
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fd.flash_causal_dropout_attention(qq, kk, vv, 8 ** -0.5, 0.5, seed)
        for i in (0, 63, 64, 149):
            dq, dk, dv = torch.autograd.grad(o[:, i].sum(), (qq, kk, vv), retain_graph=True)
            assert not dk[:, i + 1:].any() and not dv[:, i + 1:].any(), f"row {i} sees its future"
            # its own key may be dropped (-1e3 beside kept logits: P = 0), so
            # only its past as a whole is sure to be seen
            assert dq[:, i + 1:].eq(0).all() and dv[:, :i + 1].float().abs().sum() > 0
        k2, v2 = k.clone(), v.clone()
        k2[:, 100:] += 1.0
        v2[:, 100:] -= 1.0
        with torch.no_grad():
            base = fd.flash_causal_dropout_attention(q, k, v, 8 ** -0.5, 0.5, seed)
            moved = fd.flash_causal_dropout_attention(q, k2, v2, 8 ** -0.5, 0.5, seed)
        assert torch.equal(base[:, :100], moved[:, :100]), dtype


@pytest.mark.gpu
def test_k5_all_dropped_rows_on_card(cuda_device):
    """p = 0.999: nearly every row has all its keys dropped and averages its
    past values (the -1e3 logits tie); the kernel equals the plain version.
    fp32 within 1e-5; bf16 (the tensor cores: P = 1 exactly, o rounded
    once) within 2^-8 of each mean (plus 1e-5) and 1e-2 of max|plain|."""
    fd = flash_dropout_attention
    seed = _k5_seed(cuda_device)
    for dtype, tol_mean, tol_plain in ((torch.float32, 0.0, 1e-5),
                                       (torch.bfloat16, 2**-8, 1e-2)):
        q, k, v = _qkv(4, 200, 8, 4, cuda_device, dtype)
        o, mask = fd.flash_causal_dropout_attention(q, k, v, 0.3, 0.999, seed,
                                                    collect_mask=True)
        tril = torch.ones(200, 200, dtype=torch.bool, device=cuda_device).tril()
        dropped = ~(mask.bool() & tril).any(-1)
        assert dropped.float().mean() > 0.8
        mean_past = (torch.cumsum(v.float(), 1)
                     / torch.arange(1, 201, device=cuda_device)[None, :, None])
        err = (o.float()[dropped] - mean_past[dropped]).abs()
        assert float((err - tol_mean * mean_past[dropped].abs()).max()) <= 1e-5, dtype
        want = fd.flash_causal_dropout_attention_plain(q, k, v, 0.3, 0.999, seed)
        assert float((o.float() - want.float()).abs().max()) <= \
            tol_plain * float(want.float().abs().max()), dtype
