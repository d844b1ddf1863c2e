"""Kernel wrappers of the port (K1a/K1b codebook lookup, K3 'same'-block
stack forward and backward, K7 small-channel conv weight gradient).

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
    dW2 tap layout, the scalar shares), K1b's tile/CTA partition of the rows
    (csrc/l2_argmin_stats.cu) and K7's position offsets and output layout
    (csrc/dw_conv3d.cu), each against its plain version.
On a card (marker ``gpu``; skipped here with the reason):
  * K1 against ``l2_argmin_plain``: equal indices wherever the two best
    codes are more than 1e-5 apart (relative), at the path's three shapes;
  * K3 against ``preact_stack_plain``: fp32 within 1e-4 of max|ref| (TF32
    off), bf16 within 3e-2 of max|ref| (both round at the same points; the
    fp32 sums run in another order, which can flip a bf16 rounding, 2^-8
    relative, and a flip carries through the following blocks);
  * K1b against ``l2_argmin_stats_plain``: indices equal except at genuine
    ties, counts exact where the indices agree, dw within 1e-5 of max|dw|,
    and bit-identical on a second call;
  * the K3 backward against the autograd of ``preact_stack_plain``: dx, dW1-3
    and the scalar grads of a 3-block stack, per tensor within 1e-4 of
    max|ref| in fp32 and 6e-2 in bf16 (the reference rounds its gradients
    and cuDNN's dW to bf16, the kernel sums dW in fp32), bit-identical on a
    second call;
  * K7 against ``dw_conv3d_plain`` within 1e-5 of max|ref| in fp32 and bf16
    (bf16 products are exact in fp32; only the order of the fp32 sums
    differs), bit-identical on a second call.
"""
import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.models import blocks as tblocks
from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel


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


def _grouped(mat_rows, packed, n_out, inner, tap=None):
    """out[:, o] = mat_rows @ packed[g·G + tap·inner·cob + arange(inner)·cob + j]
    for o = g·cob + j, G = the group's slab (27·inner·cob with taps, else
    inner·cob): how every kernel reads a [G][(27)][inner][cob] pack."""
    cob = packed.shape[-1]
    flat = np.asarray(packed, np.float64).reshape(-1)
    slab, off = (inner * cob, 0) if tap is None else (27 * inner * cob, tap * inner * cob)
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


def test_k1b_tile_partition():
    """csrc/l2_argmin_stats.cu: tiles of 256 rows, CTA i takes tiles
    i, i + nblk, ...; each CTA sums its rows per code in row order, the
    partials are summed in CTA order; rows past N count nowhere."""
    rng = np.random.default_rng(3)
    n, k, d, nblk = 1000, 16, 3, 2  # 4 tiles (the last one ragged) on 2 CTAs
    flat = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    embed = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    idx = quantizer_ops.l2_argmin_plain(flat, embed).numpy()
    part = np.zeros((nblk, k, 1 + d))
    tiles = -(-n // 256)
    for cta in range(nblk):
        for t in range(cta, tiles, nblk):
            for row in range(t * 256, t * 256 + 256):
                if row < n:
                    part[cta, idx[row], 0] += 1
                    part[cta, idx[row], 1:] += flat[row].numpy()
    total = part.sum(0)
    _, counts, dw = quantizer_ops.l2_argmin_stats_plain(flat, embed)
    np.testing.assert_array_equal(total[:, 0], counts.numpy())
    np.testing.assert_allclose(total[:, 1:], dw.numpy(), atol=1e-6 * np.abs(total).max(), rtol=0)


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
            conv3d.dw_conv3d.launches)


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", [(524288, 128, 2), (8192, 256, 8), (128, 512, 32)])
def test_k1_kernel_matches_plain_on_card(cuda_device, n, k, d):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    flat = torch.randn(n, d, device=cuda_device, generator=gen)
    embed = torch.randn(k, d, device=cuda_device, generator=gen)
    got = quantizer_ops.l2_argmin(flat, embed)
    want = quantizer_ops.l2_argmin_plain(flat, embed)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and tuple(got.shape) == (n,)
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
@pytest.mark.parametrize("n,k,d", [(524288, 128, 2), (8192, 256, 8), (128, 512, 32)])
def test_k1b_kernel_matches_plain_on_card(cuda_device, n, k, d):
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    flat = torch.randn(n, d, device=cuda_device, generator=gen)
    embed = torch.randn(k, d, device=cuda_device, generator=gen)
    launches = quantizer_ops.l2_argmin_stats.launches
    idx, counts, dw = quantizer_ops.l2_argmin_stats(flat, embed)
    again = quantizer_ops.l2_argmin_stats(flat, embed)
    p_idx, p_counts, p_dw = quantizer_ops.l2_argmin_stats_plain(flat, embed)
    torch.cuda.synchronize()
    assert quantizer_ops.l2_argmin_stats.launches == launches + 2
    for a, b in zip((idx, counts, dw), again):
        assert torch.equal(a, b), "two identical calls differ"
    _, real = quantizer_ops.genuine_ties(flat, embed, idx, p_idx)
    assert real.numel() == 0, f"{real.numel()} rows disagree beyond a tie"
    if torch.equal(idx, p_idx):
        assert torch.equal(counts, p_counts)
    assert float((dw - p_dw).abs().max()) <= 1e-5 * float(p_dw.abs().max())


def _plain_grads(x, ws, gy, pad_mode, monkeypatch):
    monkeypatch.setattr(conv3d, "dw_conv3d", conv3d.dw_conv3d_plain)
    xr = x.detach().clone().requires_grad_()
    wr = [t.detach().clone().requires_grad_() for t in ws]
    y = stack_kernel.preact_stack_plain(xr, *wr, pad_mode=pad_mode)
    grads = torch.autograd.grad(y, [xr, *wr], gy)
    monkeypatch.undo()
    return grads


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18, 72, 256])
def test_k3_bwd_kernel_matches_plain_on_card(cuda_device, c, pad_mode, dtype, monkeypatch):
    rng = np.random.default_rng(500 + c)
    ws = [t.to(cuda_device) for t in _stack(rng, 3, c, std=0.1)]
    x = torch.from_numpy(rng.standard_normal((1, c, 12, 10, 6)).astype(np.float32))
    x = x.to(cuda_device, dtype)
    gy = torch.from_numpy(rng.standard_normal((1, c, 12, 10, 6)).astype(np.float32))
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
        assert torch.equal(a, a2), f"{name}: two identical backward passes differ"
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * scale, f"{name}: max|d|={err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,spatial", [(9, 9, (18, 18, 10)), (2, 4, (34, 34, 18)),
                                              (16, 16, (10, 10, 6)), (32, 32, (6, 6, 4))])
def test_k7_kernel_matches_plain_on_card(cuda_device, cin, cout, spatial, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 100 + cout)
    xp = torch.randn(2, cin, *spatial, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(2, cout, *(s - 2 for s in spatial), device=cuda_device,
                    generator=gen).to(dtype)
    launches = conv3d.dw_conv3d.launches
    got = conv3d.dw_conv3d(xp, g, (3, 3, 3))
    again = conv3d.dw_conv3d(xp, g, (3, 3, 3))
    want = conv3d.dw_conv3d_plain(xp, g, (3, 3, 3))
    torch.cuda.synchronize()
    assert conv3d.dw_conv3d.launches == launches + 2
    assert torch.equal(got, again) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
