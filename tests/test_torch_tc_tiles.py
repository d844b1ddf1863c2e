"""The tensor-core routes of K8's forward (csrc/flash_attention.cu::flash_fwd_tc),
K8's backward (csrc/flash_attention_bwd.cu::bwd_dkdv_tc, bwd_dq_tc) and K7
(csrc/dw_conv3d.cu::dw_tc), transcribed register by register in numpy, on
the CPU, where no card runs them.

The transcriptions follow the kernels' index arithmetic: the lanes' fragment
maps of mma.sync m16n8k8 / m16n8k16 (csrc/mma.cuh), ldmatrix (plain and
.trans) from the kernels' shared-memory rows at the kernels' lane
addresses, the C -> A re-pack of P, the quad reductions by xor shuffles,
the causal tile classes and the heavy-first order (K8); the bricks and
their halos, the tap split across warps, the per-brick flush and the chunk
partition (K7). The products themselves are float64, so:

  * K8 without rounding P against ``flash_causal_attention_plain`` (fp32)
    within 1e-5 of max|ref|, and with P rounded to bf16 where the kernel
    rounds it against the plain version's bf16 route within 2^-7 of
    max|ref| (one bf16 step: o rounds once, and the plain version rounds P
    at the row's final max where the kernel rounds it at each tile's running
    max), at S in {1, 63, 64, 65, 130, 300} and D in {8, 16, 32}; while the
    keys fit one tile (S <= 64) the two round P alike, and the unrounded o
    agree within 1e-4 of max|ref| (room for a flip of one P's rounding where
    the two exps differ in their last bit; without P's rounding they differ
    by ~7e-4);
  * K8's backward (K and V, or Q and dO, as A fragments; the other
    operands' B fragments by plain ldmatrix for S^T / S and dP^T / dP and by
    ldmatrix.trans for dV, dK and dQ; P^T and dS^T re-packed from C to A
    fragments, rounded to bf16 where the kernel rounds them) against
    ``flash_attention_bwd_plain`` on the same o and lse, within 1e-5 of
    max|ref| unrounded (fp32) and 1e-3 rounded (bf16, before the last
    rounding), at S in {1, 65, 130} and D in {8, 16, 32} (at S = 1, where dq
    and dk are zero in exact arithmetic, within the fp32 residue of the plain
    side's two sums in ds);
  * K7 against ``dw_conv3d_plain`` within 1e-5 of max|ref| (bf16 products
    are exact; only the order of the sums differs), at B = 2, Cin != Cout,
    output sizes that are no multiple of the bricks, and two chunk counts;
  * K3 backward's tensor-core contractions (csrc/preact_stack_bwd.cu::
    contract_tc: the bricks of gt3 and a2 with the halo by K3's index
    arithmetic, circular for 'wrap' and zero for 'zeros', the channel tiles
    past 32, the tap split, the per-brick flush and the chunk partition of
    ``stack_kernel.contract_chunks``; dW1 and dW3 over flat bricks) against
    the autograd of the plain block's conv (dW2) and the plain contraction
    (dW1, dW3) within 1e-5 of max|ref|, at Cb in {1, 9, 36, 40}, both pad
    modes, volumes that are no multiple of the brick.

This file imports no jax.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.ops import causal_kernel, conv3d, flash_attention, stack_kernel

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3  # the lane's group (row) and thread in the group


def bf16(a):
    """Round finite values to bf16, to nearest even, as cvt.rn.bf16x2.f32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


# fragment maps (csrc/mma.cuh): (rows, cols) of every lane's elements, in
# register order, two elements a register
def a_map(k):
    rows = [G, G, G + 8, G + 8] + ([G, G, G + 8, G + 8] if k == 16 else [])
    cols = [2 * T, 2 * T + 1] * 2 + ([2 * T + 8, 2 * T + 9] * 2 if k == 16 else [])
    return np.stack(rows, 1), np.stack(cols, 1)


def b_map(k):
    rows = [2 * T, 2 * T + 1] + ([2 * T + 8, 2 * T + 9] if k == 16 else [])
    return np.stack(rows, 1), np.stack([G] * len(rows), 1)


C_MAP = (np.stack([G, G, G + 8, G + 8], 1), np.stack([2 * T, 2 * T + 1] * 2, 1))


def mma(c, a, b, k):
    """d = c + A B of mma.sync.m16n8k{k}, every operand as lane fragments."""
    A, B, C = np.zeros((16, k)), np.zeros((k, 8)), np.zeros((16, 8))
    A[a_map(k)], B[b_map(k)], C[C_MAP] = a, b, c
    return (C + A @ B)[C_MAP]


def ldmatrix(smem, addr, nmat, trans):
    """ldmatrix.m8n8.x{nmat}[.trans] on flat shared memory (elements): lanes
    8m .. 8m+7 address matrix m's rows of 8; returns (32, 2 nmat), register
    m of each lane in elements 2m, 2m + 1."""
    mats = smem[addr[:8 * nmat].reshape(nmat, 8, 1) + np.arange(8)]
    if trans:
        mats = mats.transpose(0, 2, 1)
    return np.concatenate([np.stack([m[G, 2 * T], m[G, 2 * T + 1]], 1) for m in mats], 1)


def quad(v, op):
    """The kernels' two xor shuffles over the 4 lanes of a group."""
    for off in (1, 2):
        v = op(v, v[LANE ^ off])
    return v


def test_fragment_maps_cover_each_element_once():
    for k in (8, 16):
        for (rows, cols), shape in ((a_map(k), (16, k)), (b_map(k), (k, 8)), (C_MAP, (16, 8))):
            seen = np.zeros(shape, int)
            np.add.at(seen, (rows, cols), 1)
            assert (seen == 1).all()
    rng = np.random.default_rng(0)
    for k in (8, 16):
        A, B = rng.standard_normal((16, k)), rng.standard_normal((k, 8))
        np.testing.assert_allclose(mma(np.zeros((32, 4)), A[a_map(k)], B[b_map(k)], k),
                                   (A @ B)[C_MAP], atol=1e-12)


def test_ldmatrix_addresses_give_the_mma_fragments():
    """K's rows by plain ldmatrix are Q.K^T's B fragments; V's by .trans are
    P.V's; the quad of lanes of a group holds all 8 columns of its two rows,
    so the xor shuffles over 1 and 2 reduce whole rows."""
    rng = np.random.default_rng(1)
    kt = rng.standard_normal((8, 16))  # 8 keys x 16 d, row-major, stride 16
    r = ldmatrix(kt.reshape(-1), ((LANE & 7) * 16 + 8 * (LANE >> 3 & 1)), 2, False)
    np.testing.assert_array_equal(r, kt.T[b_map(16)])
    vt = rng.standard_normal((16, 8))  # 16 keys x 8 d
    r = ldmatrix(vt.reshape(-1), (LANE & 15) * 8, 2, True)
    np.testing.assert_array_equal(r, vt[b_map(16)])
    for lanes in LANE.reshape(8, 4):
        assert len({*C_MAP[0][lanes].ravel()}) == 2 and len({*C_MAP[1][lanes].ravel()}) == 8
    v = rng.standard_normal(32)
    np.testing.assert_array_equal(quad(v, np.maximum), v.reshape(8, 4).max(1).repeat(4))


def test_c_fragments_repack_as_the_a_fragment():
    """pa[kk] = (C of n-block 2 kk, C of n-block 2 kk + 1) is the A fragment
    of keys 16 kk .. 16 kk + 15: no trip through shared memory."""
    p = np.random.default_rng(2).standard_normal((16, 64))
    c = [p[:, 8 * nb: 8 * nb + 8][C_MAP] for nb in range(8)]
    for kk in range(4):
        np.testing.assert_array_equal(np.concatenate([c[2 * kk], c[2 * kk + 1]], 1),
                                      p[:, 16 * kk: 16 * kk + 16][a_map(16)])


@pytest.mark.parametrize("s", [1, 64, 65, 300])
def test_k8_tile_classes_and_heavy_first_order(s):
    """Key tiles below the diagonal need no mask, the diagonal tile masks,
    tiles above it hold no key of the query tile; the launch order (grid
    (N, S / 64), x fastest, qt = gridDim.y - 1 - y) starts blocks of
    non-increasing work."""
    nqt = -(-s // 64)
    for qt in range(nqt):
        rows = np.arange(64 * qt, 64 * qt + 64)[:, None]
        for kt in range(nqt):
            masked = np.arange(64 * kt, 64 * kt + 64)[None, :] > rows
            if kt < qt:
                assert not masked.any()
            elif kt == qt:
                assert masked.any() and not masked.all()
            else:
                assert masked.all()
    n = 3
    work = [(nqt - 1 - y) + 1 for y in range(nqt) for _ in range(n)]
    assert work == sorted(work, reverse=True)


def emulate_k8_tc(q, k, v, scale, round_p):
    """flash_fwd_tc in numpy: (o before its rounding, lse)."""
    n_, s_, d_ = q.shape
    DB, RS = d_ // 8, 8 if d_ == 8 else d_ + 8
    nqt, c = -(-s_ // 64), scale * np.log2(np.e)
    rnd = bf16 if round_p else (lambda a: a)
    o, lse = np.zeros_like(q), np.zeros((n_, s_))
    for n in range(n_):
        def qv(r, col):
            return np.where(r < s_, q[n, np.minimum(r, s_ - 1), col], 0.0)
        for y in range(nqt):
            qt = nqt - 1 - y
            for warp in range(4):
                r0 = 64 * qt + 16 * warp + G
                r1 = r0 + 8
                if d_ == 8:
                    qa = [np.stack([qv(r0, 2 * T), qv(r0, 2 * T + 1), qv(r1, 2 * T),
                                    qv(r1, 2 * T + 1)], 1)]
                else:
                    qa = [np.stack([qv(r, 16 * kk + 2 * T + hi + e) for hi in (0, 8)
                                    for r in (r0, r1) for e in (0, 1)], 1) for kk in range(DB // 2)]
                m0, m1 = np.full(32, -np.inf), np.full(32, -np.inf)
                l0, l1 = np.zeros(32), np.zeros(32)
                oacc = np.zeros((DB, 32, 4))
                for kt in range(qt + 1):
                    ks, vs = np.zeros(64 * RS), np.zeros(64 * RS)
                    for row in range(min(64, s_ - 64 * kt)):
                        ks[row * RS: row * RS + d_] = k[n, 64 * kt + row]
                        vs[row * RS: row * RS + d_] = v[n, 64 * kt + row]
                    kb = []
                    for cc in range(2 * DB):
                        m = 4 * cc + (LANE >> 3)
                        r = ldmatrix(ks, (8 * (m // DB) + (LANE & 7)) * RS + 8 * (m % DB), 4, False)
                        kb += [r[:, 2 * i: 2 * i + 2] for i in range(4)]
                    s = np.zeros((8, 32, 4))
                    for nb in range(8):
                        if d_ == 8:
                            s[nb] = mma(s[nb], qa[0], kb[nb], 8)
                        for kk in range(DB // 2):
                            s[nb] = mma(s[nb], qa[kk], np.concatenate(
                                [kb[nb * DB + 2 * kk], kb[nb * DB + 2 * kk + 1]], 1), 16)
                    if kt == qt:
                        for nb in range(8):
                            for e in range(4):
                                j = 64 * kt + 8 * nb + 2 * T + (e & 1)
                                s[nb][j > (r0 if e < 2 else r1), e] = -np.inf
                    mx0 = quad(np.maximum(m0, s[:, :, :2].max((0, 2))), np.maximum)
                    mx1 = quad(np.maximum(m1, s[:, :, 2:].max((0, 2))), np.maximum)
                    al0, al1 = np.exp2((m0 - mx0) * c), np.exp2((m1 - mx1) * c)
                    m0, m1 = mx0, mx1
                    p = np.exp2(s * c - np.stack([m0, m0, m1, m1], 1) * c)
                    l0 = l0 * al0 + p[:, :, :2].sum((0, 2))
                    l1 = l1 * al1 + p[:, :, 2:].sum((0, 2))
                    pa = [rnd(np.concatenate([p[2 * kk], p[2 * kk + 1]], 1)) for kk in range(4)]
                    oacc *= np.stack([al0, al0, al1, al1], 1)
                    if d_ == 8:
                        for kk in (0, 2):
                            r = ldmatrix(vs, (16 * kk + LANE) * RS, 4, True)
                            oacc[0] = mma(oacc[0], pa[kk], r[:, :4], 16)
                            oacc[0] = mma(oacc[0], pa[kk + 1], r[:, 4:], 16)
                    else:
                        for kk in range(4):
                            for nd in range(0, DB, 2):
                                r = ldmatrix(vs, (16 * kk + (LANE & 15)) * RS
                                             + 8 * (nd + (LANE >> 4)), 4, True)
                                oacc[nd] = mma(oacc[nd], pa[kk], r[:, :4], 16)
                                oacc[nd + 1] = mma(oacc[nd + 1], pa[kk], r[:, 4:], 16)
                l0, l1 = quad(l0, np.add), quad(l1, np.add)
                for r, l, e0, m in ((r0, l0, 0, m0), (r1, l1, 2, m1)):
                    ok = r < s_
                    for nd in range(DB):
                        for e in (0, 1):
                            o[n, r[ok], 8 * nd + 2 * T[ok] + e] = oacc[nd][ok, e0 + e] / l[ok]
                    first = ok & (T == 0)
                    lse[n, r[first]] = m[first] * scale + np.log(l[first])
    return o, lse


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 130, 300])
def test_k8_tensor_core_forward_matches_plain(s, d):
    rng = np.random.default_rng(10 * s + d)
    q, k, v = (bf16(rng.standard_normal((2, s, d))) for _ in range(3))
    scale = d ** -0.5
    logits = np.einsum("nid,njd->nij", q, k) * scale
    logits[:, ~np.tri(s, dtype=bool)] = -np.inf
    want_lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    for round_p, dtype, tol in ((False, torch.float32, 1e-5), (True, torch.bfloat16, 2**-7)):
        o, lse = emulate_k8_tc(q, k, v, scale, round_p)
        want = flash_attention.flash_causal_attention_plain(
            *(torch.tensor(a, dtype=dtype) for a in (q, k, v)), scale).double().numpy()
        err, ref = float(np.abs(o - want).max()), float(np.abs(want).max())
        assert err <= tol * ref, f"round_p={round_p}: max|d|={err:.3g} > {tol} x {ref:.3g}"
        np.testing.assert_allclose(lse, want_lse, atol=1e-6 * max(1.0, np.abs(want_lse).max()))
        if round_p and s <= 64:  # one key tile: P rounds at the same max in both
            want = flash_attention._plain_attention_fp32(
                *(torch.tensor(a, dtype=dtype) for a in (q, k, v)), scale).double().numpy()
            err, ref = float(np.abs(o - want).max()), float(np.abs(want).max())
            assert err <= 1e-4 * ref, f"unrounded o: max|d|={err:.3g} > 1e-4 x {ref:.3g}"


def a_frags(x, r0, d_):
    """The A fragments of rows r0 (per lane), r0 + 8 of x (S, D), rows past S
    as 0: csrc/flash_attention_bwd.cu::load_a, one (32, 4) or (32, 8) array a
    k-step."""
    s_ = x.shape[0]

    def xv(r, col):
        return np.where(r < s_, x[np.minimum(r, s_ - 1), col], 0.0)
    r1 = r0 + 8
    if d_ == 8:
        return [np.stack([xv(r0, 2 * T), xv(r0, 2 * T + 1), xv(r1, 2 * T), xv(r1, 2 * T + 1)], 1)]
    return [np.stack([xv(r, 16 * kk + 2 * T + hi + e) for hi in (0, 8) for r in (r0, r1)
                      for e in (0, 1)], 1) for kk in range(d_ // 16)]


def smem_rows(x, row0, d_):
    """stage_rows: rows row0 .. row0 + 63 of x at the row stride, zero past S."""
    rs = 8 if d_ == 8 else d_ + 8
    sm = np.zeros(64 * rs)
    for row in range(max(0, min(64, x.shape[0] - row0))):
        sm[row * rs: row * rs + d_] = x[row0 + row]
    return sm


def mma_abt(a, xs, d_):
    """mma_abt: C (16 x 64) = A . X^T, X's B fragments by plain ldmatrix."""
    DB, RS = d_ // 8, 8 if d_ == 8 else d_ + 8
    xb = []
    for cc in range(2 * DB):
        m = 4 * cc + (LANE >> 3)
        r = ldmatrix(xs, (8 * (m // DB) + (LANE & 7)) * RS + 8 * (m % DB), 4, False)
        xb += [r[:, 2 * i: 2 * i + 2] for i in range(4)]
    c = np.zeros((8, 32, 4))
    for nb in range(8):
        if d_ == 8:
            c[nb] = mma(c[nb], a[0], xb[nb], 8)
        for kk in range(DB // 2):
            c[nb] = mma(c[nb], a[kk], np.concatenate([xb[nb * DB + 2 * kk],
                                                      xb[nb * DB + 2 * kk + 1]], 1), 16)
    return c


def mma_px(acc, pa, xs, d_):
    """mma_px: acc (16 x D) += P (A fragments) . X, X's B fragments by
    ldmatrix.trans."""
    DB, RS = d_ // 8, 8 if d_ == 8 else d_ + 8
    if d_ == 8:
        for kk in (0, 2):
            r = ldmatrix(xs, (16 * kk + LANE) * RS, 4, True)
            acc[0] = mma(acc[0], pa[kk], r[:, :4], 16)
            acc[0] = mma(acc[0], pa[kk + 1], r[:, 4:], 16)
    else:
        for kk in range(4):
            for nd in range(0, DB, 2):
                r = ldmatrix(xs, (16 * kk + (LANE & 15)) * RS + 8 * (nd + (LANE >> 4)), 4, True)
                acc[nd] = mma(acc[nd], pa[kk], r[:, :4], 16)
                acc[nd + 1] = mma(acc[nd + 1], pa[kk], r[:, 4:], 16)
    return acc


def pack_a(c, rnd):
    """The C fragments of 8 n-blocks as the A fragments of 4 k-steps, rounded."""
    return [rnd(np.concatenate([c[2 * kk], c[2 * kk + 1]], 1)) for kk in range(4)]


def store_rows(out, acc, r0, d_):
    """store_rows: rows (r0, r0 + 8) of acc (16 x D) where they are < S."""
    for rows, e0 in ((r0, 0), (r0 + 8, 2)):
        ok = rows < out.shape[0]
        for nd in range(d_ // 8):
            for e in (0, 1):
                out[rows[ok], 8 * nd + 2 * T[ok] + e] = acc[nd][ok, e0 + e]


def emulate_k8_bwd_tc(q, k, v, o, lse, do, scale, round_bf16):
    """bwd_delta, bwd_dkdv_tc and bwd_dq_tc in numpy: (dq, dk, dv) before
    their rounding."""
    n_, s_, d_ = q.shape
    nt, c = -(-s_ // 64), scale * np.log2(np.e)
    rnd = bf16 if round_bf16 else (lambda a: a)
    delta = (do * o).sum(-1)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for n in range(n_):
        # dk, dv: key tile kt, a warp's 16 key rows
        for kt in range(nt):
            for warp in range(4):
                j0 = 64 * kt + 16 * warp + G
                ka, va = a_frags(k[n], j0, d_), a_frags(v[n], j0, d_)
                dka, dva = np.zeros((d_ // 8, 32, 4)), np.zeros((d_ // 8, 32, 4))
                for qt in range(kt, nt):
                    qs, dos = smem_rows(q[n], 64 * qt, d_), smem_rows(do[n], 64 * qt, d_)
                    cols = 64 * qt + np.arange(64)
                    ls = np.where(cols < s_, lse[n, np.minimum(cols, s_ - 1)], 0.0)
                    dls = np.where(cols < s_, delta[n, np.minimum(cols, s_ - 1)], 0.0)
                    s, dp = mma_abt(ka, qs, d_), mma_abt(va, dos, d_)
                    col = 8 * np.arange(8)[:, None, None] + 2 * T[None, :, None] + (
                        np.arange(4) & 1)[None, None]  # (nb, lane, e) -> query in the tile
                    if qt == kt:
                        key = np.where(np.arange(4) < 2, 0, 8)[None, None] + j0[None, :, None]
                        s[64 * qt + col < key] = -np.inf
                    p = np.exp2(s * c - ls[col] * np.log2(np.e))
                    ds = p * (dp - dls[col]) * scale
                    dva = mma_px(dva, pack_a(p, rnd), dos, d_)
                    dka = mma_px(dka, pack_a(ds, rnd), qs, d_)
                store_rows(dk[n], dka, j0, d_)
                store_rows(dv[n], dva, j0, d_)
        # dq: query tile qt (heavy first), a warp's 16 query rows
        for y in range(nt):
            qt = nt - 1 - y
            for warp in range(4):
                r0 = 64 * qt + 16 * warp + G
                qa, doa = a_frags(q[n], r0, d_), a_frags(do[n], r0, d_)
                rows = np.stack([r0, r0, r0 + 8, r0 + 8], 1)  # (lane, e)
                ok = rows < s_
                lb = np.where(ok, lse[n, np.minimum(rows, s_ - 1)], 0.0) * np.log2(np.e)
                dl = np.where(ok, delta[n, np.minimum(rows, s_ - 1)], 0.0)
                dqa = np.zeros((d_ // 8, 32, 4))
                for kt in range(qt + 1):
                    ks, vs = smem_rows(k[n], 64 * kt, d_), smem_rows(v[n], 64 * kt, d_)
                    s, dp = mma_abt(qa, ks, d_), mma_abt(doa, vs, d_)
                    if kt == qt:
                        key = 64 * kt + 8 * np.arange(8)[:, None, None] + 2 * T[None, :, None] + (
                            np.arange(4) & 1)[None, None]
                        s[key > rows[None]] = -np.inf
                    p = np.exp2(s * c - lb[None])
                    ds = p * (dp - dl[None]) * scale
                    dqa = mma_px(dqa, pack_a(ds, rnd), ks, d_)
                store_rows(dq[n], dqa, r0, d_)
    return dq, dk, dv


def test_transposed_b_loads_and_a_repack_of_the_backward():
    """The backward's extra fragment maps: K (16 key rows) as the A operand
    of S^T = K Q^T with Q's rows by plain ldmatrix, and Q's rows by
    ldmatrix.trans as dK's B operand; P^T's C fragments re-packed as dV's A
    fragment. Each against the matrix product it stands for."""
    rng = np.random.default_rng(3)
    for d_ in (8, 16, 32):
        kk_, qq = rng.standard_normal((16, d_)), rng.standard_normal((64, d_))
        s = mma_abt(a_frags(kk_, G, d_), smem_rows(qq, 0, d_), d_)
        want = kk_ @ qq.T
        for nb in range(8):
            np.testing.assert_allclose(s[nb], want[:, 8 * nb: 8 * nb + 8][C_MAP], atol=1e-12)
        pt = rng.standard_normal((16, 64))
        acc = mma_px(np.zeros((d_ // 8, 32, 4)), pack_a([pt[:, 8 * nb: 8 * nb + 8][C_MAP]
                                                         for nb in range(8)], lambda a: a),
                     smem_rows(qq, 0, d_), d_)
        want = pt @ qq
        for nd in range(d_ // 8):
            np.testing.assert_allclose(acc[nd], want[:, 8 * nd: 8 * nd + 8][C_MAP], atol=1e-12)


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 65, 130])
def test_k8_tensor_core_backward_matches_plain(s, d):
    """bwd_dkdv_tc and bwd_dq_tc, transcribed, against
    ``flash_attention_bwd_plain`` on the same o and lse: without rounding
    within 1e-5 of max|ref| of its fp32 route; rounding P and dS to bf16 where
    the kernel rounds them, within 1e-3 of max|ref| of its bf16 route before
    the last rounding (room for a flip of one rounding where float64 and
    fp32 exps differ in their last bit); one key tile, a ragged one and
    three tiles, so both passes' diagonal, off-diagonal and ragged tiles."""
    rng = np.random.default_rng(100 * s + d)
    q, k, v, do = (bf16(rng.standard_normal((2, s, d))) for _ in range(4))
    scale = d ** -0.5
    logits = np.einsum("nid,njd->nij", q, k) * scale
    logits[:, ~np.tri(s, dtype=bool)] = -np.inf
    mx = logits.max(-1, keepdims=True)
    lse = (np.log(np.exp(logits - mx).sum(-1, keepdims=True)) + mx)[..., 0]
    o = bf16(np.einsum("nij,njd->nid", np.exp(logits - lse[..., None]), v))
    for round_p, dtype, tol in ((False, torch.float32, 1e-5), (True, torch.bfloat16, 1e-3)):
        got = emulate_k8_bwd_tc(q, k, v, o, lse, do, scale, round_p)
        want = flash_attention._plain_bwd_fp32(
            *(torch.tensor(a, dtype=dtype) for a in (q, k, v, o)),
            torch.tensor(lse, dtype=torch.float32), torch.tensor(do, dtype=dtype), scale, rows=48)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            w = w.double().numpy()
            err, ref = float(np.abs(a - w).max()), float(np.abs(w).max())
            bound = tol * ref
            if s == 1 and name != "dv":
                # zero in exact arithmetic (ds = P (do.v - do.o), o = v): the
                # plain side holds the residue of its two D-term fp32 sums,
                # at most 2 (D - 1) 2^-24 sum|do v| to first order, times the
                # scale, max|k| (dq) or max|q| (dk) and 1.01 (ds rounded)
                other = k if name == "dq" else q
                bound = max(bound, 2 * (d - 1) * 2**-24 * float(np.abs(do * v).sum(-1).max())
                            * scale * float(np.abs(other).max()) * 1.01)
            assert err <= bound, (f"{name} round_p={round_p}: max|d|={err:.3g} > {bound:.3g} "
                                  f"(max|ref| {ref:.3g})")


def test_plain_backward_is_the_autograd_of_the_plain_forward_in_fp32():
    """At fp32 ``flash_attention_bwd_plain`` rounds nothing: it equals the
    autograd of ``flash_causal_attention_plain`` within 1e-5 of max|ref|,
    with a chunk of query rows that does not divide S."""
    gen = torch.Generator().manual_seed(4)
    q, k, v, g = (torch.randn(3, 70, 16, generator=gen) for _ in range(4))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attention.flash_causal_attention_plain(qq, kk, vv, 0.25)
    want = torch.autograd.grad(o, (qq, kk, vv), g)
    lse = flash_attention.causal_lse_plain(q, k, 0.25, rows=16)
    got = flash_attention.flash_attention_bwd_plain(q, k, v, o.detach(), lse, g, 0.25, rows=16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err, ref = float((a - w).abs().max()), float(w.abs().max())
        assert a.dtype == torch.float32 and err <= 1e-5 * ref, f"{name}: {err:.3g} / {ref:.3g}"


def emulate_k7_tc(x, g, ksize, nchunks):
    """dw_tc + dw_reduce in numpy: dW (Cout, Cin, kh, kw, kd)."""
    b_, cin, hp, wp, dp = x.shape
    cout = g.shape[1]
    kh, kw, kd = ksize
    ci8 = 8 if cin <= 8 else 16 if cin <= 16 else 32
    co16 = 16 if cout <= 16 else 32
    nbk, mbk = ci8 // 8, co16 // 16
    nbw = min(nbk, 2)
    warps = 3 * mbk * (nbk // nbw)
    xs_, gs_ = (8 if ci8 == 8 else ci8 + 8), co16 + 8
    tbh, tbw, tbd = conv3d.DW_BRICK
    xh, xw, xd = tbh + 2, tbw + 2, tbd + 2
    ho, wo, do = hp - kh + 1, wp - kw + 1, dp - kd + 1
    nb3 = (-(-ho // tbh), -(-wo // tbw), -(-do // tbd))
    nbricks = b_ * int(np.prod(nb3))
    kvol = kh * kw * kd
    part = np.zeros((nchunks, kvol, cout * cin))

    def stage(src, rows, stride, extent, chans, origin, b):
        """Rows (hh, ww, dd) of 8 channels a 16-byte row, zeros outside the
        extent; two rows (d, d + 1 of one line) a load where the D extent is
        even, bounded by the first row's position as in gather8x2."""
        rows = np.array(rows)
        pairs = extent[2] % 2 == 0
        first = np.arange(0, len(rows), 2 if pairs else 1)
        pos = rows[first] + origin
        inside = (pos < extent).all(1)
        sm = np.zeros(len(rows) * stride)
        for k in (0, 1) if pairs else (0,):
            np.testing.assert_array_equal(rows[first + k], rows[first] + [0, 0, k])
            at = tuple((pos + [0, 0, k]).T)
            for ch in range(chans):
                vals = src[b, ch][tuple(np.minimum(a, e - 1) for a, e in zip(at, extent))]
                sm[(first + k) * stride + ch] = np.where(inside, vals, 0)
        return sm

    xrows = [(h, w, d) for h in range(xh) for w in range(xw) for d in range(xd)]
    grows = [(h, w, d) for h in range(tbh) for w in range(tbw) for d in range(tbd)]
    for cta in range(nchunks):
        tot = np.zeros((warps, 9, nbw, 32, 4))
        for br in range(cta, nbricks, nchunks):  # the persistent loop
            bd, r = br % nb3[2], br // nb3[2]
            bw, r = r % nb3[1], r // nb3[1]
            bh, b = r % nb3[0], r // nb3[0]
            origin = np.array([bh * tbh, bw * tbw, bd * tbd])
            xs = stage(x, xrows, xs_, (hp, wp, dp), cin, origin, b)
            gs = stage(g, grows, gs_, (ho, wo, do), cout, origin, b)
            for warp in range(warps):
                ti, mb, nb0 = warp % 3, warp // 3 % mbk, warp // (3 * mbk) * nbw
                acc = np.zeros((9, nbw, 32, 4))
                if ti < kh:
                    for line in range(tbh * tbw):
                        hh, ww = divmod(line, tbw)
                        a = ldmatrix(gs, (line * tbd + (LANE & 7) + 8 * (LANE >> 4)) * gs_
                                     + 16 * mb + 8 * (LANE >> 3 & 1), 4, True)
                        for j in range(3):  # all 9 taps, as the kernel
                            for l in range(3):
                                xr = ((hh + ti) * xw + ww + j) * xd + l
                                if nbw == 2:
                                    bf = ldmatrix(xs, (xr + (LANE & 7) + 8 * (LANE >> 3 & 1)) * xs_
                                                  + 8 * (nb0 + (LANE >> 4)), 4, True)
                                    acc[3 * j + l, 0] = mma(acc[3 * j + l, 0], a, bf[:, :4], 16)
                                    acc[3 * j + l, 1] = mma(acc[3 * j + l, 1], a, bf[:, 4:], 16)
                                else:
                                    bf = ldmatrix(xs, (xr + (LANE & 15)) * xs_ + 8 * nb0, 2, True)
                                    acc[3 * j + l, 0] = mma(acc[3 * j + l, 0], a, bf, 16)
                tot[warp] += acc  # the per-brick flush
        for warp in range(warps):
            ti, mb, nb0 = warp % 3, warp // 3 % mbk, warp // (3 * mbk) * nbw
            if ti >= kh:
                continue
            for j in range(kw):
                for l in range(kd):
                    tap = (ti * kw + j) * kd + l
                    for w in range(nbw):
                        for e in range(4):
                            co = 16 * mb + G + 8 * (e >> 1)
                            ci = 8 * (nb0 + w) + 2 * T + (e & 1)
                            ok = (co < cout) & (ci < cin)
                            part[cta, tap, co[ok] * cin + ci[ok]] = tot[warp, 3 * j + l, w, ok, e]
    dw = np.zeros((kvol, cout * cin))
    for ch in range(nchunks):  # dw_reduce: the chunks in order
        dw += part[ch]
    return dw.reshape(kh, kw, kd, cout, cin).transpose(3, 4, 0, 1, 2)


@pytest.mark.parametrize("cin,cout,out,ksize", [
    (2, 4, (5, 6, 18), (3, 3, 3)),
    (9, 9, (5, 6, 18), (3, 3, 3)),
    (16, 16, (7, 3, 17), (3, 3, 3)),
    (32, 32, (5, 2, 3), (3, 3, 3)),
    (16, 16, (6, 5, 17), (2, 3, 3)),
    (4, 4, (3, 5, 6), (3, 3, 2)),
    (4, 4, (5, 6, 18), (1, 2, 3)),
    (4, 4, (6, 5, 17), (1, 1, 2)),
])
def test_k7_tensor_core_route_matches_plain(cin, cout, out, ksize):
    """Bricks and halos, ragged on every axis; staging by pairs of positions
    (x and g of even D extent), by single positions (odd) and mixed; the tap
    split (warp i % 3, its m- and n-blocks; all 9 taps computed, those past a
    smaller kernel not written); the chunks of ``dw_chunks`` (every brick its
    own CTA) and a persistent loop of several bricks a CTA."""
    rng = np.random.default_rng(cin * 100 + cout)
    b = 2
    x = bf16(rng.standard_normal((b, cin, *(o + k - 1 for o, k in zip(out, ksize)))))
    g = bf16(rng.standard_normal((b, cout, *out)))
    want = conv3d.dw_conv3d_plain(torch.from_numpy(x).float(), torch.from_numpy(g).float(),
                                  ksize).double().numpy()
    nchunks = conv3d.dw_chunks(b, out, ksize, torch.bfloat16)
    bricks = b * int(np.prod([-(-o // t) for o, t in zip(out, conv3d.DW_BRICK)]))
    assert nchunks == min(bricks, conv3d.DW_TC_CTAS)
    for chunks in sorted({nchunks, 3}):
        got = emulate_k7_tc(x, g, ksize, chunks)
        err, ref = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= 1e-5 * ref, f"{chunks} chunks: max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def test_k7_routes_and_chunks():
    """bf16 with every kernel axis <= 3 takes the tensor cores; fp32 and a
    larger kernel the CUDA cores, whose chunks are unchanged. The brick the
    chunks are counted in is the one the CUDA source compiles."""
    src = (Path(conv3d.__file__).parent.parent / "csrc" / "dw_conv3d.cu").read_text()
    brick = re.search(r"constexpr int TBH = (\d+), TBW = (\d+), TBD = (\d+);", src)
    assert tuple(int(v) for v in brick.groups()) == conv3d.DW_BRICK
    assert conv3d.dw_tensor_core_route(torch.bfloat16, (3, 3, 3))
    assert conv3d.dw_tensor_core_route(torch.bfloat16, (1, 2, 3))
    assert not conv3d.dw_tensor_core_route(torch.float32, (3, 3, 3))
    assert not conv3d.dw_tensor_core_route(torch.bfloat16, (4, 4, 4))
    assert conv3d.dw_chunks(1, (256, 256, 64), (3, 3, 3), torch.bfloat16) == conv3d.DW_TC_CTAS
    assert conv3d.dw_chunks(1, (16, 16, 4), (3, 3, 3), torch.bfloat16) == 16
    assert conv3d.dw_chunks(1, (256, 256, 64), (3, 3, 3), torch.float32) == 4096 // 27
    assert conv3d.dw_chunks(2, (5, 6, 7), (3, 3, 3), torch.float32) == 1


def emulate_k3_contract_tc(a, b, shape, ntaps, wrap, chunks):
    """contract_tc + contract_reduce in numpy: out (ntaps, P, Q) =
    sum_v a[v][p] b[v_t][q] over the channels-last (nvox, P) and (nvox, Q)
    scratch tensors of a (B, H, W, D) volume, v_t the forward conv's
    neighbour at tap t (ntaps = 27) or v itself (ntaps = 1)."""
    b_, h, w, d = shape
    nvox, P = a.shape
    Q = b.shape[1]
    tbh, tbw, tbd = stack_kernel.TC_BRICK
    xh, xw, xd = tbh + 2, tbw + 2, tbd + 2
    grows = tbh * tbw * tbd
    assert grows == stack_kernel.TC_FLAT_BRICK
    m16 = 16 if P <= 16 else 32
    n8 = 8 if Q <= 8 else 16 if Q <= 16 else 32
    mbk, nbk = m16 // 16, n8 // 8
    nbw = min(nbk, 2)
    tw, taps = (3, 9) if ntaps == 27 else (1, 1)
    warps = tw * mbk * (nbk // nbw)
    as_, bs_ = m16 + 8, (8 if n8 == 8 else n8 + 8)
    mtiles, ntiles = -(-P // m16), -(-Q // n8)
    assert mtiles * ntiles == int(np.ceil(P / stack_kernel.TC_TILE) * np.ceil(Q / stack_kernel.TC_TILE))
    nb3 = (-(-h // tbh), -(-w // tbw), -(-d // tbd))
    nbricks = b_ * int(np.prod(nb3)) if ntaps == 27 else -(-nvox // grows)
    part = np.zeros((chunks, ntaps, P, Q))

    def halo(c, n):  # halo_axis
        return np.where((c >= 0) & (c < n), c, np.where(wrap & (c == -1), n - 1,
                                                         np.where(wrap & (c == n), 0, -1)))

    def stage(src, vox, width, c0, stride):  # load8 rows: zero past the channels or for v < 0
        sm = np.zeros((len(vox), stride))
        n = max(0, min(width, src.shape[1] - c0))
        sm[:, :n] = np.where(vox[:, None] >= 0, src[np.maximum(vox, 0), c0:c0 + n], 0)
        return sm.ravel()

    flat = np.arange(grows)
    for tile in range(mtiles * ntiles):
        pa, qb = tile % mtiles * m16, tile // mtiles * n8
        for cta in range(chunks):
            tot = np.zeros((warps, taps, nbw, 32, 4))
            for br in range(cta, nbricks, chunks):  # the persistent loop
                if ntaps == 27:
                    bd, r = br % nb3[2], br // nb3[2]
                    bw, r = r % nb3[1], r // nb3[1]
                    bh, bb = r % nb3[0], r // nb3[0]
                    hh, ww, dd = flat // (tbd * tbw) + bh * tbh, flat // tbd % tbw + bw * tbw, \
                        flat % tbd + bd * tbd
                    avox = np.where((hh < h) & (ww < w) & (dd < d),
                                    ((bb * h + hh) * w + ww) * d + dd, -1)
                    xr = np.arange(xh * xw * xd)
                    hx = halo(bh * tbh + xr // (xd * xw) - 1, h)
                    wx = halo(bw * tbw + xr // xd % xw - 1, w)
                    dx = halo(bd * tbd + xr % xd - 1, d)
                    bvox = np.where((hx < 0) | (wx < 0) | (dx < 0), -1,
                                    ((bb * h + hx) * w + wx) * d + dx)
                else:
                    avox = np.where(br * grows + flat < nvox, br * grows + flat, -1)
                    bvox = avox
                asm = stage(a, avox, m16, pa, as_)
                bsm = stage(b, bvox, n8, qb, bs_)
                for warp in range(warps):
                    ti, mb, nb0 = warp % tw, warp // tw % mbk, warp // (tw * mbk) * nbw
                    acc = np.zeros((taps, nbw, 32, 4))
                    for line in range(grows // 16):
                        fa = ldmatrix(asm, (line * 16 + (LANE & 7) + 8 * (LANE >> 4)) * as_
                                      + 16 * mb + 8 * (LANE >> 3 & 1), 4, True)
                        for tp in range(taps):
                            xr0 = (((line // tbw + ti) * xw + line % tbw + tp // 3) * xd + tp % 3
                                   if ntaps == 27 else line * 16)
                            if nbw == 2:
                                fb = ldmatrix(bsm, (xr0 + (LANE & 7) + 8 * (LANE >> 3 & 1)) * bs_
                                              + 8 * (nb0 + (LANE >> 4)), 4, True)
                                acc[tp, 0] = mma(acc[tp, 0], fa, fb[:, :4], 16)
                                acc[tp, 1] = mma(acc[tp, 1], fa, fb[:, 4:], 16)
                            else:
                                fb = ldmatrix(bsm, (xr0 + (LANE & 15)) * bs_ + 8 * nb0, 2, True)
                                acc[tp, 0] = mma(acc[tp, 0], fa, fb, 16)
                    tot[warp] += acc  # the per-brick flush
            for warp in range(warps):
                ti, mb, nb0 = warp % tw, warp // tw % mbk, warp // (tw * mbk) * nbw
                for tp in range(taps):
                    for u in range(nbw):
                        for e in range(4):
                            pp = pa + 16 * mb + G + 8 * (e >> 1)
                            qq = qb + 8 * (nb0 + u) + 2 * T + (e & 1)
                            ok = (pp < P) & (qq < Q)
                            part[cta, ti * 9 + tp if ntaps == 27 else 0, pp[ok], qq[ok]] = \
                                tot[warp, tp, u, ok, e]
    out = np.zeros((ntaps, P, Q))
    for ch in range(chunks):  # contract_reduce: the chunks in order
        out += part[ch]
    return out


@pytest.mark.parametrize("cb,shape,pad_mode", [
    (1, (2, 5, 6, 18), "wrap"),
    (9, (1, 5, 6, 17), "zeros"),
    (9, (2, 3, 2, 3), "wrap"),
    (36, (1, 5, 3, 17), "wrap"),
    (40, (1, 3, 5, 6), "zeros"),
])
def test_k3_bwd_tensor_core_contractions_match_plain(cb, shape, pad_mode):
    """dW2 (27 taps over bricks with the halo: ragged on every axis, the
    volume smaller than a brick, wrapped and zero-filled halos, Cb past 32 in
    tiles of 32) against the autograd of the plain block's conv, dW1 and dW3
    (one tap over flat bricks, C = 2 Cb, tiles past 32 on both operands)
    against the plain contraction; the chunks of ``contract_plan`` and a
    persistent loop of several bricks a CTA."""
    rng = np.random.default_rng(cb * 10 + len(pad_mode))
    b_, h, w, d = shape
    c, nvox = 2 * cb, b_ * h * w * d
    gt3, a2 = (bf16(rng.standard_normal((nvox, cb))) for _ in range(2))
    gt2, gu3 = bf16(rng.standard_normal((nvox, cb))), bf16(rng.standard_normal((nvox, c)))
    a1, a3 = bf16(rng.standard_normal((nvox, c))), bf16(rng.standard_normal((nvox, cb)))
    # dW2: the autograd of the plain block's 3x3x3 conv with cotangent gt3
    x = torch.from_numpy(a2.reshape(b_, h, w, d, cb)).permute(0, 4, 1, 2, 3)
    w2 = torch.zeros(cb, cb, 3, 3, 3, dtype=torch.float64, requires_grad=True)
    y = torch.nn.functional.conv3d(conv3d.pad3d(x, 1, pad_mode), w2)
    (want2,) = torch.autograd.grad(y, w2, torch.from_numpy(gt3.reshape(b_, h, w, d, cb))
                                   .permute(0, 4, 1, 2, 3))
    want2 = want2.numpy().reshape(cb, cb, 27).transpose(2, 0, 1)  # (tap, out, in)
    chunks, need = stack_kernel.contract_plan(b_, h, w, d, c, cb)
    assert need >= max(chunks[0], chunks[2]) * c * cb and need >= chunks[1] * 27 * cb * cb
    cases = [(gt3, a2, 27, want2, chunks[1]), (gt2, a1, 1, (gt2.T @ a1)[None], chunks[0]),
             (gu3, a3, 1, (gu3.T @ a3)[None], chunks[2])]
    if cb == 9:  # a persistent loop over several bricks
        cases.append((gt3, a2, 27, want2, 3))
    for a, b, ntaps, want, ch in cases:
        got = emulate_k3_contract_tc(a, b, shape, ntaps, pad_mode == "wrap", ch)
        err, ref = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= 1e-5 * ref, f"{ntaps} taps, {ch} chunks: max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def test_k3_bwd_routes_and_chunks():
    """bf16 takes the tensor cores, fp32 the CUDA cores; the brick and tile
    the chunks are counted in are the ones the CUDA source compiles; the
    chunk count is a function of the shapes (one CTA a brick, at most
    ``TC_CTAS`` over the channel tiles)."""
    src = (Path(conv3d.__file__).parent.parent / "csrc" / "preact_stack_bwd.cu").read_text()
    brick = re.search(r"constexpr int TBH = (\d+), TBW = (\d+), TBD = (\d+);", src)
    assert tuple(int(v) for v in brick.groups()) == stack_kernel.TC_BRICK
    assert conv3d.stack_bwd_tensor_core_route(torch.bfloat16)
    assert not conv3d.stack_bwd_tensor_core_route(torch.float32)
    assert stack_kernel.contract_chunks(2048, 9, 9) == stack_kernel.TC_CTAS
    assert stack_kernel.contract_chunks(64, 36, 36) == 64
    assert stack_kernel.contract_chunks(4096, 128, 256) == stack_kernel.TC_CTAS // 32
    assert stack_kernel.contract_chunks(1, 128, 128) == 1
    (c1, c2, c3), need = stack_kernel.contract_plan(1, 128, 128, 32, 18, 9)
    assert (c1, c2, c3) == (528, 528, 528) and need == 528 * 27 * 81


def _fused_inputs(c, shape, seed):
    """bf16-exact x (B, C, H, W, D) and one block's weights and scalars, float64."""
    rng = np.random.default_rng(seed)
    b_, h, w, d = shape
    cb = max(c // 2, 1)
    x = bf16(rng.standard_normal((b_, c, h, w, d)))
    w1 = bf16(rng.standard_normal((cb, c, 1, 1, 1)) * c ** -0.5)
    w2 = bf16(rng.standard_normal((cb, cb, 3, 3, 3)) * (27 * cb) ** -0.5)
    w3 = bf16(rng.standard_normal((c, cb, 1, 1, 1)) * cb ** -0.5)
    sc8 = bf16(rng.standard_normal(8) * 0.3)
    return tuple(torch.from_numpy(t) for t in (x, w1, w2, w3, sc8))


def _halo_voxels(k0, kdims, shape, wrap):
    """brick_conv.cuh halo_voxel for every row of a brick's halo."""
    b_, h, w, d = shape
    (bb, h0, w0, d0), (bh, bw, bd) = k0, kdims
    r = np.arange((bh + 2) * (bw + 2) * (bd + 2))

    def axis(cc, n):  # halo_axis
        return np.where((cc >= 0) & (cc < n), cc, np.where(wrap & (cc == -1), n - 1,
                                                           np.where(wrap & (cc == n), 0, -1)))

    hh = axis(h0 + r // ((bd + 2) * (bw + 2)) - 1, h)
    ww = axis(w0 + r // (bd + 2) % (bw + 2) - 1, w)
    dd = axis(d0 + r % (bd + 2) - 1, d)
    return np.where((hh < 0) | (ww < 0) | (dd < 0), -1, ((bb * h + hh) * w + ww) * d + dd)


def _bricks(shape, kdims):
    """brick_conv.cuh brick_of over every brick index, d fastest."""
    b_, h, w, d = shape
    bh, bw, bd = kdims
    nb = (-(-h // bh), -(-w // bw), -(-d // bd))
    for idx in range(b_ * int(np.prod(nb))):
        i = idx
        d0, i = i % nb[2] * bd, i // nb[2]
        w0, i = i % nb[1] * bw, i // nb[1]
        yield i // nb[0], i % nb[0] * bh, w0, d0


def _brick_rows(k0, kdims, shape):
    """brick_voxel and halo_base for every row of a brick."""
    b_, h, w, d = shape
    (bb, h0, w0, d0), (bh, bw, bd) = k0, kdims
    r = np.arange(bh * bw * bd)
    oh, ow, od = r // (bw * bd), r // bd % bw, r % bd
    vox = np.where((h0 + oh < h) & (w0 + ow < w) & (d0 + od < d),
                   ((bb * h + h0 + oh) * w + w0 + ow) * d + d0 + od, -1)
    return vox, (oh * (bw + 2) + ow) * (bd + 2) + od


def _elu(v):
    return np.where(v > 0, v, np.expm1(np.minimum(v, 0)))


def emulate_k3_fused(x, w1s, w2s, w3s, sc8, pad_mode, route, voxels=None):
    """csrc/preact_stack.cu fused_tc (lane by lane: the staging tile, the
    ldmatrix addresses, the implicit GEMM's halo rows a lane addresses, the
    fragments of every product) or fused_cc (voxel by voxel), in float64
    with no rounding; weights through ``pack_fused_weights``, the brick of
    ``fused_brick`` at ``fused_voxels`` (or ``voxels``). Returns y (B, C, H,
    W, D)."""
    b_, c, h, w, d = x.shape
    shape = (b_, h, w, d)
    cb = w1s.shape[0]
    xl = x.permute(0, 2, 3, 4, 1).reshape(-1, c).numpy()
    w1f, w2f, w3f = (t[0].double().numpy() for t in
                     stack_kernel.pack_fused_weights(w1s[None], w2s[None], w3s[None], route))
    cbp = stack_kernel.fused_cbp(route, cb)
    b1a, b1b, b2a, b2b, b3a, b3b, b4, scale = sc8.numpy()
    a1 = lambda v: _elu(v + b1a) + b1b  # noqa: E731
    a2f = lambda v: _elu(v + b2a) + b2b  # noqa: E731
    a3f = lambda v: _elu(v + b3a) + b3b  # noqa: E731
    kdims = stack_kernel.fused_brick(
        h, w, d, voxels or stack_kernel.fused_voxels(route, cbp, b_ * h * w * d))
    wrap = pad_mode == "wrap"
    y = np.full_like(xl, np.nan)
    for k0 in _bricks(shape, kdims):
        hv = _halo_voxels(k0, kdims, shape, wrap)
        vox, base = _brick_rows(k0, kdims, shape)
        nh = len(hv)
        hw_, hd_ = kdims[1] + 2, kdims[2] + 2
        offs = [(kh * hw_ + kw) * hd_ + kd for kh in range(3) for kw in range(3) for kd in range(3)]
        if route == "fused_cc":
            halo = np.where(hv[:, None] >= 0, a2f(a1(xl[np.maximum(hv, 0)]) @ w1f.T), 0.0)
            halo[:, cb:] = 0.0
            acc = sum(halo[base + off] @ w2f[tap].T for tap, off in enumerate(offs))
            a3 = a3f(acc)[:, :cb]
            out = (a3 @ w3f[:, :cb].T) * scale + b4
            ok = vox >= 0
            y[vox[ok]] = out[ok] + xl[vox[ok]]
            continue
        nt, as_, k1 = cbp // 8, cbp + 8, w1f.shape[1]
        arow, acol = (LANE & 7) + 8 * (LANE >> 3 & 1), 8 * (LANE >> 4)

        def fb(wm, n0, kk0):  # B fragment of w [N][K] at n-block n0, k-step kk0 (two ldg32)
            return wm[n0 * 8 + b_map(16)[1], kk0 + b_map(16)[0]]

        halo = np.zeros(nh * as_)
        for mt in range(-(-nh // 16)):  # 1. a2 of the halo rows
            acc = np.zeros((nt, 32, 4))
            sr = mt * 16 + (LANE >> 1)
            sv = np.where(sr < nh, hv[np.minimum(sr, nh - 1)], -1)
            for kk0 in range(0, k1, 16):
                stg = np.zeros(16 * 24)
                for j in range(8):
                    ch = kk0 + 8 * (LANE & 1) + j
                    val = np.where((sv >= 0) & (ch < c),
                                   a1(xl[np.maximum(sv, 0), np.minimum(ch, c - 1)]), 0.0)
                    stg[(LANE >> 1) * 24 + 8 * (LANE & 1) + j] = val
                fa = ldmatrix(stg, arow * 24 + acol, 4, False)
                for n in range(nt):
                    acc[n] = mma(acc[n], fa, fb(w1f, n, kk0), 16)
            for half in range(2):
                r = mt * 16 + G + 8 * half
                inside = (r < nh) & (hv[np.minimum(r, nh - 1)] >= 0)
                for n in range(nt):
                    for e in range(2):
                        col = n * 8 + 2 * T + e
                        val = np.where(inside & (col < cb), a2f(acc[n][:, 2 * half + e]), 0.0)
                        halo[(r * as_ + col)[r < nh]] = val[r < nh]
        a3s = np.zeros(len(vox) * as_)
        for mt in range(len(vox) // 16):  # 2. the conv, 3. W3 and y, m-tile by m-tile
            m0 = 16 * mt
            a0 = base[m0 + arow] * as_ + acol
            acc = np.zeros((nt, 32, 4))
            for tap, off in enumerate(offs):
                for kk0 in range(0, cbp, 16):
                    fa = ldmatrix(halo, a0 + off * as_ + kk0, 4, False)
                    for n in range(nt):
                        acc[n] = mma(acc[n], fa, fb(w2f[tap], n, kk0), 16)
            for half in range(2):
                r = m0 + G + 8 * half
                for n in range(nt):
                    for e in range(2):
                        col = n * 8 + 2 * T + e
                        a3s[r * as_ + col] = np.where(col < cb, a3f(acc[n][:, 2 * half + e]), 0)
            ntc = -(-c // 8)
            for n0 in range(0, ntc, 8):
                acc2 = np.zeros((8, 32, 4))
                for kk0 in range(0, cbp, 16):
                    fa = ldmatrix(a3s, (m0 + arow) * as_ + kk0 + acol, 4, False)
                    for j in range(min(8, ntc - n0)):
                        acc2[j] = mma(acc2[j], fa, fb(w3f, n0 + j, kk0), 16)
                for half in range(2):
                    v = vox[m0 + G + 8 * half]
                    for j in range(min(8, ntc - n0)):
                        for e in range(2):
                            cc = (n0 + j) * 8 + 2 * T + e
                            ok = (v >= 0) & (cc < c)
                            y[v[ok], cc[ok]] = (acc2[j][ok, 2 * half + e] * scale + b4
                                                + xl[v[ok], cc[ok]])
    return torch.from_numpy(y.reshape(b_, h, w, d, c)).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("c,shape,pad_mode,route,voxels", [
    (18, (1, 5, 6, 17), "zeros", "fused_tc", None),  # Cb 9 padded to 16, C to 32 / 24
    (18, (2, 3, 2, 3), "wrap", "fused_tc", None),  # the volume smaller than a brick
    (10, (1, 4, 4, 8), "zeros", "fused_tc", None),  # Cb 5, the tensor cores' smallest
    (72, (1, 3, 5, 6), "wrap", "fused_tc", None),   # Cb 36 padded to 48, C to 80 / 72
    (16, (1, 5, 6, 17), "wrap", "fused_tc", 256),   # the brick of 256 voxels (two m-tiles)
    (4, (1, 5, 6, 17), "wrap", "fused_cc", None),
    (4, (1, 9, 10, 18), "zeros", "fused_cc", 1024),  # four voxels a thread
    (8, (2, 3, 4, 5), "zeros", "fused_cc", None),
    (3, (1, 2, 2, 3), "wrap", "fused_cc", None),    # Cb 1, a 2 x 2 x 3 volume
])
def test_k3_fused_forward_matches_plain(c, shape, pad_mode, route, voxels):
    """K3's fused bf16 forward, transcribed (``emulate_k3_fused``), against
    the plain block (``preact_fixup_same``) in float64 on bf16-exact inputs:
    the brick gather with wrapped and zero halos, the padding of Cb and C to
    the mma's widths, the implicit GEMM's rows and the fragments of the
    three products, within 1e-10 of max|ref| (only the order of the sums
    differs)."""
    x, w1, w2, w3, sc8 = _fused_inputs(c, shape, c * 100 + shape[-1])
    want = stack_kernel.preact_fixup_same(x, w1, w2, w3, sc8, pad_mode=pad_mode)
    got = emulate_k3_fused(x, w1, w2, w3, sc8, pad_mode, route, voxels)
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    assert err <= 1e-10 * ref, f"max|d|={err:.3g} > 1e-10 x {ref:.3g}"


def test_k3_fused_routes_and_bricks():
    """bf16 takes the fused kernel (the tensor cores from Cb = 5 to 128, the
    CUDA cores below), fp32 and wider Cb the three kernels; the brick sizes
    are the CUDA source's; the published grids' bricks."""
    src = (Path(conv3d.__file__).parent.parent / "csrc" / "preact_stack.cu").read_text()
    for name, route in (("kTcVox", "fused_tc"), ("kCcVox", "fused_cc")):
        assert f"constexpr int {name} = {stack_kernel.FUSED_BRICK_VOXELS[route]};" in src
    route = conv3d.stack_fwd_route
    assert [route(torch.bfloat16, cb) for cb in (1, 2, 4, 5, 9, 36, 128, 129)] == \
        ["fused_cc"] * 3 + ["fused_tc"] * 4 + ["three_kernels"]
    assert route(torch.float32, 9) == "three_kernels" and route(torch.float32, 2) == "three_kernels"
    assert [stack_kernel.fused_cbp("fused_tc", cb) for cb in (5, 9, 36, 64, 128)] == \
        [16, 16, 48, 64, 128]
    assert [stack_kernel.fused_cbp("fused_cc", cb) for cb in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert stack_kernel.fused_voxels("fused_tc", 16, 128 * 128 * 32) == 256
    assert stack_kernel.fused_voxels("fused_tc", 48, 128 * 128 * 32) == 128
    assert stack_kernel.fused_voxels("fused_tc", 32, 8 * 8 * 2) == 128
    assert stack_kernel.fused_voxels("fused_cc", 4, 64 * 64 * 16) == 1024
    assert stack_kernel.fused_voxels("fused_cc", 2, 32 * 32 * 8) == 256
    brick = stack_kernel.fused_brick
    assert brick(128, 128, 32, 128) == (2, 4, 16) and brick(512, 512, 128, 256) == (4, 4, 16)
    assert brick(32, 32, 8, 128) == (4, 4, 8) and brick(16, 16, 4, 128) == (4, 8, 4)
    assert brick(8, 8, 2, 128) == (8, 8, 2)
    for shp in ((128, 128, 32), (8, 8, 2), (3, 5, 7), (2, 2, 1)):
        for v in (128, 256):
            assert np.prod(brick(*shp, v)) == v


def _c_tile(frag):
    """A 16 x 8 tile from its C fragments (32, 4)."""
    out = np.zeros((16, 8))
    out[C_MAP] = frag
    return out


def emulate_k4_bwd_tc(saves, gy, cond, keep, p, w, ctas=None):
    """csrc/causal_stack_bwd.cu's tensor-core route (tc_pre, tc_mid,
    tc_dgrad, reduce_segs) in numpy, float64 and unrounded but for gm's split
    into a bf16 hi half and a lo half: ``bwd_plan``'s bricks and persistent
    CTAs, the halo rows of both convs (the forward's one s0-row behind, the
    transposed one's ahead, zero outside the grid), the conv, its transpose
    and dWU lane by lane (ldmatrix of each lane's halo row, .trans for the
    products with K over voxels, the fragments of mma.sync), the 1x1 products
    on the gathered tiles, the per-CTA partials summed in CTA order and
    scattered by segment. Returns what ``causal_stack_bwd_plain`` returns."""
    ck = causal_kernel
    nb, cu, cb = w.w1e.shape
    b_, s0, s1, s2, _ = gy.shape
    cc = 0 if cond is None else cond.shape[-1]
    (n0, n1, n2), (cm, cd) = ck.bwd_plan(b_, s0, s1, s2)
    cm, cd = (ctas, ctas) if ctas else (cm, cd)
    pk = {k: v.double().numpy() for k, v in ck.pack_bwd_tc_weights(w).items()}
    lm, ld = ck.bwd_partial_lens(cu, cb, cc)
    nvox = b_ * s0 * s1 * s2
    cup, bs_ = pk["w3"].shape[-1], 24
    h1, h2 = n1 + 2, n2 + 2
    nh = (n0 + 1) * h1 * h2
    nbr = (-(-s0 // n0), -(-s1 // n1), -(-s2 // n2))
    nbricks = b_ * int(np.prod(nbr))
    g = gy.reshape(nvox, cu).double().numpy()
    cf = None if cond is None else cond.reshape(nvox, cc).double().numpy()
    gcond = None if cond is None else np.zeros((nvox, cc))
    r = np.arange(n0 * n1 * n2)
    hr = np.arange(nh)
    base = ((r // (n1 * n2)) * h1 + r // n2 % n1) * h2 + r % n2
    fwd_off = [((t // 9) * h1 + t // 3 % 3) * h2 + t % 3 for t in range(18)]
    bwd_off = [((1 - t // 9) * h1 + 2 - t // 3 % 3) * h2 + 2 - t % 3 for t in range(18)]
    arow, acol = (LANE & 7) + 8 * (LANE >> 3 & 1), 8 * (LANE >> 4)

    def brick(bi):
        i = bi
        i2, i = i % nbr[2] * n2, i // nbr[2]
        i1, i = i % nbr[1] * n1, i // nbr[1]
        bb, i0 = i // nbr[0], i % nbr[0] * n0
        a, bq, c = i0 + r // (n1 * n2), i1 + r // n2 % n1, i2 + r % n2
        rows = np.where((a < s0) & (bq < s1) & (c < s2), ((bb * s0 + a) * s1 + bq) * s2 + c, -1)

        def halo(o0):
            a, bq, c = i0 + o0 + hr // (h1 * h2), i1 - 1 + hr // h2 % h1, i2 - 1 + hr % h2
            ok = (a >= 0) & (a < s0) & (bq >= 0) & (bq < s1) & (c >= 0) & (c < s2)
            return bb, rows, np.where(ok, ((bb * s0 + a) * s1 + bq) * s2 + c, -1)
        return halo

    def gather(src, vox, width):
        out = np.zeros((len(vox), width))
        out[vox >= 0, :src.shape[1]] = src[vox[vox >= 0]]
        return out

    def conv(tiles, wt, offs):  # acc (128, 16) = sum over taps and tiles of halo rows . wt[tap]^T
        acc = np.zeros((len(r), 16))
        for warp in range(len(r) // 16):
            a0 = base[16 * warp + arow] * bs_ + acol
            frag = np.zeros((2, 32, 4))
            for tap, off in enumerate(offs):
                for tile in tiles:
                    fa = ldmatrix(tile, a0 + off * bs_, 4, False)
                    for n in range(2):
                        frag[n] = mma(frag[n], fa, wt[tap][n * 8 + b_map(16)[1], b_map(16)[0]], 16)
            for n in range(2):
                acc[16 * warp:16 * warp + 16, 8 * n:8 * n + 8] = _c_tile(frag[n])
        return acc

    def flat(t):  # shared rows of bs_ bf16
        return np.pad(t, ((0, 0), (0, bs_ - t.shape[1]))).ravel()

    res = []
    for j in reversed(range(nb)):
        b1a, b1b, b2a, b2b, b3a, b3b, b4, scale = w.sc[j].double().numpy()
        x = saves[j].reshape(nvox, cu).double().numpy()
        kp = None if keep is None else keep[j].double().numpy()
        be = pk["be"][j]
        a1 = np.pad(_elu(x + b1a) + b1b, ((0, 0), (0, cup - cu)))
        a2 = np.zeros((nvox, 16))  # tc_pre
        a2[:, :cb] = (_elu(a1 @ pk["w1e"][j].T + np.pad(be, (0, 16 - cb)) + b2a) + b2b)[:, :cb]
        gmh, gml = np.zeros((nvox, 16)), np.zeros((nvox, 16))
        part = np.zeros((cm, lm))
        for cta in range(cm):  # tc_mid
            tot_u, tot3 = np.zeros((18, 16, 16)), np.zeros((cup, 16))
            totc, dbc, ssum = np.zeros((16, max(cc, 1))), np.zeros(16), np.zeros(4)
            for bi in range(cta, nbricks, cm):
                bb, rows, hv = brick(bi)(-1)
                ok = rows >= 0
                halo = flat(gather(a2, hv, 16))
                c = conv([halo], pk["wuf"][j], fwd_off)
                if kp is not None:
                    c[:, :cb] = np.where(kp[bb] > 0, c[:, :cb] / (1 - p), 0.0)
                cs = None
                if cf is not None:
                    cs = gather(cf, rows, cc)
                    c[:, :cb] = c[:, :cb] + np.pad(cs, ((0, 0), (0, pk["wct"].shape[-1] - cc))) \
                        @ pk["wct"][j].T[:, :cb] + pk["bc"][j]
                t3 = c + b3a
                gs = gather(g, rows, cup)
                gus = gs * scale
                ga3 = gus @ pk["w3"][j].T
                okc = ok[:, None] & (np.arange(16) < cb)
                gt3 = np.where(okc, ga3 * np.where(t3 > 0, 1.0, np.exp(np.minimum(t3, 0))), 0.0)
                a3 = np.where(okc, _elu(t3) + b3b, 0.0)
                gm = gt3 if kp is None else np.where(kp[bb] > 0, gt3 / (1 - p), 0.0) \
                    if cb == 16 else np.where(np.pad(kp[bb], (0, 16 - cb)) > 0, gt3 / (1 - p), 0.0)
                hi = bf16(gm)
                lo = np.where(okc, gm - hi, 0.0)
                gmh[rows[ok]], gml[rows[ok]] = hi[ok], lo[ok]
                ssum += [gt3.sum(), np.where(okc, ga3, 0).sum(), gs[:, :cu].sum(),
                         (gs * (a3 @ pk["w3t"][j].T))[:, :cu].sum()]
                dbc += gt3.sum(0)
                if cf is not None:
                    gcond[rows[ok]] += (gt3 @ pk["wcn"][j].T)[ok, :cc]
                    totc += gt3.T @ cs
                hflat, lflat = flat(hi), flat(lo)
                for tap in range(18):  # dWU, lane by lane: gm^T (hi, lo) x a2 of the tap's rows
                    acc = np.zeros((2, 32, 4))
                    for line in range(len(r) // 16):
                        va = (16 * line + (LANE & 7) + 8 * (LANE >> 4)) * bs_ + 8 * (LANE >> 3 & 1)
                        fb = ldmatrix(halo, (base[16 * line + arow] + fwd_off[tap]) * bs_ + acol,
                                      4, True)
                        for src in (hflat, lflat):
                            fa = ldmatrix(src, va, 4, True)
                            acc[0] = mma(acc[0], fa, fb[:, :4], 16)
                            acc[1] = mma(acc[1], fa, fb[:, 4:], 16)
                    tot_u[tap] += np.concatenate([_c_tile(acc[0]), _c_tile(acc[1])], 1)
                tot3 += gus.T @ a3
            o = [tot_u[:, :cb, :cb].ravel(), tot3[:cu, :cb].ravel()]
            if cf is not None:
                o += [totc[:cb, :cc].ravel(), dbc[:cb]]
            part[cta] = np.concatenate(o + [ssum])
        mid = np.cumsum(part, 0)[-1]  # CTA order
        dsc = np.zeros(8)
        dwu, o = mid[:18 * cb * cb].reshape(18, cb, cb), 18 * cb * cb
        dw3, o = mid[o:o + cu * cb].reshape(cu, cb), o + cu * cb
        dwc = dbcs = None
        if cf is not None:
            dwc, o = mid[o:o + cb * cc].reshape(cb, cc), o + cb * cc
            dbcs, o = mid[o:o + cb], o + cb
        dsc[4:] = mid[o:o + 4]
        part = np.zeros((cd, ld))
        dx = np.zeros((nvox, cu))
        for cta in range(cd):  # tc_dgrad
            tot1, dbe, ssum = np.zeros((16, cup)), np.zeros(16), np.zeros(4)
            for bi in range(cta, nbricks, cd):
                bb, rows, hv = brick(bi)(0)
                ok = rows >= 0
                okc = ok[:, None] & (np.arange(16) < cb)
                a1s = np.where(ok[:, None], gather(a1, rows, cup), 0.0)
                t2 = a1s @ pk["w1e"][j].T + np.pad(be, (0, 16 - cb)) + b2a
                ga2 = conv([flat(gather(gmh, hv, 16)), flat(gather(gml, hv, 16))],
                           pk["wut"][j], bwd_off)
                gt2 = np.where(okc, ga2 * np.where(t2 > 0, 1.0, np.exp(np.minimum(t2, 0))), 0.0)
                ga1 = (gt2 @ pk["w1n"][j].T)[:, :cu]
                xr = gather(x, rows, cu)
                gt1 = ga1 * np.where(xr + b1a > 0, 1.0, np.exp(np.minimum(xr + b1a, 0)))
                dx[rows[ok]] = g[rows[ok]] + gt1[ok]
                ssum += [gt1[ok].sum(), ga1[ok].sum(), gt2.sum(), np.where(okc, ga2, 0).sum()]
                dbe += gt2.sum(0)
                tot1 += gt2.T @ a1s
            part[cta] = np.concatenate([tot1[:cb, :cu].ravel(), dbe[:cb], ssum])
        dgr = np.cumsum(part, 0)[-1]
        dw1 = dgr[:cb * cu].reshape(cb, cu)
        dbe_ = dgr[cb * cu:cb * cu + cb]
        dsc[:4] = dgr[cb * cu + cb:]
        res.append((dw1, dbe_, dwu, dw3, dwc, dbcs, dsc))
        g = dx
    st = [None if t[0] is None else torch.from_numpy(np.stack(t[::-1])) for t in zip(*res)]
    grads = ck.kernel_grads_to_union(st[0], st[1], st[2], st[3],
                                     st[4] if cf is not None else torch.zeros(nb, cb, 1),
                                     st[5] if cf is not None else torch.zeros(nb, cb), st[6],
                                     cf is not None)
    return (torch.from_numpy(g.reshape(gy.shape)),
            None if gcond is None else torch.from_numpy(gcond.reshape(cond.shape)), *grads)


def _k4_case(c, cb8, cc, b, grid, p, nb, seed):
    """bf16-exact inputs and union weights (Cu = 3c, Cb = 3 cb8) in float64."""
    rng = np.random.default_rng(seed)
    cu, cb = 3 * c, 3 * cb8

    def t(*shape, scale=1.0):
        return torch.from_numpy(bf16(rng.standard_normal(shape) * scale))

    sc = t(nb, 8, scale=0.1)
    sc[:, 7] += 0.25
    w = causal_kernel.UnionWeights(
        t(nb, cu, cb, scale=cu ** -0.5), t(nb, cb, scale=0.1),
        t(nb, 2, 3, 3, cb, cb, scale=(18 * cb) ** -0.5), t(nb, cb, cu, scale=cb ** -0.5),
        t(nb, cc, cb, scale=cc ** -0.5) if cc else None, t(nb, cb, scale=0.1) if cc else None,
        torch.from_numpy(bf16(sc.numpy())))
    saves = t(nb, b, *grid, cu)
    gy = t(b, *grid, cu)
    cond = t(b, *grid, cc) if cc else None
    keep = torch.from_numpy((rng.random((nb, b, cb)) < 0.5).astype(np.float64)) if p else None
    return saves, gy, cond, keep, p, w


@pytest.mark.parametrize("case,ctas", [
    ((16, 4, 16, 1, (3, 5, 6), 0.5, 2), None),   # the top prior's widths, a condition, a keep mask
    ((8, 4, 8, 2, (4, 3, 5), 0.0, 1), 3),         # B = 2, a persistent loop over several bricks
    ((6, 1, 0, 1, (2, 9, 17), 0.5, 1), None),     # unconditioned, Cb = 3, ragged bricks
])
def test_k4_tensor_core_backward_matches_plain(case, ctas):
    """K4's tensor-core backward, transcribed (``emulate_k4_bwd_tc``), against
    ``causal_stack_bwd_plain`` (fp32 math on bf16-exact float64 inputs):
    dx, the condition's gradient and every union-weight gradient per tensor
    within 1e-5 of max|ref|. gm's bf16 hi half and its remainder carry gm
    exactly, so only the order of the sums differs."""
    saves, gy, cond, keep, p, w = _k4_case(*case, seed=sum(case[:4]))
    got = emulate_k4_bwd_tc(saves, gy, cond, keep, p, w, ctas)
    want = causal_kernel.causal_stack_bwd_plain(saves, gy, cond, keep, p, w)
    for i, (a, r) in enumerate(zip(got, want)):
        assert (a is None) == (r is None), i
        if r is None:
            continue
        err, ref = float((a - r.double()).abs().max()), float(r.abs().max())
        assert err <= 1e-5 * ref, f"output {i}: max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def test_k4_gm_halves_and_plan():
    """gm as bf16 hi + lo halves is gm to 2^-16 of |gm| (the kernel rounds
    lo to bf16 too); the plan's bricks hold 128 voxels (the CUDA source's
    tc::kVox, csrc/causal_tc.cuh) and its CTAs are a function of the
    shapes; the route takes bf16 at the widths the kernels compile."""
    gm = np.random.default_rng(3).standard_normal(4096) * 10.0 ** np.arange(-3, 5).repeat(512)
    hi = bf16(gm)
    assert np.all(np.abs(gm - hi - bf16(gm - hi)) <= 2.0 ** -16 * np.abs(gm))
    src = (Path(conv3d.__file__).parent.parent / "csrc" / "causal_tc.cuh").read_text()
    assert f"kVox = {causal_kernel.BWD_TC_VOXELS};" in src
    assert causal_kernel.bwd_plan(1, 128, 128, 32) == ((2, 4, 16), causal_kernel.BWD_TC_CTAS)
    assert causal_kernel.bwd_plan(1, 3, 5, 6) == ((4, 4, 8), (2, 2))
    route = conv3d.causal_bwd_tensor_core_route
    assert route(torch.bfloat16, 48, 12, 16) and route(torch.bfloat16, 64, 16, 32)
    assert not route(torch.float32, 48, 12, 16) and not route(torch.bfloat16, 48, 24, 16)
    assert not route(torch.bfloat16, 96, 12, 16) and not route(torch.bfloat16, 48, 12, 48)


# ---- K3 backward's brick route (csrc/preact_stack_bwd.cu brick_bwd_mid,
# brick_bwd_dgrad, brick_scalars) and K4's tensor-core forward
# (csrc/causal_stack.cu tc_fwd_pre, tc_fwd_brick)


def _own_voxels(k0, kdims, shape):
    """brick_conv.cuh own_voxel for every row of a brick's halo: the brick's
    own voxels inside the volume, -1 elsewhere (wrapped neighbours too)."""
    b_, h, w, d = shape
    (bb, h0, w0, d0), (bh, bw, bd) = k0, kdims
    r = np.arange((bh + 2) * (bw + 2) * (bd + 2))
    hh, ww, dd = r // ((bd + 2) * (bw + 2)) - 1, r // (bd + 2) % (bw + 2) - 1, r % (bd + 2) - 1
    ok = ((hh >= 0) & (hh < bh) & (ww >= 0) & (ww < bw) & (dd >= 0) & (dd < bd)
          & (h0 + hh < h) & (w0 + ww < w) & (d0 + dd < d))
    return np.where(ok, ((bb * h + h0 + hh) * w + w0 + ww) * d + d0 + dd, -1)


def _taps_offsets(kdims):
    """The halo offset of each tap (kh, kw, kd), brick_conv.cuh conv_tile."""
    hw_, hd_ = kdims[1] + 2, kdims[2] + 2
    return [(kh * hw_ + kw) * hd_ + kd for kh in range(3) for kw in range(3) for kd in range(3)]


def _brick_conv_lanes(halo_rows, base, offs, wt, cbp):
    """conv_tile lane by lane: halo_rows (nh, CBP) in shared rows of CBP + 8,
    each lane's ldmatrix address its own voxel's halo row, B fragments of wt
    [27][CBP][CBP] ([N][K]); returns the brick's (nv, CBP) sums."""
    as_, nt = cbp + 8, cbp // 8
    halo = np.pad(halo_rows, ((0, 0), (0, 8))).ravel()
    arow, acol = (LANE & 7) + 8 * (LANE >> 3 & 1), 8 * (LANE >> 4)
    out = np.zeros((len(base), cbp))
    for m0 in range(0, len(base), 16):
        a0 = base[m0 + arow] * as_ + acol
        acc = np.zeros((nt, 32, 4))
        for tap, off in enumerate(offs):
            for kk0 in range(0, cbp, 16):
                fa = ldmatrix(halo, a0 + off * as_ + kk0, 4, False)
                for n in range(nt):
                    acc[n] = mma(acc[n], fa, wt[tap][n * 8 + b_map(16)[1], kk0 + b_map(16)[0]], 16)
        for n in range(nt):
            out[m0:m0 + 16, 8 * n:8 * n + 8] = _c_tile(acc[n])
    return out


@pytest.mark.parametrize("c,shape,pad_mode", [
    (18, (1, 5, 6, 17), "wrap"),   # Cb 9 padded to 16, bricks overhanging H, W and D
    (18, (2, 3, 2, 3), "zeros"),   # a volume smaller than a brick, B = 2
    (72, (1, 3, 5, 6), "zeros"),   # Cb 36 padded to 48: three k-steps, six n-blocks
    (72, (1, 2, 3, 3), "wrap"),    # extents below 3: a wrapped neighbour is the voxel itself
])
def test_k3_bwd_transposed_conv_tile_matches_autograd(c, shape, pad_mode):
    """K3 backward's transposed conv (brick_bwd_dgrad): conv_tile over a
    brick of gt3 with its one-voxel halo (wrapped for 'wrap', zero for
    'zeros'), the taps mirrored and w2's channels swapped
    (``pack_brick_bwd_weights``' w2m), transcribed lane by lane, against the
    autograd of the plain block's conv (its input gradient ga2), float64,
    within 1e-10 of max|ref| (only the order of the sums differs)."""
    rng = np.random.default_rng(c + shape[-1])
    b_, h, w, d = shape
    cb = c // 2
    gt3 = torch.from_numpy(bf16(rng.standard_normal((b_, cb, h, w, d))))
    w2 = torch.from_numpy(bf16(rng.standard_normal((cb, cb, 3, 3, 3)) * (27 * cb) ** -0.5))
    w1 = torch.zeros(cb, c, 1, 1, 1, dtype=torch.float64)
    w3 = torch.zeros(c, cb, 1, 1, 1, dtype=torch.float64)
    a2 = torch.zeros(b_, cb, h, w, d, dtype=torch.float64, requires_grad=True)
    (want,) = torch.autograd.grad(conv3d.conv3d(a2, w2, padding=1, pad_mode=pad_mode), a2, gt3)
    cbp = stack_kernel.fused_cbp("fused_tc", cb)
    w2m = stack_kernel.pack_brick_bwd_weights(w1[None], w2[None], w3[None])["w2m"][0].double()
    kdims = stack_kernel.fused_brick(h, w, d, stack_kernel.fused_voxels("fused_tc", cbp, b_ * h * w * d))
    gl = gt3.permute(0, 2, 3, 4, 1).reshape(-1, cb).numpy()
    got = np.full_like(gl, np.nan)
    for k0 in _bricks(shape, kdims):
        hv = _halo_voxels(k0, kdims, shape, pad_mode == "wrap")
        vox, base = _brick_rows(k0, kdims, shape)
        rows = np.where(hv[:, None] >= 0, np.pad(gl[np.maximum(hv, 0)], ((0, 0), (0, cbp - cb))), 0)
        ga2 = _brick_conv_lanes(rows, base, _taps_offsets(kdims), w2m.numpy(), cbp)
        got[vox[vox >= 0]] = ga2[vox >= 0, :cb]
    want = want.permute(0, 2, 3, 4, 1).reshape(-1, cb).numpy()
    assert not np.isnan(got).any(), "a voxel no brick wrote"
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-10 * ref, f"max|d|={err:.3g} > 1e-10 x {ref:.3g}"


def _shift(a, shape, tap, wrap):
    """a (nvox, ch) at each voxel's forward-conv neighbour of tap, zero
    outside the volume for 'zeros' (preact_stack_bwd.cu shifted, s = +1)."""
    b_, h, w, d = shape
    v = a.reshape(b_, h, w, d, -1)
    out = np.zeros_like(v)
    dh, dw, dd = tap // 9 - 1, tap // 3 % 3 - 1, tap % 3 - 1
    for i in range(h):
        for j in range(w):
            for k in range(d):
                ii, jj, kk = i + dh, j + dw, k + dd
                if wrap:
                    ii, jj, kk = ii % h, jj % w, kk % d
                elif not (0 <= ii < h and 0 <= jj < w and 0 <= kk < d):
                    continue
                out[:, i, j, k] = v[:, ii, jj, kk]
    return out.reshape(a.shape)


def emulate_k3_bwd_bricks(x, gy, w1s, w2s, w3s, sc8, pad_mode, voxels=None):
    """csrc/preact_stack_bwd.cu's brick route for one block, float64 and
    unrounded: brick_bwd_mid over the forward's bricks (the halo's a2 with
    a1, t2 and a2 written for own_voxel's rows, the conv, a3, gu3, ga3 =
    W3^T gu3 on ``pack_brick_bwd_weights``' w3t, gt3, the W3 product for
    d_scale), then brick_bwd_dgrad (gt3's halo, the mirrored taps' conv on
    w2m, gt2, ga1 on w1n, dx), each brick's partial of the 8 scalar sums
    summed in brick order (brick_scalars); the weight contractions as sums
    over the scratch tensors the kernels wrote (contract_tc's operands).
    Returns (dx, dw1, dw2, dw3, dsc) as ``preact_stack_bwd_plain`` does."""
    b_, c, h, w, d = x.shape
    shape, nvox = (b_, h, w, d), b_ * h * w * d
    cb = w1s.shape[0]
    cbp = stack_kernel.fused_cbp("fused_tc", cb)
    pk = {k: v[0].double().numpy() for k, v in
          stack_kernel.pack_brick_bwd_weights(w1s[None], w2s[None], w3s[None]).items()}
    k1, n3 = pk["w1"].shape[1], pk["w3"].shape[0]
    b1a, b1b, b2a, b2b, b3a, b3b, b4, scale = sc8.numpy()
    xl = x.permute(0, 2, 3, 4, 1).reshape(nvox, c).numpy()
    gl = gy.permute(0, 2, 3, 4, 1).reshape(nvox, c).numpy()
    wrap = pad_mode == "wrap"
    kdims = stack_kernel.fused_brick(
        h, w, d, voxels or stack_kernel.fused_voxels("fused_tc", cbp, nvox))
    offs = _taps_offsets(kdims)
    grad = lambda t: np.where(t > 0, 1.0, np.exp(np.minimum(t, 0)))  # noqa: E731
    sx = {k: np.full((nvox, n), np.nan) for k, n in
          (("a1", c), ("a2", cb), ("t2", cb), ("a3", cb), ("gt3", cb), ("gu3", c), ("gt2", cb))}
    dx = np.full((nvox, c), np.nan)
    bricks = list(_bricks(shape, kdims))
    sp = np.zeros((len(bricks), 8))
    colb = np.arange(cbp) < cb
    for i, k0 in enumerate(bricks):  # brick_bwd_mid
        hv, own = _halo_voxels(k0, kdims, shape, wrap), _own_voxels(k0, kdims, shape)
        vox, base = _brick_rows(k0, kdims, shape)
        ok = vox >= 0
        a1h = np.where(hv[:, None] >= 0, _elu(xl[np.maximum(hv, 0)] + b1a) + b1b, 0.0)
        acc1 = np.pad(a1h, ((0, 0), (0, k1 - c))) @ pk["w1"].T
        a2h = np.where((hv[:, None] >= 0) & colb, _elu(acc1 + b2a) + b2b, 0.0)
        m = own >= 0
        sx["a1"][own[m]], sx["a2"][own[m]], sx["t2"][own[m]] = \
            a1h[m], a2h[m, :cb], (acc1 + b2a)[m, :cb]
        t3 = sum(a2h[base + off] @ pk["w2"][tap].T for tap, off in enumerate(offs)) + b3a
        a3 = np.where(colb, _elu(t3) + b3b, 0.0)
        gs = np.where(ok[:, None], gl[np.maximum(vox, 0)], 0.0)
        gu = gs * scale
        ga = np.pad(gu, ((0, 0), (0, k1 - c))) @ pk["w3t"].T
        okc = ok[:, None] & colb
        gt3 = np.where(okc, ga * grad(t3), 0.0)
        p3 = (a3 @ pk["w3"].T)[:, :c]
        sx["a3"][vox[ok]], sx["gt3"][vox[ok]], sx["gu3"][vox[ok]] = a3[ok, :cb], gt3[ok, :cb], gu[ok]
        sp[i, 4:] = [gt3.sum(), np.where(okc, ga, 0).sum(), gs.sum(), (gs * p3).sum()]
    assert not any(np.isnan(v).any() for v in sx.values() if v is not sx["gt2"]), \
        "a scratch voxel no brick wrote"
    for i, k0 in enumerate(bricks):  # brick_bwd_dgrad
        hv = _halo_voxels(k0, kdims, shape, wrap)
        vox, base = _brick_rows(k0, kdims, shape)
        ok = vox >= 0
        okc = ok[:, None] & colb
        halo = np.where(hv[:, None] >= 0, np.pad(sx["gt3"][np.maximum(hv, 0)],
                                                  ((0, 0), (0, cbp - cb))), 0.0)
        ga2 = sum(halo[base + off] @ pk["w2m"][tap].T for tap, off in enumerate(offs))
        t2 = np.pad(sx["t2"][np.maximum(vox, 0)], ((0, 0), (0, cbp - cb)))
        gt2 = np.where(okc, ga2 * grad(t2), 0.0)
        ga1 = (gt2 @ pk["w1n"].T)[:, :c]
        xr = xl[np.maximum(vox, 0)]
        gt1 = ga1 * grad(xr + b1a)
        sx["gt2"][vox[ok]] = gt2[ok, :cb]
        dx[vox[ok]] = gl[vox[ok]] + gt1[ok]
        sp[i, :4] = [gt1[ok].sum(), ga1[ok].sum(), gt2.sum(), np.where(okc, ga2, 0).sum()]
    assert not np.isnan(dx).any() and not np.isnan(sx["gt2"]).any()
    dsc = np.cumsum(sp, 0)[-1]  # brick order
    dw1 = sx["gt2"].T @ sx["a1"]
    dw2 = np.stack([sx["gt3"].T @ _shift(sx["a2"], shape, tap, wrap) for tap in range(27)])
    dw3 = sx["gu3"].T @ sx["a3"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(dx.reshape(b_, h, w, d, c)).permute(0, 4, 1, 2, 3), t(dw1).reshape(w1s.shape),
            t(dw2.transpose(1, 2, 0)).reshape(w2s.shape), t(dw3).reshape(w3s.shape), t(dsc))


@pytest.mark.parametrize("c,shape,pad_mode,voxels", [
    (18, (1, 5, 6, 17), "zeros", None),   # Cb 9: bricks overhanging the volume on every axis
    (18, (2, 3, 4, 5), "wrap", 256),      # B = 2, the 256-voxel brick (two m-tiles a warp)
    (72, (1, 3, 5, 6), "wrap", None),     # Cb 36 padded to 48
    (10, (1, 4, 4, 8), "zeros", None),    # Cb 5, the smallest width of the route
])
def test_k3_bwd_brick_chain_matches_plain(c, shape, pad_mode, voxels):
    """K3 backward's two brick kernels and the contractions on what they
    write, transcribed (``emulate_k3_bwd_bricks``), against the autograd of
    the plain block (``preact_stack_bwd_plain``) on bf16-exact inputs: dx,
    dW1, dW2, dW3 and the 8 scalar grads per tensor within 1e-5 of max|ref|
    (float64 but for the plain side's dW of the 3x3x3 conv, which
    ``dw_conv3d_plain`` sums in fp32); every scratch voxel written once."""
    x, w1, w2, w3, sc8 = _fused_inputs(c, shape, 7 * c + shape[-1])
    gy = torch.from_numpy(bf16(np.random.default_rng(c).standard_normal(tuple(x.shape))))
    saves = x.permute(0, 2, 3, 4, 1)[None].contiguous()
    want = stack_kernel.preact_stack_bwd_plain(saves, gy, w1[None], w2[None], w3[None],
                                               sc8[None], pad_mode)
    got = emulate_k3_bwd_bricks(x, gy, w1, w2, w3, sc8, pad_mode, voxels)
    for name, a, r in zip(("dx", "dw1", "dw2", "dw3", "dsc"), got, want):
        r = r[0] if name != "dx" else r
        err, ref = float((a - r.double()).abs().max()), float(r.abs().max())
        assert err <= 1e-5 * ref, f"{name}: max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def emulate_k4_fwd_tc(x, cond, keep, p, w):
    """csrc/causal_stack.cu's tensor-core forward of one block, float64 and
    unrounded: a2 by tc_fwd_pre (W1e^T, be, Cb padded to 16), then
    tc_fwd_brick over ``bwd_plan``'s bricks: the a2 halo one s0-row behind
    (zero outside the grid), the union conv lane by lane (each lane's
    ldmatrix row its voxel's halo row at the tap's fwd_off, B fragments of
    wuf), the keep mask / (1 - p), the condition's product on wct and bc,
    t3, a3 and y = (a3 W3) * scale + b4 + x on w3t. Returns y."""
    ck = causal_kernel
    cu, cb = w.w1e.shape
    b_, s0, s1, s2, _ = x.shape
    nvox = b_ * s0 * s1 * s2
    cc = 0 if cond is None else cond.shape[-1]
    pk = {k: v[0].double().numpy() for k, v in
          ck.pack_bwd_tc_weights(ck.UnionWeights(*(None if t is None else t[None]
                                                  for t in w))).items()}
    b1a, b1b, b2a, b2b, b3a, b3b, b4, scale = w.sc.double().numpy()
    (n0, n1, n2), _ = ck.bwd_plan(b_, s0, s1, s2)
    cup = pk["w3"].shape[-1]
    xl = x.reshape(nvox, cu).double().numpy()
    a1 = np.pad(_elu(xl + b1a) + b1b, ((0, 0), (0, cup - cu)))
    a2 = np.zeros((nvox, 16))
    a2[:, :cb] = (_elu(a1 @ pk["w1e"].T + np.pad(pk["be"], (0, 16 - cb)) + b2a) + b2b)[:, :cb]
    h1, h2 = n1 + 2, n2 + 2
    r = np.arange(n0 * n1 * n2)
    hr = np.arange((n0 + 1) * h1 * h2)
    base = ((r // (n1 * n2)) * h1 + r // n2 % n1) * h2 + r % n2
    fwd_off = [((t // 9) * h1 + t // 3 % 3) * h2 + t % 3 for t in range(18)]
    arow, acol = (LANE & 7) + 8 * (LANE >> 3 & 1), 8 * (LANE >> 4)
    nbr = (-(-s0 // n0), -(-s1 // n1), -(-s2 // n2))
    y = np.full((nvox, cu), np.nan)
    for bi in range(b_ * int(np.prod(nbr))):
        i = bi
        i2, i = i % nbr[2] * n2, i // nbr[2]
        i1, i = i % nbr[1] * n1, i // nbr[1]
        bb, i0 = i // nbr[0], i % nbr[0] * n0
        a, bq, cq = i0 + r // (n1 * n2), i1 + r // n2 % n1, i2 + r % n2
        rows = np.where((a < s0) & (bq < s1) & (cq < s2), ((bb * s0 + a) * s1 + bq) * s2 + cq, -1)
        a, bq, cq = i0 - 1 + hr // (h1 * h2), i1 - 1 + hr // h2 % h1, i2 - 1 + hr % h2
        ok = (a >= 0) & (a < s0) & (bq >= 0) & (bq < s1) & (cq >= 0) & (cq < s2)
        hv = np.where(ok, ((bb * s0 + a) * s1 + bq) * s2 + cq, -1)
        halo = np.pad(np.where(hv[:, None] >= 0, a2[np.maximum(hv, 0)], 0.0),
                      ((0, 0), (0, 8))).ravel()
        cv = np.zeros((len(r), 16))
        for m0 in range(0, len(r), 16):
            a0 = base[m0 + arow] * 24 + acol
            frag = np.zeros((2, 32, 4))
            for tap, off in enumerate(fwd_off):
                fa = ldmatrix(halo, a0 + off * 24, 4, False)
                for n in range(2):
                    frag[n] = mma(frag[n], fa, pk["wuf"][tap][n * 8 + b_map(16)[1], b_map(16)[0]],
                                  16)
            for n in range(2):
                cv[m0:m0 + 16, 8 * n:8 * n + 8] = _c_tile(frag[n])
        if keep is not None:
            cv[:, :cb] = np.where(keep.double().numpy()[bb] > 0, cv[:, :cb] / (1 - p), 0.0)
        if cond is not None:
            cs = np.where(rows[:, None] >= 0,
                          cond.reshape(nvox, cc).double().numpy()[np.maximum(rows, 0)], 0.0)
            cv[:, :cb] += (np.pad(cs, ((0, 0), (0, pk["wct"].shape[-1] - cc))) @ pk["wct"].T)[:, :cb] \
                + pk["bc"]
        good = rows >= 0
        a3 = np.where(good[:, None] & (np.arange(16) < cb), _elu(cv + b3a) + b3b, 0.0)
        yv = (a3 @ pk["w3t"].T)[:, :cu] * scale + b4
        y[rows[good]] = yv[good] + xl[rows[good]]
    assert not np.isnan(y).any(), "a voxel no brick wrote"
    return torch.from_numpy(y.reshape(x.shape))


@pytest.mark.parametrize("case", [
    (16, 4, 16, 1, (3, 5, 6), 0.5),   # the top prior's widths, a condition, a keep mask
    (16, 4, 0, 2, (4, 3, 5), 0.5),    # unconditioned, B = 2, a keep mask
    (6, 1, 6, 1, (2, 9, 17), 0.0),    # Cb = 3, Cu = 18, ragged bricks on every axis
])
def test_k4_tensor_core_forward_matches_plain(case):
    """K4's tensor-core forward brick, transcribed (``emulate_k4_fwd_tc``),
    against ``causal_block_plain`` on bf16-exact float64 inputs within 1e-5
    of max|ref| (the plain block widens to fp32 for its dots and the conv;
    the transcription sums in float64, in another order)."""
    saves, _, cond, keep, p, w = _k4_case(*case[:5], case[5], 1, seed=sum(case[:4]) + 7)
    w1 = causal_kernel.union_block(w, 0)
    x = saves[0]
    kp = None if keep is None else keep[0]
    want = causal_kernel.causal_block_plain(x, cond, kp, p, w1)
    got = emulate_k4_fwd_tc(x, cond, kp, p, w1)
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    assert err <= 1e-5 * ref, f"max|d|={err:.3g} > 1e-5 x {ref:.3g}"


def test_k3_bwd_and_k4_fwd_routes_at_the_published_widths():
    """The brick route of K3's backward is taken where the forward takes
    'fused_tc' (bf16, 5 <= Cb <= 128): at every stack of the published full
    config at both stems (bench.py:117-128) but the Cb <= 4 ones; fp32 never.
    K4's tensor-core forward takes the top prior (Cu 48, Cb 12, Cc 16) in
    bf16, not the 256- and 512-wide priors (they run the stock blocks), not
    fp32; the two K4 routes agree everywhere."""
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    full = dict(num_embeddings=(128, 256, 512), n_pre_quantization_blocks=50,
                n_post_quantization_blocks=50, n_post_downscale_blocks=2,
                n_post_upscale_blocks=3, pad_mode="wrap")
    widths = set()
    for stem in (dict(), dict(base_network_channels=8, stem_space_to_depth=2)):
        widths |= {c for _, c, _, _ in VQVAEConfig(**full, **stem).same_stacks((512, 512, 128))}
    assert widths == {2, 4, 8, 16, 18, 32, 64, 72, 128, 256}
    for c in sorted(widths):
        cb = max(c // 2, 1)
        assert conv3d.stack_bwd_brick_route(torch.bfloat16, cb) == (cb >= 5), c
        assert not conv3d.stack_bwd_brick_route(torch.float32, cb)
        assert conv3d.stack_bwd_brick_route(torch.bfloat16, cb) == \
            (conv3d.stack_fwd_route(torch.bfloat16, cb) == "fused_tc")
    assert not conv3d.stack_bwd_brick_route(torch.bfloat16, 129)
    fwd, bwd = conv3d.causal_fwd_tensor_core_route, conv3d.causal_bwd_tensor_core_route
    for cu, cb, cc in ((48, 12, 16), (48, 12, 0), (768, 192, 768), (1536, 384, 0), (18, 3, 6)):
        for dt in (torch.bfloat16, torch.float32):
            assert fwd(dt, cu, cb, cc) == bwd(dt, cu, cb, cc)
    assert fwd(torch.bfloat16, 48, 12, 16) and not fwd(torch.float32, 48, 12, 16)
    assert not fwd(torch.bfloat16, 768, 192, 768)
