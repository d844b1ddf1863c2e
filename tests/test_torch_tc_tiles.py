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

from vqvae3d_tpu_torch.ops import conv3d, flash_attention, stack_kernel

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
