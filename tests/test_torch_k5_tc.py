"""K5's bf16 tensor-core route (csrc/flash_dropout_attention.cu::
flash_dropout_fwd_tc, csrc/flash_dropout_attention_bwd.cu::drop_dq_tc and
drop_dkdv_tc, the mask placement of csrc/dropout_tc.cuh) transcribed register
by register in numpy, on the CPU, where no card runs it.

The transcriptions are K8's (``test_torch_tc_tiles.py``: the fragment maps,
ldmatrix addresses and C -> A re-packs of flash_fwd_tc, bwd_dq_tc and
bwd_dkdv_tc) with K5's mask on the C fragments:

  * the lane-pair Philox split: over a 64-key tile the even lane of each
    pair (l, l ^ 1) makes the 8 calls of its row g, the odd lane those of row
    g + 8, every (row, group of 4 keys) of the tile once; one xor-1 shuffle
    gives each lane the other row's word; every C element's bit equals
    ``keep_mask`` (padded rows and keys included);
  * the packed tiles: the query-major pass stores each lane's word at
    32 w + l of its tile, the key-major pass reads its columns from the
    staged 512 bytes (eight 8-byte loads a lane); every element it reads
    equals ``keep_mask``, and ``unpack_tile_bits`` reads the same layout;
  * the outputs against the plain version, which rounds where the kernel
    rounds: o within 2^-7 of max|ref| (one bf16 step: the plain version
    rounds P at the row's final max, the kernel at each tile's running max),
    unrounded within 1e-5 of the fp32 plain version; the gradients within
    1e-3 of max|ref| before their last rounding (1e-5 unrounded), as K8's
    tests hold K8's; at S in {1, 65, 130}, D in {8, 16}, p in {0.5, 0.9}.

This file imports no jax.
"""
import numpy as np
import pytest
import torch

from test_torch_tc_tiles import G, LANE, T, a_frags, bf16, mma_abt, mma_px, pack_a, quad, \
    smem_rows, store_rows
from vqvae3d_tpu_torch.ops import flash_dropout_attention as fd

LOG2E = np.log2(np.e)
SEED = (123456789, 2**32 - 5)
E = np.arange(4)  # C element e: row r0 (e < 2) or r1, column 2 t + (e & 1)


def lane_keep_words(n, kt, r0, r1, thr, calls=None):
    """dtc::lane_keep_word for the 32 lanes of a warp: (32,) words, bit
    4 nb + b for key 64 kt + 8 nb + 4 (t / 2) + b of the lane's own row (r0
    when even, r1 when odd). ``calls`` collects each call's (row, group)."""
    row = np.where(LANE & 1, r1, r0)[:, None]
    grp = 16 * kt + 2 * np.arange(8)[None] + (T >> 1)[:, None]  # (32, 8)
    if calls is not None:
        calls += list(zip(np.broadcast_to(row, grp.shape).ravel(), grp.ravel()))
    words = fd.philox4x32_10(grp, row, n, 0, SEED[0], SEED[1])
    word = np.zeros(32, np.int64)
    for b, w in enumerate(words):
        keep = np.broadcast_to(w, grp.shape) >= thr
        word |= (keep.astype(np.int64) << (4 * np.arange(8) + b)).sum(-1)
    return word


def row_kept(mine):
    """dtc::row_bits + row_kept: the xor-1 exchange, then the (8 nb, 32
    lanes, 4 e) keep bits of the C fragments."""
    other = mine[LANE ^ 1]
    sh = 2 * (LANE & 1)
    r0w = np.where(LANE & 1, other, mine) >> sh
    r1w = np.where(LANE & 1, mine, other) >> sh
    word = np.where(E[None] < 2, r0w[:, None], r1w[:, None])  # (lane, e)
    return ((word[None] >> (4 * np.arange(8)[:, None, None] + (E & 1)[None, None])) & 1) == 1


def column_kept(bs, warp):
    """dtc::column_bits + column_kept: the key-major lane's (8 nb, 32, 4 e)
    bits from a tile's 128 staged words."""
    sh = 8 * warp + (G & 3)
    wd = np.zeros((8, 2, 32), np.int64)
    for m in range(4):
        for e1 in range(2):
            idx = 32 * m + 8 * T + 4 * e1 + 2 * (G >> 2)  # an 8-byte load: words idx, idx + 1
            wd[2 * m, e1], wd[2 * m + 1, e1] = bs[idx] >> sh, bs[idx + 1] >> sh
    return ((wd[:, E & 1].transpose(0, 2, 1) >> (4 * (E >> 1))[None, None]) & 1) == 1


def _keys_cols(kt):
    """(8 nb, 32 lanes, 4 e) key (or query) index of each C element's column."""
    return 64 * kt + 8 * np.arange(8)[:, None, None] + 2 * T[None, :, None] + (E & 1)[None, None]


def emulate_k5_fwd_tc(q, k, v, scale, p, round_p, keep, bad):
    """flash_dropout_fwd_tc in numpy: (o before its rounding, lse). ``keep``:
    the (N, S', S') keep mask over the padded tiles; ``bad`` counts C
    elements whose bit differs from it."""
    n_, s_, d_ = q.shape
    nqt, thr = -(-s_ // 64), fd.keep_threshold(p)
    c_lse = scale / (1 - p)
    c_keep, neg_raw = c_lse * LOG2E, -1000.0 / c_lse  # a dropped logit in units of the dot
    rnd = bf16 if round_p else (lambda a: a)
    o, lse = np.zeros_like(q), np.zeros((n_, s_))
    for n in range(n_):
        for y in range(nqt):
            qt = nqt - 1 - y
            for warp in range(4):
                r0 = 64 * qt + 16 * warp + G
                rows = np.where(E[None] < 2, r0[:, None], r0[:, None] + 8)  # (lane, e)
                qa = a_frags(q[n], r0, d_)
                m0, m1 = np.full(32, -np.inf), np.full(32, -np.inf)
                l0, l1 = np.zeros(32), np.zeros(32)
                oacc = np.zeros((d_ // 8, 32, 4))
                for kt in range(qt + 1):
                    kept = row_kept(lane_keep_words(n, kt, r0, r0 + 8, thr)) if thr else \
                        np.ones((8, 32, 4), bool)
                    keys = _keys_cols(kt)
                    bad[0] += int((kept != keep[n, np.broadcast_to(rows, keys.shape), keys]).sum())
                    ks, vs = smem_rows(k[n], 64 * kt, d_), smem_rows(v[n], 64 * kt, d_)
                    x = np.where(kept, mma_abt(qa, ks, d_), neg_raw)
                    if kt == qt:
                        x[keys > rows[None]] = -np.inf
                    mx0 = quad(np.maximum(m0, x[:, :, :2].max((0, 2))), np.maximum)
                    mx1 = quad(np.maximum(m1, x[:, :, 2:].max((0, 2))), np.maximum)
                    al0, al1 = np.exp2((m0 - mx0) * c_keep), np.exp2((m1 - mx1) * c_keep)
                    m0, m1 = mx0, mx1
                    pr = np.exp2(x * c_keep - np.stack([m0, m0, m1, m1], 1) * c_keep)
                    l0 = l0 * al0 + pr[:, :, :2].sum((0, 2))
                    l1 = l1 * al1 + pr[:, :, 2:].sum((0, 2))
                    oacc *= np.stack([al0, al0, al1, al1], 1)
                    oacc = mma_px(oacc, pack_a(pr, rnd), vs, d_)
                l0, l1 = quad(l0, np.add), quad(l1, np.add)
                store_rows(o[n], oacc / np.stack([l0, l0, l1, l1], 1), r0, d_)
                for r, l, m in ((r0, l0, m0), (r0 + 8, l1, m1)):
                    first = (r < s_) & (T == 0)
                    lse[n, r[first]] = m[first] * c_lse + np.log(l[first])
    return o, lse


def emulate_k5_bwd_tc(q, k, v, o, lse, do, scale, p, round_bf16, keep, bad, calls):
    """drop_dq_tc (delta, the packed keep bits, dq) then drop_dkdv_tc (dk,
    dv from the staged bits) in numpy: (dq, dk, dv before their rounding,
    the packed bits (N, T, 128), delta). ``calls`` collects, per tile, the
    (row, group) of each Philox call of the query-major pass."""
    n_, s_, d_ = q.shape
    nt, thr = -(-s_ // 64), fd.keep_threshold(p)
    c_ds = scale / (1 - p)
    c_keep, neg_raw = c_ds * LOG2E, -1000.0 / c_ds
    rnd = bf16 if round_bf16 else (lambda a: a)
    bits = np.zeros((n_, fd.packed_tiles(s_), 128), np.int64)
    delta = np.zeros((n_, s_))
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for n in range(n_):
        for y in range(nt):
            qt = nt - 1 - y
            for warp in range(4):
                r0 = 64 * qt + 16 * warp + G
                rows = np.where(E[None] < 2, r0[:, None], r0[:, None] + 8)
                ok = rows < s_
                qa, doa, oa = (a_frags(x[n], r0, d_) for x in (q, do, o))
                part = [sum(doa[kk][:, c] * oa[kk][:, c] for kk in range(len(oa))
                            for c in range(oa[0].shape[1]) if (c >> 1) % 2 == h) for h in (0, 1)]
                dl = np.stack([quad(part[0], np.add)] * 2 + [quad(part[1], np.add)] * 2, 1)
                for e0 in (0, 2):
                    first = ok[:, e0] & (T == 0)
                    delta[n, rows[first, e0]] = dl[first, e0]
                lb = np.where(ok, lse[n, np.minimum(rows, s_ - 1)], 0.0) * LOG2E
                dqa = np.zeros((d_ // 8, 32, 4))
                for kt in range(qt + 1):
                    kept = np.ones((8, 32, 4), bool)
                    if thr:
                        tile_calls = calls.setdefault((n, qt, kt), [])
                        mine = lane_keep_words(n, kt, r0, r0 + 8, thr, tile_calls)
                        bits[n, qt * (qt + 1) // 2 + kt, 32 * warp + LANE] = mine
                        kept = row_kept(mine)
                    keys = _keys_cols(kt)
                    bad[0] += int((kept != keep[n, np.broadcast_to(rows, keys.shape), keys]).sum())
                    ks, vs = smem_rows(k[n], 64 * kt, d_), smem_rows(v[n], 64 * kt, d_)
                    s, dp = mma_abt(qa, ks, d_), mma_abt(doa, vs, d_)
                    live = kept & ~((kt == qt) & (keys > rows[None]))
                    with np.errstate(over="ignore", invalid="ignore"):  # ex2 past the row: +inf
                        pr = np.exp2(s * c_keep - lb[None])
                        ds = np.where(live, pr * (dp - dl[None]) * c_ds, 0.0)
                    dqa = mma_px(dqa, pack_a(ds, rnd), ks, d_)
                store_rows(dq[n], dqa, r0, d_)
        for kt in range(nt):
            for warp in range(4):
                j0 = 64 * kt + 16 * warp + G
                keyrow = np.where(E[None] < 2, j0[:, None], j0[:, None] + 8)  # (lane, e)
                ka, va = a_frags(k[n], j0, d_), a_frags(v[n], j0, d_)
                dka, dva = np.zeros((d_ // 8, 32, 4)), np.zeros((d_ // 8, 32, 4))
                for qt in range(kt, nt):
                    qs, dos = smem_rows(q[n], 64 * qt, d_), smem_rows(do[n], 64 * qt, d_)
                    cols = _keys_cols(qt)  # the queries of the C elements
                    qin = np.minimum(cols, s_ - 1)
                    ls = np.where(cols < s_, lse[n, qin], 0.0) * LOG2E
                    dls = np.where(cols < s_, delta[n, qin], 0.0)
                    kept = column_kept(bits[n, qt * (qt + 1) // 2 + kt], warp) if thr else \
                        np.ones((8, 32, 4), bool)
                    bad[0] += int((kept != keep[n, cols, np.broadcast_to(keyrow, cols.shape)]).sum())
                    s, dp = mma_abt(ka, qs, d_), mma_abt(va, dos, d_)
                    x = np.where(kept, s, neg_raw)
                    if qt == kt:
                        x[cols < keyrow[None]] = -np.inf
                    pr = np.exp2(x * c_keep - ls)
                    ds = np.where(kept, pr * (dp - dls) * c_ds, 0.0)
                    dva = mma_px(dva, pack_a(pr, rnd), dos, d_)
                    dka = mma_px(dka, pack_a(ds, rnd), qs, d_)
                store_rows(dk[n], dka, j0, d_)
                store_rows(dv[n], dva, j0, d_)
    return dq, dk, dv, bits, delta


def _case(s, d, p):
    rng = np.random.default_rng(1000 * s + 10 * d + int(10 * p))
    q, k, v, do = (bf16(rng.standard_normal((2, s, d))) for _ in range(4))
    pad = 64 * -(-s // 64)
    keep = fd.keep_mask(torch.tensor(SEED), 2, torch.arange(pad), pad, p).numpy()
    return q, k, v, do, keep


def _t(a, dtype):
    return torch.tensor(a, dtype=dtype)


@pytest.mark.parametrize("p", [0.5, 0.9])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("s", [1, 65, 130])
def test_k5_tensor_core_forward_matches_plain(s, d, p):
    """flash_dropout_fwd_tc transcribed: every C element's keep bit (the
    lane-pair calls and the xor-1 exchange) equals keep_mask; o against the
    rounding plain version within 2^-7 of max|ref| (1e-5 unrounded against
    the fp32 one); lse within 1e-6."""
    q, k, v, _, keep = _case(s, d, p)
    scale, seed = d ** -0.5, torch.tensor(SEED)
    for round_p, dtype, tol in ((False, torch.float32, 1e-5), (True, torch.bfloat16, 2**-7)):
        bad = [0]
        o, lse = emulate_k5_fwd_tc(q, k, v, scale, p, round_p, keep, bad)
        assert bad[0] == 0, f"{bad[0]} C elements' keep bits differ from keep_mask"
        want, want_lse = fd._plain_fwd(*(_t(a, dtype) for a in (q, k, v)), scale, p, seed, None)
        want = want.to(dtype).double().numpy()
        err, ref = float(np.abs(o - want).max()), float(np.abs(want).max())
        assert err <= tol * ref, f"round_p={round_p}: max|d|={err:.3g} > {tol} x {ref:.3g}"
        np.testing.assert_allclose(lse, want_lse.double().numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, float(want_lse.abs().max())))


@pytest.mark.parametrize("p", [0.5, 0.9])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("s", [1, 65, 130])
def test_k5_tensor_core_backward_and_packed_bits(s, d, p):
    """drop_dq_tc then drop_dkdv_tc transcribed: the query-major pass makes
    each (row, group of 4 keys) Philox call of a tile once; the bits the
    key-major pass reads from the staged tile equal keep_mask, and so does
    ``unpack_tile_bits`` of the packed buffer; the gradients against the
    plain backward on the same o and lse within 1e-3 of max|ref| rounding
    P and ds to bf16 (1e-5 unrounded, fp32); delta is rowsum(do o)."""
    q, k, v, do, keep = _case(s, d, p)
    scale, seed = d ** -0.5, torch.tensor(SEED)
    # the forward in float64: logits after dropout, lse and o
    x = np.where(keep[:, :s, :s], np.einsum("nid,njd->nij", q, k) * scale / (1 - p), -1000.0)
    x[:, ~np.tri(s, dtype=bool)] = -np.inf
    mx = x.max(-1, keepdims=True)
    lse = (np.log(np.exp(x - mx).sum(-1, keepdims=True)) + mx)[..., 0]
    o64 = np.einsum("nij,njd->nid", np.exp(x - lse[..., None]), v)
    for round_p, dtype, tol in ((False, torch.float32, 1e-5), (True, torch.bfloat16, 1e-3)):
        o = bf16(o64) if round_p else o64
        bad, calls = [0], {}
        dq, dk, dv, bits, delta = emulate_k5_bwd_tc(q, k, v, o, lse, do, scale, p, round_p, keep,
                                                    bad, calls)
        assert bad[0] == 0, f"{bad[0]} C elements' keep bits differ from keep_mask"
        for (n, qt, kt), got in calls.items():
            assert sorted(got) == sorted({(64 * qt + r, 16 * kt + c) for r in range(64)
                                          for c in range(16)}), (n, qt, kt)
        unpacked = fd.unpack_tile_bits(torch.from_numpy(bits.astype(np.uint32).view(np.int32)), s)
        tril = np.tri(s, dtype=bool)
        assert np.array_equal(unpacked.numpy()[:, tril], keep[:, :s, :s][:, tril])
        np.testing.assert_allclose(delta, (do * o).sum(-1), rtol=0, atol=1e-12)
        want = fd._plain_bwd_fp32(*(_t(a, dtype) for a in (q, k, v, o)), _t(lse, torch.float32),
                                  _t(do, dtype), scale, p, seed, None)
        for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            w = w.double().numpy()
            err, ref = float(np.abs(a - w).max()), float(np.abs(w).max())
            bound = tol * ref
            if s == 1 and name != "dv":
                # zero in exact arithmetic (a kept key: ds = P (do.v - do.o),
                # o = v): the plain side's residue of its two D-term fp32
                # sums, as in K8's test, times 1 / (1 - p)
                other = k if name == "dq" else q
                bound = max(bound, 2 * (d - 1) * 2**-24 * float(np.abs(do * v).sum(-1).max())
                            * scale / (1 - p) * float(np.abs(other).max()) * 1.01)
            assert err <= bound, (f"{name} round_p={round_p}: max|d|={err:.3g} > {bound:.3g} "
                                  f"(max|ref| {ref:.3g})")


def test_k5_route_and_packed_tiles():
    """bf16 takes the tensor cores, fp32 the CUDA cores, before any launch;
    a head dim outside {8, 16, 32} raises; the packed buffer holds the tiles
    on or below the diagonal."""
    for d in (8, 16, 32):
        assert fd.dropout_tensor_core_route(torch.bfloat16, d) is True
        assert fd.dropout_tensor_core_route(torch.float32, d) is False
    for d in (4, 24, 64):
        with pytest.raises(ValueError, match="D in"):
            fd.dropout_tensor_core_route(torch.bfloat16, d)
    assert [fd.packed_tiles(s) for s in (1, 64, 65, 130, 8192)] == [1, 1, 3, 6, 8256]
