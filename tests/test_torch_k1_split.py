"""K1a / K1b's work split (csrc/l2_argmin.cuh, l2_argmin.cu), transcribed in
numpy: the codebook staged with its norms, each row group's lanes walking
codes s, s + S, ... with a strict '<', the xor butterfly that combines their
(dist, k) pairs lexicographically, and the rows each CTA and thread own.

The codebooks carry exact ties planted across the split's boundaries
(duplicated rows k < k' in different lanes' codes, and in the same lane's),
which must go to the lowest k, as in ``l2_argmin_plain`` and the JAX
package's ``l2_argmin_ref``. Elsewhere the transcription (a distance as
|e|^2 + sum_j (-2 x_j) e_j in fp32, products and sums rounded apart where
the kernel fuses them in FMAs) may differ from the plain version only at
genuine ties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.ops.quantizer_ops import l2_argmin_ref
from vqvae3d_tpu_torch.ops import quantizer_ops as qo


def emulate_lookup(flat: np.ndarray, embed: np.ndarray, plan: qo.LookupPlan) -> np.ndarray:
    """The indices K1a writes under ``plan``, lane by lane; asserts that the
    lanes s = 0 of the tiles' row groups write every row once."""
    n, d = flat.shape
    k = embed.shape[0]
    dt, rows, lanes = plan.dt, plan.rows, plan.lanes
    se = np.zeros((k, qo.code_stride(dt)), np.float32)  # stage_codebook
    se[:, :d] = embed
    norm = np.zeros(k, np.float32)
    for j in range(d):
        norm = norm + se[:, j] * se[:, j]
    se[:, dt] = norm
    xm = np.zeros((n, dt), np.float32)
    xm[:, :d] = np.float32(-2) * flat
    dist = np.tile(se[None, :, dt], (n, 1))
    for j in range(dt):  # the chain from the norm in j order, zeros past d
        dist = dist + xm[:, j : j + 1] * se[None, :, j]
    # each lane: its codes in increasing order from (inf, s), strict '<'
    bd = np.full((n, lanes), np.inf, np.float32)
    bk = np.tile(np.arange(lanes), (n, 1))
    for s in range(lanes):
        for c in range(s, k, lanes):
            take = dist[:, c] < bd[:, s]
            bd[take, s], bk[take, s] = dist[take, c], c
    o = lanes // 2
    while o:  # the xor butterfly: every lane ends with the group's pair
        pd, pk = bd[:, np.arange(lanes) ^ o], bk[:, np.arange(lanes) ^ o]
        take = (pd < bd) | ((pd == bd) & (pk < bk))
        bd, bk = np.where(take, pd, bd), np.where(take, pk, bk)
        o //= 2
    assert (bk == bk[:, :1]).all()
    idx = np.full(n, -1, np.int64)
    for cta in range(plan.tiles):
        for r in range(rows):
            for t in range(0, qo.THREADS, lanes):  # lane s = 0 of each row group
                row = cta * plan.tile_rows + r * (qo.THREADS // lanes) + t // lanes
                if row < n:
                    assert idx[row] == -1, "a row written twice"
                    idx[row] = bk[row, 0]
    assert (idx >= 0).all(), "a row never written"
    return idx


def planted(n: int, k: int, d: int, lanes: int, seed: int):
    """A codebook whose duplicated rows k < k' fall in different lanes'
    codes (k' - k not a multiple of ``lanes``) and in the same lane's, and
    rows next to each duplicated code: (flat, embed, rows, their code)."""
    rng = np.random.default_rng(seed)
    embed = rng.standard_normal((k, d)).astype(np.float32)
    pairs = [(a, b) for a, b in ((0, k - 1), (1, 1 + lanes), (2, 3), (k // 2, k - 2)) if a < b < k]
    for a, b in pairs:
        embed[b] = embed[a]
    flat = rng.standard_normal((n, d)).astype(np.float32)
    rows = np.arange(0, n, 3)[: 4 * len(pairs)]
    near = [pairs[i % len(pairs)][0] for i in range(len(rows))]
    # the lowest code equal to the one each row lies next to
    codes = np.array([np.flatnonzero((embed == embed[a]).all(1))[0] for a in near], np.int64)
    if len(rows):
        noise = rng.standard_normal((len(rows), d)).astype(np.float32)
        flat[rows] = embed[codes] + np.float32(1e-3) * noise
    return flat, embed, rows, codes


def check_lookup(flat, embed, plan, rows, codes):
    got = emulate_lookup(flat, embed, plan)
    ft, et = torch.from_numpy(flat), torch.from_numpy(embed)
    plain = qo.l2_argmin_plain(ft, et).numpy()
    jax_idx = np.asarray(l2_argmin_ref(jnp.asarray(flat), jnp.asarray(embed))).astype(np.int64)
    np.testing.assert_array_equal(got[rows], codes)  # exact ties: the lowest k
    np.testing.assert_array_equal(plain[rows], codes)
    np.testing.assert_array_equal(jax_idx[rows], codes)
    for want in (plain, jax_idx):
        _, real = qo.genuine_ties(ft, et, torch.from_numpy(got), torch.from_numpy(want))
        assert real.numel() == 0


# (n, k, d): ragged n, k not a multiple of the split
@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (255, 37, 3), (257, 100, 8), (700, 77, 32),
                                   (1000, 13, 2), (300, 5, 64)])
def test_k1_split_of_lookup_plan(n, k, d):
    """The split ``lookup_plan`` picks, tiles and all."""
    plan = qo.lookup_plan(n, k, d)
    flat, embed, rows, codes = planted(n, k, d, plan.lanes, n + k)
    check_lookup(flat, embed, plan, rows, codes)


@pytest.mark.parametrize("rows,lanes", [(8, 1), (1, 1), (1, 2), (1, 8), (1, 32)])
@pytest.mark.parametrize("n,k,d", [(2100, 45, 2), (333, 70, 4)])
def test_k1_split_routes(n, k, d, rows, lanes):
    """Every route at small sizes: R rows a thread (the large-N route) and
    S lanes a row group, the ties planted across their lanes."""
    dt = next(c for c in qo.D_CAPS if c >= d)
    rows = min(rows, qo.rows_per_thread(dt))
    tile_rows = qo.THREADS // lanes * rows
    plan = qo.LookupPlan(dt, rows, lanes, -(-n // tile_rows))
    flat, embed, rr, codes = planted(n, k, d, lanes, 7 * lanes + rows)
    check_lookup(flat, embed, plan, rr, codes)


def test_k1_plans_at_the_main_path_shapes():
    """The three lookups of a 512x512x128 volume: the level-0 lookup keeps 8
    rows a thread, the others split the codebook, and none runs on one CTA;
    K1b's slabs fit beside the codebook (two at K = 512, D = 32)."""
    shapes = [(524288, 128, 2), (8192, 256, 8), (128, 512, 32)]
    plans = [qo.lookup_plan(*s) for s in shapes]
    assert [(p.rows, p.lanes, p.tiles) for p in plans] == [(8, 1, 256), (1, 8, 256), (1, 32, 16)]
    stats = [qo.stats_plan(*s) for s in shapes]
    assert [(p.ctas, p.slabs) for p in stats] == [(256, 8), (256, 8), (16, 2)]
    for (n, k, d), p in zip(shapes, stats):
        assert p.lookup == qo.lookup_plan(n, k, d)
        smem = 4 * (k * qo.code_stride(p.lookup.dt) + p.slabs * k * (d + 1))
        assert smem <= qo.SMEM_LIMIT


def test_k1_code_stride_spreads_a_quarter_warp_over_the_banks():
    """8 consecutive codes read with 16-byte loads hit 8 different groups of
    4 banks, and each code's norm lies inside its stride."""
    for dt in qo.D_CAPS:
        w = qo.code_stride(dt)
        assert w % 4 == 0 and w > dt
        groups = {(c * w // 4) % 8 for c in range(8)}
        assert len(groups) == 8, dt
