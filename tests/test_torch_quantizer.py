"""Parity of the port's quantizer (eval and train paths) with the JAX package.

Indices must be equal except at genuine ties: rows whose two candidate
codes lie within 1e-5 (relative, fp64) of each other, which fp32 sums in
another order may break either way. Loss and quantized values to 1e-6.
The fused lookup + statistics: counts exact where the indices agree, dw
within 1e-6 of max|dw|. The train path (first-pass init + EMA update) to
1e-5, with the commitment loss's gradient on the inputs: non-zero on the
pass that initialises the codebook, exactly zero after."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from vqvae3d_tpu.models.quantizer import QuantizerState, quantize as jquantize
from vqvae3d_tpu.ops.quantizer_ops import l2_argmin_ref, l2_argmin_stats_ref
from vqvae3d_tpu_torch.models import quantizer as tq
from vqvae3d_tpu_torch.models.quantizer import Quantizer, quantize
from vqvae3d_tpu_torch.ops.quantizer_ops import (
    genuine_ties,
    l2_argmin_plain,
    l2_argmin_stats_plain,
)


@pytest.mark.parametrize("n,k,d", [(20000, 128, 2), (4096, 256, 8), (128, 512, 32)])
def test_l2_argmin_plain_matches_jax(n, k, d):
    rng = np.random.default_rng(n)
    flat = rng.standard_normal((n, d)).astype(np.float32)
    embed = rng.standard_normal((k, d)).astype(np.float32)
    want = torch.from_numpy(np.array(l2_argmin_ref(jnp.asarray(flat), jnp.asarray(embed)))).long()
    got = l2_argmin_plain(torch.from_numpy(flat), torch.from_numpy(embed), chunk=3000)
    assert got.dtype == torch.int64
    ties, real = genuine_ties(torch.from_numpy(flat), torch.from_numpy(embed), got, want)
    assert real.numel() == 0 and ties.numel() <= n * 1e-3


def test_l2_argmin_ties_go_to_the_lowest_index():
    embed = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    flat = torch.tensor([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
    np.testing.assert_array_equal(l2_argmin_plain(flat, embed), [0, 0, 1])


def _jax_state(embed):
    return QuantizerState(
        jnp.asarray(embed), jnp.asarray(embed), jnp.zeros(embed.shape[0]), jnp.ones((), bool)
    )


def test_quantize_eval_matches_jax():
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((32, 4)).astype(np.float32)
    x = rng.standard_normal((2, 6, 5, 3, 4)).astype(np.float32)  # JAX (B, H, W, D, C)
    jloss, jq, jidx, _ = jquantize(_jax_state(embed), jnp.asarray(x), train=False,
                                   argmin_method="ref")
    loss, q, idx = quantize(torch.from_numpy(x).movedim(-1, 1), torch.from_numpy(embed))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.movedim(1, -1).numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_quantizer_module_casts_back_and_embeds_codes():
    qz = Quantizer(16, 4)
    qz.reset_parameters(torch.Generator().manual_seed(0))
    assert bool(qz.first_pass) and torch.equal(qz.embed, qz.embed_avg)
    x = torch.randn(1, 4, 3, 3, 2, dtype=torch.float64)
    loss, q, idx = qz(x)
    assert q.dtype == torch.float64 and idx.shape == (1, 3, 3, 2)
    np.testing.assert_allclose(q.movedim(1, -1).numpy(), qz.embed_code(idx).numpy(), atol=1e-6)
    qz(x, train=True)  # the train path (no longer refused) initialises the codebook
    assert not bool(qz.first_pass) and not torch.equal(qz.embed, qz.embed_avg)
    assert sorted(qz.state_dict()) == ["cluster_size", "embed", "embed_avg", "first_pass"]


@pytest.mark.parametrize("n,k,d", [(20000, 128, 2), (4096, 256, 8), (128, 512, 32)])
def test_l2_argmin_stats_plain_matches_jax(n, k, d):
    rng = np.random.default_rng(n + 1)
    flat = rng.standard_normal((n, d)).astype(np.float32)
    embed = rng.standard_normal((k, d)).astype(np.float32)
    j_idx, j_counts, j_dw = (np.asarray(a) for a in
                             l2_argmin_stats_ref(jnp.asarray(flat), jnp.asarray(embed)))
    idx, counts, dw = l2_argmin_stats_plain(torch.from_numpy(flat), torch.from_numpy(embed))
    assert idx.dtype == torch.int64 and counts.dtype == dw.dtype == torch.float32
    _, real = genuine_ties(torch.from_numpy(flat), torch.from_numpy(embed), idx,
                           torch.from_numpy(j_idx).long())
    assert real.numel() == 0
    if np.array_equal(idx.numpy(), j_idx):
        np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_allclose(dw.numpy(), j_dw, atol=1e-6 * np.abs(j_dw).max(), rtol=0)


@pytest.mark.parametrize("initialized", [False, True])
def test_quantize_train_matches_jax(initialized):
    rng = np.random.default_rng(7)
    k, d = 16, 4
    embed = rng.standard_normal((k, d)).astype(np.float32)
    cs = np.full(k, 2.0, np.float32) if initialized else np.zeros(k, np.float32)
    x = (rng.standard_normal((2, 6, 5, 3, d)) * 1.5 + 0.3).astype(np.float32)  # JAX layout
    jstate = QuantizerState(jnp.asarray(embed), jnp.asarray(embed), jnp.asarray(cs),
                            jnp.asarray(initialized))

    def jloss(xx):
        loss, q, idx, new = jquantize(jstate, xx, train=True, argmin_method="ref")
        return loss, (q, idx, new)

    (jl, (jq, jidx, jnew)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    state = tq.QuantizerState(torch.from_numpy(embed), torch.from_numpy(embed.copy()),
                              torch.from_numpy(cs), torch.tensor(not initialized))
    xt = torch.from_numpy(x).movedim(-1, 1).requires_grad_()
    loss, q, idx, new = tq.quantize_train(xt, state)
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(q.detach().movedim(1, -1).numpy(), np.asarray(jq), atol=1e-5)
    for name, a, b in zip(("embed", "embed_avg", "cluster_size"), new, jnew):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert not bool(new.first_pass) and bool(jnew.initialized)
    jg = np.asarray(jgrad)
    if initialized:
        assert not np.any(jg) and not torch.any(grad)
    else:
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(grad.movedim(1, -1).numpy(), jg,
                                   atol=1e-5 * np.abs(jg).max(), rtol=0)


def _graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(next_fn for next_fn, _ in node.next_functions)
    return {type(node).__name__ for node in seen}


@pytest.mark.parametrize("first_pass", [True, False])
def test_train_path_scatters_nothing_into_the_codebook(first_pass, monkeypatch):
    """The train path's autograd graph (from the loss, and through the module
    with its in-place buffer update) holds no gather or scatter backward
    (IndexBackward / IndexPutBackward): the codebook takes no gradient. The
    rows it quantizes to are the post-EMA codebook's rows at the indices, bit
    for bit; the backward runs after the buffers changed."""
    rng = np.random.default_rng(11)
    k, d = 16, 4
    embed = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    state = tq.QuantizerState(embed, embed.clone(), torch.full((k,), 0.0 if first_pass else 2.0),
                              torch.tensor(first_pass))
    x = torch.from_numpy(rng.standard_normal((2, d, 5, 3, 4)).astype(np.float32)).requires_grad_()
    rows_seen = []
    finish = tq._finish
    monkeypatch.setattr(tq, "_finish", lambda *a: rows_seen.append(a[2]) or finish(*a))
    loss, q, idx, new = tq.quantize_train(x, state)
    nodes = _graph_nodes(loss.grad_fn) | _graph_nodes(q.grad_fn)
    assert not any(n.startswith(("IndexBackward", "IndexPutBackward")) for n in nodes), nodes
    assert torch.equal(rows_seen[0], new.embed[idx.reshape(-1)])
    qz = Quantizer(k, d)
    qz.reset_parameters(torch.Generator().manual_seed(1))
    qz.first_pass.fill_(first_pass)
    loss, q, _ = qz(x, train=True)
    assert not any(n.startswith(("IndexBackward", "IndexPutBackward"))
                   for n in _graph_nodes(loss.grad_fn))
    (grad,) = torch.autograd.grad(loss, x)
    assert bool(torch.any(grad)) == first_pass
