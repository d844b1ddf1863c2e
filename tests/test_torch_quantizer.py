"""Parity of the port's quantizer (eval path) with the JAX package.

Indices must be equal except at genuine ties: rows whose two candidate
codes lie within 1e-5 (relative, fp64) of each other, which fp32 sums in
another order may break either way. Loss and quantized values to 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.models.quantizer import QuantizerState, quantize as jquantize
from vqvae3d_tpu.ops.quantizer_ops import l2_argmin_ref
from vqvae3d_tpu_torch.models.quantizer import Quantizer, quantize
from vqvae3d_tpu_torch.ops.quantizer_ops import genuine_ties, l2_argmin_plain


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
    with pytest.raises(NotImplementedError):
        qz(x, train=True)
    assert sorted(qz.state_dict()) == ["cluster_size", "embed", "embed_avg", "first_pass"]
