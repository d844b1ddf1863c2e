"""The port's PixelCNN samplers against the JAX package, on the CPU.

Tiny sizes (input_dim 5, condition_dim 4, model_dim 8, 2 blocks, 3x4x3
grids from a 2x2x1 condition, batch 2); weights are a random JAX tree
carried across with ``jax_pixelcnn_params_to_state_dict``
(``test_torch_prior.jax_and_port_models``). The row function here is
``row_decode_plain`` (CPU tensors), K6's plain version.

  * teacher-forced, the cached sampler's logits (every voxel, through
    ``row_decode_plain``) equal the JAX one-shot ``PixelCNN.apply`` within
    1e-5 of max|ref| (fp32, summed in another order);
  * with the Gumbel table that JAX ``gumbel_row`` draws row by row in raster
    order (the key sequence of the JAX sampler's voxel loop,
    tests/test_cached_sample.py:133-162), the port's cached sampler gives
    exactly the grids of JAX ``cached_ancestral_sample``, conditioned and
    not;
  * the port's cached sampler gives exactly the port's naive sampler's grids
    for the same table, and both keep their noise on a ``torch.Generator``;
  * the row function checks: CPU tensors take the plain version (no launch);
    other devices raise; non-finite logits give index -1, and the cached
    sampler raises on them;
  * at ``kernel_size`` 5 (the sampler's own height and width row steps, no
    row kernel, as the JAX sampler's XLA row body) the same three checks,
    conditioned and not;
  * a Fixup or concat-activation PixelCNN in the cached sampler raises
    ``ValueError``, as the JAX sampler asserts (``--sampler naive`` takes
    them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_prior import COARSE, DIMS, jax_and_port_models, tiny_config

from vqvae3d_tpu.ops.decode_row import gumbel_row
from vqvae3d_tpu.sample.cached_sample import cached_ancestral_sample as jcached
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.ops import decode_row
from vqvae3d_tpu_torch.sample.ar_sample import ancestral_sample
from vqvae3d_tpu_torch.sample.cached_sample import _extract_layers, cached_ancestral_sample

B = 2
TAU = 0.7


def _jax_gumbel_table(seed: int) -> np.ndarray:
    """(s0, s1, s2, B, K): JAX gumbel_row over the rows in raster order."""
    rng = jax.random.PRNGKey(seed)
    rows = []
    for _ in range(DIMS[0] * DIMS[1]):
        rng, g = gumbel_row(rng, B, DIMS[2], 5)
        rows.append(np.asarray(g))
    return np.stack(rows).reshape(*DIMS[:2], DIMS[2], B, 5)


def _cond(with_cond, seed):
    if not with_cond:
        return None
    return np.random.default_rng(seed).integers(0, 4, (B, *COARSE))


@pytest.mark.parametrize("with_cond", [False, True])
def test_teacher_forced_logits_match_jax_forward(with_cond):
    jmodel, params, model = jax_and_port_models(tiny_config(with_cond), seed=60 + with_cond)
    rng = np.random.default_rng(61)
    grid = rng.integers(0, 5, (B, *DIMS))
    cond = _cond(with_cond, 62)
    got_grid, logits = cached_ancestral_sample(
        model, DIMS, B, None if cond is None else torch.from_numpy(cond), TAU,
        forced=torch.from_numpy(grid))
    want = np.asarray(jmodel.apply(
        {"params": params}, jax.nn.one_hot(grid, 5),
        None if cond is None else jax.nn.one_hot(cond, 4), train=False))
    np.testing.assert_array_equal(got_grid.numpy(), grid)
    got = logits.movedim(1, -1).numpy()
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 1e-5 * scale, f"max|d|={err:.3g} > 1e-5 x {scale:.3g}"


@pytest.mark.parametrize("with_cond", [False, True])
def test_cached_sampler_matches_jax_cached_sampler(with_cond):
    jmodel, params, model = jax_and_port_models(tiny_config(with_cond), seed=70 + with_cond)
    cond = _cond(with_cond, 71)
    seed = 13 + with_cond
    want = jcached(jmodel, params, jax.random.PRNGKey(seed), DIMS, B,
                   None if cond is None else jnp.asarray(cond, jnp.int32), tau=TAU)
    table = torch.from_numpy(_jax_gumbel_table(seed))
    got = cached_ancestral_sample(model, DIMS, B, None if cond is None else torch.from_numpy(cond),
                                  TAU, gumbel=table)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, *DIMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_cond", [False, True])
def test_cached_sampler_matches_naive_sampler(with_cond):
    _, _, model = jax_and_port_models(tiny_config(with_cond), seed=80 + with_cond)
    cond = _cond(with_cond, 81)
    cond_t = None if cond is None else torch.from_numpy(cond)
    table = -torch.empty(*DIMS, B, 5).exponential_(
        generator=torch.Generator().manual_seed(82)).log()
    naive = ancestral_sample(model, DIMS, B, cond_t, TAU, gumbel=table)
    cached = cached_ancestral_sample(model, DIMS, B, cond_t, TAU, gumbel=table)
    torch.testing.assert_close(cached, naive, rtol=0, atol=0)
    # noise from a generator: the same seed gives the same grids
    a, b = (cached_ancestral_sample(model, DIMS, B, cond_t, TAU,
                                    generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 5


def test_row_decode_dispatch():
    _, _, model = jax_and_port_models(tiny_config(False), seed=90)
    layers = _extract_layers(model)
    st = decode_row.stack_row_weights(layers, model.parse_input.weight, model.parse_input.bias,
                                      model.parse_output.weight, model.parse_output.bias)
    L, br, C, s2 = len(layers), st["w1"].shape[-1], 8, DIMS[2]
    g = torch.Generator().manual_seed(91)
    rows = [torch.randn(L, B, s2, br, generator=g) for _ in range(3)]
    dfin, sprev = torch.randn(B, s2, C, generator=g), torch.randn(B, s2, C, generator=g)
    gum = torch.randn(s2, B, 5, generator=g)
    before = decode_row.row_decode.launches
    vhc = rows[2].clone()
    idx, vhc2 = decode_row.row_decode(st, rows[0], rows[1], None, dfin, sprev, vhc, gum, 1, TAU)
    assert vhc2 is vhc and not torch.equal(vhc, rows[2])  # the caches update in place
    vhc_p = rows[2].clone()
    idx_p, _ = decode_row.row_decode_plain(st, rows[0], rows[1], None, dfin, sprev, vhc_p, gum,
                                           1, TAU)
    assert torch.equal(idx, idx_p) and torch.equal(vhc, vhc_p)
    assert decode_row.row_decode.launches == before
    with pytest.raises(NotImplementedError):
        decode_row.row_decode(st, *(t.to("meta") for t in rows[:2]), None, dfin, sprev, vhc,
                              gum, 1, TAU)


def test_non_finite_logits_are_reported():
    _, _, model = jax_and_port_models(tiny_config(False), seed=92)
    with torch.no_grad():
        model.parse_output.bias[2] = float("nan")
    layers = _extract_layers(model)
    st = decode_row.stack_row_weights(layers, model.parse_input.weight, model.parse_input.bias,
                                      model.parse_output.weight, model.parse_output.bias)
    L, br, C, s2 = len(layers), st["w1"].shape[-1], 8, DIMS[2]
    g = torch.Generator().manual_seed(93)
    rows = [torch.randn(L, B, s2, br, generator=g) for _ in range(3)]
    dfin, sprev = torch.randn(B, s2, C, generator=g), torch.randn(B, s2, C, generator=g)
    idx, _ = decode_row.row_decode(st, rows[0], rows[1], None, dfin, sprev, rows[2],
                                   torch.zeros(s2, B, 5), 1, TAU)
    assert torch.equal(idx, torch.full((B, s2), -1, dtype=torch.int32))
    with pytest.raises(FloatingPointError, match="non-finite logits"):
        cached_ancestral_sample(model, DIMS, B, None, TAU,
                                generator=torch.Generator().manual_seed(94))


@pytest.mark.parametrize("with_cond", [False, True])
def test_cached_sampler_at_kernel_size_5(with_cond):
    """The k = 5 row steps: forced logits against the JAX one-shot forward,
    free-running grids equal to JAX ``cached_ancestral_sample``'s (its XLA
    row body at k != 3) and, conditioned, to the port's naive sampler's for
    one table (the naive sampler's 36 forwards are this test's costliest
    part; the JAX grid pins the unconditioned case)."""
    fields = tiny_config(with_cond, kernel_size=5)
    jmodel, params, model = jax_and_port_models(fields, seed=95 + with_cond)
    cond = _cond(with_cond, 96)
    cond_t = None if cond is None else torch.from_numpy(cond)
    grid = np.random.default_rng(97).integers(0, 5, (B, *DIMS))
    _, logits = cached_ancestral_sample(model, DIMS, B, cond_t, TAU,
                                        forced=torch.from_numpy(grid))
    want = np.asarray(jmodel.apply(
        {"params": params}, jax.nn.one_hot(grid, 5),
        None if cond is None else jax.nn.one_hot(cond, 4), train=False))
    got = logits.movedim(1, -1).numpy()
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 1e-5 * scale, f"max|d|={err:.3g} > 1e-5 x {scale:.3g}"
    seed = 17 + with_cond
    jgrid = jcached(jmodel, params, jax.random.PRNGKey(seed), DIMS, B,
                    None if cond is None else jnp.asarray(cond, jnp.int32), tau=TAU)
    table = torch.from_numpy(_jax_gumbel_table(seed))
    before = decode_row.row_decode.launches
    got = cached_ancestral_sample(model, DIMS, B, cond_t, TAU, gumbel=table)
    assert decode_row.row_decode.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgrid))
    if with_cond:
        naive = ancestral_sample(model, DIMS, B, cond_t, TAU, gumbel=table)
        torch.testing.assert_close(got, naive, rtol=0, atol=0)


@pytest.mark.parametrize("option", [{"use_pre_activation": False},
                                    {"use_concat_activation": True}])
def test_cached_sampler_refuses_fixup_and_concat(option):
    model = PixelCNN(PixelCNNConfig(**tiny_config(False), **option))
    with pytest.raises(ValueError, match="--sampler naive"):
        cached_ancestral_sample(model, DIMS, 1)
    # the naive sampler takes them
    grid = ancestral_sample(model, DIMS, 1, generator=torch.Generator().manual_seed(0))
    assert grid.shape == (1, *DIMS) and int(grid.min()) >= 0 and int(grid.max()) < 5
