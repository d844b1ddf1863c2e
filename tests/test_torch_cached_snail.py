"""The port's PixelSNAIL samplers against the JAX package, on the CPU.

Tiny sizes, those of tests/test_cached_snail.py: input_dim 5, model_dim 8,
2 blocks of 2 causal layers, 2 heads, bottleneck divisor 2 (br 4, dh 2),
3x2x3 grids (a 2x1x2 condition over 4 codes when conditioned), batch 2.
Weights are a random JAX parameter tree (numpy seeds, every leaf N(0, 0.2²))
carried across with ``convert.jax_pixelsnail_params_to_state_dict``; fp32
throughout, the JAX attention on its dense path.

  * teacher-forced, the port's cached sampler gives the logits of the JAX
    cached sampler (``forced_x``) and of the JAX one-shot ``PixelSNAIL.apply``
    at every voxel within rtol = atol = 1e-4 (the JAX test's tolerance),
    conditioned and not; forcing the first slices alone gives their logits
    bit for bit;
  * with the Gumbel table of the JAX sampler's key sequence (per voxel in
    raster order ``rng, sub = split(rng)``, then ``gumbel(sub, (B, K))``;
    ``categorical(k, l)`` is ``argmax(l + gumbel(k, l.shape))``, checked
    here), the port's cached sampler gives exactly the grids of JAX
    ``cached_snail_sample``, conditioned and not;
  * the port's cached sampler gives exactly the port's naive sampler's grids
    for one table; with noise from a ``torch.Generator`` the same seed gives
    the same grids;
  * ``kernel_size`` 5 raises ``NotImplementedError``; a non-finite logit
    raises ``FloatingPointError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.models.pixelsnail import PixelSNAIL as JPixelSNAIL
from vqvae3d_tpu.models.pixelsnail import PixelSNAILConfig as JConfig
from vqvae3d_tpu.sample.cached_snail import cached_snail_sample as jcached
from vqvae3d_tpu_torch.convert import jax_pixelsnail_params_to_state_dict
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.sample.ar_sample import ancestral_sample
from vqvae3d_tpu_torch.sample.cached_snail import cached_snail_sample, make_cached_snail_sampler

B, K, NC = 2, 5, 4
DIMS, COARSE = (3, 2, 3), (2, 1, 2)
TAU = 0.7


def _fields(with_cond, kernel_size=3):
    return dict(input_dim=K, condition_dim=NC if with_cond else 0, model_dim=8,
                kernel_size=kernel_size, num_layers_per_block=2, num_blocks=2,
                causal_dropout_prob=0.0, attention_dropout_prob=0.0, bottleneck_divisor=2,
                num_heads=2)


def _models(with_cond, seed):
    """(JAX model, JAX params as numpy, port PixelSNAIL) on the same weights."""
    fields = _fields(with_cond)
    jmodel = JPixelSNAIL(JConfig(**fields, dtype=jnp.float32))
    c = jnp.zeros((B, *COARSE, NC)) if with_cond else None
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((B, *DIMS, K)), c),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes)
    cfg = PixelSNAILConfig(**fields, dtype=torch.float32)
    model = PixelSNAIL(cfg)
    model.load_state_dict(jax_pixelsnail_params_to_state_dict(params, cfg))
    return jmodel, params, model.eval()


def _cond(with_cond, seed):
    if not with_cond:
        return None, None
    cond = np.random.default_rng(seed).integers(0, NC, (B, *COARSE))
    return cond, torch.from_numpy(cond)


def _jax_gumbel_table(seed: int) -> np.ndarray:
    """(s0, s1, s2, B, K): the JAX sampler's per-voxel noise in raster order."""
    rng, table = jax.random.PRNGKey(seed), []
    for _ in range(int(np.prod(DIMS))):
        rng, sub = jax.random.split(rng)
        table.append(np.asarray(jax.random.gumbel(sub, (B, K))))
    return np.stack(table).reshape(*DIMS, B, K)


@pytest.mark.parametrize("with_cond", [False, True])
def test_teacher_forced_logits_match_jax(with_cond):
    jmodel, params, model = _models(with_cond, seed=10 + with_cond)
    grid = np.random.default_rng(11).integers(0, K, (B, *DIMS))
    cond, cond_t = _cond(with_cond, 12)
    got_grid, logits = cached_snail_sample(model, DIMS, B, cond_t, TAU,
                                           forced=torch.from_numpy(grid))
    np.testing.assert_array_equal(got_grid.numpy(), grid)
    got = logits.movedim(1, -1).numpy()
    jcond = None if cond is None else jnp.asarray(cond, jnp.int32)
    want_cached = np.asarray(jcached(jmodel, params, jax.random.PRNGKey(0), DIMS, B, jcond,
                                     forced_x=jnp.asarray(grid, jnp.int32)))
    want_forward = np.asarray(jmodel.apply(
        {"params": params}, jax.nn.one_hot(grid, K),
        None if cond is None else jax.nn.one_hot(cond, NC), train=False))
    np.testing.assert_allclose(got, want_cached, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_forward, rtol=1e-4, atol=1e-4)
    # forcing the first slices alone gives those slices' logits
    prefix, part = cached_snail_sample(model, DIMS, B, cond_t, TAU,
                                       forced=torch.from_numpy(grid[:, :2]))
    np.testing.assert_array_equal(prefix.numpy(), grid[:, :2])
    assert torch.equal(part, logits[:, :, :2])


@pytest.mark.parametrize("with_cond", [False, True])
def test_cached_sampler_matches_jax_cached_sampler(with_cond):
    jmodel, params, model = _models(with_cond, seed=20 + with_cond)
    cond, cond_t = _cond(with_cond, 21)
    seed = 22 + with_cond
    want = jcached(jmodel, params, jax.random.PRNGKey(seed), DIMS, B,
                   None if cond is None else jnp.asarray(cond, jnp.int32), tau=TAU)
    table = _jax_gumbel_table(seed)
    got = cached_snail_sample(model, DIMS, B, cond_t, TAU, gumbel=torch.from_numpy(table))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, *DIMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the table's premise: jax.random.categorical is the Gumbel argmax of its key
    key = jax.random.PRNGKey(seed)
    lg = jnp.asarray(np.random.default_rng(23).standard_normal((B, K)), jnp.float32) / TAU
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, lg, axis=-1)),
        np.asarray(jnp.argmax(lg + jax.random.gumbel(key, lg.shape), -1)))


@pytest.mark.parametrize("with_cond", [False, True])
def test_cached_sampler_matches_naive_sampler(with_cond):
    _, _, model = _models(with_cond, seed=30 + with_cond)
    _, cond_t = _cond(with_cond, 31)
    table = -torch.empty(*DIMS, B, K).exponential_(
        generator=torch.Generator().manual_seed(32)).log()
    naive = ancestral_sample(model, DIMS, B, cond_t, TAU, gumbel=table)
    cached = cached_snail_sample(model, DIMS, B, cond_t, TAU, gumbel=table)
    torch.testing.assert_close(cached, naive, rtol=0, atol=0)
    # noise from a generator: the same seed gives the same grids
    sampler = make_cached_snail_sampler(model, DIMS, B, TAU)
    a, b = (sampler(cond_t, generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < K


def test_cached_sampler_refuses_what_it_cannot_sample():
    model = PixelSNAIL(PixelSNAILConfig(**_fields(False, kernel_size=5), dtype=torch.float32))
    with pytest.raises(NotImplementedError):
        cached_snail_sample(model, DIMS, 1)
    _, _, model = _models(False, seed=40)
    with torch.no_grad():
        model.parse_output.bias[2] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite logits"):
        cached_snail_sample(model, DIMS, B, None, TAU,
                            generator=torch.Generator().manual_seed(41))
    with pytest.raises(ValueError):  # an unconditioned prior takes no condition
        cached_snail_sample(model, DIMS, B, torch.zeros(B, *COARSE, dtype=torch.int64))
