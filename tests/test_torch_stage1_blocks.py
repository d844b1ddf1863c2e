"""Parity of the port's stage-1 pieces beside the pre-activation block with
the JAX package, on the CPU at fp32.

  * ``FixupResBlock`` ('regular') and ``EvonormResBlock`` ('evonorm') in
    every mode (same, same with a channel change, down, up, out) on the
    same numpy-seeded input and parameters: output within 1e-5 x max|ref|,
    the input's and every parameter's gradient (for one seeded cotangent,
    JAX ``jax.vjp``) within 1e-4 x max|ref| of its tensor;
  * ``silu_velocity`` against JAX's custom VJP, and
    ``torch.autograd.gradcheck`` of its hand-written backward in float64;
  * ``group_std`` at B = 2 (population variance, the groups' channel order);
  * ``mixture_nll_loss``, ``sample_mixture`` (greedy, and the logistic draw
    given the same uniforms) and ``generic_nll_loss`` within 1e-6 relative;
  * ``baur_loss_3d`` with ``lambda_gdl`` 0 and 1;
  * ``area_resize`` at integer and non-integer factors, against JAX and
    against ``F.interpolate(mode='area')``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from vqvae3d_tpu.metrics import baur as jbaur
from vqvae3d_tpu.metrics import distribution as jdist
from vqvae3d_tpu.models import blocks as jblocks
from vqvae3d_tpu.ops.resize import area_resize as jarea_resize
from vqvae3d_tpu_torch.metrics import baur, distribution as dist
from vqvae3d_tpu_torch.models import blocks as tblocks
from vqvae3d_tpu_torch.ops.resize import area_resize

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _t(x_ndhwc):
    return torch.from_numpy(np.array(x_ndhwc)).movedim(-1, 1)


def _np(x):
    return x.detach().movedim(1, -1).numpy()


def _port_key(path):
    """A JAX parameter path -> the port's state_dict key (a ResizeConv3D's
    ``/conv`` level dropped, ``kernel`` -> ``weight``)."""
    names = [p for p in path if p != "conv"]
    return ".".join(names[:-1] + ["weight" if names[-1] == "kernel" else names[-1]])


def _to_port(leaf, path):
    a = np.asarray(leaf)
    return np.transpose(a, (4, 3, 0, 1, 2)) if path[-1] == "kernel" else a


def _state_dict(params):
    return {_port_key(path): torch.from_numpy(_to_port(leaf, path).copy())
            for path, leaf in flatten_dict(params).items()}


BLOCK_CASES = [  # (mode, in channels, out channels, spatial)
    ("same", 8, 8, (6, 4, 4)),
    ("same", 5, 8, (6, 4, 4)),
    ("down", 4, 8, (8, 8, 4)),
    ("up", 8, 4, (4, 4, 2)),
    ("out", 6, 3, (6, 4, 4)),
    ("out", 4, 4, (6, 4, 4)),
]


@pytest.mark.parametrize("kind", ["regular", "evonorm"])
@pytest.mark.parametrize("mode,cin,cout,spatial", BLOCK_CASES)
def test_block_matches_jax(kind, mode, cin, cout, spatial):
    rng = np.random.default_rng([len(kind), len(mode), cin, cout])
    x = rng.standard_normal((2, *spatial, cin)).astype(np.float32)
    jcls = jblocks.FixupResBlock if kind == "regular" else jblocks.EvonormResBlock
    jblock = jcls(out_channels=cout, mode=mode, num_layers=5, dtype=jnp.float32)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x)["params"]
    # every parameter off its init (zero convs, zero gamma): each path counts
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32), shapes)
    gy = rng.standard_normal(jax.eval_shape(jblock.apply, {"params": shapes}, x).shape)
    gy = gy.astype(np.float32)

    @jax.jit
    def value_and_vjp(p, x, gy):
        y, vjp = jax.vjp(lambda p, x: jblock.apply({"params": p}, x), p, x)
        return y, vjp(gy)

    y, (gp, gx) = value_and_vjp(params, x, gy)

    tblock = tblocks.make_block(kind, cin, cout, mode, 5, pad_mode="wrap", dtype=torch.float32)
    tblock.load_state_dict(_state_dict(params))  # strict: the same parameter tree
    xt = _t(x).requires_grad_()
    yt = tblock(xt)
    yt.backward(_t(gy))
    want = np.asarray(y)
    np.testing.assert_allclose(_np(yt), want, rtol=0, atol=OUT_TOL * np.abs(want).max())
    gx = np.asarray(gx)
    np.testing.assert_allclose(_np(xt.grad), gx, rtol=0, atol=GRAD_TOL * np.abs(gx).max())
    named = dict(tblock.named_parameters())
    for path, g in flatten_dict(jax.device_get(gp)).items():
        g = _to_port(g, path)
        np.testing.assert_allclose(named[_port_key(path)].grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(), err_msg=_port_key(path))


def test_fixup_block_pads_with_zeros_in_a_wrap_model():
    """The 'regular' block's convs pad with zeros whatever the pad mode
    (JAX passes it to pre-activation blocks only); make_block refuses an
    unknown type."""
    blk = tblocks.make_block("regular", 4, 4, "same", 3, pad_mode="wrap")
    assert blk.branch_conv1.pad_mode == blk.branch_conv2.pad_mode == "zeros"
    evo = tblocks.make_block("evonorm", 4, 4, "same", 3, pad_mode="wrap")
    assert evo.branch_conv2.pad_mode == "zeros" and not evo.needs_skip
    assert tuple(evo.branch_conv2.weight.shape) == (1, 1, 3, 3, 3)  # max(4 // 4, 1)
    with pytest.raises(ValueError):
        tblocks.make_block("fixup", 4, 4, "same", 3)


def test_silu_velocity_matches_jax_vjp_and_gradchecks():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 4, 2)).astype(np.float32)  # channels-last, C = 2
    v = rng.standard_normal(2).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    y, vjp = jax.vjp(jblocks.silu_velocity, jnp.asarray(x), jnp.asarray(v))
    jdx, jdv = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    vt = torch.from_numpy(v).view(2, 1, 1, 1).requires_grad_()
    yt = tblocks.silu_velocity(xt, vt)
    yt.backward(_t(g))
    np.testing.assert_allclose(_np(yt), np.asarray(y), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vt.grad.flatten().numpy(), np.asarray(jdv), rtol=1e-5)
    x64 = torch.randn(2, 3, 4, 3, 2, dtype=torch.float64, requires_grad=True)
    v64 = torch.randn(3, 1, 1, 1, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tblocks.silu_velocity, (x64, v64))


@pytest.mark.parametrize("c,groups", [(16, None), (6, None), (12, 3)])
def test_group_std_matches_jax_at_batch_2(c, groups):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, 4, 3, 5, c)) * rng.uniform(0.5, 3.0, c)).astype(np.float32)
    want = np.asarray(jblocks.group_std(jnp.asarray(x), groups))
    got = tblocks.group_std(_t(x), groups)
    assert got.shape == (2, c, 4, 3, 5)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    # the two samples are normalised apart (the reference's batch-1 reshape is not)
    assert not np.allclose(want[0], want[1])


def _mixture_inputs(rng, shape=(3, 4, 5), n_mix=3):
    x = rng.standard_normal(shape).astype(np.float32)
    logits = rng.standard_normal((*shape, n_mix)).astype(np.float32)
    loc = rng.standard_normal((*shape, n_mix)).astype(np.float32)
    scale = rng.uniform(0.05, 2.0, (*shape, n_mix)).astype(np.float32)
    return x, logits, loc, scale


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("reduce_sum", [True, False])
def test_mixture_nll_and_generic_nll_match_jax(reduce_sum):
    rng = np.random.default_rng(11)
    x, logits, loc, scale = _mixture_inputs(rng)
    want = jdist.mixture_nll_loss(*map(jnp.asarray, (x, logits, loc, scale)),
                                  reduce_sum=reduce_sum)
    got = dist.mixture_nll_loss(*map(torch.from_numpy, (x, logits, loc, scale)),
                                reduce_sum=reduce_sum)
    assert _rel(got.numpy(), want) <= 1e-6
    want = jdist.generic_nll_loss(jnp.asarray(x), jdist.logistic_log_prob, reduce_sum,
                                  loc=jnp.asarray(loc[..., 0]), scale=jnp.asarray(scale[..., 0]))
    got = dist.generic_nll_loss(torch.from_numpy(x), dist.logistic_log_prob, reduce_sum,
                                loc=torch.from_numpy(loc[..., 0]),
                                scale=torch.from_numpy(scale[..., 0]))
    assert _rel(got.numpy(), want) <= 1e-6


def test_sample_mixture_matches_jax_given_the_same_uniforms():
    rng = np.random.default_rng(12)
    _, logits, loc, scale = _mixture_inputs(rng)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jdist.sample_mixture(key, *map(jnp.asarray, (logits, loc, scale))))
    # the uniforms of JAX's draw: sample_mixture splits the key, logistic_sample
    # draws on the second half
    u = jax.random.uniform(jax.random.split(key)[1], logits.shape[:-1], jnp.float32,
                           1e-6, 1.0 - 1e-6)
    got = dist.sample_mixture(*map(torch.from_numpy, (logits, loc, scale)),
                              u=torch.from_numpy(np.array(u)))
    assert _rel(got.numpy(), want) <= 1e-6
    comp = np.argmax(logits, -1)[..., None]
    greedy_loc = np.take_along_axis(loc, comp, -1)[..., 0]
    half = torch.full(logits.shape[:-1], 0.5)  # the logistic's median: the component's loc
    got = dist.sample_mixture(*map(torch.from_numpy, (logits, loc, scale)), u=half)
    np.testing.assert_array_equal(got.numpy(), greedy_loc)
    gen = torch.Generator().manual_seed(0)
    drawn = dist.sample_mixture(*map(torch.from_numpy, (logits, loc, scale)), greedy=False,
                                generator=gen)
    assert drawn.shape == logits.shape[:-1] and torch.isfinite(drawn).all()


@pytest.mark.parametrize("lambda_gdl", [0.0, 1.0])
def test_baur_loss_matches_jax(lambda_gdl):
    rng = np.random.default_rng(13)
    recon = rng.standard_normal((2, 6, 5, 4, 1)).astype(np.float32)
    target = rng.standard_normal((2, 6, 5, 4, 1)).astype(np.float32)
    q = [np.float32(0.25), np.float32(0.5)]
    want = jbaur.baur_loss_3d(jnp.asarray(recon), jnp.asarray(target),
                              [jnp.asarray(v) for v in q], lambda_gdl=lambda_gdl)
    got = baur.baur_loss_3d(_t(recon), _t(target), [torch.tensor(v) for v in q],
                            lambda_gdl=lambda_gdl)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    grads = baur._image_gradients(_t(recon))
    for g, jg in zip(grads, jbaur._image_gradients(jnp.asarray(recon))):
        np.testing.assert_array_equal(_np(g), np.asarray(jg))


@pytest.mark.parametrize("src,dst", [((8, 12, 16), (4, 3, 8)), ((9, 12, 7), (4, 5, 7)),
                                     ((10, 6, 6), (3, 6, 4)), ((6, 6, 6), (6, 6, 6))])
def test_area_resize_matches_jax_and_interpolate(src, dst):
    rng = np.random.default_rng(sum(src))
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jarea_resize(jnp.asarray(x), dst))
    got = area_resize(_t(x), dst)
    assert got.dtype == torch.float32 and tuple(got.shape[2:]) == dst
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(F.interpolate(_t(x), size=dst, mode="area")),
                               rtol=1e-5, atol=1e-6)
    half = area_resize(_t(x).to(torch.bfloat16), dst)
    assert half.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        area_resize(_t(x), tuple(s + 1 for s in src))
