"""Parity of the port's plain ops with the JAX package: conv3d ('wrap' and
'zeros' padding, every kernel/stride the model uses), trilinear x2 upsampling,
space_to_depth / depth_to_space and the Fixup init functions; and the
gradients of the training path: the small-channel conv's custom backward
(dW by ``dw_conv3d_plain``, K7's plain version, against the JAX
``_conv3d_valid_smallc``, whose dW is the Pallas kernel in interpret mode
here) and the 'same'-stack backward (the CPU path of K3's autograd Function
against ``jax.vjp`` of the JAX block math looped over the blocks).

Inputs come from a numpy seed and go through both packages; the port's
(B, C, H, W, D) layout is moved to JAX's (B, H, W, D, C) to compare.
Tolerance 1e-5 absolute (fp32 on the CPU, O(1) values)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.ops import conv3d as tconv
from vqvae3d_tpu_torch.ops import resize as tresize
from vqvae3d_tpu_torch.ops import stack_kernel

# the JAX ops package re-exports functions under its module names
jconv = importlib.import_module("vqvae3d_tpu.ops.conv3d")
jresize = importlib.import_module("vqvae3d_tpu.ops.resize")
jblocks = importlib.import_module("vqvae3d_tpu.models.blocks")

TOL = 1e-5


def _t(x_ndhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_ndhwc).movedim(-1, 1)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.movedim(1, -1).numpy()


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (3, 1, 1), (4, 2, 1), (2, 2, 0)])
def test_conv3d_matches_jax(pad_mode, k, stride, pad):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 8, 6, 4, 3)).astype(np.float32)
    # JAX (kH, kW, kD, I, O), scaled to keep the outputs O(1)
    w = (rng.standard_normal((k, k, k, 3, 5)) / np.sqrt(3 * k**3)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jconv.conv3d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        stride=stride, padding=[(pad, pad)] * 3, pad_mode=pad_mode,
    )
    got = tconv.conv3d(
        _t(x), torch.from_numpy(w).permute(4, 3, 0, 1, 2), torch.from_numpy(b),
        stride=stride, padding=pad, pad_mode=pad_mode,
    )
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
def test_pad3d_matches_jnp_pad(pad_mode):
    x = np.random.default_rng(0).standard_normal((1, 3, 4, 2, 2)).astype(np.float32)
    want = jconv.pad3d(jnp.asarray(x), ((2, 2),) * 3, mode=pad_mode)
    got = tconv.pad3d(_t(x), 2, mode=pad_mode)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_trilinear_upsample2x_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 5, 6, 3, 4)).astype(np.float32)
    want = jresize.trilinear_upsample2x(jnp.asarray(x))
    got = tresize.trilinear_upsample2x(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_space_to_depth_matches_jax(factor):
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 4, 3)).astype(np.float32)
    want = jresize.space_to_depth(jnp.asarray(x), factor)
    got = tresize.space_to_depth(_t(x), factor)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    back = tresize.depth_to_space(got, factor)
    np.testing.assert_array_equal(_np(back), x)
    np.testing.assert_array_equal(
        _np(back), np.asarray(jresize.depth_to_space(want, factor))
    )


@pytest.mark.parametrize(
    "name,args",
    [
        ("fixup_branch_init", (7,)),
        ("kaiming_normal_init", ()),
        ("xavier_normal_init", ()),
        ("torch_conv_default_init", ()),
    ],
)
def test_init_functions_match_jax_spread(name, args):
    """Same distribution as the JAX init on the transposed shape: the
    standard deviations agree within 3 % over 60k draws."""
    o, i, k = 40, 12, 5
    jw = getattr(jconv, name)(*args)(jax.random.PRNGKey(0), (k, k, k, i, o))
    tw = getattr(tconv, name)(*args)((o, i, k, k, k), torch.Generator().manual_seed(0))
    assert tuple(tw.shape) == (o, i, k, k, k) and tw.dtype == torch.float32
    np.testing.assert_allclose(float(tw.std()), float(np.std(np.asarray(jw))), rtol=0.03)
    assert abs(float(tw.mean())) < 0.05 * float(tw.std())


def test_conv3d_module_casts_to_compute_dtype():
    m = tconv.Conv3D(2, 3, 3, pad=1, pad_mode="wrap", dtype=torch.float64)
    m.reset_parameters(torch.Generator().manual_seed(0))
    y = m(torch.randn(1, 2, 4, 4, 2, generator=torch.Generator().manual_seed(1)))
    assert y.dtype == torch.float64 and tuple(y.shape) == (1, 3, 4, 4, 2)
    assert m.weight.dtype == torch.float32


@pytest.mark.parametrize("cin,cout,k", [(9, 9, 3), (2, 4, 3), (3, 5, 2)])
def test_smallc_conv_backward_matches_jax(cin, cout, k):
    """dx and dW of a stride-1 VALID conv on a pre-padded input: the port's
    ``_SmallConv3d`` (through ``conv3d``) against ``jax.vjp`` of
    ``_conv3d_valid_smallc``; dW also straight from ``dw_conv3d_plain``."""
    rng = np.random.default_rng(cin * 10 + cout)
    xp = rng.standard_normal((2, 7, 6, 5, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, cin, cout)) / np.sqrt(cin * k**3)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jconv._conv3d_valid_smallc(a, b, (1, 1, 1)),
                       jnp.asarray(xp), jnp.asarray(w))
    g = rng.standard_normal(out.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))
    xt = _t(xp).requires_grad_()
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
    y = tconv.conv3d(xt, wt)
    np.testing.assert_allclose(_np(y.detach()), np.asarray(out), atol=TOL, rtol=0)
    dx, dw = torch.autograd.grad(y, [xt, wt], _t(g))
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), atol=TOL, rtol=0)
    want_dw = np.transpose(np.asarray(jdw), (4, 3, 0, 1, 2))
    np.testing.assert_allclose(dw.numpy(), want_dw, atol=1e-4, rtol=0)
    direct = tconv.dw_conv3d_plain(xt.detach(), _t(g), (k, k, k))
    np.testing.assert_allclose(direct.numpy(), want_dw, atol=1e-4, rtol=0)


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9])
def test_stack_backward_matches_jax_vjp(c, pad_mode):
    """A 3-block 'same' stack: dx, the stacked weights' and scalars'
    gradients of the port's training path (``preact_stack_fused`` with
    gradients: the saving forward + the block-by-block backward) against
    ``jax.vjp`` of ``preact_fixup_same_ndhwc`` looped over the blocks."""
    rng = np.random.default_rng(60 + c)
    nb, cb = 3, max(c // 2, 1)
    x = rng.standard_normal((2, 6, 5, 4, c)).astype(np.float32)
    w1 = (rng.standard_normal((nb, 1, 1, 1, c, cb)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((nb, 3, 3, 3, cb, cb)) * 0.3).astype(np.float32)
    w3 = (rng.standard_normal((nb, 1, 1, 1, cb, c)) * 0.3).astype(np.float32)
    sc = (rng.standard_normal((nb, 8)) * 0.2 + np.eye(8)[7]).astype(np.float32)

    def jstack(x, w1, w2, w3, sc):
        for j in range(nb):
            x = jblocks.preact_fixup_same_ndhwc(x, w1[j], w2[j], w3[j], sc[j],
                                                pad_mode=pad_mode)
        return x

    out, vjp = jax.vjp(jstack, *(jnp.asarray(a) for a in (x, w1, w2, w3, sc)))
    g = rng.standard_normal(out.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g))

    def port_w(w):  # (NB, kH, kW, kD, I, O) -> (NB, O, I, kH, kW, kD)
        return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (0, 5, 4, 1, 2, 3))))

    ins = [_t(x), port_w(w1), port_w(w2), port_w(w3), torch.from_numpy(sc)]
    ins = [t.requires_grad_() for t in ins]
    y = stack_kernel.preact_stack_fused(*ins, pad_mode)
    np.testing.assert_allclose(_np(y.detach()), np.asarray(out), atol=1e-4, rtol=0)
    grads = torch.autograd.grad(y, ins, _t(g))
    want = [np.asarray(jgrads[0])] + [np.transpose(np.asarray(a), (0, 5, 4, 1, 2, 3))
                                      for a in jgrads[1:4]] + [np.asarray(jgrads[4])]
    got = [_np(grads[0])] + [t.numpy() for t in grads[1:]]
    for name, a, b in zip(("dx", "dw1", "dw2", "dw3", "dsc"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0, err_msg=name)
