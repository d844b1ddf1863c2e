"""Parity of the port's plain ops with the JAX package: conv3d ('wrap' and
'zeros' padding, every kernel/stride the model uses), trilinear x2 upsampling,
space_to_depth / depth_to_space and the Fixup init functions.

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

# the JAX ops package re-exports functions under its module names
jconv = importlib.import_module("vqvae3d_tpu.ops.conv3d")
jresize = importlib.import_module("vqvae3d_tpu.ops.resize")

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
