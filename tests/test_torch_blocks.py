"""Parity of the port's blocks with the JAX package.

  * ``PreActFixupResBlock`` in modes same/down/up against the JAX module, in
    both pad modes, at C in {2, 9, 18}, with EVERY parameter randomized (the
    zero-init ``branch_conv3`` would otherwise make a 'same' block the
    identity and prove nothing). Tolerance 1e-4 absolute (fp32).
  * A 'same' stack (``apply_same_stack``) against the JAX block math
    ``preact_fixup_same_ndhwc`` looped over the blocks, 1e-4.
The kernels themselves are checked in tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from vqvae3d_tpu.models import blocks as jblocks
from vqvae3d_tpu_torch.models import blocks as tblocks
from vqvae3d_tpu_torch.ops import stack_kernel

TOL = 1e-4


def _t(x_ndhwc):
    return torch.from_numpy(np.asarray(x_ndhwc)).movedim(-1, 1)


def _np(x):
    return x.movedim(1, -1).numpy()


def _randomize(tree, rng, std=0.2):
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * std).astype(np.float32), tree
    )


def _block_state_dict(params):
    """JAX block params -> port keys (ResizeConv3D nests its kernel under
    /conv in JAX; the port and the reference hold ``weight`` directly)."""
    sd = {}
    for path, leaf in flatten_dict(params).items():
        names = [p for p in path if p != "conv"]
        if names[-1] == "kernel":
            sd[".".join(names[:-1]) + ".weight"] = torch.from_numpy(
                np.transpose(np.asarray(leaf), (4, 3, 0, 1, 2)).copy()
            )
        else:
            sd[".".join(names)] = torch.from_numpy(np.asarray(leaf).copy())
    return sd


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18])
@pytest.mark.parametrize("mode", ["same", "same_skip", "down", "up"])
def test_preact_block_matches_jax(mode, c, pad_mode):
    rng = np.random.default_rng(c)
    spatial = (4, 4, 2) if mode == "up" else (8, 6, 4)
    x = rng.standard_normal((2, *spatial, c)).astype(np.float32)
    out_ch = {"same": c, "same_skip": c + 3, "down": 2 * c, "up": max(c // 2, 1)}[mode]
    jmode = "same" if mode == "same_skip" else mode
    jblock = jblocks.PreActFixupResBlock(
        out_channels=out_ch, mode=jmode, num_layers=5, pad_mode=pad_mode
    )
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x)["params"]
    params = _randomize(shapes, rng)
    want = jax.jit(lambda p, x: jblock.apply({"params": p}, x))(params, x)

    tblock = tblocks.PreActFixupResBlock(c, out_ch, jmode, 5, pad_mode=pad_mode)
    tblock.load_state_dict(_block_state_dict(params))
    with torch.inference_mode():
        got = tblock(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


def _same_block_params(rng, c, std=0.2):
    """Random params of one 'same' block, in the JAX tree layout."""
    cb = max(c // 2, 1)
    p = {f"bias{n}": (rng.standard_normal(1) * std).astype(np.float32) for n in tblocks.SCALARS}
    p["scale"] = (1.0 + rng.standard_normal(1) * std).astype(np.float32)
    for name, shape in (("branch_conv1", (1, 1, 1, c, cb)), ("branch_conv2", (3, 3, 3, cb, cb)),
                        ("branch_conv3", (1, 1, 1, cb, c))):
        p[name] = {"kernel": (rng.standard_normal(shape) * std).astype(np.float32)}
    return p


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18])
def test_same_stack_matches_jax(c, pad_mode):
    rng = np.random.default_rng(100 + c)
    x = rng.standard_normal((1, 6, 4, 4, c)).astype(np.float32)
    params = [_same_block_params(rng, c) for _ in range(3)]
    want = jnp.asarray(x)
    for p in params:
        scalars = tuple(jnp.asarray(p[f"bias{n}"]) for n in tblocks.SCALARS)
        want = jblocks.preact_fixup_same_ndhwc(
            want, *(jnp.asarray(p[f"branch_conv{i}"]["kernel"]) for i in (1, 2, 3)),
            scalars + (jnp.asarray(p["scale"]),), pad_mode=pad_mode,
        )
    blocks = []
    for p in params:
        blocks.append(tblocks.PreActFixupResBlock(c, c, "same", pad_mode=pad_mode))
        blocks[-1].load_state_dict(_block_state_dict(p))
    launches = stack_kernel.preact_stack_fused.launches
    with torch.inference_mode():
        got = tblocks.apply_same_stack(_t(x), blocks, pad_mode=pad_mode)
        one_by_one = _t(x)
        for blk in blocks:
            one_by_one = blk(one_by_one)
    # a CPU tensor takes the plain loop: no kernel launch is counted
    assert stack_kernel.preact_stack_fused.launches == launches
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(one_by_one), _np(got), atol=1e-6, rtol=0)


def test_resize_conv_and_pqc_shapes():
    g = torch.Generator().manual_seed(0)
    pqc = tblocks.PreQuantizationConditioning(16 + 2, 2, has_aux=True, num_layers=4)
    for m in pqc.modules():
        if m is not pqc and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    with torch.inference_mode():
        y = pqc(torch.randn(1, 16, 8, 8, 4, generator=g), torch.randn(1, 8, 2, 2, 1, generator=g))
    assert tuple(y.shape) == (1, 2, 8, 8, 4)
    with pytest.raises(ValueError):
        pqc(torch.zeros(1, 16, 8, 8, 4))
