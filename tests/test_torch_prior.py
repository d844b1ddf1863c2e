"""Parity of the port's PixelCNN prior with the JAX package, on the CPU.

Weights: a random JAX PixelCNN ``params`` tree (numpy seed, every leaf
N(0, 0.3²), so no Fixup branch is zero) carried to the port with
``convert.jax_pixelcnn_params_to_state_dict``. Inputs: one-hot grids from a
numpy seed. Sizes are tiny: input_dim 5, condition_dim 4, model_dim 8, 2-4
blocks, 3x4x3 grids, batch 2.

  * the causal block (masks 'A' and 'B', with and without a condition) and
    ``PixelCNN.forward`` (unconditioned; conditioned at the coarse and at
    the full grid) against the JAX modules, at the JAX default config and
    with ``scan_stacks=False``: within 1e-5 of max|ref| (fp32, the same
    math summed in another order);
  * ``trilinear_resize`` against the JAX resize at the real factor (32x32x8
    -> 128x128x32) and at an odd one (2x2x1 -> 3x4x3): within 1e-6 absolute
    (one-hot inputs, fp32 lerps);
  * the weight bridge: the port state_dict, fed to the JAX package's
    ``convert_reference_pixelcnn_state_dict``, gives back the JAX tree
    exactly; prior checkpoints and config files read across packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.models.causal_blocks import PreActFixupCausalResBlock as JBlock
from vqvae3d_tpu.models.pixelcnn import PixelCNN as JPixelCNN
from vqvae3d_tpu.models.pixelcnn import PixelCNNConfig as JConfig
from vqvae3d_tpu.ops.resize import trilinear_resize as jresize
from vqvae3d_tpu.train.checkpoint import (
    _config_from_json,
    _config_to_json,
    convert_reference_pixelcnn_state_dict,
)
from vqvae3d_tpu_torch.checkpoint import load_prior, save_prior
from vqvae3d_tpu_torch.cli import train_prior, train_vqvae
from vqvae3d_tpu_torch.convert import _causal_block, jax_pixelcnn_params_to_state_dict
from vqvae3d_tpu_torch.models.causal_blocks import PreActFixupCausalResBlock
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
from vqvae3d_tpu_torch.ops.resize import trilinear_resize

REL = 1e-5
DIMS = (3, 4, 3)
COARSE = (2, 2, 1)


def tiny_config(with_cond: bool, num_resblocks: int = 2, **kw) -> dict:
    return dict(input_dim=5, condition_dim=4 if with_cond else 0, model_dim=8,
                num_resblocks=num_resblocks, dropout_prob=0.0, bottleneck_divisor=2, **kw)


def _random_tree(shapes, rng, std=0.3):
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)


def jax_and_port_models(fields: dict, seed: int, batch: int = 2, **jax_kw):
    """(JAX model, JAX params as numpy, port PixelCNN) on the same random weights."""
    jcfg = JConfig(**fields, dtype=jnp.float32, **jax_kw)
    jmodel = JPixelCNN(jcfg)
    x = jnp.zeros((batch, *DIMS, jcfg.input_dim))
    c = jnp.zeros((batch, *COARSE, jcfg.condition_dim)) if jcfg.use_conditioning else None
    shapes = jax.eval_shape(lambda k: jmodel.init(k, x, c), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], np.random.default_rng(seed))
    tcfg = PixelCNNConfig(**fields, dtype=torch.float32)
    model = PixelCNN(tcfg)
    model.load_state_dict(jax_pixelcnn_params_to_state_dict(params, tcfg))
    return jmodel, params, model.eval()


def _grids(rng, batch, with_cond, cond_dims=COARSE):
    data = rng.integers(0, 5, (batch, *DIMS))
    cond = rng.integers(0, 4, (batch, *cond_dims)) if with_cond else None
    return data, cond


def _jax_logits(jmodel, params, data, cond):
    oh = jax.nn.one_hot(data, 5)
    c = None if cond is None else jax.nn.one_hot(cond, 4)
    return np.asarray(jmodel.apply({"params": params}, oh, c, train=False))


def _port_logits(model, data, cond):
    with torch.inference_mode():
        out = model(idx_to_one_hot(torch.from_numpy(data), 5),
                    None if cond is None else idx_to_one_hot(torch.from_numpy(cond), 4))
    return out.movedim(1, -1).numpy()


def _assert_rel(got, want, rel=REL):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max|d|={err:.3g} > {rel} x max|ref| {scale:.3g}"


@pytest.mark.parametrize("mask", ["A", "B"])
@pytest.mark.parametrize("with_cond", [False, True])
def test_causal_block_matches_jax(mask, with_cond):
    rng = np.random.default_rng(10 + 2 * with_cond + (mask == "A"))
    c, cdim = 8, (6 if with_cond else 0)
    jblk = JBlock(out_channels=c, kernel_size=3, mask=mask, condition_dim=cdim,
                  dropout_prob=0.0, bottleneck_divisor=2, num_layers=3)
    stack = tuple(rng.standard_normal((2, *DIMS, c)).astype(np.float32) for _ in range(3))
    cond = rng.standard_normal((2, *DIMS, cdim)).astype(np.float32) if with_cond else None
    shapes = jax.eval_shape(lambda k: jblk.init(k, stack, condition=cond), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = jblk.apply({"params": params}, stack, condition=cond)

    sd = {}
    _causal_block(params, "blk", sd)
    blk = PreActFixupCausalResBlock(c, c, 3, mask, condition_dim=cdim, dropout_prob=0.0,
                                    bottleneck_divisor=2, num_layers=3)
    blk.load_state_dict({k[len("blk."):]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    assert (blk.skip_conv is not None) == (mask == "A")
    with torch.inference_mode():
        got = blk(tuple(torch.from_numpy(s).movedim(-1, 1) for s in stack),
                  None if cond is None else torch.from_numpy(cond).movedim(-1, 1))
    for g, w in zip(got, want):
        _assert_rel(g.movedim(1, -1).numpy(), np.asarray(w))


@pytest.mark.parametrize("scan_stacks", [True, False])
@pytest.mark.parametrize("cond_grid", [None, "coarse", "full"])
def test_pixelcnn_forward_matches_jax(scan_stacks, cond_grid):
    with_cond = cond_grid is not None
    fields = tiny_config(with_cond, num_resblocks=3)
    jmodel, params, model = jax_and_port_models(fields, seed=20 + 3 * scan_stacks,
                                                scan_stacks=scan_stacks)
    rng = np.random.default_rng(30)
    data, cond = _grids(rng, 2, with_cond, DIMS if cond_grid == "full" else COARSE)
    _assert_rel(_port_logits(model, data, cond), _jax_logits(jmodel, params, data, cond))


@pytest.mark.parametrize("src,dst,c", [((32, 32, 8), (128, 128, 32), 2), ((2, 2, 1), (3, 4, 3), 4)])
def test_trilinear_resize_matches_jax(src, dst, c):
    rng = np.random.default_rng(sum(src))
    one_hot = np.eye(c, dtype=np.float32)[rng.integers(0, c, (2, *src))]  # (B, *src, C)
    want = np.asarray(jresize(jnp.asarray(one_hot), dst))
    got = trilinear_resize(torch.from_numpy(one_hot).movedim(-1, 1), dst).movedim(1, -1)
    assert tuple(got.shape) == (2, *dst, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_trilinear_resize_refuses_to_shrink():
    with pytest.raises(ValueError):
        trilinear_resize(torch.zeros(1, 1, 4, 4, 4), (2, 4, 4))


@pytest.mark.parametrize("with_cond", [False, True])
def test_weight_bridge_round_trip(with_cond):
    fields = tiny_config(with_cond)
    _, params, model = jax_and_port_models(fields, seed=40 + with_cond)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_reference_pixelcnn_state_dict(sd, JConfig(**fields))["params"]
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path])


def test_prior_checkpoint_and_config_interchange(tmp_path):
    fields = tiny_config(True)
    _, _, model = jax_and_port_models(fields, seed=50)
    save_prior(tmp_path / "ck", model, step=7)
    loaded, cfg = load_prior(tmp_path / "ck", device="cpu")
    assert cfg == model.config
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    # the JAX package reads the port's config file, and the port the JAX one
    jcfg = _config_from_json(JConfig, (tmp_path / "ck" / "step_7_config.json").read_text())
    assert jcfg.model_dim == 8 and jcfg.condition_dim == 4 and jcfg.dtype == jnp.float32
    (tmp_path / "ck" / "step_7_config.json").write_text(
        _config_to_json(JConfig(**fields, dtype=jnp.float32)))
    assert "scan_stacks" in json.loads((tmp_path / "ck" / "step_7_config.json").read_text())
    assert load_prior(tmp_path / "ck", device="cpu")[1] == cfg


def test_training_only_options_raise():
    """A spatial mesh axis without a process group raises (the sharded steps:
    tests/test_torch_spatial.py); the Fixup and
    concat-activation PixelCNNs build (their parity:
    tests/test_torch_prior_variants.py) and training-time dropout works
    (tests/test_torch_prior_train.py::test_dropout_trains)."""
    fixup = PixelCNN(PixelCNNConfig(**tiny_config(False), use_pre_activation=False))
    concat = PixelCNN(PixelCNNConfig(**tiny_config(False), use_concat_activation=True))
    assert not fixup.uses_union_stack and not concat.uses_union_stack
    # PixelSNAIL trains (tests/test_torch_pixelsnail.py): its flags parse
    args = train_prior.parse_arguments(["codes", "0", "--use-model", "pixelsnail",
                                        "--num-blocks", "3", "--attention-dropout-prob", "0"])
    assert (args.num_blocks, args.attention_dropout_prob) == (3, 0.0)
    # multi-host training joins a process group from the launcher's env, which a
    # spatial mesh axis needs
    assert train_prior.parse_arguments(["codes", "0", "--multihost"]).multihost
    with pytest.raises(ValueError, match="needs --multihost"):
        train_vqvae.main(train_vqvae.parse_arguments(["ct", "--mesh-shape", "2", "2",
                                                      "--device", "cpu"]))
    model = PixelCNN(PixelCNNConfig(**{**tiny_config(False), "dropout_prob": 0.5}))
    out = model(torch.zeros(1, 5, *DIMS), train=True, generator=torch.Generator().manual_seed(0))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
