"""The PixelCNN variants of the port against the JAX package, on the CPU.

The variants are the JAX ``PixelCNNConfig`` options beside the default:
``use_pre_activation=False`` (``FixupCausalResBlock``),
``use_concat_activation=True`` (grouped branch convs over concatenated
ELUs) and ``kernel_size`` 5; and the ``GatedResBlock``, which no model of
either package calls. Weights: random JAX parameter trees (numpy seeds,
every leaf N(0, 0.3²), so no Fixup branch is zero) carried to the port with
``convert``. Inputs from numpy seeds. Sizes are tiny (input_dim 5,
condition_dim 4, model_dim 8, bottleneck divisor 2, 2 blocks, 3x4x3 grids
from a 2x2x1 condition, batch 2), fp32, and each whole-model config compiles
once in JAX (module-scoped fixtures).

  * the blocks (``FixupCausalResBlock`` masks 'A' and 'B', ``out=True``
    with a change of width; the concat ``PreActFixupCausalResBlock`` masks
    'A' and 'B', with and without a condition; ``GatedResBlock`` masks 'A'
    and 'B' with a condition, and 'A' without) and the PixelCNN forward of
    each variant (conditioned on the coarse grid; the Fixup model keeps
    ``embed_condition`` and ignores it) within 1e-5 of max|ref| (the same
    fp32 math summed in another order);
  * ``prior_loss_fn``'s loss and logs within rel 1e-5 and every gradient
    within 1e-4 of the tensor's max|ref| or 1e-5 of the largest gradient
    against ``jax.value_and_grad`` of the JAX ``prior_loss_fn`` (the unused
    ``embed_condition`` of the Fixup model has a zero gradient on both
    sides);
  * Fixup channel dropout with the keep masks passed as data against the
    block computed by hand with ``F.conv3d`` (within 1e-6: the same fp32
    ops), and the masks' width following the block type;
  * no variant runs the union stack (K4);
  * the weight bridge round-trips each variant's tree exactly, and the
    port's checkpoint with a JAX-written config file loads and runs.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_prior import (
    COARSE,
    DIMS,
    _assert_rel,
    _grids,
    _jax_logits,
    _port_logits,
    _random_tree,
    jax_and_port_models,
    tiny_config,
)

from vqvae3d_tpu.models.causal_blocks import FixupCausalResBlock as JFixup
from vqvae3d_tpu.models.causal_blocks import GatedResBlock as JGated
from vqvae3d_tpu.models.causal_blocks import PreActFixupCausalResBlock as JBlock
from vqvae3d_tpu.models.pixelcnn import PixelCNNConfig as JConfig
from vqvae3d_tpu.train import prior_train as jpt
from vqvae3d_tpu.train.checkpoint import _config_to_json, convert_reference_pixelcnn_state_dict
from vqvae3d_tpu_torch.checkpoint import load_prior, save_prior
from vqvae3d_tpu_torch.convert import (
    _causal_block,
    _fixup_causal_block,
    jax_gated_block_params_to_state_dict,
    jax_pixelcnn_params_to_state_dict,
)
from vqvae3d_tpu_torch.models.causal_blocks import (
    FixupCausalResBlock,
    GatedResBlock,
    PreActFixupCausalResBlock,
)
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.train import prior_train

VARIANTS = {
    "fixup": dict(use_pre_activation=False),
    "concat": dict(use_concat_activation=True),
    "k5": dict(kernel_size=5),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """(name, fields, JAX model, JAX params, port model): conditioned."""
    fields = tiny_config(True, **VARIANTS[request.param])
    jmodel, params, model = jax_and_port_models(fields, seed=300 + len(request.param))
    return request.param, fields, jmodel, params, model


def _stack(rng, c):
    return tuple(rng.standard_normal((2, *DIMS, c)).astype(np.float32) for _ in range(3))


def _to_port(stack):
    return tuple(torch.from_numpy(s).movedim(-1, 1) for s in stack)


def _check_stack(got, want):
    for g, w in zip(got, want):
        _assert_rel(g.movedim(1, -1).numpy(), np.asarray(w))


def _load(block, sd):
    block.load_state_dict({k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return block


@pytest.mark.parametrize("mask,out,cin", [("A", False, 8), ("B", False, 8), ("B", True, 6)])
def test_fixup_block_matches_jax(mask, out, cin):
    rng = np.random.default_rng(100 + cin + out)
    jblk = JFixup(out_channels=8, kernel_size=3, mask=mask, out=out, dropout_prob=0.0,
                  num_layers=3)
    stack = _stack(rng, cin)
    shapes = jax.eval_shape(lambda k: jblk.init(k, stack), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = jblk.apply({"params": params}, stack)
    sd = {}
    _fixup_causal_block(params, "blk", sd)
    blk = _load(FixupCausalResBlock(cin, 8, 3, mask, out=out, dropout_prob=0.0, num_layers=3),
                {k[len("blk."):]: v for k, v in sd.items()})
    assert (blk.skip_conv is not None) == (mask == "A" or cin != 8)
    with torch.inference_mode():
        _check_stack(blk(_to_port(stack)), want)
    with pytest.raises(ValueError):
        blk(_to_port(stack), torch.zeros(2, 4, *DIMS))


@pytest.mark.parametrize("mask", ["A", "B"])
@pytest.mark.parametrize("with_cond", [False, True])
def test_concat_block_matches_jax(mask, with_cond):
    rng = np.random.default_rng(110 + 2 * with_cond + (mask == "A"))
    cdim = 6 if with_cond else 0
    jblk = JBlock(out_channels=8, kernel_size=3, mask=mask, condition_dim=cdim,
                  dropout_prob=0.0, bottleneck_divisor=4, concat_activation=True, num_layers=3)
    stack = _stack(rng, 8)
    cond = rng.standard_normal((2, *DIMS, cdim)).astype(np.float32) if with_cond else None
    shapes = jax.eval_shape(lambda k: jblk.init(k, stack, condition=cond), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = jblk.apply({"params": params}, stack, condition=cond)
    sd = {}
    _causal_block(params, "blk", sd)
    blk = _load(PreActFixupCausalResBlock(8, 8, 3, mask, condition_dim=cdim, dropout_prob=0.0,
                                          bottleneck_divisor=4, concat_activation=True,
                                          num_layers=3),
                {k[len("blk."):]: v for k, v in sd.items()})
    # branch max(8 // 4, 2) = 2 over doubled inputs, two groups
    assert blk.branch == 2 and blk.branch_conv2.depth_conv.weight.shape[:2] == (2, 2)
    with torch.inference_mode():
        got = blk(_to_port(stack), None if cond is None else torch.from_numpy(cond).movedim(-1, 1))
    _check_stack(got, want)


@pytest.mark.parametrize("mask,cdim", [("A", 6), ("B", 6), ("A", 0)])
def test_gated_block_matches_jax(mask, cdim):
    rng = np.random.default_rng(120 + cdim + (mask == "A"))
    jblk = JGated(kernel_size=3, mask=mask, condition_dim=cdim, dtype=jnp.float32)
    stack = _stack(rng, 4)
    cond = rng.standard_normal((2, *DIMS, cdim)).astype(np.float32) if cdim else None
    shapes = jax.eval_shape(lambda k: jblk.init(k, stack, condition=cond), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = jblk.apply({"params": params}, stack, condition=cond)
    blk = _load(GatedResBlock(4, 3, mask, condition_dim=cdim),
                jax_gated_block_params_to_state_dict(params))
    with torch.inference_mode():
        got = blk(_to_port(stack), None if cond is None else torch.from_numpy(cond).movedim(-1, 1))
    _check_stack(got, want)


def test_pixelcnn_forward_matches_jax(variant):
    name, fields, jmodel, params, model = variant
    data, cond = _grids(np.random.default_rng(130), 2, True)
    _assert_rel(_port_logits(model, data, cond), _jax_logits(jmodel, params, data, cond))
    assert not model.uses_union_stack
    if name == "fixup":  # kept for the checkpoint, unused by the blocks
        assert model.embed_condition is not None and "embed_condition.weight" in model.state_dict()


def test_prior_loss_and_grads_match_jax(variant):
    name, fields, jmodel, params, model = variant
    rng = np.random.default_rng(140)
    batch = {"data": rng.integers(0, 5, (2, *DIMS)).astype(np.int32),
             "condition": rng.integers(0, 4, (2, *COARSE)).astype(np.int32)}
    (_, jlog), jgrads = jax.value_and_grad(
        lambda p: jpt.prior_loss_fn(jmodel, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                    train=True, rng=jax.random.PRNGKey(0)),
        has_aux=True)(params)
    model.zero_grad(set_to_none=True)
    loss, log = prior_train.prior_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, train=True)
    loss.backward()
    for k, v in jax.device_get(jlog).items():
        np.testing.assert_allclose(float(log[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    ref = jax_pixelcnn_params_to_state_dict(jax.device_get(jgrads), model.config)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    gmax = max(float(v.abs().max()) for v in ref.values())
    for n, prm in named.items():
        got = torch.zeros_like(prm) if prm.grad is None else prm.grad
        tol = max(1e-4 * float(ref[n].abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(got.numpy(), ref[n].numpy(), rtol=0, atol=tol, err_msg=n)
    if name == "fixup":
        assert named["embed_condition.weight"].grad is None
        assert float(ref["embed_condition.weight"].abs().max()) == 0.0


def test_fixup_dropout_with_masks_as_data():
    """A Fixup block's channel dropout (keep (B, 3·C), [d|h|w], kept × 1/(1 − p),
    after the first ELU) against the same block computed by hand; and the
    masks of a whole model follow the block type."""
    p = 0.5
    g = torch.Generator().manual_seed(150)
    blk = FixupCausalResBlock(8, 8, 3, "B", dropout_prob=p, num_layers=3)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.3)
    stack = tuple(torch.randn(2, 8, *DIMS, generator=g) for _ in range(3))
    keep = (torch.rand(2, 24, generator=g) < 0.5).float()
    with torch.no_grad():
        got = blk(stack, train=True, keep=keep)
        want = []
        for si, (x, conv) in enumerate(zip(stack, ("depth_conv", "height_conv", "width_conv"))):
            c1, c2 = getattr(blk.branch_conv1, conv), getattr(blk.branch_conv2, conv)
            (f0, _), (f1, b1), (f2, b2) = c1.pads
            h = F.conv3d(F.pad(x + blk.bias1a, (f2, b2, f1, b1, f0, 0)), c1.weight)
            h = F.elu(h + blk.bias1b) * keep[:, si * 8:(si + 1) * 8, None, None, None] / (1 - p)
            h = F.conv3d(F.pad(h + blk.bias2a, (f2, b2, f1, b1, f0, 0)), c2.weight)
            want.append(F.elu(h * blk.scale + blk.bias2b + x))
        # the block's eval forward is the forward with every channel kept, unscaled
        ones = blk(stack, train=True, keep=torch.ones(2, 24))
        ref = blk(stack)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert not all(torch.allclose(a, b) for a, b in zip(ones, ref))  # kept values scale by 2
    for name, cb in (("fixup", 8), ("concat", 4), ("k5", 4)):
        model = PixelCNN(PixelCNNConfig(**{**tiny_config(False), "dropout_prob": p},
                                        **VARIANTS[name], dtype=torch.float32))
        assert model.layers[0].branch == cb
        x = F.one_hot(torch.randint(0, 5, (2, *DIMS), generator=g), 5).movedim(-1, 1).float()
        keep = (torch.rand(3, 2, 3 * cb, generator=g) < 0.5).float()
        with torch.no_grad():
            a = model(x, train=True, keep=keep)
            b = model(x, train=True, generator=torch.Generator().manual_seed(1))
        assert a.shape == b.shape == (2, 5, *DIMS) and torch.isfinite(a).all()


def _t2j(w):
    return np.transpose(np.asarray(w), (2, 3, 4, 1, 0))


def _state_dict_to_tree(sd, rename):
    """The port's state_dict back to a JAX tree, by key: a conv weight to
    ``kernel`` (O, I, k…) -> (k…, I, O), other leaves as they are."""
    tree = {}
    for key, v in sd.items():
        parts = rename(key).split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        v = v.numpy()
        node["kernel" if parts[-1] == "weight" else parts[-1]] = (
            _t2j(v) if parts[-1] == "weight" else v)
    return tree


def _assert_tree_equal(got, want):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(leaf))


def test_weight_bridge_round_trip(variant, tmp_path):
    name, fields, jmodel, params, model = variant
    sd = model.state_dict()
    if name == "fixup":  # the JAX converter reads pre-activation trees only
        back = _state_dict_to_tree(sd, lambda k: re.sub(r"^layers\.(\d+)\.", r"layer_\1.", k))
    else:
        back = convert_reference_pixelcnn_state_dict(
            {k: v.numpy() for k, v in sd.items()}, JConfig(**fields))["params"]
    _assert_tree_equal(back, params)
    # a port checkpoint with the JAX package's config file loads and runs
    save_prior(tmp_path / "ck", model, step=1)
    (tmp_path / "ck" / "step_1_config.json").write_text(
        _config_to_json(JConfig(**fields, dtype=jnp.float32)))
    loaded, cfg = load_prior(tmp_path / "ck", device="cpu")
    assert cfg == model.config
    data, cond = _grids(np.random.default_rng(160), 1, True)
    np.testing.assert_array_equal(_port_logits(loaded, data, cond),
                                  _port_logits(model, data, cond))


def test_gated_weight_bridge_round_trip():
    jblk = JGated(kernel_size=3, mask="A", condition_dim=6, dtype=jnp.float32)
    stack = _stack(np.random.default_rng(170), 4)
    cond = np.zeros((2, *DIMS, 6), np.float32)
    shapes = jax.eval_shape(lambda k: jblk.init(k, stack, condition=cond), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], np.random.default_rng(171))
    blk = _load(GatedResBlock(4, 3, "A", condition_dim=6),
                jax_gated_block_params_to_state_dict(params))
    _assert_tree_equal(_state_dict_to_tree(blk.state_dict(), lambda k: k), params)
