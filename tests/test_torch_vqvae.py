"""Whole-model parity of the port with the JAX VQ-VAE, the weight bridge,
the checkpoint/config interchange and the options outside the port's slice.

Every parameter of the JAX model is randomized from a numpy seed (the
zero-init ``branch_conv3`` would otherwise make each 'same' block the
identity), the tree goes through ``jax_variables_to_state_dict`` into the
port, and both run the same input at fp32 on the CPU. Tolerances are those
of tests/test_checkpoint.py:122-138: indices exact, quantizations within
2e-4, decoded volume within 2e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE, VQVAEConfig as JConfig
from vqvae3d_tpu.train.checkpoint import (
    _config_from_json,
    _config_to_json,
    convert_reference_vqvae_state_dict,
)
from vqvae3d_tpu_torch.checkpoint import (
    config_from_json,
    config_to_json,
    load_model,
    save_checkpoint,
)
from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig

BLOCKS = dict(
    n_pre_quantization_blocks=1,
    n_post_quantization_blocks=1,
    n_post_upscale_blocks=1,
    n_post_downscale_blocks=1,
)


def _configs(levels, stem, pad_mode):
    kw = dict(
        BLOCKS,
        n_bottleneck_blocks=levels,
        num_embeddings=(16, 32, 64)[:levels],
        base_network_channels=4 * stem,
        stem_space_to_depth=stem,
        pad_mode=pad_mode,
    )
    return (
        JConfig(**kw, dtype=jnp.float32, remat=False, argmin_method="ref"),
        VQVAEConfig(**kw, dtype=torch.float32),
    )


def _random_variables(jmodel, shape, rng):
    """A JAX variable tree of random values (shapes from eval_shape: no init
    compile). Params ~ N(0, 0.2²) as tests/test_checkpoint.py draws them;
    codebooks ~ N(0, 1); the quantizers marked initialized."""
    shapes = jax.eval_shape(
        lambda key, x: jmodel.init(key, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros(shape),
    )
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"]
    )
    quantizer = {"encoder": {}}
    for name, q in shapes["quantizer"]["encoder"].items():
        embed = rng.standard_normal(q["embed"].shape).astype(np.float32)
        quantizer["encoder"][name] = {
            "embed": embed,
            "embed_avg": embed.copy(),
            "cluster_size": np.zeros(q["cluster_size"].shape, np.float32),
            "initialized": np.ones((), bool),
        }
    return {"params": params, "quantizer": quantizer}


@pytest.mark.parametrize(
    "levels,stem,pad_mode,shape",
    [
        (2, 1, "wrap", (32, 32, 16)),
        (2, 2, "zeros", (32, 32, 16)),
        (3, 1, "zeros", (64, 64, 64)),  # the smallest volume three levels admit
        (3, 2, "wrap", (64, 64, 64)),
    ],
)
def test_vqvae_matches_jax(levels, stem, pad_mode, shape, monkeypatch):
    # The JAX block-space conv rewrites are a TPU layout device (same math);
    # off, as bench.py runs literal serving, they keep the 64³ compile short.
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    jcfg, tcfg = _configs(levels, stem, pad_mode)
    rng = np.random.default_rng(levels * 10 + stem)
    x = rng.standard_normal((1, *shape, 1)).astype(np.float32)
    jmodel = JVQVAE(jcfg)
    variables = _random_variables(jmodel, x.shape, rng)
    decoded, (losses, quants, indices) = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False)
    )(variables, x)

    model = VQVAE(tcfg)
    model.load_state_dict(jax_variables_to_state_dict(variables, tcfg))
    with torch.inference_mode():
        t_dec, (t_losses, t_quants, t_indices) = model(torch.from_numpy(x).movedim(-1, 1))

    for lvl in range(levels):
        np.testing.assert_array_equal(t_indices[lvl].numpy(), np.asarray(indices[lvl]))
        np.testing.assert_allclose(
            t_quants[lvl].movedim(1, -1).numpy(), np.asarray(quants[lvl]), atol=2e-4, rtol=0
        )
        np.testing.assert_allclose(float(t_losses[lvl]), float(losses[lvl]), rtol=1e-4)
    np.testing.assert_allclose(
        t_dec.movedim(1, -1).numpy(), np.asarray(decoded), atol=2e-3, rtol=0
    )


def test_state_dict_round_trips_through_the_reference_converter():
    """stem=1: the port's state_dict IS a reference checkpoint —
    convert_reference_vqvae_state_dict maps it back onto the JAX tree."""
    jcfg, tcfg = _configs(2, 1, "wrap")
    rng = np.random.default_rng(7)
    variables = _random_variables(JVQVAE(jcfg), (1, 32, 32, 16, 1), rng)
    model = VQVAE(tcfg)
    model.load_state_dict(jax_variables_to_state_dict(variables, tcfg))  # strict: all keys
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = jax.device_get(convert_reference_vqvae_state_dict(sd, jcfg))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_want[path]))


def test_config_json_interchange():
    jcfg = JConfig(num_embeddings=(128, 256, 512), n_pre_quantization_blocks=50,
                   stem_space_to_depth=2, base_network_channels=8, pad_mode="zeros")
    tcfg = config_from_json(_config_to_json(jcfg))
    assert tcfg.dtype == torch.bfloat16
    assert dataclasses.asdict(tcfg) | {"dtype": None} == dataclasses.asdict(jcfg) | {"dtype": None}
    assert _config_from_json(JConfig, config_to_json(tcfg)) == jcfg


def test_full_config_counts():
    """The published full config (bench.py:117-128): 342 'same' blocks per
    volume with the literal stem, 337 with the s2d stem."""
    full = dict(num_embeddings=(128, 256, 512), n_pre_quantization_blocks=50,
                n_post_quantization_blocks=50, n_post_downscale_blocks=2,
                n_post_upscale_blocks=3)
    lit = VQVAEConfig(**full)
    s2d = VQVAEConfig(**full, base_network_channels=8, stem_space_to_depth=2)
    vol = (512, 512, 128)
    assert sum(n for *_, n in lit.same_stacks(vol)) == 342
    assert sum(n for *_, n in s2d.same_stacks(vol)) == 337
    # the decoder's last stack: C=4 at full resolution (literal stem only)
    assert lit.same_stacks(vol)[-1] == ("decode", 4, vol, 3)
    assert ("decode", 8, (256, 256, 64), 3) == s2d.same_stacks(vol)[-1]
    assert lit.embedding_dims == s2d.embedding_dims == [2, 8, 32]
    assert lit.code_grid_shapes((512, 512, 128)) == [(128, 128, 32), (32, 32, 8), (8, 8, 2)]


@pytest.mark.parametrize("stem", [1, 2])
def test_same_stacks_match_the_model_run(stem, monkeypatch):
    """same_stacks lists exactly the stacks an encode + decode runs."""
    from vqvae3d_tpu_torch.models import blocks

    cfg = VQVAEConfig(**BLOCKS, n_bottleneck_blocks=3, num_embeddings=(8,),
                      stem_space_to_depth=stem, base_network_channels=4 * stem,
                      dtype=torch.float32)
    seen, plain = [], blocks.preact_stack_fused
    monkeypatch.setattr(blocks, "preact_stack_fused", lambda x, w1s, *a: (
        seen.append((x.shape[1], tuple(x.shape[2:]), w1s.shape[0])) or plain(x, w1s, *a)))
    with torch.inference_mode():
        VQVAE(cfg)(torch.zeros(1, 1, 64, 64, 64))
    assert seen == [s[1:] for s in cfg.same_stacks((64, 64, 64))]


@pytest.mark.parametrize(
    "field,value",
    [("block_type", "regular"), ("encoder_variant", "encoder"), ("metric", "mixture-nll")],
)
def test_options_outside_the_slice_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        VQVAE(VQVAEConfig(n_bottleneck_blocks=2, num_embeddings=(8, 8), **{field: value}))


def test_train_mode_raises_and_checkpoint_round_trips(tmp_path):
    """Train mode used to raise; since the train step is ported it runs and
    initialises the codebooks, and the checkpoint round-trips the result."""
    cfg = VQVAEConfig(n_bottleneck_blocks=2, num_embeddings=(8, 16), dtype=torch.float32)
    model = VQVAE(cfg, generator=torch.Generator().manual_seed(3))
    x = torch.randn(1, 1, 32, 32, 16)
    embed0 = model.encoder.quantize[0].embed.clone()
    model(x, train=True)
    assert not bool(model.encoder.quantize[0].first_pass)
    assert not torch.equal(model.encoder.quantize[0].embed, embed0)
    save_checkpoint(tmp_path, model.state_dict(), cfg, step=5)
    loaded, cfg2 = load_model(tmp_path)
    assert cfg2 == cfg
    with torch.inference_mode():
        a, _ = model(x)
        b, _ = loaded(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
