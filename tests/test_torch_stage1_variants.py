"""The stage-1 train step with the options beside the default: the
'regular' and 'evonorm' block types, the legacy encoder, and the mixture-NLL
head at both stems, against the JAX package on the CPU at fp32 (their eval
forwards: tests/test_torch_vqvae.py::test_stage1_options_match_jax).

A small VQ-VAE (2 levels, 1 block a stack, 32x32x16): a random JAX variable
tree (numpy seed) goes through ``jax_variables_to_state_dict`` into the port
(strict, so the parameter trees agree key for key), and both take one train
step (JAX ``make_train_step``, its gradients read back from the AMSGrad
first moment, g = mu / (1 - b1)) on the same batch: the loss within 1e-5
relative, every gradient within 1e-3 x max|ref| of its tensor. Each JAX
train step costs ~20 s of XLA compile on the CPU, so the options share two
models: 'regular' blocks with the legacy encoder and the mixture head at
stem 1, and 'evonorm' blocks with the mixture head at stem 2 (the
pre-activation block's train step is tests/test_torch_train.py's).
The mixture head at stem 2 pins the channel order under the s2d stem: the
JAX train step splits the head in its folded layout, the port after
``depth_to_space``. The JAX side runs with ``VQVAE3D_BLOCK_REWRITE=0`` (a TPU
layout device: the same math, a longer compile)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE, VQVAEConfig as JConfig
from vqvae3d_tpu.train.state import VQVAETrainState, make_optimizer
from vqvae3d_tpu.train.vqvae_train import make_train_step as jmake_train_step
from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig
from vqvae3d_tpu_torch.train import vqvae_train
from vqvae3d_tpu_torch.train.state import AMSGrad

LR, B1 = 1e-3, 0.9
SHAPE = (32, 32, 16)
BLOCKS = dict(n_pre_quantization_blocks=1, n_post_quantization_blocks=1,
              n_post_upscale_blocks=1, n_post_downscale_blocks=1)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-3


def _configs(fields, stem):
    kw = dict(BLOCKS, **fields, n_bottleneck_blocks=2, num_embeddings=(16, 32),
              base_network_channels=4 * stem, stem_space_to_depth=stem, pad_mode="wrap",
              base_lr=LR)
    return (JConfig(**kw, dtype=jnp.float32, remat=False, argmin_method="ref"),
            VQVAEConfig(**kw, dtype=torch.float32))


def _variables(jmodel, rng):
    """Random JAX variables: params ~ N(0, 0.1²) (every zero init moved
    off, so each branch counts), codebooks ~ N(0, 1), initialised."""
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 1)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes["params"])
    quantizer = {"encoder": {}}
    for name, q in shapes["quantizer"]["encoder"].items():
        embed = rng.standard_normal(q["embed"].shape).astype(np.float32)
        quantizer["encoder"][name] = {
            "embed": embed, "embed_avg": embed.copy(),
            "cluster_size": np.full(q["cluster_size"].shape, 3.0, np.float32),
            "initialized": np.asarray(True),
        }
    return {"params": params, "quantizer": quantizer}


def _batch(rng):
    vol = rng.uniform(-0.5, 4.0, size=(2, *SHAPE, 1)).astype(np.float32)
    nv = np.array([SHAPE[2], SHAPE[2] - 4], np.int32)
    vol[1:, :, :, nv[-1]:] = 0.0  # padded slices, as the loader writes them
    return {"volume": vol, "num_valid_slices": nv}


def _check_train_step(jmodel, variables, model, tcfg, batch):
    jstate = VQVAETrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                    tx=make_optimizer(LR), quantizer=variables["quantizer"])
    jstate, jlog = jmake_train_step(jmodel, donate=False)(jstate, batch)
    mu = np.asarray(jstate.opt_state[0].mu)
    unravel = jax.flatten_util.ravel_pytree(jstate.params)[1]
    grads = jax.device_get(unravel(jnp.asarray(mu / (1 - B1))))
    ref = jax_variables_to_state_dict({"params": grads, "quantizer": variables["quantizer"]},
                                      tcfg)
    opt = AMSGrad(model.parameters(), lr=LR)
    log = vqvae_train.make_train_step(model, opt)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]), rtol=LOSS_TOL)
    named = dict(model.named_parameters())
    assert set(named) == {k for k in ref if not k.startswith("encoder.quantize")}
    for name, p in named.items():
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=name)


TRAIN_MODELS = {  # name: (config fields, stem)
    "regular, legacy encoder, mixture-nll stem 1": (
        dict(block_type="regular", encoder_variant="encoder", metric="mixture-nll", n_mix=2), 1),
    "evonorm, mixture-nll stem 2": (dict(block_type="evonorm", metric="mixture-nll", n_mix=3), 2),
}


@pytest.mark.parametrize("name", list(TRAIN_MODELS))
def test_train_step_matches_jax(name, monkeypatch):
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    jcfg, tcfg = _configs(*TRAIN_MODELS[name])
    rng = np.random.default_rng(10 + list(TRAIN_MODELS).index(name))
    jmodel = JVQVAE(jcfg)
    variables = _variables(jmodel, rng)
    model = VQVAE(tcfg)
    model.load_state_dict(jax_variables_to_state_dict(variables, tcfg))
    _check_train_step(jmodel, variables, model, tcfg, _batch(rng))
