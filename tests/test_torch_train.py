"""The port's stage-1 train step against the JAX package's, on the CPU.

  * One and two train steps (the first initialises the codebooks from the
    data, the second is a second AMSGrad step), stems 1 and 2, both pad
    modes, fp32, against the JAX ``make_train_step`` on the same random
    weights (a JAX variable tree through ``jax_variables_to_state_dict``)
    and the same batch:
      - every log-dict value within rel 1e-5, or abs 1e-5 for values near 0
        (the per-voxel loss minimum; means of signed values such as
        loc_mean, where fp32 sums in another order cancel: measured 2e-6);
      - every gradient within 1e-4 · max|ref| of its tensor, or 1e-5 of the
        largest gradient of the model where the tensor's own gradient is a
        near-cancelling sum (single Fixup scalars whose gradients lie 1e-10
        to 1e-5 below the largest; measured at most 1.6e-6 of the largest
        for every tensor). The JAX step does not return its
        gradients; they are read back exactly from its AMSGrad first moment:
        g1 = mu1 / (1 - b1), g2 = (mu2 - b1 mu1) / (1 - b1);
      - the EMA state (embed, embed_avg, cluster_size, first_pass) within
        1e-5;
      - the parameters after the step, per element within
        lr · min(2, 4 · tol / |g|) + 1e-3 · lr, tol the gradient's tolerance
        above: Adam's step is a ratio
        of moments, so a gradient within the tolerance above moves it by at
        most about twice its relative error (taken 4× for the mix of two
        steps), and a near-zero gradient can flip its sign, 2 · lr.
  * The eval step against ``make_eval_step``, SSIM and medians included.
  * ``AMSGrad`` against ``optax.amsgrad`` over 5 steps of falling gradients.
  * The huber loss, the depth mask and the checkpoint's train state
    (save, restore, retention).
The JAX side runs with ``VQVAE3D_BLOCK_REWRITE=0`` (its block-space conv
rewrites are a TPU layout device: same math, a longer compile).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE, VQVAEConfig as JConfig
from vqvae3d_tpu.train.state import VQVAETrainState, make_optimizer
from vqvae3d_tpu.train.vqvae_train import make_eval_step as jmake_eval_step
from vqvae3d_tpu.train.vqvae_train import make_train_step as jmake_train_step
from vqvae3d_tpu_torch import checkpoint
from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig
from vqvae3d_tpu_torch.train import vqvae_train
from vqvae3d_tpu_torch.train.state import AMSGrad, amsgrad_update

LR = 1e-3
B1 = 0.9
SHAPE = (32, 32, 16)
BLOCKS = dict(n_pre_quantization_blocks=1, n_post_quantization_blocks=1,
              n_post_upscale_blocks=1, n_post_downscale_blocks=1)


def _configs(stem, pad_mode, blocks=BLOCKS):
    kw = dict(blocks, n_bottleneck_blocks=2, num_embeddings=(16, 32),
              base_network_channels=4 * stem, stem_space_to_depth=stem, pad_mode=pad_mode,
              base_lr=LR)
    return (JConfig(**kw, dtype=jnp.float32, remat=False, argmin_method="ref"),
            VQVAEConfig(**kw, dtype=torch.float32))


def _variables(jmodel, rng, initialized):
    """Random JAX variables: params ~ N(0, 0.1²), codebooks ~ N(0, 1)."""
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 1)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes["params"])
    quantizer = {"encoder": {}}
    for name, q in shapes["quantizer"]["encoder"].items():
        embed = rng.standard_normal(q["embed"].shape).astype(np.float32)
        quantizer["encoder"][name] = {
            "embed": embed, "embed_avg": embed.copy(),
            "cluster_size": (np.full(q["cluster_size"].shape, 3.0, np.float32)
                             if initialized else np.zeros(q["cluster_size"].shape, np.float32)),
            "initialized": np.asarray(initialized),
        }
    return {"params": params, "quantizer": quantizer}


def _batch(rng, b=2):
    vol = rng.uniform(-0.5, 4.0, size=(b, *SHAPE, 1)).astype(np.float32)
    nv = np.array([SHAPE[2], SHAPE[2] - 4][:b], np.int32)
    vol[1:, :, :, nv[-1]:] = 0.0  # padded slices, as the loader writes them
    return {"volume": vol, "num_valid_slices": nv}


def _port(tcfg, variables):
    model = VQVAE(tcfg)
    model.load_state_dict(jax_variables_to_state_dict(variables, tcfg))
    opt = AMSGrad(model.parameters(), lr=LR)
    return model, opt


def _check_logs(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _sd(tree, tcfg, quantizer):
    return jax_variables_to_state_dict({"params": tree, "quantizer": quantizer}, tcfg)


def _check_step(model, jstate, grads_ref, tcfg, log, jlog):
    _check_logs(log, jlog)
    ref = _sd(grads_ref, tcfg, jstate.quantizer)
    gmax = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    params_ref = _sd(jax.device_get(jstate.params), tcfg, jstate.quantizer)
    named = dict(model.named_parameters())
    assert set(named) == {k for k in ref if not k.startswith("encoder.quantize")}
    for name, p in named.items():
        g_ref = ref[name].numpy()
        tmax = np.abs(g_ref).max()
        tol = max(1e-4 * tmax, 1e-5 * gmax)
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0, atol=tol, err_msg=name)
        # Adam's step is a ratio of moments: a gradient off by a relative d moves
        # the step by ~2d lr; d <= tol / |g| here, taken 4x for the mix of two
        # steps' moments, capped at a sign flip's 2 lr
        err = np.abs(p.detach().numpy() - params_ref[name].numpy())
        tol_p = LR * np.minimum(2.0, 4 * tol / np.maximum(np.abs(g_ref), 1e-30))
        assert np.all(err <= tol_p + 1e-3 * LR), (name, float((err / (tol_p + 1e-3 * LR)).max()))
    sd = model.state_dict()
    for lvl in range(tcfg.n_bottleneck_blocks):
        q = jstate.quantizer["encoder"][f"quantize_{lvl}"]
        for key in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_allclose(sd[f"encoder.quantize.{lvl}.{key}"].numpy(),
                                       np.asarray(q[key]), rtol=1e-5, atol=1e-5, err_msg=key)
        assert bool(sd[f"encoder.quantize.{lvl}.first_pass"]) == (not bool(q["initialized"]))


@pytest.mark.parametrize("stem,pad_mode", [(1, "wrap"), (1, "zeros"), (2, "wrap"), (2, "zeros")])
def test_two_train_steps_match_jax(stem, pad_mode, monkeypatch):
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    # 'zeros' runs only the pre-/post-quantization stacks (a shorter JAX compile)
    blocks = BLOCKS if pad_mode == "wrap" else dict(BLOCKS, n_post_upscale_blocks=0,
                                                    n_post_downscale_blocks=0)
    jcfg, tcfg = _configs(stem, pad_mode, blocks)
    rng = np.random.default_rng(stem * 10 + len(pad_mode))
    jmodel = JVQVAE(jcfg)
    variables = _variables(jmodel, rng, initialized=False)
    batch = _batch(rng)

    jstate = VQVAETrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                    tx=make_optimizer(LR), quantizer=variables["quantizer"])
    unravel = ravel_pytree(jstate.params)[1]
    jstep = jmake_train_step(jmodel, donate=False)
    model, opt = _port(tcfg, variables)
    step = vqvae_train.make_train_step(model, opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    mu_prev = np.zeros_like(np.asarray(jstate.opt_state[0].mu), np.float64)
    for n in (1, 2):
        jstate, jlog = jstep(jstate, batch)
        mu = np.asarray(jstate.opt_state[0].mu, np.float64)
        grads = unravel(jnp.asarray(((mu - B1 * mu_prev) / (1 - B1)).astype(np.float32)))
        mu_prev = mu
        log = step(tbatch)
        assert int(jstate.step) == opt.count == n
        _check_step(model, jstate, jax.device_get(grads), tcfg, log, jax.device_get(jlog))


def test_eval_step_matches_jax(monkeypatch):
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    jcfg, tcfg = _configs(1, "wrap")
    rng = np.random.default_rng(5)
    jmodel = JVQVAE(jcfg)
    variables = _variables(jmodel, rng, initialized=True)
    batch = _batch(rng)
    jstate = VQVAETrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                    tx=make_optimizer(LR), quantizer=variables["quantizer"])
    jlog = jax.device_get(jmake_eval_step(jmodel)(jstate, batch))
    model, _ = _port(tcfg, variables)
    log = vqvae_train.make_eval_step(model)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert "ssim" in log and "recon_loss_median" in log
    _check_logs(log, jlog)


def test_amsgrad_matches_optax():
    """Falling gradient magnitudes, so the running max of the bias-corrected
    second moment is what decides the later steps (torch's Adam(amsgrad)
    keeps the max of the raw moment and would differ from step 2 on)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(50).astype(np.float32)
    tx = optax.amsgrad(LR, 0.9, 0.999, 1e-8)
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    mu, nu, nu_max = (torch.zeros(50) for _ in range(3))
    p = torch.from_numpy(p0.copy())
    for t in range(1, 6):
        g = (rng.standard_normal(50) * 10.0 ** (1 - t)).astype(np.float32)
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        p += amsgrad_update(torch.from_numpy(g), mu, nu, nu_max, t, LR)
        np.testing.assert_allclose(nu_max.numpy(), np.asarray(jstate[0].nu_max), rtol=1e-6)
        np.testing.assert_allclose((p - torch.from_numpy(p0)).numpy(),
                                   np.asarray(jp) - p0, rtol=1e-6, atol=1e-9)


def test_huber_and_depth_mask():
    x = torch.linspace(-3, 3, 61)
    torch.testing.assert_close(vqvae_train.huber_loss(x, torch.zeros_like(x)),
                               F.smooth_l1_loss(x, torch.zeros_like(x), reduction="none"))
    m = vqvae_train.depth_valid_mask(torch.tensor([2, 4]), 4)
    assert m.shape == (2, 1, 1, 1, 4)
    np.testing.assert_array_equal(m[:, 0, 0, 0].numpy(), [[1, 1, 0, 0], [1, 1, 1, 1]])


def test_train_state_checkpoint_round_trip(tmp_path):
    cfg = VQVAEConfig(n_bottleneck_blocks=2, num_embeddings=(8, 16), dtype=torch.float32)
    model = VQVAE(cfg, generator=torch.Generator().manual_seed(1))
    opt = AMSGrad(model.parameters(), lr=LR)
    step = vqvae_train.make_train_step(model, opt)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng, b=1).items()}
    step(batch)
    for s in (1, 2):
        checkpoint.save_train_state(tmp_path, model, opt, cfg, s, max_to_keep=1)
    assert sorted(f.name for f in tmp_path.glob("step_*")) == [
        "step_2.pt", "step_2_config.json", "step_2_train.pt"]
    model2 = VQVAE(cfg, generator=torch.Generator().manual_seed(9))
    opt2 = AMSGrad(model2.parameters(), lr=LR)
    assert checkpoint.restore_train_state(tmp_path, model2, opt2) == 2
    assert opt2.count == opt.count == 1
    torch.testing.assert_close(opt2.nu_max, opt.nu_max, rtol=0, atol=0)
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    # the serving side reads the same directory
    served, cfg2 = checkpoint.load_model(tmp_path, device="cpu")
    assert cfg2 == cfg and not bool(served.encoder.quantize[0].first_pass)
