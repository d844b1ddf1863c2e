"""The port's convergence tools (``vqvae3d_tpu_torch/tools/``) against the
JAX package's (``tools/convergence_smoke.py``, ``tools/prior_convergence_
smoke.py``), and the stage-1 CLI chain, on the CPU.

  * The synthetic data: the port's ``make_diverse_ct_dir`` (2 scans of
    48x48x16) and ``synth_codes`` (16x16x8 on 4x4x2, the training seeds and
    the held-out 9999) give arrays equal to the JAX tools' from the same
    seeds (the JAX tools are loaded by path from ``tools/``).
  * The stage-1 tool's ``run`` at tests/test_torch_train.py's tiny fp32
    config (stem 2, 'wrap', codebooks 16 / 32, one pre- and one
    post-quantization block a level, no post-resize blocks as in that file's
    'zeros' cases, for a shorter JAX compile; lr 1e-3) from random JAX
    weights carried over by ``convert``: 5 steps, then 4 resumed from the
    checkpoint (the loader restarted at epoch 0), every step logged, against
    the JAX ``make_train_step`` loop of the JAX tool on the same weights and
    the batches of the JAX ``CTDataModule`` (same seed, pre-folded as the
    JAX tool feeds them; its loader also restarted at epoch 0 after step
    5). Every log value at every step within
    ``STAGE1_TOL`` relative (absolute near 0): the fp32 sums of two
    frameworks in another order, compounded over 9 AMSGrad steps and 9 EMA
    codebook updates; worst measured 1.03e-5 (``train_nmse``, step 2).
  * The prior tool's ``run`` at a tiny fp32 PixelCNN (5 codes on 4, 8
    channels, 2 blocks) from random JAX weights: 3 steps and 2 resumed equal
    5 uninterrupted steps bit for bit (parameters, optimizer state, the
    train and validation logs of steps 4-5); the 5 steps' logs and the
    validation at step 5 against the JAX ``make_prior_train_step`` /
    ``make_prior_eval_step`` loop of the JAX tool within ``PRIOR_TOL``
    (worst measured 5.26e-7).
  * The stage-1 CLI chain of tests/test_e2e_pipeline.py's first half:
    ``train_vqvae`` -> ``extract_embeddings`` -> ``decode_embeddings`` ->
    ``calc_ssim_from_checkpoint``, each through its ``main`` on the CPU.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prior_train import _models as prior_models
from test_torch_train import BLOCKS, LR, _configs, _variables
from vqvae3d_tpu.data.ct_dataset import CTDataModule as JCTDataModule
from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE
from vqvae3d_tpu.train import prior_train as jpt
from vqvae3d_tpu.train.state import VQVAETrainState, make_optimizer
from vqvae3d_tpu.train.vqvae_train import make_train_step as jmake_train_step
from vqvae3d_tpu_torch.cli import (calc_ssim_from_checkpoint, decode_embeddings,
                                   extract_embeddings, train_vqvae)
from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.tools import convergence_smoke, prior_convergence_smoke

REPO = Path(__file__).resolve().parents[1]
RES, DEPTH, N_SCANS = 48, 16, 2  # the JAX generator needs res >= 34
STAGE1_LEGS = (5, 4)  # steps, then resumed steps
STAGE1_TOL = 1e-4  # rel (abs for |ref| < 1); worst measured 1.03e-5
PRIOR_DIMS, PRIOR_COND = (16, 16, 8), (4, 4, 2)
PRIOR_TOL = 1e-5  # rel (abs for |ref| < 1); worst measured 5.26e-7
TIMES = ("time", "wall_step_ms", "cuda_step_ms")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _records(out):
    return [json.loads(line) for line in (Path(out) / "metrics.jsonl").read_text().splitlines()]


def _worst(got: dict, want: dict, prefix: str) -> float:
    """max over ``want``'s keys of |got - want| / max(|want|, 1)."""
    assert {k for k in got if k not in TIMES + ("step",)} == {prefix + k for k in want}
    return max(abs(got[prefix + k] - float(v)) / max(abs(float(v)), 1.0)
               for k, v in want.items())


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv") / "ct"
    convergence_smoke.make_diverse_ct_dir(root, N_SCANS, RES, DEPTH, seed=0)
    return root


def test_generators_match_jax_tools(scans, tmp_path):
    jstage1, jprior = _jax_tool("convergence_smoke"), _jax_tool("prior_convergence_smoke")
    jstage1.make_diverse_ct_dir(str(tmp_path / "jax"), N_SCANS, RES, DEPTH, seed=0)
    for i in range(N_SCANS):
        got, header = nrrd_io.read(scans / f"scan{i}.nrrd")
        want, jheader = nrrd_io.read(tmp_path / "jax" / f"scan{i}.nrrd")
        assert got.dtype == want.dtype == np.int16 and got.shape == (RES, RES, DEPTH)
        np.testing.assert_array_equal(got, want)
        for key in ("type", "sizes", "encoding", "spacings"):
            np.testing.assert_array_equal(header[key], jheader[key], err_msg=key)
    for seed in (1000, 1001, prior_convergence_smoke.HELDOUT_SEED):
        got = prior_convergence_smoke.synth_codes(seed, PRIOR_DIMS, 5, PRIOR_COND, 4)
        want = jprior.synth_codes(seed, PRIOR_DIMS, 5, PRIOR_COND, 4)
        for g, w, shape in zip(got, want, (PRIOR_DIMS, PRIOR_COND), strict=True):
            assert g.dtype == w.dtype == np.int32 and g.shape == shape
            np.testing.assert_array_equal(g, w)


def test_stage1_tool_matches_jax_loop(scans, tmp_path, monkeypatch):
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    jcfg, tcfg = _configs(2, "wrap", dict(BLOCKS, n_post_upscale_blocks=0,
                                          n_post_downscale_blocks=0))
    jmodel = JVQVAE(jcfg)
    variables = _variables(jmodel, np.random.default_rng(7), initialized=False)

    out = tmp_path / "run"
    dm = CTDataModule(str(scans), batch_size=1, train_frac=1.0, num_workers=1,
                      size=(RES, RES, None), output_depth=DEPTH)
    for n, resume in zip(STAGE1_LEGS, (False, True)):
        _, opt, step = convergence_smoke.run(
            tcfg, dm, out, steps=n, resume_steps=n, log_every=1, device="cpu",
            state_dict=None if resume else jax_variables_to_state_dict(variables, tcfg))
        assert step == opt.count == sum(STAGE1_LEGS[: 1 + resume])
    records = _records(out)
    assert [r["step"] for r in records] == list(range(1, sum(STAGE1_LEGS) + 1))

    # the JAX tool's loop: its pre-folded batches, the loader at epoch 0 on resume
    jdm = JCTDataModule(str(scans), batch_size=1, train_frac=1.0, num_workers=1,
                        size=(RES, RES, None), output_depth=DEPTH)
    jstate = VQVAETrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                    tx=make_optimizer(LR), quantizer=variables["quantizer"])
    jstep = jmake_train_step(jmodel, donate=False)
    worst, target = [], 0
    for n in STAGE1_LEGS:
        target, epoch = target + n, 0
        while int(jstate.step) < target:
            for batch in jdm.train_dataloader(epoch=epoch, fold=jcfg.stem_space_to_depth):
                jstate, jlog = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
                s = int(jstate.step)
                worst.append(_worst(records[s - 1], jax.device_get(jlog), "train_"))
                if s >= target:
                    break
            epoch += 1
    assert len(worst) == sum(STAGE1_LEGS)
    assert max(worst) <= STAGE1_TOL, [f"{w:.2e}" for w in worst]


def test_prior_tool_resume_replays_and_matches_jax(tmp_path):
    jmodel, params, model, tcfg = prior_models(True, seed=40)
    sd = model.state_dict()
    k, k_cond = tcfg.input_dim, tcfg.condition_dim
    samples = [prior_convergence_smoke.synth_codes(1000 + i, PRIOR_DIMS, k, PRIOR_COND, k_cond)
               for i in range(3)]
    heldout = prior_convergence_smoke.synth_codes(9999, PRIOR_DIMS, k, PRIOR_COND, k_cond)
    kw = dict(log_every=1, eval_every=2, device="cpu")

    whole, opt_w, _ = prior_convergence_smoke.run(tcfg, samples, heldout, tmp_path / "whole",
                                                  steps=5, resume_steps=0, state_dict=sd, **kw)
    for n, resume in ((3, False), (2, True)):
        legs, opt_l, step = prior_convergence_smoke.run(
            tcfg, samples, heldout, tmp_path / "legs", steps=n, resume_steps=n,
            state_dict=None if resume else sd, **kw)
    assert step == opt_l.count == opt_w.count == 5
    for (name, a), b in zip(whole.state_dict().items(), legs.state_dict().values()):
        assert torch.equal(a, b), name
    for key in ("mu", "nu", "nu_max"):
        assert torch.equal(getattr(opt_w, key), getattr(opt_l, key)), key

    def lines(out, step):
        return [{k: v for k, v in r.items() if k not in TIMES}
                for r in _records(out) if r["step"] == step]

    for s in (4, 5):
        assert lines(tmp_path / "whole", s) == lines(tmp_path / "legs", s)

    # the JAX tool's loop on the same weights: sample s % n, its PRNGKey(7)
    jstate = jpt.PriorTrainState.create(apply_fn=jmodel.apply, params=params,
                                        tx=make_optimizer(tcfg.lr))
    jstep = jpt.make_prior_train_step(jmodel, donate=False)
    train = [r for r in _records(tmp_path / "whole") if "train_loss_mean" in r]
    worst = []
    for s in range(5):
        data, cond = samples[s % len(samples)]
        jstate, jlog = jstep(jstate, {"data": jnp.asarray(data[None]),
                                      "condition": jnp.asarray(cond[None])},
                             jax.random.PRNGKey(7))
        worst.append(_worst(train[s], jax.device_get(jlog), "train_"))
    jval = jpt.make_prior_eval_step(jmodel)(jstate, {"data": jnp.asarray(heldout[0][None]),
                                                     "condition": jnp.asarray(heldout[1][None])})
    val = [r for r in _records(tmp_path / "whole") if "val_loss_mean" in r and r["step"] == 5]
    worst.append(_worst(val[0], jax.device_get(jval), "val_"))
    assert max(worst) <= PRIOR_TOL, [f"{w:.2e}" for w in worst]


def test_stage1_cli_chain_on_cpu(scans, tmp_path):
    """train_vqvae -> extract_embeddings -> decode_embeddings ->
    calc_ssim_from_checkpoint, each through its main at a tiny config."""
    ckpt, size = tmp_path / "ckpt", ["--scan-size", str(RES), str(RES),
                                     "--output-depth", str(DEPTH)]
    _, _, step = train_vqvae.main(train_vqvae.parse_arguments([
        str(scans), "--ckpt-dir", str(ckpt), "--batch-size", "1", "--num-embeddings", "8", "16",
        "--n-bottleneck-blocks", "2", "--n-pre-quantization-blocks", "1",
        "--n-post-quantization-blocks", "1", "--stem-space-to-depth", "2",
        "--base-network-channels", "8", "--max-steps", "2", "--val-every-steps", "2",
        "--log-every-n-steps", "1", "--num-workers", "1", "--precision", "fp32",
        "--device", "cpu", *size]))
    assert step == 2
    extract_embeddings.main(extract_embeddings.parse_arguments([
        "--checkpoint-path", str(ckpt), "--dataset-path", str(scans), "--output-path",
        str(tmp_path), "--output-name", "codes", "--rescale-input", "0", "--backend", "file",
        "--device", "cpu", *size]))
    codes = extract_embeddings.read_codes(tmp_path / "codes")
    assert len(codes) == N_SCANS
    assert [g.shape for g in codes[0]] == [(12, 12, 4), (3, 3, 1)]
    assert all(0 <= g.min() and g.max() < k for grids in codes
               for g, k in zip(grids, (8, 16), strict=True))

    decode_embeddings.code_store_to_sample_db(tmp_path / "codes", tmp_path / "s.db")
    n = decode_embeddings.main(decode_embeddings.parse_arguments([
        str(tmp_path / "s.db"), str(ckpt), str(tmp_path / "decoded" / "v"), "--volume-shape",
        str(RES), str(RES), str(DEPTH), "--device", "cpu"]))
    vols = [nrrd_io.read(f)[0] for f in sorted((tmp_path / "decoded").glob("*.nrrd"))]
    assert n == len(vols) == N_SCANS
    # the ELU's floor is -1: HU -2000; a NaN would land far below
    assert all(v.shape == (RES, RES, DEPTH) and v.min() >= -2000 for v in vols)

    ssim = calc_ssim_from_checkpoint.main(calc_ssim_from_checkpoint.parse_arguments(
        [str(ckpt), str(scans), "--device", "cpu", *size]))
    assert sum(v["n"] for v in ssim.values()) == N_SCANS
    assert all(np.isfinite(v["ssim_mean"]) and -1 <= v["ssim_mean"] <= 1 for v in ssim.values())
