"""The port's stage-1 serving CLIs on tiny synthetic CT scans, on the CPU.

  * ``extract_embeddings`` writes the same code store as the JAX CLI's
    ``main`` on the same weights (a random JAX variable tree, converted for
    the port): every code grid equal.
  * ``code_store_to_sample_db`` + ``decode_embeddings`` write one int32 NRRD
    per scan; the decoded volumes agree with the JAX ``decode_samples`` on
    the same DB within 2e-3 (tests/test_checkpoint.py's decoded tolerance).
  * ``sample_embeddings --device cpu`` samples level-0 grids from a tiny
    conditioned PixelCNN checkpoint, conditioned on the DB's level-1 grids;
    the JAX package's ``sample_db`` reads what it wrote. With ``--use-model
    pixelsnail`` it samples from a tiny PixelSNAIL checkpoint, conditioned
    and not, with both samplers; a ``--use-model`` that names another class
    than the checkpoint's raises ``ValueError``.
  * ``train_prior --device cpu`` trains a tiny conditioned PixelCNN for two
    steps on a synthetic code store, then ``--resume``s for a third; the
    checkpoint keeps the step and the optimizer state, ``load_prior`` and
    ``sample_embeddings`` read it, and the JAX ``_config_from_json`` reads
    its config.
  * ``train_prior`` with each PixelCNN option beside the default
    (``--use-pre-activation False``, ``--use-concat-activation True``,
    ``--kernel-size 5``) trains two steps and ``--resume``s for a third;
    ``sample_embeddings --sampler naive`` samples from the Fixup checkpoint,
    and the cached sampler refuses it.
  * A resumed ``train_prior`` run (2 + 1 + 1 steps) equals an uninterrupted
    one (4 steps) bit for bit, for the PixelCNN and the PixelSNAIL, with
    dropout and mixup on.
  * ``train_vqvae --block-type evonorm --device cpu`` trains two steps, then
    ``calc_ssim_from_checkpoint`` prints, per split, the SSIM that
    ``ssim3d_slices`` gives the checkpoint's own reconstructions, under the
    JAX CLI's JSON keys, and ``plot_from_checkpoint`` writes the volume and
    the ELU of its reconstruction as HU NRRDs.
  * A ``step_N_config.json`` written by the JAX package, with its TPU
    layout fields (``packed_stacks``, ``scan_stacks``, ``argmin_method``,
    ``remat*``), loads in the port.
  * In a subprocess where ``import jax`` fails, every module of the port
    imports and both CLIs run: the port never needs jax.
"""
import json
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.cli import decode_embeddings as jdecode
from vqvae3d_tpu.cli import extract_embeddings as jextract
from vqvae3d_tpu.data import nrrd_io
from vqvae3d_tpu.data.code_store import CodeStore
from vqvae3d_tpu.data.sample_db import add_samples as jadd_samples
from vqvae3d_tpu.data.sample_db import create_or_load_db
from vqvae3d_tpu.data.sample_db import save_db as jsave_db
from vqvae3d_tpu.models.pixelcnn import PixelCNNConfig as JPixelCNNConfig
from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE, VQVAEConfig as JConfig
from vqvae3d_tpu.train.checkpoint import _config_from_json, _config_to_json
import vqvae3d_tpu_torch
from vqvae3d_tpu_torch.checkpoint import load_model, load_prior, save_checkpoint, save_prior
from vqvae3d_tpu_torch.cli import (
    calc_ssim_from_checkpoint,
    decode_embeddings,
    extract_embeddings,
    plot_from_checkpoint,
    sample_embeddings,
    train_prior,
    train_vqvae,
)
from vqvae3d_tpu_torch.data.code_store import CodeStoreWriter
from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.data.transforms import hu_unnormalize
from vqvae3d_tpu_torch.metrics.evaluate import ssim3d_slices
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

REPO = Path(__file__).resolve().parent.parent
H = W = 32
DEPTH = 16
CFG = dict(n_bottleneck_blocks=2, num_embeddings=(8, 16), n_pre_quantization_blocks=1,
           n_post_quantization_blocks=1, n_post_upscale_blocks=1, n_post_downscale_blocks=1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    ct = work / "ct"
    ct.mkdir()
    for i in range(3):
        vol = rng.integers(-1000, 1500, size=(H, W, int(rng.integers(10, 17)))).astype(np.int16)
        nrrd_io.write(ct / f"scan{i}.nrrd", vol, header={"spacings": (0.976, 0.976, 3)})
    jcfg = JConfig(**CFG, dtype=jnp.float32, remat=False, argmin_method="ref")
    tcfg = VQVAEConfig(**CFG, dtype=torch.float32)
    jmodel = JVQVAE(jcfg)
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, H, W, DEPTH, 1)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"]
    )
    quantizer = {"encoder": {}}
    for name, q in shapes["quantizer"]["encoder"].items():
        embed = rng.standard_normal(q["embed"].shape).astype(np.float32)
        quantizer["encoder"][name] = dict(
            embed=embed, embed_avg=embed.copy(), initialized=np.ones((), bool),
            cluster_size=np.zeros(q["cluster_size"].shape, np.float32),
        )
    variables = {"params": params, "quantizer": quantizer}
    ckpt = work / "ckpt"
    save_checkpoint(ckpt, jax_variables_to_state_dict(variables, tcfg), tcfg)
    return SimpleNamespace(work=work, ct=ct, ckpt=ckpt, jcfg=jcfg, jmodel=jmodel,
                           variables=variables)


def _extract_args(s, name):
    return ["--checkpoint-path", str(s.ckpt), "--dataset-path", str(s.ct),
            "--output-path", str(s.work), "--output-name", name, "--rescale-input", "0",
            "--scan-size", str(H), str(W), "--backend", "file",
            "--output-depth", str(DEPTH)]


def test_extract_matches_the_jax_cli(setup, monkeypatch):
    s = setup
    extract_embeddings.main(extract_embeddings.parse_arguments(
        _extract_args(s, "codes_torch") + ["--device", "cpu"]))

    # the JAX CLI's main on the same weights (its loader swapped for them)
    monkeypatch.setenv("VQVAE3D_COMPILE_CACHE", "0")
    monkeypatch.setattr(jextract, "load_vqvae", lambda path, shape: (
        s.jmodel, SimpleNamespace(**s.variables), s.jcfg))
    jextract.main(jextract.parse_arguments(_extract_args(s, "codes_jax")))

    got, want = CodeStore(str(s.work / "codes_torch")), CodeStore(str(s.work / "codes_jax"))
    assert got.length == want.length == 3 and got.num_embeddings == [8, 16]
    for i in range(3):
        for lvl in range(2):
            assert got.get(i, lvl).shape == (H // 4 ** (lvl + 1), W // 4 ** (lvl + 1),
                                              DEPTH // 4 ** (lvl + 1))
            np.testing.assert_array_equal(got.get(i, lvl), want.get(i, lvl))


def test_decode_writes_volumes_matching_jax(setup, monkeypatch):
    s = setup
    if not (s.work / "codes_torch").exists():
        extract_embeddings.main(extract_embeddings.parse_arguments(
            _extract_args(s, "codes_torch") + ["--device", "cpu"]))
    db_path = s.work / "samples.db"
    assert decode_embeddings.code_store_to_sample_db(s.work / "codes_torch", db_path) == 3
    out = s.work / "decoded" / "synth"
    n = decode_embeddings.main(decode_embeddings.parse_arguments(
        [str(db_path), str(s.ckpt), str(out), "--device", "cpu"]))
    files = sorted(out.parent.glob("*.nrrd"))
    assert n == 3 and len(files) == 3
    vol, header = nrrd_io.read(files[0])
    assert vol.shape == (H, W, DEPTH) and vol.dtype == np.int32
    np.testing.assert_allclose(header["spacings"], [0.976, 0.976, 3])

    db = create_or_load_db(db_path, level=0)
    model, _ = load_model(s.ckpt, device="cpu")
    with torch.inference_mode():
        got = dict(decode_embeddings.decode_samples(model, db, torch.device("cpu")))
    # unfolded JAX decode with its block-space rewrites off: the same math as
    # its folded serving path, compiled in seconds instead of a minute
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    want = dict(jdecode.decode_samples(s.jmodel, s.variables, db, folded=False))
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], atol=2e-3, rtol=0)


@pytest.mark.parametrize("sampler", ["cached", "naive"])
def test_sample_embeddings_cli_on_cpu(tmp_path, sampler):
    prior = PixelCNN(PixelCNNConfig(input_dim=5, condition_dim=4, model_dim=8, num_resblocks=2,
                                    dropout_prob=0.0, bottleneck_divisor=2,
                                    dtype=torch.float32),
                     generator=torch.Generator().manual_seed(3))
    save_prior(tmp_path / "prior", prior)
    db_path = tmp_path / "samples.db"
    db = create_or_load_db(db_path, 1)  # the JAX package writes the coarser level
    coarse = np.random.default_rng(4).integers(0, 4, (2, 2, 2, 1)).astype(np.int32)
    level1 = jadd_samples(db, 1, coarse, None)
    jsave_db(db, db_path, 1)
    argv = ["--model-checkpoint", str(tmp_path / "prior"), "--db-path", str(db_path),
            "--level", "0", "--size", "3", "4", "3", "--num-samples", "3", "--batch-size", "1",
            "--tau", "0.5", "--sampler", sampler, "--device", "cpu"]
    new = sample_embeddings.main(sample_embeddings.parse_arguments(argv))
    db = create_or_load_db(db_path, 0)
    assert len(new) == 3 and set(db[0]) == set(new) and set(db[1]) == set(level1)
    for u in new:
        grid = np.asarray(db[0][u]["data"])
        assert grid.shape == (3, 4, 3) and grid.dtype == np.int32
        assert 0 <= grid.min() and grid.max() < 5 and db[0][u]["condition"] in level1
    with pytest.raises(ValueError, match="holds a PixelCNN"):  # the checkpoint's class
        sample_embeddings.main(sample_embeddings.parse_arguments(argv + ["--use-model",
                                                                        "pixelsnail"]))


@pytest.mark.parametrize("sampler", ["cached", "naive"])
@pytest.mark.parametrize("with_cond", [False, True])
def test_sample_embeddings_cli_pixelsnail_on_cpu(tmp_path, sampler, with_cond):
    prior = PixelSNAIL(PixelSNAILConfig(input_dim=5, condition_dim=4 if with_cond else 0,
                                        model_dim=8, num_blocks=2, num_layers_per_block=1,
                                        causal_dropout_prob=0.0, attention_dropout_prob=0.0,
                                        bottleneck_divisor=2, num_heads=2,
                                        dtype=torch.float32),
                       generator=torch.Generator().manual_seed(6))
    save_prior(tmp_path / "snail", prior)
    db_path = tmp_path / "samples.db"
    level1 = None
    if with_cond:  # the JAX package writes the coarser level
        db = create_or_load_db(db_path, 1)
        coarse = np.random.default_rng(7).integers(0, 4, (2, 2, 1, 2)).astype(np.int32)
        level1 = jadd_samples(db, 1, coarse, None)
        jsave_db(db, db_path, 1)
    argv = ["--model-checkpoint", str(tmp_path / "snail"), "--db-path", str(db_path),
            "--level", "0", "--size", "3", "2", "3", "--num-samples", "4", "--batch-size", "2",
            "--tau", "0.5", "--sampler", sampler, "--device", "cpu"]
    with pytest.raises(ValueError, match="holds a PixelSNAIL"):  # --use-model pixelcnn
        sample_embeddings.main(sample_embeddings.parse_arguments(argv))
    new = sample_embeddings.main(sample_embeddings.parse_arguments(
        argv + ["--use-model", "pixelsnail"]))
    db = create_or_load_db(db_path, 0)
    assert len(new) == 4 and set(db[0]) == set(new)
    for u in new:
        grid = np.asarray(db[0][u]["data"])
        assert grid.shape == (3, 2, 3) and grid.dtype == np.int32
        assert 0 <= grid.min() and grid.max() < 5
        assert (db[0][u]["condition"] in level1) if with_cond else db[0][u]["condition"] is None


def test_train_prior_cli_on_cpu(tmp_path):
    rng = np.random.default_rng(5)
    w = CodeStoreWriter(str(tmp_path / "codes"), 2, [5, 4], backend="file")
    for i in range(4):  # 3 train grids, 1 validation grid
        w.write_sample(i, [rng.integers(0, 5, (4, 4, 4)).astype(np.int32),
                           rng.integers(0, 4, (2, 2, 1)).astype(np.int32)])
    w.close()
    ck = tmp_path / "prior"
    flags = [str(tmp_path / "codes"), "0", "--use-model", "pixelcnn", "--model-dim", "8",
             "--num-resblocks", "2", "--bottleneck-divisor", "2", "--dropout-prob", "0.1",
             "--batch-size", "1", "--val-every-steps", "2", "--log-every-n-steps", "1",
             "--lr", "1e-3", "--ckpt-dir", str(ck), "--device", "cpu"]
    model, opt, step = train_prior.main(train_prior.parse_arguments(flags + ["--max-steps", "2"]))
    assert step == 2 and opt.count == 2 and model.config.dtype == torch.bfloat16
    assert (ck / "latest.txt").read_text() == "2" and (ck / "best" / "step_2_train.pt").exists()
    model, opt, step = train_prior.main(train_prior.parse_arguments(
        flags + ["--max-steps", "3", "--resume"]))
    assert step == 3 and opt.count == 3
    assert sorted(f.name for f in ck.glob("step_*")) == [
        "step_3.pt", "step_3_config.json", "step_3_train.pt"]
    logs = [json.loads(line) for line in (ck / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_mean"] for r in logs if "train_loss_mean" in r]
    val = [r for r in logs if "val_accuracy" in r]
    assert len(losses) == 3 and np.all(np.isfinite(losses)) and len(val) == 2
    assert {"val_loss_mean", "val_bits_per_dim", "val_loss_std"} <= set(val[0])
    loaded, cfg = load_prior(ck, device="cpu")
    assert cfg == model.config
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v.cpu())
    jcfg = _config_from_json(JPixelCNNConfig, (ck / "step_3_config.json").read_text())
    assert (jcfg.input_dim, jcfg.condition_dim, jcfg.model_dim) == (5, 4, 8)
    assert jcfg.dtype == jnp.bfloat16
    # the trained prior serves sample_embeddings
    db_path = tmp_path / "samples.db"
    db = create_or_load_db(db_path, 1)
    level1 = jadd_samples(db, 1, rng.integers(0, 4, (2, 2, 2, 1)).astype(np.int32), None)
    jsave_db(db, db_path, 1)
    new = sample_embeddings.main(sample_embeddings.parse_arguments([
        "--model-checkpoint", str(ck), "--db-path", str(db_path), "--level", "0",
        "--size", "4", "4", "4", "--num-samples", "2", "--batch-size", "1", "--device", "cpu"]))
    db = create_or_load_db(db_path, 0)
    assert len(new) == 2 and all(db[0][u]["condition"] in level1 for u in new)


@pytest.mark.parametrize("option", [["--use-pre-activation", "False"],
                                    ["--use-concat-activation", "True"],
                                    ["--kernel-size", "5"]])
def test_train_prior_options_on_cpu(tmp_path, option):
    rng = np.random.default_rng(7)
    w = CodeStoreWriter(str(tmp_path / "codes"), 2, [5, 4], backend="file")
    for i in range(3):  # 2 train grids, 1 validation grid
        w.write_sample(i, [rng.integers(0, 5, (4, 4, 2)).astype(np.int32),
                           rng.integers(0, 4, (2, 2, 1)).astype(np.int32)])
    w.close()
    ck = tmp_path / "prior"
    flags = [str(tmp_path / "codes"), "0", "--model-dim", "8", "--num-resblocks", "2",
             "--bottleneck-divisor", "2", "--dropout-prob", "0.3", "--batch-size", "1",
             "--val-every-steps", "2", "--ckpt-dir", str(ck), "--device", "cpu", *option]
    model, opt, step = train_prior.main(train_prior.parse_arguments(flags + ["--max-steps", "2"]))
    assert step == 2 and not model.uses_union_stack
    model, opt, step = train_prior.main(train_prior.parse_arguments(
        flags + ["--max-steps", "3", "--resume"]))
    assert step == opt.count == 3
    logs = [json.loads(line) for line in (ck / "metrics.jsonl").read_text().splitlines()]
    losses = [r["val_loss_mean"] for r in logs if "val_loss_mean" in r]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    loaded, cfg = load_prior(ck, device="cpu")
    assert cfg == model.config and (cfg.use_pre_activation, cfg.use_concat_activation,
                                    cfg.kernel_size) == {
        "--use-pre-activation": (False, False, 3), "--use-concat-activation": (True, True, 3),
        "--kernel-size": (True, False, 5)}[option[0]]
    if option[0] != "--use-pre-activation":
        return
    db_path = tmp_path / "samples.db"
    db = create_or_load_db(db_path, 1)
    level1 = jadd_samples(db, 1, rng.integers(0, 4, (2, 2, 2, 1)).astype(np.int32), None)
    jsave_db(db, db_path, 1)
    argv = ["--model-checkpoint", str(ck), "--db-path", str(db_path), "--level", "0",
            "--size", "3", "3", "2", "--num-samples", "2", "--batch-size", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match="--sampler naive"):
        sample_embeddings.main(sample_embeddings.parse_arguments(argv))
    new = sample_embeddings.main(sample_embeddings.parse_arguments(argv + ["--sampler", "naive"]))
    db = create_or_load_db(db_path, 0)
    assert len(new) == 2 and all(db[0][u]["condition"] in level1 for u in new)
    assert all(np.asarray(db[0][u]["data"]).shape == (3, 3, 2) for u in new)


@pytest.mark.parametrize("use_model", ["pixelcnn", "pixelsnail"])
def test_train_prior_resume_replays_the_run(tmp_path, use_model):
    """A 2+1+1-step run equals a 4-step run bit for bit, with channel
    dropout, mixup and (PixelSNAIL) attention dropout on: each step draws
    from (seed, step), and a resumed run takes the batch the uninterrupted
    one would (batch 2 over 7 train grids, 3 batches an epoch: the first
    resume starts at the third batch of epoch 0, the second at epoch 1)."""
    rng = np.random.default_rng(6)
    w = CodeStoreWriter(str(tmp_path / "codes"), 2, [5, 4], backend="file")
    for i in range(8):
        w.write_sample(i, [rng.integers(0, 5, (4, 4, 2)).astype(np.int32),
                           rng.integers(0, 4, (2, 2, 1)).astype(np.int32)])
    w.close()
    model_flags = {
        "pixelcnn": ["--num-resblocks", "2", "--dropout-prob", "0.3"],
        "pixelsnail": ["--num-blocks", "1", "--num-layers-per-block", "1", "--num-heads", "2",
                       "--causal-dropout-prob", "0.3", "--attention-dropout-prob", "0.2"],
    }[use_model]
    flags = [str(tmp_path / "codes"), "0", "--use-model", use_model, "--model-dim", "8",
             "--bottleneck-divisor", "2", "--mixup-alpha", "0.4", "--batch-size", "2",
             "--val-every-steps", "2", "--lr", "1e-3", "--precision", "fp32", "--device", "cpu",
             *model_flags]
    whole, opt_w, _ = train_prior.main(train_prior.parse_arguments(
        flags + ["--max-steps", "4", "--ckpt-dir", str(tmp_path / "whole")]))
    for n in (2, 3, 4):
        parts, opt_p, step = train_prior.main(train_prior.parse_arguments(
            flags + ["--max-steps", str(n), "--ckpt-dir", str(tmp_path / "parts")]
            + (["--resume"] if n > 2 else [])))
    assert step == 4 and opt_p.count == opt_w.count == 4
    assert type(whole).__name__ == {"pixelcnn": "PixelCNN", "pixelsnail": "PixelSNAIL"}[use_model]
    for k, v in whole.state_dict().items():
        assert torch.equal(parts.state_dict()[k], v), k
    for k in ("mu", "nu", "nu_max"):
        assert torch.equal(opt_p.state_dict()[k], opt_w.state_dict()[k]), k
    # and the draws are not a constant: another seed trains another model
    other, _, _ = train_prior.main(train_prior.parse_arguments(
        flags + ["--max-steps", "4", "--ckpt-dir", str(tmp_path / "other"), "--seed", "7"]))
    assert any(not torch.equal(other.state_dict()[k], v) for k, v in whole.state_dict().items())


def test_evonorm_train_then_ssim_and_plot_clis_on_cpu(setup, tmp_path, capsys):
    s = setup
    ckpt = tmp_path / "evonorm"
    size = ["--scan-size", str(H), str(W), "--output-depth", str(DEPTH)]
    train_vqvae.main(train_vqvae.parse_arguments(
        [str(s.ct), "--ckpt-dir", str(ckpt), "--block-type", "evonorm", "--batch-size", "1",
         "--n-bottleneck-blocks", "2", "--num-embeddings", "8", "16",
         "--n-pre-quantization-blocks", "1", "--n-post-quantization-blocks", "1",
         "--max-steps", "2", "--val-every-steps", "2", "--num-workers", "1",
         "--precision", "fp32", "--device", "cpu", *size]))
    model, cfg = load_model(ckpt, device="cpu")
    assert cfg.block_type == "evonorm"

    capsys.readouterr()
    out = calc_ssim_from_checkpoint.main(calc_ssim_from_checkpoint.parse_arguments(
        [str(ckpt), str(s.ct), "--device", "cpu", *size]))
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    dm = CTDataModule(str(s.ct), size=(H, W, None), output_depth=DEPTH)
    with torch.inference_mode():
        for split, loader in (("train", dm.train_dataloader()), ("val", dm.val_dataloader())):
            vals = []
            for b in loader:
                x = torch.from_numpy(b["volume"]).movedim(-1, 1)
                recon = torch.nn.functional.elu(model(x)[0])
                vals.append(float(ssim3d_slices(recon, x, data_range=4.24)))
            assert set(out[split]) == {"ssim_mean", "ssim_std", "n"}
            assert out[split]["n"] == len(vals) > 0
            np.testing.assert_allclose(out[split]["ssim_mean"], np.mean(vals), rtol=1e-6)
            np.testing.assert_allclose(out[split]["ssim_std"], np.std(vals), rtol=1e-5,
                                       atol=1e-7)
            assert any(line.startswith(f"{split}: SSIM ") for line in printed)

    prefix = tmp_path / "plot" / "vol"
    prefix.parent.mkdir()
    written = plot_from_checkpoint.main(plot_from_checkpoint.parse_arguments(
        [str(ckpt), str(s.ct), str(prefix), "--sample-index", "1", "--device", "cpu", *size]))
    assert written == [f"{prefix}_orig.nrrd", f"{prefix}_recon.nrrd"]
    vol, _ = CTDataModule(str(s.ct), train_frac=1.0, size=(H, W, None),
                          output_depth=DEPTH).dataset[1]
    orig, header = nrrd_io.read(written[0])
    recon, _ = nrrd_io.read(written[1])
    np.testing.assert_array_equal(orig, hu_unnormalize(vol[..., 0]))
    np.testing.assert_allclose(header["spacings"], (0.976, 0.976, 3))
    with torch.inference_mode():
        want = torch.nn.functional.elu(model(torch.from_numpy(vol)[None].movedim(-1, 1))[0])
    np.testing.assert_array_equal(recon, hu_unnormalize(want[0, 0].numpy()))


def test_jax_written_config_with_layout_fields_loads(setup, tmp_path):
    """A JAX step_N_config.json carries the TPU layout fields the port's
    config does not have; the port drops them on load."""
    s = setup
    jcfg = JConfig(**CFG, dtype=jnp.float32, remat=False, remat_blocks=True,
                   remat_policy="nothing", argmin_method="ref", packed_stacks="off",
                   scan_stacks=False)
    ckpt = tmp_path / "jax_config"
    save_checkpoint(ckpt, torch.load(s.ckpt / "step_0.pt", weights_only=True),
                    VQVAEConfig(**CFG, dtype=torch.float32))
    text = _config_to_json(jcfg)
    assert all(k in json.loads(text) for k in ("packed_stacks", "scan_stacks", "argmin_method",
                                               "remat", "remat_blocks", "remat_policy"))
    (ckpt / "step_0_config.json").write_text(text)
    model, cfg = load_model(ckpt, device="cpu")
    assert cfg == VQVAEConfig(**CFG, dtype=torch.float32)


def test_port_runs_with_jax_blocked(setup):
    s = setup
    modules = [m.name for m in pkgutil.walk_packages(vqvae3d_tpu_torch.__path__,
                                                     "vqvae3d_tpu_torch.")]
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "orbax"):
            sys.modules[name] = None  # any import of them now raises
        for name in {modules!r}:
            importlib.import_module(name)
        from vqvae3d_tpu_torch.cli import decode_embeddings as D, extract_embeddings as E
        E.main(E.parse_arguments({_extract_args(s, "codes_nojax") + ["--device", "cpu"]!r}))
        D.code_store_to_sample_db({str(s.work / "codes_nojax")!r}, {str(s.work / "nojax.db")!r})
        assert D.main(D.parse_arguments([{str(s.work / "nojax.db")!r}, {str(s.ckpt)!r},
                                         {str(s.work / "nojax" / "v")!r}, "--device", "cpu"])) == 3
        print("NOJAX_OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0 and "NOJAX_OK" in proc.stdout, proc.stderr[-3000:]
