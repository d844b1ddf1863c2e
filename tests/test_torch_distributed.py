"""The port's data-parallel training over torch.distributed, on the CPU (gloo).

Two ranks, spawned as processes of their own, each train on their slice of
a global batch of 2 (one sample a rank); the parent holds them against one
process on the whole batch:

  * the stage-1 train step (stem 2, tiny widths, two steps from a first
    pass) against the JAX ``make_train_step`` on the global batch from the
    same converted variables, with ``tests/test_torch_train.py``'s
    ``_check_step`` (logs within rel 1e-5, every gradient, the parameters
    after AMSGrad, the EMA state within 1e-5); ``cluster_size`` equal, bit
    for bit, to the JAX step's and to the one-process port step's (integer
    counts summed over ranks); the ranks' parameters and EMA buffers equal
    bit for bit;
  * the PixelCNN prior step at dropout 0 against the JAX
    ``make_prior_train_step`` on the global batch
    (``tests/test_torch_prior_train.py``'s checks), two steps;
  * a conditioned Fixup PixelCNN, whose ``embed_condition`` no loss reaches,
    over two steps at two ranks against one process at the global batch:
    every gradient within 1e-5 of the tensor's max|ref| (sums in another
    order), the parameters within the AMSGrad bound, the unused parameter
    without a gradient (AMSGrad's zero) and its weights untouched on every
    rank;
  * ``train_vqvae`` and ``train_prior`` with ``--multihost --coordinator``
    in two processes (``SLURM_PROCID`` / ``SLURM_NTASKS``), where ``import
    jax`` fails, against a one-process run at the same global batch: the
    checkpoints (parameters, EMA buffers, optimizer moments) within the
    tolerances above, the same metrics file, and only rank 0 calling
    ``torch.save``;
  * ``CTDataModule`` and ``CodeDataModule``: each rank's slice equals the
    JAX modules' ``process_index`` slice, and the slices' union is the
    one-process batch (in-process, no spawn);
  * ``--mesh-shape``: ``N 1`` at world size N and ``d s`` at world size d
    x s are taken, also where s does not divide the coarsest code grid's H
    (those levels run whole); another world size, and a space axis that
    does not divide the H of the stem's output, raise (the spatial steps
    themselves are ``tests/test_torch_spatial.py``'s).

The spawned ranks import no jax (this module imports it only inside the
tests); every spawn and subprocess has a timeout, so a rendezvous that hangs
fails its test.
"""
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.cli import train_prior, train_vqvae
from vqvae3d_tpu_torch.data import nrrd_io
from vqvae3d_tpu_torch.data.code_store import CodeDataModule, CodeStoreWriter
from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.models.vqvae import VQVAE
from vqvae3d_tpu_torch.parallel import mesh
from vqvae3d_tpu_torch.parallel.multihost import initialize_multihost, shutdown
from vqvae3d_tpu_torch.train import prior_train, vqvae_train
from vqvae3d_tpu_torch.train.state import AMSGrad

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180  # seconds a spawn or a subprocess may take
LR = 1e-3
WORLD = 2
THREADS = 2  # a rank's CPU threads: the ranks share the test worker's cores


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _rank_main(rank, port, job, args, results):
    """A spawned rank: join the gloo group, run ``job``, send back its result
    (numpy only) or the traceback."""
    try:
        torch.set_num_threads(THREADS)
        os.environ.update(SLURM_PROCID=str(rank), SLURM_NTASKS=str(WORLD))
        initialize_multihost(f"127.0.0.1:{port}", device="cpu")
        out = job(rank, *args)
        results.put((rank, "jax" in sys.modules, out))
    except Exception:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))
    finally:
        shutdown()


def _run_ranks(job, *args):
    """``job(rank, *args)`` on WORLD spawned ranks; their results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, job, args, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(WORLD):
            rank, imported_jax, got = results.get(timeout=TIMEOUT)
            assert imported_jax is not None, f"rank {rank} failed:\n{got}"
            assert not imported_jax, f"rank {rank} imported jax"
            out[rank] = got
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [out[r] for r in range(WORLD)]


def _local(batch: dict, rank: int) -> dict:
    b = len(next(iter(batch.values()))) // WORLD
    return {k: torch.from_numpy(v[rank * b:(rank + 1) * b]) for k, v in batch.items()}


def _train(model, opt, step_fn, batch, steps):
    """Per step: the log, the gradient the optimizer took (averaged over
    ranks; read back from AMSGrad's first moment, g_n = (mu_n - b1 mu_n-1) /
    (1 - b1), as tests/test_torch_train.py reads the JAX step's), the
    parameters left without a gradient, and the state_dict after it."""
    out, mu_prev = [], torch.zeros_like(opt.mu, dtype=torch.float64)
    named = list(model.named_parameters())
    for _ in range(steps):
        log = step_fn(batch)
        mu = opt.mu.double()
        flat = ((mu - opt.b1 * mu_prev) / (1 - opt.b1)).float()
        mu_prev = mu
        grads = {n: g.view_as(p).numpy().copy()
                 for (n, p), g in zip(named, flat.split([p.numel() for _, p in named]))}
        out.append(dict(log={k: float(v) for k, v in log.items()}, grads=grads,
                        no_grad=[n for n, p in named if p.grad is None],
                        state=_numpy(model.state_dict())))
    return out


def _ranks_job(rank, stage1, prior, fixup):
    """The three train-step checks' work on one rank."""
    model = VQVAE(stage1.tcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in stage1.sd.items()})
    opt = AMSGrad(model.parameters(), lr=LR)
    s1 = _train(model, opt, vqvae_train.make_train_step(model, opt), _local(stage1.batch, rank), 2)
    out = {"stage1": s1}
    for name, case in (("prior", prior), ("fixup", fixup)):
        model = PixelCNN(case.tcfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in case.sd.items()})
        opt = AMSGrad(model.parameters(), lr=LR)
        out[name] = _train(model, opt, prior_train.make_prior_train_step(model, opt),
                           _local(case.batch, rank), 2)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs of the three train-step checks, and what two ranks made of them."""
    import test_torch_prior_train as tpt
    import test_torch_train as ttt

    blocks = dict(ttt.BLOCKS, n_post_upscale_blocks=0, n_post_downscale_blocks=0)
    jcfg, tcfg = ttt._configs(2, "zeros", blocks)
    rng = np.random.default_rng(70)
    from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE
    jmodel = JVQVAE(jcfg)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("VQVAE3D_BLOCK_REWRITE", "0")  # read by the JAX side when it traces
        variables = ttt._variables(jmodel, rng, initialized=False)
    from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
    stage1 = SimpleNamespace(tcfg=tcfg, sd=_numpy(jax_variables_to_state_dict(variables, tcfg)),
                             batch=ttt._batch(rng), jcfg=jcfg, jmodel=jmodel,
                             variables=variables)
    jpmodel, params, pmodel, ptcfg = tpt._models(True, seed=71)
    prior = SimpleNamespace(tcfg=ptcfg, sd=_numpy(pmodel.state_dict()),
                            batch=tpt._batch(np.random.default_rng(72), True), jmodel=jpmodel,
                            params=params)
    fcfg = PixelCNNConfig(**tpt._fields(True), use_pre_activation=False, dtype=torch.float32)
    fmodel = PixelCNN(fcfg, generator=torch.Generator().manual_seed(73))
    fixup = SimpleNamespace(tcfg=fcfg, sd=_numpy(fmodel.state_dict()),
                            batch=tpt._batch(np.random.default_rng(74), True))
    shipped = [SimpleNamespace(**{k: v for k, v in vars(c).items() if k in ("tcfg", "sd", "batch")})
               for c in (stage1, prior, fixup)]
    got = _run_ranks(_ranks_job, *shipped)
    return SimpleNamespace(stage1=stage1, prior=prior, fixup=fixup, got=got)


def _same_across_ranks(got, name):
    for n in range(2):
        a, b = got[0][name][n], got[1][name][n]
        assert a["log"] == b["log"]
        for k in a["state"]:
            np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


def _as_model(cls, tcfg, step):
    """A model holding one step's state_dict, with that step's gradients."""
    model = cls(tcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in step["state"].items()})
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(step["grads"][n])
    return model


def test_stage1_step_over_two_ranks_matches_jax(ranks, monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from test_torch_train import B1, _check_step
    from vqvae3d_tpu.train.state import VQVAETrainState, make_optimizer
    from vqvae3d_tpu.train.vqvae_train import make_train_step as jmake_train_step

    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    s = ranks.stage1
    _same_across_ranks(ranks.got, "stage1")
    jstate = VQVAETrainState.create(apply_fn=s.jmodel.apply, params=s.variables["params"],
                                    tx=make_optimizer(LR), quantizer=s.variables["quantizer"])
    unravel = ravel_pytree(jstate.params)[1]
    jstep = jmake_train_step(s.jmodel, donate=False)
    # the one-process port step on the global batch
    one = VQVAE(s.tcfg)
    one.load_state_dict({k: torch.from_numpy(v) for k, v in s.sd.items()})
    opt = AMSGrad(one.parameters(), lr=LR)
    one_step = vqvae_train.make_train_step(one, opt)
    mu_prev = np.zeros_like(np.asarray(jstate.opt_state[0].mu), np.float64)
    for n in (0, 1):
        jstate, jlog = jstep(jstate, s.batch)
        mu = np.asarray(jstate.opt_state[0].mu, np.float64)
        grads = unravel(jnp.asarray(((mu - B1 * mu_prev) / (1 - B1)).astype(np.float32)))
        mu_prev = mu
        one_step({k: torch.from_numpy(v) for k, v in s.batch.items()})
        step = ranks.got[0]["stage1"][n]
        _check_step(_as_model(VQVAE, s.tcfg, step), jstate, jax.device_get(grads), s.tcfg,
                    step["log"], jax.device_get(jlog))
        for lvl in range(s.tcfg.n_bottleneck_blocks):
            key = f"encoder.quantize.{lvl}.cluster_size"
            np.testing.assert_array_equal(step["state"][key], one.state_dict()[key].numpy())
            np.testing.assert_array_equal(
                step["state"][key],
                np.asarray(jstate.quantizer["encoder"][f"quantize_{lvl}"]["cluster_size"]))


def test_prior_step_over_two_ranks_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from test_torch_prior_train import B1, _check_grads, _check_logs
    from vqvae3d_tpu.train import prior_train as jpt
    from vqvae3d_tpu.train.state import make_optimizer
    from vqvae3d_tpu_torch.convert import jax_pixelcnn_params_to_state_dict

    p = ranks.prior
    _same_across_ranks(ranks.got, "prior")
    jstate = jpt.PriorTrainState.create(apply_fn=p.jmodel.apply, params=p.params,
                                        tx=make_optimizer(LR))
    unravel = ravel_pytree(jstate.params)[1]
    jstep = jpt.make_prior_train_step(p.jmodel, donate=False)
    mu_prev = np.zeros_like(np.asarray(jstate.opt_state[0].mu), np.float64)
    for n in (0, 1):
        jstate, jlog = jstep(jstate, p.batch, jax.random.PRNGKey(1))
        mu = np.asarray(jstate.opt_state[0].mu, np.float64)
        grads = unravel(jnp.asarray(((mu - B1 * mu_prev) / (1 - B1)).astype(np.float32)))
        mu_prev = mu
        step = ranks.got[0]["prior"][n]
        model = _as_model(PixelCNN, p.tcfg, step)
        _check_logs(step["log"], jax.device_get(jlog))
        ref, tols = _check_grads(model, grads, p.tcfg)
        params_ref = jax_pixelcnn_params_to_state_dict(jax.device_get(jstate.params), p.tcfg)
        _check_amsgrad(model, ref, params_ref, tols)


def _check_amsgrad(model, grads_ref, params_ref, tols):
    """Parameters after AMSGrad within its bound (tests/test_torch_train.py:
    a gradient within ``tol`` moves Adam's ratio of moments by at most ~2
    tol / |g|, taken 4x for the mix of two steps, capped at a sign flip)."""
    for name, prm in model.named_parameters():
        g = np.abs(np.asarray(grads_ref[name]))
        err = np.abs(prm.detach().numpy() - np.asarray(params_ref[name]))
        tol_p = LR * np.minimum(2.0, 4 * tols[name] / np.maximum(g, 1e-30))
        assert np.all(err <= tol_p + 1e-3 * LR), name


def test_fixup_prior_over_two_ranks_matches_one_process(ranks):
    """The unused ``embed_condition`` (no loss reaches it) gets a zero
    gradient on every rank; everything else matches the one process."""
    f = ranks.fixup
    _same_across_ranks(ranks.got, "fixup")
    model = PixelCNN(f.tcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in f.sd.items()})
    opt = AMSGrad(model.parameters(), lr=LR)
    step_fn = prior_train.make_prior_train_step(model, opt)
    ref = _train(model, opt, step_fn, {k: torch.from_numpy(v) for k, v in f.batch.items()}, 2)
    unused = [n for n in ref[0]["grads"] if n.startswith("embed_condition")]
    assert unused and set(unused) <= set(ref[0]["no_grad"])
    for n, (want, got) in enumerate(zip(ref, ranks.got[0]["fixup"])):
        np.testing.assert_allclose(got["log"]["loss_mean"], want["log"]["loss_mean"], rtol=1e-6)
        gmax = max(float(np.abs(g).max()) for g in want["grads"].values())
        tols = {k: max(1e-5 * float(np.abs(g).max()), 1e-6 * gmax)
                for k, g in want["grads"].items()}
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=tols[k], err_msg=k)
        for rank in range(WORLD):
            assert set(unused) <= set(ranks.got[rank]["fixup"][n]["no_grad"])
            for k in unused:
                assert not ranks.got[rank]["fixup"][n]["grads"][k].any(), k
                np.testing.assert_array_equal(ranks.got[rank]["fixup"][n]["state"][k], f.sd[k])
        _check_amsgrad(_as_model(PixelCNN, f.tcfg, got), want["grads"], want["state"], tols)


# the CLIs in two processes (where jax cannot be imported), rank 0 alone saving
CLI_RUNNER = """
import importlib, json, sys
for name in ("jax", "jaxlib", "flax", "orbax"):
    sys.modules[name] = None  # any import of them now raises
import torch
saved = []
torch_save = torch.save
def spy(obj, f, *args, **kw):
    saved.append(str(f))
    return torch_save(obj, f, *args, **kw)
torch.save = spy
cli = importlib.import_module("vqvae3d_tpu_torch.cli." + sys.argv[1])
cli.main(cli.parse_arguments(sys.argv[2:]))
print("SAVED " + json.dumps(saved))
"""


def _cli_over_two_ranks(module: str, argv: list) -> list:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_RUNNER, module, *argv, "--multihost", "--coordinator",
         f"127.0.0.1:{port}"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(REPO), "SLURM_PROCID": str(r),
                        "SLURM_NTASKS": str(WORLD), "OMP_NUM_THREADS": str(THREADS)})
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [json.loads(out.split("SAVED ")[-1]) for out in outs], outs


def _check_checkpoints(one: Path, two: Path, rel: float, lr: float):
    """The newest train state of two runs: the same step and files, the
    model's tensors and the optimizer's moments within ``rel`` of each
    tensor's max|ref|, the parameters also within 1e-3 lr (AMSGrad moves a
    parameter whose gradient lies near its eps by a step that rounding
    changes), the EMA counts exactly."""
    step = (one / "latest.txt").read_text()
    assert (two / "latest.txt").read_text() == step
    assert sorted(f.name for f in one.rglob("*")) == sorted(f.name for f in two.rglob("*"))
    model = [torch.load(d / f"step_{step}.pt", weights_only=True) for d in (one, two)]
    train = [torch.load(d / f"step_{step}_train.pt", weights_only=True) for d in (one, two)]
    assert train[0]["step"] == train[1]["step"]
    for (want, got), atol in (((model[0], model[1]), 1e-3 * lr),
                              ((train[0]["optimizer"], train[1]["optimizer"]), 0.0)):
        assert set(want) == set(got)
        for k, v in want.items():
            if not torch.is_tensor(v):
                assert v == got[k], k
            elif not v.is_floating_point() or k.endswith("cluster_size"):
                assert torch.equal(v, got[k]), k
            else:
                err = float((got[k] - v).abs().max())
                assert err <= rel * float(v.abs().max()) + atol, (k, err)


def test_train_vqvae_cli_over_two_ranks(tmp_path):
    rng = np.random.default_rng(80)
    ct = tmp_path / "ct"
    ct.mkdir()
    for i in range(21):  # 19 train scans, 2 validation scans: one global batch of 2
        vol = rng.integers(-1000, 1500, size=(32, 32, int(rng.integers(10, 17)))).astype(np.int16)
        nrrd_io.write(ct / f"scan{i}.nrrd", vol, header={"spacings": (0.976, 0.976, 3)})
    flags = [str(ct), "--batch-size", "2", "--num-embeddings", "8", "16",
             "--n-bottleneck-blocks", "2", "--n-pre-quantization-blocks", "1",
             "--n-post-quantization-blocks", "1", "--n-post-upscale-blocks", "1",
             "--n-post-downscale-blocks", "1", "--stem-space-to-depth", "2",
             "--base-network-channels", "8", "--scan-size", "32", "32", "--output-depth", "16",
             "--val-every-steps", "2", "--log-every-n-steps", "1", "--num-workers", "1",
             "--precision", "fp32", "--max-steps", "2", "--device", "cpu"]
    saved, outs = _cli_over_two_ranks("train_vqvae", flags + ["--ckpt-dir", str(tmp_path / "two"),
                                                              "--mesh-shape", "2", "1"])
    assert saved[0] and not saved[1] and "[step 2]" in outs[0] and "[step" not in outs[1]
    train_vqvae.main(train_vqvae.parse_arguments(flags + ["--ckpt-dir", str(tmp_path / "one")]))
    _check_checkpoints(tmp_path / "one", tmp_path / "two", rel=1e-4, lr=1e-5)
    logs = [[json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
            for d in ("one", "two")]
    assert [sorted(r) for r in logs[0]] == [sorted(r) for r in logs[1]]
    val = [[r for r in log if "val_recon_loss_median" in r] for log in logs]
    assert len(val[0]) == len(val[1]) == 1
    for k, v in val[0][0].items():
        if k.startswith("val_"):
            np.testing.assert_allclose(val[1][0][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_train_prior_cli_over_two_ranks(tmp_path):
    rng = np.random.default_rng(81)
    w = CodeStoreWriter(str(tmp_path / "codes"), 2, [5, 4], backend="file")
    for i in range(22):  # 20 train grids, 2 validation grids
        w.write_sample(i, [rng.integers(0, 5, (4, 4, 2)).astype(np.int32),
                           rng.integers(0, 4, (2, 2, 1)).astype(np.int32)])
    w.close()
    flags = [str(tmp_path / "codes"), "0", "--model-dim", "8", "--num-resblocks", "2",
             "--bottleneck-divisor", "2", "--dropout-prob", "0", "--batch-size", "2",
             "--val-every-steps", "2", "--log-every-n-steps", "1", "--lr", "1e-3",
             "--precision", "fp32", "--max-steps", "3", "--device", "cpu"]
    saved, outs = _cli_over_two_ranks("train_prior", flags + ["--ckpt-dir", str(tmp_path / "two")])
    assert saved[0] and not saved[1] and "[step 3]" in outs[0] and "[step" not in outs[1]
    train_prior.main(train_prior.parse_arguments(flags + ["--ckpt-dir", str(tmp_path / "one")]))
    _check_checkpoints(tmp_path / "one", tmp_path / "two", rel=1e-4, lr=1e-3)


def test_data_modules_slice_per_rank_as_jax(tmp_path):
    from vqvae3d_tpu.data.code_store import CodeDataModule as JCodeDataModule
    from vqvae3d_tpu.data.ct_dataset import CTDataModule as JCTDataModule

    rng = np.random.default_rng(82)
    ct = tmp_path / "ct"
    ct.mkdir()
    for i in range(9):
        vol = rng.integers(-1000, 1500, size=(16, 16, int(rng.integers(6, 9)))).astype(np.int16)
        nrrd_io.write(ct / f"scan{i}.nrrd", vol, header={"spacings": (0.976, 0.976, 3)})
    w = CodeStoreWriter(str(tmp_path / "codes"), 2, [5, 4], backend="file")
    for i in range(11):
        w.write_sample(i, [rng.integers(0, 5, (4, 4, 2)).astype(np.int32),
                           rng.integers(0, 4, (2, 2, 1)).astype(np.int32)])
    w.close()
    kw = dict(batch_size=4, num_workers=1, seed=3, size=(16, 16, None), output_depth=8,
              train_frac=0.5)
    modules = [(CTDataModule(str(ct), **kw), JCTDataModule(str(ct), **kw)),
               (CodeDataModule(str(tmp_path / "codes"), 0, batch_size=4, train_frac=0.5, seed=3),
                JCodeDataModule(str(tmp_path / "codes"), 0, batch_size=4, train_frac=0.5, seed=3))]
    for dm, jdm in modules:
        loaders = [lambda m, **p: m.train_dataloader(epoch=0, **p),
                   lambda m, **p: m.train_dataloader(epoch=1, **p),
                   lambda m, **p: m.val_dataloader(**p)]
        for loader in loaders:
            whole = list(loader(dm))
            parts = [list(loader(dm, process_index=r, process_count=WORLD)) for r in range(WORLD)]
            jparts = [list(loader(jdm, process_index=r, process_count=WORLD))
                      for r in range(WORLD)]
            assert len(whole) > 0 and all(len(p) == len(whole) for p in parts + jparts)
            for r in range(WORLD):
                for got, want in zip(parts[r], jparts[r]):
                    assert set(got) == set(want)
                    for k in got:
                        assert got[k].shape[0] == 2 and np.array_equal(got[k], want[k]), k
            for b, batch in enumerate(whole):
                for k, v in batch.items():
                    np.testing.assert_array_equal(
                        np.concatenate([parts[r][b][k] for r in range(WORLD)]), v)
        with pytest.raises(ValueError, match="divide"):
            next(iter(dm.train_dataloader(process_index=0, process_count=3)))


def test_mesh_shape_and_batch_checks():
    assert mesh.check_mesh_shape(None, 4) == 4
    assert mesh.check_mesh_shape([2], 2) == mesh.check_mesh_shape([2, 1], 2) == 2
    assert mesh.check_mesh_shape([2, 2], 4, stem_h=16) == 2
    # 32x32x16 volumes at stem 2: stem output H 16, code grids H 8 and 2; s = 4
    # runs the coarsest level whole, s = 32 and s = 3 split no stem output
    assert mesh.check_mesh_shape([1, 4], 4, stem_h=16) == 1
    for s in (32, 3):
        with pytest.raises(ValueError, match="H of the stem's output"):
            mesh.check_mesh_shape([1, s], s, stem_h=16)
    with pytest.raises(ValueError, match="world size"):
        mesh.check_mesh_shape([2, 2], 2, stem_h=16)
    with pytest.raises(ValueError, match="world size"):
        mesh.check_mesh_shape([2], 1)
    assert mesh.local_batch_size(6, 2) == 3
    with pytest.raises(ValueError, match="divide"):
        mesh.local_batch_size(3, 2)
    # without a process group: one rank, the collectives hand their input back
    assert not mesh.data_parallel()
    d = {"a": torch.tensor(1.5)}
    assert mesh.all_reduce_dict(d, "mean") is d
    x = torch.arange(3.0)
    assert mesh.all_gather_flat(x) is x
    with pytest.raises(ValueError, match="--coordinator needs --multihost"):
        train_prior.main(train_prior.parse_arguments(
            ["codes", "0", "--coordinator", "127.0.0.1:1", "--device", "cpu"]))
