"""The port's spatial sharding (``--mesh-shape d s``), on the CPU (gloo).

Ranks spawned as processes of their own (importing no jax) hold H slabs of
a stage-1 batch (stem 2, tiny widths, 32x32x16 volumes, global batch 2) and
are held against the JAX steps on one device from the same converted
variables, with ``tests/test_torch_train.py``'s ``_check_step`` (logs
within rel 1e-5, every gradient, the parameters after AMSGrad, the EMA
state within 1e-5) and ``cluster_size`` equal, bit for bit:

  * ``--mesh-shape 1 2`` (one spawn of two ranks), both pad modes: two
    train steps from a first pass against JAX ``make_train_step``, the two
    ranks' parameters and EMA buffers equal bit for bit; and the eval step
    (SSIM over the gathered slices and the medians included) against the
    one-process port eval step within rel 1e-5, whose forward (decoded
    volume within 1e-5 of max|ref|, code indices equal, commitment losses)
    is held against the JAX forward. The eval log is not held against JAX
    ``make_eval_step``'s: at this input its fp32 sums are 2.9e-6 (mean)
    and 1.9e-5 (std of the per-voxel loss) off a float64 reduction of the
    same per-voxel losses, which the port's fp32 values meet within 1e-7
    (the JAX decoded volume is within 1.7e-8 of the port's);
  * ``--mesh-shape 2 2`` (one spawn of four ranks): one train step against
    the JAX step on the global batch, where a sum over 'space' taken for a
    mean over 'data' (or the reverse) would show;
  * ``--mesh-shape 1 4`` (the same four processes, the mesh laid out
    again): the eval step and one train step, held as ``1 2`` is. Its code
    grids have H 8 and 2 (the JAX package's
    ``test_train_step_data_space_mesh`` grids), so level 0 runs on slabs of
    2 rows and level 1 whole on every rank (``models/vqvae.py``), where a
    whole level's statistics or gradient counted once a rank would show;
  * in the four ranks, at both layouts: ``mesh.gather_slabs`` (forward
    against the slabs end to end, backward against the slab of the sum of
    the ranks' cotangents) and a whole level's statistics (the first pass's
    N, mean and std, float64; K1b's counts bit for bit and dw) against
    those of every batch slice's rows in one process;
  * in the ranks: the halo exchange (``parallel/halo.py``) at each edge
    rule, ``trilinear_upsample2x``, ``conv3d``, the K3 stack's plain path
    and EvoNorm's ``group_std`` on slabs, forward and backward, against the
    whole volume.
"""
import multiprocessing as mp
import os
import socket
import sys
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.models.vqvae import VQVAE
from vqvae3d_tpu_torch.parallel import halo, mesh
from vqvae3d_tpu_torch.parallel.multihost import initialize_multihost, shutdown
from vqvae3d_tpu_torch.train import vqvae_train
from vqvae3d_tpu_torch.train.state import AMSGrad

TIMEOUT = 180  # seconds a spawn may take
LR = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, space, port, job, args, results):
    """A spawned rank: join the gloo group laid out as (world / space) x
    space, run ``job``, send back its result (numpy only) or the
    traceback."""
    try:
        torch.set_num_threads(1)
        os.environ.update(SLURM_PROCID=str(rank), SLURM_NTASKS=str(world))
        initialize_multihost(f"127.0.0.1:{port}", device="cpu")
        mesh.init_mesh(space)
        out = job(rank, *args)
        results.put((rank, "jax" in sys.modules, out))
    except Exception:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))
    finally:
        mesh.reset_mesh()
        shutdown()


def _run_ranks(world, space, job, *args):
    """``job(rank, *args)`` on ``world`` spawned ranks laid out as (world /
    space) x space; their results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, space, port, job, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):
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
    return [out[r] for r in range(world)]


def _slab(batch: dict) -> dict:
    """The rank's batch slice and H slab of a global batch (numpy)."""
    d, s = mesh.data_size(), mesh.space_size()
    b = len(batch["volume"]) // d
    lo = mesh.data_index() * b
    vol = batch["volume"][lo:lo + b]
    h = vol.shape[1] // s
    vol = vol[:, mesh.space_index() * h:(mesh.space_index() + 1) * h]
    return {"volume": torch.from_numpy(np.ascontiguousarray(vol)),
            "num_valid_slices": torch.from_numpy(batch["num_valid_slices"][lo:lo + b])}


def _model(case):
    model = VQVAE(case.tcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case.sd.items()})
    return model


def _steps(case, n):
    """The eval step, then ``n`` train steps from the same state: per step
    the log, the gradient AMSGrad took (summed over 'space', averaged over
    'data'; g_n = (mu_n - b1 mu_n-1) / (1 - b1)) and the state_dict."""
    from test_torch_distributed import _train

    model = _model(case)
    batch = _slab(case.batch)
    ev = {k: float(v) for k, v in vqvae_train.make_eval_step(model)(batch).items()}
    opt = AMSGrad(model.parameters(), lr=LR)
    return {"eval": ev, "train": _train(model, opt, vqvae_train.make_train_step(model, opt),
                                        batch, n)}


def _slab_ops(rank):
    """The halo ops on slabs against the whole volume, forward and backward,
    float64 (the upsample computes in fp32): per op the max |error| of the
    slab's output against the whole volume's rows, and of the space group's
    input gradients against the whole volume's, each rank giving its own
    output rows a cotangent."""
    from vqvae3d_tpu_torch.models.blocks import group_std
    from vqvae3d_tpu_torch.ops.conv3d import conv3d
    from vqvae3d_tpu_torch.ops.resize import trilinear_upsample2x
    from vqvae3d_tpu_torch.ops.stack_kernel import preact_stack_fused

    s, i = mesh.space_size(), mesh.space_index()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 3, 8, 4, 6, generator=gen, dtype=torch.float64)
    h = x.shape[2] // s
    nb, cb = 2, 2
    stack_w = [torch.randn(nb, cb, 3, 1, 1, 1, generator=gen, dtype=torch.float64) * 0.5,
               torch.randn(nb, cb, cb, 3, 3, 3, generator=gen, dtype=torch.float64) * 0.3,
               torch.randn(nb, 3, cb, 1, 1, 1, generator=gen, dtype=torch.float64) * 0.5,
               torch.randn(nb, 8, generator=gen, dtype=torch.float64) * 0.2]
    conv_w = torch.randn(3, 3, 3, 3, 3, generator=gen, dtype=torch.float64)
    # (the op on a slab, the whole volume's output, its rows a slab's output holds)
    ops = {
        "halo wrap": (lambda t: halo.exchange(t, 2, "wrap"),
                      lambda t: torch.cat([t[:, :, -2:], t, t[:, :, :2]], 2), (i * h, h + 4)),
        "halo zeros": (lambda t: halo.exchange(t, 2, "zeros"),
                       lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 2, 2)), (i * h, h + 4)),
        "halo clamp": (lambda t: halo.exchange(t, 1, "clamp"),
                       lambda t: torch.cat([t[:, :, :1], t, t[:, :, -1:]], 2), (i * h, h + 2)),
        "upsample": (trilinear_upsample2x, trilinear_upsample2x, (2 * i * h, 2 * h)),
        # EvoNorm's statistics over the whole volume: sums over the space group
        "group_std": (lambda t: group_std(t, 1), lambda t: group_std(t, 1), (i * h, h)),
    }
    for mode in ("wrap", "zeros"):
        conv = lambda t, m=mode: conv3d(t, conv_w, padding=1, pad_mode=m)  # noqa: E731
        stack = lambda t, m=mode: preact_stack_fused(t, *stack_w, m)  # noqa: E731
        ops[f"conv {mode}"] = (conv, conv, (i * h, h))
        ops[f"stack {mode}"] = (stack, stack, (i * h, h))
    errs = {}
    for name, (on_slab, whole, (start, rows)) in ops.items():
        xs = x[:, :, i * h:(i + 1) * h].clone().requires_grad_()
        y = on_slab(xs)
        xw = x.clone().requires_grad_()
        with halo.suspended():
            ref = whole(xw).narrow(2, start, rows)
        g = torch.randn(ref.shape, generator=torch.Generator().manual_seed(6 + rank),
                        dtype=ref.dtype)
        y.backward(g)
        ref.backward(g)
        # the slabs' gradients end to end; the whole volume's summed over the ranks' cotangents
        parts = [torch.empty_like(xs.grad) for _ in range(s)]
        torch.distributed.all_gather(parts, xs.grad, group=mesh.space_group())
        total = xw.grad.clone()
        torch.distributed.all_reduce(total, group=mesh.space_group())
        errs[name] = (float((y.detach() - ref.detach()).abs().max()),
                      float((torch.cat(parts, 2) - total).abs().max()))
    return errs


def _whole_ops():
    """The collectives of the levels that run whole, float64 where the code
    allows: per check the max |error| against the whole volume. Every rank
    of a space group holds its batch slice's copy of a whole level."""
    from vqvae3d_tpu_torch.models import quantizer

    s, i, d, j = mesh.space_size(), mesh.space_index(), mesh.data_size(), mesh.data_index()

    def draw(seed, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                           dtype=torch.float64)

    # the space group's slabs, and the cotangent each rank gives the whole tensor
    slabs = [draw(100 * j + r, (2, 3, 2, 4, 3)) for r in range(s)]
    cots = [draw(200 * j + r, (2, 3, 2 * s, 4, 3)) for r in range(s)]
    x = slabs[i].clone().requires_grad_()
    y = mesh.gather_slabs(x)
    y.backward(cots[i])
    errs = {"gather": float((y.detach() - torch.cat(slabs, 2)).abs().max()),
            "gather backward": float((x.grad - sum(cots).narrow(2, 2 * i, 2)).abs().max())}

    # a whole level (B, D, H, W, Z) a batch slice, and every slice's rows
    levels = [draw(300 + k, (1, 4, 3, 2, 2)) * 2 + k for k in range(d)]
    rows = torch.cat([v.movedim(1, -1).reshape(-1, 4) for v in levels])
    with halo.whole():
        n, mean, std = quantizer.row_stats(levels[j].movedim(1, -1).reshape(-1, 4))
    errs.update({"N": abs(n - rows.shape[0]),
                 "mean": float((mean - rows.mean(0)).abs().max()),
                 "std": float((std - rows.std(0, correction=0)).abs().max())})
    # K1b's counts and dw through the first pass and the EMA update: the
    # counts summed over 'data' once each, against one quantize_train of all rows
    embed = draw(400, (5, 4)).float()
    state = quantizer.QuantizerState(embed, embed.clone(), torch.zeros(5), torch.tensor(True))
    with halo.whole():
        new = quantizer.quantize_train(levels[j], state)[-1]
    kept = mesh.data_parallel
    mesh.data_parallel = lambda: False  # one process over every slice's rows
    try:
        want = quantizer.quantize_train(torch.cat(levels), state)[-1]
    finally:
        mesh.data_parallel = kept
    errs["cluster_size"] = float((new.cluster_size - want.cluster_size).abs().max())
    errs["embed_avg"] = float((new.embed_avg - want.embed_avg).abs().max())
    return errs


def _job_12(rank, cases):
    return {"ops": _slab_ops(rank), **{name: _steps(c, 2) for name, c in cases.items()}}


def _job_22(rank, case):
    """At ``--mesh-shape 2 2``, then, in the same processes, ``1 4``."""
    out = {"2x2": _steps(case, 1), "ops 2x2": _whole_ops()}
    mesh.reset_mesh()
    mesh.init_mesh(4)
    return {**out, "1x4": _steps(case, 1), "ops 1x4": _whole_ops()}


@pytest.fixture(scope="module")
def spatial():
    """Inputs of the checks, the JAX steps on one device, and what the
    sharded ranks made of them."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    import test_torch_train as ttt
    from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE
    from vqvae3d_tpu.train.state import VQVAETrainState, make_optimizer
    from vqvae3d_tpu.train.vqvae_train import make_train_step
    from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict

    cases, ref = {}, {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("VQVAE3D_BLOCK_REWRITE", "0")  # read by the JAX side when it traces
        for pad_mode in ("wrap", "zeros"):
            # K3 runs the pre- and post-quantization stacks (the stacks inside the
            # Down/UpBlocks are the same code and lengthen the JAX compile)
            jcfg, tcfg = ttt._configs(2, pad_mode, dict(
                ttt.BLOCKS, n_post_upscale_blocks=0, n_post_downscale_blocks=0))
            rng = np.random.default_rng(90 + len(pad_mode))
            jmodel = JVQVAE(jcfg)
            variables = ttt._variables(jmodel, rng, initialized=False)
            batch = ttt._batch(rng)
            sd = {k: v.numpy() for k, v in jax_variables_to_state_dict(variables, tcfg).items()}
            cases[pad_mode] = SimpleNamespace(tcfg=tcfg, sd=sd, batch=batch)
            jstate = VQVAETrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                            tx=make_optimizer(LR),
                                            quantizer=variables["quantizer"])
            forward = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
            steps = [jax.device_get(forward(variables, jnp.asarray(batch["volume"])))]
            unravel = ravel_pytree(jstate.params)[1]
            jstep = make_train_step(jmodel, donate=False)
            mu_prev = np.zeros_like(np.asarray(jstate.opt_state[0].mu), np.float64)
            for _ in range(2):
                jstate, jlog = jstep(jstate, batch)
                mu = np.asarray(jstate.opt_state[0].mu, np.float64)
                grads = unravel(jnp.asarray(((mu - ttt.B1 * mu_prev) / (1 - ttt.B1))
                                            .astype(np.float32)))
                mu_prev = mu
                steps.append((jax.device_get(jstate), jax.device_get(grads),
                              jax.device_get(jlog)))
            ref[pad_mode] = steps
    got12 = _run_ranks(2, 2, _job_12, cases)
    got22 = _run_ranks(4, 2, _job_22, cases["wrap"])
    return SimpleNamespace(cases=cases, ref=ref, got12=got12, got22=got22)


def _same_across_ranks(steps):
    for got in steps[1:]:
        assert got["eval"] == steps[0]["eval"]
        for a, b in zip(steps[0]["train"], got["train"]):
            assert a["log"] == b["log"]
            for k in a["state"]:
                np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


def _check_against_jax(case, ref, got):
    from test_torch_distributed import _as_model
    from test_torch_train import _check_logs, _check_step

    # the eval step: against the one-process port step, whose forward is JAX's
    model = _model(case)
    tbatch = {k: torch.from_numpy(v) for k, v in case.batch.items()}
    _check_logs(got["eval"], vqvae_train.make_eval_step(model)(tbatch))
    jdecoded, (jlosses, _, jindices) = ref[0]
    with torch.no_grad():
        decoded, (losses, _, indices) = model(tbatch["volume"].movedim(-1, 1))
    jd = np.moveaxis(np.asarray(jdecoded), -1, 1)
    np.testing.assert_allclose(decoded.numpy(), jd, rtol=0, atol=1e-5 * np.abs(jd).max())
    for lvl, (a, b) in enumerate(zip(indices, jindices)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"level {lvl}")
    np.testing.assert_allclose([float(v) for v in losses], np.asarray(jlosses), rtol=1e-5)
    # the train steps: against JAX, and cluster_size against the one-process
    # port step bit for bit (integer counts summed over the slabs)
    opt = AMSGrad(model.parameters(), lr=LR)
    one_step = vqvae_train.make_train_step(model, opt)
    for n, step in enumerate(got["train"]):
        jstate, grads, jlog = ref[n + 1]
        _check_step(_as_model(VQVAE, case.tcfg, step), jstate, grads, case.tcfg, step["log"],
                    jlog)
        one_step(tbatch)
        for lvl in range(case.tcfg.n_bottleneck_blocks):
            key = f"encoder.quantize.{lvl}.cluster_size"
            np.testing.assert_array_equal(step["state"][key], model.state_dict()[key].numpy())


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
def test_two_slabs_match_jax(spatial, pad_mode):
    steps = [g[pad_mode] for g in spatial.got12]
    _same_across_ranks(steps)
    _check_against_jax(spatial.cases[pad_mode], spatial.ref[pad_mode], steps[0])


def test_two_by_two_mesh_matches_jax(spatial):
    got = [g["2x2"] for g in spatial.got22]
    _same_across_ranks(got)
    ref = spatial.ref["wrap"]
    _check_against_jax(spatial.cases["wrap"], ref[:2], got[0])


def test_one_by_four_mesh_runs_the_coarsest_level_whole(spatial):
    # H 32 at stem 2: code grids of H 8 (slabs of 2 rows) and 2 (whole)
    case = spatial.cases["wrap"]
    assert [h for h, *_ in case.tcfg.code_grid_shapes((32, 32, 16))] == [8, 2]
    assert case.tcfg.first_whole_level(32, 4) == 1
    assert case.tcfg.first_whole_level(32, 2) == case.tcfg.n_enc
    got = [g["1x4"] for g in spatial.got22]
    _same_across_ranks(got)
    _check_against_jax(case, spatial.ref["wrap"][:2], got[0])


def test_whole_level_collectives(spatial):
    for layout in ("ops 2x2", "ops 1x4"):
        for rank, got in enumerate(spatial.got22):
            errs = got[layout]
            assert errs["N"] == 0 and errs["cluster_size"] == 0.0, (layout, rank, errs)
            # float64 sums in another order; embed_avg sums fp32 rows
            for name in ("gather", "gather backward", "mean", "std"):
                assert errs[name] <= 1e-12, (layout, rank, name, errs[name])
            assert errs["embed_avg"] <= 1e-5, (layout, rank, errs["embed_avg"])


def test_slab_ops_match_the_whole_volume(spatial):
    for rank, got in enumerate(spatial.got12):
        for name, (fwd, bwd) in got["ops"].items():
            # float64 inputs: sums in another order; the upsample computes in fp32
            assert fwd <= 1e-12, (rank, name, fwd)
            assert bwd <= (1e-6 if name == "upsample" else 1e-12), (rank, name, bwd)
