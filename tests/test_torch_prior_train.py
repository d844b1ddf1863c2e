"""The port's PixelCNN prior training against the JAX package, on the CPU.

Sizes are tiny: input_dim 5, condition_dim 4, model_dim 8, bottleneck
divisor 2 (Cb = 4, the union 24 -> 12 channels), 2 blocks, 4x4x4 grids (the
condition at 2x2x1), batch 2. Weights are random JAX parameter trees (numpy
seeds, every leaf N(0, 0.3²) so no Fixup branch is zero) carried to the port
with ``convert``; everything runs in fp32.

  * The union stack: ``causal_stack_plain`` on ``pack_causal_union``'s
    weights against the JAX ``apply_causal_stack(folded_io=False)`` (the JAX
    kernel K4 equals it, ``causal_kernel.py:46-49``) and against the JAX
    stock block loop, conditioned and not, at dropout 0; and with p = 0.5
    against ``apply_causal_stack(train=True)`` on the keep masks the JAX
    scan draws (``causal_stack.py:274-283``, keyed per block as at
    ``:430-433``), passed to the port as data. Outputs within 1e-5 and every
    gradient (input, condition, every block parameter) within 1e-4 of the
    tensor's max|ref|: the same sums taken in another order (2x-folded or
    per stream there, union here). ``causal_stack_fused``'s custom backward
    (the CPU path of the kernel's autograd.Function) against the autograd of
    the plain stack within 1e-6.
  * ``prior_loss_fn``: the loss, every log key and every gradient against
    ``jax.value_and_grad`` of the JAX ``prior_loss_fn``, conditioned and
    not, train (dropout 0) and eval (with accuracy): logs within rel 1e-5,
    gradients within 1e-4 of the tensor's max|ref| or 1e-5 of the largest
    gradient (near-cancelling Fixup scalars). Then two train steps against
    the JAX ``make_prior_train_step``, the parameters after each within
    the AMSGrad bound of tests/test_torch_train.py; the trained state_dict
    goes back through the JAX ``convert_reference_pixelcnn_state_dict``.
  * ``cross_entropy``, ``mixup_data`` and ``mixup_cross_entropy`` against
    the JAX functions with λ and the pairing given (within 1e-6);
    ``sattolo_cycle`` gives a derangement.
  * Causality: the gradient of every stream of an output voxel of the plain
    segment (and of the fused path) is exactly zero on every input voxel
    ``causal_reach`` forbids; the full PixelCNN's logits at raster
    positions up to v do not move, bit for bit, when the input at v does
    (tests/test_causal.py's impulse test).
  * Dropout trains: a training forward with p = 0.5 through the union
    stack equals the stock block loop on the same masks, and its gradients
    are finite.
  * ``CodeDataModule`` draws the same batches as the JAX one from one store,
    and the same slice of each for the second of two processes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vqvae3d_tpu.data.code_store import CodeDataModule as JCodeDataModule
from vqvae3d_tpu.models import prior_utils as jpu
from vqvae3d_tpu.models.causal_blocks import CausalPreActParams
from vqvae3d_tpu.models.causal_blocks import PreActFixupCausalResBlock as JBlock
from vqvae3d_tpu.models.pixelcnn import PixelCNN as JPixelCNN
from vqvae3d_tpu.models.pixelcnn import PixelCNNConfig as JConfig
from vqvae3d_tpu.ops.causal_stack import apply_causal_stack
from vqvae3d_tpu.train import prior_train as jpt
from vqvae3d_tpu.train.checkpoint import convert_reference_pixelcnn_state_dict
from vqvae3d_tpu.train.state import make_optimizer
from vqvae3d_tpu_torch.convert import _causal_block, jax_pixelcnn_params_to_state_dict
from vqvae3d_tpu_torch.data.code_store import CodeDataModule, CodeStoreWriter
from vqvae3d_tpu_torch.models import prior_utils
from vqvae3d_tpu_torch.models.causal_blocks import PreActFixupCausalResBlock
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.ops.causal_kernel import (
    causal_reach,
    causal_stack_fused,
    causal_stack_plain,
    pack_causal_union,
)
from vqvae3d_tpu_torch.ops.resize import trilinear_resize
from vqvae3d_tpu_torch.train import prior_train
from vqvae3d_tpu_torch.train.state import AMSGrad

C, BD, B, NB = 8, 2, 2, 2
CB = C // BD
DIMS, COARSE = (4, 4, 4), (2, 2, 1)
LR, B1 = 1e-3, 0.9


def _tree(shapes, rng, std=0.3):
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)


def _rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3g} > {rel} x max|ref| {scale:.3g}"


def _block_sd(tree):
    sd = {}
    _causal_block(tree, "b", sd)
    return {k[2:]: np.asarray(v, np.float32) for k, v in sd.items()}


def _port_blocks(trees, cdim, p):
    blocks = []
    for t in trees:
        blk = PreActFixupCausalResBlock(C, C, 3, "B", condition_dim=cdim, dropout_prob=p,
                                        bottleneck_divisor=BD, num_layers=NB + 1)
        blk.load_state_dict({k: torch.from_numpy(v) for k, v in _block_sd(t).items()})
        blocks.append(blk)
    return blocks


def _jax_masks(key, p):
    """(NB, B, 3·Cb) keep masks as the JAX scan draws them for ``key``."""
    out = []
    for i in range(NB):
        r3 = jax.random.split(jax.random.fold_in(key, i), 3)
        out.append(np.concatenate(
            [np.asarray(jax.random.bernoulli(r3[s], 1.0 - p, (B, 1, 1, 1, CB))).reshape(B, CB)
             for s in range(3)], -1))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _port_segment(run, trees, stack, cond, g, keep, p):
    """(y, dx, dcond, per-block parameter grads) of ``run`` on fresh blocks."""
    cdim = 0 if cond is None else cond.shape[-1]
    blocks = _port_blocks(trees, cdim, p)
    x = torch.from_numpy(np.concatenate(stack, -1)).requires_grad_()
    ct = None if cond is None else torch.from_numpy(cond).requires_grad_()
    y = run(x, ct, keep, p, pack_causal_union(blocks))
    (y * torch.from_numpy(np.concatenate(g, -1))).sum().backward()
    pg = [{n: q.grad.numpy() for n, q in blk.named_parameters()} for blk in blocks]
    return y.detach().numpy(), x.grad.numpy(), None if ct is None else ct.grad.numpy(), pg


@pytest.mark.parametrize("case", ["conditioned", "unconditioned", "dropout"])
def test_union_stack_matches_jax(case):
    rng = np.random.default_rng({"conditioned": 1, "unconditioned": 2, "dropout": 3}[case])
    cdim = 0 if case == "unconditioned" else 6
    p = 0.5 if case == "dropout" else 0.0
    mod = CausalPreActParams(channels=C, kernel_size=3, condition_dim=cdim,
                             bottleneck_divisor=BD, num_layers=NB + 1)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0))["params"]
    trees = [_tree(shapes, rng) for _ in range(NB)]
    stack = tuple(rng.standard_normal((B, *DIMS, C)).astype(np.float32) for _ in range(3))
    g = tuple(rng.standard_normal((B, *DIMS, C)).astype(np.float32) for _ in range(3))
    cond = rng.standard_normal((B, *DIMS, cdim)).astype(np.float32) if cdim else None
    key = jax.random.PRNGKey(7)

    def union(trees, stack, cond):
        vals = [mod.apply({"params": t}) for t in trees]
        stacked = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *vals)
        out = apply_causal_stack(stack, stacked, cond, kernel_size=3, dropout_prob=p,
                                 train=p > 0, rng=key if p > 0 else None, folded_io=False)
        return sum(jnp.sum(o * gi) for o, gi in zip(out, g)), out

    def stock(trees, stack, cond):
        for t in trees:
            stack = JBlock(out_channels=C, kernel_size=3, mask="B", condition_dim=cdim,
                           dropout_prob=0.0, bottleneck_divisor=BD, num_layers=NB + 1).apply(
                {"params": t}, stack, condition=cond)
        return sum(jnp.sum(o * gi) for o, gi in zip(stack, g)), stack

    keep = _jax_masks(key, p) if p > 0 else None
    got = _port_segment(causal_stack_plain, trees, stack, cond, g, keep, p)
    refs = [union] + ([stock] if p == 0 else [])
    for ref in refs:
        (_, out), (gt, gs, gc) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True))(
            trees, stack, cond)
        name = ref.__name__
        _rel(got[0], np.concatenate(out, -1), 1e-5, f"{name} output")
        _rel(got[1], np.concatenate(gs, -1), 1e-4, f"{name} dx")
        if cdim:
            _rel(got[2], gc, 1e-4, f"{name} dcond")
        for j in range(NB):
            want = _block_sd(gt[j])
            for n, a in got[3][j].items():
                _rel(a, want[n], 1e-4, f"{name} block {j} d{n}")
    # the kernel path's autograd.Function (its CPU backward: the per-block
    # recompute) against the autograd of the plain stack
    fused = _port_segment(causal_stack_fused, trees, stack, cond, g, keep, p)
    for a, b in zip(fused[:3], got[:3]):
        if b is not None:
            _rel(a, b, 1e-6, "fused vs plain")
    for fa, pa in zip(fused[3], got[3]):
        for n in pa:
            _rel(fa[n], pa[n], 1e-6, f"fused vs plain d{n}")


def test_union_segment_is_causal():
    torch.manual_seed(0)
    blocks = [PreActFixupCausalResBlock(C, C, 3, "B", condition_dim=0, dropout_prob=0.0,
                                        bottleneck_divisor=BD, num_layers=4) for _ in range(3)]
    with torch.no_grad():
        for blk in blocks:
            for prm in blk.parameters():
                prm.copy_(torch.randn(prm.shape) * 0.3)
    dims = (3, 4, 5)
    for run in (causal_stack_plain, causal_stack_fused):
        x = torch.randn(1, *dims, 3 * C, requires_grad=True)
        w = pack_causal_union(blocks)
        y = run(x, None, None, 0.0, w)
        for pos in [(0, 0, 0), (1, 2, 3), (2, 3, 4), (1, 0, 4)]:
            reach = causal_reach(dims, pos)
            for so in range(3):
                (gx,) = torch.autograd.grad(y[0, pos[0], pos[1], pos[2], so * C:(so + 1) * C].sum(),
                                            x, retain_graph=True)
                dep = gx[0].abs().reshape(*dims, 3, C).sum(-1).permute(3, 0, 1, 2) > 0  # (si, *dims)
                leak = dep & ~reach[:, so]
                assert not leak.any(), f"{run.__name__}: output {pos} stream {so} depends on " \
                                       f"{leak.nonzero()[:5].tolist()}"
                assert dep[so][pos], "an output must depend on its own stream's input"


def _raster(dims):
    return [(a, b, c) for a in range(dims[0]) for b in range(dims[1]) for c in range(dims[2])]


@pytest.mark.parametrize("variant", [{}, {"use_pre_activation": False},
                                     {"use_concat_activation": True}])
@pytest.mark.parametrize("use_cond", [False, True])
def test_pixelcnn_causality(use_cond, variant):
    """tests/test_causal.py:159-178 for the port: perturbing the input at v
    leaves every logit at raster positions <= v bit-identical; for the
    default PixelCNN (the union stack) and the Fixup and concat-activation
    ones (stock blocks)."""
    torch.manual_seed(1)
    dims = (3, 4, 3)
    model = PixelCNN(PixelCNNConfig(input_dim=6, condition_dim=5 if use_cond else 0,
                                    model_dim=8, num_resblocks=2, dropout_prob=0.0,
                                    dtype=torch.float32, **variant))
    assert model.uses_union_stack == (not variant)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.3)
    x = torch.rand(1, 6, *dims)
    cond = torch.rand(1, 5, *dims) if use_cond else None
    with torch.no_grad():
        base = model(x, cond)
        order = _raster(dims)
        for v in order[::4]:
            x2 = x.clone()
            x2[0, :, v[0], v[1], v[2]] += 3.0
            diff = (model(x2, cond) - base).abs().sum(1)[0]
            for q in order[:order.index(v) + 1]:
                assert diff[q] == 0.0, f"perturbing {v} changed the logits at {q}"
            assert diff.sum() > 0


def _fields(with_cond, **kw):
    return dict(input_dim=5, condition_dim=4 if with_cond else 0, model_dim=C,
                num_resblocks=NB, dropout_prob=0.0, bottleneck_divisor=BD, lr=LR, **kw)


def _models(with_cond, seed):
    fields = _fields(with_cond)
    jcfg = JConfig(**fields, dtype=jnp.float32)
    jmodel = JPixelCNN(jcfg)
    x = jnp.zeros((B, *DIMS, 5))
    c = jnp.zeros((B, *COARSE, 4)) if with_cond else None
    shapes = jax.eval_shape(lambda k: jmodel.init(k, x, c), jax.random.PRNGKey(0))["params"]
    params = _tree(shapes, np.random.default_rng(seed))
    tcfg = PixelCNNConfig(**fields, dtype=torch.float32)
    model = PixelCNN(tcfg)
    model.load_state_dict(jax_pixelcnn_params_to_state_dict(params, tcfg))
    return jmodel, params, model, tcfg


def _batch(rng, with_cond):
    batch = {"data": rng.integers(0, 5, (B, *DIMS)).astype(np.int32)}
    if with_cond:
        batch["condition"] = rng.integers(0, 4, (B, *COARSE)).astype(np.int32)
    return batch


def _check_logs(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _check_grads(model, grads_ref, tcfg):
    ref = jax_pixelcnn_params_to_state_dict(jax.device_get(grads_ref), tcfg)
    gmax = max(float(v.abs().max()) for v in ref.values())
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    tols = {}
    for name, prm in named.items():
        tols[name] = max(1e-4 * float(ref[name].abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(prm.grad.numpy(), ref[name].numpy(), rtol=0,
                                   atol=tols[name], err_msg=name)
    return ref, tols


@pytest.mark.parametrize("with_cond,train", [(True, True), (False, True), (True, False),
                                             (False, False)])
def test_prior_loss_and_grads_match_jax(with_cond, train):
    jmodel, params, model, tcfg = _models(with_cond, seed=10 + 2 * with_cond + train)
    batch = _batch(np.random.default_rng(20 + with_cond), with_cond)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jlog), jgrads = jax.value_and_grad(
        lambda p: jpt.prior_loss_fn(jmodel, p, jbatch, train=train, rng=jax.random.PRNGKey(0)),
        has_aux=True)(params)
    loss, log = prior_train.prior_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, train=train)
    loss.backward()
    assert ("accuracy" in log) == (not train)
    _check_logs(log, jax.device_get(jlog))
    _check_grads(model, jgrads, tcfg)


def test_prior_train_steps_match_jax():
    jmodel, params, model, tcfg = _models(True, seed=30)
    batch = _batch(np.random.default_rng(31), True)
    jstate = jpt.PriorTrainState.create(apply_fn=jmodel.apply, params=params,
                                        tx=make_optimizer(LR))
    unravel = ravel_pytree(jstate.params)[1]
    jstep = jpt.make_prior_train_step(jmodel, donate=False)
    opt = AMSGrad(model.parameters(), lr=LR)
    step = prior_train.make_prior_train_step(model, opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    mu_prev = np.zeros_like(np.asarray(jstate.opt_state[0].mu), np.float64)
    for n in (1, 2):
        jstate, jlog = jstep(jstate, batch, jax.random.PRNGKey(1))
        # the JAX step returns no gradients: read them back from AMSGrad's mu
        mu = np.asarray(jstate.opt_state[0].mu, np.float64)
        grads = unravel(jnp.asarray(((mu - B1 * mu_prev) / (1 - B1)).astype(np.float32)))
        mu_prev = mu
        log = step(tbatch)
        assert int(jstate.step) == opt.count == n
        _check_logs(log, jax.device_get(jlog))
        ref, tols = _check_grads(model, grads, tcfg)
        params_ref = jax_pixelcnn_params_to_state_dict(jax.device_get(jstate.params), tcfg)
        for name, prm in model.named_parameters():
            # Adam's step is a ratio of moments (tests/test_torch_train.py:122-127)
            g = np.abs(ref[name].numpy())
            err = np.abs(prm.detach().numpy() - params_ref[name].numpy())
            tol_p = LR * np.minimum(2.0, 4 * tols[name] / np.maximum(g, 1e-30))
            assert np.all(err <= tol_p + 1e-3 * LR), name
    # the trained state_dict goes back to the JAX tree
    back = convert_reference_pixelcnn_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JConfig(**_fields(True)))["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params)))
    flat = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_allclose(np.asarray(leaf), want[path], rtol=0, atol=2.01 * LR)


def test_cross_entropy_and_mixup_match_jax():
    rng = np.random.default_rng(40)
    logits = rng.standard_normal((3, *DIMS, 5)).astype(np.float32) * 3
    y = rng.integers(0, 5, (3, *DIMS)).astype(np.int32)
    tl = torch.from_numpy(logits).movedim(-1, 1)
    ty = torch.from_numpy(y)
    np.testing.assert_allclose(prior_utils.cross_entropy(tl, ty).numpy(),
                               np.asarray(jpu.cross_entropy(jnp.asarray(logits), jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)
    index, lam = np.array([2, 0, 1]), 0.3
    x = rng.random((3, *DIMS, 5)).astype(np.float32)
    cond = rng.random((3, *COARSE, 4)).astype(np.float32)
    mx, mc, (ya, yb), got_lam = prior_utils.mixup_data(
        torch.from_numpy(x).movedim(-1, 1), ty, 0.4, torch.from_numpy(cond).movedim(-1, 1),
        lam=lam, index=torch.from_numpy(index))
    assert got_lam == lam and torch.equal(ya, ty) and torch.equal(yb, ty[index])
    np.testing.assert_allclose(mx.movedim(1, -1).numpy(), lam * x + (1 - lam) * x[index],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mc.movedim(1, -1).numpy(), lam * cond + (1 - lam) * cond[index],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        prior_utils.mixup_cross_entropy(tl, (ya, yb), lam).numpy(),
        np.asarray(jpu.mixup_cross_entropy(jnp.asarray(logits),
                                           (jnp.asarray(y), jnp.asarray(y[index])), lam)),
        rtol=1e-6, atol=1e-6)
    assert float(prior_utils.bits_per_dim(torch.tensor(2.0))) == pytest.approx(
        float(jpu.bits_per_dim(jnp.asarray(2.0))), rel=1e-7)
    gen = torch.Generator().manual_seed(0)
    for b in (2, 3, 7):
        perm = prior_utils.sattolo_cycle(b, gen)
        assert sorted(perm.tolist()) == list(range(b))
        assert all(perm[i] != i for i in range(b)), "not a derangement"
    assert 0.0 < prior_utils.draw_beta(0.4, gen) < 1.0


def test_dropout_trains():
    torch.manual_seed(2)
    model = PixelCNN(PixelCNNConfig(**{**_fields(True), "dropout_prob": 0.5},
                                    dtype=torch.float32))
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.3)
    rng = np.random.default_rng(50)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng, True).items()}
    x = prior_utils.idx_to_one_hot(batch["data"], 5)
    cond = prior_utils.idx_to_one_hot(batch["condition"], 4)
    gen = torch.Generator().manual_seed(3)
    keep = (torch.rand(NB + 1, B, 3 * CB, generator=gen) < 0.5).float()
    got = model(x, cond, train=True, keep=keep)
    # the stock block loop on the same masks
    with torch.no_grad():
        h = model.parse_input(x)
        stack = (h, h, h)
        cemb = model.embed_condition(trilinear_resize(cond, DIMS))
        for i, layer in enumerate(model.layers):
            stack = layer(stack, cemb, train=True, keep=keep[i])
        want = model.parse_output(stack[0] + stack[1] + stack[2])
    _rel(got.detach().numpy(), want.numpy(), 1e-5, "union vs stock with dropout")
    assert not torch.allclose(got, model(x, cond, train=False))
    loss, _ = prior_train.prior_loss_fn(model, batch, train=True, generator=gen)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_code_data_module_matches_jax(tmp_path):
    rng = np.random.default_rng(60)
    w = CodeStoreWriter(str(tmp_path / "codes"), 2, [5, 4], backend="file")
    for i in range(9):
        fine = rng.integers(0, 5, (1, *DIMS) if i % 2 else DIMS).astype(np.int32)
        w.write_sample(i, [fine, rng.integers(0, 4, COARSE).astype(np.int32)])
    w.close()
    for level in (0, 1):
        dm = CodeDataModule(str(tmp_path / "codes"), level, batch_size=2, train_frac=0.7, seed=5)
        jdm = JCodeDataModule(str(tmp_path / "codes"), level, batch_size=2, train_frac=0.7,
                              seed=5)
        assert dm.num_embeddings == jdm.num_embeddings == ([5, 4] if level == 0 else [4, 0])
        np.testing.assert_array_equal(dm.train_indices, jdm.train_indices)
        np.testing.assert_array_equal(dm.val_indices, jdm.val_indices)
        for got, want in [(list(dm.train_dataloader(epoch=e)), list(jdm.train_dataloader(epoch=e)))
                          for e in (0, 1)] + [(list(dm.val_dataloader()),
                                               list(jdm.val_dataloader()))]:
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    # the second of two processes reads the JAX module's slice of every batch
    for got, want in zip(dm.train_dataloader(process_index=1, process_count=2),
                         jdm.train_dataloader(process_index=1, process_count=2)):
        assert got["data"].shape[0] == 1 and all(np.array_equal(got[k], want[k]) for k in got)
