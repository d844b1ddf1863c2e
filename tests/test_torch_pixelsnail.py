"""The port's PixelSNAIL prior against the JAX package, on the CPU.

Sizes are tiny: input_dim 5, condition_dim 4, model_dim 16, bottleneck
divisor 4 (Cb = 4), 2 heads (dh = 2), 2 attention blocks of 1 causal block
each, 4x4x2 grids (S = 32; the condition at 2x2x1), batch 2. Weights are
random JAX parameter trees (numpy seeds, every leaf N(0, 0.3²), so no Fixup
branch is zero) carried to the port with
``convert.jax_pixelsnail_params_to_state_dict``; everything runs in fp32, and
the JAX attention takes its dense path, as it does off the TPU.

  * ``generate_background`` equals the JAX one within an fp32 ulp; the aux block (a 1x1x1
    causal conv over elu(aux) added after ExpandRF), ``CausalAttention``
    (p = 0), ``flash_causal_attention_plain`` (K8's plain version) and
    ``CausalAttentionPixelBlock`` (with the swapped key/query roles) match
    the JAX modules within 1e-5 of max|ref|: the same fp32 math summed in
    another order;
  * ``PixelSNAIL.forward``, conditioned (a coarse condition, upsampled) and
    not: logits within 1e-5 of max|ref|;
  * ``prior_loss_fn`` with mixup (λ and the pairing the JAX key draws):
    every log key within rel 1e-5, every gradient within 1e-4 of its max|ref|
    or 1e-5 of the largest gradient (as for the PixelCNN); two train steps
    against the JAX ``make_prior_train_step``, at p = 0 and with channel
    dropout p = 0.5 on keep masks given to both as data;
  * causality: perturbing the input at v leaves every logit at raster
    positions <= v bit-identical;
  * attention dropout > 0 at S <= 2048 trains on the dense path; beyond
    S = 2048 the route is kernel K5 (its plain version on the CPU,
    ``tests/test_torch_flash_dropout.py``), decided before any launch; K5
    raises on a device with no kernel;
  * the weight bridge is the exact inverse of the JAX converter, and prior
    checkpoints and config files read across packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vqvae3d_tpu.models import causal_blocks as jcb
from vqvae3d_tpu.models.pixelsnail import PixelSNAIL as JPixelSNAIL
from vqvae3d_tpu.models.pixelsnail import PixelSNAILConfig as JConfig
from vqvae3d_tpu.models.prior_utils import generate_background as jbackground
from vqvae3d_tpu.models.prior_utils import sattolo_cycle as jsattolo
from vqvae3d_tpu.train import prior_train as jpt
from vqvae3d_tpu.train.checkpoint import _config_from_json, convert_reference_pixelsnail_state_dict
from vqvae3d_tpu.train.state import make_optimizer
from vqvae3d_tpu_torch.checkpoint import load_prior, save_prior
from vqvae3d_tpu_torch.convert import _biased_streams, _causal_block, jax_pixelsnail_params_to_state_dict
from vqvae3d_tpu_torch.models.causal_blocks import (
    CausalAttention,
    CausalAttentionPixelBlock,
    PreActFixupCausalResBlock,
    attention_path,
)
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.models.prior_utils import generate_background, idx_to_one_hot
from vqvae3d_tpu_torch.ops.flash_attention import flash_causal_attention_plain
from vqvae3d_tpu_torch.ops.flash_dropout_attention import flash_causal_dropout_attention
from vqvae3d_tpu_torch.train import prior_train
from vqvae3d_tpu_torch.train.state import AMSGrad

C, BD, NH, B = 16, 4, 2, 2
CB = C // BD
DIMS, COARSE = (4, 4, 2), (2, 2, 1)
LR, B1 = 1e-3, 0.9


def _tree(shapes, rng, std=0.3):
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)


def _rel(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3g} > {rel} x max|ref| {scale:.3g}"


def _t(x):  # channels-last numpy -> channels-first torch
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def _n(x):  # channels-first torch -> channels-last numpy
    return x.detach().movedim(1, -1).numpy()


def _stack(rng, c):
    return tuple(rng.standard_normal((B, *DIMS, c)).astype(np.float32) for _ in range(3))


def _fields(with_cond, **kw):
    base = dict(input_dim=5, condition_dim=4 if with_cond else 0, model_dim=C,
                num_layers_per_block=1, num_blocks=2, causal_dropout_prob=0.0,
                attention_dropout_prob=0.0, bottleneck_divisor=BD, num_heads=NH, lr=LR)
    return {**base, **kw}


def _models(fields, seed):
    """(JAX model, JAX params as numpy, port PixelSNAIL) on the same weights."""
    jmodel = JPixelSNAIL(JConfig(**fields, dtype=jnp.float32))
    x = jnp.zeros((B, *DIMS, 5))
    c = jnp.zeros((B, *COARSE, 4)) if fields["condition_dim"] else None
    shapes = jax.eval_shape(lambda k: jmodel.init(k, x, c), jax.random.PRNGKey(0))["params"]
    params = _tree(shapes, np.random.default_rng(seed))
    tcfg = PixelSNAILConfig(**fields, dtype=torch.float32)
    model = PixelSNAIL(tcfg)
    model.load_state_dict(jax_pixelsnail_params_to_state_dict(params, tcfg))
    return jmodel, params, model.eval(), tcfg


def _batch(rng, with_cond):
    batch = {"data": rng.integers(0, 5, (B, *DIMS)).astype(np.int32)}
    if with_cond:
        batch["condition"] = rng.integers(0, 4, (B, *COARSE)).astype(np.int32)
    return batch


def test_generate_background_matches_jax():
    for dims in (DIMS, (32, 32, 8), (1, 3, 5)):
        got = generate_background(3, dims)
        assert got.shape == (3, 3, *dims) and got.dtype == torch.float32
        # within an fp32 ulp of 1: the two linspaces round their steps apart
        np.testing.assert_allclose(_n(got), np.asarray(jbackground(3, dims)), rtol=0,
                                   atol=2**-23)


def test_aux_block_matches_jax():
    rng = np.random.default_rng(1)
    jblk = jcb.PreActFixupCausalResBlock(out_channels=C, mask="B", condition_dim=C,
                                         dropout_prob=0.0, bottleneck_divisor=BD, use_aux=True,
                                         num_layers=3)
    stack, aux, cond = _stack(rng, C), _stack(rng, CB), rng.standard_normal((B, *DIMS, C))
    cond = cond.astype(np.float32)
    params = _tree(jax.eval_shape(jblk.init, jax.random.PRNGKey(0), stack, aux, cond)["params"],
                   rng)
    want = jblk.apply({"params": params}, stack, aux, cond)
    sd = {}
    _causal_block(params, "b", sd)
    blk = PreActFixupCausalResBlock(C, C, 3, "B", condition_dim=C, dropout_prob=0.0,
                                    bottleneck_divisor=BD, use_aux=True, num_layers=3)
    blk.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert any(k.startswith("aux.") for k in blk.state_dict())
    got = blk(tuple(map(_t, stack)), _t(cond), aux=tuple(map(_t, aux)))
    for g, w in zip(got, want):
        _rel(_n(g), w, what="aux block")
    with pytest.raises(ValueError):
        blk(tuple(map(_t, stack)), _t(cond))  # a use_aux block needs its aux


def _jax_attention(keys, queries, values):
    out = jcb.CausalAttention(num_heads=NH, dropout_prob=0.0).apply({}, keys, queries, values)
    return [np.asarray(o) for o in out]


def test_causal_attention_and_plain_kernel_match_jax():
    rng = np.random.default_rng(2)
    keys, queries, values = _stack(rng, 8), _stack(rng, 8), _stack(rng, 8)
    want = _jax_attention(keys, queries, values)
    got = CausalAttention(NH, 0.0)(tuple(map(_t, keys)), tuple(map(_t, queries)),
                                   tuple(map(_t, values)))
    for g, w in zip(got, want):
        _rel(_n(g), w, what="CausalAttention")
    # K8's plain version on the (N, S, dh) fold of one stream
    seq = int(np.prod(DIMS))

    def fold(x):  # (B, *DIMS, nh·dh) -> (B·nh, S, dh)
        return torch.from_numpy(x.reshape(B, seq, NH, -1).transpose(0, 2, 1, 3).reshape(
            B * NH, seq, -1).copy())

    o = flash_causal_attention_plain(fold(queries[0]), fold(keys[0]), fold(values[0]), 4 ** -0.5)
    o = o.reshape(B, NH, seq, -1).permute(0, 2, 1, 3).reshape(want[0].shape)
    _rel(o.numpy(), want[0], what="flash_causal_attention_plain")


def _tpu_flash_forward_one_block(q, k, v, sm_scale):
    """The bundled Pallas TPU flash_attention's forward math
    (jax/experimental/pallas/ops/tpu/flash_attention.py:395-472, causal),
    as jnp, for a sequence that fits its one key block (the JAX model's
    blocks are 128 keys, models/causal_blocks.py:695): s = q.k^T in fp32
    times sm_scale, the causal mask added as -0.7 x the fp32 max, p =
    exp(s - m), l = sum p in fp32, o = dot(p.astype(v.dtype), v) in fp32
    times 1 / l. Returns o before and after its cast to the input dtype."""
    dims = (((2,), (2,)), ((0,), (0,)))
    s = jax.lax.dot_general(q, k, dims, preferred_element_type=jnp.float32) * sm_scale
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, s.shape, 2)
    s = s + jnp.where(cols <= rows, 0.0, -0.7 * float(jnp.finfo(jnp.float32).max))
    m = s.max(-1, keepdims=True)
    p = jnp.exp(s - m)
    l = p.sum(-1, keepdims=True)
    o = jax.lax.dot_general(p.astype(v.dtype), v, (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32) * (1.0 / l)
    return o, o.astype(q.dtype)


def test_plain_kernel_rounds_p_where_the_tpu_kernel_does():
    """K8's plain version at bf16 rounds the unnormalised P to bf16 for P.V
    and keeps l in fp32, as the TPU kernel does: its o before the last
    rounding within 1e-4 of max|ref| of the TPU math's (room for a flip of
    one P's rounding where the two exps differ in their last bit; without
    rounding P the two differ by ~1e-3), and its bf16 o within 2^-8 of
    max|ref| of the TPU kernel's bf16 o (each rounds o to bf16 once)."""
    rng = np.random.default_rng(11)
    n, seq, dh = 6, 100, 8
    q, k, v = (rng.standard_normal((n, seq, dh)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want32, want16 = _tpu_flash_forward_one_block(jq, jk, jv, dh ** -0.5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    from vqvae3d_tpu_torch.ops.flash_attention import _plain_attention_fp32

    _rel(_plain_attention_fp32(tq, tk, tv, dh ** -0.5).numpy(), np.asarray(want32), rel=1e-4,
         what="o before its rounding")
    got = flash_causal_attention_plain(tq, tk, tv, dh ** -0.5)
    assert got.dtype == torch.bfloat16
    _rel(got.float().numpy(), np.asarray(want16.astype(jnp.float32)), rel=2**-8,
         what="bf16 o")


def _tpu_flash_backward_one_block(q, k, v, do, sm_scale):
    """The bundled Pallas TPU flash_attention's backward math
    (jax/experimental/pallas/ops/tpu/flash_attention.py:273-275 di,
    :840-920 dk/dv, :1185-1261 dq; causal), as jnp, for a sequence in one
    block, with the forward's o, m and l (:395-472): p = exp(s - m) / l in
    fp32; dv = dot(p^T.astype(do.dtype), do); dp = do.v^T; ds = (dp - di) p
    sm_scale; dk = dot(ds^T.astype(do.dtype), q); dq = dot(ds.astype(k.dtype),
    k); every dot fp32-accumulated. Returns (o, lse = m + log l, dq, dk, dv),
    the gradients before their cast to the input dtype and after it."""
    f32 = jnp.float32
    dims = (((2,), (2,)), ((0,), (0,)))
    s = jax.lax.dot_general(q, k, dims, preferred_element_type=f32) * sm_scale
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, s.shape, 2)
    s = s + jnp.where(cols <= rows, 0.0, -0.7 * float(jnp.finfo(f32).max))
    m = s.max(-1, keepdims=True)
    e = jnp.exp(s - m)
    l = e.sum(-1, keepdims=True)
    o = (jax.lax.dot_general(e.astype(v.dtype), v, (((2,), (1,)), ((0,), (0,))),
                             preferred_element_type=f32) * (1.0 / l)).astype(q.dtype)
    di = jnp.sum(o.astype(f32) * do.astype(f32), axis=-1)[..., None]
    p = jnp.exp(s - m) * (1 / l)
    tr = (((1,), (1,)), ((0,), (0,)))  # contract the query axis: p^T . x
    dv = jax.lax.dot_general(p.astype(do.dtype), do, tr, preferred_element_type=f32)
    dp = jax.lax.dot_general(do, v, dims, preferred_element_type=f32)
    ds = (dp - di) * p * sm_scale
    dk = jax.lax.dot_general(ds.astype(do.dtype), q, tr, preferred_element_type=f32)
    dq = jax.lax.dot_general(ds.astype(k.dtype), k, (((2,), (1,)), ((0,), (0,))),
                             preferred_element_type=f32)
    grads = (dq, dk, dv)
    return o, (m + jnp.log(l))[..., 0], grads, tuple(g.astype(q.dtype) for g in grads)


def test_plain_backward_rounds_where_the_tpu_kernel_does():
    """K8's plain backward at bf16 rounds P for dv and ds for dk and dq, as
    the TPU kernel does: on the TPU forward's o and log-sum-exp, its fp32
    gradients within 3e-4 of max|ref| of the TPU math's (room for a flip of
    a rounding of P or ds where the two exps, exp(s - lse) and exp(s - m) / l,
    differ in their last bits: up to 8e-5 measured over four seeds), and its
    bf16 gradients within 2^-8 of max|ref| (each rounds once more). Without
    the roundings the plain gradients lie more than 1e-3 away (1.2e-3 to
    2.8e-3 measured), so the test tells the two apart."""
    rng = np.random.default_rng(12)
    n, seq, dh = 6, 100, 8
    q, k, v, do = (rng.standard_normal((n, seq, dh)).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    o, lse, want32, want16 = _tpu_flash_backward_one_block(jq, jk, jv, jdo, dh ** -0.5)
    from vqvae3d_tpu_torch.ops.flash_attention import _plain_bwd_fp32, flash_attention_bwd_plain

    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    args += [torch.from_numpy(np.asarray(o.astype(jnp.float32))).to(torch.bfloat16),
             torch.from_numpy(np.asarray(lse)),
             torch.from_numpy(do).to(torch.bfloat16)]
    got32 = _plain_bwd_fp32(*args, dh ** -0.5, rows=32)
    got16 = flash_attention_bwd_plain(*args, dh ** -0.5, rows=32)
    unrounded = _plain_bwd_fp32(*(a.float() if a.dtype == torch.bfloat16 else a for a in args),
                                dh ** -0.5)
    for name, a, a16, u, w, w16 in zip(("dq", "dk", "dv"), got32, got16, unrounded, want32,
                                       want16):
        _rel(a.numpy(), np.asarray(w), rel=3e-4, what=f"{name} before its rounding")
        assert a16.dtype == torch.bfloat16
        _rel(a16.float().numpy(), np.asarray(w16.astype(jnp.float32)), rel=2**-8,
             what=f"bf16 {name}")
        d = float(np.abs(u.numpy() - np.asarray(w)).max()) / float(np.abs(np.asarray(w)).max())
        assert d > 1e-3, f"{name}: unrounded within {d:.3g} of the rounding TPU math"


def _block_state_dict(tree):
    sd = {}
    _causal_block(tree["causal_0"], "causal_layers.0", sd)
    for proj in ("key_value_proj", "query_proj"):
        _biased_streams(tree, proj, proj, sd)
    _causal_block(tree["out_proj"], "out_proj", sd)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def test_attention_block_matches_jax():
    rng = np.random.default_rng(3)
    jblk = jcb.CausalAttentionPixelBlock(model_dim=C, num_layers_per_block=1,
                                         bottleneck_divisor=BD, condition_dim=C, num_heads=NH,
                                         causal_dropout_prob=0.0, attention_dropout_prob=0.0,
                                         num_layers=3)
    stack = _stack(rng, C)
    cond = rng.standard_normal((B, *DIMS, C)).astype(np.float32)
    bg = np.asarray(jbackground(B, DIMS))
    params = _tree(jax.eval_shape(jblk.init, jax.random.PRNGKey(0), stack, bg, cond)["params"],
                   rng)
    want = jblk.apply({"params": params}, stack, bg, cond)
    blk = CausalAttentionPixelBlock(C, 3, 1, BD, C, NH, 0.0, 0.0, num_layers=3)
    blk.load_state_dict(_block_state_dict(params))
    args = (tuple(map(_t, stack)), generate_background(B, DIMS), _t(cond))
    got = blk(*args)
    for g, w in zip(got, want):
        _rel(_n(g), w, what="attention block")
    # the roles matter: attending with the projections in their named roles
    # gives another result, which the JAX block (and a converted reference
    # checkpoint) does not
    with torch.no_grad():
        swapped = blk.causal_attention.forward
        blk.causal_attention.forward = lambda keys, queries, values, **kw: swapped(
            queries, keys, values, **kw)
        try:
            other = blk(*args)
        finally:
            del blk.causal_attention.forward
    assert max(float((a - b).detach().abs().max()) for a, b in zip(other, got)) > 1e-3


def _jax_logits(jmodel, params, batch):
    c = batch.get("condition")
    return np.asarray(jmodel.apply({"params": params}, jax.nn.one_hot(batch["data"], 5),
                                   None if c is None else jax.nn.one_hot(c, 4), train=False))


def _port_logits(model, batch):
    c = batch.get("condition")
    with torch.inference_mode():
        return _n(model(idx_to_one_hot(torch.from_numpy(batch["data"]), 5),
                        None if c is None else idx_to_one_hot(torch.from_numpy(c), 4)))


@pytest.mark.parametrize("with_cond", [False, True])
def test_pixelsnail_forward_matches_jax(with_cond):
    jmodel, params, model, _ = _models(_fields(with_cond), seed=10 + with_cond)
    batch = _batch(np.random.default_rng(11), with_cond)
    _rel(_port_logits(model, batch), _jax_logits(jmodel, params, batch), what="logits")


def _check_logs(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _check_grads(model, grads_ref, tcfg):
    ref = jax_pixelsnail_params_to_state_dict(jax.device_get(grads_ref), tcfg)
    gmax = max(float(v.abs().max()) for v in ref.values())
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    tols = {}
    for name, prm in named.items():
        tols[name] = max(1e-4 * float(ref[name].abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(prm.grad.numpy(), ref[name].numpy(), rtol=0,
                                   atol=tols[name], err_msg=name)
    return ref, tols


def _jax_mix(rng_key, alpha, b):
    """The λ and pairing the JAX loss draws from ``rng_key`` (its split order,
    ``prior_train.py:118``, ``prior_utils.py:60-62``)."""
    _, mix_rng = jax.random.split(rng_key)
    k_lam, k_perm = jax.random.split(mix_rng)
    lam = float(jax.random.beta(k_lam, alpha, alpha, dtype=jnp.float32))
    return lam, torch.from_numpy(np.asarray(jsattolo(k_perm, b)).astype(np.int64))


@pytest.mark.parametrize("with_cond,train", [(True, True), (False, True), (True, False)])
def test_prior_loss_and_grads_match_jax(with_cond, train):
    fields = _fields(with_cond, mixup_alpha=0.4)
    jmodel, params, model, tcfg = _models(fields, seed=20 + with_cond + 2 * train)
    batch = _batch(np.random.default_rng(21), with_cond)
    key = jax.random.PRNGKey(5)
    (_, jlog), jgrads = jax.value_and_grad(
        lambda p: jpt.prior_loss_fn(jmodel, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                    train=train, rng=key), has_aux=True)(params)
    mix = _jax_mix(key, 0.4, B) if train else None
    loss, log = prior_train.prior_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, train=train, mix=mix)
    loss.backward()
    assert ("accuracy" in log) == (not train)
    _check_logs(log, jax.device_get(jlog))
    _check_grads(model, jgrads, tcfg)


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_prior_train_steps_match_jax(p, monkeypatch):
    """Two steps against the JAX train step. At p = 0.5 both sides take the
    same channel-dropout keep masks as data: the JAX blocks' draws are
    replaced by the masks (the port's (L, B, 3·Cb) order: to_causal, then per
    attention block its inner blocks and out_proj; streams d, h, w)."""
    fields = _fields(True, causal_dropout_prob=p)
    jmodel, params, model, tcfg = _models(fields, seed=30)
    keep = None
    if p:
        keep = (torch.rand(tcfg.num_causal_blocks, B, 3 * CB,
                           generator=torch.Generator().manual_seed(7)) < 1 - p).float()
        masks = [keep[i, :, s * CB:(s + 1) * CB].numpy().reshape(B, 1, 1, 1, CB) > 0
                 for i in range(tcfg.num_causal_blocks) for s in range(3)]
        calls = []

        def given(x, rate, rng):
            m = masks[len(calls) % len(masks)]
            calls.append(1)
            return jnp.where(m, x / (1.0 - rate), 0.0).astype(x.dtype)

        monkeypatch.setattr(jcb, "_channel_dropout", given)
    batch = _batch(np.random.default_rng(31), True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstate = jpt.PriorTrainState.create(apply_fn=jmodel.apply, params=params,
                                        tx=make_optimizer(LR))
    unravel = ravel_pytree(jstate.params)[1]
    jstep = jpt.make_prior_train_step(jmodel, donate=False)
    opt = AMSGrad(model.parameters(), lr=LR)
    step = prior_train.make_prior_train_step(model, opt)
    mu_prev = np.zeros_like(np.asarray(jstate.opt_state[0].mu), np.float64)
    for n in (1, 2):
        jstate, jlog = jstep(jstate, batch, jax.random.PRNGKey(1))
        mu = np.asarray(jstate.opt_state[0].mu, np.float64)
        grads = unravel(jnp.asarray(((mu - B1 * mu_prev) / (1 - B1)).astype(np.float32)))
        mu_prev = mu
        if keep is None:
            log = step(tbatch)
        else:  # the step with its keep masks given
            opt.zero_grad()
            loss, log = prior_train.prior_loss_fn(model, tbatch, train=True, keep=keep)
            loss.backward()
            opt.step()
        assert int(jstate.step) == opt.count == n
        _check_logs(log, jax.device_get(jlog))
        ref, tols = _check_grads(model, grads, tcfg)
        params_ref = jax_pixelsnail_params_to_state_dict(jax.device_get(jstate.params), tcfg)
        for name, prm in model.named_parameters():
            g = np.abs(ref[name].numpy())
            err = np.abs(prm.detach().numpy() - params_ref[name].numpy())
            tol_p = LR * np.minimum(2.0, 4 * tols[name] / np.maximum(g, 1e-30))
            assert np.all(err <= tol_p + 1e-3 * LR), name
    if p:
        assert len(calls) == 3 * tcfg.num_causal_blocks  # traced once, masks consumed once


def _raster(dims):
    return [(a, b, c) for a in range(dims[0]) for b in range(dims[1]) for c in range(dims[2])]


def test_pixelsnail_causality():
    """Perturbing the input at v leaves every logit at raster positions <= v
    bit-identical (tests/test_causal.py's impulse test, through attention)."""
    torch.manual_seed(1)
    model = PixelSNAIL(PixelSNAILConfig(**_fields(True), dtype=torch.float32))
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.3)
    x = torch.rand(1, 5, *DIMS)
    cond = torch.rand(1, 4, *COARSE)
    with torch.no_grad():
        base = model(x, cond)
        order = _raster(DIMS)
        for v in order[::3]:
            x2 = x.clone()
            x2[0, :, v[0], v[1], v[2]] += 3.0
            diff = (model(x2, cond) - base).abs().sum(1)[0]
            for q in order[:order.index(v) + 1]:
                assert diff[q] == 0.0, f"perturbing {v} changed the logits at {q}"
            if v != order[-1]:
                assert diff.sum() > 0


def test_attention_dropout_trains_and_the_k5_case_raises():
    torch.manual_seed(2)
    model = PixelSNAIL(PixelSNAILConfig(**_fields(False, attention_dropout_prob=0.5,
                                                  causal_dropout_prob=0.2),
                                        dtype=torch.float32))
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(40), False).items()}
    x = idx_to_one_hot(batch["data"], 5)
    gen = torch.Generator().manual_seed(3)
    a = model(x, train=True, generator=gen)
    assert not torch.allclose(a, model(x, train=True, generator=gen))
    assert not torch.allclose(a, model(x))
    loss, _ = prior_train.prior_loss_fn(model, batch, train=True, generator=gen)
    loss.backward()
    assert all(torch.isfinite(q.grad).all() for q in model.parameters())
    # the dispatch, decided from the device, the dropout and S before a launch:
    # dropout at S > 2048 takes K5 (its plain version on the CPU); the K5 case
    # raises only where no kernel exists
    assert attention_path("cuda", False, 8192) == "flash"
    assert attention_path("cuda", True, 2048) == "dense"
    assert attention_path("cpu", False, 8192) == attention_path("cpu", True, 2048) == "dense"
    assert attention_path("cuda", True, 2049) == attention_path("cpu", True, 8192) == "flash_dropout"
    with pytest.raises(NotImplementedError, match="no path"):
        attention_path("mps", True, 2049)
    qkv = [torch.zeros(2, 4, 8, device="meta") for _ in range(3)]
    with pytest.raises(NotImplementedError, match="K5"):
        flash_causal_dropout_attention(*qkv, 0.3, 0.5, torch.zeros(2, dtype=torch.int64,
                                                                  device="meta"))


def test_weight_bridge_and_checkpoint_interchange(tmp_path):
    fields = _fields(True)
    _, params, model, tcfg = _models(fields, seed=50)
    back = convert_reference_pixelsnail_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, JConfig(**fields))["params"]
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want) == len(model.state_dict())
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path])
    save_prior(tmp_path / "ck", model, step=3)
    loaded, cfg = load_prior(tmp_path / "ck", device="cpu")
    assert isinstance(loaded, PixelSNAIL) and cfg == tcfg
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    jcfg = _config_from_json(JConfig, (tmp_path / "ck" / "step_3_config.json").read_text())
    assert (jcfg.num_blocks, jcfg.num_heads, jcfg.dtype) == (2, NH, jnp.float32)
