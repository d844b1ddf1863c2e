"""Kernel K5's plain version (causal attention with the reference's pre-mask
logit dropout) and PixelSNAIL's K5 route, against the JAX package, on the
CPU.

The JAX K5 (``ops/flash_dropout_attention.py``) keys the TPU's hardware
generator and has no interpret mode (``tests/test_flash_dropout.py``); off the
TPU the JAX package runs the same semantics in
``ops/chunked_attention.py::causal_attention_chunked``, and that is the
reference here:

  * p = 0.5: the chunked path's own mask is rebuilt in the test (its
    ``_fast_dropout_key``, then one ``bernoulli(fold_in(key, qi·nkb + ki))``
    per 128x128 tile) and given to ``flash_causal_dropout_attention_plain`` as
    ``keep=``: output and dq, dk, dv against ``jax.vjp`` of the chunked path,
    fp32 within 1e-5 (output) and 1e-4 (gradients) of max|ref| (the same fp32
    math in another order: 6e-7 measured); bf16 within 2e-2 of max|ref| (the
    chunked path rounds the scaled q, the softmax weights and the output to
    bf16, the port only the output: 7e-3 measured);
  * p = 0: against the chunked and the dense paths (fp32, 1e-5 of max|ref|);
  * Philox: Random123's known-answer vectors; the mask does not depend on the
    query chunk; the keep fraction within 5 sigma of 1 - p; other seeds,
    rows or heads give other bits;
  * rows whose every causal key is dropped average their past values (the
    -1e3 quirk), at p = 0.9 and 0.999, and the plain version equals a float64
    dense reference on the same mask within 1e-6 of max|ref|;
  * the dispatcher on CPU tensors is the plain version (autograd and
    ``collect_mask`` included) and counts no launch;
  * the model: with ``causal_blocks.DENSE_MAX_SEQ`` lowered in the test, a
    tiny PixelSNAIL (``tests/test_torch_pixelsnail.py``'s sizes) trains
    through the K5 route; its loss and every gradient equal the dense
    route's from the same generator (both draw the same seed, so the same
    mask), within 1e-5 of max|ref|; with both routes' masks given as data,
    its loss and gradients equal the JAX model's (dense attention, the
    masks in place of its ``bernoulli`` draws), as
    ``test_torch_pixelsnail.py`` holds the other routes; and it stays causal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.models import causal_blocks as jcb
from vqvae3d_tpu.models.pixelsnail import PixelSNAIL as JPixelSNAIL
from vqvae3d_tpu.models.pixelsnail import PixelSNAILConfig as JConfig
from vqvae3d_tpu.ops.chunked_attention import _fast_dropout_key, causal_attention_chunked
from vqvae3d_tpu.train import prior_train as jpt
from vqvae3d_tpu_torch.convert import jax_pixelsnail_params_to_state_dict
from vqvae3d_tpu_torch.models import causal_blocks
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.ops import flash_attention, flash_dropout_attention as fd
from vqvae3d_tpu_torch.train import prior_train

B, NH, S, D = 2, 2, 300, 8
SCALE = D ** -0.5


def _rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3g} > {rel} x max|ref| {scale:.3g}"


def _inputs(seed, n=B * NH, s=S, d=D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, s, d)).astype(np.float32) for _ in range(4))


def _chunked_mask(key, b, nh, s, blk, p):
    """The keep mask ``causal_attention_chunked`` draws: its rbg key, one
    bernoulli per (qi, ki <= qi) tile of the padded sequence."""
    n = -(-s // blk)
    key0 = _fast_dropout_key(key)
    m = np.zeros((b, nh, n * blk, n * blk), bool)
    for qi in range(n):
        for ki in range(qi + 1):
            m[:, :, qi * blk:(qi + 1) * blk, ki * blk:(ki + 1) * blk] = np.asarray(
                jax.random.bernoulli(jax.random.fold_in(key0, qi * n + ki), 1 - p,
                                     (b, nh, blk, blk)))
    return m[:, :, :s, :s].reshape(b * nh, s, s)


def _port(fn, arrays, dtype, g):
    """(o, dq, dk, dv) of ``fn`` on (N, S, D) tensors of ``dtype``."""
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays)
    o = fn(q, k, v)
    return (o, *torch.autograd.grad(o, (q, k, v), torch.from_numpy(g).to(dtype)))


def _jax_chunked(arrays, g, jdtype, p, key):
    def f(q, k, v):
        return causal_attention_chunked(q, k, v, SCALE, dropout_p=p, dropout_rng=key,
                                        block_q=128, block_k=128)

    q, k, v = (jnp.asarray(a.reshape(B, NH, S, D), jdtype) for a in arrays)
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(jnp.asarray(g.reshape(B, NH, S, D), jdtype)))


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)).reshape(B * NH, S, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_chunked_with_its_mask(dtype):
    *qkv, g = _inputs(1)
    key = jax.random.PRNGKey(3)
    keep = torch.from_numpy(_chunked_mask(key, B, NH, S, 128, 0.5))
    want = _jax_chunked(qkv, g, getattr(jnp, dtype), 0.5, key)
    got = _port(lambda q, k, v: fd.flash_causal_dropout_attention_plain(
        q, k, v, SCALE, 0.5, keep=keep), qkv, getattr(torch, dtype), g)
    tols = (1e-5, 1e-4, 1e-4, 1e-4) if dtype == "float32" else (2e-2,) * 4
    for name, a, b, tol in zip(("o", "dq", "dk", "dv"), got, want, tols):
        assert a.dtype == getattr(torch, dtype)
        _rel(_to_np(a), _to_np(b), tol, f"{dtype} {name}")


def test_p0_matches_jax_chunked_and_dense():
    *qkv, g = _inputs(2)
    want = _jax_chunked(qkv, g, jnp.float32, 0.0, None)
    got = _port(lambda q, k, v: fd.flash_causal_dropout_attention(q, k, v, SCALE, 0.0),
                qkv, torch.float32, g)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        _rel(_to_np(a), _to_np(b), 1e-5, f"p=0 vs chunked {name}")
    # the JAX dense path (S <= 2048 off the TPU) on one stream, heads in channels
    def stream(a):  # (B·NH, S, D) -> (B, S, 1, 1, NH·D): a grid of S voxels
        return a.reshape(B, NH, S, D).transpose(0, 2, 1, 3).reshape(B, S, 1, 1, NH * D)

    q, k, v = (stream(a) for a in qkv)
    dense = jcb.CausalAttention(num_heads=NH, dropout_prob=0.0, use_chunked="never").apply(
        {}, (k,) * 3, (q,) * 3, (v,) * 3)[0]
    dense = np.asarray(dense).reshape(B, S, NH, D).transpose(0, 2, 1, 3).reshape(B * NH, S, D)
    _rel(_to_np(got[0]), dense, 1e-5, "p=0 vs dense")


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors of philox4x32_10, with the words in
    int64 tensors (the 32x32 products would overflow without the split)."""
    words = fd.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_mask_is_per_logit_and_plain_is_chunk_invariant(monkeypatch):
    seed = torch.tensor([7, 2**32 - 3])
    full = fd.keep_mask(seed, 3, torch.arange(70), 70, 0.5)
    part = fd.keep_mask(seed, 3, torch.arange(33, 50), 61, 0.5)
    assert torch.equal(part, full[:, 33:50, :61])
    *qkv, g = _inputs(3, n=3, s=70)
    run = lambda: _port(lambda q, k, v: fd.flash_causal_dropout_attention_plain(
        q, k, v, SCALE, 0.5, seed), qkv, torch.float32, g)
    want = run()
    monkeypatch.setattr(fd, "ROW_CHUNK", 16)
    for a, b in zip(run(), want):
        _rel(a.detach().numpy(), b.detach().numpy(), 1e-6, "chunk 16 vs 512")
    # keep= with the Philox mask is the seeded function
    got = _port(lambda q, k, v: fd.flash_causal_dropout_attention_plain(
        q, k, v, SCALE, 0.5, keep=full), qkv, torch.float32, g)
    for a, b in zip(got, want):
        _rel(a.detach().numpy(), b.detach().numpy(), 1e-6, "keep= vs seed")


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_fraction(p):
    m = fd.keep_mask(torch.tensor([123, 456]), 4, torch.arange(256), 256, p)
    n = m.numel()
    frac = float(m.float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(frac - (1 - p)) <= 5 * sigma, f"{frac} vs {1 - p} (sigma {sigma:.2g})"
    assert fd.keep_threshold(0.5) == 2**31 and fd.keep_threshold(0.0) == 0


def test_seeds_rows_and_heads_give_other_bits():
    rows = torch.arange(64)
    a = fd.keep_mask(torch.tensor([1, 2]), 2, rows, 64, 0.5)
    assert torch.equal(a, fd.keep_mask(torch.tensor([1, 2]), 2, rows, 64, 0.5))
    for other in ([2, 1], [1, 3], [2**32 - 1, 2]):
        b = fd.keep_mask(torch.tensor(other), 2, rows, 64, 0.5)
        assert 0.4 < float((a != b).float().mean()) < 0.6, other
    assert 0.4 < float((a[0] != a[1]).float().mean()) < 0.6  # heads
    assert 0.4 < float((a[0, :32] != a[0, 32:]).float().mean()) < 0.6  # rows
    g1 = torch.Generator().manual_seed(5)
    s1, s2 = fd.draw_seed(g1), fd.draw_seed(g1)
    assert s1.shape == (2,) and s1.dtype == torch.int64 and not torch.equal(s1, s2)
    assert int(s1.min()) >= 0 and int(s1.max()) < 2**32


def _dense64(q, k, v, keep, p):
    """float64 dense reference of the contract on a given keep mask."""
    s = q.shape[1]
    logits = np.einsum("nid,njd->nij", q, k) * SCALE
    logits = np.where(keep, logits / (1 - p), -1e3)
    logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("nij,njd->nid", w / w.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("p", [0.9, 0.999])
def test_all_dropped_rows_average_their_past(p):
    *qkv, g = _inputs(4, n=4, s=64)
    seed = torch.tensor([11, 12])
    keep = fd.keep_mask(seed, 4, torch.arange(64), 64, p)
    dropped = ~(keep & torch.ones(64, 64, dtype=torch.bool).tril()).any(-1)  # (n, i)
    assert dropped.any() and (p < 0.99 or dropped.float().mean() > 0.9)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    o = fd.flash_causal_dropout_attention(q, k, v, SCALE, p, seed)
    mean_past = torch.cumsum(v.detach(), 1) / torch.arange(1, 65)[None, :, None]
    np.testing.assert_allclose(o.detach()[dropped], mean_past[dropped], rtol=0, atol=1e-6)
    _rel(o.detach().numpy(), _dense64(*(a.astype(np.float64) for a in qkv), keep.numpy(), p),
         1e-6, "vs float64 dense")
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(g))
    assert all(torch.isfinite(t).all() for t in grads)
    # an all-dropped row passes no gradient to q (its logits are constants)
    assert not grads[0][dropped].any()


def _counts():
    return (fd.flash_causal_dropout_attention.launches, fd.flash_dropout_attention_bwd.launches)


def test_dispatcher_on_cpu_is_the_plain_version():
    *qkv, g = _inputs(5, n=3, s=40)
    seed = torch.tensor([9, 10])
    before = _counts()
    got = _port(lambda q, k, v: fd.flash_causal_dropout_attention(q, k, v, SCALE, 0.5, seed),
                qkv, torch.float32, g)
    want = _port(lambda q, k, v: fd.flash_causal_dropout_attention_plain(
        q, k, v, SCALE, 0.5, seed), qkv, torch.float32, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    o, mask = fd.flash_causal_dropout_attention(q, k, v, SCALE, 0.5, seed, collect_mask=True)
    assert torch.equal(o, got[0].detach()) and mask.dtype == torch.uint8
    keep = fd.keep_mask(seed, 3, torch.arange(40), 40, 0.5)
    tril = torch.ones(40, 40, dtype=torch.bool).tril()
    assert torch.equal(mask.bool()[:, tril], keep[:, tril]) and mask[:, ~tril].eq(1).all()
    # p = 0 takes no seed and equals K8's plain version
    np.testing.assert_allclose(fd.flash_causal_dropout_attention(q, k, v, SCALE, 0.0),
                               flash_attention.flash_causal_attention_plain(q, k, v, SCALE),
                               rtol=0, atol=1e-6)
    assert _counts() == before
    with pytest.raises(ValueError, match="seed"):
        fd.flash_causal_dropout_attention(q, k, v, SCALE, 0.5)
    with pytest.raises(ValueError, match="p < 1"):
        fd.flash_causal_dropout_attention(q, k, v, SCALE, 1.0, seed)


# the model: test_torch_pixelsnail.py's sizes (S = 32), attention dropout on
C, BD, DIMS = 16, 4, (4, 4, 2)
SEQ = int(np.prod(DIMS))


def _fields(**kw):
    return {**dict(input_dim=5, condition_dim=4, model_dim=C, num_layers_per_block=1,
                   num_blocks=2, causal_dropout_prob=0.0, attention_dropout_prob=0.5,
                   bottleneck_divisor=BD, num_heads=2, lr=1e-3), **kw}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"data": rng.integers(0, 5, (B, *DIMS)).astype(np.int32),
            "condition": rng.integers(0, 4, (B, 2, 2, 1)).astype(np.int32)}


def _perturbed_model(seed):
    torch.manual_seed(seed)
    model = PixelSNAIL(PixelSNAILConfig(**_fields(), dtype=torch.float32))
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.3)
    return model


def _loss_and_grads(model, batch, gen_seed):
    model.zero_grad(set_to_none=True)
    loss, _ = prior_train.prior_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
        generator=torch.Generator().manual_seed(gen_seed))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_model_k5_route_equals_the_dense_route(monkeypatch):
    model, batch = _perturbed_model(1), _batch(2)
    dense = _loss_and_grads(model, batch, 3)
    calls = []
    k5 = causal_blocks.flash_causal_dropout_attention
    monkeypatch.setattr(causal_blocks, "DENSE_MAX_SEQ", SEQ - 1)
    monkeypatch.setattr(causal_blocks, "flash_causal_dropout_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or k5(*a, **kw))
    routed = _loss_and_grads(model, batch, 3)
    assert calls == [(3 * B * 2, SEQ, C // BD // 2)] * 2  # one call per attention block
    assert abs(routed[0] - dense[0]) <= 1e-6 * abs(dense[0])
    gmax = max(float(t.abs().max()) for t in dense[1].values())
    for name, t in dense[1].items():
        err = float((routed[1][name] - t).abs().max())
        assert err <= 1e-5 * max(float(t.abs().max()), 1e-3 * gmax), name
    # another step (another generator state) draws other masks
    assert abs(_loss_and_grads(model, batch, 4)[0] - routed[0]) > 1e-6


def test_model_k5_route_matches_jax_with_the_masks_as_data(monkeypatch):
    """The port's K5 route (its plain version) against the JAX PixelSNAIL,
    whose dense attention draws its masks with ``jax.random.bernoulli``: both
    take the same (B, nh, S, S) masks per block and stream, in call order."""
    fields = _fields()
    jmodel = JPixelSNAIL(JConfig(**fields, dtype=jnp.float32))
    x, c = jnp.zeros((B, *DIMS, 5)), jnp.zeros((B, 2, 2, 1, 4))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, x, c), jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32), shapes)
    tcfg = PixelSNAILConfig(**fields, dtype=torch.float32)
    model = PixelSNAIL(tcfg)
    model.load_state_dict(jax_pixelsnail_params_to_state_dict(params, tcfg))
    masks = rng.random((2, 3 * B * 2, SEQ, SEQ)) < 0.5  # (block, n = stream·B·nh + ...)
    jcalls, tcalls = [], []

    def bernoulli(key, p, shape):
        blk, stream = divmod(len(jcalls), 3)
        jcalls.append(shape)
        return jnp.asarray(masks[blk, stream * B * 2:(stream + 1) * B * 2].reshape(shape))

    def given(q, k, v, sm_scale, p, seed):
        tcalls.append(1)
        return fd.flash_causal_dropout_attention_plain(
            q, k, v, sm_scale, p, keep=torch.from_numpy(masks[len(tcalls) - 1]))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(causal_blocks, "DENSE_MAX_SEQ", SEQ - 1)
    monkeypatch.setattr(causal_blocks, "flash_causal_dropout_attention", given)
    batch = _batch(7)
    (_, jlog), jgrads = jax.value_and_grad(
        lambda prm: jpt.prior_loss_fn(jmodel, prm, {k: jnp.asarray(v) for k, v in batch.items()},
                                      train=True, rng=jax.random.PRNGKey(1)), has_aux=True)(params)
    loss, log = prior_train.prior_loss_fn(model, {k: torch.from_numpy(v) for k, v in
                                                  batch.items()}, train=True)
    loss.backward()
    assert jcalls == [(B, 2, SEQ, SEQ)] * 6 and len(tcalls) == 2
    np.testing.assert_allclose(float(loss.detach()), float(jlog["loss_mean"]), rtol=1e-5)
    ref = jax_pixelsnail_params_to_state_dict(jax.device_get(jgrads), tcfg)
    gmax = max(float(v.abs().max()) for v in ref.values())
    for name, prm in model.named_parameters():
        tol = max(1e-4 * float(ref[name].abs().max()), 1e-5 * gmax)
        np.testing.assert_allclose(prm.grad.numpy(), ref[name].numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def test_model_k5_route_is_causal(monkeypatch):
    """Training forward through the K5 route, one generator seed per forward:
    perturbing the input at v leaves every logit at raster positions <= v
    bit-identical."""
    monkeypatch.setattr(causal_blocks, "DENSE_MAX_SEQ", SEQ - 1)
    model = _perturbed_model(8)
    x = torch.rand(1, 5, *DIMS)
    cond = torch.rand(1, 4, 2, 2, 1)

    def logits(inp):
        return model(inp, cond, train=True, generator=torch.Generator().manual_seed(9))

    with torch.no_grad():
        base = logits(x)
        order = [(a, b, c) for a in range(DIMS[0]) for b in range(DIMS[1]) for c in range(DIMS[2])]
        for pos in order[::5]:
            x2 = x.clone()
            x2[0, :, pos[0], pos[1], pos[2]] += 3.0
            diff = (logits(x2) - base).abs().sum(1)[0]
            for q in order[:order.index(pos) + 1]:
                assert diff[q] == 0.0, f"perturbing {pos} changed the logits at {q}"
            if pos != order[-1]:
                assert diff.sum() > 0
