"""Causal flash attention with in-kernel logit dropout (kernel K5, forward and
backward) and its plain version.

Counterpart of ``vqvae3d_tpu/ops/flash_dropout_attention.py``
(``flash_causal_dropout_attention``, its Pallas forward and combined
backward), which PixelSNAIL's attention blocks take in training with
attention dropout on at S > 2048. On (N, S, D) tensors, N any fold of
streams, batch and heads, with t = round(p 2^32) (exact at p = 0.5):

  keep[n, i, j] = philox4x32_10(key=seed, counter=(j // 4, i, n, 0))[j % 4] >= t
  s[n, i, j]    = (q[n, i] . k[n, j]) * sm_scale
  s'[n, i, j]   = s * (1 / (1 - p)) where kept, -1e3 where dropped
  o[n, i]       = sum_{j <= i} softmax_j(s'[n, i, j]) v[n, j]

the reference's pre-mask logit dropout: a dropped logit is -1e3, not -inf,
and the causal mask (the diagonal included) comes after the dropout. A row
whose every key is dropped is a softmax over equal -1e3 logits: the mean of
its past values. ``seed`` is a (2,) int64 tensor on the operands' device whose
values are the two 32-bit key words (``draw_seed``); the TPU kernel keys its
hardware generator with one int32 and a tile id, so its bits differ. The
counter is per logit, so the mask does not depend on any tiling: the forward,
both backward passes, the plain version and ``keep_mask`` give the same bits.

Rounding: q, k, v are widened to fp32; the dots, the two scalings, the
softmax, its row sums and the log-sum-exp are fp32. For bf16 inputs the
unnormalised P is rounded to bf16 for the P.V product, and in the backward P
for dv and ds (with its scale) for dk and dq, where the tensor-core kernels
and the TPU kernel round them (its ``p.astype(v.dtype)``, :148-151 and
:206-227), as K8's bf16 route does; fp32 inputs round nothing. The output (and
in the backward each gradient) is rounded to the input type once.

Two kernel routes, chosen by ``dropout_tensor_core_route`` before any launch
(neither is a fallback of the other): bf16 runs on the tensor cores
(``flash_dropout_fwd_tc``; the backward's query-major ``drop_dq_tc``, which
also writes delta and the mask bit-packed once, then the key-major
``drop_dkdv_tc``, which reads it), fp32 on the CUDA cores (the first design's
``flash_dropout_fwd``; ``drop_delta``, ``drop_dkdv``, ``drop_dq``).

``flash_causal_dropout_attention_plain`` is that math in plain PyTorch over
chunks of query rows, forward and backward (its own autograd Function, which
recomputes each chunk's logits), so its memory is O(chunk S), not O(S^2);
``keep=`` takes the mask as data instead. ``flash_causal_dropout_attention``
is the dispatcher: a CPU tensor takes the plain version (autograd through
it); a CUDA tensor runs ``_FlashDropout``, whose forward launches
``csrc/flash_dropout_attention.cu`` (adding one to
``flash_causal_dropout_attention.launches``) and whose backward launches
``csrc/flash_dropout_attention_bwd.cu`` (adding one to
``flash_dropout_attention_bwd.launches``); any other device raises. The
kernels take D in {8, 16, 32} and v as wide as q and k. ``collect_mask``
also returns the (N, S, S) uint8 keep mask that the forward used (1 at the
causally masked j > i), for tests at small S.
"""
from __future__ import annotations

import ctypes

import torch

from vqvae3d_tpu_torch.ops import _build
from vqvae3d_tpu_torch.ops.flash_attention import HEAD_DIMS, _check

NEG_BIG = -1e3  # the reference's masked_fill value for a dropped logit
MASK32 = 0xFFFFFFFF
# Philox4x32-10 (Salmon et al., SC'11; Random123): multipliers, key increments
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROW_CHUNK = 512  # query rows of one chunk of the plain version
TILE = 64  # the tensor-core kernels' query and key tiles
TILE_WORDS = 128  # int32 words of a tile's packed keep bits (csrc/dropout_tc.cuh)


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit words of m * a, a holding uint32 values in int64.

    The 64-bit product overflows int64, so a is split into 16-bit halves:
    m a = (ah m + (al m >> 16)) 2^16 + (al m & 0xffff), every term < 2^49."""
    ah, al = a >> 16, a & 0xFFFF
    lo_part = al * m
    t = ah * m + (lo_part >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with 10 rounds on int64 tensors (or ints) holding uint32
    words, broadcast together: counter (c0, c1, c2, c3), key (k0, k1) ->
    four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(dropout_p: float) -> int:
    """t with P(bits >= t) = 1 - p for uniform 32-bit bits (JAX
    ``_keep_threshold``)."""
    return min(int(round(dropout_p * 2**32)), MASK32)


def draw_seed(generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Two 32-bit key words as a (2,) int64 tensor on the generator's device
    (no host sync on a card)."""
    dev = generator.device if generator is not None else device
    return torch.randint(0, 2**32, (2,), generator=generator, device=dev, dtype=torch.int64)


def keep_mask(seed: torch.Tensor, n: int, rows: torch.Tensor, keys: int,
              dropout_p: float) -> torch.Tensor:
    """(n, len(rows), keys) bool keep mask of the module docstring for the
    query rows ``rows`` (int64) and the keys 0 .. keys - 1."""
    dev = rows.device
    if dropout_p == 0:
        return torch.ones(n, len(rows), keys, dtype=torch.bool, device=dev)
    groups = torch.arange((keys + 3) // 4, dtype=torch.int64, device=dev)
    seed = seed.to(dev)
    words = philox4x32_10(groups[None, None, :], rows.to(torch.int64)[None, :, None],
                          torch.arange(n, dtype=torch.int64, device=dev)[:, None, None], 0,
                          seed[0] & MASK32, seed[1] & MASK32)
    bits = torch.stack(torch.broadcast_tensors(*words), -1).flatten(-2)[..., :keys]
    return bits >= keep_threshold(dropout_p)


def _check_p(dropout_p: float) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"attention dropout takes 0 <= p < 1, got {dropout_p}")


def _logits(q, k, seed, keep, i0: int, i1: int, sm_scale: float, dropout_p: float):
    """Rows i0 .. i1 - 1 of the post-dropout logits over keys 0 .. i1 - 1
    on fp32 operands, -inf past the row, and their keep mask (None at p = 0)."""
    logits = (q[:, i0:i1] @ k[:, :i1].transpose(-1, -2)) * sm_scale
    rows = torch.arange(i0, i1, device=q.device)
    kp = None
    if dropout_p > 0:
        kp = (keep[:, i0:i1, :i1] if keep is not None
              else keep_mask(seed, q.shape[0], rows, i1, dropout_p))
        logits = torch.where(kp, logits * (1.0 / (1.0 - dropout_p)), NEG_BIG)
    future = torch.arange(i1, device=q.device)[None] > rows[:, None]
    return logits.masked_fill_(future, float("-inf")), kp


def _plain_fwd(q, k, v, sm_scale: float, dropout_p: float, seed, keep):
    """The plain forward in fp32, ``ROW_CHUNK`` query rows at a time: (o
    before its rounding, the natural log-sum-exp (N, S)). For bf16 inputs the
    unnormalised P = exp(s' - m), m the row max, is rounded to bf16 for P.V
    and divided by l = sum P of the fp32 P, as the tensor-core kernel rounds
    it (there at each key tile's running max: the same rounding while a row's
    keys fit one tile); fp32 inputs take softmax(s') V."""
    bf16 = q.dtype == torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    s = q.shape[1]
    o = torch.empty_like(qf)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    for i0 in range(0, s, ROW_CHUNK):
        i1 = min(i0 + ROW_CHUNK, s)
        logits, _ = _logits(qf, kf, seed, keep, i0, i1, sm_scale, dropout_p)
        lse[:, i0:i1] = torch.logsumexp(logits, -1)
        if bf16:
            e = logits.sub_(logits.amax(-1, keepdim=True)).exp_()  # the diagonal is finite
            o[:, i0:i1] = (e.to(torch.bfloat16).float() @ vf[:, :i1]) / e.sum(-1, keepdim=True)
        else:
            o[:, i0:i1] = torch.softmax(logits, -1) @ vf[:, :i1]
    return o, lse


def _plain_bwd_fp32(q, k, v, o, lse, do, sm_scale: float, dropout_p: float, seed, keep):
    """The plain backward's fp32 (dq, dk, dv) before their last rounding,
    ``ROW_CHUNK`` query rows at a time, from o and the natural log-sum-exp
    ``lse`` of a forward: P = exp(s' - lse), dv = P^T do (dropped logits
    included), ds = keep ? P (do.v - delta) sm_scale / (1 - p) : 0, dk =
    ds^T q, dq = ds k. For bf16 inputs delta = rowsum(do o) on the rounded o,
    as the kernels read it, and P is rounded to bf16 for dv and ds for dk and
    dq, where the tensor-core kernel rounds them; fp32 inputs take P =
    softmax(s') and delta = rowsum(P dP), the autograd of the softmax (the
    same values while o is unrounded; a row whose softmax is constant gets
    ds = 0 exactly)."""
    bf16 = q.dtype == torch.bfloat16
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1) if bf16 else None
    c_ds = sm_scale / (1.0 - dropout_p)
    s = q.shape[1]
    dq, dk, dv = torch.empty_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, s, ROW_CHUNK):
        i1 = min(i0 + ROW_CHUNK, s)
        logits, kp = _logits(qf, kf, seed, keep, i0, i1, sm_scale, dropout_p)
        p = logits.sub_(lse[:, i0:i1, None]).exp_() if bf16 else torch.softmax(logits, -1)
        dv[:, :i1] += rnd(p).transpose(-1, -2) @ dof[:, i0:i1]
        dp = dof[:, i0:i1] @ vf[:, :i1].transpose(-1, -2)
        rows = delta[:, i0:i1, None] if bf16 else (p * dp).sum(-1, keepdim=True)
        ds = p.mul_(dp.sub_(rows)).mul_(c_ds)
        if kp is not None:
            ds.masked_fill_(~kp, 0.0)
        ds = rnd(ds)
        dk[:, :i1] += ds.transpose(-1, -2) @ qf[:, i0:i1]
        dq[:, i0:i1] = ds @ kf[:, :i1]
    return dq, dk, dv


class _PlainDropout(torch.autograd.Function):
    """The plain forward, saving q, k, v, o and the log-sum-exp; the plain
    backward (``_plain_bwd_fp32``), which recomputes the logits and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, dropout_p, seed, keep):
        o, lse = _plain_fwd(q, k, v, sm_scale, dropout_p, seed, keep)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse, seed, keep)
        ctx.args = (sm_scale, dropout_p)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed, keep = ctx.saved_tensors
        grads = _plain_bwd_fp32(q, k, v, o, lse, do, *ctx.args, seed, keep)
        return (*(g.to(q.dtype) for g in grads), None, None, None, None)


def flash_causal_dropout_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                         sm_scale: float, dropout_p: float,
                                         seed: torch.Tensor | None = None,
                                         keep: torch.Tensor | None = None) -> torch.Tensor:
    """The K5 contract in plain PyTorch, ``ROW_CHUNK`` query rows at a time
    (forward and backward: O(chunk S) memory). The mask is
    ``keep_mask(seed, ...)``, or ``keep`` ((N, S, S) bool) when given. bf16
    inputs round P and ds where the tensor-core kernels round them
    (``_plain_fwd``, ``_plain_bwd_fp32``); fp32 rounds nothing but o and the
    gradients."""
    _check_p(dropout_p)
    if dropout_p > 0 and (seed is None) == (keep is None):
        raise ValueError("dropout takes a seed or a keep mask (one of the two)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _PlainDropout.apply(q, k, v, sm_scale, dropout_p, seed, keep)
    return _plain_fwd(q, k, v, sm_scale, dropout_p, seed, keep)[0].to(q.dtype)


def dropout_tensor_core_route(dtype: torch.dtype, d: int) -> bool:
    """K5's route, chosen before any launch: bf16 takes the tensor-core
    kernels (flash_dropout_fwd_tc; drop_dq_tc and drop_dkdv_tc), fp32 the
    CUDA-core ones (tensor cores would round fp32 operands to TF32). Raises
    for a head dim the kernels do not take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"K5 takes D in {HEAD_DIMS}, got {d}")
    return dtype == torch.bfloat16


def packed_tiles(s: int) -> int:
    """The 64 x 64 tiles on or below the diagonal of one stream: the tiles
    of the backward's packed keep bits (``TILE_WORDS`` int32 each)."""
    nqt = -(-s // TILE)
    return nqt * (nqt + 1) // 2


def unpack_tile_bits(bits: torch.Tensor, s: int) -> torch.Tensor:
    """(N, S, S) bool keep mask from the packed bits (N, packed_tiles(S),
    TILE_WORDS) int32 that the tensor-core backward's query-major pass
    writes (csrc/dropout_tc.cuh): bit 4 nb + b of word 32 w + 4 g + t of tile
    (qt, kt) is the keep bit of query 64 qt + 16 w + g + 8 (t % 2), key
    64 kt + 8 nb + 4 (t // 2) + b. Entries above the diagonal of a tile hold
    the generator's bits; tiles above the diagonal are False."""
    n, nqt = bits.shape[0], -(-s // TILE)
    word = torch.arange(TILE_WORDS, device=bits.device)
    w, g, t = word // 32, word % 32 // 4, word % 4
    bit = torch.arange(32, device=bits.device)
    row = (16 * w + g + 8 * (t % 2))[:, None].expand(-1, 32)
    col = (8 * (bit // 4)[None] + 4 * (t // 2)[:, None] + (bit % 4)[None])
    flat = ((bits.to(torch.int64)[..., None] >> bit) & 1).bool()  # (N, T, words, 32)
    out = torch.zeros(n, nqt * TILE, nqt * TILE, dtype=torch.bool, device=bits.device)
    idx = 0
    for qt in range(nqt):
        for kt in range(qt + 1):
            tile = torch.zeros(n, TILE, TILE, dtype=torch.bool, device=bits.device)
            tile[:, row, col] = flat[:, idx]
            out[:, qt * TILE:(qt + 1) * TILE, kt * TILE:(kt + 1) * TILE] = tile
            idx += 1
    return out[:, :s, :s]


def _check_seed(seed: torch.Tensor, like: torch.Tensor) -> None:
    if seed.shape != (2,) or seed.dtype != torch.int64 or seed.device != like.device:
        raise ValueError(f"the seed is a (2,) int64 tensor on {like.device}, got "
                         f"{tuple(seed.shape)} {seed.dtype} {seed.device}")


def _aligned(*ts):
    """The tensor-core route copies 16-byte rows: a view that starts off that
    grid is copied."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def flash_dropout_attention_fwd(q, k, v, seed, sm_scale: float, dropout_p: float,
                                collect_mask: bool = False):
    """Launch the K5 forward on contiguous CUDA tensors: (o, lse), and the
    (N, S, S) uint8 keep mask with ``collect_mask``. The route is
    ``dropout_tensor_core_route``'s."""
    _check("flash_dropout_attention_fwd", q, k, v)
    _check_seed(seed, q)
    n, s, d = q.shape
    tc = dropout_tensor_core_route(q.dtype, d)
    if tc:
        q, k, v = _aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(n, s, dtype=torch.float32, device=q.device)
    mask = torch.ones(n, s, s, dtype=torch.uint8, device=q.device) if collect_mask else None
    _build.check(_build.library().vq_flash_dropout_fwd(
        int(q.dtype == torch.bfloat16), int(tc), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), seed.data_ptr(), None if mask is None else mask.data_ptr(),
        n, s, d, ctypes.c_float(sm_scale), keep_threshold(dropout_p),
        ctypes.c_float(1.0 / (1.0 - dropout_p)), _build.stream_ptr(q.device)),
        "flash_dropout_attention_fwd")
    flash_causal_dropout_attention.launches += 1
    return (o, lse, mask) if collect_mask else (o, lse)


def flash_dropout_attention_bwd(q, k, v, o, lse, do, seed, sm_scale: float, dropout_p: float,
                                keep_bits: bool = False):
    """Launch the K5 backward on contiguous CUDA tensors: (dq, dk, dv). The
    tensor-core route (``dropout_tensor_core_route``) runs drop_dq_tc, which
    also writes delta and the packed keep bits (at p > 0: scratch of
    (N, packed_tiles(S), TILE_WORDS) int32, live for this call only), then
    drop_dkdv_tc; the CUDA-core route drop_delta, drop_dkdv and drop_dq.
    ``keep_bits`` also returns the packed bits (None off that route or at
    p = 0), for tests (``unpack_tile_bits``)."""
    _check("flash_dropout_attention_bwd", q, k, v, o, do)
    _check_seed(seed, q)
    n, s, d = q.shape
    tc = dropout_tensor_core_route(q.dtype, d)
    if tc:
        q, k, v, do = _aligned(q, k, v, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(n, s, dtype=torch.float32, device=q.device)
    bits = (torch.empty(n, packed_tiles(s), TILE_WORDS, dtype=torch.int32, device=q.device)
            if tc and dropout_p > 0 else None)
    _build.check(_build.library().vq_flash_dropout_bwd(
        int(q.dtype == torch.bfloat16), int(tc), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), seed.data_ptr(),
        None if bits is None else bits.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        n, s, d, ctypes.c_float(sm_scale), keep_threshold(dropout_p),
        ctypes.c_float(1.0 / (1.0 - dropout_p)), _build.stream_ptr(q.device)),
        "flash_dropout_attention_bwd")
    flash_dropout_attention_bwd.launches += 1
    return (dq, dk, dv, bits) if keep_bits else (dq, dk, dv)


flash_dropout_attention_bwd.launches = 0


class _FlashDropout(torch.autograd.Function):
    """K5 forward, saving q, k, v, o, the log-sum-exp and the seed; K5
    backward, which regenerates the mask from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, seed, sm_scale, dropout_p):
        o, lse = flash_dropout_attention_fwd(q, k, v, seed, sm_scale, dropout_p)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.args = (sm_scale, dropout_p)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed = ctx.saved_tensors
        dq, dk, dv = flash_dropout_attention_bwd(q, k, v, o, lse, do.contiguous(), seed,
                                                 *ctx.args)
        return dq, dk, dv, None, None, None


def flash_causal_dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   sm_scale: float, dropout_p: float,
                                   seed: torch.Tensor | None = None,
                                   collect_mask: bool = False):
    """Causal attention with logit dropout on (N, S, D) tensors (the module
    docstring's contract). CPU tensors take the plain version; CUDA tensors
    kernel K5. ``seed`` may be None only at p = 0. ``collect_mask`` returns
    (o, keep mask) from a forward without autograd."""
    _check_p(dropout_p)
    dev = q.device
    if seed is None:
        if dropout_p > 0:
            raise ValueError("dropout takes a seed")
        seed = torch.zeros(2, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        if not collect_mask:
            return flash_causal_dropout_attention_plain(q, k, v, sm_scale, dropout_p, seed)
        n, s = q.shape[:2]
        with torch.no_grad():
            o = flash_causal_dropout_attention_plain(q, k, v, sm_scale, dropout_p, seed)
            keep = keep_mask(seed, n, torch.arange(s), s, dropout_p)
        return o, (keep | torch.ones(s, s, dtype=torch.bool).triu(1)).to(torch.uint8)
    if dev.type != "cuda":
        raise NotImplementedError(f"flash_causal_dropout_attention: no kernel K5 for device {dev}")
    q, k, v, seed = q.contiguous(), k.contiguous(), v.contiguous(), seed.contiguous()
    sm_scale, dropout_p = float(sm_scale), float(dropout_p)
    if collect_mask:
        with torch.no_grad():
            o, _, mask = flash_dropout_attention_fwd(q, k, v, seed, sm_scale, dropout_p, True)
        return o, mask
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashDropout.apply(q, k, v, seed, sm_scale, dropout_p)
    return flash_dropout_attention_fwd(q, k, v, seed, sm_scale, dropout_p)[0]


flash_causal_dropout_attention.launches = 0
