"""Causal flash attention (kernel K8, forward and backward) and its plain
version.

Counterpart of ``vqvae3d_tpu/models/causal_blocks.py::_flash_causal_attention``
(the bundled Pallas TPU ``flash_attention``, causal, with its custom
backward), which PixelSNAIL's attention blocks take when attention dropout is
off. On (N, S, D) tensors, N any fold of streams, batch and heads:

  o[n, i] = sum_{j <= i} softmax_j(q[n, i] . k[n, j] * sm_scale) v[n, j]

(the diagonal included, so every row attends to at least itself).

Rounding: q, k, v are widened to fp32; the dots, the softmax, its row sums
and the log-sum-exp are fp32. For bf16 inputs the unnormalised P is rounded
to bf16 once, where the tensor-core forward feeds it to the P.V product (the
TPU kernel's ``p.astype(v.dtype)`` before its fp32-accumulated dot); the
tensor-core backward rounds the normalised P for dv and ds (with its scale)
for dk and dq, as the TPU kernel's backward does; fp32 inputs round nothing.
The output (and in the backward each gradient) is rounded to the input type
once. ``flash_causal_attention_plain`` is the forward's math densely, in
plain PyTorch: the (S, S) logits materialise, so it is a reference for small
N S² only; ``flash_attention_bwd_plain`` is the backward's, query rows a
chunk at a time, on the lse of ``causal_lse_plain``.

``flash_causal_attention`` is the dispatcher: a CPU tensor takes the plain
version (autograd through it); a CUDA tensor runs ``_FlashCausal``, whose
forward launches ``csrc/flash_attention.cu`` (adding one to
``flash_causal_attention.launches``) and whose backward launches
``csrc/flash_attention_bwd.cu`` (adding one to
``flash_attention_bwd.launches``); any other device raises. The kernels take
D in {8, 16, 32} and v as wide as q and k.
"""
from __future__ import annotations

import ctypes

import torch

from vqvae3d_tpu_torch.ops import _build

HEAD_DIMS = (8, 16, 32)


def flash_causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 sm_scale: float) -> torch.Tensor:
    """The K8 contract densely: fp32 logits, causal mask, fp32 softmax and
    P.V, the output rounded to q's dtype.

    For bf16 inputs the unnormalised P = exp(s - m), m the row max, is
    rounded to bf16 before P.V, as the kernel and the TPU kernel round it
    (there at each key tile's running max, here at the row's final max: the
    same rounding while a row's keys fit one tile, a bf16 step of P apart
    beyond), and divided by l = sum P of the fp32 P. The rounding passes
    the gradient straight through to the fp32 softmax; the backward that
    rounds as K8's does is ``flash_attention_bwd_plain``."""
    return _plain_attention_fp32(q, k, v, sm_scale).to(q.dtype)


def _plain_attention_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: float) -> torch.Tensor:
    """``flash_causal_attention_plain``'s fp32 o before its last rounding."""
    s = q.shape[-2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if q.dtype == torch.bfloat16:
        with torch.no_grad():  # in place: one (S, S) fp32 tensor besides the logits and p
            e = logits.sub_(logits.amax(-1, keepdim=True)).exp_()
            l = e.sum(-1, keepdim=True)
            rounded = e.to(torch.bfloat16).float().div_(l)
            del logits, e
            rounded.sub_(p)
        p = p + rounded
    return p @ v.float()


def flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale: float, rows: int = 1024):
    """K8's backward densely: (dq, dk, dv) in q's dtype from the forward's
    o and fp32 log-sum-exp ``lse`` (N, S).

    P = exp(s - lse) in fp32 (s = q.k sm_scale, causal), delta = rowsum(do o)
    in fp32, dv = P^T do, ds = P (do.v^T - delta) sm_scale, dk = ds^T q, dq =
    ds k, every sum fp32. For bf16 inputs P is rounded to bf16 for dv and
    ds for dk and dq, where the kernel's tensor-core route and the TPU
    kernel round them (the bundled Pallas backward: ``p.T.astype(do.dtype)``,
    ``ds.T.astype(do.dtype)``, ``ds.astype(k.dtype)``); fp32 rounds nothing.
    Query rows go ``rows`` at a time, so the logits held are (N, rows, S)."""
    return tuple(g.to(q.dtype) for g in _plain_bwd_fp32(q, k, v, o, lse, do, sm_scale, rows))


def causal_lse_plain(q, k, sm_scale: float, rows: int = 1024) -> torch.Tensor:
    """The forward's fp32 log-sum-exp (N, S) densely, for
    ``flash_attention_bwd_plain``: logsumexp over the causal logits q.k
    sm_scale, query rows ``rows`` at a time."""
    s_len = q.shape[-2]
    out = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    keys = torch.arange(s_len, device=q.device)
    for r0 in range(0, s_len, rows):
        r1 = min(r0 + rows, s_len)
        logits = (q[:, r0:r1].float() @ k.float().transpose(-1, -2)) * sm_scale
        logits.masked_fill_(keys[None, :] > torch.arange(r0, r1, device=q.device)[:, None],
                            float("-inf"))
        out[:, r0:r1] = torch.logsumexp(logits, -1)
    return out


def _plain_bwd_fp32(q, k, v, o, lse, do, sm_scale: float, rows: int = 1024):
    """``flash_attention_bwd_plain``'s fp32 gradients before their last rounding."""
    bf16 = q.dtype == torch.bfloat16
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    s_len = q.shape[-2]
    dq, dk, dv = torch.empty_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    keys = torch.arange(s_len, device=q.device)
    for r0 in range(0, s_len, rows):
        r1 = min(r0 + rows, s_len)
        logits = (qf[:, r0:r1] @ kf.transpose(-1, -2)) * sm_scale
        future = keys[None, :] > torch.arange(r0, r1, device=q.device)[:, None]
        p = (logits - lse[:, r0:r1, None]).exp_().masked_fill_(future, 0.0)
        del logits
        dv += rnd(p).transpose(-1, -2) @ dof[:, r0:r1]
        ds = rnd(p.mul_((dof[:, r0:r1] @ vf.transpose(-1, -2)).sub_(delta[:, r0:r1, None]))
                 .mul_(sm_scale))
        del p
        dk += ds.transpose(-1, -2) @ qf[:, r0:r1]
        dq[:, r0:r1] = ds @ kf
    return dq, dk, dv


def _check(what: str, *ts: torch.Tensor) -> None:
    ref = ts[0]
    if ref.dim() != 3 or ref.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: (N, S, D) fp32 or bf16 tensors, got {tuple(ref.shape)} "
                         f"{ref.dtype}")
    n, s, d = ref.shape
    if d not in HEAD_DIMS or n > 65535:
        raise ValueError(f"{what}: the kernel takes D in {HEAD_DIMS} and N <= 65535, got "
                         f"N={n} D={d}")
    for t in ts:
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{what}: operands differ: {tuple(t.shape)} {t.dtype} {t.device} "
                             f"vs {tuple(ref.shape)} {ref.dtype} {ref.device}")


def flash_attention_fwd(q, k, v, sm_scale: float):
    """Launch the K8 forward on contiguous CUDA tensors: (o, lse)."""
    _check("flash_attention_fwd", q, k, v)
    if q.dtype == torch.bfloat16:
        # the bf16 route copies 16-byte rows: a view that starts off that grid is copied
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    n, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(n, s, dtype=torch.float32, device=q.device)
    _build.check(_build.library().vq_flash_attn_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), n, s, d, ctypes.c_float(sm_scale), _build.stream_ptr(q.device)),
        "flash_attention_fwd")
    flash_causal_attention.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float):
    """Launch the K8 backward (delta, dk/dv, dq) on contiguous CUDA tensors:
    (dq, dk, dv). bf16 takes the tensor-core route, fp32 the CUDA cores."""
    _check("flash_attention_bwd", q, k, v, o, do)
    if q.dtype == torch.bfloat16:
        q, k, v, do = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, do))
    n, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(n, s, dtype=torch.float32, device=q.device)
    _build.check(_build.library().vq_flash_attn_bwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), n, s, d, ctypes.c_float(sm_scale), _build.stream_ptr(q.device)),
        "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashCausal(torch.autograd.Function):
    """K8 forward, saving q, k, v, o and the log-sum-exp; K8 backward."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.sm_scale)
        return dq, dk, dv, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """Causal attention on (N, S, D) tensors (the module docstring's
    contract). CPU tensors take the plain version; CUDA tensors kernel K8."""
    dev = q.device
    if dev.type == "cpu":
        return flash_causal_attention_plain(q, k, v, sm_scale)
    if dev.type != "cuda":
        raise NotImplementedError(f"flash_causal_attention: no kernel for device {dev}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashCausal.apply(q, k, v, float(sm_scale))
    return flash_attention_fwd(q, k, v, float(sm_scale))[0]


flash_causal_attention.launches = 0
