"""'same'-block stack (kernel K3, forward and backward) and its plain version.

Counterpart of ``vqvae3d_tpu/ops/stack_kernel.py::preact_stack_fused`` and,
per block, of ``vqvae3d_tpu/ops/fused_block.py::preact_block_fused``. A stack
is n PreActFixup 'same' blocks (``preact_fixup_same``) of one width C, with
the weights stacked per block in the reference layout:

  w1s (NB, Cb, C, 1, 1, 1), w2s (NB, Cb, Cb, 3, 3, 3), w3s (NB, C, Cb, 1, 1, 1),
  sc8 (NB, 8) fp32 = (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale) per block.

``preact_stack_fused`` has two paths:

  * no input needs a gradient (serving, ``torch.no_grad()``): the forward
    saves nothing — on a CUDA tensor one K3 launch per block
    (``csrc/preact_stack.cu``) ping-ponging between two buffers, on a CPU
    tensor ``preact_stack_plain``;
  * otherwise the ``torch.autograd.Function`` of the JAX custom VJP: its
    forward runs the same per-block forward but keeps every block's input
    (NB channels-last volumes); its backward (``preact_stack_bwd``) sweeps
    the blocks in reverse, recomputing each block from its saved input — on
    a CUDA tensor one K3-backward launch per block
    (``csrc/preact_stack_bwd.cu``), on a CPU tensor the autograd of the
    plain block (``preact_stack_bwd_plain``) — and returns the gradients of
    the stacked weights, through which autograd reaches each block's
    parameters.

Launches are counted on ``preact_stack_fused.launches`` (forward blocks) and
``preact_stack_bwd.launches`` (backward blocks). The kernels work on
channels-last copies; results are returned as (B, C, H, W, D) views in
``torch.channels_last_3d`` memory format.

The JAX package's resident/streaming/tiled variants and its s2d stack folds
(``stack_fold``) are TPU VMEM and 128-lane devices, not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops import _build
from vqvae3d_tpu_torch.ops.conv3d import conv3d


def preact_fixup_same(x, w1, w2, w3, sc8, *, pad_mode: str):
    """One 'same' PreActFixup block, plain math (``preact_fixup_same_ndhwc``,
    vqvae3d_tpu/models/blocks.py:138-150) on (B, C, H, W, D). Scalars and
    weights are cast to the activation dtype, as the JAX package does."""
    dt = x.dtype
    b1a, b1b, b2a, b2b, b3a, b3b, b4, scale = sc8.to(dt).unbind()
    out = F.elu(x + b1a) + b1b
    out = F.conv3d(out, w1.to(dt))
    out = F.elu(out + b2a) + b2b
    out = conv3d(out, w2, padding=1, pad_mode=pad_mode)
    out = F.elu(out + b3a) + b3b
    out = F.conv3d(out, w3.to(dt))
    return out * scale + b4 + x


def preact_stack_plain(x, w1s, w2s, w3s, sc8, *, pad_mode: str):
    """The stack as a loop of the plain block."""
    for j in range(w1s.shape[0]):
        x = preact_fixup_same(x, w1s[j], w2s[j], w3s[j], sc8[j], pad_mode=pad_mode)
    return x


def _cob(n: int) -> int:
    """Output channels per thread for a conv with n outputs (1, 2, 4 or 8)."""
    return 1 if n <= 1 else 2 if n <= 2 else 4 if n <= 4 else 8


def _group_pack(w: torch.Tensor, cob: int) -> torch.Tensor:
    """(NB, O, *rest) -> (NB, G, *rest, cob) with O zero-padded to G·cob: the
    kernel's [group][...][cob] layout, one contiguous slab per block."""
    nb, o = w.shape[:2]
    g = -(-o // cob)
    w = F.pad(w.reshape(nb, o, -1), (0, 0, 0, g * cob - o))
    w = w.reshape(nb, g, cob, *w.shape[2:])
    return w.movedim(2, -1).contiguous()


def pack_stack_weights(w1s, w2s, w3s, dtype):
    """Reference-layout stack weights -> the forward kernel's packed layouts
    in dtype: w1 [NB][Gb][C][cob_b], w2 [NB][Gb][27][Cb][cob_b],
    w3 [NB][Gc][Cb][cob_c]."""
    nb, cb, c = w1s.shape[:3]
    w1 = _group_pack(w1s.reshape(nb, cb, c).to(dtype), _cob(cb))
    # (NB, Cb_out, Cb_in, 27) -> (NB, Cb_out, 27, Cb_in): tap-major per group
    w2 = _group_pack(w2s.reshape(nb, cb, cb, 27).transpose(2, 3).to(dtype), _cob(cb))
    w3 = _group_pack(w3s.reshape(nb, c, cb).to(dtype), _cob(c))
    return w1, w2, w3


def pack_stack_weights_t(w1s, w2s, w3s, dtype):
    """The backward kernel's transposed packs in dtype: w1t [NB][Gc][Cb][cob_c]
    (W1^T), w2t [NB][Gb][27][Cb_out][cob_b] (groups over the conv's input
    channels), w3t [NB][Gb][C][cob_b] (W3^T)."""
    nb, cb, c = w1s.shape[:3]
    w1t = _group_pack(w1s.reshape(nb, cb, c).transpose(1, 2).to(dtype), _cob(c))
    w2t = _group_pack(w2s.reshape(nb, cb, cb, 27).permute(0, 2, 3, 1).to(dtype), _cob(cb))
    w3t = _group_pack(w3s.reshape(nb, c, cb).transpose(1, 2).to(dtype), _cob(cb))
    return w1t, w2t, w3t


def _check(x, w1s, w2s, w3s, sc8, pad_mode):
    if x.device.type != "cuda":
        raise NotImplementedError(f"preact_stack: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"preact_stack takes fp32 or bf16, got {x.dtype}")
    if pad_mode not in ("wrap", "zeros"):
        raise ValueError(f"unknown pad mode {pad_mode!r}")
    nb, cb, c = w1s.shape[:3]
    if x.shape[1] != c or tuple(w2s.shape[1:]) != (cb, cb, 3, 3, 3) \
            or tuple(w3s.shape[1:3]) != (c, cb) or tuple(sc8.shape) != (nb, 8):
        raise ValueError(
            f"preact_stack: weights {tuple(w1s.shape)}, {tuple(w2s.shape)}, "
            f"{tuple(w3s.shape)}, {tuple(sc8.shape)} do not fit C={x.shape[1]}"
        )


def _forward_cuda(x, w1s, w2s, w3s, sc8, pad_mode, saves=None):
    """K3 forward over the stack. Without ``saves`` the activations ping-pong
    between two buffers; with ``saves`` (NB, B, H, W, D, C) block j reads
    saves[j] and writes saves[j + 1] (the last block a fresh buffer)."""
    _check(x, w1s, w2s, w3s, sc8, pad_mode)
    nb = w1s.shape[0]
    b, c, h, w, d = x.shape
    cb = w1s.shape[1]
    w1p, w2p, w3p = pack_stack_weights(w1s, w2s, w3s, x.dtype)
    sc = sc8.float().contiguous()
    a2 = torch.empty((b, h, w, d, cb), dtype=x.dtype, device=x.device)
    a3 = torch.empty_like(a2)
    if saves is None:
        # channels-last: a view when x already is channels_last_3d, else one copy
        cur = x.permute(0, 2, 3, 4, 1).contiguous()
        bufs = [torch.empty_like(cur), torch.empty_like(cur) if nb > 1 else None]
        outs = [bufs[j % 2] for j in range(nb)]
    else:
        saves[0].copy_(x.permute(0, 2, 3, 4, 1))
        cur = saves[0]
        outs = [saves[j + 1] for j in range(nb - 1)] + [torch.empty_like(cur)]
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    for j in range(nb):
        _build.check(
            lib.vq_preact_block_fwd(
                is_bf16, cur.data_ptr(), w1p[j].data_ptr(), w2p[j].data_ptr(),
                w3p[j].data_ptr(), sc[j].data_ptr(), a2.data_ptr(), a3.data_ptr(),
                outs[j].data_ptr(), b, h, w, d, c, cb, _cob(cb), _cob(c),
                int(pad_mode == "wrap"), stream,
            ),
            "preact_stack_fused",
        )
        preact_stack_fused.launches += 1
        cur = outs[j]
    return cur.permute(0, 4, 1, 2, 3)


def preact_stack_bwd_plain(saves, gy, w1s, w2s, w3s, sc8, pad_mode):
    """The stack's backward by the autograd of the plain block, block by
    block in reverse, each recomputed from its saved input (saves[j],
    channels-last). Returns (dx, dw1s, dw2s, dw3s, dsc8)."""
    grads = []
    g = gy
    with torch.enable_grad():
        for j in reversed(range(w1s.shape[0])):
            xj = saves[j].permute(0, 4, 1, 2, 3).detach().requires_grad_()
            ws = [t[j].detach().requires_grad_() for t in (w1s, w2s, w3s, sc8)]
            y = preact_fixup_same(xj, *ws, pad_mode=pad_mode)
            g, *gw = torch.autograd.grad(y, [xj, *ws], g)
            grads.append(gw)
    return (g, *(torch.stack(t[::-1]) for t in zip(*grads)))


def preact_stack_bwd(saves, gy, w1s, w2s, w3s, sc8, pad_mode):
    """The stack's backward on the card: one K3-backward launch per block,
    last block first (each adds one to ``preact_stack_bwd.launches``).
    saves (NB, B, H, W, D, C) are the blocks' inputs, gy the cotangent of the
    stack output. Returns (dx, dw1s, dw2s, dw3s, dsc8), the weight gradients
    as fp32 sums in the reference layouts."""
    _check(gy, w1s, w2s, w3s, sc8, pad_mode)
    nb, cb, c = w1s.shape[:3]
    b, _, h, w, d = gy.shape
    dt = saves.dtype
    nvox = b * h * w * d
    w1p, w2p, w3p = pack_stack_weights(w1s, w2s, w3s, dt)
    w1t, w2t, w3t = pack_stack_weights_t(w1s, w2s, w3s, dt)
    sc = sc8.float().contiguous()
    gb, gc = -(-cb // _cob(cb)), -(-c // _cob(c))
    nsv = 4 * gb + 4 * gc
    work = torch.empty(nvox * (2 * c + 5 * cb), dtype=dt, device=gy.device)
    sv = torch.empty(nvox * nsv, dtype=torch.float32, device=gy.device)
    part_len = max(2**20, 27 * cb * cb, c * cb) + nsv
    part = torch.empty(part_len, dtype=torch.float32, device=gy.device)
    f32 = dict(dtype=torch.float32, device=gy.device)
    dw1, dw2 = torch.empty(nb, cb, c, **f32), torch.empty(nb, 27, cb, cb, **f32)
    dw3, dsc = torch.empty(nb, c, cb, **f32), torch.empty(nb, 8, **f32)
    g = gy.to(dt).permute(0, 2, 3, 4, 1).contiguous()
    bufs = [torch.empty_like(g), torch.empty_like(g)]
    lib = _build.library()
    stream = _build.stream_ptr(gy.device)
    for i, j in enumerate(reversed(range(nb))):
        dx = bufs[i % 2]
        _build.check(
            lib.vq_preact_block_bwd(
                int(dt == torch.bfloat16), saves[j].data_ptr(), g.data_ptr(),
                w1p[j].data_ptr(), w2p[j].data_ptr(), w3p[j].data_ptr(),
                w1t[j].data_ptr(), w2t[j].data_ptr(), w3t[j].data_ptr(), sc[j].data_ptr(),
                work.data_ptr(), sv.data_ptr(), part.data_ptr(), part_len, dx.data_ptr(),
                dw1[j].data_ptr(), dw2[j].data_ptr(), dw3[j].data_ptr(), dsc[j].data_ptr(),
                b, h, w, d, c, cb, _cob(cb), _cob(c), int(pad_mode == "wrap"), stream,
            ),
            "preact_stack_bwd",
        )
        preact_stack_bwd.launches += 1
        g = dx
    # (NB, 27, Cb_out, Cb_in) with tap = (kh*3 + kw)*3 + kd -> (NB, Cb_out, Cb_in, 3, 3, 3)
    dw2 = dw2.permute(0, 2, 3, 1).reshape(nb, cb, cb, 3, 3, 3)
    return (g.permute(0, 4, 1, 2, 3), dw1.reshape(w1s.shape), dw2, dw3.reshape(w3s.shape), dsc)


preact_stack_bwd.launches = 0


class _PreactStack(torch.autograd.Function):
    """The stack with its backward sweep (JAX ``_fwd_rule`` / ``_bwd_rule``,
    vqvae3d_tpu/ops/stack_kernel.py:1107-1249): the forward keeps every
    block's input, the backward recomputes each block from it."""

    @staticmethod
    def forward(ctx, x, w1s, w2s, w3s, sc8, pad_mode):
        nb = w1s.shape[0]
        b, c, h, w, d = x.shape
        saves = torch.empty((nb, b, h, w, d, c), dtype=x.dtype, device=x.device)
        if x.device.type == "cuda":
            y = _forward_cuda(x, w1s, w2s, w3s, sc8, pad_mode, saves=saves)
        else:
            cur = x
            for j in range(nb):
                saves[j].copy_(cur.permute(0, 2, 3, 4, 1))
                cur = preact_fixup_same(cur, w1s[j], w2s[j], w3s[j], sc8[j], pad_mode=pad_mode)
            y = cur
        ctx.save_for_backward(saves, w1s, w2s, w3s, sc8)
        ctx.pad_mode = pad_mode
        return y

    @staticmethod
    def backward(ctx, gy):
        saves, w1s, w2s, w3s, sc8 = ctx.saved_tensors
        bwd = preact_stack_bwd_plain if saves.device.type == "cpu" else preact_stack_bwd
        dx, dw1, dw2, dw3, dsc = bwd(saves, gy, w1s, w2s, w3s, sc8, ctx.pad_mode)
        return (dx.to(gy.dtype), dw1.to(w1s.dtype), dw2.to(w2s.dtype), dw3.to(w3s.dtype),
                dsc.to(sc8.dtype), None)


def preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode: str):
    """Run an NB-block 'same' stack on x (B, C, H, W, D).

    When autograd needs a gradient of any input: the saving forward and the
    K3 backward (``_PreactStack``). Otherwise: CPU -> ``preact_stack_plain``;
    CUDA -> one K3 launch per block (fp32 or bf16 activations), saving
    nothing. Any other device or dtype raises."""
    if w1s.shape[0] == 0:
        return x
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1s, w2s, w3s, sc8)):
        return _PreactStack.apply(x, w1s, w2s, w3s, sc8, pad_mode)
    if x.device.type == "cpu":
        return preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode)
    return _forward_cuda(x, w1s, w2s, w3s, sc8, pad_mode)


preact_stack_fused.launches = 0
