"""'same'-block stack forward (kernel K3) and its plain version.

Counterpart of ``vqvae3d_tpu/ops/stack_kernel.py::preact_stack_fused`` (the
serving forward, which saves nothing) and, per block, of the forward math of
``vqvae3d_tpu/ops/fused_block.py::preact_block_fused``. A stack is n
PreActFixup 'same' blocks (``preact_fixup_same``) of one width C, with the
weights stacked per block in the reference layout:

  w1s (NB, Cb, C, 1, 1, 1), w2s (NB, Cb, Cb, 3, 3, 3), w3s (NB, C, Cb, 1, 1, 1),
  sc8 (NB, 8) fp32 = (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale) per block.

``preact_stack_fused`` runs the plain version on a CPU tensor and the CUDA
kernel of ``csrc/preact_stack.cu`` on a CUDA tensor (source note there: what
bounds it, what the design does). It adds one to
``preact_stack_fused.launches`` per block it launches. The kernel works on a
channels-last copy of the activation; the result is returned as a
(B, C, H, W, D) view in ``torch.channels_last_3d`` memory format, which the
next stack takes without a copy.

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
    """Reference-layout stack weights -> the kernel's packed layouts in dtype:
    w1 [NB][Gb][C][cob_b], w2 [NB][Gb][27][Cb][cob_b], w3 [NB][Gc][Cb][cob_c]."""
    nb, cb, c = w1s.shape[:3]
    w1 = _group_pack(w1s.reshape(nb, cb, c).to(dtype), _cob(cb))
    # (NB, Cb_out, Cb_in, 27) -> (NB, Cb_out, 27, Cb_in): tap-major per group
    w2 = _group_pack(w2s.reshape(nb, cb, cb, 27).transpose(2, 3).to(dtype), _cob(cb))
    w3 = _group_pack(w3s.reshape(nb, c, cb).to(dtype), _cob(c))
    return w1, w2, w3


def preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode: str):
    """Run an NB-block 'same' stack on x (B, C, H, W, D).

    CPU: ``preact_stack_plain``. CUDA: one K3 launch per block (fp32 or
    bf16 activations); anything else raises."""
    if x.device.type == "cpu":
        return preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode)
    if x.device.type != "cuda":
        raise NotImplementedError(f"preact_stack_fused: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"preact_stack_fused takes fp32 or bf16, got {x.dtype}")
    if pad_mode not in ("wrap", "zeros"):
        raise ValueError(f"unknown pad mode {pad_mode!r}")
    nb = w1s.shape[0]
    if nb == 0:
        return x
    b, c, h, w, d = x.shape
    cb = w1s.shape[1]
    if w1s.shape[2] != c or tuple(w2s.shape[1:]) != (cb, cb, 3, 3, 3) \
            or tuple(w3s.shape[1:3]) != (c, cb) or tuple(sc8.shape) != (nb, 8):
        raise ValueError(
            f"preact_stack_fused: weights {tuple(w1s.shape)}, {tuple(w2s.shape)}, "
            f"{tuple(w3s.shape)}, {tuple(sc8.shape)} do not fit C={c}"
        )
    w1p, w2p, w3p = pack_stack_weights(w1s, w2s, w3s, x.dtype)
    sc = sc8.float().contiguous()
    # channels-last: a view when x already is channels_last_3d, else one copy
    cur = x.permute(0, 2, 3, 4, 1).contiguous()
    a2 = torch.empty((b, h, w, d, cb), dtype=x.dtype, device=x.device)
    a3 = torch.empty_like(a2)
    bufs = [torch.empty_like(cur), torch.empty_like(cur) if nb > 1 else None]
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    for j in range(nb):
        out = bufs[j % 2]
        _build.check(
            lib.vq_preact_block_fwd(
                is_bf16, cur.data_ptr(), w1p[j].data_ptr(), w2p[j].data_ptr(),
                w3p[j].data_ptr(), sc[j].data_ptr(), a2.data_ptr(), a3.data_ptr(),
                out.data_ptr(), b, h, w, d, c, cb, _cob(cb), _cob(c),
                int(pad_mode == "wrap"), stream,
            ),
            "preact_stack_fused",
        )
        preact_stack_fused.launches += 1
        cur = out
    return cur.permute(0, 4, 1, 2, 3)


preact_stack_fused.launches = 0
