"""The mask-'B' segment of PixelCNN (kernel K4, forward and backward) and its
plain version.

Counterpart of ``vqvae3d_tpu/ops/causal_kernel.py::causal_stack_fused``. The
three causal streams of NB mask-'B' ``PreActFixupCausalResBlock``s run as one
union stream X = [d|h|w] (B, s0, s1, s2, 3C), channels-last, with per-block
union weights from ``pack_causal_union``:

  a1 = elu(x + b1a) + b1b;  e = a1·W1e + be;  a2 = elu(e + b2a) + b2b
  c  = causal_union_conv(a2) [· keep/(1−p)] + cond·wc + bc
  a3 = elu(c + b3a) + b3b;  y = (a3·W3)·scale + b4 + x

W1e = blockdiag(w1_d, w1_h, w1_w)·M folds the ExpandRF mixing into the first
1x1x1 conv; the union conv has 2x3x3 taps with zero pads (1, 0), (1, 1),
(1, 1) on (s0, s1, s2) and holds each stream's causal kernel in its own
diagonal block (the depth kernel in all taps, the height kernel at depth tap
1, the width kernel at depth tap 1 and height tap 1). The JAX package embeds
2x-folded kernels (a TPU 128-lane device); the union form is the same algebra
at the grid's own resolution.

Rounding follows the JAX kernel in the activation dtype: elementwise ops in
that dtype, the dots and the conv accumulated in fp32 (bf16 products are
exact there) and cast back, the conv kept in fp32 through the dropout and the
condition add and cast before ``+ b3a``. ``causal_block_plain`` is that math
in plain PyTorch.

``causal_stack_fused`` has two paths:

  * no input needs a gradient: a forward that saves nothing — on a CUDA
    tensor one K4 launch per block (``csrc/causal_stack.cu``: in bf16 at the
    widths of ``conv3d.causal_fwd_tensor_core_route`` the tensor-core route,
    whose a2 and union-conv tile are the backward's), on a CPU tensor
    ``causal_stack_plain``;
  * otherwise ``_CausalStack``, the JAX custom VJP: its forward keeps every
    block's input; its backward sweeps the blocks in reverse, recomputing
    each block from its saved input — on a CUDA tensor one K4-backward launch
    per block (``csrc/causal_stack_bwd.cu``), on a CPU tensor the autograd of
    the plain block — and returns dx, the condition's gradient summed over
    the blocks (in the activation dtype, as the JAX kernel's carry) and the
    union weights' gradients, through which autograd reaches every block's
    parameters.

Launches are counted on ``causal_stack_fused.launches`` (forward blocks) and
``causal_stack_bwd.launches`` (backward blocks). Channel dropout (torch
Dropout3d: one keep decision per (sample, channel)) enters as data, a
(NB, B, 3Cb) 0/1 mask in the union's channel order.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops import _build
from vqvae3d_tpu_torch.ops.conv3d import (causal_bwd_tensor_core_route,
                                          causal_fwd_tensor_core_route)
from vqvae3d_tpu_torch.ops.stack_kernel import _cob, _group_pack, fused_brick

UTAPS = (2, 3, 3)  # union conv taps on (s0, s1, s2), kernel_size 3
NTAPS = 18
STREAMS = ("depth_conv", "height_conv", "width_conv")


class UnionWeights(NamedTuple):
    """Stacked per-block union weights (leading dim NB), fp32 as the
    parameters: w1e (Cu, Cb), be (Cb,), wu (2, 3, 3, Cb, Cb) (tap, in, out),
    w3 (Cb, Cu), wc (Cc, Cb) and bc (Cb,) or None when unconditioned, sc (8,)
    = (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale)."""

    w1e: torch.Tensor
    be: torch.Tensor
    wu: torch.Tensor
    w3: torch.Tensor
    wc: Optional[torch.Tensor]
    bc: Optional[torch.Tensor]
    sc: torch.Tensor


def _mat(conv) -> torch.Tensor:
    """A 1x1x1 conv's (O, I, 1, 1, 1) weight as an (I, O) matrix."""
    return conv.weight[:, :, 0, 0, 0].t()


def _blockdiag3(ws) -> torch.Tensor:
    """3 x (NB, A, B) -> (NB, 3A, 3B) block-diagonal."""
    nb, a, b = ws[0].shape
    out = ws[0].new_zeros(nb, 3 * a, 3 * b)
    for s, w in enumerate(ws):
        out[:, s * a:(s + 1) * a, s * b:(s + 1) * b] = w
    return out


def pack_causal_union(blocks: Sequence) -> UnionWeights:
    """Mask-'B' ``PreActFixupCausalResBlock``s (kernel_size 3, no skip conv)
    -> their stacked union weights. Torch ops on the parameters, so autograd
    carries the union weights' gradients back to each block's parameters (as
    the JAX package's traced packing, ``causal_kernel.py:705-756``)."""
    def st(fn):
        return torch.stack([fn(b) for b in blocks])

    for b in blocks:
        if b.skip_conv is not None or tuple(b.branch_conv2.depth_conv.weight.shape[2:]) != (2, 3, 3):
            raise ValueError("the union stack takes mask-'B' blocks of kernel_size 3 "
                             "without a skip conv")
    w1 = [st(lambda b, s=s: _mat(getattr(b.branch_conv1, s))) for s in STREAMS]  # (NB, C, cb)
    nb, _, cb = w1[0].shape
    wdc = st(lambda b: _mat(b.expand_rf.depth_conv))  # (NB, cb, 2cb): [d2h | d2w]
    bdc = st(lambda b: b.expand_rf.depth_conv.bias)
    wh2w = st(lambda b: _mat(b.expand_rf.height_conv))
    bh2w = st(lambda b: b.expand_rf.height_conv.bias)
    # ExpandRF as a right factor: [[I, d2h, d2w], [0, I, h2w], [0, 0, I]]
    m = wdc.new_zeros(nb, 3 * cb, 3 * cb)
    eye = torch.eye(cb, dtype=wdc.dtype, device=wdc.device)
    for s in range(3):
        m[:, s * cb:(s + 1) * cb, s * cb:(s + 1) * cb] = eye
    m[:, :cb, cb:2 * cb] = wdc[:, :, :cb]
    m[:, :cb, 2 * cb:] = wdc[:, :, cb:]
    m[:, cb:2 * cb, 2 * cb:] = wh2w
    w1e = _blockdiag3(w1) @ m
    be = torch.cat([torch.zeros_like(bh2w), bdc[:, :cb], bdc[:, cb:] + bh2w], -1)

    def taps(s):  # (NB, O, I, k0, k1, k2) -> (NB, k0, k1, k2, I, O)
        return st(lambda b: getattr(b.branch_conv2, s).weight).permute(0, 3, 4, 5, 2, 1)

    wu = wdc.new_zeros(nb, *UTAPS, 3 * cb, 3 * cb)
    wu[:, :, :, :, :cb, :cb] = taps("depth_conv")
    wu[:, 1:2, 0:2, :, cb:2 * cb, cb:2 * cb] = taps("height_conv")
    wu[:, 1:2, 1:2, 0:2, 2 * cb:, 2 * cb:] = taps("width_conv")
    w3 = _blockdiag3([st(lambda b, s=s: _mat(getattr(b.branch_conv3, s))) for s in STREAMS])
    wc = bc = None
    if blocks[0].condition is not None:
        wc = st(lambda b: _mat(b.condition)).repeat(1, 1, 3)
        bc = st(lambda b: b.condition.bias).repeat(1, 3)
    sc = st(lambda b: torch.cat([b.bias1a, b.bias1b, b.bias2a, b.bias2b, b.bias3a,
                                 b.bias3b, b.bias4, b.scale]))
    return UnionWeights(w1e, be, wu, w3, wc, bc, sc)


def union_block(weights: UnionWeights, j: int) -> UnionWeights:
    """Block j's weights (leading dim dropped; None stays None)."""
    return UnionWeights(*(None if t is None else t[j] for t in weights))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) in dtype dt times w (K, N) cast to dt, accumulated in fp32,
    cast back to dt."""
    return torch.matmul(a.float(), w.to(a.dtype).float()).to(a.dtype)


def causal_union_conv(a2: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """The union causal conv, fp32: a2 (B, s0, s1, s2, Cb), wu (2, 3, 3, Cb,
    Cb) -> (B, s0, s1, s2, Cb). Tap (j0, j1, j2) reads a2 at
    (i0 + j0 - 1, i1 + j1 - 1, i2 + j2 - 1), zero outside."""
    s0, s1, s2 = a2.shape[1:4]
    a = F.pad(a2.float(), (0, 0, 1, 1, 1, 1, 1, 0))
    w = wu.to(a2.dtype).float()
    out = None
    for j0 in range(UTAPS[0]):
        for j1 in range(UTAPS[1]):
            for j2 in range(UTAPS[2]):
                t = torch.matmul(a[:, j0:j0 + s0, j1:j1 + s1, j2:j2 + s2], w[j0, j1, j2])
                out = t if out is None else out + t
    return out


def causal_block_plain(x, cond, keep, p: float, w: UnionWeights) -> torch.Tensor:
    """One union block, plain math, in x's dtype: x (B, s0, s1, s2, Cu)
    channels-last, cond (B, s0, s1, s2, Cc) or None, keep (B, Cb) 0/1 or None
    (dropout with probability p), w one block's ``UnionWeights``."""
    dt = x.dtype
    b1a, b1b, b2a, b2b, b3a, b3b, b4, scale = w.sc.to(dt).unbind()
    a1 = F.elu(x + b1a) + b1b
    a2 = F.elu(_dot(a1, w.w1e) + w.be.to(dt) + b2a) + b2b
    c = causal_union_conv(a2, w.wu)
    if keep is not None:
        c = torch.where(keep[:, None, None, None, :] > 0, c / (1.0 - p), 0.0)
    if cond is not None:
        c = c + torch.matmul(cond.float(), w.wc.to(dt).float()) + w.bc.to(dt).float()
    a3 = F.elu(c.to(dt) + b3a) + b3b
    return _dot(a3, w.w3) * scale + b4 + x


def causal_reach(dims, pos) -> torch.Tensor:
    """Where output voxel ``pos`` of a mask-'B' segment may depend on its
    input, by raster order: a (3, 3, s0, s1, s2) bool, [input stream, output
    stream, voxel], streams (depth, height, width). The depth stream's input
    reaches every output stream from slices i0 ≤ pos[0]; the height stream's
    the height and width outputs from rows i1 ≤ pos[1] of the same slice; the
    width stream's the width output from positions i2 ≤ pos[2] of the same
    row. A dependence outside this set leaks the future."""
    i0, i1, i2 = (torch.arange(n).view([-1 if a == k else 1 for k in range(3)])
                  for a, n in enumerate(dims))
    p0, p1, p2 = pos
    reach = torch.zeros(3, 3, *dims, dtype=torch.bool)
    reach[0] = (i0 <= p0).expand(*dims)
    reach[1, 1:] = ((i0 == p0) & (i1 <= p1)).expand(*dims)
    reach[2, 2] = ((i0 == p0) & (i1 == p1) & (i2 <= p2)).expand(*dims)
    return reach


def causal_influence(dims, pos) -> torch.Tensor:
    """The converse of ``causal_reach``: the output voxels that input voxel
    ``pos`` may move, (3, 3, s0, s1, s2) bool [input stream, output stream,
    voxel]."""
    i0, i1, i2 = (torch.arange(n).view([-1 if a == k else 1 for k in range(3)])
                  for a, n in enumerate(dims))
    v0, v1, v2 = pos
    out = torch.zeros(3, 3, *dims, dtype=torch.bool)
    out[0] = (i0 >= v0).expand(*dims)
    out[1, 1:] = ((i0 == v0) & (i1 >= v1)).expand(*dims)
    out[2, 2] = ((i0 == v0) & (i1 == v1) & (i2 >= v2)).expand(*dims)
    return out


def causal_stack_plain(x, cond, keep, p: float, weights: UnionWeights,
                       remat: bool = False) -> torch.Tensor:
    """The segment as a loop of the plain block. ``remat`` checkpoints each
    block (``torch.utils.checkpoint``; the JAX ``remat_scan``), so that
    autograd keeps one input per block instead of every intermediate."""
    for j in range(weights.sc.shape[0]):
        args = (cond, None if keep is None else keep[j], p, union_block(weights, j))
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(causal_block_plain, x, *args,
                                                  use_reentrant=False)
        else:
            x = causal_block_plain(x, *args)
    return x


# ---------------------------------------------------------------------------
# Kernel path
# ---------------------------------------------------------------------------


def _check(x, cond, keep, weights: UnionWeights):
    if x.device.type != "cuda":
        raise NotImplementedError(f"causal_stack: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"causal_stack takes fp32 or bf16, got {x.dtype}")
    nb, cu, cb = weights.w1e.shape
    if x.ndim != 5 or x.shape[-1] != cu or tuple(weights.wu.shape[1:]) != (*UTAPS, cb, cb):
        raise ValueError(f"causal_stack: x {tuple(x.shape)} does not fit union weights "
                         f"{tuple(weights.w1e.shape)}, {tuple(weights.wu.shape)}")
    if (cond is None) != (weights.wc is None) or (
            cond is not None and (cond.shape[:4] != x.shape[:4] or cond.dtype != x.dtype)):
        raise ValueError("causal_stack: the condition must match x and the weights")
    if keep is not None and tuple(keep.shape) != (nb, x.shape[0], cb):
        raise ValueError(f"causal_stack: keep mask {tuple(keep.shape)} is not "
                         f"{(nb, x.shape[0], cb)}")


class _Packed(NamedTuple):
    """The kernels' weight layouts in the activation dtype, [group][...][cob]
    per block: w1 [Gb][Cu][cob_b], wu [Gb][18][Cb_in][cob_b], w3 [Gu][Cb][cob_u],
    wc [Gb][Cc][cob_b]; be, bc (NB, Cb); sc (NB, 8) fp32."""

    w1: torch.Tensor
    wu: torch.Tensor
    w3: torch.Tensor
    wc: Optional[torch.Tensor]
    be: torch.Tensor
    bc: Optional[torch.Tensor]
    sc: torch.Tensor


def pack_kernel_weights(w: UnionWeights, dtype) -> _Packed:
    nb, cu, cb = w.w1e.shape
    ob, ou = _cob(cb), _cob(cu)
    wu = w.wu.reshape(nb, NTAPS, cb, cb).permute(0, 3, 1, 2)  # (NB, O, 18, I)
    return _Packed(
        _group_pack(w.w1e.transpose(1, 2).to(dtype), ob),
        _group_pack(wu.to(dtype), ob),
        _group_pack(w.w3.transpose(1, 2).to(dtype), ou),
        None if w.wc is None else _group_pack(w.wc.transpose(1, 2).to(dtype), ob),
        w.be.to(dtype).contiguous(),
        None if w.bc is None else w.bc.to(dtype).contiguous(),
        w.sc.float().contiguous(),
    )


def pack_kernel_weights_t(w: UnionWeights, dtype):
    """The backward's transposed packs: w1t [Gu][Cb][cob_u] (W1e^T), wut
    [Gb][18][Cb_out][cob_b] (groups over the conv's input channels), w3t
    [Gb][Cu][cob_b] (W3^T), wct [Gc][Cb][cob_c] (wc^T) or None."""
    nb, cu, cb = w.w1e.shape
    wut = w.wu.reshape(nb, NTAPS, cb, cb).permute(0, 2, 1, 3)  # (NB, I, 18, O)
    wct = None
    if w.wc is not None:
        wct = _group_pack(w.wc.to(dtype), _cob(w.wc.shape[1]))
    return (_group_pack(w.w1e.to(dtype), _cob(cu)), _group_pack(wut.to(dtype), _cob(cb)),
            _group_pack(w.w3.to(dtype), _cob(cb)), wct)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _forward_cuda(x, cond, keep, p, weights: UnionWeights, saves=None):
    """K4 forward over the segment on x (B, s0, s1, s2, Cu), on
    ``conv3d.causal_fwd_tensor_core_route``'s route (bf16 at the widths it
    takes: ``vq_causal_block_fwd_tc``; else the three CUDA-core kernels).
    Without ``saves`` the activations ping-pong between two buffers; with
    ``saves`` (NB, B, s0, s1, s2, Cu) block j reads saves[j] and writes
    saves[j + 1] (the last block a fresh buffer)."""
    _check(x, cond, keep, weights)
    nb, cu, cb = weights.w1e.shape
    b, s0, s1, s2, _ = x.shape
    cc = 0 if cond is None else cond.shape[-1]
    tensor_cores = causal_fwd_tensor_core_route(x.dtype, cu, cb, cc)
    if tensor_cores:
        pk = pack_bwd_tc_weights(weights)
        sc = weights.sc.float().contiguous()
        brick = bwd_plan(b, s0, s1, s2)[0]
        a2 = torch.empty((b * s0 * s1 * s2, 16), dtype=x.dtype, device=x.device)
    else:
        pk = pack_kernel_weights(weights, x.dtype)
        a2 = torch.empty((b, s0, s1, s2, cb), dtype=x.dtype, device=x.device)
        a3 = torch.empty_like(a2)
    cond = None if cond is None else cond.contiguous()
    keep = None if keep is None else keep.float().contiguous()
    if saves is None:
        cur = x.contiguous()
        bufs = [torch.empty_like(cur), torch.empty_like(cur) if nb > 1 else None]
        outs = [bufs[j % 2] for j in range(nb)]
    else:
        saves[0].copy_(x)
        cur = saves[0]
        outs = [saves[j + 1] for j in range(nb - 1)] + [torch.empty_like(cur)]
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    cj = (lambda k, j: None) if cond is None else (lambda k, j: pk[k][j].data_ptr())
    for j in range(nb):
        kp = None if keep is None else keep[j].data_ptr()
        if tensor_cores:
            err = lib.vq_causal_block_fwd_tc(
                cur.data_ptr(), _ptr(cond), kp, 1.0 - p,
                *(pk[k][j].data_ptr() for k in ("w1e", "be", "wuf", "w3t")),
                cj("wct", j), cj("bc", j), sc[j].data_ptr(), a2.data_ptr(), outs[j].data_ptr(),
                b, s0, s1, s2, cu, cb, cc, *brick, stream)
        else:
            err = lib.vq_causal_block_fwd(
                int(x.dtype == torch.bfloat16), cur.data_ptr(), _ptr(cond), kp, 1.0 - p,
                pk.w1[j].data_ptr(), pk.be[j].data_ptr(), pk.wu[j].data_ptr(),
                pk.w3[j].data_ptr(), None if cond is None else pk.wc[j].data_ptr(),
                None if cond is None else pk.bc[j].data_ptr(), pk.sc[j].data_ptr(),
                a2.data_ptr(), a3.data_ptr(), outs[j].data_ptr(),
                b, s0, s1, s2, cu, cb, cc, _cob(cb), _cob(cu), stream)
        _build.check(err, "causal_stack_fused")
        causal_stack_fused.launches += 1
        cur = outs[j]
    return cur


def causal_stack_bwd_plain(saves, gy, cond, keep, p, weights: UnionWeights):
    """The segment's backward by the autograd of the plain block, block by
    block in reverse, each recomputed from its saved input. Returns (dx,
    gcond or None, dw1e, dbe, dwu, dw3, dwc or None, dbc or None, dsc)."""
    grads, gcond = [], None
    g = gy
    with torch.enable_grad():
        for j in reversed(range(weights.sc.shape[0])):
            xj = saves[j].detach().requires_grad_()
            cj = None if cond is None else cond.detach().requires_grad_()
            wj = [None if t is None else t[j].detach().requires_grad_() for t in weights]
            y = causal_block_plain(xj, cj, None if keep is None else keep[j], p,
                                   UnionWeights(*wj))
            ins = [xj] + ([cj] if cj is not None else []) + [t for t in wj if t is not None]
            out = list(torch.autograd.grad(y, ins, g))
            g = out.pop(0)
            if cj is not None:
                gc = out.pop(0)
                gcond = gc if gcond is None else gcond + gc  # in the activation dtype
            grads.append([None if t is None else out.pop(0) for t in wj])
    stacked = [None if t[0] is None else torch.stack(t[::-1]) for t in zip(*grads)]
    return (g, gcond, *stacked)


BWD_TC_VOXELS = 128  # a brick of the tensor-core forward and backward (csrc/causal_tc.cuh tc::kVox)
# the persistent CTAs of tc_mid and tc_dgrad at most: one wave on an H100's
# 132 SMs at the CTAs an SM holds (their launch bounds: 2 and 3)
BWD_TC_CTAS = (264, 396)


def bwd_plan(b: int, s0: int, s1: int, s2: int):
    """The tensor-core backward's brick (bs0, bs1, bs2) of ``BWD_TC_VOXELS``
    voxels and the CTA counts of tc_mid and tc_dgrad, one a brick up to
    ``BWD_TC_CTAS``: a function of the shapes only, so the order of the
    per-CTA partials' sum is fixed."""
    brick = fused_brick(s0, s1, s2, BWD_TC_VOXELS)
    nbricks = b * math.prod(-(-n // t) for n, t in zip((s0, s1, s2), brick))
    return brick, tuple(min(nbricks, n) for n in BWD_TC_CTAS)


def bwd_partial_lens(cu: int, cb: int, cc: int):
    """Floats of a CTA's partial: tc_mid's (dWU, dW3^T, dwc^T, dbc, 4 scalar
    sums) and tc_dgrad's (dW1e^T, dbe, 4 scalar sums)."""
    return NTAPS * cb * cb + cu * cb + cb * cc + (cb if cc else 0) + 4, cb * cu + cb + 4


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def pack_bwd_tc_weights(w: UnionWeights):
    """The tensor-core backward's bf16 packs, each [N][K] (k contiguous),
    zero-padded to CUP = Cu, CCP = Cc and Cb rounded up to 16, leading dim
    NB: w1e [16][CUP] (W1e^T), wuf [18][16][16] (the conv: tap, out, in), wut
    [18][16][16] (its transpose: tap, in, out), w3 [16][CUP], w3t [CUP][16],
    wct [16][CCP] (wc^T), wcn [CCP][16] (wc), w1n [CUP][16] (W1e); be, bc."""
    nb, cu, cb = w.w1e.shape
    cup, bp = _pad16(cu), 16
    dt = torch.bfloat16

    def pad(t, *sizes):  # zero-pad the trailing dims to sizes
        pads = []
        for n, want in zip(reversed(t.shape), reversed(sizes)):
            pads += [0, want - n]
        return F.pad(t.to(dt), pads).contiguous()

    wu = w.wu.reshape(nb, NTAPS, cb, cb)  # (tap, in, out)
    out = dict(w1e=pad(w.w1e.transpose(1, 2), bp, cup), wuf=pad(wu.transpose(2, 3), bp, bp),
               wut=pad(wu, bp, bp), w3=pad(w.w3, bp, cup), w3t=pad(w.w3.transpose(1, 2), cup, bp),
               w1n=pad(w.w1e, cup, bp), be=w.be.to(dt).contiguous())
    if w.wc is not None:
        ccp = _pad16(w.wc.shape[1])
        out.update(wct=pad(w.wc.transpose(1, 2), bp, ccp), wcn=pad(w.wc, ccp, bp),
                   bc=w.bc.to(dt).contiguous())
    return out


def causal_stack_bwd(saves, gy, cond, keep, p, weights: UnionWeights):
    """The segment's backward on the card: one K4-backward launch per block,
    last block first (each adds one to ``causal_stack_bwd.launches``). saves
    (NB, B, s0, s1, s2, Cu) are the blocks' inputs, gy the cotangent of the
    segment's output. Returns what ``causal_stack_bwd_plain`` returns, the
    weight gradients as fp32 sums in the ``UnionWeights`` layouts. The route
    is ``conv3d.causal_bwd_tensor_core_route``'s: bf16 at the widths it takes
    runs ``_bwd_tensor_cores``, the rest the CUDA-core kernels below."""
    _check(gy, cond, keep, weights)
    nb, cu, cb = weights.w1e.shape
    b, s0, s1, s2, _ = gy.shape
    dt = saves.dtype
    nvox = b * s0 * s1 * s2
    cc = 0 if cond is None else cond.shape[-1]
    if causal_bwd_tensor_core_route(dt, cu, cb, cc):
        return _bwd_tensor_cores(saves, gy, cond, keep, p, weights)
    ob, ou = _cob(cb), _cob(cu)
    pk = pack_kernel_weights(weights, dt)
    w1t, wut, w3t, wct = pack_kernel_weights_t(weights, dt)
    gb, gu = -(-cb // ob), -(-cu // ou)
    nsv = 4 * gb + 4 * gu
    dev = gy.device
    f32 = dict(dtype=torch.float32, device=dev)
    work = torch.empty(nvox * (2 * cu + 5 * cb), dtype=dt, device=dev)
    gm = torch.empty(nvox * cb, **f32)
    sv = torch.empty(nvox * nsv, **f32)
    part_len = 2048 * max(NTAPS * cb * cb, cu * cb, cc * cb, nsv) + nsv  # 2048 chunks
    part = torch.empty(part_len, **f32)
    dw1, dbe = torch.empty(nb, cb, cu, **f32), torch.empty(nb, cb, **f32)
    dwu, dw3 = torch.empty(nb, NTAPS, cb, cb, **f32), torch.empty(nb, cu, cb, **f32)
    dwc, dbc = torch.empty(nb, cb, max(cc, 1), **f32), torch.empty(nb, cb, **f32)
    dsc = torch.empty(nb, 8, **f32)
    gcond = None if cond is None else torch.zeros_like(cond)
    condc = None if cond is None else cond.contiguous()
    keep = None if keep is None else keep.float().contiguous()
    g = gy.to(dt).contiguous()
    bufs = [torch.empty_like(g), torch.empty_like(g)]
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    for i, j in enumerate(reversed(range(nb))):
        dx = bufs[i % 2]
        _build.check(
            lib.vq_causal_block_bwd(
                int(dt == torch.bfloat16), saves[j].data_ptr(), g.data_ptr(), _ptr(condc),
                None if keep is None else keep[j].data_ptr(), 1.0 - p,
                pk.w1[j].data_ptr(), pk.be[j].data_ptr(), pk.wu[j].data_ptr(),
                pk.w3[j].data_ptr(), None if cond is None else pk.wc[j].data_ptr(),
                None if cond is None else pk.bc[j].data_ptr(), pk.sc[j].data_ptr(),
                w1t[j].data_ptr(), wut[j].data_ptr(), w3t[j].data_ptr(),
                None if cond is None else wct[j].data_ptr(),
                work.data_ptr(), gm.data_ptr(), sv.data_ptr(), part.data_ptr(), part_len,
                dx.data_ptr(), _ptr(gcond), dw1[j].data_ptr(), dbe[j].data_ptr(),
                dwu[j].data_ptr(), dw3[j].data_ptr(), dwc[j].data_ptr(), dbc[j].data_ptr(),
                dsc[j].data_ptr(), b, s0, s1, s2, cu, cb, cc, ob, ou,
                _cob(max(cc, 1)), stream,
            ),
            "causal_stack_bwd",
        )
        causal_stack_bwd.launches += 1
        g = dx
    return (g, gcond, *kernel_grads_to_union(dw1, dbe, dwu, dw3, dwc, dbc, dsc,
                                             cond is not None))


def _bwd_tensor_cores(saves, gy, cond, keep, p, weights: UnionWeights):
    """``causal_stack_bwd`` on the tensor-core route (bf16): one
    ``vq_causal_block_bwd_tc`` a block, last block first."""
    nb, cu, cb = weights.w1e.shape
    b, s0, s1, s2, _ = gy.shape
    nvox = b * s0 * s1 * s2
    cc = 0 if cond is None else cond.shape[-1]
    dev = gy.device
    pk = pack_bwd_tc_weights(weights)
    sc = weights.sc.float().contiguous()
    brick, ctas = bwd_plan(b, s0, s1, s2)
    part_len = max(n * length for n, length in zip(ctas, bwd_partial_lens(cu, cb, cc)))
    f32 = dict(dtype=torch.float32, device=dev)
    work = torch.empty(3 * nvox * 16, dtype=torch.bfloat16, device=dev)
    part = torch.empty(part_len, **f32)
    dw1, dbe = torch.empty(nb, cb, cu, **f32), torch.empty(nb, cb, **f32)
    dwu, dw3 = torch.empty(nb, NTAPS, cb, cb, **f32), torch.empty(nb, cu, cb, **f32)
    dwc, dbc = torch.empty(nb, cb, max(cc, 1), **f32), torch.empty(nb, cb, **f32)
    dsc = torch.empty(nb, 8, **f32)
    gcond = None if cond is None else torch.zeros_like(cond)
    condc = None if cond is None else cond.contiguous()
    keep = None if keep is None else keep.float().contiguous()
    g = gy.to(torch.bfloat16).contiguous()
    bufs = [torch.empty_like(g), torch.empty_like(g)]
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    cj = (lambda t, j: None) if cond is None else (lambda t, j: t[j].data_ptr())
    for i, j in enumerate(reversed(range(nb))):
        dx = bufs[i % 2]
        _build.check(
            lib.vq_causal_block_bwd_tc(
                saves[j].data_ptr(), g.data_ptr(), _ptr(condc),
                None if keep is None else keep[j].data_ptr(), 1.0 - p,
                *(pk[k][j].data_ptr() for k in ("w1e", "be", "wuf", "wut", "w3", "w3t")),
                cj(pk.get("wct"), j), cj(pk.get("bc"), j), cj(pk.get("wcn"), j),
                pk["w1n"][j].data_ptr(), sc[j].data_ptr(),
                work.data_ptr(), part.data_ptr(), part_len, *ctas, dx.data_ptr(), _ptr(gcond),
                dw1[j].data_ptr(), dbe[j].data_ptr(), dwu[j].data_ptr(), dw3[j].data_ptr(),
                dwc[j].data_ptr(), dbc[j].data_ptr(), dsc[j].data_ptr(),
                b, s0, s1, s2, cu, cb, cc, *brick, stream,
            ),
            "causal_stack_bwd",
        )
        causal_stack_bwd.launches += 1
        g = dx
    return (g, gcond, *kernel_grads_to_union(dw1, dbe, dwu, dw3, dwc, dbc, dsc,
                                             cond is not None))


def kernel_grads_to_union(dw1, dbe, dwu, dw3, dwc, dbc, dsc, has_cond: bool):
    """The backward kernel's stacked outputs -> the ``UnionWeights`` layouts:
    dW1e^T (NB, Cb, Cu), dWU (NB, 18, Cb_out, Cb_in), dW3^T (NB, Cu, Cb) and
    dwc^T (NB, Cb, Cc) transposed back; dwc, dbc dropped without a condition."""
    nb, _, cb = dw3.shape
    dwu = dwu.transpose(2, 3).reshape(nb, *UTAPS, cb, cb)
    return (dw1.transpose(1, 2), dbe, dwu, dw3.transpose(1, 2),
            dwc.transpose(1, 2) if has_cond else None, dbc if has_cond else None, dsc)


causal_stack_bwd.launches = 0


class _CausalStack(torch.autograd.Function):
    """The segment with its backward sweep (JAX ``_fwd_rule`` /
    ``_bwd_rule``, vqvae3d_tpu/ops/causal_kernel.py:605-686): the forward
    keeps every block's input, the backward recomputes each block from it."""

    @staticmethod
    def forward(ctx, x, cond, keep, p, *weights):
        w = UnionWeights(*weights)
        nb = w.sc.shape[0]
        saves = torch.empty((nb, *x.shape), dtype=x.dtype, device=x.device)
        if x.device.type == "cuda":
            y = _forward_cuda(x, cond, keep, p, w, saves=saves)
        else:
            cur = x
            for j in range(nb):
                saves[j].copy_(cur)
                cur = causal_block_plain(cur, cond, None if keep is None else keep[j], p,
                                         union_block(w, j))
            y = cur
        ctx.save_for_backward(saves, cond, keep, *weights)
        ctx.p = p
        return y

    @staticmethod
    def backward(ctx, gy):
        saves, cond, keep, *weights = ctx.saved_tensors
        w = UnionWeights(*weights)
        bwd = causal_stack_bwd_plain if saves.device.type == "cpu" else causal_stack_bwd
        dx, gcond, *dws = bwd(saves, gy, cond, keep, ctx.p, w)
        return (dx.to(gy.dtype), None if gcond is None else gcond.to(cond.dtype), None, None,
                *(None if g is None else g.to(t.dtype) for g, t in zip(dws, weights)))


def causal_stack_fused(x: torch.Tensor, cond: Optional[torch.Tensor],
                       keep: Optional[torch.Tensor], p: float,
                       weights: UnionWeights) -> torch.Tensor:
    """Run the NB-block mask-'B' segment on the union stream x (B, s0, s1,
    s2, 3C) channels-last, with the embedded condition cond (B, s0, s1, s2,
    Cc) or None and the dropout keep mask (NB, B, 3Cb) or None (p is its
    rate). Returns the segment's output in x's layout and dtype.

    When autograd needs a gradient of any input: the saving forward and the
    K4 backward (``_CausalStack``). Otherwise: CPU -> ``causal_stack_plain``;
    CUDA -> one K4 launch per block (fp32 or bf16), saving nothing. Any other
    device or dtype raises."""
    if weights.sc.shape[0] == 0:
        return x
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, cond, *weights)):
        return _CausalStack.apply(x, cond, keep, p, *weights)
    if x.device.type == "cpu":
        return causal_stack_plain(x, cond, keep, p, weights)
    return _forward_cuda(x, cond, keep, p, weights)


causal_stack_fused.launches = 0
