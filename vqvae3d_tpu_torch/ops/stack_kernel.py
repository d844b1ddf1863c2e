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
    (``csrc/preact_stack_bwd.cu``: in bf16 at the forward's tensor-core
    widths two brick kernels that share the forward's halo pass and conv
    tile, ``_bwd_bricks``; else five elementwise kernels), on a CPU tensor
    the autograd of the plain block (``preact_stack_bwd_plain``) — and
    returns the gradients of the stacked weights, through which autograd
    reaches each block's parameters.

Launches are counted on ``preact_stack_fused.launches`` (forward blocks) and
``preact_stack_bwd.launches`` (backward blocks). The kernels work on
channels-last copies; results are returned as (B, C, H, W, D) views in
``torch.channels_last_3d`` memory format.

The JAX package's resident/streaming/tiled variants and its s2d stack folds
(``stack_fold``) are TPU VMEM and 128-lane devices, not ported.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops import _build
from vqvae3d_tpu_torch.parallel import halo
from vqvae3d_tpu_torch.ops.conv3d import (conv3d, stack_bwd_brick_route,
                                          stack_bwd_tensor_core_route, stack_fwd_route)


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


def preact_stack_plain(x, w1s, w2s, w3s, sc8, *, pad_mode: str, fill=None):
    """The stack as a loop of the plain block; ``fill(x, 2)`` writes a slab
    buffer's halo rows before each block (``_on_slab``)."""
    with halo.suspended():
        for j in range(w1s.shape[0]):
            if fill is not None:
                fill(x, 2)
            x = preact_fixup_same(x, w1s[j], w2s[j], w3s[j], sc8[j], pad_mode=pad_mode)
    return x


def stack_halo_rows(pad_mode: str):
    """(lo, hi): the neighbour planes a slab's stack buffer holds below and
    above the slab, one a side, but none at a true end of the volume in
    'zeros' mode, where the kernel's own zero padding is the volume's (the
    conv pads a2, not the block input)."""
    first, last = halo.ends()
    wrap = pad_mode == "wrap"
    return int(wrap or not first), int(wrap or not last)


def _fill_halo(buf, dim: int, lo: int, hi: int) -> None:
    """Write the neighbouring slabs' edge planes into the halo rows of a
    stack buffer (H at ``dim``; the slab's rows lo .. n - hi - 1), in
    place. Every rank of the space group calls it (one exchange)."""
    n = buf.shape[dim]
    below, above = halo.swap_edges(buf.select(dim, lo), buf.select(dim, n - hi - 1))
    if lo:
        buf.select(dim, 0).copy_(below)
    if hi:
        buf.select(dim, n - 1).copy_(above)


def _fold_halo(buf, dim: int, lo: int, hi: int) -> None:
    """The backward of ``_fill_halo`` on a cotangent buffer, in place: send
    the halo rows' cotangents to the slabs that own those rows, add theirs
    to this slab's edge rows, then zero the halo rows (the next block's
    backward takes a cotangent that is zero there)."""
    n = buf.shape[dim]
    below, above = buf.select(dim, 0), buf.select(dim, n - 1)
    from_prev, from_next = halo.swap_edges(below if lo else torch.zeros_like(below),
                                           above if hi else torch.zeros_like(above))
    if lo:
        buf.select(dim, lo).add_(from_prev)
        below.zero_()
    if hi:
        buf.select(dim, n - hi - 1).add_(from_next)
        above.zero_()


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


FUSED_BRICK_VOXELS = {"fused_tc": 128, "fused_cc": 256}  # csrc/preact_stack.cu kTcVox, kCcVox


def fused_voxels(route: str, cbp: int, nvox: int) -> int:
    """The fused kernel's brick size for blocks of ``nvox`` voxels:
    ``FUSED_BRICK_VOXELS``, on blocks of at least 2^15 voxels doubled on the
    tensor cores at CBP <= 32 (two m-tiles a warp: 2.5 halo rows a voxel at
    4x4x16 instead of 3.4 at 2x4x16) and quadrupled on the CUDA cores (four
    voxels a thread: 1.8 halo rows a voxel at 8x8x16)."""
    base = FUSED_BRICK_VOXELS[route]
    if nvox < 1 << 15:
        return base
    return 4 * base if route == "fused_cc" else 2 * base if cbp <= 32 else base


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def fused_brick(h: int, w: int, d: int, voxels: int):
    """The brick (bh, bw, bd) of the fused forward, ``voxels`` output voxels
    (a power of 2): d up to 16 (the grid's d rounded up to a power of 2),
    then w about the square root of the rest (at most w rounded up), h the
    rest, so that the one-voxel halo stays small."""
    bd = min(16, _pow2_at_least(d), voxels)
    rest = voxels // bd
    bw = min(_pow2_at_least(math.isqrt(rest - 1) + 1), _pow2_at_least(w), rest)
    return rest // bw, bw, bd


def fused_cbp(route: str, cb: int) -> int:
    """Cb as the fused kernel pads it: to a multiple of 16 (the mma's k) on
    the tensor cores, to 1, 2 or 4 on the CUDA cores."""
    return -(-cb // 16) * 16 if route == "fused_tc" else _cob(cb)


def pack_fused_weights(w1s, w2s, w3s, route: str):
    """Reference-layout stack weights -> the fused kernel's bf16 layouts, each
    [N][K] with k contiguous and zero-padded: w1 (NB, CBP, K1) (conv1, K1 =
    C rounded up to 16 on the tensor cores, else C), w2 (NB, 27, CBP, CBP)
    (tap = (kh * 3 + kw) * 3 + kd, out, in), w3 (NB, N3, CBP) (N3 = C rounded
    up to 8 on the tensor cores, else C)."""
    nb, cb, c = w1s.shape[:3]
    cbp = fused_cbp(route, cb)
    k1 = -(-c // 16) * 16 if route == "fused_tc" else c
    n3 = -(-c // 8) * 8 if route == "fused_tc" else c
    dt = torch.bfloat16
    w1 = F.pad(w1s.reshape(nb, cb, c).to(dt), (0, k1 - c, 0, cbp - cb))
    w2 = F.pad(w2s.reshape(nb, cb, cb, 27).permute(0, 3, 1, 2).to(dt),
               (0, cbp - cb, 0, cbp - cb))
    w3 = F.pad(w3s.reshape(nb, c, cb).to(dt), (0, cbp - cb, 0, n3 - c))
    return w1.contiguous(), w2.contiguous(), w3.contiguous()


def pack_brick_bwd_weights(w1s, w2s, w3s):
    """The backward brick kernels' bf16 packs, each [N][K] (k contiguous,
    zero-padded; Cb to CBP as ``fused_cbp``, C to K1 = 16 or N3 = 8 as
    ``pack_fused_weights``): the forward's w1 (NB, CBP, K1), w2 (NB, 27, CBP,
    CBP), w3 (NB, N3, CBP); w3t (NB, CBP, K1) (W3^T: ga3 = W3^T gu3); w2m
    (NB, 27, CBP, CBP), the transposed conv's taps, tap' = 26 - tap (the
    mirrored offset) with in and out swapped; w1n (NB, N3, CBP) (W1^T:
    ga1 = W1^T gt2)."""
    nb, cb, c = w1s.shape[:3]
    cbp = fused_cbp("fused_tc", cb)
    k1, n3 = -(-c // 16) * 16, -(-c // 8) * 8
    dt = torch.bfloat16
    w1, w2, w3 = pack_fused_weights(w1s, w2s, w3s, "fused_tc")
    w3t = F.pad(w3s.reshape(nb, c, cb).transpose(1, 2).to(dt), (0, k1 - c, 0, cbp - cb))
    # (NB, out, in, 27) -> taps mirrored -> (NB, tap', in, out)
    w2m = F.pad(w2s.reshape(nb, cb, cb, 27).flip(-1).permute(0, 3, 2, 1).to(dt),
                (0, cbp - cb, 0, cbp - cb))
    w1n = F.pad(w1s.reshape(nb, cb, c).transpose(1, 2).to(dt), (0, cbp - cb, 0, n3 - c))
    return dict(w1=w1, w2=w2, w3=w3, w3t=w3t.contiguous(), w2m=w2m.contiguous(),
                w1n=w1n.contiguous())


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


def _forward_cuda(x, w1s, w2s, w3s, sc8, pad_mode, saves=None, fill=None):
    """K3 forward over the stack, on ``conv3d.stack_fwd_route``'s route.
    Without ``saves`` the activations ping-pong between two buffers; with
    ``saves`` (NB, B, H, W, D, C) block j reads saves[j] and writes saves[j +
    1] (the last block a fresh buffer). ``fill(buf, 1)`` writes a slab
    buffer's halo rows before each launch (``_on_slab``)."""
    _check(x, w1s, w2s, w3s, sc8, pad_mode)
    nb = w1s.shape[0]
    b, c, h, w, d = x.shape
    cb = w1s.shape[1]
    route = stack_fwd_route(x.dtype, cb)
    fused = route != "three_kernels"
    if fused:
        w1p, w2p, w3p = pack_fused_weights(w1s, w2s, w3s, route)
        brick = fused_brick(h, w, d, fused_voxels(route, fused_cbp(route, cb), b * h * w * d))
    else:
        w1p, w2p, w3p = pack_stack_weights(w1s, w2s, w3s, x.dtype)
        a2 = torch.empty((b, h, w, d, cb), dtype=x.dtype, device=x.device)
        a3 = torch.empty_like(a2)
    sc = sc8.float().contiguous()
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
        if fill is not None:
            fill(cur, 1)
        if fused:
            err = lib.vq_preact_block_fwd_fused(
                cur.data_ptr(), w1p[j].data_ptr(), w2p[j].data_ptr(), w3p[j].data_ptr(),
                sc[j].data_ptr(), outs[j].data_ptr(), b, h, w, d, c, cb, fused_cbp(route, cb),
                int(route == "fused_tc"), int(pad_mode == "wrap"), *brick, stream)
        else:
            err = lib.vq_preact_block_fwd(
                is_bf16, cur.data_ptr(), w1p[j].data_ptr(), w2p[j].data_ptr(),
                w3p[j].data_ptr(), sc[j].data_ptr(), a2.data_ptr(), a3.data_ptr(),
                outs[j].data_ptr(), b, h, w, d, c, cb, _cob(cb), _cob(c),
                int(pad_mode == "wrap"), stream)
        _build.check(err, "preact_stack_fused")
        preact_stack_fused.launches += 1
        cur = outs[j]
    return cur.permute(0, 4, 1, 2, 3)


def preact_stack_bwd_plain(saves, gy, w1s, w2s, w3s, sc8, pad_mode, fold=None):
    """The stack's backward by the autograd of the plain block, block by
    block in reverse, each recomputed from its saved input (saves[j],
    channels-last); ``fold(g, 2)`` passes a slab buffer's halo cotangents
    on after each block (``_on_slab``). Returns (dx, dw1s, dw2s, dw3s,
    dsc8)."""
    grads = []
    g = gy
    with torch.enable_grad(), halo.suspended():
        for j in reversed(range(w1s.shape[0])):
            xj = saves[j].permute(0, 4, 1, 2, 3).detach().requires_grad_()
            ws = [t[j].detach().requires_grad_() for t in (w1s, w2s, w3s, sc8)]
            y = preact_fixup_same(xj, *ws, pad_mode=pad_mode)
            g, *gw = torch.autograd.grad(y, [xj, *ws], g)
            if fold is not None:
                fold(g, 2)
            grads.append(gw)
    return (g, *(torch.stack(t[::-1]) for t in zip(*grads)))


TC_BRICK = (4, 4, 16)  # the bricks of the backward's tensor-core dW2 (csrc/preact_stack_bwd.cu)
TC_FLAT_BRICK = 256  # consecutive voxels of a dW1 / dW3 brick
TC_TILE = 32  # channels of a CTA's tile per operand, at most
TC_CTAS = 528  # CTAs of a tensor-core contraction at most: 4 on each of an H100's 132 SMs


def contract_chunks(n_bricks: int, p: int, q: int) -> int:
    """CTAs per channel tile of a tensor-core contraction out[t][p][q] over
    ``n_bricks`` bricks, a function of the shapes only (so repeats are
    bit-identical): one per brick, at most ``TC_CTAS`` over all tiles of at
    most ``TC_TILE`` x ``TC_TILE`` channels."""
    tiles = math.ceil(p / TC_TILE) * math.ceil(q / TC_TILE)
    return max(1, min(n_bricks, TC_CTAS // tiles))


def contract_plan(b: int, h: int, w: int, d: int, c: int, cb: int):
    """The tensor-core route's (chunks of dW1, dW2, dW3) for one block and
    the partial floats they need."""
    flat = math.ceil(b * h * w * d / TC_FLAT_BRICK)
    bricks = b * math.prod(math.ceil(n / t) for n, t in zip((h, w, d), TC_BRICK))
    chunks = (contract_chunks(flat, cb, c), contract_chunks(bricks, cb, cb),
              contract_chunks(flat, c, cb))
    need = max(chunks[0] * cb * c, chunks[1] * 27 * cb * cb, chunks[2] * c * cb)
    return chunks, need


def preact_stack_bwd(saves, gy, w1s, w2s, w3s, sc8, pad_mode, fold=None):
    """The stack's backward on the card: one K3-backward launch per block,
    last block first (each adds one to ``preact_stack_bwd.launches``).
    saves (NB, B, H, W, D, C) are the blocks' inputs, gy the cotangent of the
    stack output. Returns (dx, dw1s, dw2s, dw3s, dsc8), the weight gradients
    as fp32 sums in the reference layouts. The elementwise half takes the
    brick kernels (``_bwd_bricks``) where ``conv3d.stack_bwd_brick_route``
    says so, else the five elementwise kernels; the weight contractions take
    the tensor cores in bf16 and the CUDA cores in fp32
    (``conv3d.stack_bwd_tensor_core_route``). ``fold(dx, 1)`` passes a
    slab buffer's halo cotangents on after each block (``_on_slab``)."""
    _check(gy, w1s, w2s, w3s, sc8, pad_mode)
    nb, cb, c = w1s.shape[:3]
    b, _, h, w, d = gy.shape
    dt = saves.dtype
    if stack_bwd_brick_route(dt, cb):
        return _bwd_bricks(saves, gy, w1s, w2s, w3s, sc8, pad_mode, fold)
    nvox = b * h * w * d
    w1p, w2p, w3p = pack_stack_weights(w1s, w2s, w3s, dt)
    w1t, w2t, w3t = pack_stack_weights_t(w1s, w2s, w3s, dt)
    sc = sc8.float().contiguous()
    gb, gc = -(-cb // _cob(cb)), -(-c // _cob(c))
    nsv = 4 * gb + 4 * gc
    work = torch.empty(nvox * (2 * c + 5 * cb), dtype=dt, device=gy.device)
    sv = torch.empty(nvox * nsv, dtype=torch.float32, device=gy.device)
    tensor_cores = stack_bwd_tensor_core_route(dt)
    chunks, need = contract_plan(b, h, w, d, c, cb) if tensor_cores else ((0, 0, 0), 0)
    part_len = max(2**20, 27 * cb * cb, c * cb, need) + nsv
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
                int(dt == torch.bfloat16), int(tensor_cores), saves[j].data_ptr(), g.data_ptr(),
                w1p[j].data_ptr(), w2p[j].data_ptr(), w3p[j].data_ptr(),
                w1t[j].data_ptr(), w2t[j].data_ptr(), w3t[j].data_ptr(), sc[j].data_ptr(),
                work.data_ptr(), sv.data_ptr(), part.data_ptr(), part_len, *chunks, dx.data_ptr(),
                dw1[j].data_ptr(), dw2[j].data_ptr(), dw3[j].data_ptr(), dsc[j].data_ptr(),
                b, h, w, d, c, cb, _cob(cb), _cob(c), int(pad_mode == "wrap"), stream,
            ),
            "preact_stack_bwd",
        )
        preact_stack_bwd.launches += 1
        if fold is not None:
            fold(dx, 1)
        g = dx
    # (NB, 27, Cb_out, Cb_in) with tap = (kh*3 + kw)*3 + kd -> (NB, Cb_out, Cb_in, 3, 3, 3)
    dw2 = dw2.permute(0, 2, 3, 1).reshape(nb, cb, cb, 3, 3, 3)
    return (g.permute(0, 4, 1, 2, 3), dw1.reshape(w1s.shape), dw2, dw3.reshape(w3s.shape), dsc)


def _bwd_bricks(saves, gy, w1s, w2s, w3s, sc8, pad_mode, fold=None):
    """``preact_stack_bwd`` on the brick route (bf16): one
    ``vq_preact_block_bwd_brick`` a block, last block first, on the forward's
    bricks (``fused_brick`` at ``fused_voxels``); the contractions on the
    tensor cores as on the other bf16 route."""
    nb, cb, c = w1s.shape[:3]
    b, _, h, w, d = gy.shape
    nvox = b * h * w * d
    cbp = fused_cbp("fused_tc", cb)
    brick = fused_brick(h, w, d, fused_voxels("fused_tc", cbp, nvox))
    bricks = b * math.prod(-(-n // t) for n, t in zip((h, w, d), brick))
    pk = pack_brick_bwd_weights(w1s, w2s, w3s)
    sc = sc8.float().contiguous()
    dev = gy.device
    work = torch.empty(nvox * (2 * c + 5 * cb), dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    sp = torch.empty(bricks * 8, **f32)
    chunks, need = contract_plan(b, h, w, d, c, cb)
    part = torch.empty(need, **f32)
    dw1, dw2 = torch.empty(nb, cb, c, **f32), torch.empty(nb, 27, cb, cb, **f32)
    dw3, dsc = torch.empty(nb, c, cb, **f32), torch.empty(nb, 8, **f32)
    g = gy.to(torch.bfloat16).permute(0, 2, 3, 4, 1).contiguous()
    bufs = [torch.empty_like(g), torch.empty_like(g)]
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    for i, j in enumerate(reversed(range(nb))):
        dx = bufs[i % 2]
        _build.check(
            lib.vq_preact_block_bwd_brick(
                saves[j].data_ptr(), g.data_ptr(),
                *(pk[k][j].data_ptr() for k in ("w1", "w2", "w3", "w3t", "w2m", "w1n")),
                sc[j].data_ptr(), work.data_ptr(), sp.data_ptr(), part.data_ptr(), need, *chunks,
                dx.data_ptr(), dw1[j].data_ptr(), dw2[j].data_ptr(), dw3[j].data_ptr(),
                dsc[j].data_ptr(), b, h, w, d, c, cb, cbp, int(pad_mode == "wrap"), *brick,
                stream,
            ),
            "preact_stack_bwd",
        )
        preact_stack_bwd.launches += 1
        if fold is not None:
            fold(dx, 1)
        g = dx
    dw2 = dw2.permute(0, 2, 3, 1).reshape(nb, cb, cb, 3, 3, 3)
    return (g.permute(0, 4, 1, 2, 3), dw1.reshape(w1s.shape), dw2, dw3.reshape(w3s.shape), dsc)


preact_stack_bwd.launches = 0


class _PreactStack(torch.autograd.Function):
    """The stack with its backward sweep (JAX ``_fwd_rule`` / ``_bwd_rule``,
    vqvae3d_tpu/ops/stack_kernel.py:1107-1249): the forward keeps every
    block's input, the backward recomputes each block from it."""

    @staticmethod
    def forward(ctx, x, w1s, w2s, w3s, sc8, pad_mode, rows=None):
        nb = w1s.shape[0]
        b, c, h, w, d = x.shape
        fill = None if rows is None else functools.partial(_fill_halo, lo=rows[0], hi=rows[1])
        saves = torch.empty((nb, b, h, w, d, c), dtype=x.dtype, device=x.device)
        if x.device.type == "cuda":
            y = _forward_cuda(x, w1s, w2s, w3s, sc8, pad_mode, saves=saves, fill=fill)
        else:
            cur = x
            with halo.suspended():
                for j in range(nb):
                    saves[j].copy_(cur.permute(0, 2, 3, 4, 1))
                    if fill is not None:
                        fill(saves[j], 1)
                        cur = saves[j].permute(0, 4, 1, 2, 3)
                    cur = preact_fixup_same(cur, w1s[j], w2s[j], w3s[j], sc8[j],
                                            pad_mode=pad_mode)
            y = cur
        ctx.save_for_backward(saves, w1s, w2s, w3s, sc8)
        ctx.pad_mode, ctx.rows = pad_mode, rows
        return y

    @staticmethod
    def backward(ctx, gy):
        saves, w1s, w2s, w3s, sc8 = ctx.saved_tensors
        bwd = preact_stack_bwd_plain if saves.device.type == "cpu" else preact_stack_bwd
        fold = (None if ctx.rows is None else
                functools.partial(_fold_halo, lo=ctx.rows[0], hi=ctx.rows[1]))
        dx, dw1, dw2, dw3, dsc = bwd(saves, gy, w1s, w2s, w3s, sc8, ctx.pad_mode, fold)
        return (dx.to(gy.dtype), dw1.to(w1s.dtype), dw2.to(w2s.dtype), dw3.to(w3s.dtype),
                dsc.to(sc8.dtype), None, None)


def preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode: str):
    """Run an NB-block 'same' stack on x (B, C, H, W, D).

    When autograd needs a gradient of any input: the saving forward and the
    K3 backward (``_PreactStack``). Otherwise: CPU -> ``preact_stack_plain``;
    CUDA -> one K3 launch per block (fp32 or bf16 activations), saving
    nothing. Under a space group x is an H slab (``_on_slab``). Any other
    device or dtype raises."""
    if w1s.shape[0] == 0:
        return x
    if halo.active():
        return _on_slab(x, w1s, w2s, w3s, sc8, pad_mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1s, w2s, w3s, sc8)):
        return _PreactStack.apply(x, w1s, w2s, w3s, sc8, pad_mode)
    if x.device.type == "cpu":
        return preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode)
    return _forward_cuda(x, w1s, w2s, w3s, sc8, pad_mode)


preact_stack_fused.launches = 0


def _on_slab(x, w1s, w2s, w3s, sc8, pad_mode):
    """The stack on an H slab of (B, C, H/s, W, D): the slab in a buffer of
    lo + H/s + hi rows (``stack_halo_rows``) whose halo rows hold the
    neighbouring slabs' edge planes of each block's input, written before
    each block (``_fill_halo``); the unchanged per-block step (K3 on a card)
    runs over the whole buffer in either pad mode. The slab's rows are then
    exact: only the halo rows read a wrapped or zero row, and the next
    exchange overwrites them. The backward takes a cotangent that is zero
    on the halo rows; each block's dx there is the neighbours' share, sent
    to them and added to their edge rows (``_fold_halo``). gt3 is zero on
    the halo rows, so the weight gradients, summed over the space group by
    the gradient all-reduce, count every (row, cotangent) pair once."""
    lo, hi = stack_halo_rows(pad_mode)
    xp = F.pad(x, (0, 0, 0, 0, lo, hi))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1s, w2s, w3s, sc8)):
        y = _PreactStack.apply(xp, w1s, w2s, w3s, sc8, pad_mode, (lo, hi))
    else:
        fill = functools.partial(_fill_halo, lo=lo, hi=hi)
        y = (preact_stack_plain(xp, w1s, w2s, w3s, sc8, pad_mode=pad_mode, fill=fill)
             if x.device.type == "cpu" else
             _forward_cuda(xp, w1s, w2s, w3s, sc8, pad_mode, fill=fill))
    return y.narrow(2, lo, x.shape[2])
