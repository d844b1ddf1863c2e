"""One row of cached PixelCNN sampling: kernel K6 and its plain version.

Counterpart of ``vqvae3d_tpu/ops/decode_row.py`` (Pallas ``row_decode``,
``_row_kernel``). A row (fixed s0-slice i0 and s1-row i1, all s2 voxels) is
sampled in two phases:

  * phase 1, the height-row step, vectorised over the row's s2 positions:
    the height stream restricted to row i1 is a function of the previous
    row's ``parse_input`` embedding, each layer's cached post-activation
    v-row of row i1-1 and the depth stream's d2h injections at this row. It
    yields every layer's h2w injection and the height stream's final row,
    and it writes each layer's new v-row into the caches.
  * phase 2, the voxel chain: each voxel in order through all L layers of
    the width stream (1x1x1 contractions and the ws-tap width conv over
    per-layer tap caches, fed by d2w and h2w), then the logits and the
    sample ``argmax(logits / tau + gumbel)`` (lowest index on ties); the
    sampled code's ``parse_input`` row feeds the next voxel's layer 0.

``stack_row_weights`` stacks the per-layer weights into (L, ...) tensors
(mask-'A' width taps front-padded with zero taps to the widest). Unlike the
TPU layout, which packs [w3·scale ; skip] into one matrix with an identity
skip for every mask-'B' layer, the residual is added directly and only
layer 0's skip conv is kept.

``row_decode`` is the dispatcher: on CUDA tensors it launches K6, picking
the kernel from the widths before the launch (``uses_wide_kernel``): the
narrow ``csrc/row_decode.cu`` (C <= 32, br <= 8: the top prior), counted on
``row_decode.launches``, or the wide ``csrc/row_decode_wide.cu`` (the 256-
and 512-wide mid and bottom priors: one cluster of ``WIDE_CLUSTER``
CTAs per row call, the height-row step split by batch rows and the voxel
chain by output columns for all batch rows; ``wide_row_decode`` pads C and
br to multiples of 4 and runs a batch whose state does not fit a CTA's
shared memory as consecutive sub-batches), counted on
``row_decode.wide_launches`` (one per sub-batch);
on CPU tensors it runs ``row_decode_plain``, which computes the same contract
op by op; any other device raises. Both update the height v-row caches ``vhc`` IN
PLACE and also return them.

Contract (fp32 throughout; B batch, s2 row length, C model width, br the
bottleneck width, K codes, L layers):
  d2h_row, d2w_row, cnd_row (L, B, s2, br) (cnd_row None when unconditioned);
  dfin_row (B, s2, C) the depth stream's final row; sprev_row (B, s2, C) the
  previous row's parse_input embedding (zeros at i1 = 0); vhc (L, B, s2, br);
  gumbel (s2, B, K); i1 the row index; tau the temperature;
  forced_idx (B, s2) int: teacher-force the row and also return its logits.
Returns (B, s2) int32 indices and vhc — plus (B, s2, K) logits when forced.
Free-running, a voxel whose logits are not all finite gets index -1 (the
next voxel then reads code 0's embedding); the sampler reports it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from vqvae3d_tpu_torch.ops import _build

f32 = torch.float32


def _k1(w: torch.Tensor) -> torch.Tensor:
    """A 1x1x1 conv weight (O, I, 1, 1, 1) as an (I, O) matrix."""
    return w.detach()[:, :, 0, 0, 0].t().float()


def stack_row_weights(layers, w_in, b_in, w_out, b_out) -> Dict[str, torch.Tensor]:
    """Stack the per-layer width and height weights of the sampler's layer
    views (``sample.cached_sample._extract_layers``) into the row function's
    (L, ...) operands. ``w_in``/``b_in``: ``parse_input`` weight (C, K, 1, 1,
    1) and bias; ``w_out``/``b_out``: ``parse_output`` weight (K, C, 1, 1, 1)
    and bias.

    A layer's output is ``w3v @ w3 + b3`` plus its residual: the input itself
    for a layer without a skip conv, else ``sk_in @ skw + skip bias`` (the
    skip bias is folded into ``b3``). Only layer 0 (mask 'A') may have a skip
    conv; ``skw``/``hskw`` hold its (C, C) weights and are absent without
    one."""
    if any(lp.skip is not None for lp in layers[1:]):
        raise NotImplementedError("row_decode: a skip conv past layer 0 (a width change)")
    w1 = torch.stack([_k1(lp.c1["width_conv"]) for lp in layers])
    # width conv taps (O, I, 1, 1, ws) -> (ws, I, O); a layer with fewer taps
    # is front-padded with zero taps, which multiply the never-written slot
    kws = [lp.c2["width_conv"][:, :, 0, 0, :].permute(2, 1, 0).float() for lp in layers]
    ws_max = max(w.shape[0] for w in kws)
    wk = torch.stack([F.pad(w, (0, 0, 0, 0, ws_max - w.shape[0], 0)) for w in kws])
    sc = torch.stack([torch.stack([lp.s[n] for n in ("1a", "1b", "2a", "2b", "3a", "3b", "4")]
                                  + [lp.scale]) for lp in layers]).float()
    scale = sc[:, 7][:, None, None]
    b4 = sc[:, 6][:, None].expand(-1, w_in.shape[0])
    l0_skip = layers[0].skip is not None

    def out_proj(stream):
        w3 = torch.stack([_k1(lp.c3[stream]) for lp in layers]) * scale
        b3 = b4.clone()
        if l0_skip:
            b3[0] += layers[0].skip[stream][1].float()
        return w3, b3

    st = dict(
        w1=w1, wk=wk, sc=sc,
        hw1=torch.stack([_k1(lp.c1["height_conv"]) for lp in layers]),
        herf=torch.stack([_k1(lp.erf_h[0]) for lp in layers]),
        herfb=torch.stack([lp.erf_h[1].float() for lp in layers]),
        # height conv (O, I, 1, 2, 3) -> (2 rows, 3 taps, I, O)
        hwk=torch.stack([lp.c2["height_conv"][:, :, 0].permute(2, 3, 1, 0).float()
                         for lp in layers]),
        w_in=_k1(w_in), b_in=b_in.detach().float(), w_out=_k1(w_out),
        b_out=b_out.detach().float(),
    )
    st["w3"], st["b3"] = out_proj("width_conv")
    st["hw3"], st["hb3"] = out_proj("height_conv")
    if l0_skip:
        st["skw"] = _k1(layers[0].skip["width_conv"][0])
        st["hskw"] = _k1(layers[0].skip["height_conv"][0])
    return {k: v.contiguous() for k, v in st.items()}


def _shift_s2(p: torch.Tensor, d: int) -> torch.Tensor:
    """out[:, s] = p[:, s + d] with zero fill; s2 is dim 1 of (B, s2, X)."""
    if d == 0:
        return p
    z = torch.zeros_like(p[:, : abs(d)])
    if d > 0:
        return torch.cat([p[:, d:], z], 1)
    return torch.cat([z, p[:, :d]], 1)


def row_decode_plain(st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel,
                     i1: int, tau: float, forced_idx: Optional[torch.Tensor] = None):
    """The row contract computed op by op (the module docstring)."""
    L, B, s2, br = d2w_row.shape
    C = dfin_row.shape[-1]
    ws = st["wk"].shape[1]
    sc = st["sc"].tolist()
    if cnd_row is None:
        cnd_row = torch.zeros_like(d2w_row)
    l0_skip = "skw" in st
    b_in = st["b_in"]

    # ---- phase 1: the height-row step, vectorised over s2
    hw = torch.empty_like(d2w_row)
    h = b_in.expand(B, s2, C)  # parse_input of the unsampled row
    for li in range(L):
        a = sc[li]
        if li == 0:
            u = F.elu(sprev_row + a[0]) + a[1]
            if i1 == 0:
                u = torch.zeros_like(u)
        else:
            u = F.elu(h + a[0]) + a[1]
        tp = u @ st["hw1"][li]
        hw[li] = tp @ st["herf"][li] + st["herfb"][li]
        v = F.elu(tp + d2h_row[li] + a[2]) + a[3]
        b2 = torch.zeros_like(v)
        for j1 in range(3):
            p = vhc[li] @ st["hwk"][li, 0, j1] + v @ st["hwk"][li, 1, j1]
            b2 = b2 + _shift_s2(p, j1 - 1)
        vhc[li] = v
        w3v = F.elu(b2 + cnd_row[li] + a[4]) + a[5]
        h = w3v @ st["hw3"][li] + st["hb3"][li] + (
            sprev_row @ st["hskw"] if li == 0 and l0_skip else h)
    hfin = h

    # ---- phase 2: the voxel chain and the samples
    vc = torch.zeros(L, B, max(ws - 1, 1), br, dtype=f32, device=d2w_row.device)
    s_prev = torch.zeros(B, C, dtype=f32, device=d2w_row.device)
    idx_all = torch.empty(B, s2, dtype=torch.int32, device=d2w_row.device)
    logits_all = []
    for i2 in range(s2):
        w = b_in.expand(B, C)  # parse_input of the unsampled voxel
        for li in range(L):
            a = sc[li]
            u = F.elu((s_prev if li == 0 else w) + a[0]) + a[1]
            if li == 0 and i2 == 0:
                u = torch.zeros_like(u)
            t = u @ st["w1"][li] + d2w_row[li, :, i2] + hw[li, :, i2]
            v = F.elu(t + a[2]) + a[3]
            taps = torch.cat([vc[li, :, s] for s in range(ws - 1)] + [v], -1)
            b2 = taps @ st["wk"][li].reshape(ws * br, br)
            if ws > 1:
                vc[li] = torch.cat([vc[li, :, 1:ws - 1], v[:, None]], 1)
            w3v = F.elu(b2 + cnd_row[li, :, i2] + a[4]) + a[5]
            w = w3v @ st["w3"][li] + st["b3"][li] + (
                s_prev @ st["skw"] if li == 0 and l0_skip else w)
        total = dfin_row[:, i2] + hfin[:, i2] + w
        logits = total @ st["w_out"] + st["b_out"]
        if forced_idx is not None:
            logits_all.append(logits)
            idx = forced_idx[:, i2].long()
        else:
            idx = torch.argmax(logits / tau + gumbel[i2], dim=-1)
            idx = torch.where(torch.isfinite(logits).all(-1), idx, -1)
        idx_all[:, i2] = idx
        s_prev = st["w_in"][idx.clamp(min=0)] + b_in
    if forced_idx is not None:
        return idx_all, vhc, torch.stack(logits_all, 1)
    return idx_all, vhc


def sampling_disagreements(logits, gumbel, tau: float, idx, rel: float = 1e-5):
    """Where a row's indices ``idx`` (B, s2) are not the argmax of
    logits / tau + gumbel, with ``logits`` (B, s2, K) computed along ``idx``
    (teacher-forced) and ``gumbel`` (s2, B, K): (near ties, beyond). A near
    tie is a voxel whose chosen z is within rel x max|z| of the largest z: a
    flip that fp32 sums in another order can cause."""
    z = logits / tau + gumbel.transpose(0, 1)
    zi = z.gather(-1, idx.long()[..., None])[..., 0]
    bad = z.argmax(-1) != idx
    tie = bad & (z.amax(-1) - zi <= rel * z.abs().amax(-1))
    return int(tie.sum()), int((bad & ~tie).sum())


def uses_wide_kernel(C: int, br: int, K: int, s2: int) -> bool:
    """Whether a row of these widths runs the wide kernel: the narrow one
    (weights in shared memory, one warp on the voxel chain) takes C <= 32,
    br <= 8, K <= 512 and s2 <= 256."""
    return not (C <= 32 and br <= 8 and K <= 512 and s2 <= 256)


WIDE_CLUSTER = 16  # CTAs a cluster of the wide kernel (csrc/row_decode_wide.cu kCluster)
WIDE_THREADS = 256  # threads a CTA of the wide kernel (csrc/row_decode_wide.cu NT)


WIDE_MBARS = 5  # phase 2's mbarriers (csrc/row_decode_wide.cu kMbars)
# the shared memory a CTA may opt in to on the sm_90a cards (H100, H200:
# 232,448 bytes); the C entry point reads the card's own limit and refuses a
# row above it
WIDE_SMEM_OPTIN = 232448


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def wide_layout_bytes(L: int, B: int, s2: int, C: int, br: int, K: int,
                      n: int = WIDE_CLUSTER) -> int:
    """The shared memory a CTA of the wide kernel needs for a row call, in
    bytes: a transcription of ``layout()`` in csrc/row_decode_wide.cu (its
    persistent state, then the larger of phase 1's and phase 2's buffers)."""
    jb, jc, jk = -(-br // n), -(-C // n), -(-K // n)
    jb4, jc4, jk4 = _align4(jb), _align4(jc), _align4(jk)
    r, rl = B * s2, -(-B // n) * s2
    base = (L * r * jb4 + r * jc4 + B * jc4 + _align4(8 * L)
            + max(2 * B * jb4, B * jk4, B * jc4) + _align4(2 * WIDE_MBARS))
    phase1 = 2 * rl * C + 4 * rl * br + rl * max(C, br) + rl * 6 * br
    phase2 = (L * B * jb4 + _align4(B * C) + 2 * _align4(B * br) + C * jb4 + 2 * br * jb4
              + br * jc4 + jc4 + 4 * B * jb4 + B * max(jc4, jb4) + jc4 + n * B * 4
              + _align4(2 * B) + 2 * B * jk4)
    return 4 * (base + max(phase1, phase2))


@functools.lru_cache(maxsize=256)
def wide_row_batches(L: int, B: int, s2: int, C: int, br: int, K: int,
                     limit: int = WIDE_SMEM_OPTIN):
    """The sub-batches [(b0, b1), ...] a wide row call of B batch rows runs
    as, consecutive and in order: each as large as fits ``limit`` bytes of
    shared memory (``wide_layout_bytes``) and a CTA's ``WIDE_THREADS``
    threads, the last one what is left. A row that does not fit even at
    B = 1 stays one call, which the kernel's entry point refuses."""
    if wide_layout_bytes(L, 1, s2, C, br, K) > limit:
        return ((0, B),)
    step = min(B, WIDE_THREADS)
    while wide_layout_bytes(L, step, s2, C, br, K) > limit:
        step -= 1
    return tuple((b0, min(b0 + step, B)) for b0 in range(0, B, step))


# each row operand's axes: C and b (br) are padded to multiples of 4 for the
# wide kernel, whose rows are read as float4; the others stay
_WIDE_AXES = {"w1": "LCb", "wk": "Lwbb", "w3": "LbC", "b3": "LC", "sc": "L8", "hw1": "LCb",
              "herf": "Lbb", "herfb": "Lb", "hwk": "L23bb", "hw3": "LbC", "hb3": "LC",
              "w_in": "KC", "b_in": "C", "w_out": "CK", "b_out": "K", "skw": "CC",
              "hskw": "CC", "d2h_row": "LBsb", "d2w_row": "LBsb", "cnd_row": "LBsb",
              "vhc": "LBsb", "dfin_row": "BsC", "sprev_row": "BsC"}


def _pad_axes(t: torch.Tensor, axes: str, cp: int, brp: int) -> torch.Tensor:
    pads = []
    for a, n in zip(reversed(axes), reversed(t.shape)):
        pads += [0, {"C": cp, "b": brp}.get(a, n) - n]
    return F.pad(t, pads) if any(pads) else t


def wide_row_decode(step, st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel,
                    i1: int, tau: float, forced_idx: Optional[torch.Tensor] = None,
                    limit: int = WIDE_SMEM_OPTIN):
    """A wide row call (the module docstring's contract) run as calls of
    ``step`` (same signature; the kernel's launch on the card) that the wide
    kernel takes:

      * C and br are zero-padded to multiples of 4. Every weight row that
        reads a padded channel is zero, so the padded channels (which carry
        the ELU of the biases) feed nothing real; vhc's real channels are
        written back.
      * a batch is split into the sub-batches of ``wide_row_batches``; each
        takes its slice of every per-batch operand and of the Gumbel table,
        so the row equals one unsplit call.
    """
    L, B, s2, br = d2w_row.shape
    C, K = dfin_row.shape[-1], gumbel.shape[-1]
    cp, brp = _align4(C), _align4(br)
    ops = dict(d2h_row=d2h_row, d2w_row=d2w_row, cnd_row=cnd_row, dfin_row=dfin_row,
               sprev_row=sprev_row, vhc=vhc)
    if (cp, brp) != (C, br):
        st = {k: _pad_axes(v, _WIDE_AXES[k], cp, brp) for k, v in st.items()}
        ops = {k: None if v is None else _pad_axes(v, _WIDE_AXES[k], cp, brp).contiguous()
               for k, v in ops.items()}
    plan = wide_row_batches(L, B, s2, cp, brp, K, limit)
    outs = []
    for b0, b1 in plan:
        if len(plan) == 1:
            sub, gum, frc = ops, gumbel, forced_idx
        else:
            sub = {k: None if v is None else v[b0:b1].contiguous() if k in ("dfin_row", "sprev_row")
                   else v[:, b0:b1].contiguous() for k, v in ops.items()}
            gum = gumbel[:, b0:b1].contiguous()
            frc = None if forced_idx is None else forced_idx[b0:b1]
        outs.append(step(st, sub["d2h_row"], sub["d2w_row"], sub["cnd_row"], sub["dfin_row"],
                         sub["sprev_row"], sub["vhc"], gum, i1, tau, forced_idx=frc))
        if sub["vhc"] is not ops["vhc"]:
            ops["vhc"][:, b0:b1] = sub["vhc"]
    if ops["vhc"] is not vhc:
        vhc.copy_(ops["vhc"][..., :br])
    idx = outs[0][0] if len(outs) == 1 else torch.cat([o[0] for o in outs])
    if forced_idx is None:
        return idx, vhc
    return idx, vhc, outs[0][2] if len(outs) == 1 else torch.cat([o[2] for o in outs])


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def row_decode(st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel,
               i1: int, tau: float, forced_idx: Optional[torch.Tensor] = None,
               cycles: Optional[torch.Tensor] = None):
    """Sample one row (the module docstring's contract). CPU tensors take
    ``row_decode_plain``; CUDA tensors launch kernel K6. ``cycles``, a (B, 4)
    int64 CUDA tensor, asks the narrow kernel for its clock64() cycles per
    batch element: the voxel chain, its layer loops alone, the staging and
    the height-row step, the staging alone (``chain_cycles_per_layer_step``
    reads them)."""
    dev = d2w_row.device
    if dev.type == "cpu":
        return row_decode_plain(st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc,
                                gumbel, i1, tau, forced_idx)
    if dev.type != "cuda":
        raise NotImplementedError(f"row_decode: no kernel for device {dev}")
    L, B, s2, br = d2w_row.shape
    C = dfin_row.shape[-1]
    K = gumbel.shape[-1]
    ws = st["wk"].shape[1]
    shapes = {"d2h_row": (d2h_row, (L, B, s2, br)), "d2w_row": (d2w_row, (L, B, s2, br)),
              "dfin_row": (dfin_row, (B, s2, C)), "sprev_row": (sprev_row, (B, s2, C)),
              "vhc": (vhc, (L, B, s2, br)), "gumbel": (gumbel, (s2, B, K)),
              "w1": (st["w1"], (L, C, br)), "wk": (st["wk"], (L, ws, br, br)),
              "w3": (st["w3"], (L, br, C)), "b3": (st["b3"], (L, C)),
              "sc": (st["sc"], (L, 8)), "hw1": (st["hw1"], (L, C, br)),
              "herf": (st["herf"], (L, br, br)), "herfb": (st["herfb"], (L, br)),
              "hwk": (st["hwk"], (L, 2, 3, br, br)), "hw3": (st["hw3"], (L, br, C)),
              "hb3": (st["hb3"], (L, C)), "w_in": (st["w_in"], (K, C)),
              "b_in": (st["b_in"], (C,)), "w_out": (st["w_out"], (C, K)),
              "b_out": (st["b_out"], (K,))}
    if cnd_row is not None:
        shapes["cnd_row"] = (cnd_row, (L, B, s2, br))
    if "skw" in st:
        shapes.update(skw=(st["skw"], (C, C)), hskw=(st["hskw"], (C, C)))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.dtype != f32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"row_decode: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"(contiguous: {t.is_contiguous()}), expected {want} fp32 "
                             f"contiguous on {dev}")
    wide = uses_wide_kernel(C, br, K, s2)
    if ws != 2 or br > 512:
        raise ValueError(f"row_decode: the kernels take ws = 2 and br <= 512 (the wide one "
                         f"also checks that the row's state fits shared memory); got L={L} "
                         f"C={C} br={br} ws={ws} K={K} s2={s2}")
    if forced_idx is not None and tuple(forced_idx.shape) != (B, s2):
        raise ValueError(f"row_decode: forced_idx {tuple(forced_idx.shape)}, expected {(B, s2)}")
    if cycles is not None and (wide or tuple(cycles.shape) != (B, 4)
                               or cycles.dtype != torch.int64 or cycles.device != dev):
        raise ValueError(f"row_decode: cycles takes a (B, 4) int64 tensor on {dev} and the "
                         f"narrow kernel; got {tuple(cycles.shape)} {cycles.dtype}, wide={wide}")
    if wide:
        return wide_row_decode(_launch_wide, st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row,
                               vhc, gumbel, i1, tau, forced_idx)
    return _launch(False, st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel, i1,
                   tau, forced_idx, cycles)


def _launch_wide(st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel, i1, tau,
                 forced_idx=None):
    return _launch(True, st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel, i1,
                   tau, forced_idx, None)


def _launch(wide: bool, st, d2h_row, d2w_row, cnd_row, dfin_row, sprev_row, vhc, gumbel,
            i1: int, tau: float, forced_idx, cycles):
    """One launch of the narrow or the wide kernel on checked operands."""
    dev = d2w_row.device
    L, B, s2, br = d2w_row.shape
    C, K, ws = dfin_row.shape[-1], gumbel.shape[-1], st["wk"].shape[1]
    forced = logits = None
    if forced_idx is not None:
        forced = forced_idx.to(device=dev, dtype=torch.int32).contiguous()
        logits = torch.empty(B, s2, K, dtype=f32, device=dev)
    out = torch.empty(B, s2, dtype=torch.int32, device=dev)
    lib = _build.library()
    args = [*(_ptr(st.get(k)) for k in ("w1", "wk", "w3", "b3", "sc", "hw1", "herf", "herfb",
                                         "hwk", "hw3", "hb3", "skw", "hskw", "w_in", "b_in",
                                         "w_out", "b_out")),
            d2h_row.data_ptr(), d2w_row.data_ptr(), _ptr(cnd_row), dfin_row.data_ptr(),
            sprev_row.data_ptr(), vhc.data_ptr(), gumbel.data_ptr(), _ptr(forced),
            out.data_ptr(), _ptr(logits), L, B, s2, C, br, ws, K, int(i1), ctypes.c_float(tau)]
    if wide:
        err = lib.vq_row_decode_wide(*args, _build.stream_ptr(dev))
    else:
        err = lib.vq_row_decode(*args, _ptr(cycles), _build.stream_ptr(dev))
    _build.check(err, "row_decode")
    if wide:
        row_decode.wide_launches += 1
    else:
        row_decode.launches += 1
    if forced_idx is not None:
        return out, vhc, logits
    return out, vhc


def chain_cycles_per_layer_step(cycles: torch.Tensor, L: int, s2: int) -> float:
    """The narrow K6's clock64() cycles per layer-step of its voxel chain
    (``row_decode``'s ``cycles``: the layer loops' cycles over s2 voxels x L
    layers), the mean over the batch elements."""
    return float(cycles[:, 1].double().mean()) / (s2 * L)


row_decode.launches = 0  # the narrow kernel (csrc/row_decode.cu)
row_decode.wide_launches = 0  # the wide kernel (csrc/row_decode_wide.cu)
