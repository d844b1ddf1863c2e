#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (vqvae3d_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from csrc/ (nvcc, sm_90a), then:

  1. kernels vs plain (serving): K1a (codebook lookup) at the three (N, K, D)
     lookups of a 512x512x128 volume; K3 (the 'same'-block stack forward) at
     every distinct (C, spatial) of the published full config, both pad
     modes, fp32 and bf16, one block and a 50-block stack. Times with CUDA
     events.
  2. the serving main path through the entry points: two synthetic int16 CT
     volumes (512x512x128, from --seed) written as NRRD, a port checkpoint at
     the published full config (literal stem, seeded weights perturbed so
     that no Fixup branch is zero), ``extract_embeddings`` then
     ``decode_embeddings`` on the codes it wrote; code-grid shapes, finite
     outputs and the K1a/K3 launch counts the config implies are checked.
  3. the full-config forward in fp32, kernels vs plain: indices
     equal except at genuine ties, decoded volume within tolerance; then bf16
     per-volume latency of the kernel and the plain path, stems 1 and 2, with
     peak device memory.
  4. train kernels vs plain: K1b (lookup + EMA statistics) at the three
     lookups; the K3 backward at every (C, spatial) of the stem-2 stacks,
     both pad modes, fp32 and bf16, one block and the stack's full depth,
     against the autograd of the plain stack; K7 (small-channel conv dW) at
     every qualifying conv of the stem-2 train step against the plain dW;
     each timed beside its plain version (K7 also beside cuDNN's wgrad).
  5. the stem-2 full-config train step at 512x512x128: one fp32 step on the
     kernel path against the plain path (loss, every gradient, the new EMA
     state); bf16 ms/step of both paths with peak memory; the launches per
     step against what the config implies; two identical steps from one
     state give bit-identical parameters and EMA state; a profiler breakdown.
  6. the train main path through the entry points: three synthetic scans,
     ``train_vqvae`` for 3 steps (validating at step 3), then ``--resume``
     for one more, then ``extract_embeddings`` on the checkpoint it wrote.

TF32 is off for the whole run (fp32 comparisons need true fp32; bf16 runs
do not use it). Every number is printed beside the card's name and power
limit. The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Exits non-zero, with no result, when CUDA is
absent, when the package is missing, or when any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

FULL = dict(
    num_embeddings=(128, 256, 512),
    n_pre_quantization_blocks=50,
    n_post_quantization_blocks=50,
    n_post_downscale_blocks=2,
    n_post_upscale_blocks=3,
    pad_mode="wrap",
)  # bench.py:117-128, jobs/train_vqvae_full.sh
VOLUME = (512, 512, 128)
N_VOLUMES = 2  # synthetic CT volumes through extract -> decode
# max|kernel - plain| <= tol * max|plain|. Kernel and plain round at the same
# points; only the order of the fp32 sums differs. In fp32 that moves the last
# bits (measured on an NVIDIA H100 80GB HBM3 at 700 W: 2.4e-7 for one block,
# 1.7e-6 for 50). In bf16 it can flip a rounding, one ulp (2^-8..2^-7 of the
# value), and the flips of
# successive blocks add up like a random walk: 2^-7 for one block, 2^-4
# (about sqrt(50) ulps at the top of a binade) for a 50-block stack
# (measured: 3.6e-3 and 3.1e-2).
K3_TOL = {
    ("float32", 1): 1e-4,
    ("float32", 50): 1e-4,
    ("bfloat16", 1): 2**-7,
    ("bfloat16", 50): 2**-4,
}
DECODED_TOL = 1e-3  # fp32 full forward, relative to max|plain decoded|
STEM2 = dict(base_network_channels=8, stem_space_to_depth=2)  # bench_train.py:55-67
# K3 backward vs the autograd of the plain stack, per gradient tensor:
# max|kernel - plain| <= tol * max|plain|. fp32: both sum in fp32 in another
# order. bf16: the plain reference rounds every gradient and cuDNN's dW to
# bf16 where the kernel sums dW and the scalar grads in fp32, and rounding
# flips carry through the blocks of a deep stack.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (worst over every stem-2
# shape and both pad modes):
# fp32 1.7e-5 (one block) and 9.2e-6 (full depth); bf16 5.8e-3 and 3.1e-2.
K3_BWD_TOL = {
    ("float32", "one"): 1e-4,
    ("float32", "full"): 1e-4,
    ("bfloat16", "one"): 2**-6,
    ("bfloat16", "full"): 2**-4,
}
K7_TOL = 1e-5  # fp32 sums in another order; bf16 products are exact in fp32
# the fp32 train step, kernel path vs plain path (see phase_train_step)
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_EMA_TOL = 1e-4, 1e-2, 1e-4
# published peaks of one H100 SXM (NVIDIA data sheet): the bounds' rates
HBM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type, in ms;
    and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k3_block_cost(c: int, spatial, itemsize: int):
    """(bytes, flops) of one K3 forward block: x read and y written once,
    the weights read once; 2 (C Cb + 27 Cb² + Cb C) flops per voxel."""
    cb = max(c // 2, 1)
    nvox = int(np.prod(spatial))
    weights = (2 * c * cb + 27 * cb * cb) * itemsize + 8 * 4
    return 2 * nvox * c * itemsize + weights, 2 * nvox * (2 * c * cb + 27 * cb * cb)


def write_scan(path: Path, vol: np.ndarray) -> None:
    """A synthetic CT scan as raw NRRD with the loader's spacing (0.976, 0.976, 3)."""
    from vqvae3d_tpu_torch.data import nrrd_io

    nrrd_io.write(path, vol, header={"spacings": (0.976, 0.976, 3.0)}, encoding="raw")


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel call sites to the plain versions (the
    reference on the card): the stacks to the plain block loop (autograd
    through it in training), the lookups to the plain argmin and statistics,
    the small-channel conv dW to the plain contraction. The wrappers
    themselves never fall back."""
    from vqvae3d_tpu_torch.models import blocks, quantizer
    from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel

    saved = (blocks.preact_stack_fused, quantizer.l2_argmin, quantizer.l2_argmin_stats,
             conv3d.dw_conv3d)
    blocks.preact_stack_fused = lambda x, w1s, w2s, w3s, sc8, pad_mode: (
        stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode))
    quantizer.l2_argmin = quantizer_ops.l2_argmin_plain
    quantizer.l2_argmin_stats = quantizer_ops.l2_argmin_stats_plain
    conv3d.dw_conv3d = conv3d.dw_conv3d_plain
    try:
        yield
    finally:
        (blocks.preact_stack_fused, quantizer.l2_argmin, quantizer.l2_argmin_stats,
         conv3d.dw_conv3d) = saved


def launch_counts():
    from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel

    return dict(l2_argmin=quantizer_ops.l2_argmin.launches,
                l2_argmin_stats=quantizer_ops.l2_argmin_stats.launches,
                preact_stack_fwd=stack_kernel.preact_stack_fused.launches,
                preact_stack_bwd=stack_kernel.preact_stack_bwd.launches,
                dw_conv3d=conv3d.dw_conv3d.launches)


def reset_counts():
    from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel

    for fn in (quantizer_ops.l2_argmin, quantizer_ops.l2_argmin_stats,
               stack_kernel.preact_stack_fused, stack_kernel.preact_stack_bwd, conv3d.dw_conv3d):
        fn.launches = 0


def make_model(stem: int, seed: int, dtype, device):
    """Full-config model with seeded weights; every Fixup branch perturbed
    off its zero init (branch_conv3, biases, scale)."""
    import torch
    from vqvae3d_tpu_torch.models.blocks import SCALARS, PreActFixupResBlock
    from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig

    cfg = VQVAEConfig(**FULL, base_network_channels=4 * stem, stem_space_to_depth=stem,
                      dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    model = VQVAE(cfg, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, PreActFixupResBlock):
                w3 = m.branch_conv3.weight
                w3.copy_(torch.randn(w3.shape, generator=gen) * w3.shape[1] ** -0.5)
                for n in SCALARS:
                    getattr(m, f"bias{n}").copy_(torch.randn(1, generator=gen) * 0.05)
                m.scale.copy_(1.0 + torch.randn(1, generator=gen) * 0.05)
    return model.to(device).eval(), cfg


def k3_weights(c: int, nb: int, gen, device):
    """Random stack weights at a Fixup-like scale (stable over 50 blocks)."""
    import torch

    cb = max(c // 2, 1)
    sc8 = torch.randn(nb, 8, generator=gen) * 0.1
    sc8[:, 7] = 0.3 + 0.05 * torch.randn(nb, generator=gen)
    return tuple(t.to(device) for t in (
        torch.randn(nb, cb, c, 1, 1, 1, generator=gen) * c ** -0.5,
        torch.randn(nb, cb, cb, 3, 3, 3, generator=gen) * (27 * cb) ** -0.5,
        torch.randn(nb, c, cb, 1, 1, 1, generator=gen) * cb ** -0.5,
        sc8,
    ))


def phase_kernels(ident, results, seed):
    import torch
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig
    from vqvae3d_tpu_torch.ops import quantizer_ops, stack_kernel

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    cfg = VQVAEConfig(**FULL)
    # --- K1 at the three lookups of one volume
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    for grid, k, d in zip(cfg.code_grid_shapes(VOLUME), cfg.num_embeddings, cfg.embedding_dims):
        n = int(np.prod(grid))
        flat = torch.randn(n, d, generator=gen).to(dev)
        embed = torch.randn(k, d, generator=gen).to(dev)
        got = quantizer_ops.l2_argmin(flat, embed)
        want = quantizer_ops.l2_argmin_plain(flat, embed)
        ties, real = quantizer_ops.genuine_ties(flat, embed, got, want)
        dist = lambda idx: ((flat.double() - embed.double()[idx]) ** 2).sum(-1)  # noqa: E731
        err = float((dist(got) - dist(want)).abs().max())
        ms = cuda_ms(lambda: quantizer_ops.l2_argmin(flat, embed), 20)
        pms = cuda_ms(lambda: quantizer_ops.l2_argmin_plain(flat, embed), 5)
        print(f"K1 l2_argmin N={n} K={k} D={d}: mismatches={int((got != want).sum())} "
              f"genuine_ties={ties.numel()} beyond_tie={real.numel()} "
              f"max|d_kernel-d_plain|={err:.3g} kernel {ms:.4f} ms plain {pms:.4f} ms [{ident}]")
        if real.numel():
            raise AssertionError(f"K1 disagrees beyond ties on {real.numel()} rows")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["ms"] += ms
        bms, k1["bound_by"] = bound_ms(4 * (n * d + k * d + k) + 8 * n, 2 * n * k * d, FP32_FLOPS)
        k1["bound_ms"] += bms
        k1["plain_ms"] += pms
    results["l2_argmin"] = k1

    # --- K3 at every distinct (C, spatial) of the full config, both stems
    shapes = {}
    for stem in (1, 2):
        c2 = VQVAEConfig(**FULL, base_network_channels=4 * stem, stem_space_to_depth=stem)
        for _, c, spatial, n in c2.same_stacks(VOLUME):
            shapes.setdefault((c, spatial), 0)
            if stem == 1:
                shapes[(c, spatial)] += n  # blocks per literal-stem volume
    k3 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    worst = {}
    for (c, spatial), per_volume in sorted(shapes.items(), key=lambda kv: -np.prod(kv[0][1])):
        x32 = torch.randn(1, c, *spatial, generator=gen).to(dev)
        for pad_mode in ("wrap", "zeros"):
            w = k3_weights(c, 50, gen, dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                for nb in (1, 50):
                    ws = tuple(t[:nb] for t in w)
                    with torch.inference_mode():
                        got = stack_kernel.preact_stack_fused(x, *ws, pad_mode)
                        want = stack_kernel.preact_stack_plain(x, *ws, pad_mode=pad_mode)
                    err = float((got.float() - want.float()).abs().max())
                    scale = float(want.float().abs().max())
                    key = (str(dtype).removeprefix("torch."), nb)
                    worst[key] = max(worst.get(key, 0.0), err / scale)
                    if not err <= K3_TOL[key] * scale or not torch.isfinite(got).all():
                        raise AssertionError(
                            f"K3 C={c} {spatial} {pad_mode} {key}: max|d|={err:.3g} "
                            f"> {K3_TOL[key]} x {scale:.3g}")
                    if dtype == torch.float32 and nb == 50:
                        k3["max_abs_err"] = max(k3["max_abs_err"], err)
                    print(f"K3 C={c} {spatial} {pad_mode} {key[0]} blocks={nb}: "
                          f"max|d|={err:.3g} max|ref|={scale:.3g}")
            if pad_mode == "wrap":  # the config's pad mode, serving dtype bf16
                xb, ws = x32.to(torch.bfloat16), tuple(t[:10] for t in w)
                with torch.inference_mode():
                    ms = cuda_ms(lambda: stack_kernel.preact_stack_fused(xb, *ws, "wrap"), 3) / 10
                    pms = cuda_ms(lambda: stack_kernel.preact_stack_plain(
                        xb, *ws, pad_mode="wrap"), 1) / 10
                print(f"K3 C={c} {spatial} bf16 per block: kernel {ms:.4f} ms plain {pms:.4f} ms "
                      f"x{per_volume} blocks/volume [{ident}]")
                k3["ms"] += ms * per_volume
                bms, k3["bound_by"] = bound_ms(*k3_block_cost(c, spatial, 2), BF16_FLOPS)
                k3["bound_ms"] += bms * per_volume
                k3["plain_ms"] += pms * per_volume
    print(f"K3 worst max|d|/max|ref| by (dtype, blocks): "
          + ", ".join(f"{k[0]} {k[1]}: {v:.3g}" for k, v in sorted(worst.items())))
    results["preact_stack_fwd"] = k3


def phase_main_path(ident, counts, seed, n_volumes, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import save_checkpoint
    from vqvae3d_tpu_torch.cli import decode_embeddings, extract_embeddings
    from vqvae3d_tpu_torch.data import nrrd_io

    rng = np.random.default_rng(seed)
    ct = work / "ct"
    ct.mkdir()
    t0 = time.perf_counter()
    for i in range(n_volumes):
        write_scan(ct / f"scan{i}.nrrd", rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    model, cfg = make_model(1, seed, torch.bfloat16, "cpu")
    save_checkpoint(work / "ckpt", model.state_dict(), cfg)
    del model
    print(f"main path set-up: {n_volumes} volumes {VOLUME} + full-config checkpoint "
          f"in {time.perf_counter() - t0:.1f} s")
    stacks = cfg.same_stacks(VOLUME)
    want_k3 = {p: sum(n for q, _, _, n in stacks if q == p) for p in ("encode", "decode")}

    reset_counts()
    t0 = time.perf_counter()
    extract_embeddings.main(extract_embeddings.parse_arguments([
        "--checkpoint-path", str(work / "ckpt"), "--dataset-path", str(ct),
        "--output-path", str(work), "--output-name", "codes", "--rescale-input", "0",
        "--scan-size", *map(str, VOLUME[:2]), "--output-depth", str(VOLUME[2]), "--backend", "file",
        "--device", "cuda",
    ]))
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), l2_argmin=cfg.n_enc * n_volumes,
                preact_stack_fwd=want_k3["encode"] * n_volumes)
    print(f"extract_embeddings: {n_volumes} volumes in {t_extract:.2f} s (host clock, "
          f"first call included); launches {got}, config implies {want} [{ident}]")
    if got != want:
        raise AssertionError(f"extract launches {got} != {want}")
    counts.update(got)
    codes = extract_embeddings.read_codes(work / "codes")
    if len(codes) != n_volumes:
        raise AssertionError(f"{len(codes)} code samples, expected {n_volumes}")
    for i, grids in enumerate(codes):
        for lvl, (g, shape) in enumerate(zip(grids, cfg.code_grid_shapes(VOLUME), strict=True)):
            if g.shape != shape or g.min() < 0 or g.max() >= cfg.num_embeddings[lvl]:
                raise AssertionError(f"code grid {i}/{lvl}: {g.shape} range {g.min()}..{g.max()}")
    print(f"code grids: {[g.shape for g in codes[0]]}, "
          f"distinct codes used {[len(np.unique(g)) for g in codes[0]]}")

    decode_embeddings.code_store_to_sample_db(work / "codes", work / "samples.db")
    reset_counts()
    t0 = time.perf_counter()
    n = decode_embeddings.main(decode_embeddings.parse_arguments(
        [str(work / "samples.db"), str(work / "ckpt"), str(work / "decoded" / "synth"),
         "--volume-shape", *map(str, VOLUME), "--device", "cuda"]))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), preact_stack_fwd=want_k3["decode"] * n_volumes)
    print(f"decode_embeddings: {n} volumes in {t_decode:.2f} s (host clock, NRRD writes "
          f"included); launches {got}, config implies {want} [{ident}]")
    if got != want or n != n_volumes:
        raise AssertionError(f"decode launches {got} != {want} or {n} volumes")
    for k in counts:
        counts[k] += got[k]
    for f in sorted((work / "decoded").glob("*.nrrd")):
        vol, _ = nrrd_io.read(f)
        # elu output >= -1 -> HU >= -2000; a NaN would land at INT_MIN
        if vol.shape != VOLUME or vol.min() < -2000:
            raise AssertionError(f"{f.name}: shape {vol.shape} min {vol.min()}")
    print(f"decoded NRRDs: {n} x {VOLUME} int32, HU in range")


def phase_forward(ident, seed):
    import torch
    from vqvae3d_tpu_torch.data.transforms import hu_window_normalize
    from vqvae3d_tpu_torch.ops import quantizer_ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    vol = hu_window_normalize(rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    x = torch.from_numpy(vol)[None, None].to(dev)

    # --- fp32: kernels vs plain, same weights
    model, cfg = make_model(1, seed, torch.float32, dev)
    inputs = {}
    hooks = [q.register_forward_hook(lambda m, a, o, i=i: inputs.__setitem__(i, a[0].float()))
             for i, q in enumerate(model.encoder.quantize)]
    with torch.inference_mode():
        res_k = model.encode(x)
        quants = [q for _, q, _ in res_k]
        dec_k = model.decode(quants)
        with plain_path():
            res_p = model.encode(x)
            dec_p = model.decode(quants)  # the same codes: a decoder-only comparison
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    tie_above = None
    for lvl in reversed(range(cfg.n_enc)):  # coarse first: a tie there changes finer inputs
        a, b = res_k[lvl][2].flatten(), res_p[lvl][2].flatten()
        embed = model.encoder.quantize[lvl].embed
        flat = inputs[lvl].movedim(1, -1).reshape(-1, embed.shape[1])
        ties, real = quantizer_ops.genuine_ties(flat, embed, a, b)
        frac = float((a != b).float().mean())
        print(f"fp32 level {lvl}: index mismatch fraction {frac:.3g} "
              f"(genuine ties {ties.numel()}, beyond tie {real.numel()})")
        if real.numel() and tie_above is None:
            raise AssertionError(f"level {lvl}: {real.numel()} index mismatches beyond ties")
        if (a != b).any() and tie_above is None:
            tie_above = lvl
    err = float((dec_k - dec_p).abs().max())
    scale = float(dec_p.abs().max())
    finite = bool(torch.isfinite(dec_k).all())
    print(f"fp32 decoded: shape {tuple(dec_k.shape)} finite={finite} max|d|={err:.3g} "
          f"max|ref|={scale:.3g} (tolerance {DECODED_TOL} x max|ref|) [{ident}]")
    if not finite or tuple(dec_k.shape) != (1, 1, *VOLUME) or err > DECODED_TOL * scale:
        raise AssertionError("fp32 decoded volume disagrees with the plain path")
    del model, res_k, res_p, dec_k, dec_p, quants, inputs

    # --- bf16 per-volume latency, kernels vs plain, both stems
    latency = {}
    for stem in (1, 2):
        model, _ = make_model(stem, seed, torch.bfloat16, dev)
        for path in ("kernel", "plain", "kernel", "plain"):
            ctx = plain_path() if path == "plain" else contextlib.nullcontext()
            with ctx, torch.inference_mode():
                torch.cuda.reset_peak_memory_stats()
                run = lambda: model(x)  # noqa: E731
                ms = cuda_ms(run, iters=3 if path == "kernel" else 2)
                peak = torch.cuda.max_memory_allocated() / 2**30
                out, _ = model(x)
                if not torch.isfinite(out).all():
                    raise AssertionError(f"stem {stem} {path}: non-finite output")
            latency.setdefault((stem, path), []).append(ms)
            print(f"bf16 stem={stem} {path} path: {ms:.2f} ms/volume (encode+decode, "
                  f"batch 1, {VOLUME}) peak {peak:.2f} GiB [{ident}]")
        del model
        torch.cuda.empty_cache()
    return latency


def smallc_convs(model, x):
    """The stride-1 k>1 convs of one forward that take the small-channel
    backward (K7): [(channels, output spatial)], from a no-grad forward with
    hooks on the resize/same-with-skip blocks' 3x3x3 convs."""
    import torch
    from vqvae3d_tpu_torch.models.blocks import PreActFixupResBlock
    from vqvae3d_tpu_torch.ops.conv3d import SMALLC_MAX

    seen, hooks = [], []
    for m in model.modules():
        if isinstance(m, PreActFixupResBlock) and m.needs_skip and m.mode != "down":
            conv = m.branch_conv2
            if max(conv.weight.shape[:2]) <= SMALLC_MAX:
                f = 2 if m.mode == "up" else 1
                hooks.append(conv.register_forward_pre_hook(
                    lambda mod, a, f=f: seen.append(
                        (mod.weight.shape[0], tuple(f * s for s in a[0].shape[2:])))))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def phase_train_kernels(ident, results, seed):
    import torch
    import torch.nn.functional as F
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig
    from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 7)
    cfg = VQVAEConfig(**FULL, **STEM2)
    # --- K1b at the three lookups of one train step
    k1b = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    for grid, k, d in zip(cfg.code_grid_shapes(VOLUME), cfg.num_embeddings, cfg.embedding_dims):
        n = int(np.prod(grid))
        flat = torch.randn(n, d, generator=gen).to(dev)
        embed = torch.randn(k, d, generator=gen).to(dev)
        idx, counts, dw = quantizer_ops.l2_argmin_stats(flat, embed)
        again = quantizer_ops.l2_argmin_stats(flat, embed)
        p_idx = quantizer_ops.l2_argmin_plain(flat, embed)
        ties, real = quantizer_ops.genuine_ties(flat, embed, idx, p_idx)
        # the statistics of the kernel's own indices, by the plain means
        want_counts = torch.bincount(idx, minlength=k).float()
        want_dw = torch.zeros(k, d, device=dev).index_add_(0, idx, flat)
        err = float((dw - want_dw).abs().max())
        scale = float(want_dw.abs().max())
        ms = cuda_ms(lambda: quantizer_ops.l2_argmin_stats(flat, embed), 20)
        pms = cuda_ms(lambda: quantizer_ops.l2_argmin_stats_plain(flat, embed), 5)
        print(f"K1b l2_argmin_stats N={n} K={k} D={d}: index mismatches "
              f"{int((idx != p_idx).sum())} (genuine ties {ties.numel()}, beyond tie "
              f"{real.numel()}); counts exact: {torch.equal(counts, want_counts)}; "
              f"max|dw - ref|={err:.3g} max|ref|={scale:.3g}; kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms [{ident}]")
        if real.numel() or not torch.equal(counts, want_counts) or err > 1e-5 * scale:
            raise AssertionError("K1b disagrees with its plain version")
        if not all(torch.equal(a, b) for a, b in zip((idx, counts, dw), again)):
            raise AssertionError("K1b: two identical calls differ")
        k1b["max_abs_err"] = max(k1b["max_abs_err"], err)
        k1b["ms"] += ms
        k1b["plain_ms"] += pms
        bms, k1b["bound_by"] = bound_ms(4 * (n * d + k * d) + 8 * n + 4 * k * (d + 1),
                                        2 * n * k * d + n * d, FP32_FLOPS)
        k1b["bound_ms"] += bms
    results["l2_argmin_stats"] = k1b

    # --- the K3 backward at every (C, spatial) of the stem-2 stacks
    shapes = {}
    for _, c, spatial, n in cfg.same_stacks(VOLUME):
        per_step, deepest = shapes.get((c, spatial), (0, 0))
        shapes[(c, spatial)] = (per_step + n, max(deepest, n))
    bwd = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    worst = {}
    for (c, spatial), (per_step, deepest) in sorted(shapes.items(),
                                                    key=lambda kv: -np.prod(kv[0][1])):
        x32 = torch.randn(1, c, *spatial, generator=gen).to(dev)
        g32 = torch.randn(1, c, *spatial, generator=gen).to(dev)
        for pad_mode in ("wrap", "zeros"):
            w = k3_weights(c, deepest, gen, dev)
            for dtype in (torch.float32, torch.bfloat16):
                x, gy = x32.to(dtype), g32.to(dtype)
                for depth, nb in (("one", 1), ("full", deepest)):
                    ws = [t[:nb] for t in w]
                    xg = x.clone().requires_grad_()
                    wg = [t.clone().requires_grad_() for t in ws]
                    y = stack_kernel.preact_stack_fused(xg, *wg, pad_mode)
                    got = torch.autograd.grad(y, [xg, *wg], gy)
                    with plain_path():
                        xr = x.clone().requires_grad_()
                        wr = [t.clone().requires_grad_() for t in ws]
                        yr = stack_kernel.preact_stack_plain(xr, *wr, pad_mode=pad_mode)
                        want = torch.autograd.grad(yr, [xr, *wr], gy)
                    key = (str(dtype).removeprefix("torch."), depth)
                    errs = []
                    for name, a, b in zip(("dx", "dw1", "dw2", "dw3", "dsc"), got, want):
                        err = float((a.float() - b.float()).abs().max())
                        scale = float(b.float().abs().max())
                        errs.append(f"{name} {err / scale:.2e}")
                        worst[key] = max(worst.get(key, 0.0), err / scale)
                        if not err <= K3_BWD_TOL[key] * scale:
                            raise AssertionError(
                                f"K3 bwd C={c} {spatial} {pad_mode} {key} {name}: "
                                f"max|d|={err:.3g} > {K3_BWD_TOL[key]} x {scale:.3g}")
                        if key == ("float32", "full"):
                            bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
                    print(f"K3 bwd C={c} {spatial} {pad_mode} {key[0]} blocks={nb}: "
                          f"max|d|/max|ref| " + ", ".join(errs))
                    del y, got, yr, want
            if pad_mode == "wrap":  # the config's pad mode, training dtype bf16
                nb = min(deepest, 10)
                xb, gb = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
                ws = [t[:nb] for t in w]
                saves = torch.empty((nb, 1, *spatial, c), dtype=torch.bfloat16, device=dev)
                stack_kernel._forward_cuda(xb, *ws, "wrap", saves=saves)
                ms = cuda_ms(lambda: stack_kernel.preact_stack_bwd(saves, gb, *ws, "wrap"), 3) / nb
                with plain_path():
                    pms = cuda_ms(lambda: stack_kernel.preact_stack_bwd_plain(
                        saves, gb, *ws, "wrap"), 1) / nb
                cb = max(c // 2, 1)
                nvox = int(np.prod(spatial))
                # x and g read, dx written (bf16), fp32 dW and scalars written; 3x the
                # forward's flops (recompute, data gradient, weight gradient)
                nbytes = 3 * nvox * c * 2 + (2 * c * cb + 27 * cb * cb) * (2 + 4) + 64
                bms, bwd["bound_by"] = bound_ms(nbytes, 3 * k3_block_cost(c, spatial, 2)[1],
                                                BF16_FLOPS)
                print(f"K3 bwd C={c} {spatial} bf16 per block: kernel {ms:.4f} ms plain "
                      f"{pms:.4f} ms bound {bms:.4f} ms x{per_step} blocks/step [{ident}]")
                bwd["ms"] += ms * per_step
                bwd["plain_ms"] += pms * per_step
                bwd["bound_ms"] += bms * per_step
                del saves
            torch.cuda.empty_cache()
    print("K3 bwd worst max|d|/max|ref| by (dtype, depth): "
          + ", ".join(f"{k[0]} {k[1]}: {v:.3g}" for k, v in sorted(worst.items())))
    results["preact_stack_bwd"] = bwd

    # --- K7 at every qualifying conv of the stem-2 train step
    model, _ = make_model(2, seed, torch.bfloat16, dev)
    vol = torch.zeros(1, 1, *VOLUME, device=dev)
    convs = smallc_convs(model, vol)
    del model
    results["smallc_convs"] = convs
    k7 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for cb, spatial in convs:
        padded = tuple(s + 2 for s in spatial)
        xp32 = torch.randn(1, cb, *padded, generator=gen).to(dev)
        g32 = torch.randn(1, cb, *spatial, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xp, g = xp32.to(dtype), g32.to(dtype)
            got = conv3d.dw_conv3d(xp, g, (3, 3, 3))
            again = conv3d.dw_conv3d(xp, g, (3, 3, 3))
            want = conv3d.dw_conv3d_plain(xp, g, (3, 3, 3))
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            # and against the autograd of F.conv3d: cuDNN's wgrad, whose order of
            # summation is its own (fp32: 6e-6 measured on the CPU at 64x64x32)
            # and whose dW is in the activation dtype (bf16: rounded to 2^-9 of
            # the value, its internal accumulation not documented)
            w = torch.zeros(cb, cb, 3, 3, 3, dtype=dtype, device=dev, requires_grad=True)
            (auto,) = torch.autograd.grad(F.conv3d(xp, w), w, g)
            auto_err = float((got - auto.float()).abs().max())
            auto_tol = 1e-4 if dtype == torch.float32 else 2**-6
            if not torch.equal(got, again) or err > K7_TOL * scale or auto_err > auto_tol * scale:
                raise AssertionError(f"K7 C={cb} {spatial} {dtype}: max|d| plain {err:.3g}, "
                                     f"autograd {auto_err:.3g} (max|ref| {scale:.3g}) or not "
                                     f"deterministic")
            print(f"K7 C={cb} {spatial} {str(dtype).removeprefix('torch.')}: max|d|/max|ref| "
                  f"vs plain {err / scale:.2e} (tol {K7_TOL}), vs autograd of F.conv3d "
                  f"{auto_err / scale:.2e} (tol {auto_tol:.3g})")
            k7["max_abs_err"] = max(k7["max_abs_err"], err)
        xp, g = xp32.to(torch.bfloat16), g32.to(torch.bfloat16)
        ms = cuda_ms(lambda: conv3d.dw_conv3d(xp, g, (3, 3, 3)), 5)
        pms = cuda_ms(lambda: conv3d.dw_conv3d_plain(xp, g, (3, 3, 3)), 2)
        lms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(xp, (cb, cb, 3, 3, 3), g), 5)
        nvox = int(np.prod(spatial))
        bms, k7["bound_by"] = bound_ms(2 * cb * (int(np.prod(padded)) + nvox) + 4 * 27 * cb * cb,
                                       2 * 27 * cb * cb * nvox, BF16_FLOPS)
        print(f"K7 dw_conv3d C={cb}->{cb} 3x3x3 over {spatial}: bf16 kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms cuDNN wgrad "
              f"{lms:.4f} ms bound {bms:.4f} ms [{ident}]")
        k7["ms"] += ms
        k7["plain_ms"] += pms
        k7["library_ms"] += lms
        k7["bound_ms"] += bms
    results["dw_conv3d"] = k7


def synthetic_batch(seed, device):
    """One loader batch: a random CT volume in the loader's HU window,
    (1, H, W, D, 1), all depth slices valid."""
    import torch
    from vqvae3d_tpu_torch.data.transforms import hu_window_normalize

    rng = np.random.default_rng(seed)
    vol = hu_window_normalize(rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    return {"volume": torch.from_numpy(vol)[None, ..., None].to(device),
            "num_valid_slices": torch.tensor([VOLUME[2]], device=device)}


def phase_train_step(ident, seed, results):
    import torch
    from vqvae3d_tpu_torch.models.quantizer import QuantizerState, ema_first_pass_init
    from vqvae3d_tpu_torch.ops import quantizer_ops
    from vqvae3d_tpu_torch.train import vqvae_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    dev = torch.device("cuda")
    batch = synthetic_batch(seed + 2, dev)

    # --- fp32: one step's loss, gradients and EMA state, kernels vs plain
    model, cfg = make_model(2, seed, torch.float32, dev)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads():
        """One step's loss, gradients and new EMA state, and per level the
        quantizer's input and indices."""
        model.zero_grad(set_to_none=True)
        seen = {}
        hooks = [q.register_forward_hook(lambda m, a, o, i=i: seen.__setitem__(
                     i, (a[0].detach().float(), o[2].flatten())))
                 for i, q in enumerate(model.encoder.quantize)]
        loss, _, _ = vqvae_train.vqvae_loss_fn(model, batch, train=True)
        for h in hooks:
            h.remove()
        loss.backward()
        return (float(loss.detach()), {n: p.grad for n, p in model.named_parameters()},
                {k: v.clone() for k, v in model.state_dict().items() if ".quantize." in k}, seen)

    loss_k, grads_k, ema_k, seen_k = loss_and_grads()
    model.load_state_dict(state0)
    with plain_path():
        loss_p, grads_p, ema_p, seen_p = loss_and_grads()
    torch.cuda.synchronize()
    # indices equal except at genuine ties; a tie at a coarser level changes the
    # finer levels' inputs, so below one any mismatch is accepted. The EMA state
    # is compared on the codes no mismatched row touched.
    touched, tie_above, mism = {}, None, []
    for lvl in reversed(range(cfg.n_enc)):
        x, a = seen_k[lvl]
        b = seen_p[lvl][1]
        q0 = QuantizerState(*(state0[f"encoder.quantize.{lvl}.{k}"] for k in
                              ("embed", "embed_avg", "cluster_size", "first_pass")))
        flat = x.movedim(1, -1).reshape(-1, q0.embed.shape[1])
        embed = ema_first_pass_init(q0, flat).embed  # the codebook of the lookup
        ties, real = quantizer_ops.genuine_ties(flat, embed, a, b)
        mism.append(f"level {lvl}: {int((a != b).sum())} (ties {ties.numel()})")
        if real.numel() and tie_above is None:
            raise AssertionError(f"fp32 train step, level {lvl}: {real.numel()} index "
                                 f"mismatches beyond ties")
        diff = torch.nonzero(a != b).flatten()
        touched[lvl] = torch.unique(torch.cat([a[diff], b[diff]]))
        if diff.numel() and tie_above is None:
            tie_above = lvl
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    grad_err = {n: float((grads_k[n] - grads_p[n]).abs().max())
                / max(float(grads_p[n].abs().max()), 1e-3 * gmax) for n in grads_p}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    ema_err = 0.0
    for k in ema_p:
        keep = torch.ones(ema_p[k].shape[:1], dtype=torch.bool, device=dev)
        if ema_p[k].ndim:
            keep[touched[int(k.split(".")[2])]] = False
        d = (ema_k[k].float() - ema_p[k].float())[keep]
        if d.numel():
            ema_err = max(ema_err, float(d.abs().max()) / max(float(ema_p[k].float().abs().max()), 1.0))
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"fp32 train step (stem 2, {VOLUME}): index mismatches {', '.join(mism)}; loss "
          f"kernel {loss_k:.7g} plain {loss_p:.7g} (rel {loss_err:.2e}); gradients of "
          f"{len(grads_p)} tensors, worst max|d| over max(max|ref|, 1e-3 max grad): "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f"; EMA state rel {ema_err:.2e} on the codes no mismatch touched "
          f"({sum(t.numel() for t in touched.values())} touched) [{ident}]")
    if (loss_err > STEP_LOSS_TOL or worst[0][1] > STEP_GRAD_TOL or ema_err > STEP_EMA_TOL
            or not np.isfinite(loss_k)):
        raise AssertionError("fp32 train step: kernel path disagrees with the plain path")
    results["step_fp32"] = dict(loss_rel=loss_err, grad_worst=worst[0][1], ema_rel=ema_err)
    del model, state0, grads_k, grads_p
    torch.cuda.empty_cache()

    # --- bf16 train steps: launches per step, ms/step and peak memory per path
    model, cfg = make_model(2, seed, torch.bfloat16, dev)
    convs = results["smallc_convs"]
    opt = AMSGrad(model.parameters(), lr=1e-4)
    step = vqvae_train.make_train_step(model, opt)
    reset_counts()
    log = step(batch)
    torch.cuda.synchronize()
    got = launch_counts()
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    want = dict(l2_argmin=0, l2_argmin_stats=cfg.n_enc, preact_stack_fwd=blocks,
                preact_stack_bwd=blocks, dw_conv3d=len(convs))
    print(f"bf16 train step launches {got}, config implies {want} "
          f"(loss {float(log['loss']):.5g}) [{ident}]")
    if got != want or not np.isfinite(float(log["loss"])):
        raise AssertionError(f"train step launches {got} != {want} or non-finite loss")
    timing = {}
    for path in ("kernel", "plain", "kernel", "plain"):
        ctx = plain_path() if path == "plain" else contextlib.nullcontext()
        with ctx:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(batch), iters=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        timing.setdefault(path, []).append((ms, peak))
        print(f"bf16 train step (stem 2, batch 1, {VOLUME}) {path} path: {ms:.2f} ms/step "
              f"(mean of 3 after 1 warm-up) peak {peak:.2f} GiB [{ident}]")
    results["step_bf16"] = timing

    # --- two identical steps from one state: bit-identical params and EMA state
    torch.backends.cudnn.deterministic = True
    snap = ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state_dict().items()})
    outs = []
    for _ in range(2):
        model.load_state_dict(snap[0])
        opt.load_state_dict(snap[1])
        step(batch)
        outs.append({k: v.clone() for k, v in model.state_dict().items()})
    torch.backends.cudnn.deterministic = False
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    print(f"two identical bf16 steps from one state: {len(outs[0]) - len(differ)} of "
          f"{len(outs[0])} params and buffers bit-identical (cuDNN deterministic) [{ident}]")
    if differ:
        raise AssertionError(f"not bit-identical: {differ[:5]}")

    # --- where the time goes: one kernel-path step under the profiler
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=act) as prof:
        step(batch)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=70)
    print(f"profile of one bf16 kernel-path train step: device busy {busy:.1f} ms of "
          f"{wall:.1f} ms wall under the profiler [{ident}]\n{table}")
    del model, opt
    torch.cuda.empty_cache()


def phase_train_cli(ident, counts, results, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.cli import extract_embeddings, train_vqvae
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    rng = np.random.default_rng(seed + 3)
    ct = work / "ct_train"
    ct.mkdir()
    for i in range(3):
        write_scan(ct / f"scan{i}.nrrd", rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    ckpt = work / "train_ckpt"
    flags = [str(ct), "--ckpt-dir", str(ckpt), "--batch-size", "1",
             "--num-embeddings", *map(str, FULL["num_embeddings"]),
             "--n-pre-quantization-blocks", "50", "--n-post-quantization-blocks", "50",
             "--n-post-downscale-blocks", "2", "--n-post-upscale-blocks", "3",
             "--stem-space-to-depth", "2", "--base-network-channels", "8",
             "--pad-mode", "wrap", "--scan-size", *map(str, VOLUME[:2]),
             "--output-depth", str(VOLUME[2]), "--val-every-steps", "3",
             "--log-every-n-steps", "1", "--num-workers", "2", "--device", "cuda"]
    cfg = VQVAEConfig(**FULL, **STEM2)
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    per_step = dict(l2_argmin=0, l2_argmin_stats=cfg.n_enc, preact_stack_fwd=blocks,
                    preact_stack_bwd=blocks, dw_conv3d=len(results["smallc_convs"]))
    runs = [("train", ["--max-steps", "3"], 3), ("resume", ["--max-steps", "4", "--resume"], 1)]
    total = {k: 0 for k in launch_counts()}
    for name, extra, steps in runs:
        reset_counts()
        t0 = time.perf_counter()
        _, opt, step = train_vqvae.main(train_vqvae.parse_arguments(flags + extra))
        torch.cuda.synchronize()
        got = launch_counts()
        # each run validates once (the 1 val scan, an eval forward)
        want = {k: v * steps for k, v in per_step.items()}
        want["l2_argmin"] += cfg.n_enc
        want["preact_stack_fwd"] += blocks
        print(f"train_vqvae {name}: {steps} step(s) to step {step} in "
              f"{time.perf_counter() - t0:.1f} s (host clock, data and checkpoints "
              f"included); launches {got}; the config implies {want} [{ident}]")
        if step != {"train": 3, "resume": 4}[name] or opt.count != step:
            raise AssertionError(f"{name}: step {step}, optimizer count {opt.count}")
        if got != want:
            raise AssertionError(f"{name}: launches {got} != {want}")
        if name == "train":
            saved = torch.load(ckpt / "step_3_train.pt", weights_only=True)["optimizer"]
            if not all(torch.equal(saved[k], getattr(opt, k).cpu()) for k in ("mu", "nu", "nu_max")):
                raise AssertionError("the saved optimizer state is not the trained one")
        for k in total:
            total[k] += got[k]
    logs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in logs if "train_loss" in r]
    val = [r["val_recon_loss_mean"] for r in logs if "val_recon_loss_mean" in r]
    print(f"train losses by step {losses}; val recon loss {val}; best/ holds "
          f"{sorted(f.name for f in (ckpt / 'best').glob('step_*'))}")
    if len(losses) != 4 or not np.all(np.isfinite(losses + val)) or len(val) != 2:
        raise AssertionError("train CLI: losses missing or not finite")

    # the serving slice reads the training slice's checkpoint
    reset_counts()
    extract_embeddings.main(extract_embeddings.parse_arguments([
        "--checkpoint-path", str(ckpt), "--dataset-path", str(ct),
        "--output-path", str(work), "--output-name", "train_codes", "--rescale-input", "0",
        "--scan-size", *map(str, VOLUME[:2]), "--output-depth", str(VOLUME[2]),
        "--backend", "file", "--device", "cuda"]))
    torch.cuda.synchronize()
    got = launch_counts()
    codes = extract_embeddings.read_codes(work / "train_codes")
    print(f"extract_embeddings on the trained checkpoint: {len(codes)} samples, grids "
          f"{[g.shape for g in codes[0]]}, launches {got} [{ident}]")
    if len(codes) != 3 or [g.shape for g in codes[0]] != cfg.code_grid_shapes(VOLUME):
        raise AssertionError("extract on the trained checkpoint wrote the wrong grids")
    for k in total:
        total[k] += got[k]
    for k, v in total.items():
        counts[k] = counts.get(k, 0) + v


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to check", file=sys.stderr)
        return 2
    try:
        import vqvae3d_tpu_torch  # noqa: F401
        from vqvae3d_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 3

    # fp32 comparisons need true fp32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ident = card_identity()
    print(ident)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} from {[s.name for s in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")

    failed, results, counts = [], {}, {}
    with tempfile.TemporaryDirectory(prefix="vqvae3d_smoke_") as tmp:
        phases = [
            ("kernels vs plain", lambda: phase_kernels(ident, results, args.seed)),
            ("main path", lambda: phase_main_path(
                ident, counts, args.seed, N_VOLUMES, Path(tmp))),
            ("full forward", lambda: phase_forward(ident, args.seed)),
            ("train kernels vs plain", lambda: phase_train_kernels(ident, results, args.seed)),
            ("train step", lambda: phase_train_step(ident, args.seed, results)),
            ("train CLI", lambda: phase_train_cli(ident, counts, results, args.seed, Path(tmp))),
        ]
        for name, fn in phases:
            t0 = time.perf_counter()
            print(f"=== phase: {name}", flush=True)
            try:
                fn()
                print(f"=== phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
            except Exception:  # report every phase, then fail the run
                traceback.print_exc()
                print(f"=== phase {name}: FAILED", flush=True)
                failed.append(name)
            torch.cuda.empty_cache()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    meta = {
        "l2_argmin": ("vqvae3d_tpu_torch/csrc/l2_argmin.cu", "vqvae3d_tpu/ops/quantizer_ops.py:106"),
        "l2_argmin_stats": ("vqvae3d_tpu_torch/csrc/l2_argmin_stats.cu",
                            "vqvae3d_tpu/ops/quantizer_ops.py:197"),
        "preact_stack_fwd": ("vqvae3d_tpu_torch/csrc/preact_stack.cu",
                             "vqvae3d_tpu/ops/stack_kernel.py:968"),
        "preact_stack_bwd": ("vqvae3d_tpu_torch/csrc/preact_stack_bwd.cu",
                             "vqvae3d_tpu/ops/stack_kernel.py:1112"),
        "dw_conv3d": ("vqvae3d_tpu_torch/csrc/dw_conv3d.cu", "vqvae3d_tpu/ops/pallas_conv.py:151"),
    }
    missing = [name for name in meta if not counts.get(name)]
    if missing:
        print(f"chip_smoke: no launch on the main paths of {missing}", file=sys.stderr)
        return 1
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **{k: results[name][k] for k in keys}}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
