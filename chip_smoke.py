#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (vqvae3d_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from csrc/ (nvcc, sm_90a), then:

  1. kernels vs plain: K1 (codebook lookup) at the three (N, K, D) lookups of
     a 512x512x128 volume; K3 (the 'same'-block stack) at every distinct
     (C, spatial) of the published full config, both pad modes, fp32 and
     bf16, one block and a 50-block stack. Times with CUDA events.
  2. the main path through the entry points: two synthetic int16 CT volumes
     (512x512x128, from --seed) written as NRRD, a port checkpoint at the
     published full config (literal stem, seeded weights perturbed so that no
     Fixup branch is zero), ``extract_embeddings`` then ``decode_embeddings``
     on the codes it wrote; code-grid shapes, finite outputs and the K1/K3
     launch counts the config implies are checked.
  3. the full-config forward in fp32, kernels vs plain: indices
     equal except at genuine ties, decoded volume within tolerance; then bf16
     per-volume latency of the kernel and the plain path, stems 1 and 2, with
     peak device memory.

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
# bits (measured on an H100: 2.4e-7 for one block, 1.7e-6 for 50). In bf16 it
# can flip a rounding, one ulp (2^-8..2^-7 of the value), and the flips of
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


HU_MIN, HU_MAX, HU_SCALE = -1500.0, 3000.0, 1000.0  # the CT window of the data loader


def write_nrrd(path: Path, vol: np.ndarray) -> None:
    """Raw little-endian NRRD, first axis fastest, CT spacing (0.976, 0.976, 3)."""
    kind = {np.dtype(np.int16): "int16", np.dtype(np.int32): "int32"}[vol.dtype]
    header = ["NRRD0005", f"type: {kind}", "dimension: 3",
              "sizes: " + " ".join(map(str, vol.shape)), "encoding: raw",
              "endian: little", "spacings: 0.976 0.976 3.0"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n\n").encode("ascii"))
        f.write(vol.astype(vol.dtype.newbyteorder("<")).tobytes(order="F"))


def read_nrrd(path: Path) -> np.ndarray:
    """Read a little-endian int16/int32 NRRD (raw or gzip) written as above."""
    import zlib

    raw = path.read_bytes()
    head, payload = raw.split(b"\n\n", 1)
    fields = dict(line.split(": ", 1) for line in head.decode("ascii").splitlines()[1:]
                  if ": " in line and not line.startswith("#"))
    if fields["encoding"] in ("gzip", "gz"):
        payload = zlib.decompress(payload, zlib.MAX_WBITS | 32)
    dtype = np.dtype({"int16": "<i2", "int32": "<i4"}[fields["type"]])
    sizes = tuple(int(s) for s in fields["sizes"].split())
    return np.frombuffer(payload, dtype=dtype).reshape(sizes, order="F")


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
    reference on the card). The wrappers themselves never fall back."""
    from vqvae3d_tpu_torch.models import blocks, quantizer
    from vqvae3d_tpu_torch.ops import quantizer_ops, stack_kernel

    saved = blocks.preact_stack_fused, quantizer.l2_argmin
    blocks.preact_stack_fused = lambda x, w1s, w2s, w3s, sc8, pad_mode: (
        stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode))
    quantizer.l2_argmin = quantizer_ops.l2_argmin_plain
    try:
        yield
    finally:
        blocks.preact_stack_fused, quantizer.l2_argmin = saved


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
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
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
    k3 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
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
                k3["plain_ms"] += pms * per_volume
    print(f"K3 worst max|d|/max|ref| by (dtype, blocks): "
          + ", ".join(f"{k[0]} {k[1]}: {v:.3g}" for k, v in sorted(worst.items())))
    results["preact_stack_fwd"] = k3


def phase_main_path(ident, counts, seed, n_volumes, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import save_checkpoint
    from vqvae3d_tpu_torch.cli import decode_embeddings, extract_embeddings
    from vqvae3d_tpu_torch.ops import quantizer_ops, stack_kernel

    rng = np.random.default_rng(seed)
    ct = work / "ct"
    ct.mkdir()
    t0 = time.perf_counter()
    for i in range(n_volumes):
        write_nrrd(ct / f"scan{i}.nrrd", rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    model, cfg = make_model(1, seed, torch.bfloat16, "cpu")
    save_checkpoint(work / "ckpt", model.state_dict(), cfg)
    del model
    print(f"main path set-up: {n_volumes} volumes {VOLUME} + full-config checkpoint "
          f"in {time.perf_counter() - t0:.1f} s")
    stacks = cfg.same_stacks(VOLUME)
    want_k3 = {p: sum(n for q, _, _, n in stacks if q == p) for p in ("encode", "decode")}

    quantizer_ops.l2_argmin.launches = stack_kernel.preact_stack_fused.launches = 0
    t0 = time.perf_counter()
    extract_embeddings.main(extract_embeddings.parse_arguments([
        "--checkpoint-path", str(work / "ckpt"), "--dataset-path", str(ct),
        "--output-path", str(work), "--output-name", "codes", "--rescale-input", "0",
        "--scan-size", *map(str, VOLUME[:2]), "--output-depth", str(VOLUME[2]), "--backend", "file",
        "--device", "cuda",
    ]))
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    got = dict(l2_argmin=quantizer_ops.l2_argmin.launches,
               preact_stack_fwd=stack_kernel.preact_stack_fused.launches)
    want = dict(l2_argmin=cfg.n_enc * n_volumes, preact_stack_fwd=want_k3["encode"] * n_volumes)
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
    quantizer_ops.l2_argmin.launches = stack_kernel.preact_stack_fused.launches = 0
    t0 = time.perf_counter()
    n = decode_embeddings.main(decode_embeddings.parse_arguments(
        [str(work / "samples.db"), str(work / "ckpt"), str(work / "decoded" / "synth"),
         "--volume-shape", *map(str, VOLUME), "--device", "cuda"]))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    got = dict(l2_argmin=quantizer_ops.l2_argmin.launches,
               preact_stack_fwd=stack_kernel.preact_stack_fused.launches)
    want = dict(l2_argmin=0, preact_stack_fwd=want_k3["decode"] * n_volumes)
    print(f"decode_embeddings: {n} volumes in {t_decode:.2f} s (host clock, NRRD writes "
          f"included); launches {got}, config implies {want} [{ident}]")
    if got != want or n != n_volumes:
        raise AssertionError(f"decode launches {got} != {want} or {n} volumes")
    for k in counts:
        counts[k] += got[k]
    for f in sorted((work / "decoded").glob("*.nrrd")):
        vol = read_nrrd(f)
        # elu output >= -1 -> HU >= -2000; a NaN would land at INT_MIN
        if vol.shape != VOLUME or vol.min() < -2000:
            raise AssertionError(f"{f.name}: shape {vol.shape} min {vol.min()}")
    print(f"decoded NRRDs: {n} x {VOLUME} int32, HU in range")


def phase_forward(ident, seed):
    import torch
    from vqvae3d_tpu_torch.ops import quantizer_ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    hu = rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16).astype(np.float32)
    vol = np.clip(hu, HU_MIN, HU_MAX) / HU_SCALE + 1.0  # the loader's HU window
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
        "preact_stack_fwd": ("vqvae3d_tpu_torch/csrc/preact_stack.cu",
                             "vqvae3d_tpu/ops/stack_kernel.py:968"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
