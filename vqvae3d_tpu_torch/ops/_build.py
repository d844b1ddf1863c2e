"""Build the port's CUDA kernels and load them through ctypes.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes). The sources compile in parallel, one ``nvcc`` each, and
are linked once. The library lands in ``vqvae3d_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the sources' hash, so a changed source
rebuilds and an unchanged one loads at once. Nothing is built at import time:
``library()`` builds on first use.

Every C entry point takes PyTorch's current CUDA stream and returns
``cudaGetLastError()``; ``check`` raises when that is not 0, so a refused
launch (too many threads, too much shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_p, _i, _i64, _f, _u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_uint32)
# C entry points: name -> argtypes (every one returns an int error code)
SIGNATURES = {
    # K1a: x, embed, out, n, k, d, rows, lanes, stream
    "vq_l2_argmin": [_p, _p, _p, _i64, _i, _i, _i, _i, _p],
    # K1b: x, embed, idx, counts, dw, part, nblk, n, k, d, rows, lanes, slabs, stream
    "vq_l2_argmin_stats": [_p, _p, _p, _p, _p, _p, _i, _i64, _i, _i, _i, _i, _i, _p],
    # K3: is_bf16, x, w1, w2, w3, sc, a2, a3, y, batch, h, w, d, c, cb,
    #     cob_b, cob_c, wrap, stream
    "vq_preact_block_fwd": [
        _i, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _i, _i, _i, _i, _i,
        _i, _i, _i, _p,
    ],
    # K3 forward, bf16 fused: x, w1, w2, w3, sc, y, batch, h, w, d, c, cb, cbp,
    #     tensor_cores, wrap, bh, bw, bd, stream
    "vq_preact_block_fwd_fused": [_p] * 6 + [_i64] + [_i] * 11 + [_p],
    # K3 backward: is_bf16, tensor_cores, x, gy, w1, w2, w3, w1t, w2t, w3t, sc,
    #     work, sv, part, part_len, chunks_w1, chunks_w2, chunks_w3, dx, dw1,
    #     dw2, dw3, dsc, batch, h, w, d, c, cb, cob_b, cob_c, wrap, stream
    "vq_preact_block_bwd": [
        _i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _i, _i, _i, _p, _p, _p,
        _p, _p, _i64, _i, _i, _i, _i, _i, _i, _i, _i, _p,
    ],
    # K3 backward, bf16 brick route: x, gy, w1, w2, w3, w3t, w2m, w1n, sc, work, sp,
    #     part, part_len, chunks_w1, chunks_w2, chunks_w3, dx, dw1, dw2, dw3, dsc,
    #     batch, h, w, d, c, cb, cbp, wrap, bh, bw, bd, stream
    "vq_preact_block_bwd_brick": [_p] * 12 + [_i64, _i, _i, _i] + [_p] * 5 + [_i64]
    + [_i] * 10 + [_p],
    # K7: is_bf16, tensor_cores, x, g, dw, part, nchunks, batch, cin, cout, hp,
    #     wp, dp, kh, kw, kd, brick_h, brick_w, brick_d, stream
    "vq_dw_conv3d": [_i, _i, _p, _p, _p, _p, _i, _i64] + [_i] * 11 + [_p],
    # K4: is_bf16, x, cond, keep, denom, w1, be, wu, w3, wc, bc, sc, a2, a3, y,
    #     batch, s0, s1, s2, cu, cb, cc, cob_b, cob_u, stream
    "vq_causal_block_fwd": [_i, _p, _p, _p, _f] + [_p] * 10 + [_i64] + [_i] * 8 + [_p],
    # K4, bf16 tensor cores: x, cond, keep, denom, w1e, be, wuf, w3t, wct, bc, sc,
    #     a2, y, batch, s0, s1, s2, cu, cb, cc, n0, n1, n2, stream
    "vq_causal_block_fwd_tc": [_p] * 3 + [_f] + [_p] * 9 + [_i64] + [_i] * 9 + [_p],
    # K4 backward: is_bf16, x, gy, cond, keep, denom, w1, be, wu, w3, wc, bc, sc,
    #     w1t, wut, w3t, wct, work, gm, sv, part, part_len, dx, gcond, dw1, dbe,
    #     dwu, dw3, dwc, dbc, dsc, batch, s0, s1, s2, cu, cb, cc, cob_b, cob_u,
    #     cob_c, stream
    "vq_causal_block_bwd": [_i, _p, _p, _p, _p, _f] + [_p] * 15 + [_i64] + [_p] * 9
    + [_i64] + [_i] * 9 + [_p],
    # K4 backward, bf16 tensor cores: x, gy, cond, keep, denom, w1e, be, wuf, wut,
    #     w3, w3t, wct, bc, wcn, w1n, sc, work, part, part_len, ctas_mid,
    #     ctas_dgrad, dx, gcond, dw1, dbe, dwu, dw3, dwc, dbc, dsc, batch, s0, s1,
    #     s2, cu, cb, cc, n0, n1, n2, stream
    "vq_causal_block_bwd_tc": [_p] * 4 + [_f] + [_p] * 13 + [_i64, _i, _i] + [_p] * 9
    + [_i64] + [_i] * 9 + [_p],
    # K6: w1, wk, w3, b3, sc, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw,
    #     w_in, b_in, w_out, b_out, d2h, d2w, cnd, dfin, sprev, vhc, gumbel,
    #     forced, out, logits, L, B, s2, C, br, ws, K, i1, tau, cycles, stream
    "vq_row_decode": [_p] * 27 + [_i] * 8 + [ctypes.c_float, _p, _p],
    # K6 wide: the same arguments as vq_row_decode but cycles
    "vq_row_decode_wide": [_p] * 27 + [_i] * 8 + [ctypes.c_float, _p],
    # the wide K6's exchange alone, at its cluster size: exchange (0: a
    #     cluster barrier, 1: st.async and an mbarrier), iters, stream
    "vq_cluster_exchange_probe": [_i, _i, _p],
    # K8: is_bf16, q, k, v, o, lse, N, S, D, scale, stream
    "vq_flash_attn_fwd": [_i] + [_p] * 5 + [_i] * 3 + [_f, _p],
    # K8 backward: is_bf16, q, k, v, o, do, lse, delta, dq, dk, dv, N, S, D,
    #     scale, stream
    "vq_flash_attn_bwd": [_i] + [_p] * 10 + [_i] * 3 + [_f, _p],
    # K5: is_bf16, tensor_cores, q, k, v, o, lse, seed, mask, N, S, D, scale,
    #     thr, inv_keep, stream
    "vq_flash_dropout_fwd": [_i, _i] + [_p] * 7 + [_i] * 3 + [_f, _u32, _f, _p],
    # K5 backward: is_bf16, tensor_cores, q, k, v, o, do, lse, delta, seed, bits,
    #     dq, dk, dv, N, S, D, scale, thr, inv_keep, stream
    "vq_flash_dropout_bwd": [_i, _i] + [_p] * 12 + [_i] * 3 + [_f, _u32, _f, _p],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of vqvae3d_tpu_torch cannot be built"
        )
    return found


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every csrc/*.cu (in parallel) and link them into one .so.

    Returns the library's path; reuses it when the sources are unchanged."""
    srcs = sources()
    lib_path = BUILD_DIR / f"libvqvae3d_kernels_{_digest(srcs)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vq_error_string.argtypes = [ctypes.c_int]
            lib.vq_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().vq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
