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

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points: name -> argtypes (every one returns an int error code)
SIGNATURES = {
    # K1a: x, embed, e2, out, n, k, d, stream
    "vq_l2_argmin": [_p, _p, _p, _p, _i64, _i, _i, _p],
    # K1b: x, embed, e2, idx, counts, dw, part, nblk, n, k, d, stream
    "vq_l2_argmin_stats": [_p, _p, _p, _p, _p, _p, _p, _i, _i64, _i, _i, _p],
    # K3: is_bf16, x, w1, w2, w3, sc, a2, a3, y, batch, h, w, d, c, cb,
    #     cob_b, cob_c, wrap, stream
    "vq_preact_block_fwd": [
        _i, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _i, _i, _i, _i, _i,
        _i, _i, _i, _p,
    ],
    # K3 backward: is_bf16, x, gy, w1, w2, w3, w1t, w2t, w3t, sc, work, sv,
    #     part, part_len, dx, dw1, dw2, dw3, dsc, batch, h, w, d, c, cb,
    #     cob_b, cob_c, wrap, stream
    "vq_preact_block_bwd": [
        _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _p, _p, _p, _p, _p,
        _i64, _i, _i, _i, _i, _i, _i, _i, _i, _p,
    ],
    # K7: is_bf16, x, g, dw, part, nchunks, batch, cin, cout, hp, wp, dp, kh,
    #     kw, kd, stream
    "vq_dw_conv3d": [_i, _p, _p, _p, _p, _i, _i64, _i, _i, _i, _i, _i, _i, _i, _i, _p],
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
