"""Codebook nearest-neighbour lookup (kernels K1a, K1b) and plain versions.

Counterpart of ``vqvae3d_tpu/ops/quantizer_ops.py``:

  * ``l2_argmin`` replaces the serving kernel ``l2_argmin_pallas``
    (``csrc/l2_argmin.cu``);
  * ``l2_argmin_stats`` replaces the training kernel
    ``l2_argmin_stats_pallas``: the same lookup fused with the EMA cluster
    statistics, per-code counts and sums of the rows
    (``csrc/l2_argmin_stats.cu``, deterministic).

On a CUDA tensor each launches its hand-written kernel (source notes there:
what bounds it, what the design does); on a CPU tensor it runs its plain
version. All compute ``argmin_k(|e_k|^2 - 2 x.e_k)`` in fp32 with ties to
the lowest index.
"""
from __future__ import annotations

import torch

from vqvae3d_tpu_torch.ops import _build


def l2_argmin_plain(flat: torch.Tensor, embed: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
    """(N, D), (K, D) -> (N,) int64 nearest-code indices, fp32.

    Chunked over N so the (chunk, K) distance block stays small. On a card,
    run it with ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's
    default) so the product is true fp32."""
    e = embed.float()
    e2 = (e * e).sum(-1)
    x = flat.float()
    out = [
        torch.argmin(e2 - 2.0 * (x[i : i + chunk] @ e.T), dim=-1)
        for i in range(0, x.shape[0], chunk)
    ]
    if not out:
        return torch.empty(0, dtype=torch.int64, device=flat.device)
    return torch.cat(out)


def l2_argmin(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest codebook index per row: (N, D), (K, D) -> (N,) int64.

    CPU tensors take ``l2_argmin_plain``; CUDA tensors launch kernel K1 and
    add one to ``l2_argmin.launches`` per launch."""
    if flat.device.type == "cpu":
        return l2_argmin_plain(flat, embed)
    if flat.device.type != "cuda":
        raise NotImplementedError(f"l2_argmin: no kernel for device {flat.device}")
    if flat.ndim != 2 or embed.ndim != 2 or flat.shape[1] != embed.shape[1]:
        raise ValueError(f"l2_argmin: shapes {tuple(flat.shape)} vs {tuple(embed.shape)}")
    if embed.device != flat.device:
        raise ValueError("l2_argmin: flat and embed lie on different devices")
    n, d = flat.shape
    k = embed.shape[0]
    if d > 64:
        raise ValueError(f"l2_argmin kernel takes D <= 64, got {d}")
    x = flat.float().contiguous()
    e = embed.float().contiguous()
    e2 = (e * e).sum(-1).contiguous()
    out = torch.empty(n, dtype=torch.int64, device=flat.device)
    lib = _build.library()
    _build.check(
        lib.vq_l2_argmin(
            x.data_ptr(), e.data_ptr(), e2.data_ptr(), out.data_ptr(),
            n, k, d, _build.stream_ptr(flat.device),
        ),
        "l2_argmin",
    )
    l2_argmin.launches += 1
    return out


l2_argmin.launches = 0


def l2_argmin_stats_plain(flat: torch.Tensor, embed: torch.Tensor):
    """(N, D), (K, D) -> (idx (N,) int64, counts (K,) fp32, dw (K, D) fp32):
    the lookup, then per-code row counts and row sums by ``index_add_``
    (``l2_argmin_stats_ref``, vqvae3d_tpu/ops/quantizer_ops.py:242-255)."""
    idx = l2_argmin_plain(flat, embed)
    k, d = embed.shape
    x = flat.float()
    counts = torch.zeros(k, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, idx, torch.ones_like(x[:, 0]))
    dw = torch.zeros(k, d, dtype=torch.float32, device=flat.device)
    dw.index_add_(0, idx, x)
    return idx, counts, dw


STATS_CTAS = 264  # pass-1 CTAs of K1b at most: two per SM of an H100


def l2_argmin_stats(flat: torch.Tensor, embed: torch.Tensor):
    """Fused lookup + EMA statistics: (N, D), (K, D) -> (idx (N,) int64,
    counts (K,) fp32, dw (K, D) fp32).

    CPU tensors take ``l2_argmin_stats_plain``; CUDA tensors launch kernel
    K1b and add one to ``l2_argmin_stats.launches``. The kernel's sums are
    deterministic: the same inputs give bit-identical counts and dw."""
    if flat.device.type == "cpu":
        return l2_argmin_stats_plain(flat, embed)
    if flat.device.type != "cuda":
        raise NotImplementedError(f"l2_argmin_stats: no kernel for device {flat.device}")
    if flat.ndim != 2 or embed.ndim != 2 or flat.shape[1] != embed.shape[1]:
        raise ValueError(f"l2_argmin_stats: shapes {tuple(flat.shape)} vs {tuple(embed.shape)}")
    if embed.device != flat.device:
        raise ValueError("l2_argmin_stats: flat and embed lie on different devices")
    n, d = flat.shape
    k = embed.shape[0]
    if d > 32:
        raise ValueError(f"l2_argmin_stats kernel takes D <= 32, got {d}")
    x = flat.float().contiguous()
    e = embed.float().contiguous()
    e2 = (e * e).sum(-1).contiguous()
    nblk = max(1, min(-(-n // 256), STATS_CTAS))
    idx = torch.empty(n, dtype=torch.int64, device=flat.device)
    counts = torch.empty(k, dtype=torch.float32, device=flat.device)
    dw = torch.empty(k, d, dtype=torch.float32, device=flat.device)
    part = torch.empty(nblk * k * (d + 1), dtype=torch.float32, device=flat.device)
    _build.check(
        _build.library().vq_l2_argmin_stats(
            x.data_ptr(), e.data_ptr(), e2.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            dw.data_ptr(), part.data_ptr(), nblk, n, k, d, _build.stream_ptr(flat.device),
        ),
        "l2_argmin_stats",
    )
    l2_argmin_stats.launches += 1
    return idx, counts, dw


l2_argmin_stats.launches = 0


def genuine_ties(flat: torch.Tensor, embed: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 rel: float = 1e-5):
    """Split the rows where index vectors ``a`` and ``b`` disagree into
    (ties, real): a tie when the fp64 squared distances to the two codes lie
    within ``rel`` of the row's distance scale (|x|^2 + max|e|^2). fp32 sums
    taken in another order may break such a tie either way."""
    diff = torch.nonzero(a != b).flatten()
    if diff.numel() == 0:
        return diff, diff
    x, e = flat[diff].double(), embed.double()
    da = ((x - e[a[diff]]) ** 2).sum(-1)
    db = ((x - e[b[diff]]) ** 2).sum(-1)
    scale = (x * x).sum(-1) + (e * e).sum(-1).max()
    tie = (da - db).abs() <= rel * scale
    return diff[tie], diff[~tie]
