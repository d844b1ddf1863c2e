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
the lowest index. ``lookup_plan`` and ``stats_plan`` choose the kernels'
work split from (N, K, D) before the launch (``csrc/l2_argmin.cuh``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vqvae3d_tpu_torch.ops import _build

THREADS = 256  # threads a CTA (csrc/l2_argmin.cuh kThreads)
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may opt into (kSmemLimit)
SM_COUNT = 132  # SMs of an H100 SXM
D_CAPS = (2, 4, 8, 16, 32, 64)  # the kernels' register widths DT, by d <= DT


def rows_per_thread(dt: int) -> int:
    """Rows a thread keeps in registers on the large-N route (kRows)."""
    return 8 if dt <= 2 else 4 if dt <= 8 else 2 if dt <= 16 else 1


def code_stride(dt: int) -> int:
    """Floats a code takes in shared memory (code_stride): DT values, the
    norm, padded to an odd number of 16-byte units."""
    units = (dt + 4) // 4
    return 4 * units + (4 if units % 2 == 0 else 0)


class LookupPlan(NamedTuple):
    """The lookup's work split: register width ``dt``, ``rows`` a thread,
    ``lanes`` of a warp sharing them (splitting the codebook), ``tiles`` of
    ``tile_rows`` rows (K1a: one CTA each)."""

    dt: int
    rows: int
    lanes: int
    tiles: int

    @property
    def tile_rows(self) -> int:
        return THREADS // self.lanes * self.rows


def lookup_plan(n: int, k: int, d: int) -> LookupPlan:
    """Split a lookup of n rows against k codes of width d (a route by
    shape, before the launch). Split the codebook across lanes while that
    leaves fewer than one CTA of row groups for each SM and at least 4 codes
    a lane; at large n keep ``rows_per_thread`` rows a thread where that
    still fills every SM that way."""
    dt = next(c for c in D_CAPS if c >= d)
    fill = SM_COUNT * THREADS
    lanes = 1
    while lanes < 32 and n * lanes < fill and k >= 8 * lanes:
        lanes *= 2
    rows = rows_per_thread(dt) if lanes == 1 and n >= fill * rows_per_thread(dt) else 1
    tile_rows = THREADS // lanes * rows
    return LookupPlan(dt, rows, lanes, -(-n // tile_rows))


class StatsPlan(NamedTuple):
    """K1b's split: the lookup's, ``ctas`` pass-1 CTAs (each takes tiles
    b, b + ctas, ...) and ``slabs`` statistics slabs a CTA (8 / slabs warps
    share each, in turn)."""

    lookup: LookupPlan
    ctas: int
    slabs: int


def stats_plan(n: int, k: int, d: int) -> StatsPlan:
    """K1b's split of (n, k, d): the lookup's, at most two CTAs an SM, and as
    many slabs of k (1 + d) floats as fit beside the codebook."""
    plan = lookup_plan(n, k, d)
    code = k * code_stride(plan.dt) * 4
    slab = k * (d + 1) * 4
    slabs = next((g for g in (8, 4, 2, 1) if code + g * slab <= SMEM_LIMIT), 0)
    if not slabs:
        raise ValueError(f"l2_argmin_stats: K={k} codes of D={d} do not fit a CTA's shared memory")
    return StatsPlan(plan, max(1, min(plan.tiles, 2 * SM_COUNT)), slabs)


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
    plan = lookup_plan(n, k, d)
    if k * code_stride(plan.dt) * 4 > SMEM_LIMIT:
        raise ValueError(f"l2_argmin: K={k} codes of D={d} do not fit a CTA's shared memory")
    x = flat.float().contiguous()
    e = embed.float().contiguous()
    out = torch.empty(n, dtype=torch.int64, device=flat.device)
    _build.check(
        _build.library().vq_l2_argmin(
            x.data_ptr(), e.data_ptr(), out.data_ptr(), n, k, d, plan.rows, plan.lanes,
            _build.stream_ptr(flat.device),
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
    plan = stats_plan(n, k, d)
    x = flat.float().contiguous()
    e = embed.float().contiguous()
    idx = torch.empty(n, dtype=torch.int64, device=flat.device)
    counts = torch.empty(k, dtype=torch.float32, device=flat.device)
    dw = torch.empty(k, d, dtype=torch.float32, device=flat.device)
    part = torch.empty(plan.ctas * k * (d + 1), dtype=torch.float32, device=flat.device)
    _build.check(
        _build.library().vq_l2_argmin_stats(
            x.data_ptr(), e.data_ptr(), idx.data_ptr(), counts.data_ptr(), dw.data_ptr(),
            part.data_ptr(), plan.ctas, n, k, d, plan.lookup.rows, plan.lookup.lanes,
            plan.slabs, _build.stream_ptr(flat.device),
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
