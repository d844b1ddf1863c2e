"""Halo exchange of H planes between the slabs of a space group.

Under ``--mesh-shape d s`` with s > 1 (``parallel/mesh.py``) each rank of a
space group holds one contiguous H slab of every activation, slab i the
rows [i H/s, (i + 1) H/s) of the whole volume. An op that reads rows past
its slab's edges (a conv's padding, the trilinear upsample's neighbour
taps) takes them from the two space neighbours:

  * ``exchange``: an autograd Function that pads H of (B, C, H, W, D) by k
    planes a side, the previous slab's last k rows below and the next
    slab's first k rows above. At the volume's true ends it applies the
    op's own edge rule: the ring (slab 0 <-> slab s - 1) for 'wrap', zero
    planes for 'zeros', the slab's own edge row repeated for 'clamp' (the
    trilinear upsample's clamped edge, ``ops/resize.py``). Its backward
    sends each halo plane's cotangent back to the rank that owns the row
    and adds it to that row ('clamp' adds it to the edge row itself,
    'zeros' drops it);
  * ``swap_edges``: the raw exchange of two edge planes, for code that
    fills halo rows itself (kernel K3's stack buffers,
    ``ops/stack_kernel.py``).

Every exchange is one ``all_gather`` of the ranks' two edge planes over the
space group (gloo stages CUDA tensors through the host). ``active()`` is
true under a space axis of more than one rank; ``suspended()`` turns the
exchange off for code that pads a buffer whose halo rows it fills itself.
``whole()`` marks code that runs on whole volumes which every rank of the
space group holds alike (the levels whose code grid's H the space axis does
not divide, ``models/vqvae.py``): no exchange, and ``counted()`` tells a
sum over the world to take such values from the group's first rank only.
A failed collective raises; nothing falls back to a whole volume.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
import torch.distributed as dist

from vqvae3d_tpu_torch.parallel import mesh

EDGES = ("wrap", "zeros", "clamp")
_LOCAL = threading.local()


def active() -> bool:
    """True when H is split over a space group and no caller suspended the
    exchange."""
    return mesh.space_size() > 1 and not getattr(_LOCAL, "suspended", False)


@contextlib.contextmanager
def suspended():
    """Ops inside pad their input as a whole volume (no exchange)."""
    prev = getattr(_LOCAL, "suspended", False)
    _LOCAL.suspended = True
    try:
        yield
    finally:
        _LOCAL.suspended = prev


@contextlib.contextmanager
def whole():
    """Ops inside run on whole volumes, the same on every rank of the space
    group: no exchange (as under ``suspended()``), and ``replicated()`` is
    true."""
    prev = getattr(_LOCAL, "whole", False)
    _LOCAL.whole = True
    try:
        with suspended():
            yield
    finally:
        _LOCAL.whole = prev


def replicated() -> bool:
    """True inside ``whole()`` under a space axis of more than one rank: the
    values are copies, one a rank of the space group."""
    return mesh.space_size() > 1 and getattr(_LOCAL, "whole", False)


def counted() -> bool:
    """Whether this rank's values enter a sum over the world: a slab's
    always; of the copies ``replicated()`` marks, only the space group's
    first rank's, so the sum counts them once."""
    return not replicated() or mesh.space_index() == 0


def ends() -> Tuple[bool, bool]:
    """(whether this slab holds the volume's first row, its last row)."""
    return mesh.space_index() == 0, mesh.space_index() == mesh.space_size() - 1


def swap_edges(first: torch.Tensor, last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank of the space group sends ``first`` and ``last`` (two
    tensors of one shape: planes at its slab's two edges); returns (the
    previous slab's ``last``, the next slab's ``first``) in ring order, on
    the inputs' device (slab 0's previous slab is slab s - 1)."""
    s, i = mesh.space_size(), mesh.space_index()
    both = mesh.staged(torch.stack([first, last]))
    parts = [torch.empty_like(both) for _ in range(s)]
    dist.all_gather(parts, both, group=mesh.space_group())
    return parts[(i - 1) % s][1].to(first.device), parts[(i + 1) % s][0].to(first.device)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k: int, edge: str):
        h = x.shape[2]
        if not 1 <= k <= h:
            raise ValueError(f"halo of {k} rows on a slab of {h}")
        first, last = ends()
        below, above = swap_edges(x[:, :, :k], x[:, :, h - k:])
        if first and edge != "wrap":
            below = torch.zeros_like(below) if edge == "zeros" else x[:, :, :1].expand_as(below)
        if last and edge != "wrap":
            above = torch.zeros_like(above) if edge == "zeros" else x[:, :, h - 1:].expand_as(above)
        ctx.k, ctx.edge = k, edge
        return torch.cat([below, x, above], 2)

    @staticmethod
    def backward(ctx, g):
        k, edge = ctx.k, ctx.edge
        h = g.shape[2] - 2 * k
        g_below, g_above = g[:, :, :k], g[:, :, h + k:]
        dx = g[:, :, k:h + k].clone()
        # the previous slab's rows above it are my first rows; the next's below, my last
        from_prev, from_next = swap_edges(g_below, g_above)
        first, last = ends()
        if not first or edge == "wrap":
            dx[:, :, :k] += from_prev
        elif edge == "clamp":
            dx[:, :, :1] += g_below.sum(2, keepdim=True)
        if not last or edge == "wrap":
            dx[:, :, h - k:] += from_next
        elif edge == "clamp":
            dx[:, :, h - 1:] += g_above.sum(2, keepdim=True)
        return dx, None, None


def exchange(x: torch.Tensor, k: int, edge: str) -> torch.Tensor:
    """(B, C, H, W, D) slab -> (B, C, H + 2k, W, D): k planes a side from
    the neighbouring slabs, the volume's ends by ``edge`` ('wrap', 'zeros'
    or 'clamp'; 'clamp' takes k = 1)."""
    if edge not in EDGES:
        raise ValueError(f"unknown halo edge rule {edge!r}")
    if edge == "clamp" and k != 1:
        raise ValueError("the clamped edge repeats one row")
    return _Exchange.apply(x, k, edge)
