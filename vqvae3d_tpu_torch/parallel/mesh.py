"""The (data, space) mesh of ranks and the collectives the train path uses.

Counterpart of ``vqvae3d_tpu/parallel/mesh.py``. The JAX package shards the
batch on a mesh's ``data`` axis and, with ``--mesh-shape d s``, the volume's
H on a ``space`` axis, and lets GSPMD derive the collectives; the port's
mesh is the process group (one process per card, ``parallel/multihost.py``)
laid out as d x s, rank r = i_data * s + i_space. The s ranks of a space
group share one slice of every global batch, each holding one contiguous H
slab of every activation (``parallel/halo.py`` exchanges the planes the
convs read across slab edges), except in the levels whose code grid's H s
does not divide: those run whole on every rank of the group
(``models/vqvae.py``; the JAX quantizer's ``_shardable`` fallback). The
collectives are written out:

  * ``average_gradient``: the flat gradient vector that
    ``train.state.AMSGrad`` builds (``optax.flatten``'s layout), summed over
    ``space`` (each rank's loss is its slab's part of its space group's) and
    averaged over ``data``: one all-reduce over the world, divided by d;
  * ``AllReduceSum``: a sum over every rank (or over a group: the rank's
    space group for EvoNorm's group statistics) that autograd
    differentiates (its backward sums the incoming gradient over the same
    ranks), for statistics that carry a gradient (the quantizer's
    first-pass mean and std); a rank whose copy is not ``counted`` sends
    zeros (a whole level's statistics count once over the space group);
  * ``all_reduce_dict``: the sum / mean / min / max over ranks of a dict of
    0-d tensors (the log's global values), one collective a dict; 'mean' is
    the mean over ``data`` of sums over ``space``, so a rank passes its
    slab's part of its space group's value;
  * ``all_gather_flat``: the ranks' 1-D tensors end to end (the eval
    medians); ``space_gather``: the space group's slabs along H (the eval
    SSIM, which needs whole H x W slices);
  * ``gather_slabs``: ``space_gather`` that autograd differentiates, into
    the first whole level; its backward is each rank's slab of the sum of
    the ranks' gradients (a reduce-scatter over the space group).
    ``space_slab``, the rank's slab of a whole tensor, is its inverse out of
    the finest whole level (its backward pads with zeros).

Collectives on CUDA tensors under gloo go through the host where gloo
needs it. Without a process group, or at world size 1, every function
returns its input unchanged (``average_gradient`` still runs its all-reduce
when a group exists).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from vqvae3d_tpu_torch.parallel.multihost import rank, world_size


class _Mesh:
    """This process's place on the mesh: the space axis' size, and the
    process group of the rank's space group (None at s = 1)."""

    space = 1
    group: Optional[dist.ProcessGroup] = None


_MESH = _Mesh()


def check_mesh_shape(mesh_shape: Optional[Sequence[int]], world: int,
                     stem_h: Optional[int] = None) -> int:
    """Validate ``--mesh-shape`` (``d``, ``d 1`` or ``d s``) against the
    process group: d x s must be the world size, and s must divide
    ``stem_h``, the H of the stem's output (the volume's H over
    ``stem_space_to_depth``), so that every slab holds whole stem blocks.
    The levels whose code grid's H s does not divide run whole
    (``models/vqvae.py``). Returns d."""
    if not mesh_shape:
        return world
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) > 2 or min(shape) < 1:
        raise ValueError(f"--mesh-shape {shape}: at most (data, space), each at least 1")
    d, s = shape[0], shape[1] if len(shape) == 2 else 1
    if d * s != world:
        raise ValueError(f"--mesh-shape {shape}: data x space must equal the world size "
                         f"({world} processes, one a card)")
    if s > 1 and (stem_h is None or stem_h % s):
        raise ValueError(f"--mesh-shape {shape}: the space axis must divide the H of the "
                         f"stem's output ({stem_h})")
    return d


def init_mesh(space: int) -> None:
    """Lay the process group out as (world / space) x ``space``: build every
    space group (each rank takes part in every ``new_group`` call, in the
    same order) and keep this rank's. ``space`` 1 is the data-parallel
    layout and builds no group."""
    world = world_size()
    if world % space:
        raise ValueError(f"a space axis of {space} does not divide {world} processes")
    group = None
    for first in range(0, world, space) if space > 1 else ():
        g = dist.new_group(list(range(first, first + space)))
        if first <= rank() < first + space:
            group = g
    _MESH.space, _MESH.group = space, group


def reset_mesh() -> None:
    """Back to the data-parallel layout (the process group left)."""
    _MESH.space, _MESH.group = 1, None


def space_size() -> int:
    """s: the ranks that share one batch slice, an H slab each."""
    return _MESH.space


def space_index() -> int:
    """This rank's slab: its place in its space group."""
    return rank() % _MESH.space


def space_group() -> Optional[dist.ProcessGroup]:
    return _MESH.group


def data_size() -> int:
    """d: the batch slices of a global batch."""
    return world_size() // _MESH.space


def data_index() -> int:
    """This rank's batch slice."""
    return rank() // _MESH.space


def local_batch_size(global_batch: int, slices: int) -> int:
    """A batch slice's share of the global batch, which must divide evenly."""
    if global_batch % slices:
        raise ValueError(f"--batch-size {global_batch} (the global batch) does not divide "
                         f"over {slices} processes")
    return global_batch // slices


def data_parallel() -> bool:
    """True when more than one rank takes part in the step."""
    return world_size() > 1


def average_gradient(flat: torch.Tensor) -> None:
    """Replace the flat fp32 gradient by its sum over ``space`` averaged over
    ``data``, in place: one all-reduce whenever a process group exists (at
    world size 1 an exact copy)."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(flat)
        flat.div_(data_size())


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of ``group`` (None: every rank);
    its gradient is the incoming gradient summed over the same ranks (every
    rank's loss reads the sum). A rank that passes ``counted=False`` adds
    zeros and takes a zero gradient, but joins both collectives."""

    @staticmethod
    def forward(ctx, x, group=None, counted=True):
        ctx.group, ctx.counted = group, counted
        out = x.clone() if counted else torch.zeros_like(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return (out if ctx.counted else torch.zeros_like(out)), None, None


def staged(x: torch.Tensor) -> torch.Tensor:
    """x where the backend gathers it: on the host under gloo."""
    return x.cpu() if x.is_cuda and dist.get_backend() == "gloo" else x


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def all_reduce_dict(values: Dict[str, torch.Tensor], op: str) -> Dict[str, torch.Tensor]:
    """The sum, mean, min or max over ranks of each 0-d tensor of
    ``values``, in one collective (fp32). 'mean' sums over the world and
    divides by the data axis' size: the mean over batch slices of each
    space group's sum of its slabs' parts (at s = 1 the mean over ranks)."""
    if not data_parallel() or not values:
        return values
    flat = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(flat, op=_OPS[op])
    if op == "mean":
        flat /= data_size()
    return dict(zip(values, flat.unbind()))


def all_gather_flat(x: torch.Tensor) -> torch.Tensor:
    """The ranks' 1-D tensors end to end, in rank order (their lengths may
    differ: a slab's share of the cylinder mask is its own)."""
    if not data_parallel():
        return x
    host = staged(x)
    n = torch.tensor([host.numel()], device=host.device)
    sizes = [torch.empty_like(n) for _ in range(world_size())]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=host.dtype, device=host.device)
    padded[: host.numel()] = host
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(x.device)


def space_gather(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The space group's slabs of x end to end along ``dim`` (H), in slab
    order: the whole volume on every rank of the group."""
    if _MESH.space == 1:
        return x
    host = staged(x).contiguous()
    parts = [torch.empty_like(host) for _ in range(_MESH.space)]
    dist.all_gather(parts, host, group=_MESH.group)
    return torch.cat(parts, dim).to(x.device)


class _GatherSlabs(torch.autograd.Function):
    """``space_gather`` along H with its backward: every rank of the space
    group reads the whole tensor, so the gradient of a rank's slab is the
    sum of the ranks' gradients at its rows, taken as an all-reduce over
    the group in at least fp32 and the rank's slab of it (gloo takes CUDA
    tensors in an all-reduce, not in a reduce-scatter), rounded to the
    gradient's dtype."""

    @staticmethod
    def forward(ctx, x):
        return space_gather(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.promote_types(grad.dtype, torch.float32)).contiguous().clone()
        dist.all_reduce(total, group=_MESH.group)
        return space_slab(total).to(grad.dtype)


def gather_slabs(x: torch.Tensor) -> torch.Tensor:
    """The space group's H slabs of (B, C, H/s, W, D) end to end, as one
    (B, C, H, W, D) on every rank of the group, differentiable."""
    return x if _MESH.space == 1 else _GatherSlabs.apply(x)


def space_slab(x: torch.Tensor) -> torch.Tensor:
    """This rank's H slab of a whole (B, C, H, W, D), H a multiple of s;
    autograd's backward of the slice pads the slab's gradient with zeros."""
    if _MESH.space == 1:
        return x
    h = x.shape[2] // _MESH.space
    return x.narrow(2, space_index() * h, h).contiguous()
