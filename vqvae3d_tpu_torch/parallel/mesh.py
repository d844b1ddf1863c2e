"""The data-parallel world and the collectives the train path uses.

Counterpart of ``vqvae3d_tpu/parallel/mesh.py``. The JAX package shards the
batch on a mesh's ``data`` axis and lets GSPMD derive the collectives; the
port's data-parallel world is the process group (one process per card,
``parallel/multihost.py``), each rank holds a contiguous slice of every
global batch, and the collectives are written out:

  * ``average_gradient``: the mean over ranks of the flat gradient vector
    that ``train.state.AMSGrad`` builds (``optax.flatten``'s layout), one
    all-reduce before its update;
  * ``AllReduceSum``: a sum over ranks that autograd differentiates (its
    backward sums the incoming gradient over ranks), for statistics that
    carry a gradient (the quantizer's first-pass mean and std);
  * ``all_reduce_dict``: the sum / mean / min / max over ranks of a dict of
    0-d tensors (the log's global values), one collective a dict;
  * ``all_gather_flat``: the ranks' equal-length 1-D tensors end to end (the
    eval medians).

Only ``all_reduce`` is used (and, for the medians, ``all_gather``, staged
through the host under gloo), so gloo also runs them on CUDA tensors.
Without a process group, or at world size 1, every function returns its
input unchanged (``average_gradient`` still runs its all-reduce when a group
exists). ``--mesh-shape d s`` with s > 1 (the JAX package's
spatial sharding of H over a ``space`` axis) is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from vqvae3d_tpu_torch.parallel.multihost import world_size


def check_mesh_shape(mesh_shape: Optional[Sequence[int]], world: int) -> int:
    """Validate ``--mesh-shape`` against the process group: ``N`` or ``N 1``
    with N the world size (one rank a card on the ``data`` axis). Returns
    the data-parallel size."""
    if not mesh_shape:
        return world
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) > 2:
        raise ValueError(f"--mesh-shape {shape}: at most (data, space)")
    if len(shape) == 2 and shape[1] != 1:
        raise NotImplementedError(
            f"--mesh-shape {shape}: spatial sharding (a 'space' axis over H, with halo "
            "exchanges around the convs) is not ported; data parallelism takes 'N' or 'N 1'")
    if shape[0] != world:
        raise ValueError(f"--mesh-shape {shape}: the data axis must equal the world size "
                         f"({world} processes, one a card)")
    return world


def local_batch_size(global_batch: int, world: int) -> int:
    """A rank's share of the global batch, which must divide evenly."""
    if global_batch % world:
        raise ValueError(f"--batch-size {global_batch} (the global batch) does not divide "
                         f"over {world} processes")
    return global_batch // world


def data_parallel() -> bool:
    """True when more than one rank shares the global batch."""
    return world_size() > 1


def average_gradient(flat: torch.Tensor) -> None:
    """Replace the flat fp32 gradient by its mean over ranks, in place: one
    all-reduce whenever a process group exists (at world size 1 an exact
    copy)."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over ranks; its gradient is the incoming
    gradient summed over ranks (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def all_reduce_dict(values: Dict[str, torch.Tensor], op: str) -> Dict[str, torch.Tensor]:
    """The sum, mean, min or max over ranks of each 0-d tensor of
    ``values``, in one collective (fp32)."""
    if not data_parallel() or not values:
        return values
    flat = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(flat, op=_OPS[op])
    if op == "mean":
        flat /= world_size()
    return dict(zip(values, flat.unbind()))


def all_gather_flat(x: torch.Tensor) -> torch.Tensor:
    """The ranks' 1-D tensors (of equal length) end to end, in rank order.
    Under gloo a CUDA tensor goes through the host."""
    if not data_parallel():
        return x
    staged = x.cpu() if x.is_cuda and dist.get_backend() == "gloo" else x
    parts = [torch.empty_like(staged) for _ in range(world_size())]
    dist.all_gather(parts, staged.contiguous())
    return torch.cat(parts).to(x.device)
