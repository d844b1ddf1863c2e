"""Multi-process runtime setup: one process per GPU over ``torch.distributed``.

Counterpart of ``vqvae3d_tpu/parallel/multihost.py``. The JAX package runs
one process per host over its chips; the port runs one process per card
(torch's idiom), so a rank is a card and the world is every card of every
host. The reference launches with SLURM ``srun`` and Lightning's env-based
NCCL rendezvous; either launch form works here:

    # one host, G cards: torchrun sets RANK, WORLD_SIZE, LOCAL_RANK and the
    # rendezvous address (env://)
    torchrun --nproc-per-node G -m vqvae3d_tpu_torch.cli.train_vqvae ... --multihost
    # SLURM, one task per card (SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID)
    srun python -m vqvae3d_tpu_torch.cli.train_vqvae ... \\
        --multihost --coordinator $MASTER_ADDR:8476

Every helper here is also right without a process group (world size 1).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_multihost(coordinator: Optional[str] = None, backend: Optional[str] = None,
                         device: str = "cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Rank and world size come from ``SLURM_PROCID`` / ``SLURM_NTASKS``, as
    the JAX package reads them, else from torchrun's ``RANK`` /
    ``WORLD_SIZE``. The rendezvous is ``tcp://<coordinator>`` when one is
    given (``host:port``; rank 0 listens there), else ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``). On a CUDA ``device`` the rank takes
    card ``LOCAL_RANK`` (or ``SLURM_LOCALID``; 0 when neither is set) and
    the backend is NCCL; on the CPU it is gloo. ``backend`` overrides that
    choice (gloo also carries CUDA tensors, so ranks can share one card)."""
    rank = _env_int("SLURM_PROCID", "RANK")
    world = _env_int("SLURM_NTASKS", "WORLD_SIZE")
    if rank is None or world is None:
        raise RuntimeError("--multihost: no rank or world size in the environment (set "
                           "SLURM_PROCID and SLURM_NTASKS, or launch with torchrun)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK", "SLURM_LOCALID") or 0)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
