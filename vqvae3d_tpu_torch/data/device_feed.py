"""Host-to-device batch prefetch: the step loop never waits on a copy.

Counterpart of the single-device ``device_prefetch`` of
``vqvae3d_tpu/data/device_feed.py:63`` (the reference's DataLoader
``pin_memory`` + non-blocking copies): each host batch (a dict of numpy
arrays) is copied into pinned memory and sent to the device with
``non_blocking=True`` up to ``size`` batches ahead of the consumer.
PyTorch's pinned-memory allocator keeps a pinned buffer alive until its copy
has completed. On a CPU device the arrays are only wrapped as tensors. Under
data parallelism each rank passes its own card (``cuda:<local rank>``, as
``parallel.multihost.initialize_multihost`` returns it), so each pins and
copies its slice of the batch to that card.
"""
from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch


def to_device(batch: dict, device: torch.device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def device_prefetch(iterator: Iterator[dict], device, size: int = 2) -> Iterator[dict]:
    """Yield the iterator's batches as tensors on ``device``, ``size`` ahead."""
    device = torch.device(device)
    queue = collections.deque()
    for batch in iterator:
        queue.append(to_device(batch, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
