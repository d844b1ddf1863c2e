"""Step timing of the training CLIs.

Counterpart of ``vqvae3d_tpu/utils/profiling.py::StepTimer``: a step timer
with a warm-up-aware running mean. On a CUDA device it times the device's
stream with CUDA events and synchronises at the end of each step, so a step's
time is the device's, not the host's enqueue; on the CPU it uses the host
clock.

    timer = StepTimer(device)
    with timer:
        log = train_step(batch)
    print(timer.last_ms, timer.mean_ms)
"""
from __future__ import annotations

import time

import torch


class StepTimer:
    def __init__(self, device=None, skip_first: int = 1):
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self.skip_first = skip_first
        self.count = 0
        self.total_ms = 0.0
        self.last_ms = float("nan")

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            self.last_ms = self._start.elapsed_time(self._end)
        else:
            self.last_ms = 1e3 * (time.perf_counter() - self._t0)
        self.count += 1
        if self.count > self.skip_first:
            self.total_ms += self.last_ms

    @property
    def mean_ms(self) -> float:
        """The mean over the steps after the warm-up; the last step's time
        until there is one."""
        n = self.count - self.skip_first
        return self.total_ms / n if n > 0 else self.last_ms
