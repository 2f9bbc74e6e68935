"""Profiling: torch.profiler traces, device-memory stats and step timing.

Counterpart of ``sparse_matrix_fine_tuning_tpu/utils/profiling.py`` (the
reference's torch.profiler hook, run_glue.py:728-742, ProfCallback
train_utils.py:558-566):
  * ``trace(log_dir)`` profiles a block with ``torch.profiler`` (the CPU,
    and the card where there is one) and writes a Chrome trace into
    ``log_dir`` (TensorBoard's and Perfetto's format);
  * ``device_memory_stats()`` reads the card's allocator under the JAX
    version's key names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``), one entry a visible CUDA device;
  * ``StepTimer`` times steps on the host clock, synchronising the card
    first so that a step's queued kernels count in its time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace(dir) as prof: run_steps()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")


def device_memory_stats() -> dict:
    """Per-device memory usage in bytes, as the JAX version names it:
    in use, the peak since the last ``torch.cuda.reset_peak_memory_stats``,
    and the card's total."""
    stats = {}
    for i in range(torch.cuda.device_count()):
        stats[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


class StepTimer:
    """Rolling step timing (throughput reporting for a train loop): each
    ``tick`` synchronises the card, where there is one, before it reads the
    clock."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> Optional[float]:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_s(self) -> Optional[float]:
        return sum(self._times) / len(self._times) if self._times else None
