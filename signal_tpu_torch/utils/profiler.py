"""Profiling and timing helpers (port of `signal_tpu/utils/profiler.py`).

``trace`` records a host and device timeline with ``torch.profiler`` and
writes it as a Chrome trace (Perfetto or ``chrome://tracing`` open it);
``time_fn`` times a call by the host clock around work that ends in
``torch.cuda.synchronize``; ``StepTimer`` keeps the reference's 'Time per
batch / Speed' accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block: ``with trace('out/trace'): step()`` writes
    ``out/trace/trace.json`` (CPU activity, and CUDA activity where there
    is a card). Yields the profiler, whose ``key_averages()`` sums time
    by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall seconds per call of ``fn(*args)``, each call ended by
    ``torch.cuda.synchronize()`` where there is a card (a card runs
    asynchronously: without it the clock measures the enqueue)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


class StepTimer:
    """Per-epoch time/throughput accounting matching the reference's
    'Time per batch / Speed' log line."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.time()
        self.batches = 0

    def tick(self, n: int = 1):
        self.batches += n

    def summary(self, batch_size: int):
        elapsed = time.time() - self.start
        per_batch = elapsed / max(self.batches, 1)
        return per_batch, batch_size / per_batch
