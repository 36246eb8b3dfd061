"""Profiling helpers: a named accumulating timer and a device trace.

Counterpart of `pulse_tpu/utils/benchmarking.py` (≙ the reference's
phc/utils/benchmarking.py timeit context manager with running averages):
`Timer` is the same clock and report; with `block=True` it waits for the
CUDA devices of the tensors in `result` before reading the clock, as the
JAX one blocks until `result` is ready. `device_trace` captures a
`torch.profiler` trace, with CUDA activity where there is a card, into a
directory, as the JAX one captures an XProf trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def synchronize(result) -> None:
    """Wait for the work queued on the CUDA device of every tensor in
    `result` (a tensor or a nest of lists, tuples, dicts and dataclasses)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(result)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named timer with running averages."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, block: bool = False, result=None):
        t0 = time.perf_counter()
        yield
        if block and result is not None:
            synchronize(result)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = [
            f"{name}: total {self.totals[name]:.3f}s over {self.counts[name]} "
            f"calls (avg {self.mean(name)*1e3:.2f} ms)"
            for name in sorted(self.totals)
        ]
        return "\n".join(lines)


timeit = Timer()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a `torch.profiler` trace (CPU, and CUDA where available) of
    the block; it is written to `logdir` as a Chrome trace JSON, viewable in
    TensorBoard's profiler plugin or Perfetto. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
