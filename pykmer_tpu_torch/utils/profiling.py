"""Profiling hooks.

The reference's profiling story is `pypy -m cProfile` plus the Timer's bp/s
fields (README.md:255-259, tools.py:24-64). GPU equivalent: wrap pipeline
sections in a `torch.profiler` trace (a chrome trace, viewable in Perfetto)
while keeping the same durable Timer fields in `.kin.json`.

Copy of ``pykmer_tpu/utils/profiling.py``, held against it
by ``tests/test_torch_copies.py``, with ``jax.profiler.trace`` mapped to
``torch.profiler.profile`` and ``TraceAnnotation`` to
``torch.profiler.record_function``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace when ``log_dir`` (or
    PYKMER_TPU_TRACE_DIR) is set, written there as a chrome trace
    ``trace_<pid>_<ns>.json``; no-op otherwise. The card's activity is
    recorded where CUDA is available, the host's always."""
    log_dir = log_dir or os.environ.get("PYKMER_TPU_TRACE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-span inside a device trace (record_function)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StageTimer:
    """Wall-clock per-stage accounting printed as an aligned table."""

    def __init__(self) -> None:
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(dt for _, dt in self.stages) or 1e-9
        rows = [
            f"  {name:24s} {dt * 1e3:10.1f} ms {dt / total * 100.0:6.1f}%"
            for name, dt in self.stages
        ]
        return "\n".join(rows)
