"""Profiling hooks: the index's span recorder and its device trace.

The reference's profiling story is `pypy -m cProfile` plus the Timer's bp/s
fields (README.md:255-259, tools.py:24-64). GPU equivalent: wrap pipeline
sections in a `torch.profiler` trace (a chrome trace, viewable in Perfetto)
while keeping the same durable Timer fields in `.kin.json`.

:class:`StageTimer` is the one recorder of an index run. Its stages are the
rows of the table printed under ``PYKMER_TPU_STAGE_TIMING``, exactly as the
original's (``pykmer_tpu/utils/profiling.py``, whose ``report()`` text
``tests/test_torch_copies.py`` holds equal). While the run records, which
it does when ``PYKMER_TPU_STAGE_TIMING`` or ``PYKMER_TPU_TRACE_DIR`` is set,
each stage and each sub-span (:func:`span`) is also kept as a :class:`Span`
on the clock of ``time.time_ns()``, which is the clock of the profiler's
chrome trace (an event's ``ts`` plus the trace's ``baseTimeNanoseconds`` /
1000). Spans opened on the thread that made the timer also enter
``torch.profiler.record_function``, so a device trace names them; the
profiler sees no ``record_function`` of another thread, so spans of worker
threads are kept in memory only, and :func:`device_trace` adds them to the
trace it writes. A finished run is handed to readers in
:data:`FINISHED_RUNS`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple

RUNS_KEPT = 256  # the newest finished runs FINISHED_RUNS holds
# recording runs that have finished, oldest first: the readers' list
FINISHED_RUNS: Deque["StageTimer"] = collections.deque(maxlen=RUNS_KEPT)

_local = threading.local()  # .stack: [(timer, open span)], innermost last


def _stack() -> List[Tuple["StageTimer", "Span"]]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded interval: ``name``; ``start`` and ``end`` in
    ``time.time_ns()``; the ``thread`` it ran on (name, and ``tid`` its
    native id); its ``parent`` span (the innermost open on the same thread,
    or, for work handed to a worker thread, the one open where the work was
    submitted; None for a top-level stage); ``counts`` (bytes, bases,
    cells); ``traced`` where it also entered ``record_function``."""

    __slots__ = ("name", "start", "end", "thread", "tid", "parent", "counts", "traced")

    def __init__(self, name: str, parent: Optional["Span"], counts: Dict[str, int],
                 traced: bool):
        self.name = name
        self.parent = parent
        self.counts = counts
        self.traced = traced
        self.thread = threading.current_thread().name
        self.tid = threading.get_native_id()
        self.start = self.end = 0


class _Open:
    """A span while its block runs: on its thread's stack, and inside a
    ``record_function`` of its name where it is traced."""

    __slots__ = ("timer", "span", "mark")

    def __init__(self, timer: "StageTimer", name: str, parent: Optional[Span],
                 counts: Dict[str, int]):
        traced = threading.get_ident() == timer.owner
        self.timer = timer
        self.span = Span(name, parent, counts, traced)
        self.mark = None

    def __enter__(self) -> Dict[str, int]:
        sp = self.span
        if sp.traced:
            from torch.profiler import record_function

            self.mark = record_function(sp.name)
            self.mark.__enter__()
        # read inside the mark, so the span and its trace event agree
        # (the first mark of a process takes milliseconds to enter)
        sp.start = time.time_ns()
        _stack().append((self.timer, sp))
        self.timer.spans.append(sp)
        return sp.counts

    def __exit__(self, *exc) -> bool:
        self.span.end = time.time_ns()
        _local.stack.pop()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


class _Off:
    """What a span is where nothing records: a block that records nothing."""

    def __enter__(self) -> Dict[str, int]:
        return {}

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **counts: int):
    """A sub-span of the span open on this thread (or carried to it by
    :func:`carry`), recorded into that span's run; a context manager whose
    block gets the span's ``counts`` dict and may add to it. Where no
    recording run has a span open here it records nothing, at the cost of
    one check."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return _OFF
    timer, parent = stack[-1]
    return _Open(timer, name, parent, counts)


def carry(fn: Callable) -> Callable:
    """``fn`` bound to the span open on this thread now: run on another
    thread, its spans record into that span's run, under that span. ``fn``
    itself where no recording run has a span open here."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return fn
    top = stack[-1]

    def carried(*args: Any, **kwargs: Any) -> Any:
        mine = _stack()
        mine.append(top)
        try:
            return fn(*args, **kwargs)
        finally:
            mine.pop()

    return carried


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None,
                 stages: Optional["StageTimer"] = None) -> Iterator[None]:
    """Capture a torch.profiler trace when ``log_dir`` (or
    PYKMER_TPU_TRACE_DIR) is set, written there as a chrome trace
    ``trace_<pid>_<ns>.json``; no-op otherwise. The card's activity is
    recorded where CUDA is available, the host's always. The spans of
    ``stages`` that the profiler could not see (those of worker threads) are
    added to the trace, on the trace's clock, one row a thread."""
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
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    if stages is not None:
        _add_thread_spans(path, stages.spans)


def _add_thread_spans(path: str, spans: List[Span]) -> None:
    """Append the untraced ``spans`` to the chrome trace at ``path``: each
    an "X" event on its thread's row, its counts as args, and a name for
    each row the trace does not name yet."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace.setdefault("traceEvents", [])
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    named = {e.get("tid") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    rows: Dict[int, str] = {}
    for sp in spans:
        if sp.traced or not sp.end:
            continue
        rows.setdefault(sp.tid, sp.thread)
        events.append({"ph": "X", "cat": "thread_span", "name": sp.name, "pid": pid,
                       "tid": sp.tid, "ts": (sp.start - base) / 1e3,
                       "dur": (sp.end - sp.start) / 1e3,
                       "args": dict(sp.counts, parent=sp.parent.name if sp.parent else None)})
    for tid, thread in rows.items():
        if tid not in named:
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": thread}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


class StageTimer:
    """Wall-clock per-stage accounting printed as an aligned table; while
    ``PYKMER_TPU_STAGE_TIMING`` or ``PYKMER_TPU_TRACE_DIR`` is set, the
    run's span recorder as well (the module's docstring). A timer stands for
    one run and is made on the thread that runs it."""

    def __init__(self) -> None:
        self.stages: list[tuple[str, float]] = []
        # the switches, read once a run: either one records
        self.record = bool(os.environ.get("PYKMER_TPU_STAGE_TIMING")
                           or os.environ.get("PYKMER_TPU_TRACE_DIR"))
        self.owner = threading.get_ident()
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            if self.record:
                with self.span(name):
                    yield
            else:
                yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def span(self, name: str, **counts: int):
        """A span of this run that is no row of the table (as :func:`span`,
        under the innermost span of this run open on this thread, or at the
        top)."""
        if not self.record:
            return _OFF
        stack = getattr(_local, "stack", None)
        parent = stack[-1][1] if stack and stack[-1][0] is self else None
        return _Open(self, name, parent, counts)

    def add(self, name: str, seconds: float) -> None:
        """A row the caller timed itself: work whose spans were recorded
        apart (a loop less the parts that have rows of their own)."""
        self.stages.append((name, seconds))

    def finish(self) -> None:
        """End the run: where it recorded, hand its spans to the readers of
        :data:`FINISHED_RUNS`."""
        if self.record:
            FINISHED_RUNS.append(self)

    def report(self) -> str:
        total = sum(dt for _, dt in self.stages) or 1e-9
        rows = [
            f"  {name:24s} {dt * 1e3:10.1f} ms {dt / total * 100.0:6.1f}%"
            for name, dt in self.stages
        ]
        return "\n".join(rows)
