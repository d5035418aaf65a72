"""What the program's span recorder gives the per-layer metrics: the
indexes that finished in the traced window, and their spans.

The program hands each finished recording run (one index) to
``pykmer_tpu_torch.utils.profiling.FINISHED_RUNS``, a bounded list of the
newest; a run's ``spans`` each have a ``name``, ``start`` and ``end`` in
``time.time_ns()``, a ``thread`` and ``counts``. The traced window sets
``PYKMER_TPU_STAGE_TIMING`` around its calls alone, so the newest runs are
the window's completed calls. Where the program keeps no such list, there
are no runs, and the metrics that read them give nothing.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def window_runs(run) -> List:
    """The recorder's runs of the window's completed calls, oldest first;
    [] where the program has no recorder."""
    try:
        from pykmer_tpu_torch.utils import profiling
    except ImportError:
        return []
    n = len(run.completed)
    runs = list(getattr(profiling, "FINISHED_RUNS", None) or [])
    return runs[-n:] if n else []


def spans(runs: Iterable, name: str) -> List:
    """The spans called ``name`` of ``runs``."""
    return [s for r in runs for s in getattr(r, "spans", ()) if s.name == name]


def seconds(span) -> float:
    return (span.end - span.start) / 1e9


def mean_seconds(run, name: str) -> Optional[float]:
    """The seconds of the ``name`` spans summed over each run of the
    window, the mean over the runs that have any."""
    totals = [sum(seconds(s) for s in found) for r in window_runs(run)
              if (found := spans([r], name))]
    return sum(totals) / len(totals) if totals else None


def union_seconds(intervals: Iterable[Tuple[int, int]]) -> float:
    """Seconds covered by at least one of the (start, end) ns intervals."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total / 1e9


def bytes_of(found: Iterable) -> int:
    return sum(s.counts.get("bytes", 0) for s in found)
