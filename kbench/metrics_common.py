"""What the per-layer metrics share: the program's stage tables of a
window's indexes, and the device trace's kernel time a job."""

from __future__ import annotations

from typing import Optional

from kbench.trace import parse_stage_tables, stage_split


def stage_mean(run, part: str) -> Optional[float]:
    """The mean seconds of ``part`` ("accumulate", "tail", "verify") over
    the window's indexes that printed a stage table."""
    splits = []
    for job in run.completed:
        for rows in parse_stage_tables(job.stderr):
            split = stage_split(rows)
            if split is not None:
                splits.append(split[part])
    return sum(splits) / len(splits) if splits else None


def kernel_seconds_per_job(run, substring: str) -> Optional[float]:
    """Device seconds of the kernels whose name holds ``substring`` over the
    traced window, a job."""
    if run.device_trace is None or not run.completed:
        return None
    seconds = run.device_trace.kernel_seconds(substring)
    return seconds / len(run.completed) if seconds > 0 else None


def idle_share(run) -> Optional[float]:
    t = run.device_trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
