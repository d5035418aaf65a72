"""Seconds of the index's input, decode and device accumulate per Gbp of
genome: the program's stage "decode + accumulate (pipelined)" (or the
accumulate stage of another strategy), the mean over the window's indexes."""

from kbench.metrics_common import stage_mean


def read(run):
    seconds = stage_mean(run, "accumulate")
    return None if seconds is None else seconds / (run.work["bases"] / 1e9)
