"""Seconds of the index's verify: the program's stage "verify", the mean over
the window's indexes. Nothing where no index verified."""

from kbench.metrics_common import stage_mean


def read(run):
    seconds = stage_mean(run, "verify")
    return seconds if seconds else None
