"""Seconds of the index's readback tail: the program's stages after the
accumulate and other than verify (escape counts, output allocation, copy and
unfold, write and hash drain, metadata), summed, the mean over the window's
indexes."""

from kbench.metrics_common import stage_mean


def read(run):
    return stage_mean(run, "tail")
