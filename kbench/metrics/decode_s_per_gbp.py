"""Seconds of the native decode a Gbp of genome: the program's "decode"
spans on the decode producer thread (one a segment) summed over an index,
over the genome's bases, the mean over the window's indexes."""

from kbench.spans import mean_seconds


def read(run):
    seconds = mean_seconds(run, "decode")
    return None if seconds is None else seconds / (run.work["bases"] / 1e9)
