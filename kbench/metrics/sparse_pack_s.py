"""Seconds of the pieces tail's device side: the program's "sparse pack"
spans on the dispatch thread (one a 2^28-cell segment: its compaction to
tokens on the card and the copies of its tokens, side stream and escapes to
the host) summed over an index, the mean over the window's indexes."""

from kbench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "sparse pack")
