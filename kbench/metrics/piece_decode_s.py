"""Thread-seconds of the pieces tail's host decode: the program's "piece
decode" spans (one a segment, decoded into its primary and mirror pieces on
the decode pool's threads) summed over an index, the mean over the window's
indexes. Threads overlap, so this may exceed the tail's wall time."""

from kbench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "piece decode")
