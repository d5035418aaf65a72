"""Seconds of the host unfold of the readback tail: the program's "unfold"
spans (one a slice, the folded cells unfolded into the 4^K plane on the
dispatch thread's pool) summed over an index, the mean over the window's
indexes. The rest of "copy + unfold" is the "d2h wait"."""

from kbench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "unfold")
