"""Seconds the index's dispatch thread waits on the decoded-segment queue
(the program's "decode queue wait" spans, around the pipeline's
``q.get()``), summed over an index, the mean over the window's indexes.
Near the accumulate stage's time where decode sets the pace, near 0 where
the upload and the card do."""

from kbench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "decode queue wait")
