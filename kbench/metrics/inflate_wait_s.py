"""Seconds the segment scan waits for BGZF blocks still inflating (the
program's "inflate wait" spans, inside its "input wait"), summed over an
index, the mean over the window's indexes that inflated a BGZF input (0 for
one that never waited). How long the inflate held up the scan, and so the
card decode. Nothing where no index records a "bgzf inflate" span."""

from kbench.spans import seconds, spans, window_runs


def read(run):
    runs = [r for r in window_runs(run) if spans([r], "bgzf inflate")]
    totals = [sum(seconds(s) for s in spans([r], "inflate wait")) for r in runs]
    return sum(totals) / len(totals) if totals else None
