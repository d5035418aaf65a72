"""Seconds of the index's pieces tail (the arena-free readback of a K >= 17
plane): the stages after the accumulate and other than verify (escape
counts, "copy + decode (pieces)", any 2-bit fallback, "write drain + mirror
hash", metadata), summed, the mean over the window's indexes whose stage
table has the "copy + decode (pieces)" row. Nothing where none has."""

from kbench.spans import window_runs
from kbench.trace import stage_split

PIECES_STAGE = "copy + decode (pieces)"


def read(run):
    tails = [split["tail"] for r in window_runs(run)
             if any(name == PIECES_STAGE for name, _ in getattr(r, "stages", ()))
             and (split := stage_split(r.stages)) is not None]
    return sum(tails) / len(tails) if tails else None
