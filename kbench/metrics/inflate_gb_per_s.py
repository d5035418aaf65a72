"""The BGZF inflate rate in GB/s (1e9 bytes): the inflated bytes of every
"bgzf inflate" span of the window's indexes (one a run of blocks, on the
inflate pool's threads) over the wall time with at least one of them in
flight. The pool's rate, to hold against the card decode's. Nothing where
the program records no such span (a whole-file inflate records none)."""

from kbench.spans import bytes_of, spans, union_seconds, window_runs


def read(run):
    found = spans(window_runs(run), "bgzf inflate")
    wall = union_seconds((s.start, s.end) for s in found)
    return bytes_of(found) / wall * 1e-9 if found and wall > 0 else None
