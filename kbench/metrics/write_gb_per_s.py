"""The `.kin` write rate in GB/s (1e9 bytes): the bytes of every "pwrite"
span of the window's indexes (the readback tail's writer threads) over the
wall time with at least one of them in flight."""

from kbench.spans import bytes_of, spans, union_seconds, window_runs


def read(run):
    found = spans(window_runs(run), "pwrite")
    wall = union_seconds((s.start, s.end) for s in found)
    return bytes_of(found) / wall * 1e-9 if found and wall > 0 else None
