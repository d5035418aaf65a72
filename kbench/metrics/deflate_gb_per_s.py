"""The BGZF deflate rate of the index's bgzip output in GB/s (1e9 bytes):
the uncompressed bytes of every "bgzf deflate" span of the window's indexes
(one a run of blocks, on the deflate pool's threads) over the wall time
with at least one of them in flight. Nothing where the program records no
such span."""

from kbench.spans import bytes_of, spans, union_seconds, window_runs


def read(run):
    found = spans(window_runs(run), "bgzf deflate")
    wall = union_seconds((s.start, s.end) for s in found)
    return bytes_of(found) / wall * 1e-9 if found and wall > 0 else None
