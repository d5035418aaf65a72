"""The pieces tail's re-read of the `.kin`'s mirror half in GB/s (1e9
bytes): the bytes of every "mirror read" span of the window's indexes (each
read of ``PieceSink.finish``, on its reader thread) over their summed
seconds."""

from kbench.spans import bytes_of, seconds, spans, window_runs


def read(run):
    found = spans(window_runs(run), "mirror read")
    busy = sum(seconds(s) for s in found)
    return bytes_of(found) / busy * 1e-9 if found and busy > 0 else None
