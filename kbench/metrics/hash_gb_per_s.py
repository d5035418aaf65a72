"""The output sha256's rate in GB/s (1e9 bytes): the bytes of every
"sha256" span of the window's indexes (each ``h.update`` of the readback
tail's hasher thread) over their summed seconds."""

from kbench.spans import bytes_of, seconds, spans, window_runs


def read(run):
    found = spans(window_runs(run), "sha256")
    busy = sum(seconds(s) for s in found)
    return bytes_of(found) / busy * 1e-9 if found and busy > 0 else None
