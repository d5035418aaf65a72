"""The share of the input decoded on the card, in %: the raw bytes of the
program's "card decode" spans (one a segment the card decodes) over those
bytes plus the raw bytes of its "decode" spans (one a segment the host's
native decoder decodes), over the window's indexes. 100 where every segment
is decoded on the card, 0 where the host decodes them all."""

from kbench.spans import bytes_of, spans, window_runs


def read(run):
    runs = window_runs(run)
    card = bytes_of(spans(runs, "card decode"))
    host = bytes_of(spans(runs, "decode"))
    return 100.0 * card / (card + host) if card + host else None
