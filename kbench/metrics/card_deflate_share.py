"""The share of the bgzip output's blocks deflated on the card, in %: 100 ×
the "card_blocks" of the program's "bgzf deflate" spans (one a run of
blocks) over their "blocks", over the window's indexes. 100 where the card
deflates every run, 0 where the host's zlib pool deflates them all (a
program whose spans count no card blocks); nothing where no index recorded a
"bgzf deflate" span (an index without the bgzip output)."""

from kbench.spans import spans, window_runs


def read(run):
    found = spans(window_runs(run), "bgzf deflate")
    blocks = sum(s.counts.get("blocks", 0) for s in found)
    card = sum(s.counts.get("card_blocks", 0) for s in found)
    return 100.0 * card / blocks if blocks else None
