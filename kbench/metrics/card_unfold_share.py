"""The share of the readback tail's unfold done on the card, in %: 100 × the
"card_cells" of the program's "unfold" spans (one a slice) over their
"cells", over the window's indexes. 100 where the card unfolds every slice
of the file in file order, 0 where the host unfolds them all (a program
whose spans count no card cells); nothing where no index recorded an
"unfold" span (the sparse and pieces tails)."""

from kbench.spans import spans, window_runs


def read(run):
    found = spans(window_runs(run), "unfold")
    cells = sum(s.counts.get("cells", 0) for s in found)
    card = sum(s.counts.get("card_cells", 0) for s in found)
    return 100.0 * card / cells if cells else None
