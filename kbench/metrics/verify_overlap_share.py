"""How far the verify's re-read of the `.kin` runs beside the tail, in %:
100 × the bytes of the "verify count" spans that ended before their index's
"verify" stage began, over the bytes of every "verify count" span, over the
window's indexes. Nothing where no index counted in such spans (a program
whose verify re-reads the file only in its own stage)."""

from kbench.spans import bytes_of, spans, window_runs


def read(run):
    early = total = 0
    for r in window_runs(run):
        counted, stage = spans([r], "verify count"), spans([r], "verify")
        if not counted or not stage:
            continue
        began = stage[0].start
        total += bytes_of(counted)
        early += bytes_of(s for s in counted if s.end <= began)
    return 100.0 * early / total if total else None
