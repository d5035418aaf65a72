"""The reader of the card unfold's share, on hand-made finished runs: 100
where every "unfold" span's cells are the card's, 0 where the spans count
no card cells (the host unfold), the cell-weighted share over the window's
indexes where both appear, nothing where no index recorded an "unfold"
span."""

import collections
import types

import pytest

from kbench import harness


def _span(name, **counts):
    return types.SimpleNamespace(name=name, start=0, end=1, thread="t", counts=counts)


def _read(monkeypatch, runs, n_window=None):
    from pykmer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "FINISHED_RUNS", collections.deque(runs, maxlen=8))
    n = len(runs) if n_window is None else n_window
    run = types.SimpleNamespace(completed=[object()] * n)
    return harness.code_file("metrics", "card_unfold_share").read(run)


CARD = [_span("unfold", cells=8, card_cells=8), _span("unfold", cells=8, card_cells=8)]
HOST = [_span("unfold", cells=16), _span("d2h wait", bytes=16)]


@pytest.mark.parametrize("spans,want", [
    ([CARD], 100.0),
    ([HOST], 0.0),
    ([CARD, HOST], 50.0),
    ([CARD, CARD + [_span("unfold", cells=32)]], 100.0 * 32 / 64),
])
def test_card_unfold_share(monkeypatch, spans, want):
    runs = [types.SimpleNamespace(spans=s) for s in spans]
    assert _read(monkeypatch, runs) == pytest.approx(want)


def test_only_the_window_runs_are_read(monkeypatch):
    runs = [types.SimpleNamespace(spans=HOST), types.SimpleNamespace(spans=CARD)]
    assert _read(monkeypatch, runs, n_window=1) == pytest.approx(100.0)


def test_card_unfold_share_gives_nothing_without_unfold_spans(monkeypatch):
    pieces = [_span("piece decode", cells=4), _span("sha256", bytes=4)]
    assert _read(monkeypatch, [types.SimpleNamespace(spans=pieces)]) is None


def test_card_unfold_share_is_listed_for_the_k15_cell():
    listed = {m["name"]: m for m in harness.load_manifest()["per_layer"]}
    m = listed["card_unfold_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == \
        ("%", "higher", "program_span", "readback tail", "index_bp_per_s",
         ["plants-k15.index"])
    assert harness.manifest_errors(harness.load_manifest()) == []
