"""The reader of the card decode's share, on hand-made finished runs: 100
where only the card decodes, 0 where only the host does, the byte-weighted
share where both do, nothing where neither does."""

import collections
import types

import pytest

from kbench import harness


def _span(name, n_bytes):
    return types.SimpleNamespace(name=name, start=0, end=1, thread="t",
                                 counts={"bytes": n_bytes})


def _read(monkeypatch, runs):
    from pykmer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "FINISHED_RUNS", collections.deque(runs, maxlen=8))
    run = types.SimpleNamespace(completed=[object()] * len(runs), work={"bases": 1})
    return harness.code_file("metrics", "card_decode_share").read(run)


@pytest.mark.parametrize("spans,want", [
    ([[_span("card decode", 100), _span("card decode", 50)], [_span("card decode", 7)]],
     100.0),
    ([[_span("decode", 100)], [_span("decode", 30), _span("decode", 5)]], 0.0),
    ([[_span("card decode", 300)], [_span("decode", 100)]], 75.0),
])
def test_card_decode_share(monkeypatch, spans, want):
    runs = [types.SimpleNamespace(spans=s) for s in spans]
    assert _read(monkeypatch, runs) == pytest.approx(want)


def test_card_decode_share_gives_nothing_without_decode_spans(monkeypatch):
    assert _read(monkeypatch, [types.SimpleNamespace(spans=[_span("unfold", 3)])]) is None


def test_card_decode_share_is_listed_for_the_cell():
    listed = {m["name"]: m for m in harness.load_manifest()["per_layer"]}
    m = listed["card_decode_share"]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == \
        ("program_span", "input, decode and device accumulate", "index_bp_per_s",
         ["plants-k15.index"])
