"""The reader of the card inflate's share, on hand-made finished runs: 100
where every "bgzf inflate" span's blocks are the card's, 0 where the spans
count no card blocks (the host's zlib pool), the block-weighted share over
the window's indexes where both appear, nothing where no index recorded a
"bgzf inflate" span; and its listing, for the bgzip cell alone."""

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
    return harness.code_file("metrics", "card_inflate_share").read(run)


CARD = [_span("bgzf inflate", blocks=32, bytes_in=10, bytes=40, card_blocks=32),
        _span("bgzf inflate", blocks=96, bytes_in=30, bytes=120, card_blocks=96)]
POOL = [_span("bgzf inflate", blocks=64, bytes_in=20, bytes=80),
        _span("bgzf inflate", blocks=64, bytes_in=20, bytes=80), _span("inflate wait")]


@pytest.mark.parametrize("spans,want", [
    ([CARD], 100.0),
    ([POOL], 0.0),
    ([CARD, POOL], 50.0),
    ([POOL, CARD + [_span("bgzf inflate", blocks=128)]], 100.0 * 128 / 384),
])
def test_card_inflate_share(monkeypatch, spans, want):
    runs = [types.SimpleNamespace(spans=s) for s in spans]
    assert _read(monkeypatch, runs) == pytest.approx(want)


def test_only_the_window_runs_are_read(monkeypatch):
    runs = [types.SimpleNamespace(spans=POOL), types.SimpleNamespace(spans=CARD)]
    assert _read(monkeypatch, runs, n_window=1) == pytest.approx(100.0)


def test_card_inflate_share_gives_nothing_without_inflate_spans(monkeypatch):
    plain = [_span("card decode", bytes=4, records=1), _span("input sha256", bytes=4)]
    assert _read(monkeypatch, [types.SimpleNamespace(spans=plain)]) is None
    assert _read(monkeypatch, []) is None


def test_card_inflate_share_is_listed_for_the_bgzf_cell_alone():
    manifest = harness.load_manifest()
    listed = {m["name"]: m for m in manifest["per_layer"]}
    m = listed["card_inflate_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == \
        ("%", "higher", "program_span", "input, decode and device accumulate",
         "index_bp_per_s", ["plants-k15-bgzf.index"])
    assert harness.manifest_errors(manifest) == []
