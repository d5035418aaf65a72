"""The reader of the card deflate's share, on hand-made finished runs: 100
where every "bgzf deflate" span's blocks are the card's, 0 where the spans
count no card blocks (the host's zlib pool), the block-weighted share over
the window's indexes where both appear, nothing where no index recorded a
"bgzf deflate" span; and its listing, for the batch cell alone."""

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
    return harness.code_file("metrics", "card_deflate_share").read(run)


CARD = [_span("bgzf deflate", blocks=1024, bytes=66846720, bytes_out=14000000,
              card_blocks=1024),
        _span("bgzf deflate", blocks=64, bytes=4177920, bytes_out=900000, card_blocks=64)]
POOL = [_span("bgzf deflate", blocks=64, bytes=4177920, bytes_out=900000),
        _span("bgzf deflate", blocks=64, bytes=4177920, bytes_out=900000),
        _span("kin read", bytes=4177920)]


@pytest.mark.parametrize("spans,want", [
    ([CARD], 100.0),
    ([POOL], 0.0),
    ([CARD, POOL], 100.0 * 1088 / 1216),
    ([POOL, CARD + [_span("bgzf deflate", blocks=128)]], 100.0 * 1088 / 1344),
])
def test_card_deflate_share(monkeypatch, spans, want):
    runs = [types.SimpleNamespace(spans=s) for s in spans]
    assert _read(monkeypatch, runs) == pytest.approx(want)


def test_only_the_window_runs_are_read(monkeypatch):
    runs = [types.SimpleNamespace(spans=POOL), types.SimpleNamespace(spans=CARD)]
    assert _read(monkeypatch, runs, n_window=1) == pytest.approx(100.0)


def test_card_deflate_share_gives_nothing_without_deflate_spans(monkeypatch):
    plain = [_span("bgzf inflate", blocks=32, card_blocks=32), _span("sha256", bytes=4)]
    assert _read(monkeypatch, [types.SimpleNamespace(spans=plain)]) is None
    assert _read(monkeypatch, []) is None


def test_card_deflate_share_is_listed_for_the_batch_cell_alone():
    manifest = harness.load_manifest()
    listed = {m["name"]: m for m in manifest["per_layer"]}
    m = listed["card_deflate_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == \
        ("%", "higher", "program_span", "bgzip output", "index_bp_per_s",
         ["plants-k15-batch.index-bgzip"])
    assert harness.manifest_errors(manifest) == []
