"""The five readers of the program's span recorder, each on a hand-made
list of finished runs: the window's newest runs, means over the runs, rates
over the window, and nothing where the program keeps no runs."""

import collections
import types

import pytest

from kbench import harness

S = 1_000_000_000  # ns a second


def _span(name, start_s, end_s, **counts):
    return types.SimpleNamespace(name=name, start=int(start_s * S), end=int(end_s * S),
                                 thread="t", counts=counts)


def _run(n_jobs, bases=2_000_000_000):
    return types.SimpleNamespace(completed=[object()] * n_jobs, work={"bases": bases})


STALE = types.SimpleNamespace(spans=[
    _span("decode queue wait", 0, 100), _span("decode", 0, 100), _span("unfold", 0, 100),
    _span("sha256", 0, 100, bytes=1), _span("pwrite", 0, 100, bytes=1)])
RUNS = [
    types.SimpleNamespace(spans=[
        _span("decode + accumulate (pipelined)", 0, 2),
        _span("decode queue wait", 0.0, 0.5), _span("decode queue wait", 1.0, 1.25),
        _span("decode", 0.1, 0.6, bases=1), _span("decode", 0.6, 1.1, bases=1),
        _span("unfold", 2.0, 2.25), _span("unfold", 2.5, 2.75),
        _span("sha256", 2.0, 3.0, bytes=2_000_000_000),
        # two writers in flight at once: 3.0 s of wall for 3.5 s of spans
        _span("pwrite", 2.0, 4.0, bytes=3_000_000_000),
        _span("pwrite", 3.5, 5.0, bytes=3_000_000_000)]),
    types.SimpleNamespace(spans=[
        _span("decode queue wait", 10.0, 10.25),
        _span("decode", 10.0, 12.0, bases=2),
        _span("unfold", 12.0, 12.5),
        _span("sha256", 12.0, 13.0, bytes=1_000_000_000),
        _span("pwrite", 12.0, 13.0, bytes=1_000_000_000)]),
]


@pytest.fixture
def finished(monkeypatch):
    from pykmer_tpu_torch.utils import profiling

    runs = collections.deque([STALE] + RUNS, maxlen=8)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    return runs


def _read(name, run):
    return harness.code_file("metrics", name).read(run)


@pytest.mark.parametrize("name,want", [
    ("decode_wait_s", (0.75 + 0.25) / 2),          # a run's waits summed, mean over 2 runs
    ("decode_s_per_gbp", (1.0 + 2.0) / 2 / 2.0),   # the same, over 2 Gbp
    ("unfold_s", (0.5 + 0.5) / 2),
    ("hash_gb_per_s", 3.0 / 2.0),                  # 3 GB over 2 s of hashing
    ("write_gb_per_s", 7.0 / 4.0),                 # 7 GB over 3 + 1 s with a write in flight
])
def test_each_reader_on_the_window_runs(finished, name, want):
    # the window completed 2 calls: the stale run before them is not read
    assert _read(name, _run(2)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["decode_wait_s", "decode_s_per_gbp", "unfold_s",
                                  "hash_gb_per_s", "write_gb_per_s"])
def test_readers_give_nothing_without_spans(monkeypatch, finished, name):
    from pykmer_tpu_torch.utils import profiling

    assert _read(name, _run(0)) is None  # no completed call
    finished.clear()
    finished.append(types.SimpleNamespace(spans=[_span("input read", 0, 1)]))
    assert _read(name, _run(1)) is None  # a run without the reader's spans
    monkeypatch.delattr(profiling, "FINISHED_RUNS")  # a program without the recorder
    assert _read(name, _run(2)) is None


def test_the_readers_are_listed_for_the_cell():
    manifest = harness.load_manifest()
    listed = {m["name"]: m for m in manifest["per_layer"]}
    for name in ("decode_wait_s", "decode_s_per_gbp", "unfold_s", "hash_gb_per_s",
                 "write_gb_per_s"):
        m = listed[name]
        assert (m["source"], m["moves"], m["workloads"]) == \
            ("program_span", "index_bp_per_s", ["plants-k15.index"])
