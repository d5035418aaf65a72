"""``verify_overlap_share`` on hand-made runs: the bytes counted before an
index's verify stage began, over all it counted; nothing where no index
counted in "verify count" spans."""

import collections
import types

import pytest

from kbench import harness

S = 1_000_000_000  # ns a second


def _span(name, start_s, end_s, **counts):
    return types.SimpleNamespace(name=name, start=int(start_s * S), end=int(end_s * S),
                                 thread="t", counts=counts)


def _run(n_jobs):
    return types.SimpleNamespace(completed=[object()] * n_jobs)


def _read(run):
    return harness.code_file("metrics", "verify_overlap_share").read(run)


@pytest.fixture
def finished(monkeypatch):
    from pykmer_tpu_torch.utils import profiling

    runs = collections.deque(maxlen=8)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    return runs


OVERLAPPED = types.SimpleNamespace(spans=[
    _span("verify count", 1.0, 1.1, bytes=3), _span("verify count", 1.2, 1.3, bytes=5),
    _span("verify", 2.0, 2.01)])
NOT_OVERLAPPED = types.SimpleNamespace(spans=[
    _span("verify", 5.0, 6.0), _span("verify count", 5.1, 5.2, bytes=4),
    _span("verify count", 5.3, 6.0, bytes=4)])
# a count that ends after the stage began is not counted as overlapped
STRADDLING = types.SimpleNamespace(spans=[
    _span("verify count", 7.0, 7.2, bytes=6), _span("verify count", 7.4, 7.6, bytes=2),
    _span("verify", 7.5, 7.7)])


@pytest.mark.parametrize("runs,want", [
    ([OVERLAPPED], 100.0),
    ([NOT_OVERLAPPED], 0.0),
    ([STRADDLING], 75.0),
    ([OVERLAPPED, NOT_OVERLAPPED], 100.0 * 8 / 16),
])
def test_the_share_counted_before_the_stage(finished, runs, want):
    finished.extend(runs)
    assert _read(_run(len(runs))) == pytest.approx(want)


def test_only_the_window_runs_are_read(finished):
    finished.extend([NOT_OVERLAPPED, OVERLAPPED])
    assert _read(_run(1)) == pytest.approx(100.0)


def test_nothing_without_verify_counts(monkeypatch, finished):
    from pykmer_tpu_torch.utils import profiling

    assert _read(_run(0)) is None  # no completed call
    finished.append(types.SimpleNamespace(spans=[_span("verify", 0, 1),
                                                 _span("sha256", 0, 1, bytes=9)]))
    assert _read(_run(1)) is None  # the parent's runs: a verify stage, no counts
    finished.append(types.SimpleNamespace(spans=[_span("verify count", 0, 1, bytes=9)]))
    assert _read(_run(1)) is None  # counts with no verify stage to measure against
    monkeypatch.delattr(profiling, "FINISHED_RUNS")  # a program without the recorder
    assert _read(_run(1)) is None
