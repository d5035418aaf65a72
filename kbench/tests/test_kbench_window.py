"""The window: calls back to back until the seconds pass, the last to its
end; the end-to-end metrics over the first call to the last return."""

import itertools

import pytest

from kbench import harness


def _run(seconds):
    return harness.Run({}, {"job": "x"}, 1, seconds, False, None, "/nonexistent")


def test_window_runs_until_seconds_then_finishes_the_last_call():
    ticks = itertools.count(0.0, 1.5)  # each clock read 1.5 s after the last
    run = _run(5.0)
    harness.run_window(run, lambda r, i: {"bases": 100}, clock=lambda: next(ticks))
    # calls start at 0, 3, 6: the third ends at 7.5 >= 5 and closes the window
    assert [j.start for j in run.jobs] == [0.0, 3.0, 6.0]
    assert run.window_s == 7.5


def test_index_rate_is_bases_of_completed_calls_over_the_window():
    index = harness.code_file("jobs", "index")
    run = _run(1.0)
    run.jobs = [harness.Job(0, 10.0, 12.0, {"bases": 600}),
                harness.Job(1, 12.0, 13.0, {"bases": 600})]
    assert index.end_to_end(run) == {"index_bp_per_s": pytest.approx(400.0)}


def test_a_call_that_raises_ends_the_window_and_counts_as_failed():
    run = _run(100.0)

    def call(r, i):
        if i == 1:
            raise OSError("disk full")
        return {}

    harness.run_window(run, call)
    assert len(run.jobs) == 2 and run.jobs[1].error == "OSError: disk full"
    assert len(run.completed) == 1
