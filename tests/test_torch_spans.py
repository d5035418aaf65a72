"""The port's span recorder on the CPU: one pipelined index records the
spans of its dispatch thread, decode producer, hasher and writers as one
run, with counts that add up, inside their parents; the stage table keeps
its rows; nothing is recorded with both switches unset; and under
``PYKMER_TPU_TRACE_DIR`` one chrome trace holds the worker threads' spans
on their own rows, on the profiler's clock."""

import collections
import functools
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from conftest import make_random_fasta

import pykmer_tpu_torch
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.index import indexer as tix
from pykmer_tpu_torch.ops import packing
from pykmer_tpu_torch.ops import readback as trb
from pykmer_tpu_torch.utils import profiling

K = 9
# the table the pipelined raw index prints, row by row
STAGE_ROWS = ["input read", "decode + accumulate (pipelined)", "output alloc",
              "copy + unfold", "write + hash drain", "metadata", "verify"]
DISPATCH_SPANS = {"decode queue wait", "unfold", "write drain wait", "hash drain wait",
                  "input hash wait"}
WORKER_SPANS = {"decode", "input wait", "sha256", "pwrite", "input sha256", "verify read",
                "verify count"}


@pytest.fixture
def finished(monkeypatch):
    """A fresh list of finished runs, and neither switch set."""
    runs = collections.deque(maxlen=profiling.RUNS_KEPT)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    monkeypatch.delenv("PYKMER_TPU_STAGE_TIMING", raising=False)
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR", raising=False)
    return runs


def _index(tmp_path, monkeypatch, name="g.fa"):
    """A pipelined CPU index of 40 records in ~15 kB segments; returns the
    header and the run's timer."""
    fasta = make_random_fasta(str(tmp_path / name), np.random.default_rng(17),
                              n_records=40, lengths=(5000, 1333, 670))
    monkeypatch.setattr(tix, "iter_pipelined_chunks",
                        functools.partial(tix.iter_pipelined_chunks, target_segment=15000))
    timers = []
    real = tix.StageTimer

    def spy():
        timers.append(real())
        return timers[-1]

    monkeypatch.setattr(tix, "StageTimer", spy)
    header = pykmer_tpu_torch.create_fasta_index(
        fasta, "s", fasta, K, config=IndexConfig(kmer_len=K, chunk_windows=4096),
        verbose=False, device="cpu")
    assert len(timers) == 1
    return header, timers[0]


def slow_writes(monkeypatch, seconds=0.05):
    """Each write of the readback tail lands ``seconds`` late."""
    real = trb._spanned_pwrite

    def slow(fd, arr, offset):
        time.sleep(seconds)
        real(fd, arr, offset)

    monkeypatch.setattr(trb, "_spanned_pwrite", slow)


def _table_rows(text):
    """The stage names of the one table in ``text``, each row in the
    table's format."""
    lines = text.splitlines()
    at = lines.index("stage timing (device strategy):")
    rows = [re.match(r"^  (.+?)\s+-?\d+\.\d ms\s+-?\d+\.\d%$", line)
            for line in lines[at + 1:]]
    assert all(rows)
    return [m.group(1) for m in rows]


def test_one_index_records_every_thread_as_one_run(tmp_path, monkeypatch, finished, capsys):
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    header, timer = _index(tmp_path, monkeypatch)
    assert list(finished) == [timer]
    spans = timer.spans
    assert spans and all(s.end >= s.start > 0 for s in spans)
    me = threading.current_thread().name
    threads = {s.thread for s in spans}
    assert me in threads and "decode" in threads
    assert any(t.startswith("chase-hash") for t in threads)
    assert any(t.startswith("chase-write") for t in threads)
    names = collections.Counter(s.name for s in spans)
    assert DISPATCH_SPANS | WORKER_SPANS | set(STAGE_ROWS) <= set(names)
    assert names["decode"] > 3 and names["decode queue wait"] > names["decode"]
    by_thread = {name: {s.thread for s in spans if s.name == name} for name in names}
    for name in DISPATCH_SPANS | set(STAGE_ROWS):
        assert by_thread[name] == {me}, name
    assert by_thread["decode"] == by_thread["input wait"] == {"decode"}
    assert all(t.startswith("chase-hash") for t in by_thread["sha256"])
    assert all(t.startswith("chase-write") for t in by_thread["pwrite"])
    assert by_thread["input sha256"] == {"input-hash"}
    # the main thread's spans are the ones the profiler sees
    assert all(s.traced == (s.thread == me) for s in spans)
    # the printed table is the parent's: its stages, in order, and no sub-span
    assert _table_rows(capsys.readouterr().err) == STAGE_ROWS
    assert [name for name, _ in timer.stages] == STAGE_ROWS


def test_counts_add_up(tmp_path, monkeypatch, finished):
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    header, timer = _index(tmp_path, monkeypatch)

    def total(name, key):
        return sum(s.counts[key] for s in timer.spans if s.name == name)

    assert total("decode", "bases") == sum(n for _, n in header.chromosomes)
    assert total("decode", "bytes") == os.path.getsize(str(tmp_path / "g.fa"))
    assert total("sha256", "bytes") == 4**K
    assert total("pwrite", "bytes") == 4**K
    assert total("unfold", "cells") == 4**K // 2


def test_sub_spans_lie_inside_their_parents(tmp_path, monkeypatch, finished):
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    _, timer = _index(tmp_path, monkeypatch)
    stages = [s for s in timer.spans if s.parent is None]
    assert [s.name for s in stages] == STAGE_ROWS
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    first, last = stages[0].start, stages[-1].end
    for s in timer.spans:
        if s.parent is None:
            continue
        assert s.parent.parent is None, s.name  # every sub-span sits under a stage
        assert s.parent.start <= s.start, s.name
        if s.thread == s.parent.thread:
            assert s.end <= s.parent.end, s.name
        else:  # a worker's span: submitted within its stage, done within the index
            assert first <= s.start <= s.end <= last, s.name
    parents = {s.name: s.parent.name for s in timer.spans if s.parent is not None}
    assert parents["decode queue wait"] == parents["decode"] == parents["input wait"] \
        == "decode + accumulate (pipelined)"
    assert parents["unfold"] == "copy + unfold"
    assert parents["write drain wait"] == parents["hash drain wait"] == "write + hash drain"


def test_the_verify_reads_the_file_once_its_writes_have_landed(tmp_path, monkeypatch,
                                                               finished):
    """The verify's re-read of the `.kin` starts after its last write has
    ended and runs on threads of its own, started in the tail's drain; what
    it counts is the file, once; the table keeps its rows. Each write is
    slowed, so the writes are still in flight when the slice loop ends."""
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    slow_writes(monkeypatch)
    _, timer = _index(tmp_path, monkeypatch)

    def named(name):
        return [s for s in timer.spans if s.name == name]

    reads, counts, writes = named("verify read"), named("verify count"), named("pwrite")
    assert reads and counts and writes
    assert min(s.start for s in reads) >= max(s.end for s in writes)
    assert sum(s.counts["bytes"] for s in reads) == 4**K
    assert sum(s.counts["bytes"] for s in counts) == 4**K
    assert {s.thread for s in reads} == {"verify-read_0"}
    assert {s.thread for s in counts} == {"verify"}
    assert {s.parent.name for s in reads + counts} == {"write + hash drain"}
    verify, = named("verify")
    assert all(s.end <= verify.end for s in reads + counts)
    assert [name for name, _ in timer.stages] == STAGE_ROWS


def test_nothing_is_recorded_with_both_switches_unset(tmp_path, monkeypatch, finished,
                                                      capsys):
    _, timer = _index(tmp_path, monkeypatch)
    assert not timer.record and timer.spans == [] and not finished
    assert [name for name, _ in timer.stages] == STAGE_ROWS
    err = capsys.readouterr().err
    assert "stage timing" not in err
    with profiling.span("loose") as counts:  # no run open: records nothing
        counts["bytes"] = 1
    assert profiling.carry(len) is len


def test_trace_dir_writes_one_trace_with_every_thread(tmp_path, monkeypatch, finished,
                                                      capsys):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PYKMER_TPU_TRACE_DIR", str(trace_dir))
    _, timer = _index(tmp_path, monkeypatch)
    assert timer.record and list(finished) == [timer]
    assert "stage timing" not in capsys.readouterr().err  # the table needs its own switch
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace_dir / files[0]) as fh:
        trace = json.load(fh)
    base = trace["baseTimeNanoseconds"]
    events = trace["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    marks = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    workers = [e for e in events if e.get("ph") == "X" and e.get("cat") == "thread_span"]
    main_tid = threading.get_native_id()
    assert {e["name"] for e in workers} == WORKER_SPANS
    assert all(e["tid"] != main_tid and e["pid"] == os.getpid() for e in workers)
    assert {rows[e["tid"]] for e in workers if e["name"] == "decode"} == {"decode"}
    assert {rows[e["tid"]].split("_")[0] for e in workers} == {
        "decode", "chase-hash", "chase-write", "input-hash", "verify", "verify-read"}
    # the workers' spans lie inside the index, on the trace's clock
    stage = {e["name"]: e for e in marks}
    lo, hi = stage["input read"]["ts"], stage["verify"]["ts"] + stage["verify"]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in workers)
    # each span of the main thread is a record_function event of its name
    # and tid, on one clock: the span reads the clock inside its event, so
    # it lies within it (to the profiler's 0.1 ms of clock conversion); the
    # stages that run while no other thread of the index does agree with
    # their events to 1 ms at both ends (elsewhere a thread that takes the
    # GIL between the two clock reads can part them by a few ms)
    main = [s for s in timer.spans if s.traced]
    assert {s.name for s in main} == DISPATCH_SPANS | set(STAGE_ROWS)
    for s in main:
        start, end = (s.start - base) / 1e3, (s.end - base) / 1e3
        hit = min((e for e in marks if e["name"] == s.name),
                  key=lambda e: abs(e["ts"] - start))
        assert hit["tid"] == main_tid
        assert hit["ts"] - 100 <= start <= end <= hit["ts"] + hit["dur"] + 100, s.name
        if s.name in ("output alloc", "metadata", "verify"):
            assert start - hit["ts"] < 1e3 and hit["ts"] + hit["dur"] - end < 1e3, s.name


def test_the_sparse_tail_records_its_loop_and_fallbacks(rng, monkeypatch, finished):
    """The sparse tail's rows are timed by the caller (the loop less its
    2-bit fallbacks): the loop and each fallback are spans, the rows as
    before."""
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", 1 << 13)
    folded = rng.integers(0, 3, size=4**K // 2, dtype=np.uint8)  # dense: every segment falls back
    timer = profiling.StageTimer()
    out = np.zeros(4**K, np.uint8)
    trb.stream_plane_to_out(torch.from_numpy(folded), K, out, stages=timer, mode="sparse")
    n_segs = 4**K // 2 // (1 << 13)
    assert [name for name, _ in timer.stages] == [
        "copy + decode (sparse)", f"2-bit fallback, {n_segs} of {n_segs} segs",
        "write + hash drain"]
    loop = next(s for s in timer.spans if s.name == "copy + decode (sparse)")
    falls = [s for s in timer.spans if s.name == "2-bit fallback"]
    assert len(falls) == n_segs and all(s.parent is loop for s in falls)
    assert sum(s.counts["cells"] for s in falls) == 4**K // 2
    assert sum(s.counts["bytes"] for s in timer.spans if s.name == "sha256") == 4**K
    assert not finished  # a timer outside an index hands no run on


def test_carry_binds_a_worker_to_the_span_open_at_submission(monkeypatch, finished):
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    timer = profiling.StageTimer()

    def work():
        with profiling.span("on the worker", bytes=3):
            pass

    with timer.stage("outer"):
        t = threading.Thread(target=profiling.carry(work), name="worker")
    t.start()
    t.join()
    t = threading.Thread(target=work)  # not carried: records nothing
    t.start()
    t.join()
    outer, inner = timer.spans
    assert (inner.name, inner.thread, inner.parent, inner.counts) == \
        ("on the worker", "worker", outer, {"bytes": 3})
    assert not inner.traced and outer.traced
    timer.finish()
    assert list(finished) == [timer]


def test_the_input_hash_counts_the_input_and_is_joined_at_metadata(tmp_path, monkeypatch,
                                                                   finished):
    """The streaming input's sha256 runs on its own thread ("input sha256"
    spans, one an update, their bytes the input's size) and is joined in the
    metadata stage ("input hash wait")."""
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    _, timer = _index(tmp_path, monkeypatch)
    hashed = [s for s in timer.spans if s.name == "input sha256"]
    assert hashed and {s.thread for s in hashed} == {"input-hash"}
    assert sum(s.counts["bytes"] for s in hashed) == os.path.getsize(str(tmp_path / "g.fa"))
    assert all(s.parent.name == "input read" for s in hashed)
    wait, = [s for s in timer.spans if s.name == "input hash wait"]
    assert wait.parent.name == "metadata"


def test_the_card_path_counts_its_segments(tmp_path, finished, monkeypatch):
    """The card path's pipeline (the plain decode on the CPU) records one
    "card decode" a segment on the dispatch thread, whose bytes sum to the
    input's size and records to its records, and no host "decode"."""
    from pykmer_tpu_torch.host import pipeline
    from pykmer_tpu_torch.host.segments import StreamingInput

    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    fasta = make_random_fasta(str(tmp_path / "c.fa"), np.random.default_rng(19),
                              n_records=30, lengths=(5000, 1333, 670))
    timer = profiling.StageTimer()
    with timer.stage("decode + accumulate (pipelined)"):
        data = StreamingInput(fasta)
        sink = {}
        chunks = list(pipeline.iter_card_chunks(data, K, 4096, sink, torch.device("cpu"),
                                                target_segment=15000))
        data.release()
    assert chunks and len(sink["chromosomes"]) == 30
    decodes = [s for s in timer.spans if s.name == "card decode"]
    assert len(decodes) > 3 and {s.thread for s in decodes} == {threading.current_thread().name}
    assert sum(s.counts["bytes"] for s in decodes) == os.path.getsize(fasta)
    assert sum(s.counts["records"] for s in decodes) == 30
    names = {s.name for s in timer.spans}
    assert "decode" not in names and "decode queue wait" in names
