"""The ``index_blocked`` job kind (the K=17 cell's) on the CPU at small sizes:
a sound run is correct and notes each call's readback tail, its control is
not correct, a fault planted in the pieces tail is not correct, and the
pieces tail's per-layer metrics read numbers from a traced run and nothing
from a program without its spans."""

import collections
import types

import pytest

from kbench import harness

CELL = "plants-k17.index"
# K=11 over 200 kbp: at most 200 k of the 2 M folded cells are nonzero, so
# the plane passes the pieces tail's one-in-eight gate
CONFIG = dict(harness.data_file("configs", "plants-k17"), kmer_len=11, genome_bp=200_000,
              records=2, n_bases=12_000)
# K=5 over 1 Mbp: 512 canonical cells at ~2000 windows each, so they
# saturate, and the control's counts wrap
SATURATED = dict(CONFIG, kmer_len=5, genome_bp=1_000_000, n_bases=60_000)
WORKLOAD = dict(harness.data_file("workloads", CELL), warm_bp=50_000)
PIECES_METRICS = ("pieces_tail_s", "sparse_pack_s", "piece_decode_s", "mirror_read_gb_per_s")


@pytest.fixture
def pieces(monkeypatch):
    """The pieces tail at K=11 on the CPU (where "auto" reads back raw): the
    sparse stream on, 32 segments, no size threshold, a sparse readback."""
    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.ops import packing

    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", 1 << 16)
    monkeypatch.setattr(indexer, "PIECES_MIN_CELLS", 0)
    return dict(WORKLOAD, readback="sparse")


def _run(tmp_path, workload=WORKLOAD, seconds=0.0, trace=False, call=None, infos=None,
         config=CONFIG):
    say = (lambda s: infos.append(s)) if infos is not None else (lambda s: None)
    return harness.execute(CELL, 2**33 + 5, seconds, trace, "cpu", config=config,
                           workload=workload, call=call, say=say,
                           directory=str(tmp_path / "run"))


def _info(lines):
    import json

    return json.loads(lines[-1])["kbench_info"]


def test_a_sound_run_is_correct_and_notes_its_tails(tmp_path):
    infos = []
    result = _run(tmp_path, seconds=0.3, infos=infos, config=SATURATED)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0 for c in result["check"].values())
    assert set(result["metrics"]) == {"index_bp_per_s", "setup_s"}
    info = _info(infos)
    assert info["tails"] == ["raw"] * result["attempted"]  # auto on the CPU
    assert info["valid_windows"] > 0 and info["reference_peak_bytes"] is None


def test_the_control_is_not_correct(tmp_path):
    kind = harness.code_file("jobs", "index_blocked")
    result = _run(tmp_path, call=kind.control, config=SATURATED)
    assert not result["correct"]
    assert result["check"]["kin_bytes_wrong"]["value"] > 0
    assert result["check"]["meta_fields_wrong"]["value"] > 0


def test_the_pieces_tail_is_correct_and_traced(tmp_path, pieces):
    infos = []
    result = _run(tmp_path, workload=pieces, seconds=0.3, trace=True, infos=infos)
    assert result["correct"] and result["failed"] == 0
    assert _info(infos)["tails"] == ["pieces"] * result["attempted"]
    for name in PIECES_METRICS:
        assert result["metrics"][name]["value"] > 0, name
    # no device trace on the CPU: the kernels' shares are left out
    assert not {"encode_i64_roofline", "sweep_i64_roofline"} & set(result["metrics"])


def test_a_program_without_the_tail_counter_notes_nothing(monkeypatch):
    """Where the program keeps no ``TAILS`` counter (a program older than
    it), a call notes None and runs as before."""
    from pykmer_tpu_torch.index import indexer

    kind = harness.code_file("jobs", "index_blocked")
    monkeypatch.delattr(indexer, "TAILS")
    monkeypatch.setattr(kind.index, "call", lambda run, i: {"bases": 1})
    run = types.SimpleNamespace(state={"info": {}})
    assert kind.call(run, 0) == {"bases": 1} and kind.call(run, 1) == {"bases": 1}
    assert run.state["info"]["tails"] == [None, None]


def _mirror_unwritten(monkeypatch, full):
    """The pwrite of the first segment's mirror piece (the file's last
    bytes) is dropped, so those cells stay zero."""
    from pykmer_tpu_torch.ops import readback

    real = readback._spanned_pwrite

    def pwrite(fd, arr, offset):
        if offset + arr.nbytes != full:
            real(fd, arr, offset)

    monkeypatch.setattr(readback, "_spanned_pwrite", pwrite)


@pytest.mark.parametrize("verify", [True, False])
def test_a_mirror_piece_left_unwritten_is_not_correct(tmp_path, monkeypatch, pieces, verify):
    """The fault in the window's calls alone (the warm index is sound)."""
    kind = harness.code_file("jobs", "index_blocked")

    def call(run, i):
        with monkeypatch.context() as m:
            _mirror_unwritten(m, 4 ** CONFIG["kmer_len"])
            return kind.call(run, i)

    result = _run(tmp_path, workload=dict(pieces, verify=verify), call=call)
    assert not result["correct"]
    if not verify:  # the index completes; the comparison finds the zeros
        assert result["failed"] == 1 and result["attempted"] == 1
        assert result["check"]["kin_bytes_wrong"]["value"] > 0
        assert result["check"]["meta_fields_wrong"]["value"] > 0


@pytest.mark.parametrize("name", PIECES_METRICS)
def test_the_pieces_readers_give_nothing_without_their_spans(monkeypatch, name):
    """A program older than these spans and the tail's record: its traced
    runs read nothing, and do not fail."""
    from pykmer_tpu_torch.utils import profiling

    run = types.SimpleNamespace(completed=[types.SimpleNamespace(stderr="")],
                                work={"bases": 1})
    monkeypatch.setattr(profiling, "FINISHED_RUNS", collections.deque(
        [types.SimpleNamespace(spans=[])]))
    read = harness.code_file("metrics", name).read
    assert read(run) is None
    monkeypatch.delattr(profiling, "FINISHED_RUNS")
    assert read(run) is None


def test_the_new_metrics_are_listed_for_the_k17_cell_alone():
    manifest = harness.load_manifest()
    listed = {m["name"]: m for m in manifest["per_layer"]}
    for name in PIECES_METRICS + ("encode_i64_roofline", "sweep_i64_roofline"):
        assert (listed[name]["moves"], listed[name]["workloads"]) == \
            ("index_bp_per_s", [CELL]), name
    cells = [w["name"] for w in manifest["workloads"]]
    assert cells[-1] == CELL
    assert [m["workloads"] for m in manifest["end_to_end"]
            if m["name"] == "index_bp_per_s"] == [["plants-k15.index", CELL]]
