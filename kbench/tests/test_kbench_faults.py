"""The comparison that decides ``correct`` fails where it should: the
control (the reference with a guarantee broken, in the program's place),
and a run of the program with its timed path broken underneath. The chip
is not asked for; the cells run on the CPU at sizes a test holds."""

import itertools
import json

import pytest

from kbench import harness

# K=5 over 1 Mbp: 512 canonical cells at ~2000 windows each, so they
# saturate, as the repeat families' cells do at the cells' own size
INDEX_CONFIG = dict(harness.data_file("configs", "plants-k15"), kmer_len=5,
                    genome_bp=1_000_000, records=2, n_bases=60_000)
INDEX_WORKLOAD = dict(harness.data_file("workloads", "plants-k15.index"), warm_bp=100_000)


def _index(tmp_path, seconds=0.0, call=None):
    return harness.execute("plants-k15.index", 2**33 + 1, seconds, False, "cpu",
                           config=INDEX_CONFIG, workload=INDEX_WORKLOAD, call=call,
                           say=lambda s: None, directory=str(tmp_path / "run"))


def test_sound_runs_are_correct(tmp_path):
    result = _index(tmp_path, 0.5)
    assert result["correct"] and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["check"].values())


def test_index_control_is_not_correct(tmp_path):
    kind = harness.code_file("jobs", "index")
    result = _index(tmp_path, call=kind.control)
    assert not result["correct"]
    assert result["check"]["kin_bytes_wrong"]["value"] > 0
    assert result["check"]["meta_fields_wrong"]["value"] > 0


def _every_other(iterator_fn):
    def wrapped(*args, **kwargs):
        return itertools.islice(iterator_fn(*args, **kwargs), 0, None, 2)
    return wrapped


def _plane_altered(stream_fn):
    def wrapped(plane, *args, **kwargs):
        plane[plane.numel() // 3] += 1
        return stream_fn(plane, *args, **kwargs)
    return wrapped


INDEX_FAULTS = {
    "state unchanged": lambda m, ix: m.setattr(ix, "accumulate_sorted",
                                               lambda plane, codes: plane),
    "half the batch left out": lambda m, ix: (
        m.setattr(ix, "iter_pipelined_chunks", _every_other(ix.iter_pipelined_chunks)),
        m.setattr(ix, "iter_chunks_packed_lazy", _every_other(ix.iter_chunks_packed_lazy))),
    "an answer altered where produced": lambda m, ix: m.setattr(
        ix, "stream_plane_to_out", _plane_altered(ix.stream_plane_to_out)),
}


@pytest.mark.parametrize("fault", sorted(INDEX_FAULTS))
def test_index_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from pykmer_tpu_torch.index import indexer

    # small chunks, so that the genome spans several and half can be left out
    monkeypatch.setattr("pykmer_tpu_torch.config.CPU_CHUNK_WINDOWS", 1 << 16)
    INDEX_FAULTS[fault](monkeypatch, indexer)
    assert not _index(tmp_path)["correct"]


def test_seeds_move_the_inputs_not_the_sizes(tmp_path):
    infos = []
    for seed in (1, 2):
        harness.execute("plants-k15.index", seed, 0.0, False, "cpu",
                        config=dict(INDEX_CONFIG, kmer_len=9),
                        workload=INDEX_WORKLOAD, directory=str(tmp_path / "run"),
                        say=lambda line: infos.append(json.loads(line)["kbench_info"]))
    assert infos[0]["valid_windows"] == infos[1]["valid_windows"]
    assert infos[0]["distinct_cells"] != infos[1]["distinct_cells"]
