"""The index's verify on the CPU: faults planted in the writes of the `.kin`
(the in-memory stats and the hash stay right) fail it, in the raw tail at
K=9, in the sharded index over a 1x2 mesh at K=9 and in the pieces tail at
K=11 (its thresholds lowered), and leave no `.kin` at its final name; the
pieces tail's mirror half is counted from the bytes read back from the file;
the sharded index reads its file back beside the hash; ``verify=False``
reads nothing back."""

import collections
import os
import threading

import numpy as np
import pytest

from conftest import make_random_fasta

import pykmer_tpu_torch
from kbench import genome
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.index import create_fasta_index_sharded
from pykmer_tpu_torch.index import indexer as tix
from pykmer_tpu_torch.index.verify import FileVerifier
from pykmer_tpu_torch.ops import packing
from pykmer_tpu_torch.ops import readback as trb
from pykmer_tpu_torch.utils import profiling

SHIFT = 4096  # bytes a shifted write lands past its offset
PIECES_K = 11
SEG = 1 << 16  # folded cells a segment of the pieces tail
VERIFY_SPANS = {"verify read", "verify count"}


@pytest.fixture
def recorded(monkeypatch):
    """A fresh list of finished runs, and the span recorder on."""
    runs = collections.deque(maxlen=profiling.RUNS_KEPT)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR", raising=False)
    return runs


def _pieces_on(monkeypatch):
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", SEG)
    monkeypatch.setattr(tix, "PIECES_MIN_CELLS", 0)
    monkeypatch.setattr(trb, "MIRROR_READ_CELLS", 1 << 19)


def _input(tmp_path, tail, monkeypatch):
    """(FASTA path, K, readback) of ``tail``: "raw" or "sharded" at K=9, or
    "pieces" at K=11 with its thresholds lowered."""
    if tail in ("raw", "sharded"):
        path = str(tmp_path / "r.fa")
        make_random_fasta(path, np.random.default_rng(23), n_records=40,
                          lengths=(5000, 1333, 670))
        return path, 9, "auto"
    _pieces_on(monkeypatch)
    path = str(tmp_path / "p.fa")
    genome.make_genome(path, 41, genome_bp=200_003, records=3, repeat_cover=0.65,
                       max_divergence=0.2, n_bases=9_000, n_runs=4)
    return path, PIECES_K, "sparse"


def _index(tail, path, k, readback, verify=True):
    """(header, the tail ``tix.TAILS`` counted) of one index of ``path``:
    the sharded index over a 1x2 CPU mesh for ``tail`` "sharded", which
    reads back raw, the single-device index otherwise."""
    before = dict(tix.TAILS)
    if tail == "sharded":
        header = create_fasta_index_sharded(
            path, "s", path, k, config=IndexConfig(kmer_len=k, chunk_windows=1 << 14),
            n_shards=2, verify=verify, verbose=False, device="cpu")
    else:
        header = pykmer_tpu_torch.create_fasta_index(
            path, "s", path, k, config=IndexConfig(kmer_len=k, readback=readback),
            verify=verify, verbose=False, device="cpu")
    took, = (tix.TAILS - collections.Counter(before)).keys()
    return header, took


def _took(tail):
    return "raw" if tail == "sharded" else tail


def _planted(monkeypatch, pick, alter):
    """Route the one write of the `.kin` that ``pick(offset, nbytes)``
    chooses through ``alter(arr, offset) -> (arr, offset)``; the others land
    as they are. Returns the list of offsets altered."""
    real = trb._spanned_pwrite
    lock = threading.Lock()
    hit = []

    def faulty(fd, arr, offset):
        with lock:
            chosen = not hit and pick(offset, arr.nbytes)
            if chosen:
                hit.append(offset)
        if chosen:
            arr, offset = alter(arr, offset)
        real(fd, arr, offset)

    monkeypatch.setattr(trb, "_spanned_pwrite", faulty)
    return hit


def _flip_first(arr, offset):
    arr = arr.copy()
    arr[0] ^= 1  # another value: the histogram moves
    return arr, offset


def _shifted(arr, offset):
    return arr, offset + SHIFT


@pytest.mark.parametrize("tail,fault", [("raw", "byte"), ("raw", "shift"),
                                        ("pieces", "byte"), ("pieces", "shift"),
                                        ("pieces", "mirror byte"),
                                        ("sharded", "byte"), ("sharded", "shift")])
def test_a_planted_write_fault_fails_the_verify(tmp_path, monkeypatch, recorded, tail,
                                                fault):
    path, k, readback = _input(tmp_path, tail, monkeypatch)
    full = 4**k
    header, took = _index(tail, path, k, readback)
    assert took == _took(tail)
    with open(header.index_file_root, "rb") as fh:
        clean = np.frombuffer(fh.read(), np.uint8)
    os.remove(header.index_file_root)
    os.remove(header.metadata_file)
    if fault == "shift":
        # the write at offset 0 lands SHIFT bytes late: [0, SHIFT) stays
        # zero, and whichever of it and the next write lands last hides
        # SHIFT nonzero-holding bytes of the other
        n = SEG if tail == "pieces" else full // 2
        assert clean[n - SHIFT : n].any() and clean[n : n + SHIFT].any()
        hit = _planted(monkeypatch, lambda off, nb: off == 0, _shifted)
    elif fault == "byte":
        hit = _planted(monkeypatch, lambda off, nb: off == 0, _flip_first)
    else:  # the mirror of the first piece, which the tail reads back to hash
        hit = _planted(monkeypatch, lambda off, nb: off == full - SEG, _flip_first)
    with pytest.raises(AssertionError, match="written .kin does not match computed stats"):
        _index(tail, path, k, readback)
    assert len(hit) == 1
    assert not os.path.exists(header.index_file_root)


@pytest.mark.parametrize("tail", ["raw", "pieces", "sharded"])
def test_without_verify_nothing_is_read_back_to_count(tmp_path, monkeypatch, recorded,
                                                      tail):
    path, k, readback = _input(tmp_path, tail, monkeypatch)
    verified, _ = _index(tail, path, k, readback)
    with open(verified.index_file_root, "rb") as fh:
        want = fh.read()
    header, took = _index(tail, path, k, readback, verify=False)
    assert took == _took(tail)
    with open(header.index_file_root, "rb") as fh:
        assert fh.read() == want
    assert header.output_file_cheksum == verified.output_file_cheksum
    on, off = recorded
    assert VERIFY_SPANS <= {s.name for s in on.spans}
    assert not VERIFY_SPANS & {s.name for s in off.spans}
    assert "verify" not in {name for name, _ in off.stages}


def test_a_sharded_index_reads_its_file_back_beside_the_hash(tmp_path, monkeypatch,
                                                             recorded):
    """The sharded index's verify counts every byte of the written file
    once, read back on its own threads after the last write has ended,
    inside the tail's drain, as the single-device index's does."""
    path, k, readback = _input(tmp_path, "sharded", monkeypatch)
    _index("sharded", path, k, readback)
    run, = recorded

    def named(name):
        return [s for s in run.spans if s.name == name]

    reads, counts, writes = named("verify read"), named("verify count"), named("pwrite")
    assert reads and counts and writes
    assert min(s.start for s in reads) >= max(s.end for s in writes)
    assert sum(s.counts["bytes"] for s in reads) == 4**k
    assert sum(s.counts["bytes"] for s in counts) == 4**k
    assert {s.thread for s in reads} == {"verify-read_0"}
    assert {s.parent.name for s in reads + counts} == {"write + hash drain"}
    assert [name for name, _ in run.stages][-2:] == ["metadata", "verify"]


def test_the_verifier_counts_each_byte_once(tmp_path):
    """The verifier's counts are the file's, read in blocks beside a range
    another reader counted; a gap or an overlap in what was counted
    raises."""
    data = np.random.default_rng(3).integers(0, 256, 3 * 4096 + 100, dtype=np.uint8)
    path = str(tmp_path / "f.bin")
    data.tofile(path)
    want = np.bincount(data, minlength=256)

    v = FileVerifier(path, data.shape[0], block=4096)
    v.start([(0, 2 * 4096 + 50)])
    v.count(data[2 * 4096 + 50 :], 2 * 4096 + 50)
    assert np.array_equal(v.result(), want)

    gap = FileVerifier(path, data.shape[0], block=4096)
    gap.start([(0, 4096)])
    with pytest.raises(RuntimeError, match="counted"):
        gap.result()
    twice = FileVerifier(path, data.shape[0])
    twice.start([(0, data.shape[0])])
    twice.count(data[:10], 0)
    with pytest.raises(RuntimeError, match="counted"):
        twice.result()


def test_a_read_failure_is_raised_by_result(tmp_path):
    path = str(tmp_path / "short.bin")
    np.zeros(1000, np.uint8).tofile(path)
    v = FileVerifier(path, 5000)
    v.start([(0, 5000)])  # the file is shorter than the range
    with pytest.raises(OSError, match="short read"):
        v.result()
