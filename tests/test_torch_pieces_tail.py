"""The port's arena-free pieces tail on the CPU, driven at small K by
lowering its thresholds: its `.kin` and `.kin.json` equal the benchmark's
blocked plain reference on seeded genomes, its spans count what it did (the
segments packed and decoded, the mirror half read back, every byte hashed),
and the index records which tail it took."""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch

import pykmer_tpu_torch
from kbench import genome
from kbench.reference import index as ref
from kbench.reference import index_blocked as bref
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.index import indexer as tix
from pykmer_tpu_torch.ops import packing
from pykmer_tpu_torch.ops import readback as trb
from pykmer_tpu_torch.utils import profiling

K = 11
HALF = 4**K // 2
SEG = 1 << 16  # 32 segments of the folded plane
# the table the streaming index through the pieces tail prints, row by row
PIECES_ROWS = ["input read", "decode + accumulate (pipelined)", "escape counts",
               "copy + decode (pieces)", "write drain + mirror hash", "metadata", "verify"]
SPEC = dict(genome_bp=200_003, records=3, repeat_cover=0.65, max_divergence=0.2,
            n_bases=9_000, n_runs=4)


@pytest.fixture
def pieces(monkeypatch):
    """The sparse stream and the pieces tail switched on at K=11, a fresh
    list of finished runs, and the span recorder on."""
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", SEG)
    monkeypatch.setattr(tix, "PIECES_MIN_CELLS", 0)
    monkeypatch.setattr(trb, "MIRROR_READ_CELLS", 1 << 19)  # 4 mirror reads
    runs = collections.deque(maxlen=profiling.RUNS_KEPT)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR", raising=False)
    return runs


def _index(tmp_path, seed, readback="sparse", kmer_len=K):
    """The genome of ``seed``, with a last record whose 1,500-base run of A
    saturates its cells, indexed on the CPU; its path and records."""
    path = str(tmp_path / f"g{seed}.fa")
    records = genome.make_genome(path, seed, **SPEC)
    records.append(("run of A", np.full(2_000, ord("A"), dtype=np.uint8)))
    records[-1][1][:500] = np.frombuffer(b"acgt" * 125, np.uint8)
    genome.write_fasta(path, records)
    pykmer_tpu_torch.create_fasta_index(
        path, "s", path, kmer_len, config=IndexConfig(kmer_len=kmer_len, readback=readback),
        verbose=False, device="cpu")
    return path, records


@pytest.mark.parametrize("seed", [5, 2**35 + 1, 977])
def test_the_pieces_tail_equals_the_blocked_reference(tmp_path, pieces, seed):
    before = tix.TAILS["pieces"]
    path, records = _index(tmp_path, seed)
    kin = f"{path}.{K:02d}.kin"
    expected, wrong, _ = bref.judge(records, K, torch.device("cpu"), ref.sha256_file(path),
                                    kin_paths=[kin], block_cells=1 << 19)
    with open(kin + ".json") as fh:
        meta = json.load(fh)
    assert wrong == [0] and ref.fields_wrong(meta, expected) == []
    assert expected["vals_max"] == 255  # saturated cells, read back as escapes
    run, = pieces
    assert tix.TAILS["pieces"] == before + 1
    assert any(name == "copy + decode (pieces)" for name, _ in run.stages)


def test_the_pieces_tail_spans_add_up(tmp_path, pieces):
    _index(tmp_path, 31)
    run, = pieces
    me = threading.current_thread().name

    def named(name):
        return [s for s in run.spans if s.name == name]

    def total(name, key):
        return sum(s.counts[key] for s in named(name))

    packs, decodes, reads = named("sparse pack"), named("piece decode"), named("mirror read")
    assert len(packs) == len(decodes) == HALF // SEG and len(reads) == 4
    assert total("sparse pack", "cells") == total("piece decode", "cells") == HALF
    assert total("sparse pack", "tokens") == total("piece decode", "tokens") > 0
    assert total("sparse pack", "bytes") >= total("sparse pack", "tokens")
    assert total("mirror read", "bytes") == HALF
    assert total("sha256", "bytes") == total("pwrite", "bytes") == 4**K
    loop, = named("copy + decode (pieces)")
    drain, = named("write drain + mirror hash")
    waits = named("piece decode wait")
    assert len(waits) == HALF // SEG
    for s in packs + waits + named("piece queue wait"):
        assert s.thread == me and s.parent is loop and s.traced
    for s in decodes:  # the decode pool's threads, carried under the loop
        assert s.thread != me and s.parent is loop and not s.traced
    for s in reads:  # the mirror reader's thread, under the drain
        assert s.thread != me and s.parent is drain
    assert all(loop.start <= s.start <= s.end <= loop.end for s in packs + decodes)


def test_the_pieces_tail_verify_reads_the_file_once_its_writes_have_landed(
        tmp_path, pieces, monkeypatch):
    """The verify reads the first half back once the last write has ended;
    the mirror half is counted from the chunks the tail reads back to hash,
    on the mirror reader's thread; together they count the file once, and
    the stage table keeps its rows. Each write is slowed, so the writes are
    still in flight when the segment loop ends."""
    real = trb._spanned_pwrite

    def slow(fd, arr, offset):
        time.sleep(0.02)
        real(fd, arr, offset)

    monkeypatch.setattr(trb, "_spanned_pwrite", slow)
    _index(tmp_path, 13)
    run, = pieces

    def named(name):
        return [s for s in run.spans if s.name == name]

    reads, counts, writes = named("verify read"), named("verify count"), named("pwrite")
    assert min(s.start for s in reads) >= max(s.end for s in writes)
    assert sum(s.counts["bytes"] for s in reads) == HALF
    assert sum(s.counts["bytes"] for s in counts) == 4**K
    mirror_threads = {s.thread for s in named("mirror read")}
    on_mirror = [s for s in counts if s.thread in mirror_threads]
    assert sum(s.counts["bytes"] for s in on_mirror) == HALF
    assert {s.thread for s in counts} - mirror_threads == {"verify"}
    assert [name for name, _ in run.stages] == PIECES_ROWS


def test_a_raw_tail_records_raw(tmp_path, pieces):
    """auto reads back raw on the CPU: the counter and the stage table say
    so, and none of the pieces tail's spans is recorded."""
    before = dict(tix.TAILS)
    _index(tmp_path, 7, readback="auto", kmer_len=9)
    run, = pieces
    assert "copy + unfold" in {name for name, _ in run.stages}
    assert tix.TAILS["raw"] == before.get("raw", 0) + 1
    assert sum(tix.TAILS.values()) == sum(before.values()) + 1
    assert not {"sparse pack", "piece decode", "piece decode wait", "piece queue wait",
                "mirror read"} & {s.name for s in run.spans}


@pytest.mark.parametrize("readback", ["2bit", "sparse"])
def test_other_tails_record_their_mode(tmp_path, pieces, monkeypatch, readback):
    """Below the pieces threshold a sparse plane takes the sparse token
    stream into the 4^K array, and a fixed width its own tail."""
    monkeypatch.setattr(tix, "PIECES_MIN_CELLS", 1 << 30)
    before = tix.TAILS[readback]
    _index(tmp_path, 8, readback=readback, kmer_len=9)
    run, = pieces
    assert tix.TAILS[readback] == before + 1
    names = {s.name for s in run.spans}
    assert ("sparse pack" in names) == (readback == "sparse")
    assert not {"piece decode", "mirror read"} & names
