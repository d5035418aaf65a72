"""The cell ``plants-k15-batch.index-bgzip`` on the CPU at sizes a test
holds: sound runs are correct with every bgzip number at 0; the control and
planted faults in the program's `.kin.bgz` and `.gzi` (a block left out,
the blocks stored uncompressed or deflated at levels 5 and 4, a CRC32
altered, a `.gzi` entry shifted) are not; the two bgzip metrics read their spans from a recorded index and
nothing without them; the manifest lists the new entries, found by name."""

import json
import os
import struct
import types

import pytest

from kbench import genome, harness

CELL = "plants-k15-batch.index-bgzip"
BASE = harness.data_file("configs", "plants-k15-batch")
WORKLOAD = dict(harness.data_file("workloads", CELL), warm_bp=100_000)
# K=9 over 1 Mbp: a 256 KiB `.kin` of 5 blocks that level 6 compresses
SMALL = dict(BASE, kmer_len=9, genome_bp=1_000_000, records=2, n_bases=60_000)
# K=5 over 1 Mbp saturates its cells, so the control's wrap shows
SATURATED = dict(SMALL, kmer_len=5)
batch_job = harness.code_file("jobs", "index_batch")
bgzf_job = harness.code_file("jobs", "index_bgzf")
BGZ_CHECKS = ("bgz_bytes_wrong", "bgz_fields_wrong", "bgz_blocks_unequal")


def _run(tmp_path, config=SMALL, seconds=0.0, call=None, say=lambda s: None):
    return harness.execute(CELL, 2**33 + 11, seconds, False, "cpu", config=config,
                           workload=WORKLOAD, call=call, say=say,
                           directory=str(tmp_path / "run"))


def test_sound_runs_are_correct(tmp_path):
    infos = []
    result = _run(tmp_path, seconds=0.5,
                  say=lambda line: infos.append(json.loads(line)["kbench_info"]))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["check"]) == {"kin_bytes_wrong", "meta_fields_wrong", *BGZ_CHECKS}
    assert all(c["value"] == 0 for c in result["check"].values())
    assert len(infos[0]["bgz_bytes"]) == result["attempted"]
    assert infos[0]["bgz_ratio"] > 1 and infos[0]["bgz_blocks_sampled"] == 1
    assert set(result["metrics"]) == {"index_bp_per_s", "setup_s"}


def test_control_is_not_correct(tmp_path):
    result = _run(tmp_path, config=SATURATED, call=batch_job.control)
    assert not result["correct"]
    assert result["check"]["kin_bytes_wrong"]["value"] > 0
    assert result["check"]["meta_fields_wrong"]["value"] > 0
    assert all(result["check"][name]["value"] == 0 for name in BGZ_CHECKS)


# ---- planted faults in the program's bgzip output ---------------------------

def _payloads(bgz):
    """The payloads of the data blocks of the `.kin.bgz` at ``bgz``."""
    with open(bgz, "rb") as fh:
        data = fh.read()
    blocks = batch_job.walk(data)[0][:-1]
    return data, blocks, [batch_job._block(data, b, 65280, 6, False)[0] for b in blocks]


def _rewrite(bgz, blocks):
    """``bgz`` rewritten from ``blocks`` (bytes each), the EOF block and a
    `.gzi` of their true offsets."""
    with open(bgz, "wb") as fh:
        fh.write(b"".join(blocks) + bgzf_job.EOF_BLOCK)
    offsets, at = [], 0
    for n, block in enumerate(blocks):
        offsets.append((at, n * 65280))
        at += len(block)
    batch_job.write_gzi(bgz + ".gzi", offsets)


def _left_out(bgz):
    _, _, payloads = _payloads(bgz)
    _rewrite(bgz, [bgzf_job._block(p, 6) for n, p in enumerate(payloads) if n != 1])


def _at_level(level):
    def rewrite(bgz):
        """Every block deflated at ``level``, so the sampled block is one."""
        _, _, payloads = _payloads(bgz)
        _rewrite(bgz, [bgzf_job._block(p, level) for p in payloads])
    return rewrite


def _crc(bgz):
    data, blocks, _ = _payloads(bgz)
    at, _, bsize = blocks[1]
    data = bytearray(data)
    data[at + bsize - 8] ^= 0x5A
    with open(bgz, "wb") as fh:
        fh.write(data)


def _gzi_shifted(bgz):
    with open(bgz + ".gzi", "r+b") as fh:
        fh.seek(8)
        (c,) = struct.unpack("<Q", fh.read(8))
        fh.seek(8)
        fh.write(struct.pack("<Q", c + 1))


@pytest.mark.parametrize("fault,reading", [
    (_left_out, "bgz_bytes_wrong"), (_at_level(0), "bgz_blocks_unequal"),
    (_at_level(5), "bgz_blocks_unequal"), (_at_level(4), "bgz_blocks_unequal"),
    (_crc, "bgz_fields_wrong"), (_gzi_shifted, "bgz_fields_wrong")],
    ids=["left_out", "stored", "level5", "level4", "crc", "gzi_shifted"])
def test_bgzip_faults_are_not_correct(tmp_path, monkeypatch, fault, reading):
    from pykmer_tpu_torch.index import indexer

    real = indexer.write_bgzip

    def faulty(kin, size):
        bgz, gzi = real(kin, size)
        fault(bgz)
        return bgz, gzi

    monkeypatch.setattr(indexer, "write_bgzip", faulty)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["check"][reading]["value"] > 0
    assert result["check"]["kin_bytes_wrong"]["value"] == 0


def test_a_missing_output_is_not_correct(tmp_path):
    kin = str(tmp_path / "m.kin")
    with open(kin, "wb") as fh:
        fh.write(bytes(range(256)) * 600)
    judged = batch_job.judge_bgz(kin, BASE["output"], {0})
    assert judged["bytes"] == 153_600 and judged["fields"] > 0


def test_the_walk_reads_the_blocks_bgzip_writes(tmp_path):
    data = bytes(range(256)) * 1000
    path = str(tmp_path / "w.bgz")
    assert bgzf_job.bgzip(data, path, 65280, 6) == 5
    with open(path, "rb") as fh:
        raw = fh.read()
    blocks, stopped = batch_job.walk(raw)
    assert stopped == 0 and len(blocks) == 5 and sum(b[2] for b in blocks) == len(raw)
    assert batch_job.walk(raw[:-3])[1] == 1 and batch_job.walk(b"x" + raw)[1] == 1


# ---- the metrics -------------------------------------------------------------

def _read(monkeypatch, name, runs):
    import collections

    from pykmer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "FINISHED_RUNS", collections.deque(runs, maxlen=8))
    run = types.SimpleNamespace(completed=[object()] * len(runs))
    return harness.code_file("metrics", name).read(run)


def _recorded(tmp_path, monkeypatch, bgzip):
    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.utils import profiling

    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    fasta = str(tmp_path / "r.fa")
    genome.make_genome(fasta, 5, genome_bp=200_000, records=2, n_bases=2000, n_runs=1)
    create_fasta_index(fasta, "s", fasta, 11, verbose=False, device="cpu", bgzip=bgzip)
    return profiling.FINISHED_RUNS[-1]


def test_bgzip_metrics_read_a_recorded_index(tmp_path, monkeypatch):
    recorded = _recorded(tmp_path, monkeypatch, bgzip=True)
    seconds = _read(monkeypatch, "bgzip_s", [recorded])
    stage = next(s for s in recorded.spans if s.name == "bgzip")
    assert seconds == pytest.approx((stage.end - stage.start) / 1e9)
    rate = _read(monkeypatch, "deflate_gb_per_s", [recorded])
    assert rate is not None and rate > 0
    assert sum(s.counts["bytes"] for s in recorded.spans if s.name == "bgzf deflate") \
        == 4 ** 11


def test_bgzip_metrics_read_nothing_without_their_spans(tmp_path, monkeypatch):
    recorded = _recorded(tmp_path, monkeypatch, bgzip=False)
    for name in ("bgzip_s", "deflate_gb_per_s"):
        assert _read(monkeypatch, name, [recorded]) is None
        assert _read(monkeypatch, name, []) is None


def _span(name, start, end, **counts):
    return types.SimpleNamespace(name=name, start=start, end=end, thread="t", counts=counts)


def test_bgzip_metrics_on_hand_made_runs(monkeypatch):
    one = types.SimpleNamespace(spans=[
        _span("bgzip", 0, 3 * 10**9),
        _span("bgzf deflate", 0, 10**9, bytes=2 * 10**8),
        _span("bgzf deflate", 5 * 10**8, 2 * 10**9, bytes=10**8)])
    two = types.SimpleNamespace(spans=[_span("bgzip", 0, 10**9),
                                       _span("bgzf deflate", 0, 10**9, bytes=10**8)])
    assert _read(monkeypatch, "bgzip_s", [one, two]) == pytest.approx(2.0)
    # 0.4 GB over the 2 s with a span in flight
    assert _read(monkeypatch, "deflate_gb_per_s", [one, two]) == pytest.approx(0.2)


# ---- the manifest ------------------------------------------------------------

def test_manifest_lists_the_cell_by_name():
    manifest = harness.load_manifest()
    assert harness.manifest_errors(manifest) == []
    config = next(c for c in manifest["configs"] if c["name"] == "plants-k15-batch")
    assert (config["file"], config["reduced"]) == ("kbench/configs/plants-k15-batch.json", [])
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("plants-k15-batch", CELL, 1)
    rate = next(m for m in manifest["end_to_end"] if m["name"] == "index_bp_per_s")
    assert CELL in rate["workloads"]
    for name, unit, better in (("bgzip_s", "s", "lower"),
                               ("deflate_gb_per_s", "GB/s", "higher")):
        m = next(m for m in manifest["per_layer"] if m["name"] == name)
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == (unit, better, "program_span", "bgzip output",
                                    "index_bp_per_s", [CELL])


def test_config_keeps_the_genome_and_input_of_plants_k15_bgzf():
    bgzf = harness.data_file("configs", "plants-k15-bgzf")
    assert genome.spec(BASE) == genome.spec(bgzf) and BASE["kmer_len"] == 15
    assert BASE["input"] == bgzf["input"] and BASE["reduced"] == []
    out = BASE["output"]
    assert (out["block_payload"], out["level"], out["eof_block"]) == (65280, 6, True)
    assert out["files"] == [".kin", ".kin.bgz", ".kin.bgz.gzi"]
    assert WORKLOAD["job"] == "index_batch" and WORKLOAD["verify"]
