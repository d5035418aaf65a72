"""The cell ``plants-k15-bgzf.index`` on the CPU at sizes a test holds: the
set-up's BGZF reads back through the standard library and the program's
block walk agrees with it; sound runs are correct; the control and planted
faults in the program's inflate are not; the two inflate metrics read their
spans from a recorded index and nothing without them; the manifest lists
the cell as the rules ask."""

import gzip
import hashlib
import json
import os
import types

import pytest

from kbench import genome, harness

CELL = "plants-k15-bgzf.index"
BASE = harness.data_file("configs", "plants-k15-bgzf")
WORKLOAD = dict(harness.data_file("workloads", CELL), warm_bp=100_000)
# K=5 over 1 Mbp saturates its cells, so the control's wrap shows; K=9
# leaves them below 255, so a few moved windows show
SATURATED = dict(BASE, kmer_len=5, genome_bp=1_000_000, records=2, n_bases=60_000)
SPARSE = dict(SATURATED, kmer_len=9)
bgzf_job = harness.code_file("jobs", "index_bgzf")


def _run(tmp_path, config=SATURATED, seconds=0.0, call=None):
    return harness.execute(CELL, 2**33 + 7, seconds, False, "cpu", config=config,
                           workload=WORKLOAD, call=call, say=lambda s: None,
                           directory=str(tmp_path / "run"))


@pytest.mark.parametrize("block,eof", [(65280, True), (1000, True), (777, False)])
def test_setup_bgzf_reads_back_and_the_walk_agrees(tmp_path, block, eof):
    from pykmer_tpu_torch.host import segments

    fasta = str(tmp_path / "g.fa")
    genome.make_genome(fasta, 11, genome_bp=300_000, records=3, n_bases=3000, n_runs=2)
    with open(fasta, "rb") as fh:
        data = fh.read()
    path = str(tmp_path / "g.fa.gz")
    blocks = bgzf_job.bgzip(data, path, block, 6, eof)
    assert blocks == -(-len(data) // block) + eof
    with open(path, "rb") as fh:
        assert gzip.decompress(fh.read()) == data
    assert bgzf_job.inflated_sha256(path) == hashlib.sha256(data).hexdigest()
    walked = segments.read_bgzf(path)
    assert len(walked.c_offs) - 1 == blocks and walked.size == len(data)


def test_sound_runs_are_correct(tmp_path):
    infos = []
    result = harness.execute(CELL, 2**33 + 7, 0.5, False, "cpu", config=SATURATED,
                             workload=WORKLOAD, directory=str(tmp_path / "run"),
                             say=lambda line: infos.append(json.loads(line)["kbench_info"]))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0 for c in result["check"].values())
    assert infos[0]["inflated_matches_fasta"] and infos[0]["bgzf_ratio"] > 1
    assert set(result["metrics"]) == {"index_bp_per_s", "setup_s"}


def test_control_is_not_correct(tmp_path):
    result = _run(tmp_path, call=bgzf_job.control)
    assert not result["correct"]
    assert result["check"]["kin_bytes_wrong"]["value"] > 0
    assert result["check"]["meta_fields_wrong"]["value"] > 0


def _misplaced(real):
    """The run's second block inflated over its third."""
    def fault(comp, out, c_offs, u_offs):
        real(comp, out, c_offs, u_offs)
        if len(u_offs) > 3:
            n = min(u_offs[2] - u_offs[1], u_offs[3] - u_offs[2])
            out[u_offs[2]:u_offs[2] + n] = out[u_offs[1]:u_offs[1] + n].copy()
    return fault


def _dropped(real):
    """The run's second block left as it was (zeros in a fresh buffer)."""
    def fault(comp, out, c_offs, u_offs):
        real(comp, out, c_offs, u_offs)
        if len(u_offs) > 2:
            out[u_offs[1]:u_offs[2]] = 0
    return fault


@pytest.mark.parametrize("fault", [_misplaced, _dropped])
def test_inflate_faults_are_not_correct(tmp_path, monkeypatch, fault):
    from pykmer_tpu_torch.host import segments

    monkeypatch.setattr(segments, "inflate_blocks", fault(segments.inflate_blocks))
    result = _run(tmp_path, config=SPARSE)
    assert not result["correct"]
    assert result["check"]["kin_bytes_wrong"]["value"] > 0


def test_setup_file_fault_is_not_correct(tmp_path, monkeypatch):
    """A set-up whose file loses a block inflates to other bytes than the
    FASTA it wrote: every call is judged wrong."""
    real = bgzf_job.bgzip

    def lossy(data, path, block_payload, level, eof_block=True):
        if len(data) > 4 * block_payload:  # the genome's file, not the warm one's
            cut = len(data) // 2 // block_payload * block_payload
            data = data[:cut] + data[cut + block_payload:]
        return real(data, path, block_payload, level, eof_block)

    code_file = harness.code_file
    monkeypatch.setattr(bgzf_job, "bgzip", lossy)
    monkeypatch.setattr(harness, "code_file", lambda kind, name: bgzf_job
                        if (kind, name) == ("jobs", "index_bgzf") else code_file(kind, name))
    assert not _run(tmp_path, config=SPARSE)["correct"]


# ---- the metrics -------------------------------------------------------------

def _read(name, runs):
    from pykmer_tpu_torch.utils import profiling

    saved = list(profiling.FINISHED_RUNS)
    profiling.FINISHED_RUNS.clear()
    profiling.FINISHED_RUNS.extend(runs)
    try:
        run = types.SimpleNamespace(completed=[object()] * len(runs))
        return harness.code_file("metrics", name).read(run)
    finally:
        profiling.FINISHED_RUNS.clear()
        profiling.FINISHED_RUNS.extend(saved)


def _recorded(tmp_path, monkeypatch, compressed):
    """The recorder's run of one CPU index of a small genome, as BGZF or
    plain."""
    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.utils import profiling

    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    monkeypatch.setattr(segments, "INFLATE_EXTENT", 100_000)
    fasta = str(tmp_path / "r.fa")
    genome.make_genome(fasta, 5, genome_bp=2_000_000, records=4, n_bases=2000, n_runs=1)
    path = fasta
    if compressed:
        with open(fasta, "rb") as fh:
            data = fh.read()
        path = fasta + ".gz"
        bgzf_job.bgzip(data, path, 65280, 6)
    before = len(profiling.FINISHED_RUNS)
    create_fasta_index(path, "s", path, 9, verbose=False, device="cpu")
    assert len(profiling.FINISHED_RUNS) == before + 1
    return profiling.FINISHED_RUNS[-1], os.path.getsize(fasta)


def test_inflate_metrics_read_a_recorded_index(tmp_path, monkeypatch):
    recorded, size = _recorded(tmp_path, monkeypatch, compressed=True)
    rate = _read("inflate_gb_per_s", [recorded])
    assert rate is not None and rate > 0
    inflated = sum(s.counts["bytes"] for s in recorded.spans if s.name == "bgzf inflate")
    assert inflated == size
    wait = _read("inflate_wait_s", [recorded])
    assert wait is not None and wait >= 0


def test_inflate_metrics_read_nothing_without_their_spans(tmp_path, monkeypatch):
    recorded, _ = _recorded(tmp_path, monkeypatch, compressed=False)
    assert _read("inflate_gb_per_s", [recorded]) is None
    assert _read("inflate_wait_s", [recorded]) is None
    assert _read("inflate_gb_per_s", []) is None


def _span(name, start, end, **counts):
    return types.SimpleNamespace(name=name, start=start, end=end, thread="t", counts=counts)


def test_inflate_metrics_on_hand_made_runs():
    one = types.SimpleNamespace(spans=[
        _span("bgzf inflate", 0, 10**9, bytes=2 * 10**9),
        _span("bgzf inflate", 5 * 10**8, 2 * 10**9, bytes=10**9),
        _span("inflate wait", 0, 3 * 10**8)])
    two = types.SimpleNamespace(spans=[_span("bgzf inflate", 0, 10**9, bytes=10**9)])
    # 4 GB over the 2 s with a span in flight
    assert _read("inflate_gb_per_s", [one, two]) == pytest.approx(2.0)
    assert _read("inflate_wait_s", [one, two]) == pytest.approx(0.15)


# ---- the manifest ------------------------------------------------------------

def test_manifest_lists_the_cell():
    manifest = harness.load_manifest()
    assert harness.manifest_errors(manifest) == []
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("plants-k15-bgzf", CELL, 1)
    rate = next(m for m in manifest["end_to_end"] if m["name"] == "index_bp_per_s")
    assert rate["workloads"][-1] == CELL
    for name, unit, better in (("inflate_gb_per_s", "GB/s", "higher"),
                               ("inflate_wait_s", "s", "lower")):
        m = next(m for m in manifest["per_layer"] if m["name"] == name)
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == (unit, better, "program_span",
                                    "input, decode and device accumulate",
                                    "index_bp_per_s", [CELL])
    assert [m["name"] for m in manifest["per_layer"]][-2:] == ["inflate_gb_per_s",
                                                               "inflate_wait_s"]


def test_config_keeps_the_genome_of_plants_k15():
    k15 = harness.data_file("configs", "plants-k15")
    assert genome.spec(BASE) == genome.spec(k15) and BASE["kmer_len"] == k15["kmer_len"]
    assert BASE["reduced"] == []
    assert BASE["input"]["block_payload"] == 65280 and BASE["input"]["level"] == 6
    assert BASE["input"]["suffix"] == ".fa.gz" and BASE["input"]["eof_block"]
    assert genome.valid_windows(kmer_len=15, **genome.spec(BASE)) == 782_469_030

