"""The port's benchmark entry points on the CPU, at a tiny size.

- ``bench_gpu.py`` in a subprocess with ``--device cpu`` (K=9, a 200 kbp
  genome, one timed run, no spaced runs, no K=17 leg; the merge pair forced
  on): the JSON line's keys, its numbers, equal `.kin` sha256 over every
  run, exit 0, and the `.kin` byte-equal to the JAX package's
  ``create_fasta_index`` of the same genome; its device-step leg in this
  process on the genome's second chunk;
- a leg made to fail (the merge pair's copy target is a directory) still
  prints the JSON line, with the error, and exits 1; without a card the
  default ``--device cuda`` fails;
- ``scripts/bench_merge_fanin_torch``: ``fabricate_kin`` writes the bytes of
  ``scripts/bench_merge_fanin.fabricate_kin`` (raw and `.bgz`), and the
  fan-in at N=4, K=7 writes the `.kma` of the JAX package's ``merge``;
- ``scripts/bench_device_step_torch``: every stage timed, the table and the
  JSON printed.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from reference_runner import VOLATILE_KIN_JSON_KEYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
for path in (REPO, SCRIPTS):
    if path not in sys.path:
        sys.path.insert(0, path)

import bench_device_step_torch as bdst  # noqa: E402
import bench_merge_fanin as jfanin  # noqa: E402
import bench_merge_fanin_torch as tfanin  # noqa: E402

BENCH_K, BENCH_BP = 9, 200_000
TINY = {"BENCH_K": str(BENCH_K), "BENCH_BP": str(BENCH_BP), "BENCH_RUNS": "1",
        "BENCH_SPACED": "0", "BENCH_K17": "0", "BENCH_MERGE": "force", "BENCH_FANIN": "0"}
# bench.py's keys, and those the port adds
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "protocol", "runs", "runs_planned",
              "verified_bp_per_s", "verified_runs", "verified_vs_baseline", "merge_pair_s",
              "merge_pair_runs_s", "merge_mb_per_s", "merge_vs_baseline"}
PORT_KEYS = {"device", "card", "output_checksums", "launches", "merge_engine", "setup_s"}


def run_bench(bench_dir, extra_env=None, args=("--device", "cpu")):
    env = {**os.environ, **TINY, **(extra_env or {})}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_gpu.py"), *args,
                           "--bench-dir", str(bench_dir)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert lines, proc.stderr[-3000:]
    return proc.returncode, json.loads(lines[-1]), proc.stderr


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    rc, res, err = run_bench(d)
    return d, rc, res, err


def test_bench_runs_and_prints_the_json_line(tiny_bench):
    _, rc, res, err = tiny_bench
    assert rc == 0, err[-3000:]
    assert BENCH_KEYS | PORT_KEYS <= set(res), BENCH_KEYS | PORT_KEYS - set(res)
    assert res["metric"] == f"index_bp_per_s_k{BENCH_K}_1cpu"
    assert res["unit"] == "bp/s" and res["device"] == "cpu" and res["card"] is None
    assert not [k for k in res if k.endswith("_error")]
    assert res["value"] > 0 and res["value"] == max(res["runs"])
    assert res["runs_planned"] == 1 and len(res["runs"]) == 1
    assert len(res["verified_runs"]) == 2 and res["verified_bp_per_s"] > 0
    assert res["vs_baseline"] > 0 and res["verified_vs_baseline"] > 0


def test_bench_runs_share_one_checksum(tiny_bench):
    d, _, res, _ = tiny_bench
    sums = res["output_checksums"]
    assert len(sums) == 3 and len(set(sums)) == 1  # one timed run, two verified
    from pykmer_tpu_torch.utils.checksum import sha256_file

    assert sha256_file(str(d / f"synthetic_{BENCH_BP}.fa.{BENCH_K:02d}.kin")) == sums[0]


def test_bench_merge_leg_and_launches(tiny_bench):
    _, _, res, _ = tiny_bench
    assert len(res["merge_pair_runs_s"]) == 3 and res["merge_pair_s"] > 0
    assert res["merge_engine"] == "host"  # N = 2: the auto rule's host engine
    # on the CPU the wrappers run their plain versions and count nothing
    assert set(res["launches"].values()) == {0}
    # the legs that run on the card at K=15 only
    assert not {"device_step", "pcie_probes_mb_s", "k17_bp_per_s", "merge_fanin_s"} & set(res)


def test_bench_device_step_leg_on_a_real_chunk(tiny_bench, monkeypatch):
    import bench_gpu
    import torch

    from pykmer_tpu_torch.config import IndexConfig
    from pykmer_tpu_torch.host.pipeline import iter_pipelined_chunks

    d, _, _, _ = tiny_bench
    fasta = str(d / f"synthetic_{BENCH_BP}.fa")
    with open(fasta, "rb") as fh:
        want = list(iter_pipelined_chunks(fh.read(), BENCH_K, 1 << 15, {}))[1]
    got = bench_gpu.genome_chunk(fasta, BENCH_K, 1 << 15)
    assert np.array_equal(got[0], want[0]) and (got[1] is None) == (want[1] is None)
    run = bench_gpu.Bench(torch.device("cpu"), str(d))
    run.device_step(fasta, BENCH_K, IndexConfig(kmer_len=BENCH_K, chunk_windows=1 << 15))
    step = run.result["device_step"]
    assert step["device"] == "cpu" and step["windows"] == 1 << 15
    for key in ("encode_kernel_ms", "encode_plain_ms", "sort_ms", "stepA_ms", "sweep_ms",
                "stepAB_ms"):
        assert step[key] > 0, key
    assert "encode_bound_ms" not in step  # no card: no share of the card's bound
    assert run.result["device_windows_per_s"] == step["windows_per_s"] > 0


def test_bench_kin_matches_the_jax_package(tiny_bench, tmp_path):
    d, _, _, _ = tiny_bench
    from pykmer_tpu.index import create_fasta_index

    fa = str(tmp_path / "genome.fa")
    shutil.copyfile(d / f"synthetic_{BENCH_BP}.fa", fa)
    create_fasta_index(fa, "jax", fa, BENCH_K, verbose=False)
    with open(fa + f".{BENCH_K:02d}.kin", "rb") as fh:
        want = fh.read()
    with open(d / f"synthetic_{BENCH_BP}.fa.{BENCH_K:02d}.kin", "rb") as fh:
        assert fh.read() == want


def test_bench_failing_leg_exits_nonzero_with_the_json_line(tmp_path):
    # the merge pair copies the .kin to this path: a directory there fails it
    os.makedirs(tmp_path / f"synthetic_{BENCH_BP}.fa2.{BENCH_K:02d}.kin")
    rc, res, err = run_bench(tmp_path)
    assert rc == 1
    assert [k for k in res if k.endswith("_error")] == ["merge_error"], err[-3000:]
    assert res["value"] > 0 and len(set(res["output_checksums"])) == 1  # the K leg ran


def test_bench_without_a_card_fails(tmp_path):
    rc, res, _ = run_bench(tmp_path, args=())
    assert rc == 1 and res["value"] == 0 and "CUDA is not available" in res["error"]


@pytest.mark.parametrize("bgz", [False, True])
def test_fabricate_kin_matches_the_jax_script(tmp_path, bgz):
    stem = str(tmp_path / "s00")
    got = []
    for fabricate in (jfanin.fabricate_kin, tfanin.fabricate_kin):
        path = fabricate(stem, 7, seed=1003, bgz=bgz)
        with open(path, "rb") as fh:
            data = fh.read()
        meta = json.loads(open(f"{stem}.fa.07.kin.json").read())
        for key in VOLATILE_KIN_JSON_KEYS | {"input_file_ctime"}:
            meta.pop(key, None)
        got.append((os.path.basename(path), data, meta))
        for f in os.listdir(tmp_path):
            os.remove(tmp_path / f)
    assert got[0] == got[1]
    assert got[0][0].endswith(".kin.bgz" if bgz else ".kin")


@pytest.mark.parametrize("engine", ["auto", "device"])
def test_fanin_matches_the_jax_merge(tmp_path, engine):
    from pykmer_tpu.merge import merge as jax_merge

    d = str(tmp_path / "fanin")
    kins = tfanin.ensure_fanin_inputs(d, 4, 7, 1)
    assert [os.path.basename(k) for k in kins] == [
        "s00.fa.07.kin.bgz", "s01.fa.07.kin", "s02.fa.07.kin", "s03.fa.07.kin"]
    assert tfanin.ensure_fanin_inputs(d, 4, 7, 1) == kins  # cached, not rewritten
    dt, ran, kma, matrix = tfanin.merge_fanin(d, kins, "cpu", engine=engine)
    assert dt > 0 and ran == ("host" if engine == "auto" else "device")
    jax_merge(str(tmp_path / "jax"), sorted(kins), verbose=False)
    with open(kma, "rb") as fh, open(tmp_path / "jax.001-255.kma", "rb") as fj:
        assert fh.read() == fj.read()
    assert matrix.shape == (4, 4, 3)


def test_fanin_script_main_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MERGE_BENCH_DIR", str(tmp_path))
    assert tfanin.main(["3", "5", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "N=3 K=5 (1 bgz" in out and "engine host" in out and "peak RSS" in out


def test_device_step_script_on_cpu(capsys):
    import torch

    t = bdst.step_times(torch.device("cpu"), bdst.random_chunk(7, 4096), 7, 4096, reps=2)
    assert t["chunk"] == "all-valid" and t["windows"] == 4096
    assert all(t[k] > 0 for k in ("encode_kernel_ms", "sort_ms", "stepA_ms", "sweep_ms",
                                  "stepAB_ms", "windows_per_s"))
    assert bdst.main(["7", "4096", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "device step on cpu, K=7, 4,096 windows" in lines[0]
    assert json.loads(lines[-1])["kmer_len"] == 7


def test_device_step_sweep_bound_counts_distinct_sectors():
    import torch

    codes = torch.tensor([-1, 0, 1, 31, 32, 64, 64, 1 << 20], dtype=torch.int64)
    ms, sectors, moved = bdst.sweep_bound_ms([codes], 1 << 10)
    assert sectors == 3 and moved == codes.numel() * 8 + 3 * 64
    assert ms == moved / bdst.HBM_BYTES_PER_S * 1e3
