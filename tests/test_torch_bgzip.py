"""The index's bgzip output (``index/bgzip.py``) on the CPU: ``index
--bgzip`` and ``index-batch --bgzip`` write the JAX CLI's `.kin.bgz` and
`.gzi` byte for byte, the sharded index the single-card one's; the output is
written inside the `.kin` finish, as the "bgzip" stage after the rename,
with spans whose counts add up; a failed deflate leaves neither file, so a
later batch indexes the input again; without the native library the bytes
are the same."""

import collections
import json
import os
import shutil
import sys

import numpy as np
import pytest

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu import cli as jcli
from pykmer_tpu_torch import cli as tcli
from pykmer_tpu_torch import create_fasta_index
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.index import bgzip as tbgzip
from pykmer_tpu_torch.index import create_fasta_index_sharded, index_batch
from pykmer_tpu_torch.io import bgzf
from pykmer_tpu_torch.parallel import make_mesh
from pykmer_tpu_torch.utils import profiling

pytest.importorskip("pykmer_tpu_torch.io.native")

OUTPUTS = (".kin", ".kin.json", ".kin.bgz", ".kin.bgz.gzi")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _fasta(tmp_path, name, seed, lengths=(2600, 700, 1400)):
    return make_random_fasta(str(tmp_path / name), np.random.default_rng(seed),
                             n_records=len(lengths), lengths=lengths)


def _take(root):
    """The bytes of ``root``'s four outputs (the `.kin.json` without its
    volatile keys), each file removed."""
    out = {}
    for ext in OUTPUTS:
        path = root + ext[len(".kin"):]
        data = _read(path)
        if ext == ".kin.json":
            data = {k: v for k, v in json.loads(data).items()
                    if k not in VOLATILE_KIN_JSON_KEYS}
        out[ext] = data
        os.remove(path)
    return out


@pytest.mark.parametrize("command", ["index", "index-batch"])
def test_cli_bgzip_output_matches_jax(tmp_path, monkeypatch, command):
    """Three blocks in runs of two: both CLIs leave the same four files and
    nothing else."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tbgzip, "RUN_BLOCKS", 2)
    fasta = _fasta(tmp_path, "c.fa", 41)
    argv = ["index", fasta, "s", "9"] if command == "index" else ["index-batch", "9", fasta]
    runs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        assert main(argv + ["--quiet", "--bgzip"] + extra) == 0
        assert sorted(os.listdir(tmp_path)) == sorted(
            ["c.fa"] + [f"c.fa.09{ext}" for ext in OUTPUTS])
        runs.append(_take(fasta + ".09.kin"))
    jax, port = runs
    assert port == jax
    # the .gzi lists every block but the first
    assert int.from_bytes(port[".kin.bgz.gzi"][:8], "little") == -(-4 ** 9 // 65280) - 1


@pytest.mark.parametrize("n_data,n_shards", [(1, 2), (2, 2)])
def test_sharded_bgzip_output_equals_single_card(tmp_path, n_data, n_shards):
    fasta = _fasta(tmp_path, "s.fa", 42 + n_shards)
    cfg = IndexConfig(kmer_len=9, chunk_windows=256)
    single = create_fasta_index(fasta, "x", fasta, 9, config=cfg, verbose=False,
                                device="cpu", bgzip=True)
    want = _take(single.index_file_root)
    sharded = create_fasta_index_sharded(fasta, "x", fasta, 9, config=cfg, verbose=False,
                                         mesh=make_mesh(n_shards, n_data, device="cpu"),
                                         bgzip=True)
    got = _take(sharded.index_file_root)
    assert got[".kin.bgz"] == want[".kin.bgz"] and got[".kin.bgz.gzi"] == want[".kin.bgz.gzi"]
    assert got[".kin"] == want[".kin"]


@pytest.fixture
def finished(monkeypatch):
    runs = collections.deque(maxlen=profiling.RUNS_KEPT)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR", raising=False)
    return runs


@pytest.mark.parametrize("run_blocks", [16, 64])
def test_bgzip_spans_add_up(tmp_path, monkeypatch, finished, run_blocks):
    """K=11, a 4 MiB `.kin` of 65 blocks: "bgzf deflate" bytes = 4^K and
    blocks = ceil(4^K / 65,280), one run of ``run_blocks`` a span on the
    "bgzf-deflate" threads; ``bytes_out`` + 28 = the `.kin.bgz`'s size, as
    are the "bgzf write" bytes; "kin read" reads the `.kin` once. Every span
    sits under the "bgzip" stage, the table's last row, which begins after
    the verify; the files are ``io/bgzf.bgzip_kin``'s."""
    monkeypatch.setattr(tbgzip, "RUN_BLOCKS", run_blocks)
    fasta = _fasta(tmp_path, "r.fa", 43, lengths=(30_000, 9000))
    header = create_fasta_index(fasta, "r", fasta, 11, verbose=False, device="cpu",
                                config=IndexConfig(kmer_len=11, chunk_windows=4096),
                                bgzip=True)
    root, size = header.index_file_root, 4 ** 11
    (timer,) = finished
    assert [name for name, _ in timer.stages][-2:] == ["verify", "bgzip"]
    stage = next(s for s in timer.spans if s.name == "bgzip")
    verify = next(s for s in timer.spans if s.name == "verify")
    assert stage.start >= verify.end and stage.parent is None
    deflates = [s for s in timer.spans if s.name == "bgzf deflate"]
    blocks = -(-size // 65280)
    assert len(deflates) == -(-blocks // run_blocks)
    assert sum(s.counts["bytes"] for s in deflates) == size
    assert sum(s.counts["blocks"] for s in deflates) == blocks
    assert sum(s.counts["bytes_out"] for s in deflates) + 28 == os.path.getsize(root + ".bgz")
    assert all(s.thread.startswith("bgzf-deflate_") for s in deflates)
    writes = [s for s in timer.spans if s.name == "bgzf write"]
    assert sum(s.counts["bytes"] for s in writes) == os.path.getsize(root + ".bgz")
    reads = [s for s in timer.spans if s.name == "kin read"]
    assert sum(s.counts["bytes"] for s in reads) == size and len(reads) == len(deflates)
    for s in deflates + writes + reads:
        assert s.parent is stage and stage.start <= s.start <= s.end <= stage.end
    shutil.copy(root, str(tmp_path / "copy.kin"))
    bgzf.bgzip_kin(str(tmp_path / "copy.kin"))
    assert _read(root + ".bgz") == _read(str(tmp_path / "copy.kin.bgz"))
    assert _read(root + ".bgz.gzi") == _read(str(tmp_path / "copy.kin.bgz.gzi"))
    assert bgzf.decompress_file(root + ".bgz") == _read(root)


def test_failed_deflate_leaves_no_output_and_a_later_batch_redoes_it(
        tmp_path, monkeypatch, capsys):
    """The second run's deflate fails: the batch reports the input, the
    `.kin` stays, and neither the `.kin.bgz` nor the `.gzi` (nor their
    temporaries) is there; a later ``--bgzip`` batch indexes it again where
    one without ``--bgzip`` skips it, and then both skip it."""
    monkeypatch.setattr(tbgzip, "RUN_BLOCKS", 2)
    fasta = _fasta(tmp_path, "f.fa", 44)
    root = fasta + ".09.kin"
    real, calls = tbgzip._deflate, []

    def fail_second(run):
        calls.append(run.shape[0])
        if len(calls) == 2:
            raise IOError("BGZF deflate failed")
        return real(run)

    monkeypatch.setattr(tbgzip, "_deflate", fail_second)
    cfg = IndexConfig(kmer_len=9, chunk_windows=256)
    result = index_batch([fasta], 9, config=cfg, bgzip=True, verbose=False, device="cpu")
    assert result.failed and "BGZF deflate failed" in result.failed[0]
    assert sorted(os.listdir(tmp_path)) == ["f.fa", "f.fa.09.kin", "f.fa.09.kin.json"]
    capsys.readouterr()

    assert index_batch([fasta], 9, config=cfg, verbose=False, device="cpu").skipped == [fasta]
    again = index_batch([fasta], 9, config=cfg, bgzip=True, verbose=False, device="cpu")
    assert again.indexed == [fasta] and not again.failed and not again.skipped
    assert bgzf.decompress_file(root + ".bgz") == _read(root)
    for bgzip in (False, True):
        assert index_batch([fasta], 9, config=cfg, bgzip=bgzip, verbose=False,
                           device="cpu").skipped == [fasta]


def test_batch_with_bgzip_skips_only_a_whole_output(tmp_path):
    """With ``bgzip`` an input is done once its `.kin.bgz` and `.gzi` are
    both there."""
    from pykmer_tpu_torch.index.batch import outputs_exist

    fasta = str(tmp_path / "o.fa")
    root = fasta + ".09.kin"
    for made, plain, with_bgzip in (([], False, False), ([".kin"], True, False),
                                    ([".kin.bgz"], True, False),
                                    ([".kin.bgz", ".kin.bgz.gzi"], True, True)):
        for ext in made:
            open(root + ext[len(".kin"):], "wb").close()
        assert outputs_exist(fasta, 9) == plain
        assert outputs_exist(fasta, 9, bgzip=True) == with_bgzip
        for ext in made:
            os.remove(root + ext[len(".kin"):])


def test_bgzip_without_native_library_writes_the_same_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(tbgzip, "RUN_BLOCKS", 16)
    rng = np.random.default_rng(45)
    size = 65280 * 20 + 777
    plane = (rng.integers(0, 4, size) * (rng.random(size) < 0.4)).astype(np.uint8)
    paths = [str(tmp_path / f"{name}.kin") for name in ("native", "zlib")]
    for path in paths:
        plane.tofile(path)
    tbgzip.write_bgzip(paths[0], size)
    monkeypatch.setitem(sys.modules, "pykmer_tpu_torch.io.native", None)
    tbgzip.write_bgzip(paths[1], size)
    for ext in (".bgz", ".bgz.gzi"):
        assert _read(paths[0] + ext) == _read(paths[1] + ext)
    assert bgzf.decompress_file(paths[1] + ".bgz") == plane.tobytes()


@pytest.mark.parametrize("cpus,threads", [({0, 3, 5, 6, 7}, 5), ({2}, 1)])
def test_deflate_threads_follow_the_affinity(monkeypatch, cpus, threads):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: cpus)
    assert tbgzip.deflate_threads() == threads
