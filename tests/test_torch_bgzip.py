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


@pytest.fixture
def card_route_on_cpu(monkeypatch):
    """``write_bgzip``'s card route run on the CPU: no card to select, no
    page-locked buffer to lease, and ``ops/deflate.deflate_bgzf`` of a CPU
    tensor (the host's zlib) standing in for the kernels."""
    import contextlib

    monkeypatch.setattr(tbgzip.torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tbgzip.PINNED_OUT, "try_lease", lambda size: None)
    monkeypatch.setattr(tbgzip, "CARD_RUN_BLOCKS", 2)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")


def _folded_kin(tmp_path, k=9, seed=46):
    """A random folded plane of K=``k`` and its `.kin` (``ops/unfold``'s
    file bytes), written to ``tmp_path``."""
    import torch

    from pykmer_tpu_torch.ops import unfold

    rng = np.random.default_rng(seed)
    half = 4 ** k // 2
    plane = torch.from_numpy((rng.integers(0, 5, half) * (rng.random(half) < 0.3))
                             .astype(np.uint8))
    path = str(tmp_path / "p.kin")
    unfold.unfold_file_plain(plane, 0, k, 0, 4 ** k).numpy().tofile(path)
    return plane, path


def test_card_route_deflates_the_plane(tmp_path, card_route_on_cpu):
    """Given the plane, the card route unfolds each run of it (no "kin
    read"), deflates it on the thread "bgzf-deflate_card" (each span's
    ``card_blocks`` its ``blocks``) and writes ``io/bgzf.bgzip_kin``'s
    bytes."""
    import torch

    from pykmer_tpu_torch.utils.profiling import StageTimer

    plane, path = _folded_kin(tmp_path)
    size = 4 ** 9
    timer = StageTimer()
    with timer.stage("bgzip"):
        tbgzip.write_bgzip(path, size, torch.device("cuda"), plane)
    deflates = [s for s in timer.spans if s.name == "bgzf deflate"]
    blocks = -(-size // 65280)
    assert len(deflates) == -(-blocks // 2)
    assert all(s.thread == "bgzf-deflate_card" for s in deflates)
    assert [s.counts["card_blocks"] for s in deflates] == [s.counts["blocks"] for s in deflates]
    assert sum(s.counts["blocks"] for s in deflates) == blocks
    assert sum(s.counts["bytes"] for s in deflates) == size
    assert sum(s.counts["bytes_out"] for s in deflates) + 28 == os.path.getsize(path + ".bgz")
    assert not [s for s in timer.spans if s.name == "kin read"]
    shutil.copy(path, str(tmp_path / "copy.kin"))
    bgzf.bgzip_kin(str(tmp_path / "copy.kin"))
    for ext in (".bgz", ".bgz.gzi"):
        assert _read(path + ext) == _read(str(tmp_path / "copy.kin") + ext)


def test_card_route_failure_leaves_no_output(tmp_path, card_route_on_cpu, monkeypatch):
    """A run that fails on the card thread raises in ``write_bgzip``, which
    leaves neither file nor a temporary, and its thread has ended."""
    import threading

    import torch

    from pykmer_tpu_torch.ops import deflate

    plane, path = _folded_kin(tmp_path)
    real, calls = deflate.deflate_bgzf, []

    def fail_second(data):
        calls.append(data.shape[0])
        if len(calls) == 2:
            raise RuntimeError("deflate launch failed: cudaError_t 2")
        return real(data)

    monkeypatch.setattr(deflate, "deflate_bgzf", fail_second)
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        tbgzip.write_bgzip(path, 4 ** 9, torch.device("cuda"), plane)
    assert sorted(os.listdir(tmp_path)) == ["p.kin"]
    assert not [t for t in threading.enumerate() if t.name == "bgzf-deflate_card"]


@pytest.mark.parametrize("readback", ["raw", "packed", "sparse", "pieces"])
def test_no_tail_alters_the_plane(tmp_path, monkeypatch, readback):
    """The card route deflates the plane after the tail has written the
    `.kin` from it, so no tail may alter it: each (sparse and the pieces
    tail with their thresholds lowered) leaves the plane as it found it."""
    import torch

    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.ops import packing

    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", 1 << 13)
    if readback == "pieces":
        monkeypatch.setattr(indexer, "PIECES_MIN_CELLS", 0)
    real, seen = indexer.write_kin, []

    def checked(header, plane, tail, *rest):
        before = plane.clone()
        real(header, plane, tail, *rest)
        seen.append(tail)
        assert torch.equal(plane, before)

    monkeypatch.setattr(indexer, "write_kin", checked)
    fasta = _fasta(tmp_path, "n.fa", 47, lengths=(30_000, 9000))
    mode = "sparse" if readback == "pieces" else readback
    create_fasta_index(fasta, "n", fasta, 11, verbose=False, device="cpu",
                       config=IndexConfig(kmer_len=11, chunk_windows=4096, readback=mode))
    assert seen == [readback]
