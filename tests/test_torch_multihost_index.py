"""``create_fasta_index_multihost`` of the port in real gloo jobs on the CPU
(each process a local mesh of four CPU devices), case for case the JAX
package's ``tests/test_multihost.py``: two processes on a plain input, a
`.bgz` byte split, a `.gz` with staging on and off, the uniform decode
failure, three processes over two uneven records, a crash after the first
checkpoint and the resume; plus three processes at K=5, whose 512 folded
cells the combine splits raggedly, and a stall of process 0 before the last
barrier that outlasts the job's peer timeout.

Every `.kin` is byte-equal to the JAX package's single-process
``create_fasta_index`` of the same file on the CPU, and every `.kin.json`
field but the creation times equal (the tolerance is exact). The workers are
``test_torch_multihost.py`` run as a script.
"""

import glob
import gzip
import json
import os

import numpy as np
import pytest

from test_torch_multihost import run_workers

K = 5


def _reference(path, cw):
    """The JAX package's single-process build of ``path``: (.kin bytes,
    .kin.json); both files are removed so the job writes the same paths."""
    from pykmer_tpu.config import IndexConfig
    from pykmer_tpu.index import create_fasta_index

    h = create_fasta_index(path, "mh", path, K,
                           config=IndexConfig(kmer_len=K, chunk_windows=cw), verbose=False)
    with open(h.index_file_root, "rb") as fh:
        kin = fh.read()
    with open(h.metadata_file) as fh:
        meta = json.load(fh)
    os.remove(h.index_file_root)
    os.remove(h.metadata_file)
    return kin, meta


def _assert_matches(path, want):
    from reference_runner import VOLATILE_KIN_JSON_KEYS

    kin, meta = want
    with open(f"{path}.{K:02d}.kin", "rb") as fh:
        assert fh.read() == kin
    with open(f"{path}.{K:02d}.kin.json") as fh:
        got = json.load(fh)
    assert set(got) == set(meta)
    for key in set(meta) - VOLATILE_KIN_JSON_KEYS:
        assert got[key] == meta[key], key


def _fasta(tmp_path, name, rng, lengths):
    from conftest import make_random_fasta

    return make_random_fasta(str(tmp_path / name), rng, n_records=len(lengths),
                             lengths=lengths)


def _ok(results, nproc):
    assert len(results) == nproc
    for rc, out in results:
        assert rc == 0, out
    assert "worker 0: ok header=yes" in results[0][1], results[0][1]
    for pid in range(1, nproc):
        assert f"worker {pid}: ok header=no" in results[pid][1], results[pid][1]


def test_two_process_distributed_index(tmp_path, rng):
    fa = _fasta(tmp_path, "mh.fa", rng, (700, 350, 90))
    want = _reference(fa, 1 << 10)
    _ok(run_workers(2, "index", [fa, K]), 2)
    _assert_matches(fa, want)
    assert sorted(os.listdir(tmp_path)) == ["mh.fa", "mh.fa.05.kin", "mh.fa.05.kin.json"]


def test_two_process_bgz_input_byte_split(tmp_path, rng):
    """A `.fa.bgz` splits in uncompressed space through its block index."""
    from pykmer_tpu_torch.io.bgzf import compress_file

    fa = _fasta(tmp_path, "bz.fa", rng, (900, 400, 150))
    bgz, _ = compress_file(fa, fa + ".bgz")
    want = _reference(bgz, 1 << 10)
    _ok(run_workers(2, "index", [bgz, K, 1 << 10]), 2)
    _assert_matches(bgz, want)


@pytest.mark.parametrize("stage", ["1", "0"])
def test_two_process_gz_input_window_slice(tmp_path, rng, stage):
    """A plain `.gz`: staged once by process 0 and byte-range-read (the
    default), or, with staging off, decoded whole by every process and
    split by windows. The staged file is removed."""
    fa = _fasta(tmp_path, "gz.fa", rng, (900, 400, 150))
    gz = fa + ".gz"
    with open(fa, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    want = _reference(gz, 1 << 10)
    _ok(run_workers(2, "index", [gz, K, 1 << 10],
                    env_extra={"PYKMER_TPU_MULTIHOST_GZ_STAGE": stage}), 2)
    _assert_matches(gz, want)
    assert glob.glob(gz + ".*.inflated.tmp*") == []


def test_two_process_decode_failure_uniform_error(tmp_path, rng):
    """A decode failure on the non-main process's byte slice: every process
    exits 7 with the same error, the staged file is removed, and there is no
    output."""
    fa = _fasta(tmp_path, "gz.fa", rng, (900, 400, 150))
    gz = fa + ".gz"
    with open(fa, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    for rc, out in run_workers(2, "index", [gz, K, 1 << 10, 0, 0, 1]):
        assert rc == 7, (rc, out)
        assert "byte-range decode failed on 1/2 host" in out, out
        assert "injected decode failure" in out, out
    assert glob.glob(gz + ".*.inflated.tmp*") == []
    assert not os.path.exists(f"{gz}.{K:02d}.kin")
    assert not os.path.exists(f"{gz}.{K:02d}.kin.tmp")


def test_three_process_uneven_records(tmp_path, rng):
    """Three processes over two records: one byte range holds no record, and
    its empty partial still combines."""
    fa = _fasta(tmp_path, "u3.fa", rng, (1200, 90))
    want = _reference(fa, 1 << 10)
    from pykmer_tpu_torch.parallel.multihost import host_byte_slice

    assert any(lo == hi for lo, hi in (host_byte_slice(fa, p, 3) for p in range(3)))
    _ok(run_workers(3, "index", [fa, K, 1 << 10]), 3)
    _assert_matches(fa, want)


def test_three_process_ragged_combine(tmp_path, rng):
    """Three processes, each with a share, at K=5: the 512 folded cells split
    171 / 171 / 170 in the combine and the sharded write."""
    fa = _fasta(tmp_path, "r3.fa", rng, (800, 700, 900, 600, 750, 820))
    want = _reference(fa, 256)
    from pykmer_tpu_torch.parallel.multihost import host_byte_slice

    assert all(lo < hi for lo, hi in (host_byte_slice(fa, p, 3) for p in range(3)))
    _ok(run_workers(3, "index", [fa, K, 256]), 3)
    _assert_matches(fa, want)


def test_two_process_finish_outwaits_the_peer_timeout(tmp_path, rng):
    """Process 0 alone re-reads the written plane before the job's last
    barrier. A stall there longer than the job's peer timeout (5 s here)
    fails no process: that wait's timeout scales with the plane's bytes."""
    fa = _fasta(tmp_path, "st.fa", rng, (700, 350, 90))
    want = _reference(fa, 1 << 10)
    _ok(run_workers(2, "index", [fa, K, 1 << 10, 0, 0, -1, "cpu", 5, 7]), 2)
    _assert_matches(fa, want)


def test_two_process_crash_resume(tmp_path, rng):
    """Both processes die after their first checkpoint (or of the other's
    death); the relaunch resumes from each process's checkpoint, writes the
    reference bytes and clears every checkpoint."""
    from pykmer_tpu_torch.parallel.multihost import load_shard_checkpoint

    cw = 1 << 9
    fa = _fasta(tmp_path, "cr.fa", rng, (4000, 2500, 1500, 800))
    want = _reference(fa, cw)
    results = run_workers(2, "index", [fa, K, cw, 1, 1])
    for rc, out in results:
        assert rc != 0, out
    assert any("simulated crash after checkpoint" in out for _, out in results)
    tmp = f"{fa}.{K:02d}.kin.tmp"
    saved = [load_shard_checkpoint(f"{tmp}.proc{p:03d}") for p in range(2)]
    assert any(s is not None for s in saved), "no checkpoint written"
    for p, s in enumerate(saved):
        if s is not None:
            assert (s[1]["pid"], s[1]["nproc"], s[1]["next_step"]) == (p, 2, 1)

    results = run_workers(2, "index", [fa, K, cw, 1, 0])
    _ok(results, 2)
    _assert_matches(fa, want)
    for s, (_, out) in zip(saved, results):
        assert ("checkpoint found, next step 1" in out) == (s is not None), out
    assert not os.path.isdir(f"{tmp}.proc000.ckpt")
    assert not os.path.isdir(f"{tmp}.proc001.ckpt")
