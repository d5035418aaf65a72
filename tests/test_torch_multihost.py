"""Multi-host glue of the port (``pykmer_tpu_torch/parallel/multihost.py``)
against the JAX package's, and the multi-host CLI.

- the copied numpy helpers on the JAX tests' inputs: ``host_slice``
  coverage, the exactness of ``combine_partial_dense``, record-aligned
  ``host_byte_slice``, BGZF slices equal to plain ones, ``unfold_piece``
  against ``unfold_canonical``;
- ``combine_partials_sharded`` in real gloo jobs: with two ranks, where the
  slab divides, its offsets and pieces equal the JAX function's in a
  two-process ``jax.distributed`` job on the same partials; with three ranks
  at K=5 (512 folded cells, which 3 does not divide) the ragged pieces tile
  the plane with the exact saturating merge;
- a two-process job through ``python -m pykmer_tpu_torch index
  --coordinator ...``: the `.kin` and `.kin.json` of the JAX CLI's
  single-process build.

This file is also the worker of its multi-process tests and of
``test_torch_multihost_index.py`` / ``test_torch_cuda.py`` (run as a script,
see ``_worker_main``), so its module level imports nothing that needs jax:
a card machine without jax runs its workers.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.abspath(__file__)


# ---- the launcher -------------------------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_processes(argvs, env_extra=None, timeout=120.0, grace=10.0, cwd=None):
    """Run one process per argv (a list of strings after the interpreter) and
    wait for all; once any exits non-zero, the rest get ``grace`` seconds and
    are then killed, and every process is killed at ``timeout``. Returns
    ``[(returncode, stdout + stderr text)]`` in order. No process outlives
    the call."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, HERE, os.environ.get("PYTHONPATH")) if p), **(env_extra or {})}
    logs = [tempfile.TemporaryFile() for _ in argvs]
    procs = []
    try:
        for argv, log in zip(argvs, logs):
            procs.append(subprocess.Popen([sys.executable, *argv], stdout=log,
                                          stderr=subprocess.STDOUT, env=env, cwd=cwd))
        t_end = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < t_end:
            if any(p.poll() not in (None, 0) for p in procs):
                t_end = min(t_end, time.monotonic() + grace)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode, log.read().decode(errors="replace")))
        log.close()
    return out


def run_workers(nproc, mode, worker_args, env_extra=None, timeout=120.0):
    """``nproc`` workers of this file in ``mode`` ("index" or "combine"), one
    per rank, joined on a free port; ``worker_args`` follow ``<pid> <nproc>
    <port>`` (values are str()-ed)."""
    port = free_port()
    argvs = [[WORKER, mode, str(pid), str(nproc), str(port), *map(str, worker_args)]
             for pid in range(nproc)]
    return run_processes(argvs, env_extra=env_extra, timeout=timeout)


# ---- the worker ---------------------------------------------------------------

def _worker_index(pid, nproc, port, fasta, k, cw=1 << 10, checkpoint_every=0,
                  abort_after_saves=0, fail_decode_pid=-1, device="cpu",
                  group_timeout_s=0.0, stall_finish_s=0.0):
    """One process of ``create_fasta_index_multihost`` over ``fasta`` (project
    ``fasta``, sample "mh"), on a local mesh of four CPU devices, or of the one
    named card. ``abort_after_saves`` > 0 exits hard (code 3) right after the
    process's Nth checkpoint; ``fail_decode_pid`` makes that process's
    byte-range decode raise. ``group_timeout_s`` > 0 joins the job first with
    that peer timeout; ``stall_finish_s`` > 0 holds process 0 that long
    before its re-read of the written plane. A checkpoint found at the start
    is reported. Exit code 7 on an error."""
    import traceback

    from pykmer_tpu_torch.config import IndexConfig
    from pykmer_tpu_torch.index import create_fasta_index_multihost
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.parallel import multihost as mh

    real_load = mh.load_shard_checkpoint

    def load_and_say(key):
        found = real_load(key)
        if found is not None:
            print(f"worker {pid}: checkpoint found, next step {found[1]['next_step']}",
                  flush=True)
        return found

    mh.load_shard_checkpoint = load_and_say
    if abort_after_saves:
        real_save, saves = mh.save_shard_checkpoint, []

        def save_then_die(*args, **kwargs):
            real_save(*args, **kwargs)
            saves.append(kwargs["next_step"])
            if len(saves) >= abort_after_saves:
                print(f"worker {pid}: simulated crash after checkpoint", flush=True)
                os._exit(3)

        mh.save_shard_checkpoint = save_then_die
    if fail_decode_pid == pid:
        # the multi-host path calls host.decode.decode_joined_bytes through
        # its module at call time
        from pykmer_tpu_torch.host import decode

        def bad_decode(*args, **kwargs):
            raise ValueError("injected decode failure")

        decode.decode_joined_bytes = bad_decode
    if group_timeout_s:
        mh.initialize_distributed(f"127.0.0.1:{port}", nproc, pid, timeout_s=group_timeout_s)
    if stall_finish_s and pid == 0:
        from pykmer_tpu_torch.index import multihost as index_mh

        real_hash = index_mh._hash_and_counts

        def stall_then_hash(path):
            time.sleep(stall_finish_s)
            return real_hash(path)

        index_mh._hash_and_counts = stall_then_hash
    local = [device] * 4 if device == "cpu" else [device]
    try:
        header = create_fasta_index_multihost(
            fasta, "mh", fasta, k, config=IndexConfig(kmer_len=k, chunk_windows=cw),
            coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid,
            checkpoint_every=checkpoint_every or None, verbose=False, device=device,
            local_devices=local)
    except Exception as exc:
        traceback.print_exc()
        print(f"worker {pid}: error {type(exc).__name__}: {exc}", flush=True)
        sys.exit(7)
    finally:
        if group_timeout_s:
            mh.shutdown_distributed()
    print(f"worker {pid}: ok header={'yes' if header is not None else 'no'} "
          f"launches={sweep.LAUNCHES}", flush=True)


def seeded_partial(k, pid):
    """Process ``pid``'s partial folded plane of the combine tests: random
    counts, a band near saturation so that sums cross 255."""
    rng = np.random.default_rng(1000 + pid)
    part = rng.integers(0, 120, size=4**k // 2).astype(np.uint8)
    part[: 4**k // 16] = rng.integers(100, 256, size=4**k // 16)
    return part


def _worker_combine(pid, nproc, port, impl, k, slab_cells):
    """``combine_partials_sharded`` of ``impl`` ("torch": the port over
    gloo; "jax": the JAX package in a jax.distributed job of four CPU
    devices a process) on :func:`seeded_partial`; prints its pieces as one
    JSON line ``[[offset, hex], ...]``."""
    part = seeded_partial(k, pid)
    if impl == "jax":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                                   num_processes=nproc, process_id=pid)
        from pykmer_tpu.parallel.multihost import combine_partials_sharded
    else:
        from pykmer_tpu_torch.parallel.multihost import (
            combine_partials_sharded, initialize_distributed)

        initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
    pieces = combine_partials_sharded(part, slab_cells=slab_cells)
    print(json.dumps([[int(off), np.asarray(p).tobytes().hex()] for off, p in pieces]),
          flush=True)
    if impl == "torch":
        from pykmer_tpu_torch.parallel.multihost import shutdown_distributed

        shutdown_distributed()


def _worker_main(argv):
    mode, rest = argv[0], argv[1:]
    pid, nproc, port = int(rest[0]), int(rest[1]), rest[2]
    if mode == "index":
        ints = [int(x) for x in rest[4:9]]
        device = rest[9] if len(rest) > 9 else "cpu"
        waits = dict(zip(("group_timeout_s", "stall_finish_s"), map(float, rest[10:12])))
        _worker_index(pid, nproc, port, rest[3], *ints, device=device, **waits)
    elif mode == "combine":
        _worker_combine(pid, nproc, port, rest[3], int(rest[4]), int(rest[5]))
    else:
        raise SystemExit(f"unknown worker mode {mode!r}")


# ---- the copied numpy helpers ---------------------------------------------------

def test_host_slice_covers_everything():
    from pykmer_tpu.parallel.multihost import host_slice as jax_slice
    from pykmer_tpu_torch.parallel.multihost import host_slice

    for total in (0, 1, 7, 100, 512):
        for n in (1, 2, 3, 8):
            spans = [host_slice(total, p, n) for p in range(n)]
            assert spans == [jax_slice(total, p, n) for p in range(n)]
            covered = [i for a, b in spans for i in range(a, b)]
            assert covered == list(range(total))


def test_combine_partial_dense_exact(rng):
    """Per-host clipped partials merge to min(total, 255), as the JAX
    function's: bit-exact."""
    from pykmer_tpu.oracle import oracle_count_stream
    from pykmer_tpu.parallel.multihost import combine_partial_dense as jax_dense
    from pykmer_tpu_torch.parallel.multihost import combine_partial_dense

    kmer_len = 3
    codes = rng.integers(0, 64, size=3000).astype(np.int64)
    codes = np.concatenate([codes, np.zeros(400, np.int64), np.full(300, 7, np.int64)])
    want = oracle_count_stream([codes], kmer_len)
    parts = [oracle_count_stream([codes[lo:hi]], kmer_len)
             for lo, hi in ((0, 1000), (1000, 2500), (2500, codes.shape[0]))]
    got = combine_partial_dense(parts)
    assert np.array_equal(got, want) and np.array_equal(got, jax_dense(parts))
    assert got.max() == 255


def test_host_byte_slice_record_aligned(tmp_path, rng):
    """Byte ranges cover the file exactly, cut only at record starts, agree
    between neighbours and with the JAX function's."""
    from conftest import make_random_fasta
    from pykmer_tpu.parallel.multihost import host_byte_slice as jax_bs
    from pykmer_tpu_torch.parallel.multihost import host_byte_slice

    fa = make_random_fasta(str(tmp_path / "bs.fa"), rng, n_records=9,
                           lengths=(500, 120, 900, 77, 333, 640, 50, 211, 404))
    size = os.path.getsize(fa)
    with open(fa, "rb") as fh:
        data = fh.read()
    for nproc in (1, 2, 3, 5):
        spans = [host_byte_slice(fa, p, nproc) for p in range(nproc)]
        assert spans == [jax_bs(fa, p, nproc) for p in range(nproc)]
        assert spans[0][0] == 0 and spans[-1][1] == size
        for (_, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 == b0
        for lo, _ in spans:
            if lo not in (0, size):
                assert data[lo:lo + 1] == b">" and data[lo - 1:lo] == b"\n"


def test_host_byte_slice_bgzf_matches_plain(tmp_path, rng):
    """Slicing a `.bgz` in uncompressed space agrees with slicing the plain
    file, and with the JAX function on the JAX package's reader."""
    from conftest import make_random_fasta
    from pykmer_tpu.io.bgzf import BgzfRangeReader as JaxReader
    from pykmer_tpu.parallel.multihost import host_byte_slice_bgzf as jax_bgzf
    from pykmer_tpu_torch.io.bgzf import BgzfRangeReader, compress_file
    from pykmer_tpu_torch.parallel.multihost import host_byte_slice, host_byte_slice_bgzf

    fa = make_random_fasta(str(tmp_path / "bz.fa"), rng, n_records=6,
                           lengths=(800, 150, 600, 90, 400, 220))
    bgz, _ = compress_file(fa)
    r, jr = BgzfRangeReader(bgz), JaxReader(bgz)
    for nproc in (2, 3, 4):
        for pid in range(nproc):
            got = host_byte_slice_bgzf(r, pid, nproc)
            assert got == host_byte_slice(fa, pid, nproc) == jax_bgzf(jr, pid, nproc)
    r.close()
    jr.close()


def test_unfold_piece_matches_unfold_canonical(rng, monkeypatch):
    """Three uneven pieces, unfolded apart (native, then the numpy path),
    assemble the full plane of ``unfold_canonical``; the JAX function's
    regions are the same."""
    from pykmer_tpu.ops.readback import unfold_piece as jax_piece
    from pykmer_tpu_torch.io import native
    from pykmer_tpu_torch.ops.readback import unfold_canonical, unfold_piece

    k = 5
    fold = 4**k // 2
    folded = rng.integers(0, 256, size=fold).astype(np.uint8)
    want = unfold_canonical(folded.copy(), k)
    for numpy_path in (False, True):
        if numpy_path:
            monkeypatch.setattr(native, "_HAVE_PIECE_UNFOLD", False)
        got = np.zeros(4**k, dtype=np.uint8)
        for g0, g1 in ((0, 100), (100, 417), (417, fold)):
            primary, mirror, m_off = unfold_piece(folded[g0:g1], k, g0)
            jp, jm, jo = jax_piece(folded[g0:g1], k, g0)
            assert m_off == jo and np.array_equal(primary, jp) and np.array_equal(mirror, jm)
            got[g0:g1] = primary
            got[m_off : m_off + mirror.shape[0]] = mirror
        assert np.array_equal(got, want)


@pytest.mark.parametrize("hosts", [1, 2, 3, 257])
def test_saturating_sum_is_the_dense_merge(monkeypatch, hosts):
    """The owner's sum of H received pieces (blockwise on threads, blocks
    that do not divide the piece) is ``combine_partial_dense`` of the pieces,
    the JAX function, up to 257 hosts of all-255 cells."""
    from pykmer_tpu.parallel.multihost import combine_partial_dense as jax_dense
    from pykmer_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "SUM_BLOCK", 1000)
    rng = np.random.default_rng(hosts)
    rows = rng.integers(0, 256, size=(hosts, 4099)).astype(np.uint8)
    rows[:, :50] = 255
    rows[:, 50:60] = 0
    got = multihost.saturating_sum(rows)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jax_dense(list(rows)))
    assert (got[:50] == 255).all() and (got[50:60] == 0).all()


def test_single_process_helpers():
    """Without a process group: rank 0 of 1, the barrier and the allgather
    return at once, and the combine is the plane itself."""
    from pykmer_tpu_torch.parallel import multihost

    assert multihost.initialize_distributed() is False
    assert multihost.initialize_distributed(None, 1, 0) is False
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    multihost.barrier("single")
    assert multihost.allgather_small_json({"a": 1}) == [{"a": 1}]
    plane = np.arange(4096, dtype=np.uint8)
    [(off, got)] = multihost.combine_partials_sharded(plane)
    assert off == 0 and np.array_equal(got, plane)
    assert multihost.timed_group(1.0) is None
    multihost.leave_group(None)
    with pytest.raises(ValueError, match="needs coordinator_address"):
        multihost.initialize_distributed(None, 2, 0)


def test_serial_timeout_scales_with_the_bytes():
    """The wait for process 0's serial work is the peer timeout plus the
    bytes at the assumed rate: at K=17 (a 16 GiB plane that process 0
    re-read in 31-34 s on the card machine) ten times that re-read or more."""
    from pykmer_tpu_torch.parallel import multihost

    assert multihost.serial_timeout_s(0) == multihost.DEFAULT_TIMEOUT_S
    assert multihost.serial_timeout_s(4**17) >= multihost.DEFAULT_TIMEOUT_S + 10 * 34
    assert multihost.serial_timeout_s(4**19) > multihost.serial_timeout_s(4**17)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_plane_to_host_is_the_interleave(n_shards):
    """The partial's readback: one flat plane, or S local planes read as
    their interleave (folded cell w is ``shards[w % S][w // S]``), in slices
    that do not divide the plane, into a new host array."""
    import torch

    from pykmer_tpu_torch.ops.readback import plane_to_host

    rng = np.random.default_rng(n_shards)
    flat = rng.integers(0, 256, size=4096).astype(np.uint8)
    shards = [torch.from_numpy(flat[s::n_shards].copy()) for s in range(n_shards)]
    got = plane_to_host(shards[0] if n_shards == 1 else shards, slice_cells=1000)
    assert got.dtype == np.uint8 and np.array_equal(got, flat)
    assert not np.shares_memory(got, shards[0].numpy())


# ---- the combine in gloo jobs -----------------------------------------------------

def _pieces(out):
    return [(off, np.frombuffer(bytes.fromhex(h), np.uint8))
            for off, h in json.loads(out.strip().splitlines()[-1])]


def _assert_tiles(pieces_by_rank, k, nproc):
    """The ranks' pieces are disjoint, cover the folded plane, and hold the
    saturating merge of every rank's partial."""
    from pykmer_tpu_torch.parallel.multihost import combine_partial_dense

    want = combine_partial_dense([seeded_partial(k, p) for p in range(nproc)])
    got = np.zeros_like(want)
    seen = np.zeros(want.shape[0], dtype=np.int64)
    for pieces in pieces_by_rank:
        for off, piece in pieces:
            got[off : off + piece.shape[0]] = piece
            seen[off : off + piece.shape[0]] += 1
    assert (seen == 1).all()
    assert np.array_equal(got, want) and want.max() == 255


@pytest.mark.parametrize("slab_cells", [1 << 30, 128])
def test_combine_pieces_equal_jax(slab_cells):
    """Two ranks, K=5 (512 folded cells): one slab, or four slabs of 128
    cells. The gloo combine's offsets and pieces are the JAX function's in
    a two-process jax.distributed job (four CPU devices a process)."""
    k = 5
    by_impl = {}
    for impl in ("torch", "jax"):
        env = {"JAX_PLATFORMS": ""} if impl == "jax" else None
        results = run_workers(2, "combine", [impl, k, slab_cells], env_extra=env)
        for rc, out in results:
            assert rc == 0, out
        by_impl[impl] = [_pieces(out) for _, out in results]
    for got, want in zip(by_impl["torch"], by_impl["jax"]):
        assert [o for o, _ in got] == [o for o, _ in want]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert len(by_impl["torch"][0]) == (1 if slab_cells > 512 else 4)
    _assert_tiles(by_impl["torch"], k, 2)


def test_combine_ragged_three_ranks():
    """Three ranks at K=5: 512 cells do not divide by 3, and the ragged
    split (171, 171, 170) still tiles the plane exactly; with slabs of 100
    cells the last slab (12 cells) is ragged too."""
    k = 5
    for slab_cells, offsets in ((1 << 30, [[0], [171], [342]]),
                                (100, [[0, 100, 200, 300, 400, 500],
                                       [34, 134, 234, 334, 434, 504],
                                       [68, 168, 268, 368, 468, 508]])):
        results = run_workers(3, "combine", ["torch", k, slab_cells])
        for rc, out in results:
            assert rc == 0, out
        pieces = [_pieces(out) for _, out in results]
        assert [[o for o, _ in p] for p in pieces] == offsets
        _assert_tiles(pieces, k, 3)


# ---- the CLI ------------------------------------------------------------------------

def test_cli_two_process_job_matches_jax_cli(tmp_path, monkeypatch):
    """``index --coordinator --num-processes 2 --process-id i`` in two
    processes on the CPU: process 0 writes the JAX CLI's single-process
    `.kin` and `.kin.json` (volatile times aside), process 1 exits 0
    without output."""
    from conftest import make_random_fasta
    from pykmer_tpu import cli as jcli
    from reference_runner import VOLATILE_KIN_JSON_KEYS

    monkeypatch.chdir(tmp_path)
    fa = make_random_fasta("cl.fa", np.random.default_rng(70), n_records=4,
                           lengths=(900, 300, 1200, 80))
    assert jcli.main(["index", fa, "s", "5", "--quiet", "--chunk-windows", "256"]) == 0
    want = {f: open(f, "rb").read() for f in ("cl.fa.05.kin", "cl.fa.05.kin.json")}
    for f in want:
        os.remove(f)
    port = free_port()
    argvs = [["-m", "pykmer_tpu_torch", "index", fa, "s", "5", "--device", "cpu",
              "--chunk-windows", "256", "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", "2", "--process-id", str(pid)] for pid in range(2)]
    results = run_processes(argvs, cwd=str(tmp_path))
    for rc, out in results:
        assert rc == 0, out
    assert "done" in results[0][1] and "done" not in results[1][1]
    assert open("cl.fa.05.kin", "rb").read() == want["cl.fa.05.kin"]
    got = json.load(open("cl.fa.05.kin.json"))
    ref = json.loads(want["cl.fa.05.kin.json"])
    assert set(got) == set(ref)
    for key in set(ref) - VOLATILE_KIN_JSON_KEYS:
        assert got[key] == ref[key], key
    assert sorted(os.listdir(".")) == ["cl.fa", "cl.fa.05.kin", "cl.fa.05.kin.json"]


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
