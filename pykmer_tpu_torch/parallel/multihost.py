"""Multi-host glue of the port on ``torch.distributed``: counterpart of
``pykmer_tpu/parallel/multihost.py``.

The processes of one job join a gloo process group whose address, size and
rank are passed explicitly (:func:`initialize_distributed`). Each process
feeds its own record-aligned slice of the input and accumulates a partial
folded plane on its local devices; the saturating-histogram semantics make
the cross-host merge exact:

    min(sum_h min(c_h, 255), 255) == min(sum_h c_h, 255)

:func:`combine_partials_sharded` merges the partials slab by slab: each
process sends every other process the cells that process owns as uint8
(one ragged ``all_to_all_single``), and the owner sums the H pieces it
receives in uint16 and clips at 255 (exact for <= 257 hosts). Gloo refuses
16-bit integer collectives and a uint8 ``all_reduce`` wraps modulo 256, so
the JAX package's uint16 psum has no direct counterpart; the exchange also
puts half the bytes of a uint16 reduce-scatter on the wire. The combine runs
on host tensors, as the JAX package's does on the partial it reads back.

Copies, each held against its original by ``tests/test_torch_copies.py``:
:func:`host_slice`, :func:`_record_boundary`, :func:`host_byte_slice`,
:func:`host_byte_slice_bgzf`, :func:`combine_partial_dense`, and the shard
checkpoints, whose on-disk format is the JAX package's, so a checkpoint
written by either package resumes in the other: the ``[S, local]`` dense
shards in a step-tagged ``dense.<step>.npy`` and ``state.json`` as the single
commit point, with the stream cursor, ``num_kmers`` and the exchange-bucket
high-water mark ``max_bucket``.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import StageTimer

# seconds a collective waits for a peer before the job fails
DEFAULT_TIMEOUT_S = 600.0
# the slowest rate, in bytes/s, assumed for process 0's serial work that the
# other processes wait for (inflating a staged `.gz`, hashing the input,
# re-reading the written `.kin`): a tenth of the 0.5 GB/s that the K=17
# re-read reached on the card machine's local disk (PERF.md, phase 11c), for
# a shared filesystem
SERIAL_BYTES_PER_S = 50e6


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the job's gloo process group at ``tcp://{coordinator_address}``
    (``host:port``; process 0 serves it) as rank ``process_id`` of
    ``num_processes``. Returns True when this call created the group.

    A no-op for a single-process run (``num_processes`` None or 1 and no
    coordinator) and when the group already exists. A collective that waits
    longer than ``timeout_s`` for a peer fails the job instead of hanging it.
    """
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if dist.is_initialized():
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-host job needs coordinator_address, num_processes "
                         f"and process_id; got {coordinator_address!r}, "
                         f"{num_processes!r}, {process_id!r}")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def serial_timeout_s(nbytes: int) -> float:
    """How long the other processes wait for process 0 to get through
    ``nbytes`` of serial reads and writes: the peer timeout plus those bytes
    at ``SERIAL_BYTES_PER_S``."""
    return DEFAULT_TIMEOUT_S + nbytes / SERIAL_BYTES_PER_S


def timed_group(timeout_s: float):
    """A gloo group of every process of the job whose collectives wait up to
    ``timeout_s`` for a peer (None in a single-process run). Every process
    creates it at the same point of the program, before the wait it is for:
    creating it waits on the job's own timeout."""
    if process_count() == 1:
        return None
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))


def leave_group(group) -> None:
    """Destroy a group of :func:`timed_group`, if there is one."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group(group)


def process_index() -> int:
    """This process's rank in the job (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The job's process count (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(tag: str, group=None) -> None:
    """Wait until every process of the job reaches the point named ``tag``
    (nothing to wait for in a single-process run), on ``group`` (a
    :func:`timed_group`) or the job's own; a failure or a timeout names the
    point."""
    if process_count() > 1:
        try:
            dist.barrier(group=group)
        except RuntimeError as exc:
            raise RuntimeError(f"barrier {tag!r} of process {process_index()}: {exc}") from exc


def host_slice(total: int, process_id: int, num_processes: int) -> Tuple[int, int]:
    """Contiguous [start, end) slice of ``total`` work items for this host.

    Copy of ``pykmer_tpu/parallel/multihost.py::host_slice``."""
    per = (total + num_processes - 1) // num_processes
    start = min(process_id * per, total)
    return start, min(start + per, total)


def _record_boundary(read_at, total: int, target: int) -> int:
    """First record start (a ``>`` preceded by ``\\n``) at or after
    ``target`` in a ``total``-byte source accessed via ``read_at(off, n)``.
    Deterministic given the content, so every host computes every boundary
    identically.

    Copy of ``pykmer_tpu/parallel/multihost.py::_record_boundary``."""
    if target <= 0:
        return 0
    if target >= total:
        return total
    win = 8 << 20
    pos = target - 1  # a '>' AT target needs its preceding newline
    while pos < total - 1:
        buf = read_at(pos, min(win, total - pos))
        hits = np.flatnonzero(buf[1:] == ord(">"))
        for h in hits:
            if buf[h] == ord("\n"):
                return pos + int(h) + 1
        if pos + buf.shape[0] >= total:
            break
        pos += buf.shape[0] - 1
    return total


def host_byte_slice(
    path: str, process_id: int, num_processes: int
) -> Tuple[int, int]:
    """Record-aligned byte range [lo, hi) of a plain FASTA for this host.

    Boundaries are the first record start (``>`` at a line start) at or
    after ``size * pid / nproc``; every host computes every boundary with the
    same deterministic scan, so adjacent hosts agree. Records never span
    ranges and windows never span records, so decoding just this range
    yields exactly this host's share of the global window set.

    Copy of ``pykmer_tpu/parallel/multihost.py::host_byte_slice``."""
    size = os.path.getsize(path)
    if num_processes <= 1:
        return 0, size
    with open(path, "rb") as fh:

        def read_at(off: int, n: int) -> np.ndarray:
            fh.seek(off)
            return np.frombuffer(fh.read(n), np.uint8)

        per = size / num_processes
        lo = _record_boundary(read_at, size, int(per * process_id))
        hi = _record_boundary(read_at, size, int(per * (process_id + 1)))
    return lo, hi


def host_byte_slice_bgzf(
    reader, process_id: int, num_processes: int
) -> Tuple[int, int]:
    """Record-aligned UNCOMPRESSED byte range of a BGZF FASTA.

    ``reader`` is an ``io.bgzf.BgzfRangeReader``: its block index gives random
    access into the uncompressed stream, so each host inflates only the
    blocks of its slice plus the boundary-scan windows.

    Copy of ``pykmer_tpu/parallel/multihost.py::host_byte_slice_bgzf``."""
    total = reader.index.uncompressed_size
    if num_processes <= 1:
        return 0, total

    def read_at(off: int, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint8)
        got = reader.read_into(out, off)
        return out[:got]

    per = total / num_processes
    lo = _record_boundary(read_at, total, int(per * process_id))
    hi = _record_boundary(read_at, total, int(per * (process_id + 1)))
    return lo, hi


def allgather_small_json(obj, group=None) -> list:
    """All-gather one small JSON-serialisable object per process, on
    ``group`` (a :func:`timed_group`) or the job's own; returns the
    per-process list in pid order. Also a barrier."""
    nproc = process_count()
    if nproc == 1:
        return [obj]
    out = [None] * nproc
    # the JSON text (not the object) travels, as in the JAX package: every
    # process sees lists where a tuple was sent
    dist.all_gather_object(out, json.dumps(obj), group=group)
    return [json.loads(s) for s in out]


def combine_partials_sharded(
    partial: np.ndarray,
    slab_cells: int = 1 << 30,
    stages: Optional[StageTimer] = None,
) -> List[Tuple[int, np.ndarray]]:
    """Saturating cross-host merge of the per-host partial folded planes,
    returning only THIS host's owner pieces as ``(global_offset, cells)``.

    Per slab of ``slab_cells`` cells (``cur`` cells in the last), host h owns
    ``host_slice(cur, h, H)``: every process sends each owner its range of
    the slab as uint8 in one ragged ``all_to_all_single``, and the owner sums
    the H pieces it receives in uint16 and clips at 255. The pieces are
    disjoint, tile the plane across hosts, and no host holds the whole
    combined plane. Where ``cur`` divides by H the pieces are the JAX
    package's; where it does not (a tiny plane) the ragged split still tiles
    it. ``stages`` receives the time of the exchanges ("combine exchange")
    and of the sums ("combine add")."""
    nproc = process_count()
    fold_size = partial.shape[0]
    if nproc == 1:
        return [(0, partial)]
    assert nproc <= 257, "uint16 saturating combine is exact for <= 257 hosts"
    assert partial.dtype == np.uint8 and partial.flags.c_contiguous
    pid = process_index()
    slab = min(slab_cells, fold_size)
    t_exchange = t_add = 0.0
    pieces: List[Tuple[int, np.ndarray]] = []
    for s0 in range(0, fold_size, slab):
        cur = min(s0 + slab, fold_size) - s0
        sizes = [b - a for a, b in (host_slice(cur, h, nproc) for h in range(nproc))]
        lo, hi = host_slice(cur, pid, nproc)
        t0 = time.perf_counter()
        recv = torch.empty(nproc * (hi - lo), dtype=torch.uint8)
        dist.all_to_all_single(recv, torch.from_numpy(partial[s0 : s0 + cur]),
                               output_split_sizes=[hi - lo] * nproc,
                               input_split_sizes=sizes)
        t1 = time.perf_counter()
        if hi > lo:
            pieces.append((s0 + lo, saturating_sum(recv.numpy().reshape(nproc, hi - lo))))
        del recv
        t_exchange += t1 - t0
        t_add += time.perf_counter() - t1
    if stages is not None:
        stages.add("combine exchange", t_exchange)
        stages.add("combine add", t_add)
    return pieces


SUM_BLOCK = 1 << 22  # cells a thread of saturating_sum adds at a time
SUM_THREADS = 8


def saturating_sum(rows: np.ndarray) -> np.ndarray:
    """``min(rows.sum(axis=0), 255)`` of a uint8 ``[H, n]`` array (H <= 257),
    as uint8: summed in uint16 block by block on ``SUM_THREADS`` threads
    (numpy's ufuncs release the GIL; one reduction over axis 0 with the
    dtype cast runs on one core at a fraction of the memory rate)."""
    h, n = rows.shape
    assert h <= 257 and rows.dtype == np.uint8
    out = np.empty(n, dtype=np.uint8)

    def block(lo: int) -> None:
        hi = min(lo + SUM_BLOCK, n)
        acc = rows[0, lo:hi].astype(np.uint16)
        for r in range(1, h):
            np.add(acc, rows[r, lo:hi], out=acc)
        np.minimum(acc, 255, out=acc)
        out[lo:hi] = acc

    with ThreadPoolExecutor(SUM_THREADS) as pool:
        list(pool.map(block, range(0, n, SUM_BLOCK)))
    return out


def combine_partial_dense(parts: List[np.ndarray]) -> np.ndarray:
    """Saturating elementwise merge of per-host partial dense arrays.

    Exact because saturating adds of clipped partial counts compose to
    min(total, 255) (see module docstring); u16 intermediate is safe for up
    to 257 partials.

    Copy of ``pykmer_tpu/parallel/multihost.py::combine_partial_dense``."""
    assert len(parts) <= 257
    acc = np.zeros_like(parts[0], dtype=np.uint16)
    for p in parts:
        assert p.dtype == np.uint8
        acc += p
    return np.minimum(acc, 255).astype(np.uint8)


# ---- shard checkpoints ------------------------------------------------------

def checkpoint_dir(index_tmp_file: str) -> str:
    return index_tmp_file + ".ckpt"


def save_shard_checkpoint(
    index_tmp_file: str,
    dense_shards: np.ndarray,
    next_step: int,
    num_kmers: int,
    meta: Optional[dict] = None,
    max_bucket: int = 0,
) -> None:
    """Atomically persist sharded progress.

    The dense plane lands in a STEP-TAGGED file (``dense.<step>.npy``) and
    the committed ``state.json`` names it: the state rename is the single
    commit point, so a crash anywhere in this function leaves the previous
    (state, dense) pair fully consistent. Superseded dense files are pruned
    after the commit.

    ``max_bucket`` — the running exchange-bucket high-water mark — rides
    along so the post-run overflow check still sees pre-checkpoint overflow
    after a resume (dropped k-mers would otherwise pass verification
    silently).
    """
    d = checkpoint_dir(index_tmp_file)
    os.makedirs(d, exist_ok=True)
    data_name = f"dense.{next_step}.npy"
    data_path = os.path.join(d, data_name)
    with open(data_path + ".tmp", "wb") as fh:
        np.save(fh, dense_shards, allow_pickle=False)
    os.rename(data_path + ".tmp", data_path)
    state = {"next_step": next_step, "num_kmers": num_kmers,
             "dense_file": data_name, "max_bucket": int(max_bucket)}
    state.update(meta or {})
    state_path = os.path.join(d, "state.json")
    with open(state_path + ".tmp", "wt") as fh:
        json.dump(state, fh, indent=1, sort_keys=True)
    os.rename(state_path + ".tmp", state_path)
    for name in os.listdir(d):
        if name.startswith("dense.") and name.endswith(".npy") \
                and name != data_name:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


def load_shard_checkpoint(
    index_tmp_file: str,
) -> Optional[Tuple[np.ndarray, dict]]:
    d = checkpoint_dir(index_tmp_file)
    state_path = os.path.join(d, "state.json")
    if not os.path.exists(state_path):
        return None
    with open(state_path) as fh:
        state = json.load(fh)
    # legacy (pre-step-tag) checkpoints named the plane dense.npy
    data_path = os.path.join(d, state.get("dense_file", "dense.npy"))
    if not os.path.exists(data_path):
        return None
    dense = np.load(data_path)
    return dense, state


def clear_shard_checkpoint(index_tmp_file: str) -> None:
    d = checkpoint_dir(index_tmp_file)
    if os.path.exists(d):
        shutil.rmtree(d)
