"""Multi-host indexing: FASTA → one `.kin` across a ``torch.distributed`` job.

Counterpart of ``pykmer_tpu/index/multihost.py``. The processes of one job
cooperate on ONE index build:

1. every process reads and decodes only its record-aligned byte range of the
   input (``parallel/multihost.host_byte_slice``; a `.bgz` splits in
   uncompressed space through its block index, a plain `.gz` is inflated
   once by process 0 to a staged sibling file that every process
   byte-range-reads). Where no byte split applies, every process decodes the
   whole stream and keeps its slice of the windows;
2. each process accumulates its slice into a full folded partial plane on
   its local devices through the sharded step (``parallel/histogram``:
   encode, exchange and the CUDA sweep once per received row), and
   checkpoints its own progress every ``checkpoint_every`` steps: the
   per-process loops are independent until the combine, so a resume needs
   no coordination;
3. the partial planes come back to the host and combine with the exact
   saturating merge ``min(sum_h min(c_h, 255), 255) == min(sum_h c_h, 255)``
   in bounded slabs, each process keeping only its owner pieces
   (``parallel/multihost.combine_partials_sharded``: a uint8 exchange over
   gloo, then a uint16 sum and clip);
4. every process unfolds its pieces (two contiguous regions each,
   ``ops/readback.unfold_piece``) and pwrites them into the shared tmp
   file; process 0 stamps the metadata (global stats through one all-reduce,
   the output checksum from one re-read), verifies and renames. The job
   needs the shared filesystem the merge already assumes.

The result is byte-identical to a single-host build whatever the process
count or slice boundaries: integer saturating adds compose exactly and the
record partition is exact (``tests/test_torch_multihost*.py`` hold 2- and
3-process jobs, crashes and resumes against the JAX package's single-process
build).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
import zlib
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed

from ..config import IndexConfig
from ..formats import kin as kinfmt
from ..formats.header import KinHeader, fast_counts256
from ..host import decode as _decode
from ..host.chunks import chunk_stream
from ..io.fasta import open_input_bytes
from ..ops import readback
from ..parallel import multihost
from ..parallel.histogram import make_sharded_accumulate, shard_batch_chunks_packed
from ..parallel.mesh import DATA_AXIS, SHARD_AXIS, make_mesh
from ..parallel.multihost import host_slice, initialize_distributed
from ..state import shards_from_numpy, shards_to_numpy
from ..utils.bigmem import big_empty
from ..utils.checksum import sha256_file
from ..utils.profiling import StageTimer
from .bgzip import write_bgzip
from .indexer import PRINT_EVERY, report_stages
from .sharded import SHARDED_CHUNK_WINDOWS


def _stage_inflated(gz_path: str, staged_path: str) -> None:
    """Inflate a plain-gzip input ONCE to a staged sibling file (tmp+rename:
    a concurrent reader never sees a partial file). Host 0 runs this so the
    other hosts of a multi-host job can byte-range-read the decompressed
    FASTA instead of each inflating the whole stream.

    Copy of ``pykmer_tpu/index/multihost.py::_stage_inflated``."""
    tmp = staged_path + ".part"
    data = None
    try:
        from ..io.native import gzip_decompress_native

        data = gzip_decompress_native(gz_path)
    except ImportError:
        pass
    if data is None:
        import gzip

        with gzip.open(gz_path, "rb") as fh:
            data = np.frombuffer(fh.read(), dtype=np.uint8)
    try:
        with open(tmp, "wb") as fh:
            fh.write(memoryview(data))
        os.replace(tmp, staged_path)
    except OSError:
        # e.g. ENOSPC mid-write: never leave a multi-GB partial behind
        # (the caller falls back to per-host decode and keeps running)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def create_fasta_index_multihost(
    project_name: str,
    sample_name: str,
    input_file: str,
    kmer_len: int,
    overwrite: bool = True,
    config: Optional[IndexConfig] = None,
    n_shards_local: Optional[int] = None,
    n_data_local: int = 1,
    capacity_factor: float = 2.0,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
    verify: bool = True,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
    local_devices: Optional[Sequence[Union[str, torch.device]]] = None,
    bgzip: bool = False,
) -> Optional[KinHeader]:
    """Build one `.kin` cooperatively across all processes of a
    ``torch.distributed`` job. Every process calls this with identical
    arguments but ``process_id``. Returns the header on process 0, ``None``
    elsewhere.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` join the job's gloo group unless it exists (nothing to
    join for one process without a coordinator); a group joined here is left
    on return, also on an error. The local accumulate runs
    on ``make_mesh(n_shards_local, n_data_local, devices=local_devices,
    device=device)``: by default every visible card, or ``[cpu]`` for
    ``device="cpu"``; processes may share a card (``local_devices=
    [cuda:0]``). With ``bgzip`` process 0 also writes the `.kin` as
    `.kin.bgz` + `.gzi` (``index/bgzip.write_bgzip``) after its rename. With
    ``PYKMER_TPU_STAGE_TIMING`` set each process prints its stage table on
    stderr."""
    if input_file is None or input_file == "-":
        raise ValueError("stdin input ('-') is not supported for multi-host jobs")
    joined = initialize_distributed(coordinator_address, num_processes, process_id)
    serial = None
    try:
        # the other processes wait for process 0 alone where it stages a
        # `.gz` (the input read, inflated to a few times its size) and where
        # it hashes the input, re-reads the written plane and, for
        # ``bgzip``, deflates it: those waits get a timeout that scales with
        # the bytes
        serial = multihost.timed_group(multihost.serial_timeout_s(
            4**kmer_len * (1 + bgzip) + 8 * os.path.getsize(input_file)))
        return _build(project_name, sample_name, input_file, kmer_len, overwrite, config,
                      n_shards_local, n_data_local, capacity_factor, checkpoint_every,
                      resume, verify, verbose, device, local_devices, serial, bgzip)
    finally:
        multihost.leave_group(serial)
        # a process that exits still in the group may abort in gloo's
        # teardown, which would hide its exit code
        if joined:
            multihost.shutdown_distributed()


def _build(project_name, sample_name, input_file, kmer_len, overwrite, config,
           n_shards_local, n_data_local, capacity_factor, checkpoint_every, resume,
           verify, verbose, device, local_devices, serial, bgzip) -> Optional[KinHeader]:
    """The body of :func:`create_fasta_index_multihost`, in the job;
    ``serial`` is the group of the waits for process 0's serial work."""
    pid = multihost.process_index()
    nproc = multihost.process_count()
    is_main = pid == 0

    config = config or IndexConfig(kmer_len=kmer_len)
    if config.chunk_windows is None:
        config = dataclasses.replace(config, chunk_windows=SHARDED_CHUNK_WINDOWS)
    if config.kmer_len != kmer_len:
        raise ValueError(f"config.kmer_len {config.kmer_len} != kmer_len {kmer_len}")
    local_mesh = make_mesh(n_shards=n_shards_local, n_data=n_data_local,
                           devices=local_devices, device=device)
    if local_mesh.first.type == "cuda":
        torch.cuda.reset_peak_memory_stats(local_mesh.first)
    stages = StageTimer()

    header = KinHeader(
        project_name,
        input_file=input_file,
        kmer_len=kmer_len,
        flush_every=config.flush_every,
        min_frag_size=config.min_frag_size,
        max_frag_size=config.max_frag_size,
    )
    data_size = header.data_size
    fold_size = data_size // 2
    tmp = header.index_tmp_file
    timer = header.timer

    ckpt_key = f"{tmp}.proc{pid:03d}"
    my_ckpt = multihost.load_shard_checkpoint(ckpt_key) if resume else None
    if is_main:
        if my_ckpt is None:
            kinfmt.remove_outputs(input_file, kmer_len, overwrite)
        if verbose:
            print(f"multihost index: {nproc} processes x {local_mesh.shape[DATA_AXIS]}x"
                  f"{local_mesh.shape[SHARD_AXIS]} local mesh on "
                  f"{local_mesh.first.type}, K={kmer_len}")

    # --- 1. per-host decode ------------------------------------------------
    # plain files: each host reads + decodes only its record-aligned byte
    # range. BGZF inputs (`.bgz`) split the same way in uncompressed space
    # through the block index. A plain `.gz` has no block structure: host 0
    # inflates it ONCE to a staged sibling file that every host
    # byte-range-reads like a plain input (the sharded writer already
    # assumes a shared filesystem). PYKMER_TPU_MULTIHOST_GZ_STAGE=0 turns
    # staging off (non-shared filesystem): every host then decodes the whole
    # stream.
    raw: dict = {}
    bgz_reader = None
    staged_gz: Optional[str] = None
    read_input = input_file
    plain_gz = input_file.endswith(".gz") and not input_file.endswith(".bgz")
    t_read = time.perf_counter()
    if nproc > 1 and plain_gz and \
            os.environ.get("PYKMER_TPU_MULTIHOST_GZ_STAGE", "1") != "0":
        # keyed on (K, project, sample): concurrent jobs over the same input
        # with other parameters must not share (and delete) each other's file
        job_tag = hashlib.sha256(f"{project_name}\x00{sample_name}".encode()).hexdigest()[:8]
        staged_gz = f"{input_file}.{kmer_len:02d}.{job_tag}.inflated.tmp"
        ok = True
        if is_main:
            try:
                _stage_inflated(input_file, staged_gz)
            except (OSError, EOFError, zlib.error) as exc:
                # a read-only directory, or a truncated / corrupt .gz: fall
                # back to the per-host decode, whose own error then surfaces
                # on every host alike instead of stranding the others below
                if verbose:
                    print(f"gz staging failed ({exc}); falling back to per-host decode")
                ok = False
        # the allgather doubles as the staging verdict's broadcast
        ok = all(g.get("staged_ok", True) for g in multihost.allgather_small_json(
            {"staged_ok": ok, "pid": pid}, group=serial))
        if ok:
            read_input = staged_gz
        else:
            staged_gz = None
    if nproc > 1 and input_file.endswith(".bgz"):
        import struct
        from concurrent.futures import ThreadPoolExecutor

        from ..io.bgzf import BgzfRangeReader

        inflate_pool = ThreadPoolExecutor(os.cpu_count() or 2)
        try:
            bgz_reader = BgzfRangeReader(input_file, pool=inflate_pool)
        except (IOError, OSError, struct.error):
            # not BGZF after all, or truncated: the stream fallback, and the
            # pool must not leak on this path
            bgz_reader = None
            inflate_pool.shutdown(wait=False)
    byte_split = nproc > 1 and (
        bgz_reader is not None
        or staged_gz is not None
        or not input_file.endswith((".gz", ".bgz"))
    )
    if byte_split:
        # A failure between staging and the post-read allgather rides that
        # allgather as a flag instead of raising at once: every host reaches
        # it (a raising host would strand the others there and leak the
        # staged file), host 0 unlinks the staged file only once every host
        # is done with it, and then every host raises the same error.
        decode_err = None
        try:
            if bgz_reader is not None:
                b_lo, b_hi = multihost.host_byte_slice_bgzf(bgz_reader, pid, nproc)
            else:
                b_lo, b_hi = multihost.host_byte_slice(read_input, pid, nproc)
            if b_hi > b_lo:
                if bgz_reader is not None:
                    data = np.empty(b_hi - b_lo, dtype=np.uint8)
                    got = bgz_reader.read_into(data, b_lo)
                    assert got == b_hi - b_lo
                else:
                    with open(read_input, "rb") as fh:
                        fh.seek(b_lo)
                        data = np.frombuffer(fh.read(b_hi - b_lo), dtype=np.uint8)
                local_stream, my_chroms, my_bp = _decode.decode_joined_bytes(
                    data, kmer_len, tail_headroom=config.chunk_windows + kmer_len)
                del data
            else:
                local_stream, my_chroms, my_bp = None, [], 0
        except Exception as exc:
            decode_err = f"{type(exc).__name__}: {exc}"
            local_stream, my_chroms, my_bp = None, [], 0
        except BaseException:
            # process-fatal (KeyboardInterrupt, SystemExit): the job is
            # dying, so skip the barrier protocol and clean up best-effort
            if staged_gz is not None and is_main:
                try:
                    os.unlink(staged_gz)
                except OSError:
                    pass
            raise
        finally:
            if bgz_reader is not None:
                bgz_reader.close()
                bgz_reader.pool.shutdown(wait=False)
        # the global record list and totals in pid order == file order; also
        # the done-reading barrier and the per-host error broadcast
        gathered = multihost.allgather_small_json(
            {"chroms": [[n, int(s)] for n, s in my_chroms], "bp": my_bp,
             "err": decode_err})
        if staged_gz is not None and is_main:
            try:
                os.unlink(staged_gz)
            except OSError:
                pass
        errs = [g["err"] for g in gathered if g.get("err")]
        if errs:
            raise RuntimeError(f"{input_file}: byte-range decode failed on "
                               f"{len(errs)}/{nproc} host(s): {errs[0]}")
        chromosomes = [(n, s) for g in gathered for n, s in g["chroms"]]
        total_bp = sum(g["bp"] for g in gathered)
        if not chromosomes:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
    else:
        data = open_input_bytes(input_file)
        if is_main and not input_file.endswith((".gz", ".bgz")):
            raw["bytes"] = data  # process 0 hashes the bytes in memory
        stream, chromosomes, total_bp = _decode.decode_joined_bytes(
            data, kmer_len, tail_headroom=config.chunk_windows + kmer_len)
        del data
        n_windows = max(int(stream.shape[0]) - kmer_len + 1, 0)
        if n_windows <= 0:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        w0, w1 = host_slice(n_windows, pid, nproc)
        if w1 > w0:
            if nproc > 1:
                # copy the slice into a pooled block and release the whole
                # stream: a view would pin the full decode on every host
                # through the accumulate
                span = (w1 - w0) + kmer_len - 1
                local_stream = big_empty(span)
                np.copyto(local_stream, stream[w0 : w0 + span])
            else:
                local_stream = stream[w0 : w1 + kmer_len - 1]
        else:
            local_stream = None
        del stream
    stages.add("byte-range read + decode", time.perf_counter() - t_read)

    # the input's sha256 on process 0, overlapping the accumulate
    input_ck: dict = {}
    ck_thread = None
    if is_main:

        def _hash_input() -> None:
            if "bytes" in raw:
                input_ck["hex"] = hashlib.sha256(raw.pop("bytes")).hexdigest()
            else:
                input_ck["hex"] = sha256_file(header.input_file_path)

        ck_thread = threading.Thread(target=_hash_input, daemon=True)
        ck_thread.start()

    # --- 2. local accumulate over this host's devices ----------------------
    # Per-host checkpoints: the loops are independent across hosts until the
    # combine, so each host saves, validates and resumes its OWN progress
    # (hosts may resume from different steps).
    init_fn, step_fn = make_sharded_accumulate(
        local_mesh, kmer_len, config.chunk_windows, capacity_factor=capacity_factor)
    state = None
    start_step = 0
    rows = step_fn.rows
    ck_meta = {
        "kmer_len": kmer_len,
        "chunk_windows": config.chunk_windows,
        "rows": rows,
        "input_size": os.path.getsize(input_file),
        "nproc": nproc,
        "pid": pid,
    }
    if my_ckpt is not None:
        shards_np, ck = my_ckpt
        if all(ck.get(key) == val for key, val in ck_meta.items()) \
                and shards_np.shape == (step_fn.n_shards, step_fn.local_size):
            start_step = int(ck["next_step"])
            state = (
                shards_from_numpy(shards_np, local_mesh),
                torch.tensor(int(ck["num_kmers"]), dtype=torch.int64, device=local_mesh.first),
                # the bucket high-water mark: overflow before the checkpoint
                # must still fail the post-run capacity check
                torch.tensor(int(ck.get("max_bucket", 0)), dtype=torch.int64,
                             device=local_mesh.first),
            )
            if verbose:
                print(f"  [{pid}] resuming from checkpoint step {start_step}")
        else:
            if verbose:
                print(f"  [{pid}] stale checkpoint ignored")
            multihost.clear_shard_checkpoint(ckpt_key)
            if is_main:
                # the entry's cleanup was skipped only because a checkpoint
                # existed; a stale one means this IS a fresh build
                kinfmt.remove_outputs(input_file, kmer_len, overwrite)
        del shards_np, my_ckpt
    if state is None:
        state = init_fn()
    with stages.stage("local accumulate"):
        if local_stream is not None and local_stream.shape[0] >= kmer_len:
            padded, n_chunks = chunk_stream(local_stream, kmer_len, config.chunk_windows)
            n_steps = (n_chunks + rows - 1) // rows
            for s in range(start_step, n_steps):
                chunks = shard_batch_chunks_packed(padded, kmer_len, config.chunk_windows,
                                                   rows, s)
                state = step_fn(state, chunks)
                if verbose and is_main and n_steps > 1:
                    print(f"  dispatched step {s + 1}/{n_steps}")
                if checkpoint_every and (s + 1) % checkpoint_every == 0 and s + 1 < n_steps:
                    multihost.save_shard_checkpoint(
                        ckpt_key, shards_to_numpy(state[0]), next_step=s + 1,
                        num_kmers=int(state[1]), meta=ck_meta, max_bucket=int(state[2]))
            del padded
        planes, nk_dev, maxb_dev = state
        local_kmers, max_bucket = int(nk_dev), int(maxb_dev)
    del local_stream, state
    if max_bucket > step_fn.capacity:
        raise RuntimeError(
            f"shard bucket overflow ({max_bucket} > {step_fn.capacity}): "
            f"re-run with a larger capacity_factor (got {capacity_factor}) "
            f"or smaller chunk_windows")
    with stages.stage("partial readback"):
        partial = readback.plane_to_host(planes[0])
    del planes

    # --- 3. cross-host saturating combine: each host keeps its owner pieces --
    pieces = multihost.combine_partials_sharded(partial, stages=stages)
    del partial
    counts = np.zeros(256, dtype=np.int64)
    for _, piece in pieces:
        counts += fast_counts256(piece)
    totals = np.concatenate([[local_kmers], counts]).astype(np.int64)
    if nproc > 1:
        summed = torch.from_numpy(totals)
        torch.distributed.all_reduce(summed)
        totals = summed.numpy()
    num_kmers = int(totals[0])
    counts = totals[1:].copy()
    counts[0] += fold_size  # each folded cell's mirror position is 0
    if num_kmers == 0:
        raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")

    # --- 4. sharded write; process 0 stamps the metadata --------------------
    with stages.stage("unfold + pwrite"):
        if is_main:
            # size the tmp file before anyone writes into it
            with open(tmp, "wb") as fh:
                fh.truncate(data_size)
        multihost.barrier("pykmer_tpu_torch.index.multihost.sized")
        if pieces:
            with open(tmp, "r+b") as fh:
                fd = fh.fileno()
                for g0, piece in pieces:
                    primary, mirror, m_off = readback.unfold_piece(piece, kmer_len, g0)
                    readback.pwrite_all(fd, primary, g0)
                    readback.pwrite_all(fd, mirror, m_off)
                os.fsync(fd)
        del pieces
        multihost.barrier("pykmer_tpu_torch.index.multihost.written")

    if is_main:
        if total_bp >= PRINT_EVERY:
            timer.update(total_bp)
        header.num_kmers = num_kmers
        header.chromosomes = chromosomes
        ck_thread.join()
        # one re-read of the written plane gives the provenance sha256 and
        # the independent stats recheck
        with stages.stage("hash + verify"):
            output_ck, file_counts = _hash_and_counts(tmp)
        with stages.stage("metadata"):
            header.write_metadata(tmp, stats_counts256=counts,
                                  input_checksum=input_ck.get("hex"),
                                  output_checksum=output_ck)
        if verify and not np.array_equal(file_counts, counts):
            raise AssertionError("written .kin does not match computed stats")
        os.rename(tmp, header.index_file_root)
        if bgzip:
            with stages.stage("bgzip"):
                write_bgzip(header.index_file_root, data_size, local_mesh.first)
        if verbose:
            print("done")
    multihost.barrier("pykmer_tpu_torch.index.multihost.done", group=serial)
    for p in range(nproc) if is_main else ():
        multihost.clear_shard_checkpoint(f"{tmp}.proc{p:03d}")
    report_stages(f"multihost, process {pid} of {nproc}, local mesh "
                  f"{local_mesh.shape[DATA_AXIS]}x{local_mesh.shape[SHARD_AXIS]}",
                  stages, local_mesh.first)
    return header if is_main else None


def _hash_and_counts(path: str):
    """One streaming read → (sha256 hex, 256-bin value counts).

    Copy of ``pykmer_tpu/index/multihost.py::_hash_and_counts``."""
    import hashlib

    from ..formats.header import fast_counts256

    h = hashlib.sha256()
    counts = np.zeros(256, dtype=np.int64)
    with open(path, "rb", buffering=0) as fh:
        while True:
            blk = fh.read(64 << 20)
            if not blk:
                break
            h.update(blk)
            counts += fast_counts256(np.frombuffer(blk, dtype=np.uint8))
    return h.hexdigest(), counts
