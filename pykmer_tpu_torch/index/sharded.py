"""The sharded index path: FASTA → `.kin` over a device mesh, resumably.

Counterpart of ``pykmer_tpu/index/sharded.py``. The folded count plane lives
interleaved across the mesh's ``shards`` axis, chunks stream data-parallel
over its ``data`` axis, and each step runs encode → exchange → the sweep
kernel (``parallel/histogram.py``). Progress checkpoints (the ``[S, local]``
shards plus the stream cursor, ``parallel/multihost.py``) make a long build
resumable, and a checkpoint of either package resumes in the other.

The input is decoded whole, as the JAX package's sharded path does. The
finish is the single-device path's (``index/indexer.write_kin``): the raw
tail reads the shards back through the chased readback (``ops/readback.py``)
as their interleave, so no device and no host buffer holds the whole flat
plane beyond the 4^K output, and the verify reads the file back beside the
output hash. The files are byte-identical to the single-device
path's: saturating integer adds are associative, so the mesh cannot change
the result.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import torch

from ..config import IndexConfig
from ..formats import kin as kinfmt
from ..formats.header import KinHeader
from ..utils.profiling import StageTimer

from ..host.chunks import chunk_stream
from ..host.decode import decode_joined_bytes
from ..parallel import multihost
from ..parallel.histogram import make_sharded_accumulate, shard_batch_chunks_packed
from ..parallel.mesh import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh
from ..state import shards_from_numpy, shards_to_numpy
from .indexer import PRINT_EVERY, read_input, report_stages, write_kin

# window starts per row of a sharded step: each step routes its chunks
# through an exchange whose buffers scale with it (the JAX package's value)
SHARDED_CHUNK_WINDOWS = 1 << 22


def create_fasta_index_sharded(
    project_name: str,
    sample_name: str,
    input_file: str,
    kmer_len: int,
    overwrite: bool = True,
    config: Optional[IndexConfig] = None,
    mesh: Optional[Mesh] = None,
    n_shards: Optional[int] = None,
    n_data: int = 1,
    capacity_factor: float = 2.0,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
    verify: bool = True,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
    bgzip: bool = False,
) -> KinHeader:
    """Build one `.kin` index over ``mesh`` (default: ``make_mesh(n_shards,
    n_data, device=device)``), resumably. Returns the written header. With
    ``bgzip`` the `.kin` is also written as `.kin.bgz` + `.gzi` (the finish's,
    ``index/indexer.write_kin``).

    With ``checkpoint_every`` N, the shards are saved after every Nth step
    but the last; a later run with ``resume`` continues from the last save
    when its kmer_len, chunk_windows, rows, input size and shard shape match,
    and ignores (and clears) it otherwise. Raises ``RuntimeError`` when an
    exchange bucket overflowed its capacity."""
    if input_file is None or input_file == "-":
        raise ValueError("stdin input ('-') is not supported by the sharded index")
    config = config or IndexConfig(kmer_len=kmer_len)
    if config.chunk_windows is None:
        config = dataclasses.replace(config, chunk_windows=SHARDED_CHUNK_WINDOWS)
    if config.kmer_len != kmer_len:
        raise ValueError(f"config.kmer_len {config.kmer_len} != kmer_len {kmer_len}")
    if mesh is None:
        mesh = make_mesh(n_shards=n_shards, n_data=n_data, device=device)
    cw = config.chunk_windows

    header = KinHeader(
        project_name,
        input_file=input_file,
        kmer_len=kmer_len,
        flush_every=config.flush_every,
        min_frag_size=config.min_frag_size,
        max_frag_size=config.max_frag_size,
    )
    tmp = header.index_tmp_file
    if mesh.first.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.first)

    ckpt = multihost.load_shard_checkpoint(tmp) if resume else None
    if ckpt is None:
        kinfmt.remove_outputs(input_file, kmer_len, overwrite)

    stages = StageTimer()
    with ThreadPoolExecutor(1) as hash_pool:
        data, input_ck = read_input(input_file, stages, hash_pool)
        with stages.stage("fasta decode + join"):
            stream, chromosomes, total_bp = decode_joined_bytes(
                data, kmer_len, tail_headroom=cw + kmer_len)
        init_fn, step_fn = make_sharded_accumulate(mesh, kmer_len, cw, capacity_factor)
        if stream.shape[0] < kmer_len:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        padded, n_chunks = chunk_stream(stream, kmer_len, cw)
        rows = step_fn.rows
        n_steps = (n_chunks + rows - 1) // rows
        meta = {
            "kmer_len": kmer_len,
            "chunk_windows": cw,
            "rows": rows,
            "input_size": os.path.getsize(input_file),
        }

        start_step, state = 0, None
        if ckpt is not None:
            shards_np, ck = ckpt
            if all(ck.get(key) == val for key, val in meta.items()) \
                    and shards_np.shape == (step_fn.n_shards, step_fn.local_size):
                start_step = int(ck["next_step"])
                state = (
                    shards_from_numpy(shards_np, mesh),
                    torch.tensor(int(ck["num_kmers"]), dtype=torch.int64, device=mesh.first),
                    # the bucket high-water mark, so pre-checkpoint overflow
                    # still fails the post-run capacity check
                    torch.tensor(int(ck.get("max_bucket", 0)), dtype=torch.int64,
                                 device=mesh.first),
                )
                if verbose:
                    print(f"  resuming from checkpoint at step {start_step}/{n_steps}")
            else:
                if verbose:
                    print("  stale checkpoint ignored")
                multihost.clear_shard_checkpoint(tmp)
                kinfmt.remove_outputs(input_file, kmer_len, overwrite)
            del shards_np
        if state is None:
            state = init_fn()

        with stages.stage("sharded accumulate"):
            # num_kmers and max_bucket stay on the device: read only at
            # checkpoints and at the end
            for s in range(start_step, n_steps):
                chunks = shard_batch_chunks_packed(padded, kmer_len, cw, rows, s)
                state = step_fn(state, chunks)
                if verbose and n_steps > 1:
                    print(f"  dispatched step {s + 1}/{n_steps}")
                if checkpoint_every and (s + 1) % checkpoint_every == 0 and s + 1 < n_steps:
                    multihost.save_shard_checkpoint(
                        tmp, shards_to_numpy(state[0]), next_step=s + 1,
                        num_kmers=int(state[1]), max_bucket=int(state[2]), meta=meta)
            planes, nk_dev, maxb_dev = state
            num_kmers, max_bucket = int(nk_dev), int(maxb_dev)
        del padded, stream, data
        if max_bucket > step_fn.capacity:
            raise RuntimeError(
                f"shard bucket overflow ({max_bucket} > {step_fn.capacity}): "
                f"re-run with a larger capacity_factor (got {capacity_factor}) "
                f"or smaller chunk_windows"
            )
        if num_kmers == 0:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        if verbose:
            print(f"  records {len(chromosomes):7,d} bp {total_bp:15,d}")
        if total_bp >= PRINT_EVERY:
            header.timer.update(total_bp)
        header.num_kmers = num_kmers
        header.chromosomes = chromosomes

        write_kin(header, planes[0], "raw", stages, verify, input_ck.result, bgzip)
    multihost.clear_shard_checkpoint(tmp)
    report_stages(f"sharded, mesh {mesh.shape[DATA_AXIS]}x{mesh.shape[SHARD_AXIS]}",
                  stages, mesh.first)
    if verbose:
        print("done")
    return header

