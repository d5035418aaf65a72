"""N×N merge: the shared-k-mer count matrix over a set of `.kin` indexes.

Port of ``pykmer_tpu/merge/merger.py``. Every sample's dense array is read
from disk once, in cell-space blocks, and reduced per block to a 1-bit
validity plane (count within ``[min_count, max_count]``). Two engines turn
the planes into the N×N matrix of shared valid cells, each sample's own
total on the diagonal:

- **host**: per pair an AND + popcount of the bit planes (native AVX2, or
  numpy without the native library): the JAX package's small-N engine,
  copied, since it never touched JAX;
- **device**: the bits of all N samples go to the device in one upload per
  block, and ``ops/compare.block_contingency`` adds the block's V·Vᵀ into an
  int64 accumulator that stays there (``torch._int_mm`` on CUDA). With
  ``n_shards`` S > 1 each block is cut into S contiguous cell slices, one per
  device of a mesh, and ``parallel/compare.make_sharded_merge_step`` sums
  the S partials into the accumulator on mesh device 0.

The reader threads pack into pinned staging buffers, and the upload is
non-blocking, so the next block is read while the card multiplies the
previous one. ``merge`` writes the `.kma` and `.kma.json` through
the port's copy of ``formats.kma``: the JAX package's files, byte for byte.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import MergeConfig
from ..formats import kin as kinfmt
from ..formats import kma as kmafmt
from ..formats.header import KinHeader

from .. import resolve_device
from ..ops.compare import block_contingency, new_workspace, padded_rows
from ..parallel.compare import make_sharded_merge_step
from ..parallel.mesh import SHARD_AXIS, Mesh, make_mesh

VALID_INPUT_EXTS = (".kin", ".kin.bgz", ".kma", ".kma.bgz")
STAGING_SLOTS = 2  # pinned host buffers the block uploads alternate between


def _validate_inputs(
    indexes: Sequence[str],
) -> Tuple[List[Dict[str, Any]], int]:
    data: List[Dict[str, Any]] = []
    kmer_len: Optional[int] = None
    for pos, kin in enumerate(indexes):
        kins = str(kin)
        if not kins.endswith(VALID_INPUT_EXTS):
            raise ValueError(f"all files must be .kin[.bgz]: {kin}")
        if not os.path.exists(kins):
            raise FileNotFoundError(f"all files must exist: {kin}")
        desc = kins[: -len(".bgz")] if kins.endswith(".bgz") else kins
        desc = f"{desc}.json"
        if not os.path.exists(desc):
            raise FileNotFoundError(
                f"all .kin[.bgz] files must have an associated .kin.json: {desc}"
            )
        header = KinHeader(kins, index_file=kins)
        if kmer_len is None:
            kmer_len = header.kmer_len
        if header.kmer_len != kmer_len:
            raise ValueError(
                f"kmer_length differs. expected {kmer_len}, got {header.kmer_len}"
            )
        data.append(
            {
                "pos": pos,
                "index_file": kins,
                "description_file": desc,
                "header": header,
            }
        )
    assert kmer_len is not None
    return data, kmer_len


def merge(
    project_name: str,
    indexes: Sequence[str],
    min_count: int = MergeConfig.min_count,
    max_count: int = MergeConfig.max_count,
    block_size: int = MergeConfig.block_size,
    threads: int = MergeConfig.threads,
    buffer_size: Optional[int] = None,
    n_shards: Optional[int] = None,
    engine: str = "auto",
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
) -> Tuple[List[Dict[str, Any]], np.ndarray]:
    """Build `{project}.{min:03d}-{max:03d}.kma` (+ `.json`) from N indexes.

    The arguments are those of ``pykmer_tpu.merge.merge``, plus ``device``
    ('cuda' or, for tests, 'cpu'), where the device engine runs, and
    ``mesh``. ``engine``: "device", "host", or "auto": host when N <=
    PYKMER_TPU_MERGE_HOST_MAX_N (default 8) and the merge is not sharded, as
    in the JAX package. ``n_shards`` > 1 shards the device engine's compare
    over ``mesh`` (default ``make_mesh(n_shards, device=device)``: on CUDA
    that many visible cards); a given ``mesh`` sets ``n_shards`` itself.
    """
    device = resolve_device(device)
    if mesh is not None:
        if n_shards is not None and n_shards != mesh.shape[SHARD_AXIS]:
            raise ValueError(f"n_shards {n_shards} != the mesh's {mesh.shape[SHARD_AXIS]}")
        n_shards = mesh.shape[SHARD_AXIS]
    if not (1 <= min_count and max_count <= 255):
        raise ValueError("count bounds must satisfy 1 <= min and max <= 255")
    if block_size <= 0 or len(indexes) == 0:
        raise ValueError("need a positive block size and at least one index")
    if buffer_size is not None and buffer_size <= 0:
        raise ValueError("buffer_size must be positive")

    outfile = kmafmt.kma_path(project_name, min_count, max_count)
    if os.path.exists(project_name):
        raise ValueError(
            f"project name ({project_name}) is a file. maybe forgot to pass "
            f"project name as first argument?"
        )
    if os.path.exists(outfile):
        raise FileExistsError(f"project output file ({outfile}) already exists.")

    data, kmer_len = _validate_inputs(indexes)
    n = len(data)
    data_size = 4**kmer_len

    sharded = (n_shards or 0) > 1
    engine = resolve_engine(engine, n, sharded)
    if engine == "host" and sharded:
        raise ValueError("--shards requires the device engine")

    paths = [d["index_file"] for d in data]
    if engine == "host":
        shared = _pairwise_matrix_host(
            paths, data_size, min_count, max_count, block_size=block_size,
            threads=threads, verbose=verbose, buffer_size=buffer_size,
        )
    else:
        if sharded and mesh is None:
            mesh = make_mesh(n_shards=n_shards, device=device)
        shared = _pairwise_matrix_device(
            paths, data_size, min_count, max_count, block_size=block_size,
            threads=threads, verbose=verbose, buffer_size=buffer_size,
            device=device, mesh=mesh if sharded else None,
        )

    # matrix[k,l] = (k_count, l_count, shared): totals live on the diagonal
    matrix = np.zeros((n, n, 3), dtype=np.uint64)
    totals = np.diagonal(shared).astype(np.uint64)
    matrix[:, :, 0] = totals[:, None]
    matrix[:, :, 1] = totals[None, :]
    matrix[:, :, 2] = shared.astype(np.uint64)

    json_data = [
        {
            "pos": d["pos"],
            "index_file": d["index_file"],
            "description_file": d["description_file"],
            "header": d["header"].to_dict(lean=True),
        }
        for d in data
    ]
    outfile_json = f"{outfile}.json"
    if verbose:
        print(f"saving {outfile_json}")
    kmafmt.write_kma_json(outfile_json, project_name, min_count, max_count, json_data)
    if verbose:
        print(f"saving {outfile}")
    kmafmt.write_kma(outfile, matrix)
    return json_data, matrix


def resolve_engine(engine: str, n: int, sharded: bool) -> str:
    """The engine ``merge(engine=...)`` runs for ``n`` indexes: "auto" is
    the host engine when n <= PYKMER_TPU_MERGE_HOST_MAX_N (default 8) and the
    merge is not sharded, the device engine otherwise."""
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"engine must be auto|host|device, got {engine!r}")
    if engine == "auto":
        host_max_n = int(os.environ.get("PYKMER_TPU_MERGE_HOST_MAX_N", "8"))
        return "host" if n <= host_max_n and not sharded else "device"
    return engine


class _InputStreams:
    """N parallel block readers over `.kin` / `.kin.bgz` / `.gz` inputs (each
    file streamed exactly once, front to back).

    Raw `.kin` inputs read O_DIRECT into reusable pooled buffers; `.bgz`
    inputs use GZI-guided random access with the covering blocks inflated in
    parallel on a shared pool (zlib drops the GIL). Non-BGZF gzip inputs (no
    block structure) keep the stream fallback; a corrupt/truncated `.bgz`
    (struct.error from the header walk) falls back the same way instead of
    crashing the merge."""

    def __init__(self, paths: Sequence[str], block_size: int,
                 buffer_size: Optional[int]):
        import struct as _struct

        from ..io.bgzf import BgzfRangeReader
        from ..io.direct import DirectReader
        from ..utils.bigmem import big_empty

        self.inflate_pool = ThreadPoolExecutor(max(2, os.cpu_count() or 2))
        self.streams: List[Tuple[str, Any]] = []
        self.bufs: List[np.ndarray] = []
        ok = False
        try:
            for p in paths:
                if p.endswith("." + kinfmt.COMP_EXT):
                    try:
                        self.streams.append(
                            ("bgz", BgzfRangeReader(p, pool=self.inflate_pool))
                        )
                    except (IOError, OSError, _struct.error):
                        self.streams.append(
                            ("gz", kinfmt.open_kin_stream(
                                p, buffering=buffer_size))
                        )
                else:
                    self.streams.append(("raw", DirectReader(p)))
                self.bufs.append(big_empty(block_size))
            ok = True
        finally:
            if not ok:
                self.close()

    def read_block(self, i: int, want: int, off: int) -> np.ndarray:
        """Fill stream i's pooled buffer with cells [off, off+want)."""
        from ..io.direct import pread_into_mt

        kind, src = self.streams[i]
        blk = self.bufs[i][:want]
        if kind == "raw":
            got = pread_into_mt(src, blk, off, threads=2)
        elif kind == "bgz":
            got = src.read_into(blk, off)
        else:
            got, mv = 0, memoryview(blk)
            while got < want:
                r = src.readinto(mv[got:])
                if not r:
                    break
                got += r
        if got != want:
            raise IOError("short read while merging")
        return blk

    def close(self) -> None:
        self.inflate_pool.shutdown(wait=False)
        for _, src in self.streams:
            src.close()

    def __enter__(self) -> "_InputStreams":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _validity_ops(min_count: int, max_count: int) -> Tuple[Callable, Callable, Callable]:
    """(pack, pop, pop_and) over validity bit planes.

    ``pack(blk, out)`` writes the little-endian validity bits of a count
    block into ``out`` (the last byte's pad bits zero) and returns the
    written bytes; ``pop(bits)`` and ``pop_and(a, b)`` count set bits. The
    native library's AVX2 versions, or numpy where it is absent (the JAX
    package's fallback, with the native bit order)."""
    try:
        from ..io.native import (
            pack_valid_bits_native,
            popcount_and_native,
            popcount_buf_native,
        )

        def pack(blk: np.ndarray, out: np.ndarray) -> np.ndarray:
            return pack_valid_bits_native(blk, min_count, max_count, out=out)

        return pack, popcount_buf_native, popcount_and_native
    except ImportError:
        pass

    def pack(blk: np.ndarray, out: np.ndarray) -> np.ndarray:
        valid = (blk >= min_count) & (blk <= max_count)
        packed = np.packbits(valid, bitorder="little")
        out[: packed.shape[0]] = packed
        return out[: packed.shape[0]]

    # np.bitwise_count needs numpy >= 2.0 and pyproject leaves numpy
    # unpinned; a 256-entry popcount LUT keeps the fallback portable
    popcnt = getattr(np, "bitwise_count", None)
    if popcnt is None:
        _lut = np.unpackbits(
            np.arange(256, dtype=np.uint8)[:, None], axis=1
        ).sum(axis=1).astype(np.uint8)

        def popcnt(bits: np.ndarray) -> np.ndarray:
            return _lut[bits]

    def pop(bits: np.ndarray, threads: int = 2) -> int:
        return int(popcnt(bits).sum())

    def pop_and(a: np.ndarray, b: np.ndarray, threads: int = 2) -> int:
        return int(popcnt(a & b).sum())

    return pack, pop, pop_and


def _aligned_block(block_size: int, data_size: int, align: int = 8) -> int:
    """The block rounded up to ``align`` cells (so validity bits pack
    evenly), at least 4 alignments and no more than the data needs."""
    block_size = max(4 * align, min(block_size, data_size + align - 1))
    return (block_size + align - 1) // align * align


def _pairwise_matrix_host(
    paths: List[str],
    data_size: int,
    min_count: int,
    max_count: int,
    block_size: int,
    threads: int,
    verbose: bool,
    buffer_size: Optional[int] = None,
) -> np.ndarray:
    """Small-N engine: per block, each sample reduces to a 1-bit validity
    plane and every pair accumulates one AND+popcount pass, with each file
    read ONCE. No device work at all: a merge of a few samples pays no
    upload round-trip. O(N^2) bit-plane traffic per block means the device
    engine takes over at fan-in scale (merge() picks by N)."""
    n = len(paths)
    block_size = _aligned_block(block_size, data_size)
    pack, pop, pop_and = _validity_ops(min_count, max_count)

    acc = np.zeros((n, n), dtype=np.int64)
    bit_bufs = [np.empty(block_size // 8, dtype=np.uint8) for _ in range(n)]
    pairs = [(i, j) for i in range(n) for j in range(i, n)]
    with _InputStreams(paths, block_size, buffer_size) as streams, \
            ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        done = 0
        while done < data_size:
            want = min(block_size, data_size - done)
            nb = (want + 7) // 8
            if want % 8:
                # zero the ragged tail byte's pad bits (pack() zero-fills
                # them, but only up to the bytes it returns)
                for b in bit_bufs:
                    b[nb - 1 : nb] = 0

            def read_pack(i: int, want=want, off=done) -> np.ndarray:
                return pack(streams.read_block(i, want, off), bit_bufs[i])

            bits = list(pool.map(read_pack, range(n)))

            def count_pair(ij: Tuple[int, int]) -> int:
                i, j = ij
                if i == j:
                    return pop(bits[i], threads=1)
                return pop_and(bits[i], bits[j], threads=1)

            for (i, j), c in zip(pairs, pool.map(count_pair, pairs)):
                acc[i, j] += c
            done += want
            if verbose:
                _progress(done, data_size)
    assert done == data_size
    iu = np.triu_indices(n, k=1)
    acc[(iu[1], iu[0])] = acc[iu]
    return acc


class _BitStaging:
    """Host buffers for one block's [n, block/8] validity bits, and their
    upload to one device per shard: shard s of S takes the contiguous byte
    slice ``[s·w, (s+1)·w)`` of every row, w = block/8/S.

    On CUDA the reader threads pack into one of ``STAGING_SLOTS`` pinned
    buffers, which is copied with ``non_blocking=True`` on each shard
    device's current stream (one copy, or one per row when S > 1); an event
    per shard recorded after its copies guards the slot, which is refilled
    only once those events have completed. On the CPU one buffer is cut
    without a copy (the CPU block step runs before the next fill)."""

    def __init__(self, n: int, n_bytes: int, devices: List[torch.device]):
        self.devices = devices
        self.width = n_bytes // len(devices)
        self.next = 0
        if devices[0].type == "cuda":
            self.slots = [
                (torch.empty((n, n_bytes), dtype=torch.uint8, pin_memory=True),
                 [torch.cuda.Event() for _ in devices])
                for _ in range(STAGING_SLOTS)
            ]
        else:
            self.slots = [(torch.empty((n, n_bytes), dtype=torch.uint8), None)]

    def acquire(self) -> np.ndarray:
        """The next slot, free to fill, as a numpy array."""
        host, done = self.slots[self.next]
        for ev in done or ():
            ev.synchronize()  # the slot's previous copies have landed
        return host.numpy()

    def upload(self) -> List[torch.Tensor]:
        """The slot just filled, one [n, w] slice on each shard's device;
        moves on to the next slot."""
        host, done = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        w = self.width
        if done is None:
            return [host[:, s * w : (s + 1) * w].contiguous()
                    for s in range(len(self.devices))]
        out = []
        for s, (dev, ev) in enumerate(zip(self.devices, done)):
            src = host[:, s * w : (s + 1) * w]
            dst = torch.empty(src.shape, dtype=torch.uint8, device=dev)
            if src.is_contiguous():
                dst.copy_(src, non_blocking=True)
            else:  # each row's slice is contiguous in the pinned buffer
                for i in range(src.shape[0]):
                    dst[i].copy_(src[i], non_blocking=True)
            ev.record(torch.cuda.current_stream(dev))
            out.append(dst)
        return out


def _pairwise_matrix_device(
    paths: List[str],
    data_size: int,
    min_count: int,
    max_count: int,
    block_size: int,
    threads: int,
    verbose: bool,
    buffer_size: Optional[int] = None,
    device: torch.device = torch.device("cuda"),
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Shared-count N×N matrix on ``device``, or, with a ``mesh``, on mesh
    device 0 with the block's cells sharded over the mesh's devices; each
    file streamed exactly once. The accumulator stays on the device and is
    read once at the end."""
    n = len(paths)
    devices = [device] if mesh is None else mesh.devices[0]
    n_shards = len(devices)
    align = 8 * n_shards  # the bits split into whole bytes per shard
    # clamp the block so each shard's working set stays inside a budget: its
    # unpacked validity matrix V, zero rows included, one byte per cell and
    # row (beside it the 8x smaller bits upload and the n^2 accumulator) — a
    # large-N merge with the default 100M block would otherwise run out of
    # device memory rather than degrade
    hbm_budget = int(os.environ.get("PYKMER_TPU_MERGE_HBM_BYTES",
                                    str(2 << 30)))
    rows = padded_rows(n)
    max_block = max(4 * align, hbm_budget * n_shards // rows // align * align)
    if block_size > max_block:
        if verbose:
            print(
                f"  clamping block_size {block_size:,} -> {max_block:,} "
                f"(N={n}: {rows} unpacked planes, zero padding included, within "
                f"the {hbm_budget:,}-byte HBM budget per shard; override via "
                f"PYKMER_TPU_MERGE_HBM_BYTES)"
            )
        block_size = max_block
    block_size = _aligned_block(block_size, data_size, align)
    n_bytes = block_size // 8
    pack = _validity_ops(min_count, max_count)[0]

    staging = _BitStaging(n, n_bytes, devices)
    acc = torch.zeros((n, n), dtype=torch.int64, device=devices[0])
    if mesh is not None:
        step = make_sharded_merge_step(mesh, n)
    else:
        v = new_workspace(n, block_size, devices[0])

        def step(acc: torch.Tensor, bits: List[torch.Tensor]) -> torch.Tensor:
            return block_contingency(acc, bits[0], v)
    with _InputStreams(paths, block_size, buffer_size) as streams, \
            ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        done = 0
        while done < data_size:
            want = min(block_size, data_size - done)
            host = staging.acquire()

            def read_pack(i: int, want=want, off=done) -> None:
                # read + threshold + bit-pack in the reader thread, straight
                # into the staging row; the pad bytes of a ragged last block
                # stay zero (invalid cells)
                packed = pack(streams.read_block(i, want, off), host[i])
                host[i, packed.shape[0]:] = 0

            list(pool.map(read_pack, range(n)))
            step(acc, staging.upload())
            done += want
            if verbose:
                _progress(done, data_size)
    assert done == data_size
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return acc.cpu().numpy()


def _progress(done: int, data_size: int) -> None:
    print(
        f"  merged {done:15,d}/{data_size:15,d} "
        f"({done / data_size * 100.0:6.2f}%)"
    )


def iter_kin_cells(path: str, buffer_size: int = 1 << 16):
    """Byte-at-a-time iterator over a `.kin[.bgz]`'s cells (reference
    ``Header.__iter__``, tools.py:527-533: buffered reads of the opened
    index stream, yielding one int per cell)."""
    with kinfmt.open_kin_stream(path) as fh:
        cs = fh.read(buffer_size)
        while cs:
            yield from cs
            cs = fh.read(buffer_size)


def pair_counts_scalar(
    a_path: str,
    b_path: str,
    min_count: int = MergeConfig.min_count,
    max_count: int = MergeConfig.max_count,
) -> Tuple[int, int, int]:
    """Scalar cell-at-a-time pair counts — parity port of the reference's
    unused fallback ``Header.calculate_distance2`` (tools.py:495-512): zip
    the two cell iterators and range-test each pair. A size mismatch raises
    ``ValueError`` (``strict=True``) where the reference silently truncates."""
    a_count = b_count = s_count = 0
    for a_char, b_char in zip(
        iter_kin_cells(a_path), iter_kin_cells(b_path), strict=True
    ):
        a_valid = min_count <= a_char <= max_count
        b_valid = min_count <= b_char <= max_count
        a_count += 1 if a_valid else 0
        b_count += 1 if b_valid else 0
        s_count += 1 if a_valid and b_valid else 0
    return a_count, b_count, s_count


def pair_counts_stream(
    a_path: str,
    b_path: str,
    data_size: int,
    min_count: int = MergeConfig.min_count,
    max_count: int = MergeConfig.max_count,
    block_size: int = MergeConfig.block_size,
) -> Tuple[int, int, int]:
    """Single-pair streamed counts (reference Header.calculate_distance
    tools.py:439-493 parity; used for verification)."""
    a_count = b_count = s_count = 0
    blocks_a = kinfmt.iter_kin_blocks(a_path, data_size, block_size,
                                      reuse_buffer=True)
    blocks_b = kinfmt.iter_kin_blocks(b_path, data_size, block_size,
                                      reuse_buffer=True)
    for a_blk, b_blk in zip(blocks_a, blocks_b):
        assert a_blk.shape == b_blk.shape
        av = (a_blk >= min_count) & (a_blk <= max_count)
        bv = (b_blk >= min_count) & (b_blk <= max_count)
        a_count += int(av.sum())
        b_count += int(bv.sum())
        s_count += int((av & bv).sum())
    return a_count, b_count, s_count
