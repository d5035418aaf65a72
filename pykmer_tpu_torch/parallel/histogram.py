"""Count-space-sharded saturating histogram: counterpart of
``pykmer_tpu/parallel/histogram.py``.

Layout, as in the JAX package: counts live in the folded half-space
``w = min(c, 4^K-1-c)``. With S = n_shards (a power of two), folded code
``w`` lives on shard ``w % S`` at local index ``w // S``; the flat folded
plane is the column-major interleave of the per-shard planes
(:func:`interleaved_to_flat`).

Per step, at each position (r, s) of the ``[R, S]`` mesh, on its device:

1. upload its row of packed bases and validity bits, encode and fold
   (``ops/encode.canonical_codes_packed``, the packed kernel on CUDA);
2. key each window ``owner·local_size + local`` (invalid windows key past
   every bucket) and sort the keys, so each destination's codes are
   contiguous;
3. bucket the sorted keys by destination into a fixed ``[S, capacity]``
   buffer of local indices, padded with ``local_size``; a bucket larger than
   the capacity is recorded in ``max_bucket`` (its excess is dropped, and
   the caller must fail the run);
4. exchange along ``shards`` (``all_to_all``), then gather along ``data``,
   so each replica of a shard receives every row's codes for it;
5. apply the received rows to the shard's local plane with the saturating
   sweep kernel (``ops/sweep.accumulate_sorted``), one launch per row.

The received buffer is R·S rows, each ascending with its pad at the end, but
not sorted as a whole (the JAX package re-sorts it inside
``saturating_accumulate``). One sweep launch per row is exact:
``min(min(a + x, 255) + y, 255) = min(a + x + y, 255)`` for non-negative
x, y, and each launch clips its run counts at 255. The sweep ignores codes
outside ``[0, local_size)``, so the pad needs no mask.

``num_valid`` is summed once per row over the whole mesh and ``max_bucket``
is a running max; both stay on mesh device 0 and are read only at
checkpoints and at the end: no step synchronises the host.

The numpy helpers (:func:`interleaved_to_flat`, :func:`flat_to_interleaved`,
:func:`shard_batch_chunks`, :func:`shard_batch_chunks_packed`) are copies of
the JAX package's: ``pykmer_tpu.parallel`` imports jax.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..host.chunks import pack_base_stream
from ..index.indexer import ChunkUploader
from ..ops.encode import canonical_codes_packed, code_dtype
from ..ops.histogram import sort_codes_fast
from ..ops.sweep import accumulate_sorted
from .collectives import all_gather, all_to_all, pmax, psum
from .mesh import DATA_AXIS, SHARD_AXIS, Mesh

# local planes up to this many cells carry int32 local indices, larger ones
# int64 (K=17 below 8 shards); a test lowers it to drive the int64 path
MAX_INT32_LOCAL_CELLS = np.iinfo(np.int32).max

# (planes [R][S] of uint8[local_size], num_valid int64 0-d, max_bucket int64 0-d)
ShardedState = Tuple[List[List[torch.Tensor]], torch.Tensor, torch.Tensor]


def interleaved_to_flat(shards: np.ndarray) -> np.ndarray:
    """[S, local] per-shard arrays → the flat folded plane [4^K / 2].

    folded code w = (local << log2(S)) | s  ⇒  flat[w] = shards[w % S, w // S]
    """
    s, local = shards.shape
    return shards.T.reshape(s * local) if s == 1 else np.ascontiguousarray(
        shards.T
    ).reshape(s * local)


def flat_to_interleaved(flat: np.ndarray, n_shards: int) -> np.ndarray:
    return np.ascontiguousarray(flat.reshape(-1, n_shards).T)


def shard_batch_chunks(
    padded: np.ndarray, kmer_len: int, chunk_windows: int, n_rows: int, step: int
) -> np.ndarray:
    """Host framing: rows of overlapping chunks for one sharded step.

    Returns [n_rows, chunk_windows + K - 1]; row r covers window starts
    [(step*n_rows + r) * chunk_windows, ...). Rows beyond the stream are
    invalid-padded (their windows drop on device).
    """
    span = chunk_windows + kmer_len - 1
    out = np.full((n_rows, span), 4, dtype=np.uint8)
    for r in range(n_rows):
        start = (step * n_rows + r) * chunk_windows
        if start >= max(padded.shape[0] - kmer_len + 1, 0):
            continue
        piece = padded[start : start + span]
        out[r, : piece.shape[0]] = piece
    return out


def shard_batch_chunks_packed(
    padded: np.ndarray, kmer_len: int, chunk_windows: int, n_rows: int, step: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Packed variant of :func:`shard_batch_chunks`: rows of (2-bit bases,
    validity bitmap) planes — 0.375 B/base host→device, decoded on the
    device."""
    span = chunk_windows + kmer_len - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    bases = np.zeros((n_rows, b_span), dtype=np.uint8)
    mask = np.zeros((n_rows, m_span), dtype=np.uint8)  # 0 = all-invalid row
    n_windows = max(padded.shape[0] - kmer_len + 1, 0)
    for r in range(n_rows):
        start = (step * n_rows + r) * chunk_windows
        if start >= n_windows:
            continue
        piece = padded[start : start + span]
        if piece.shape[0] < span:
            piece = np.concatenate(
                [piece, np.full(span - piece.shape[0], 4, np.uint8)]
            )
        pb, pm = pack_base_stream(piece)
        bases[r] = pb[:b_span]
        mask[r] = pm[:m_span]
    return bases, mask


def make_sharded_accumulate(
    mesh: Mesh,
    kmer_len: int,
    chunk_windows: int,
    capacity_factor: float = 2.0,
) -> Tuple[Callable[[], ShardedState], Callable]:
    """Build ``(init_fn, step_fn)`` for the sharded histogram on ``mesh``.

    ``init_fn()`` → ``(planes, num_valid, max_bucket)``: ``planes[r][s]`` the
    zeroed local plane of position (r, s) on its device, the two counters
    0-d int64 on mesh device 0.
    ``step_fn(state, (bases [R·S, b_span], mask [R·S, m_span]))`` → state,
    the planes updated in place; row p of the packed rows goes to position
    (p // S, p % S). After the loop ``max_bucket`` must be checked against
    ``step_fn.capacity`` (an overflow invalidates the run).
    """
    n_data = mesh.shape[DATA_AXIS]
    n_shards = mesh.shape[SHARD_AXIS]
    if n_shards & (n_shards - 1):
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    shard_bits = n_shards.bit_length() - 1
    fold_size = 4**kmer_len // 2
    local_size = fold_size // n_shards
    if local_size * n_shards != fold_size:
        raise ValueError(f"{n_shards} shards do not split the 4^{kmer_len}/2 plane")
    capacity = min(int(np.ceil(chunk_windows / n_shards * capacity_factor)), chunk_windows)
    span = chunk_windows + kmer_len - 1
    dt = code_dtype(kmer_len)
    # the key keeps the code dtype; local indices narrow after the owner split
    local_dt = torch.int32 if local_size <= MAX_INT32_LOCAL_CELLS else torch.int64
    uploaders = [[ChunkUploader(d, kmer_len, chunk_windows) for d in row]
                 for row in mesh.devices]

    def init_fn() -> ShardedState:
        planes = [[torch.zeros(local_size, dtype=torch.uint8, device=d) for d in row]
                  for row in mesh.devices]
        zero = torch.zeros((), dtype=torch.int64, device=mesh.first)
        return planes, zero, zero.clone()

    def bucket(bases2: torch.Tensor, maskbits: torch.Tensor):
        """One position's (send [S, capacity] local indices, valid windows,
        largest bucket), on the row's device."""
        dev = bases2.device
        codes = canonical_codes_packed(bases2, maskbits, span, kmer_len)
        valid = codes < fold_size
        num_valid = valid.sum(dtype=torch.int64)
        key = (codes & (n_shards - 1)) * local_size + (codes >> shard_bits)
        key = sort_codes_fast(key.masked_fill_(~valid, fold_size))
        bounds = torch.arange(n_shards + 1, dtype=dt, device=dev) * local_size
        offsets = torch.searchsorted(key, bounds)
        counts = offsets[1:] - offsets[:-1]
        slot = torch.arange(capacity, device=dev)
        in_bucket = slot < counts[:, None]
        src = (offsets[:-1, None] + slot).masked_fill_(~in_bucket, 0)
        send = (key[src] - bounds[:-1, None]).to(local_dt)
        return send.masked_fill_(~in_bucket, local_size), num_valid, counts.max()

    def exchange(sends: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """``sends[r][s]`` ([S, capacity] per position) → the [R·S, capacity]
        rows each position (r, j) receives: all_to_all along ``shards``, then
        all_gather along ``data``."""
        recv = [all_to_all(sends[r], row) for r, row in enumerate(mesh.devices)]
        out = [[None] * n_shards for _ in range(n_data)]
        for j in range(n_shards):
            column = [mesh.devices[r][j] for r in range(n_data)]
            for r, rows in enumerate(all_gather([recv[r][j] for r in range(n_data)], column)):
                out[r][j] = rows
        return out

    def step_fn(state: ShardedState, packed_rows: Tuple[np.ndarray, np.ndarray]) -> ShardedState:
        planes, nk, maxb = state
        bases, mask = packed_rows
        if bases.shape[0] != n_data * n_shards or mask.shape[0] != n_data * n_shards:
            raise ValueError(f"a step takes {n_data * n_shards} rows, got {bases.shape[0]}")
        sends, nvalid, biggest = [], [], []
        for r, row in enumerate(mesh.devices):
            sends.append([])
            for s in range(len(row)):
                p = r * n_shards + s
                send, nv, mb = bucket(*uploaders[r][s](bases[p], mask[p]))
                sends[r].append(send)
                nvalid.append(nv)
                biggest.append(mb)
        for r, received in enumerate(exchange(sends)):
            for j, rows in enumerate(received):
                for codes in rows:
                    accumulate_sorted(planes[r][j], codes)
        nk = nk + psum(nvalid, mesh.first)
        maxb = torch.maximum(maxb, pmax(biggest, mesh.first))
        return planes, nk, maxb

    step_fn.capacity = capacity
    step_fn.rows = n_data * n_shards
    step_fn.span = span
    step_fn.local_size = local_size
    step_fn.n_shards = n_shards
    # the step's parts, for timing them apart on the card
    step_fn.bucket = bucket
    step_fn.exchange = exchange
    return init_fn, step_fn
