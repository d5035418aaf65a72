"""`.kin` on-disk layout: a dense 4^K uint8 coverage array, one byte per
canonical k-mer code.

Naming scheme (must match the reference exactly, tools.py:185-202):
    index root : ``{abspath(input)}.{K:02d}.kin``
    tmp file   : ``{root}.tmp``          (atomic-renamed to root when done)
    metadata   : ``{root}.json``
    compressed : ``{root}.bgz``          (BGZF; preferred for reads if present)

Copy of ``pykmer_tpu/formats/kin.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import gzip
import os
from typing import BinaryIO, Iterator, Optional

import numpy as np

IND_EXT = "kin"
DESC_EXT = "json"
TMP_EXT = "tmp"
COMP_EXT = "bgz"


def kin_root_path(input_file: str, kmer_len: int) -> str:
    return f"{os.path.abspath(input_file)}.{kmer_len:02d}.{IND_EXT}"


def kin_tmp_path(input_file: str, kmer_len: int) -> str:
    return f"{kin_root_path(input_file, kmer_len)}.{TMP_EXT}"


def kin_bgz_path(input_file: str, kmer_len: int) -> str:
    return f"{kin_root_path(input_file, kmer_len)}.{COMP_EXT}"


def metadata_path(input_file: str, kmer_len: int) -> str:
    return f"{kin_root_path(input_file, kmer_len)}.{DESC_EXT}"


def resolve_kin_path(input_file: str, kmer_len: int) -> str:
    """The readable index file: prefers `.bgz` when present (tools.py:186-190)."""
    bgz = kin_bgz_path(input_file, kmer_len)
    return bgz if os.path.exists(bgz) else kin_root_path(input_file, kmer_len)


def parse_kin_filename(index_file: str) -> tuple[str, int]:
    """Recover ``(input_file, kmer_len)`` from an index filename.

    Inverse of :func:`kin_root_path`; accepts an optional `.bgz` suffix
    (reference tools.py:220-238).
    """
    name = index_file
    if name.endswith("." + COMP_EXT):
        name = name[: -(len(COMP_EXT) + 1)]
    suffix = "." + IND_EXT
    if not name.endswith(suffix):
        raise ValueError(f"not a .{IND_EXT} file: {index_file}")
    stem = name[: -len(suffix)]
    base, dot, kstr = stem.rpartition(".")
    if not dot or not kstr.isdigit():
        raise ValueError(f"cannot parse kmer length from: {index_file}")
    return base, int(kstr)


def init_sparse_file(path: str, size: int) -> None:
    """Preallocate ``size`` bytes by seeking to the end and writing one zero
    byte — a sparse file on most filesystems (reference tools.py:333-342)."""
    with open(path, "wb") as fh:
        if size > 0:
            fh.seek(size - 1)
            fh.write(b"\0")


def remove_outputs(input_file: str, kmer_len: int, overwrite: bool) -> None:
    """Pre-run cleanup with an overwrite guard (reference tools.py:314-331)."""
    root = kin_root_path(input_file, kmer_len)
    for path in (resolve_kin_path(input_file, kmer_len), root):
        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(
                    f"file {path} already exists and overwriting disabled"
                )
            os.remove(path)
    for path in (metadata_path(input_file, kmer_len), kin_tmp_path(input_file, kmer_len)):
        if os.path.exists(path):
            os.remove(path)


def open_kin_stream(
    path: str, mode: str = "rb", buffering: Optional[int] = None
) -> BinaryIO:
    """Open a `.kin` (raw) or `.kin.bgz` (gzip-wrapped) for sequential reads.

    ``buffering`` sets the raw-file buffer size (the role the reference's
    ``buffer_size`` plays in its ``open(..., buffering=)`` calls,
    tools.py:294-305); default leaves the interpreter's choice.
    """
    if path.endswith("." + COMP_EXT):
        if buffering is not None:
            raw = open(path, mode, buffering=buffering)
            return gzip.GzipFile(fileobj=raw, mode=mode)
        return gzip.open(path, mode)
    if buffering is not None:
        return open(path, mode, buffering=buffering)
    return open(path, mode)


def iter_kin_blocks(
    path: str, data_size: int, block_size: int, reuse_buffer: bool = False
) -> Iterator[np.ndarray]:
    """Stream the dense array in ``block_size``-byte uint8 blocks.

    Total yielded bytes always equal ``data_size`` (asserted), matching the
    reference's full-coverage invariant (tools.py:492).

    ``reuse_buffer=True`` yields views of ONE pooled buffer (raw planes
    only): the caller must fully consume each block before advancing the
    iterator. Streaming consumers (stats, pair counts) use it to avoid
    allocating fresh pool blocks per read — this guest obtains new physical
    memory at ~130 MB/s, which dominated the verify pass.
    """
    total = 0
    if not path.endswith("." + COMP_EXT):
        # raw plane: O_DIRECT positional reads into pooled buffers (buffered
        # reads pay this environment's slow page-cache allocation)
        from ..io.direct import DirectReader, pread_into_mt
        from ..utils.bigmem import big_empty

        shared = big_empty(min(block_size, data_size)) if reuse_buffer \
            else None
        with DirectReader(path) as rd:
            while total < data_size:
                want = min(block_size, data_size - total)
                buf = shared[:want] if shared is not None else big_empty(want)
                got = pread_into_mt(rd, buf, total)
                if got != want:
                    raise IOError(
                        f"{path}: short read at offset {total}: got {got}, "
                        f"wanted {want}"
                    )
                total += want
                yield buf
        assert total == data_size
        return
    with open_kin_stream(path) as fh:
        while total < data_size:
            want = min(block_size, data_size - total)
            buf = fh.read(want)
            if len(buf) != want:
                raise IOError(
                    f"{path}: short read at offset {total}: got {len(buf)}, "
                    f"wanted {want}"
                )
            total += want
            yield np.frombuffer(buf, dtype=np.uint8, count=want)
    assert total == data_size


def open_kin_memmap(path: str, data_size: int, mode: str = "r") -> np.ndarray:
    if path.endswith("." + COMP_EXT):
        raise ValueError("cannot memmap a compressed index; use iter_kin_blocks")
    return np.memmap(path, dtype=np.uint8, mode=mode, shape=(data_size,))


def write_kin_array(path: str, array: np.ndarray) -> None:
    """Write the dense uint8 array to ``path`` in one streamed pass."""
    assert array.dtype == np.uint8
    with open(path, "wb") as fh:
        array.tofile(fh)


def read_kin_array(input_file: str, kmer_len: int, data_size: Optional[int] = None) -> np.ndarray:
    """Load the dense array (decompressing `.bgz` transparently)."""
    path = resolve_kin_path(input_file, kmer_len)
    if data_size is None:
        data_size = 4**kmer_len
    if path.endswith("." + COMP_EXT):
        with open_kin_stream(path) as fh:
            data = fh.read()
        arr = np.frombuffer(data, dtype=np.uint8)
    else:
        from ..io.direct import read_file_into
        from ..utils.bigmem import big_empty

        nbytes = os.path.getsize(path)
        arr = big_empty(nbytes)
        got = read_file_into(path, arr)
        if got != nbytes:
            raise IOError(f"{path}: short read: got {got}, wanted {nbytes}")
    if arr.shape[0] != data_size:
        raise IOError(f"{path}: expected {data_size} bytes, got {arr.shape[0]}")
    return arr
