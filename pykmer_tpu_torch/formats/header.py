"""`.kin.json` metadata: schema, stats, provenance.

Byte-compatible with the reference header JSON (reference tools.py:67-106 for
the key lists, tools.py:366-401 for the reader/writer): same keys, same value
semantics, ``json.dump(..., indent=1, sort_keys=True)``. Timing/host
provenance values (ctimes, hostname, speeds, script checksum) are run-specific
by design, exactly as in the reference.

Copy of ``pykmer_tpu/formats/header.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import socket
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..config import (
    DEFAULT_FLUSH_EVERY,
    DEFAULT_MAX_FRAG_SIZE,
    DEFAULT_MIN_FRAG_SIZE,
    MAX_VAL,
)
from ..utils.checksum import sha256_file
from ..utils.timer import Timer
from . import kin as kinfmt

FILE_VERSION = "KMER001"

# Key lists of the JSON schema (reference tools.py:74-92).
FIXED_KEYS: List[str] = ["file_ver", "kmer_size", "data_size", "max_size"]
DATA_KEYS: List[str] = [
    "project_name",
    "kmer_len",
    "flush_every",
    "frag_size",
    "input_file_name", "input_file_path",
    "input_file_size", "input_file_ctime", "input_file_cheksum",
    "output_file_size", "output_file_ctime", "output_file_cheksum",
    "num_kmers", "chromosomes",
    "creation_time_start", "creation_time_end", "creation_duration",
    "creation_speed",
    "hostname", "checksum_script",
    "hist",
    "hist_sum", "hist_count", "hist_min", "hist_max",
    "vals_sum", "vals_count", "vals_min", "vals_max",
]
NOT_LEAN: List[str] = ["chromosomes"]


def frag_size_autotune(
    data_size: int,
    min_frag_size: Optional[int] = DEFAULT_MIN_FRAG_SIZE,
    max_frag_size: Optional[int] = DEFAULT_MAX_FRAG_SIZE,
) -> int:
    """Reproduce the reference's fragment-size autotuner (tools.py:169-183).

    The TPU pipeline does not process by fragments (the count space is
    range-sharded over the mesh instead), but the chosen value is recorded in
    `.kin.json` and must be value-identical.
    """
    frag_size = data_size // 10
    if max_frag_size is not None and frag_size > max_frag_size:
        frag_size = max_frag_size
    if min_frag_size is not None and frag_size < min_frag_size:
        frag_size = min_frag_size
    if frag_size > data_size:
        frag_size = data_size
    if (data_size % frag_size) < (data_size // 2):
        pieces = data_size // frag_size
        frag_size = data_size // (pieces + 1)
        frag_size = frag_size + (pieces + 1) + 1
        frag_size = int(math.ceil(frag_size / 1_000) * 1_000)
    return frag_size


def fast_counts256(arr: np.ndarray) -> np.ndarray:
    """256-bin bincount of a uint8 array without numpy's int64 cast+copy.

    Uses the native C++ pass when built; otherwise chunked np.bincount (the
    whole-array call materialises an 8x int64 copy — 60s+ at 4^15).
    """
    arr = arr.reshape(-1)
    try:
        from ..io.native import count256_native

        return count256_native(arr)
    except ImportError:
        bc = np.zeros(256, dtype=np.int64)
        step = 1 << 26
        for lo in range(0, arr.shape[0], step):
            bc += np.bincount(arr[lo : lo + step], minlength=256)
        return bc


def stats_from_counts256(counts256: np.ndarray) -> Dict[str, Any]:
    """Derive all `.kin.json` stats fields from a 256-bin value histogram.

    ``counts256[v]`` = number of cells holding value ``v``. Equivalent to the
    reference's ``np.histogram(arr, bins=255, range=(1,255))`` + aggregate
    pass (tools.py:246-263): an integer value v lands in bin v-1.
    """
    bc = np.asarray(counts256, dtype=np.int64)
    assert bc.shape == (256,)
    hist_v = bc[1:256]
    values = np.arange(256, dtype=np.int64)
    present = values[bc > 0]
    return {
        "hist": [int(x) for x in hist_v],
        "hist_sum": int(hist_v.sum()),
        "hist_count": int(np.count_nonzero(hist_v)),
        "hist_min": int(hist_v.min()),
        "hist_max": int(hist_v.max()),
        "vals_sum": int((values * bc).sum()),
        "vals_count": int(bc[1:].sum()),
        "vals_min": int(present.min()) if present.size else 0,
        "vals_max": int(present.max()) if present.size else 0,
    }


def array_stats(blocks: Iterable[np.ndarray]) -> Dict[str, Any]:
    """Stats over a streamed dense array (for files larger than RAM)."""
    bc = np.zeros(256, dtype=np.int64)
    for block in blocks:
        bc += fast_counts256(block)
    return stats_from_counts256(bc)


class KinHeader:
    """Mutable metadata record for one `.kin` index."""

    def __init__(
        self,
        project_name: str,
        input_file: Optional[str] = None,
        kmer_len: Optional[int] = None,
        index_file: Optional[str] = None,
        flush_every: int = DEFAULT_FLUSH_EVERY,
        min_frag_size: int = DEFAULT_MIN_FRAG_SIZE,
        max_frag_size: int = DEFAULT_MAX_FRAG_SIZE,
        frag_size: Optional[int] = None,
    ) -> None:
        self.project_name = project_name
        self.input_file_name = os.path.basename(input_file) if input_file else None
        self.input_file_path = os.path.abspath(input_file) if input_file else None
        self.kmer_len = kmer_len
        self.flush_every = flush_every

        # True when the input arrived as a stream (stdin): provenance must
        # never stat input_file_path (it is derived from the SAMPLE name and
        # an unrelated CWD entry could share it)
        self.stream_input: bool = False

        self.input_file_size: Optional[int] = None
        self.input_file_ctime: Optional[float] = None
        self.input_file_cheksum: Optional[str] = None
        self.output_file_size: Optional[int] = None
        self.output_file_ctime: Optional[float] = None
        self.output_file_cheksum: Optional[str] = None

        self.num_kmers: Optional[int] = None
        self.chromosomes: Optional[List[Tuple[str, int]]] = None

        self.timer = Timer()
        self.creation_time_start: Optional[str] = None
        self.creation_time_end: Optional[str] = None
        self.creation_duration: Optional[str] = None
        self.creation_speed: Optional[int] = None

        self.hostname: Optional[str] = None
        self.checksum_script: Optional[str] = None

        self.hist: Optional[List[int]] = None
        self.hist_sum: Optional[int] = None
        self.hist_count: Optional[int] = None
        self.hist_min: Optional[int] = None
        self.hist_max: Optional[int] = None
        self.vals_sum: Optional[int] = None
        self.vals_count: Optional[int] = None
        self.vals_min: Optional[int] = None
        self.vals_max: Optional[int] = None

        self.frag_size: Optional[int] = None
        if index_file is not None:
            self._adopt_index_file_name(index_file)
            self.read_metadata()  # may set frag_size from the stored JSON

        if not self.kmer_len or self.kmer_len <= 0 or self.kmer_len % 2 != 1:
            raise ValueError(f"kmer_len must be a positive odd int, got {self.kmer_len}")

        if frag_size is not None:
            self.frag_size = frag_size
        elif self.frag_size is None:
            # autotune only when neither the caller nor loaded metadata set
            # it — clobbering the stored value would make a re-serialized
            # header diverge from the .kin.json on disk
            self.frag_size = frag_size_autotune(
                self.data_size, min_frag_size, max_frag_size
            )

    # ---- derived names / sizes -------------------------------------------

    @property
    def index_file(self) -> str:
        return kinfmt.resolve_kin_path(self.input_file_path, self.kmer_len)

    @property
    def index_file_basename(self) -> str:
        return os.path.basename(self.index_file)

    @property
    def index_file_root(self) -> str:
        return kinfmt.kin_root_path(self.input_file_path, self.kmer_len)

    @property
    def index_tmp_file(self) -> str:
        return kinfmt.kin_tmp_path(self.input_file_path, self.kmer_len)

    @property
    def metadata_file(self) -> str:
        return kinfmt.metadata_path(self.input_file_path, self.kmer_len)

    @property
    def kmer_size(self) -> int:
        return 4**self.kmer_len

    @property
    def data_size(self) -> int:
        return self.kmer_size

    @property
    def max_size(self) -> int:
        return self.data_size

    @property
    def file_ver(self) -> str:
        return FILE_VERSION

    @property
    def max_val(self) -> int:
        return MAX_VAL

    def _adopt_index_file_name(self, index_file: str) -> None:
        input_file, kmer_len = kinfmt.parse_kin_filename(index_file)
        if self.input_file_name is None:
            self.input_file_name = os.path.basename(input_file)
            self.input_file_path = os.path.abspath(input_file)
        if self.kmer_len is None:
            self.kmer_len = kmer_len

    # ---- stats / provenance ----------------------------------------------

    def set_stats_from_counts256(self, counts256: np.ndarray) -> None:
        for key, val in stats_from_counts256(counts256).items():
            setattr(self, key, val)

    def update_stats_from_file(self, index_file: str, block_size: int = 1 << 28) -> None:
        stats = array_stats(
            kinfmt.iter_kin_blocks(
                index_file, self.data_size, block_size, reuse_buffer=True
            )
        )
        for key, val in stats.items():
            setattr(self, key, val)

    def update_provenance(
        self,
        index_file: str,
        input_checksum: Optional[str] = None,
        output_checksum: Optional[str] = None,
    ) -> None:
        """Checksums, sizes, timestamps of input + output (tools.py:273-291).

        Checksums may be passed in precomputed (e.g. hashed from the
        in-memory array / in a background thread overlapping the device
        fetch) — values are identical to hashing the files."""
        if self.stream_input:
            # stdin input: there IS no input file — never stat (a CWD file
            # that happens to share the sample name would otherwise be
            # recorded as provenance); the checksum (of the stream bytes)
            # must have been computed by the caller
            self.input_file_size = None
            self.input_file_ctime = None
            self.input_file_cheksum = input_checksum
        else:
            # a real input path: stat it — a missing file here is an error
            # (e.g. deleted mid-run), not a silent null-provenance record
            self.input_file_size = os.path.getsize(self.input_file_path)
            self.input_file_ctime = os.path.getctime(self.input_file_path)
            self.input_file_cheksum = input_checksum or sha256_file(
                self.input_file_path
            )

        self.output_file_size = os.path.getsize(index_file)
        self.output_file_ctime = os.path.getctime(index_file)
        self.output_file_cheksum = output_checksum or sha256_file(index_file)

        self.hostname = socket.gethostname()
        self.checksum_script = sha256_file(os.path.abspath(__file__))

        time_end = datetime.datetime.now()
        self.creation_time_start = str(self.timer.time_begin)
        self.creation_time_end = str(time_end)
        self.creation_duration = str(time_end - self.timer.time_begin)
        self.creation_speed = self.timer.speed_ela

    # ---- (de)serialisation -----------------------------------------------

    def to_dict(self, lean: bool = False) -> Dict[str, Any]:
        data: Dict[str, Any] = {}
        for key in FIXED_KEYS + DATA_KEYS:
            if lean and key in NOT_LEAN:
                continue
            data[key] = getattr(self, key)
        return data

    def to_json(self, indent: int = 1, sort_keys: bool = True) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=sort_keys)

    def write_metadata(
        self,
        index_file: str,
        stats_counts256: Optional[np.ndarray] = None,
        input_checksum: Optional[str] = None,
        output_checksum: Optional[str] = None,
    ) -> None:
        """Compute provenance + stats and write `.kin.json`.

        ``stats_counts256``: device-computed 256-bin value histogram; when
        given, stats come from it (identical result to re-reading the file,
        which the oracle/tests verify), else the file is re-read.
        """
        if not self.num_kmers:
            raise ValueError("num_kmers not set (no k-mers indexed?)")
        if not self.chromosomes:
            raise ValueError("chromosomes not set")
        self.update_provenance(index_file, input_checksum, output_checksum)
        if stats_counts256 is not None:
            self.set_stats_from_counts256(stats_counts256)
        else:
            self.update_stats_from_file(index_file)
        with open(self.metadata_file, "wt") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)

    def read_metadata(self) -> None:
        with open(self.metadata_file, "rt") as fh:
            data = json.load(fh)
        for key in DATA_KEYS:
            setattr(self, key, data[key])
        for key in FIXED_KEYS:
            mine, theirs = getattr(self, key), data[key]
            if mine != theirs:
                raise ValueError(
                    f"metadata mismatch for {key}: computed {mine} != stored {theirs}"
                )

    # ---- verification -----------------------------------------------------

    def check_data(self, index_file: Optional[str] = None) -> None:
        """Re-derive stats from the file and assert they match the stored
        metadata (reference tools.py:404-426 semantics, minus its broken
        generator-with bug)."""
        self.read_metadata()
        fresh = KinHeader(
            self.project_name,
            input_file=self.input_file_path,
            kmer_len=self.kmer_len,
        )
        fresh.read_metadata()
        fresh.update_stats_from_file(index_file or self.index_file)
        for key in (
            "hist", "hist_sum", "hist_count", "hist_min", "hist_max",
            "vals_sum", "vals_count", "vals_min", "vals_max",
        ):
            mine, theirs = getattr(self, key), getattr(fresh, key)
            if mine != theirs:
                raise ValueError(
                    f"stats mismatch for {key}: stored {mine!r} != derived {theirs!r}"
                )

    def __str__(self) -> str:
        rows = []
        for key, val in self.to_dict().items():
            if isinstance(val, int):
                rows.append(f"{key:20s}: {val:15,d}")
            else:
                rows.append(f"{key:20s}: {str(val)[:50]}")
        return "\n".join(rows) + "\n"

    __repr__ = __str__
