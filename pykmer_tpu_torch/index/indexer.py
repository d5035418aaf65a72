"""The single-device index path: FASTA → `.kin` + `.kin.json`.

Port of ``create_fasta_index`` (``pykmer_tpu/index/indexer.py``). Per chunk
the device runs step A (the folded canonical encode of the packed planes,
keys-only sort, valid-window count). Two strategies apply the sorted codes:

- **device**: step B, the saturating sweep kernel, updates the flat folded
  uint8 plane, which stays on the device for the whole run (K=17's 8 GiB
  plane fits one 80 GB card);
- **host**: the sorted codes come back and the host applies the saturating
  update to a folded plane in host RAM, for planes the card cannot hold.

On the device strategy the input is pipelined: a plain file streams from disk
while it is hashed, decoded segment by segment and uploaded
(``host/pipeline.py``), and a BGZF file (what ``bgzip`` writes, ``.gz`` or
``.bgz``) streams out of a pool of inflate threads while its compressed bytes
are hashed (``host/segments.BgzfInput``); on a CUDA device either streams into
page-locked memory, each segment's raw bytes go to the card, and the card
decodes them (``iter_card_chunks``, ``ops/fasta.py``). Other gzip files and
stdin are read whole and then pipelined with the host decode. The host
strategy decodes the whole input first. Uploads go through
a ring of pinned staging buffers. :func:`choose_tail` picks the readback
tail (``ops/readback.py``: the chased copy, unfold, write and hash), and
:func:`write_kin`, the sharded index's finish too, runs it: raw, a
fixed-width pack with escape patches, the sparse token stream, or, for a
sparse plane above ``PIECES_MIN_CELLS``, the arena-free pieces tail. The
verify re-reads the written file by O_DIRECT and counts it
(``index/verify.py``), starting as soon as the tail's writes have landed,
beside the output hash, and compares its stats with the in-memory ones
before the rename. With ``bgzip`` the finish then writes the `.kin` again
as `.kin.bgz` + `.gzi` (``index/bgzip.py``). The files are the JAX
package's, byte for byte, in every mode.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import sys
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import MAX_VAL, IndexConfig, resolve_chunk_windows, resolve_strategy
from ..formats import kin as kinfmt
from ..formats.header import KinHeader, stats_from_counts256
from ..io.direct import DirectWriter
from ..io.fasta import open_input_bytes
from ..utils.bigmem import big_zeros
from ..utils.checksum import sha256_file
from ..utils.profiling import StageTimer, device_trace, span
from .. import resolve_device
from ..host.chunks import chunk_stream, iter_chunks_packed_lazy
from ..host.decode import decode_joined_bytes
from ..host.pipeline import iter_card_chunks, iter_pipelined_chunks
from ..host.segments import BgzfInput, StreamingInput, read_bgzf
from ..ops.encode import canonical_codes_packed
from ..ops import packing
from ..ops.histogram import sort_codes_fast
from ..ops.readback import output_array, stream_plane_to_out, stream_sparse_pieces
from ..ops.sweep import accumulate_sorted
from .bgzip import write_bgzip
from .verify import FileVerifier

PRINT_EVERY = 25_000_000  # progress cadence in bp (as the JAX package)
# folded planes up to this many cells sort int32 codes, larger ones int64
# (a test lowers it to drive the int64 path at small K)
MAX_INT32_SORT_CELLS = np.iinfo(np.int32).max
STAGING_SLOTS = 3  # pinned host buffers the uploads rotate through
# a sparse readback of a folded plane above this many cells (K >= 17, where
# the JAX package splits the plane into 2^30-cell sub-planes) takes the
# arena-free pieces tail (a test lowers it to drive that tail at small K)
PIECES_MIN_CELLS = 1 << 30
# K at which readback="auto" on CUDA follows the JAX package's choice
# (choose_tail); everywhere else auto reads back raw
AUTO_JAX_RULE_K = frozenset({17})
# the readback tails this process's indexes took, by name: "raw", "2bit",
# "3bit", "packed", "sparse" or "pieces" (the arena-free tail); a program
# counter, as the kernels' LAUNCHES
TAILS: collections.Counter = collections.Counter()


def _have_native() -> bool:
    try:
        import pykmer_tpu_torch.io.native  # noqa: F401
    except ImportError:
        return False
    return True


def create_fasta_index(
    project_name: str,
    sample_name: str,
    input_file: str,
    kmer_len: int,
    overwrite: bool = True,
    config: Optional[IndexConfig] = None,
    verify: bool = True,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
    bgzip: bool = False,
) -> KinHeader:
    """Build one `.kin` index on ``device`` ('cuda' or, for tests, 'cpu').

    ``input_file`` may be ``"-"`` (or ``None``) to read the FASTA from stdin;
    outputs are then named after ``sample_name``. With ``bgzip`` the `.kin`
    is also written as `.kin.bgz` + `.gzi` (:func:`write_kin`). Returns the
    written header.
    """
    device = resolve_device(device)
    from_stdin = input_file is None or input_file == "-"
    have_native = _have_native()
    stages = StageTimer()
    hint = bgzf = None
    if not from_stdin and os.path.exists(input_file):
        hint = os.path.getsize(input_file)
        if input_file.endswith((".gz", ".bgz")):
            if have_native and hint > 0:
                # a BGZF file is read whole and walked here, for its size;
                # it streams below unless the route takes read_input
                with stages.stage("input read"):
                    bgzf = read_bgzf(input_file)
            # else a conservative decompression ratio for base data
            hint = bgzf.size if bgzf is not None else hint * 4
    config = resolve_chunk_windows(
        config or IndexConfig(kmer_len=kmer_len), device, input_hint_bytes=hint
    )
    _check_supported(config, kmer_len)

    name_stem = sample_name if from_stdin else input_file
    input_file = None if from_stdin else input_file
    header = KinHeader(
        project_name,
        input_file=name_stem,
        kmer_len=kmer_len,
        flush_every=config.flush_every,
        min_frag_size=config.min_frag_size,
        max_frag_size=config.max_frag_size,
    )
    header.stream_input = from_stdin
    data_size = header.data_size
    if verbose:
        print(
            f"project_name {project_name} sample_name {sample_name} "
            f"kmer_len {kmer_len:15,d} kmer_size {data_size:15,d}"
        )
    kinfmt.remove_outputs(name_stem, kmer_len, overwrite)

    free = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        free = torch.cuda.mem_get_info(device)[0]
    strategy = resolve_strategy(kmer_len, config.accumulate, device.type, free,
                                config.chunk_windows)
    plain = input_file is not None and not input_file.endswith((".gz", ".bgz"))
    streaming = strategy == "device" and have_native and (
        bgzf.size > 0 if bgzf is not None else plain and os.path.getsize(input_file) > 0)
    if not streaming:
        bgzf = None  # read_input reads the file again
    # a streaming input to a card is decoded there
    card = streaming and device.type == "cuda"

    timer = header.timer
    cw = config.chunk_windows
    # a torch.profiler trace of the pipeline, with the worker threads'
    # spans, when PYKMER_TPU_TRACE_DIR is set; no-op otherwise
    with device_trace(stages=stages), ThreadPoolExecutor(1) as hash_pool, \
            contextlib.ExitStack() as held:
        if streaming:
            # the reader (or inflate) and input-hash threads start here;
            # decode and uploads chase them
            with stages.stage("input read"):
                data = StreamingInput(input_file, card=device if card else None) \
                    if bgzf is None else BgzfInput(bgzf, card=device if card else None)
            del bgzf  # the compressed bytes live as long as the input
            held.callback(data.release)  # on an error too: the buffer is the pool's

            def input_checksum() -> str:
                # the input hash trails the read and runs beside the tail
                with span("input hash wait"):
                    input_hex = data.input_checksum()
                data.release()
                return input_hex
            pipelined = True
        else:
            data, input_ck = read_input(input_file, stages, hash_pool)
            input_checksum = input_ck.result
            pipelined = strategy == "device" and have_native and len(data) > 0

        if pipelined:
            sink: dict = {}
            with stages.stage("decode + accumulate (pipelined)"):
                chunks = iter_card_chunks(data, kmer_len, cw, sink, device) if card \
                    else iter_pipelined_chunks(data, kmer_len, cw, sink)
                plane, num_kmers = accumulate_device(chunks, kmer_len, cw, device)
            chromosomes, total_bp = sink["chromosomes"], sink["total_bp"]
        else:
            with stages.stage("fasta decode + join"):
                stream, chromosomes, total_bp = decode_joined_bytes(
                    data, kmer_len, tail_headroom=cw + kmer_len)
            if stream.shape[0] < kmer_len:
                raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
            with stages.stage("chunk framing"):
                padded, n_chunks = chunk_stream(stream, kmer_len, cw)
            chunks = iter_chunks_packed_lazy(padded, kmer_len, cw, n_chunks)
            with stages.stage(f"{strategy} accumulate"):
                accumulate = accumulate_device if strategy == "device" else accumulate_host
                plane, num_kmers = accumulate(chunks, kmer_len, cw, device)
            # every chunk is consumed: release the code stream's pooled
            # block before the output plane allocates
            del chunks, padded, stream
        if num_kmers == 0:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        if not streaming:
            # release the input before the output plane allocates; a
            # streaming input is still being hashed, and stays until the
            # metadata takes its checksum
            del data
        if verbose:
            print(f"  records {len(chromosomes):7,d} bp {total_bp:15,d}")
        if total_bp >= PRINT_EVERY:
            timer.update(total_bp)
        header.num_kmers = int(num_kmers)
        header.chromosomes = chromosomes

        tail = choose_tail(plane, kmer_len, config.readback, device, strategy, stages)
        write_kin(header, plane, tail, stages, verify, input_checksum, bgzip)

    report_stages(f"{strategy} strategy", stages, device)
    if verbose:
        print("done")
    return header


def read_input(input_file: Optional[str], stages: StageTimer,
               hash_pool: ThreadPoolExecutor) -> Tuple[object, Future]:
    """The whole (decompressed) input, ``None`` for stdin, read as the
    "input read" stage, and the future of its sha256 on ``hash_pool``, which
    overlaps the work after it (hashlib releases the GIL): plain files and
    stdin hash the bytes already in memory, a compressed input hashes its
    file."""
    with stages.stage("input read"):
        data = open_input_bytes(input_file)
    if input_file is not None and input_file.endswith((".gz", ".bgz")):
        return data, hash_pool.submit(sha256_file, os.path.abspath(input_file))
    return data, hash_pool.submit(lambda: hashlib.sha256(data).hexdigest())


def choose_tail(plane: torch.Tensor, kmer_len: int, readback: str, device: torch.device,
                strategy: str, stages: StageTimer) -> str:
    """The readback tail of the folded ``plane``: "raw", "2bit", "3bit",
    "packed", "sparse" (the token stream into the 4^K host array) or
    "pieces" (the arena-free tail, :func:`ops.readback.stream_sparse_pieces`).

    ``readback`` is ``IndexConfig.readback``. The host strategy, whose plane
    is already in host memory, reads back raw; so does "auto" on the CPU and
    on CUDA at every K outside ``AUTO_JAX_RULE_K``. Otherwise
    ``packing.pick_mode`` decides, on the plane's escape counts where it
    prices the modes (a stage "escape counts"); explicit modes stand. A
    sparse plane above ``PIECES_MIN_CELLS`` cells takes the pieces tail
    where, as the JAX package's gate asks, the sparse stream is priceable
    (``packing.sparse_viable``) and at most one cell in 8 is nonzero (here
    over the whole flat plane, where the JAX package asks it of each
    2^30-cell sub-plane); otherwise it stays the arena "sparse".

    ``AUTO_JAX_RULE_K`` holds the K at which the card's times
    (``chip_smoke.py`` phases 4b and 6b, PERF.md §6) showed the JAX
    package's choice no slower than raw. On an H100, with the smoke's 256
    Mbp genome: at K=15 its choice, the 2-bit plane, took 2.85-2.96 s
    against raw's 2.02-2.35 s, so auto stays raw; at K=17 its choice, the
    pieces tail, took 25.1-27.2 s against raw's 34.5-36.2 s, so auto
    follows it. Below K=15 the JAX rule reads back raw anyway (planes under
    2^26 cells)."""
    if strategy == "host" or readback == "auto" and not (
            device.type == "cuda" and kmer_len in AUTO_JAX_RULE_K):
        return "raw"
    cells = plane.shape[0]
    escapes = None
    if readback == "auto" and cells >= packing.AUTO_MIN_CELLS \
            or readback == "sparse" and cells > PIECES_MIN_CELLS:
        with stages.stage("escape counts"):
            escapes = packing.count_all_escapes(plane)
    tail = packing.pick_mode(plane, cells, readback, escapes)
    if tail == "sparse" and cells > PIECES_MIN_CELLS and packing.sparse_viable(cells) \
            and int(escapes[0]) <= cells // 8:
        return "pieces"
    return tail


def write_kin(header: KinHeader, plane: Union[torch.Tensor, Sequence[torch.Tensor]],
              tail: str, stages: StageTimer, verify: bool,
              input_checksum: Callable[[], str], bgzip: bool = False) -> None:
    """Write the folded ``plane`` as ``header``'s `.kin` through ``tail``
    (:func:`choose_tail`; a sharded run's list of local planes reads back
    "raw"), stamp its `.kin.json` and rename it into place; with ``bgzip``,
    then write the `.kin` as `.kin.bgz` + `.gzi` (the "bgzip" stage,
    ``index/bgzip.write_bgzip``: on a CUDA plane the card deflates, from the
    plane where it is one tensor), each renamed into place after the `.kin`.

    The tail writes and hashes the file (``ops/readback``). With ``verify``
    an ``index/verify.FileVerifier``, which the tail's sink starts once the
    file's writes have landed, reads the file back beside the output hash;
    the "verify" stage compares its stats with the in-memory ones before the
    rename. ``input_checksum()`` runs inside the "metadata" stage. The tail
    is counted in ``TAILS``."""
    tmp, size, kmer_len = header.index_tmp_file, header.data_size, header.kmer_len
    TAILS[tail] += 1
    verifier = FileVerifier(tmp, size) if verify else None
    try:
        if tail == "pieces":
            # no 4^K host array: each segment's pieces are written and hashed
            with DirectWriter(tmp, size=size) as fd:
                counts, output_ck = stream_sparse_pieces(plane, kmer_len, fd, tmp,
                                                         stages=stages, verifier=verifier)
        else:
            with output_array(plane, tail, size, stages) as out, \
                    DirectWriter(tmp, size=size) as fd:
                counts, output_ck = stream_plane_to_out(plane, kmer_len, out, fd,
                                                        stages=stages, mode=tail,
                                                        verifier=verifier)
            del out
        # each folded cell adds its value plus exactly one structural zero
        # (its non-canonical partner) to the full plane's histogram
        counts[0] += size // 2
        with stages.stage("metadata"):
            header.write_metadata(tmp, stats_counts256=counts,
                                  input_checksum=input_checksum(),
                                  output_checksum=output_ck)
        if verifier is not None:
            # the end-to-end invariant: stats derived from the written file
            # must equal the in-memory ones
            with stages.stage("verify"):
                fresh = stats_from_counts256(verifier.result())
                if fresh["hist"] != header.hist or fresh["vals_sum"] != header.vals_sum:
                    raise AssertionError("written .kin does not match computed stats")
    except BaseException:
        if verifier is not None:
            verifier.close()  # no read outlives the index
        raise
    os.rename(tmp, header.index_file_root)
    if bgzip:
        # a single plane is the whole folded plane, which the card deflate
        # unfolds again; a sharded run's local planes are read back from the
        # file. write_bgzip picks the route from the device; a CPU plane
        # calls it with the two arguments the host route has always taken
        # (kbench's fault tests stand in for it with that signature)
        whole = plane if isinstance(plane, torch.Tensor) else None
        device = (plane if whole is not None else plane[0]).device
        card = () if device.type == "cpu" else (device, whole)
        with stages.stage("bgzip"):
            write_bgzip(header.index_file_root, size, *card)


def report_stages(title: str, stages: StageTimer, device: torch.device) -> None:
    """End an index's run: with ``PYKMER_TPU_STAGE_TIMING`` set, print its
    stage table to stderr under "stage timing (``title``):", and the peak
    memory of a CUDA ``device``; then hand its spans to the recorder's
    readers (``StageTimer.finish``)."""
    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        report = f"stage timing ({title}):\n" + stages.report()
        if device.type == "cuda":
            report += (f"\n  device peak memory: "
                       f"{torch.cuda.max_memory_allocated(device)} bytes")
        print(report, file=sys.stderr)
    stages.finish()


def _check_supported(config: IndexConfig, kmer_len: int) -> None:
    if config.kmer_len != kmer_len:
        raise ValueError(f"config.kmer_len {config.kmer_len} != kmer_len {kmer_len}")
    if config.readback not in ("auto", *packing.MODES):
        raise ValueError(f"readback={config.readback!r}: not one of auto, "
                         f"{', '.join(packing.MODES)}")
    if config.kernel != "auto":
        raise ValueError(
            f"kernel={config.kernel!r}: the port has one sweep, chosen by the "
            "plane's device; leave kernel='auto'"
        )


def chunk_sorted_codes(
    bases2: torch.Tensor,
    maskbits: Optional[torch.Tensor],
    kmer_len: int,
    span: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step A of one chunk: (sorted folded codes, number of valid windows as
    a 0-d int64 tensor on the chunk's device).

    ``maskbits`` None marks an all-valid chunk (no Ns, separators or
    padding), which skips the mask upload. On CUDA the encode is the packed
    kernel (``ops/encode.canonical_codes_packed``), which counts the valid
    windows as it writes their codes. The codes sort as int32 while the
    folded plane has at most ``MAX_INT32_SORT_CELLS`` cells (K <= 15), as
    int64 beyond."""
    fold_size = 4**kmer_len // 2
    nvalid = torch.zeros((), dtype=torch.int64, device=bases2.device)
    codes = canonical_codes_packed(bases2, maskbits, span, kmer_len, count=nvalid)
    sort_dt = torch.int32 if fold_size <= MAX_INT32_SORT_CELLS else torch.int64
    return sort_codes_fast(codes.to(sort_dt)), nvalid


class ChunkUploader:
    """Host→device copies of packed chunks.

    On CUDA each chunk is staged in one of ``STAGING_SLOTS`` pinned host
    buffers and copied with ``non_blocking=True`` on the current stream, so
    the host stages the next chunk while the card copies and computes. An event
    recorded after a slot's copies guards the slot: it is refilled only once
    that event has completed. On the CPU the chunk's arrays are wrapped
    without a copy. Chunks that are tensors already (the card decode's views,
    ``host/pipeline.iter_card_chunks``) pass through."""

    def __init__(self, device: torch.device, kmer_len: int, chunk_windows: int):
        self.device = device
        self.slots = []
        self.next = 0
        if device.type == "cuda":
            span = chunk_windows + kmer_len - 1
            self.slots = [
                (torch.empty((span + 3) // 4, dtype=torch.uint8, pin_memory=True),
                 torch.empty((span + 7) // 8, dtype=torch.uint8, pin_memory=True),
                 torch.cuda.Event())
                for _ in range(STAGING_SLOTS)
            ]

    def __call__(
        self, bases2: np.ndarray, maskbits: Optional[np.ndarray]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if isinstance(bases2, torch.Tensor):
            return bases2, maskbits
        if not self.slots:
            return (torch.from_numpy(bases2),
                    None if maskbits is None else torch.from_numpy(maskbits))
        pin_b, pin_m, done = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        with span("upload slot wait"):
            done.synchronize()  # the slot's previous copies have landed
        dev_b = self._copy(pin_b, bases2)
        dev_m = None if maskbits is None else self._copy(pin_m, maskbits)
        # on the stream of the copies' card, which need not be the current one
        done.record(torch.cuda.current_stream(self.device))
        return dev_b, dev_m

    def _copy(self, pinned: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
        n = arr.shape[0]
        if n > pinned.shape[0]:
            raise ValueError(f"chunk of {n} bytes exceeds its {pinned.shape[0]}-byte slot")
        with span("upload stage", bytes=n):
            pinned.numpy()[:n] = arr
        dev = torch.empty(n, dtype=torch.uint8, device=self.device)
        return dev.copy_(pinned[:n], non_blocking=True)


def accumulate_device(
    chunks: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    kmer_len: int,
    chunk_windows: int,
    device: torch.device,
) -> Tuple[torch.Tensor, int]:
    """Steps A and B over every packed chunk: returns (folded plane on
    ``device``, number of k-mers). The plane and the counter stay on the
    device; the count is read once at the end."""
    span = chunk_windows + kmer_len - 1
    upload = ChunkUploader(device, kmer_len, chunk_windows)
    plane = torch.zeros(4**kmer_len // 2, dtype=torch.uint8, device=device)
    nk = torch.zeros((), dtype=torch.int64, device=device)
    for bases2, maskbits in chunks:
        dev_b, dev_m = upload(bases2, maskbits)
        sorted_codes, nvalid = chunk_sorted_codes(dev_b, dev_m, kmer_len, span)
        nk += nvalid
        accumulate_sorted(plane, sorted_codes)
    return plane, int(nk)


def accumulate_host(
    chunks: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    kmer_len: int,
    chunk_windows: int,
    device: torch.device,
) -> Tuple[torch.Tensor, int]:
    """Step A on ``device`` per chunk; the sorted codes come back and the host
    applies the saturating update to a folded plane in host RAM. Returns
    (the plane as a CPU tensor over that memory, number of k-mers)."""
    span = chunk_windows + kmer_len - 1
    fold_size = 4**kmer_len // 2
    upload = ChunkUploader(device, kmer_len, chunk_windows)
    dense = big_zeros(fold_size)
    num_kmers = 0
    for bases2, maskbits in chunks:
        dev_b, dev_m = upload(bases2, maskbits)
        sorted_codes, _ = chunk_sorted_codes(dev_b, dev_m, kmer_len, span)
        codes = sorted_codes.cpu().numpy()
        # sorted, so the valid codes (< the folded sentinel) are a prefix
        valid = codes[: np.searchsorted(codes, fold_size)]
        num_kmers += int(valid.shape[0])
        if valid.shape[0] == 0:
            continue
        uniq, counts = unique_sorted(valid)
        old = dense[uniq].astype(np.int64)
        dense[uniq] = np.minimum(old + np.minimum(counts, MAX_VAL), MAX_VAL).astype(np.uint8)
    return torch.from_numpy(dense), num_kmers


def unique_sorted(sorted_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(return_counts=True)`` of an already-sorted array."""
    is_start = np.empty(sorted_vals.shape[0], dtype=bool)
    is_start[0] = True
    np.not_equal(sorted_vals[1:], sorted_vals[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    counts = np.diff(np.append(starts, sorted_vals.shape[0]))
    return sorted_vals[starts], counts
