"""The single-device index path: FASTA → `.kin` + `.kin.json`.

Port of the device strategy of ``pykmer_tpu/index/indexer.py``. The host
decodes the whole input into one joined base-code stream, frames it into
fixed-size overlapping chunks and packs each to 2-bit bases (+ a validity
bitmap when the chunk holds Ns, separators or padding). Per chunk the device
runs step A (unpack, canonical encode, fold, keys-only sort, valid-window
count) and step B (the saturating sweep into the folded uint8 plane, which
stays on the device for the whole run, as does the k-mer counter). One
device-to-host copy, the unfold, the write + sha256, the stats and the verify
pass finish the run. The files are the JAX package's, byte for byte.

Not ported yet (see ROADMAP.md): the overlapped streaming input pipeline,
K >= 17 and the host accumulate strategy.
"""

from __future__ import annotations

import hashlib
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from pykmer_tpu.config import IndexConfig
from pykmer_tpu.formats import kin as kinfmt
from pykmer_tpu.formats.header import KinHeader, fast_counts256
from pykmer_tpu.io.direct import DirectWriter
from pykmer_tpu.io.fasta import open_input_bytes
from pykmer_tpu.utils.bigmem import big_empty
from pykmer_tpu.utils.checksum import sha256_file
from pykmer_tpu.utils.profiling import StageTimer

from .. import resolve_device
from ..config import resolve_chunk_windows
from ..host.chunks import chunk_stream, iter_chunks_packed_lazy
from ..host.decode import decode_joined_bytes
from ..ops.encode import (
    canonical_codes,
    fold_codes,
    unpack_base_2bit,
    unpack_base_2bit_mask,
)
from ..ops.histogram import sort_codes_fast
from ..ops.readback import fetch_plane, unfold_canonical, write_and_hash
from ..ops.sweep import accumulate_sorted

PRINT_EVERY = 25_000_000  # progress cadence in bp (as the JAX package)
MAX_KMER_LEN = 15  # the folded plane of K <= 15 indexes in int32


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
) -> KinHeader:
    """Build one `.kin` index on ``device`` ('cuda' or, for tests, 'cpu').

    ``input_file`` may be ``"-"`` (or ``None``) to read the FASTA from stdin;
    outputs are then named after ``sample_name``. Returns the written header.
    """
    device = resolve_device(device)
    from_stdin = input_file is None or input_file == "-"
    hint = None
    if not from_stdin and os.path.exists(input_file):
        hint = os.path.getsize(input_file)
        if input_file.endswith((".gz", ".bgz")):
            hint *= 4  # conservative decompression ratio for base data
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

    stages = StageTimer()
    timer = header.timer
    with stages.stage("input read"):
        data = open_input_bytes(input_file)
    plain = input_file is not None and not input_file.endswith((".gz", ".bgz"))

    def hash_input() -> str:
        # plain files and stdin hash the bytes already in memory; a
        # compressed input hashes its file
        if plain or from_stdin:
            return hashlib.sha256(data).hexdigest()
        return sha256_file(header.input_file_path)

    tmp = header.index_tmp_file
    # the input checksum overlaps the device work (hashlib releases the GIL)
    with ThreadPoolExecutor(1) as pool:
        input_ck = pool.submit(hash_input)
        with stages.stage("fasta decode + join"):
            stream, chromosomes, total_bp = decode_joined_bytes(
                data, kmer_len, tail_headroom=config.chunk_windows + kmer_len
            )
        if stream.shape[0] < kmer_len:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        with stages.stage("chunk framing"):
            padded, n_chunks = chunk_stream(stream, kmer_len, config.chunk_windows)
        with stages.stage("device accumulate"):
            plane, num_kmers = accumulate_device(
                iter_chunks_packed_lazy(
                    padded, kmer_len, config.chunk_windows, n_chunks
                ),
                kmer_len, config.chunk_windows, device,
            )
        del padded, stream
        if num_kmers == 0:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        if verbose:
            print(f"  records {len(chromosomes):7,d} bp {total_bp:15,d}")
        if total_bp >= PRINT_EVERY:
            timer.update(total_bp)
        header.num_kmers = int(num_kmers)
        header.chromosomes = chromosomes

        with stages.stage("fetch + unfold + write"):
            folded = fetch_plane(plane)
            del plane
            # each folded cell adds its value plus exactly one structural
            # zero (its non-canonical partner) to the full plane's histogram
            counts = fast_counts256(folded).copy()
            counts[0] += data_size // 2
            out = big_empty(data_size)
            unfold_canonical(folded, kmer_len, out=out)
            del folded
            with DirectWriter(tmp, size=data_size) as fd:
                output_ck = write_and_hash(fd, out)
            del out
        with stages.stage("metadata"):
            header.write_metadata(
                tmp,
                stats_counts256=counts,
                input_checksum=input_ck.result(),
                output_checksum=output_ck,
            )
    del data

    if verify:
        # the end-to-end invariant: stats derived from the written file must
        # equal the in-memory ones
        with stages.stage("verify"):
            fresh = KinHeader(project_name, input_file=name_stem, kmer_len=kmer_len)
            fresh.update_stats_from_file(tmp)
            if fresh.hist != header.hist or fresh.vals_sum != header.vals_sum:
                raise AssertionError("written .kin does not match computed stats")

    os.rename(tmp, header.index_file_root)
    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        print("stage timing:\n" + stages.report(), file=sys.stderr)
    if verbose:
        print("done")
    return header


def _check_supported(config: IndexConfig, kmer_len: int) -> None:
    if config.kmer_len != kmer_len:
        raise ValueError(f"config.kmer_len {config.kmer_len} != kmer_len {kmer_len}")
    if kmer_len > MAX_KMER_LEN:
        raise NotImplementedError(
            f"K={kmer_len}: the port indexes K <= {MAX_KMER_LEN} so far "
            "(ROADMAP.md, queue 1: 'K=17 on one GPU and the host strategy')"
        )
    if config.accumulate not in ("auto", "device"):
        raise NotImplementedError(
            f"accumulate={config.accumulate!r}: only the device strategy is "
            "ported (ROADMAP.md, queue 1: 'K=17 on one GPU and the host strategy')"
        )
    if config.readback not in ("auto", "raw"):
        raise NotImplementedError(
            f"readback={config.readback!r}: only the raw readback is ported "
            "(ROADMAP.md, queue 1: 'readback modes')"
        )
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
    padding), which skips the mask upload and unpack."""
    fold_size = 4**kmer_len // 2
    chunk = unpack_base_2bit(bases2, span) if maskbits is None \
        else unpack_base_2bit_mask(bases2, maskbits, span)
    codes = fold_codes(canonical_codes(chunk, kmer_len), kmer_len)
    nvalid = (codes < fold_size).sum(dtype=torch.int64)
    sort_dt = torch.int32 if fold_size <= np.iinfo(np.int32).max else torch.int64
    return sort_codes_fast(codes.to(sort_dt)), nvalid


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
    plane = torch.zeros(4**kmer_len // 2, dtype=torch.uint8, device=device)
    nk = torch.zeros((), dtype=torch.int64, device=device)
    for bases2, maskbits in chunks:
        dev_b = torch.from_numpy(bases2).to(device)
        dev_m = None if maskbits is None else torch.from_numpy(maskbits).to(device)
        sorted_codes, nvalid = chunk_sorted_codes(dev_b, dev_m, kmer_len, span)
        nk += nvalid
        accumulate_sorted(plane, sorted_codes)
    return plane, int(nk)
