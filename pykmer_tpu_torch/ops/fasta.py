"""FASTA bytes to the packed upload planes, on the device that holds them.

The card's decode of the streaming input (``host/pipeline.iter_card_chunks``):
one record-aligned segment of raw FASTA bytes becomes the 2-bit base plane
and the validity plane that the encode kernel reads, and the segment's
record table. The planes are bit-identical to those of the native host
decoder, ``io.native.fasta_decode_joined_packed_native``, and of the same
length; the records are its records: each line stripped of leading and
trailing space, ``\\t``, ``\\r``, VT and FF; a line whose first kept byte is
``>`` a header, the rest of the line its name; text before the first header
dropped; every other kept byte through the A/C/G/T table (either case), any
other byte invalid; the records joined with K-1 invalid codes between them,
zero (= invalid) past the stream with tail capacity for chunk framing.

On a CUDA tensor :func:`decode_packed` launches the hand-written kernels of
``csrc/fasta.cu`` and waits once, for the segment's totals, which size the
planes and the record table; on a CPU tensor it runs the plain torch version
in this module. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

MAX_K = 31

# decodes launched on the card in this process (one a segment, each six
# kernels); a run resets it to 0 to show that its main path went through
# them (the CPU path does not count)
LAUNCHES = 0

_SPACE = (ord(" "), ord("\t"), ord("\r"), 0x0B, 0x0C)


class Decoded(NamedTuple):
    """One segment decoded: the planes (uint8, bases2 and maskbits of
    ``host.chunks.pack_base_stream``'s layout), the joined stream's length,
    and per record, in order, its name's offset and length in the segment's
    bytes, its ``seq_len`` and ``has_valid`` (int64, int64, int64, uint8),
    all on the segment's device."""

    bases: torch.Tensor
    mask: torch.Tensor
    n_codes: int
    name_off: torch.Tensor
    name_len: torch.Tensor
    seq_len: torch.Tensor
    has_valid: torch.Tensor


def plane_bytes(n: int, n_gt: int, kmer_len: int, tail_headroom: int) -> Tuple[int, int]:
    """(bases, mask) plane lengths of a segment of ``n`` bytes holding
    ``n_gt`` '>' bytes: the native decoder's worst case (every byte a base,
    an aligned separator a possible record) plus the framing headroom."""
    cap = n + (n_gt + 1) * (kmer_len - 1 + 8) + tail_headroom + 16
    cap8 = (cap + 7) & ~7
    return cap8 // 4, cap8 // 8


def decode_packed(raw: torch.Tensor, kmer_len: int, tail_headroom: int = 0) -> Decoded:
    """Decode ``raw`` (a contiguous 1-D uint8 tensor: one segment of FASTA
    whose records all start in it) at ``kmer_len``; the planes have room for
    chunk framing up to ``n_codes + tail_headroom`` codes."""
    global LAUNCHES
    if raw.dtype != torch.uint8 or raw.dim() != 1 or not raw.is_contiguous():
        raise ValueError(f"raw must be a contiguous 1-D uint8 tensor, got {raw.dtype} "
                         f"{tuple(raw.shape)} contiguous={raw.is_contiguous()}")
    if not 1 <= kmer_len <= MAX_K:
        raise ValueError(f"kmer_len must be in 1..{MAX_K}, got {kmer_len}")
    if raw.device.type == "cpu":
        return decode_packed_plain(raw, kmer_len, tail_headroom)
    if raw.device.type != "cuda":
        raise ValueError(f"no FASTA decode for device {raw.device}")
    from ._build import load

    lib = load()
    dev, n, k = raw.device, raw.shape[0], kmer_len
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = torch.empty(lib.pykmer_fasta_workspace(n), dtype=torch.uint8, device=dev)
    totals = torch.empty(3, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pykmer_fasta_scan(raw.data_ptr(), n, k, ws.data_ptr(), totals.data_ptr(),
                                    stream)
    if err != 0:
        raise RuntimeError(f"FASTA decode (scan) launch failed: cudaError_t {err}")
    kept, n_recs, n_gt = totals.tolist()  # the segment's one wait
    n_codes = kept + (k - 1) * (n_recs - 1) if n_recs else 0
    nb, nm = plane_bytes(n, n_gt, k, tail_headroom)
    bases = torch.zeros(nb, dtype=torch.uint8, device=dev)
    mask = torch.zeros(nm, dtype=torch.uint8, device=dev)
    name_off = torch.empty(n_recs, dtype=torch.int64, device=dev)
    rec_start = torch.empty(n_recs, dtype=torch.int64, device=dev)
    name_end = torch.zeros(n_recs, dtype=torch.int64, device=dev)
    has_valid = torch.zeros(n_recs, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.pykmer_fasta_write(
            raw.data_ptr(), n, k, ws.data_ptr(), bases.data_ptr(), nb, mask.data_ptr(), nm,
            n_codes, n_recs, name_off.data_ptr(), name_end.data_ptr(), rec_start.data_ptr(),
            has_valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"FASTA decode (write) launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return Decoded(bases, mask, n_codes, name_off, name_end - name_off,
                   seq_lengths(rec_start, n_codes, k), has_valid)


def seq_lengths(rec_start: torch.Tensor, n_codes: int, kmer_len: int) -> torch.Tensor:
    """Each record's kept bytes from the records' first codes: the next
    record's first code less the K-1 separator, or the stream's end."""
    end = torch.full((1,), n_codes + kmer_len - 1, dtype=rec_start.dtype,
                     device=rec_start.device)
    return torch.diff(rec_start, append=end) - (kmer_len - 1)


def decode_packed_plain(raw: torch.Tensor, kmer_len: int, tail_headroom: int = 0) -> Decoded:
    """:func:`decode_packed` as torch ops on any device: each line's first
    and last kept byte by a scatter over line numbers, the kept bytes'
    places in the joined stream by a cumulative sum, the planes by an
    index_add of disjoint bits, ``has_valid`` from the windows of K valid
    codes."""
    k, n, dev = kmer_len, raw.shape[0], raw.device
    i64 = torch.int64
    nb, nm = plane_bytes(n, int((raw == ord(">")).sum()), k, tail_headroom)
    bases = torch.zeros(nb, dtype=i64, device=dev)
    mask = torch.zeros(nm, dtype=i64, device=dev)
    nl = raw == ord("\n")
    space = torch.zeros_like(nl)
    for c in _SPACE:
        space |= raw == c
    byte = torch.nonzero(~(space | nl)).reshape(-1)  # the lines' non-space bytes
    line = torch.cumsum(nl, 0) - nl.to(i64)  # a '\n' ends the line it is in
    n_lines = int(nl.sum()) + 1
    lines_of = line[byte]
    first = torch.full((n_lines,), n, dtype=i64, device=dev) \
        .scatter_reduce_(0, lines_of, byte, "amin")
    last = torch.full((n_lines,), -1, dtype=i64, device=dev) \
        .scatter_reduce_(0, lines_of, byte, "amax")
    has = last >= 0
    header = has & (raw[first.clamp(max=max(n - 1, 0))] == ord(">")) if n else has
    before = torch.cumsum(header, 0) - header.to(i64)  # header lines before each line
    seq_line = has & ~header & (before > 0)
    idx = torch.arange(n, device=dev)
    kept = seq_line[line] & (idx >= first[line]) & (idx <= last[line])
    at = torch.nonzero(kept).reshape(-1)
    rec = before[line[at]] - 1  # each kept byte's record
    pos = torch.arange(at.shape[0], device=dev) + (k - 1) * rec
    hdr = torch.nonzero(header).reshape(-1)
    n_recs = hdr.shape[0]
    n_codes = at.shape[0] + (k - 1) * (n_recs - 1) if n_recs else 0
    lut = torch.full((256,), 4, dtype=i64, device=dev)
    for code, letters in enumerate(("Aa", "Cc", "Gg", "Tt")):
        for c in letters:
            lut[ord(c)] = code
    codes = lut[raw[at].to(i64)]
    ok = codes < 4
    vpos, vcodes = pos[ok], codes[ok]
    bases.index_add_(0, vpos >> 2, vcodes << (2 * (vpos & 3)))
    mask.index_add_(0, vpos >> 3, torch.ones_like(vpos) << (vpos & 7))
    # each record's first code: the kept bytes before its header, and its
    # separators
    cum = torch.cumsum(kept, 0) - kept.to(i64)
    rec_start = cum[first[hdr]] + (k - 1) * torch.arange(n_recs, device=dev) \
        if n_recs else torch.zeros(0, dtype=i64, device=dev)
    has_valid = torch.zeros(n_recs, dtype=torch.uint8, device=dev)
    if n_codes >= k and vpos.shape[0]:
        valid = torch.zeros(n_codes + 1, dtype=i64, device=dev)
        valid[vpos + 1] = 1
        run = torch.cumsum(valid, 0)
        starts = torch.nonzero(run[k:] - run[:-k] == k).reshape(-1)
        owner = torch.searchsorted(rec_start, starts, right=True) - 1
        has_valid[owner] = 1
    return Decoded(bases.to(torch.uint8), mask.to(torch.uint8), n_codes,
                   first[hdr] + 1, last[hdr] - first[hdr],
                   torch.bincount(rec, minlength=n_recs)[:n_recs] if n_recs
                   else torch.zeros(0, dtype=i64, device=dev), has_valid)
