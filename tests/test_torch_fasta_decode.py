"""The card decode's plain torch version (``ops/fasta.decode_packed`` on CPU
tensors) against the native host decoder, and the card path's pipeline
(``host/pipeline.iter_card_chunks``) against the host path, on the CPU.

The plain version is what the CUDA kernel (``csrc/fasta.cu``) is held
against on the card (test_torch_cuda.py); here it is held against
``io.native.fasta_decode_joined_packed_native`` bit for bit: both planes,
their length, ``n_codes``, and every record's name, ``seq_len`` and
``has_valid`` as the native entry point reports them."""

import functools

import numpy as np
import pytest
import torch

from conftest import make_random_fasta
from fasta_cases import CASES, case_bytes

from pykmer_tpu_torch.host import pipeline
from pykmer_tpu_torch.host.segments import StreamingInput
from pykmer_tpu_torch.index.indexer import accumulate_device
from pykmer_tpu_torch.io import native
from pykmer_tpu_torch.ops import fasta

HEADROOM = 4096 + 15 + 8


def native_records(buf, kmer_len):
    """Every record of the native packed decode (the entry point that
    ``fasta_decode_joined_packed_native`` wraps, which keeps only the
    records with a valid window): (name offsets, name lengths, seq_len,
    has_valid)."""
    n = buf.shape[0]
    max_recs = int((buf == ord(">")).sum()) + 1
    cap8 = (n + max_recs * (kmer_len - 1 + 8) + 16 + 7) & ~7
    scratch = np.empty(cap8, np.uint8)
    bases, mask = np.zeros(cap8 // 4, np.uint8), np.zeros(cap8 // 8, np.uint8)
    seq_len, name_off, name_len = (np.zeros(max_recs, np.int64) for _ in range(3))
    has_valid = np.zeros(max_recs, np.uint8)
    out_len = np.zeros(1, np.int64)
    n_recs = native._lib.fasta_decode_joined_packed_mt(
        buf.ctypes.data if n else None, n, kmer_len, bases.ctypes.data, mask.ctypes.data,
        seq_len.ctypes.data, has_valid.ctypes.data, name_off.ctypes.data,
        name_len.ctypes.data, max_recs, out_len.ctypes.data, 2, scratch.ctypes.data)
    assert n_recs >= 0
    return name_off[:n_recs], name_len[:n_recs], seq_len[:n_recs], has_valid[:n_recs]


def assert_matches_native(data, kmer_len, got):
    """``got`` (a ``fasta.Decoded``, on any device) equals the native
    decode of ``data``."""
    buf = np.frombuffer(data, np.uint8)
    bases, mask, n_codes, chroms, total_bp = native.fasta_decode_joined_packed_native(
        buf, kmer_len, threads=2, tail_headroom=HEADROOM)
    assert got.n_codes == n_codes
    assert torch.equal(got.bases.cpu(), torch.from_numpy(bases))
    assert torch.equal(got.mask.cpu(), torch.from_numpy(mask))
    off, length, seq_len, has_valid = native_records(buf, kmer_len)
    assert got.name_off.cpu().tolist() == off.tolist()
    assert got.name_len.cpu().tolist() == length.tolist()
    assert got.seq_len.cpu().tolist() == seq_len.tolist()
    assert got.has_valid.cpu().tolist() == has_valid.tolist()
    named = [(data[o : o + n].decode(errors="replace"), s)
             for o, n, s, v in zip(off, length, seq_len, has_valid) if v]
    assert named == chroms and int(seq_len.sum()) == total_bp


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_decode_matches_native(case):
    data = case_bytes(case)
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(0, dtype=torch.uint8)
    launches = fasta.LAUNCHES
    for kmer_len in ((15,) if len(data) > (1 << 20) else (1, 5, 15, 31)):
        assert_matches_native(data, kmer_len, fasta.decode_packed(raw, kmer_len, HEADROOM))
    assert fasta.LAUNCHES == launches  # the CPU path launches nothing


def test_decode_rejects_bad_input():
    with pytest.raises(ValueError, match="contiguous 1-D uint8"):
        fasta.decode_packed(torch.zeros(8, dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="kmer_len"):
        fasta.decode_packed(torch.zeros(8, dtype=torch.uint8), 32)


@pytest.mark.parametrize("kmer_len,chunk_windows", [(5, 512), (11, 4096)])
def test_card_path_pipeline_matches_host_path(tmp_path, kmer_len, chunk_windows):
    """A multi-segment streaming input through the card path's pipeline
    (the plain decode on the CPU) gives the host path's folded plane,
    num_kmers, records and total_bp."""
    fasta_path = make_random_fasta(str(tmp_path / "c.fa"), np.random.default_rng(kmer_len),
                                   n_records=40, lengths=(5000, 1333, 17, 0, 670))
    cpu = torch.device("cpu")
    got = []
    for path in (functools.partial(pipeline.iter_card_chunks, device=cpu),
                 pipeline.iter_pipelined_chunks):
        data = StreamingInput(fasta_path, extent=4099)
        sink = {}
        chunks = path(data, kmer_len, chunk_windows, sink, target_segment=15000)
        plane, num_kmers = accumulate_device(chunks, kmer_len, chunk_windows, cpu)
        got.append((plane, num_kmers, sink["chromosomes"], sink["total_bp"]))
        data.release()
    (p0, n0, c0, t0), (p1, n1, c1, t1) = got
    assert torch.equal(p0, p1) and n0 == n1 > 0
    assert c0 == c1 and len(c0) > 20 and t0 == t1


def test_release_stops_the_reader_mid_read(tmp_path, monkeypatch):
    """``StreamingInput.release`` ends the reader at its next extent and the
    hasher with it (the buffer may then go back to its pool); a second call
    does nothing."""
    import time

    from pykmer_tpu_torch.io import direct

    fasta_path = make_random_fasta(str(tmp_path / "r.fa"), np.random.default_rng(3),
                                   n_records=20, lengths=(5000,))
    real = direct.pread_into_mt

    def slow(rd, dst, pos, **kw):
        time.sleep(0.01)  # 400 extents: 4 s to read it all
        return real(rd, dst, pos, **kw)

    monkeypatch.setattr(direct, "pread_into_mt", slow)
    data = StreamingInput(fasta_path, extent=256)
    t = time.perf_counter()
    data.release()
    assert time.perf_counter() - t < 1.0
    assert not data._reader.is_alive() and not data._hasher.is_alive()
    assert data.buf is None and data.filled() < data.size
    data.release()


def test_pinned_pool_leases_one_buffer(monkeypatch):
    """The page-locked pool (here with a stand-in for the page-locked
    buffer, which needs a card) lends its one buffer to one input at a
    time, refuses a second lease, reuses the buffer for an input of no
    larger size and replaces it for a larger one."""
    from pykmer_tpu_torch.host import segments

    made = []

    class Buffer:
        def __init__(self, size):
            self.size, self.freed = size, False
            made.append(self)

        def free(self):
            self.freed = True

    monkeypatch.setattr(segments, "_Pinned", Buffer)
    pool = segments._PinnedPool()
    first = pool.lease(100)
    with pytest.raises(RuntimeError, match="leased"):
        pool.lease(10)
    pool.give_back()
    assert pool.lease(50) is first
    pool.give_back()
    larger = pool.lease(200)
    assert larger is not first and first.freed and not larger.freed
    assert [b.size for b in made] == [100, 200]
