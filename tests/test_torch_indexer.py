"""The port's index path on the CPU vs ``pykmer_tpu.index`` (JAX).

Both packages index the same seeded FASTA; the `.kin` must be byte-identical
and the `.kin.json` equal apart from the wall-clock provenance keys. The
port's copies of the JAX package's numpy host helpers must equal the
originals.
"""

import gzip
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu.config import IndexConfig
from pykmer_tpu.index import create_fasta_index as jax_create
from pykmer_tpu.index import indexer as jix
from pykmer_tpu.ops import encode as jenc
from pykmer_tpu.ops import readback as jrb
import pykmer_tpu_torch
from pykmer_tpu_torch import cli
from pykmer_tpu_torch.config import resolve_chunk_windows
from pykmer_tpu_torch.host import chunks as tch
from pykmer_tpu_torch.host import decode as tdec
from pykmer_tpu_torch.ops import readback as trb


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _outputs(header):
    kin = _read(header.index_file_root)
    with open(header.metadata_file) as fh:
        meta = json.load(fh)
    os.remove(header.index_file_root)
    os.remove(header.metadata_file)
    return kin, meta


def _assert_same(jax_out, port_out):
    (kin_j, meta_j), (kin_t, meta_t) = jax_out, port_out
    assert kin_t == kin_j, ".kin differs from the JAX package's"
    assert set(meta_t) == set(meta_j)
    for key in meta_j:
        if key not in VOLATILE_KIN_JSON_KEYS:
            assert meta_t[key] == meta_j[key], key


def _index_both(fasta, kmer_len, chunk_windows, sample="s"):
    cfg = IndexConfig(kmer_len=kmer_len, chunk_windows=chunk_windows)
    j = _outputs(jax_create(fasta, sample, fasta, kmer_len, config=cfg, verbose=False))
    h = pykmer_tpu_torch.create_fasta_index(
        fasta, sample, fasta, kmer_len, config=cfg, verbose=False, device="cpu")
    _assert_same(j, _outputs(h))
    return h


def _messy_fasta(path, rng):
    """Empty record, all-N record, a record shorter than K, an N-split
    record, lowercase, and a repeat that saturates (> 255 copies)."""
    seq = "".join(rng.choice(list("ACGT"), size=900))
    rep = "ACGTTGCA" * 400
    with open(path, "w") as fh:
        fh.write(">empty\n>alln\n" + "N" * 50 + "\n>short\nACG\n")
        fh.write(f">split\n{seq[:300]}NNNNN{seq[300:].lower()}\n")
        fh.write(f">repeat\n{rep}\n>tail\n{seq[::-1]}\n")
    return path


@pytest.mark.parametrize("kmer_len,chunk_windows,gz", [
    (5, 64, False), (7, 128, True), (11, 256, False), (11, 512, True),
])
def test_index_random_matches_jax(tmp_path, kmer_len, chunk_windows, gz):
    rng = np.random.default_rng(kmer_len)
    name = "r.fa.gz" if gz else "r.fa"
    fasta = make_random_fasta(str(tmp_path / name), rng, n_records=6,
                              lengths=(400, 33, 4, 1900, 120, 77), gzip_out=gz)
    _index_both(fasta, kmer_len, chunk_windows)


@pytest.mark.parametrize("kmer_len", [5, 7, 11])
def test_index_all_valid_chunks_match_jax(tmp_path, kmer_len):
    """One clean record over many chunks: interior chunks are all-valid (the
    JAX package's packed encoder, the port's mask-free step A), the padded
    tail is masked."""
    rng = np.random.default_rng(100 + kmer_len)
    fasta = make_random_fasta(str(tmp_path / "clean.fa"), rng, n_records=1,
                              lengths=(5000,), with_n=False)
    _index_both(fasta, kmer_len, 1000)


@pytest.mark.parametrize("kmer_len", [5, 7, 11])
def test_index_messy_records_match_jax(tmp_path, kmer_len):
    fasta = _messy_fasta(str(tmp_path / "messy.fa"), np.random.default_rng(7))
    h = _index_both(fasta, kmer_len, 256)
    names = [c[0] for c in h.chromosomes]
    assert "empty" not in names and "alln" not in names and "short" not in names
    assert h.vals_max == 255  # the repeat saturates


@pytest.mark.parametrize("encoder", ["packed", "slice"])
def test_index_forced_encoder_matches_jax(tmp_path, monkeypatch, encoder):
    """Either encoder of the JAX package, forced for every chunk, gives the
    port's output (the port has one encoder and reads no such switch)."""
    monkeypatch.setenv("PYKMER_TPU_ENCODER", encoder)
    fasta = _messy_fasta(str(tmp_path / "enc.fa"), np.random.default_rng(8))
    _index_both(fasta, 7, 128)


def test_index_stdin_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    fasta = make_random_fasta(str(tmp_path / "in.fa"), rng, n_records=4,
                              lengths=(300, 50, 700, 9))
    data = _read(fasta)
    monkeypatch.chdir(tmp_path)
    cfg = IndexConfig(kmer_len=5, chunk_windows=64)
    outs = []
    for create, kw in ((jax_create, {}), (pykmer_tpu_torch.create_fasta_index,
                                           {"device": "cpu"})):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
        h = create("smp", "smp", "-", 5, config=cfg, verbose=False, **kw)
        assert os.path.basename(h.index_file_root) == "smp.05.kin"
        outs.append(_outputs(h))
    _assert_same(*outs)
    assert outs[1][1]["input_file_size"] is None


def test_cli_index_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    fasta = make_random_fasta(str(tmp_path / "c.fa"), rng)
    cfg = IndexConfig(kmer_len=7, chunk_windows=64)
    j = _outputs(jax_create(fasta, "s", fasta, 7, config=cfg, verbose=False))
    rc = cli.main(["index", fasta, "s", "7", "--chunk-windows", "64", "--quiet",
                   "--device", "cpu"])
    assert rc == 0
    kin = _read(fasta + ".07.kin")
    with open(fasta + ".07.kin.json") as fh:
        _assert_same(j, (kin, json.load(fh)))
    with pytest.raises(FileExistsError):
        cli.main(["index", fasta, "s", "7", "--quiet", "--device", "cpu",
                  "--no-overwrite"])


def test_cli_rejects_and_defers(tmp_path, capsys):
    assert cli.main(["index", "-", "s", "7", "--coordinator", "h:1",
                     "--num-processes", "2"]) == 2
    assert "stdin input ('-') is not supported for multi-host jobs" in \
        capsys.readouterr().err
    assert cli.main(["index", "x.fa", "s", "7", "--chunk-windows", "100"]) == 2
    if not torch.cuda.is_available():
        fasta = make_random_fasta(str(tmp_path / "d.fa"), np.random.default_rng(1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["index", fasta, "s", "5", "--quiet"])  # --device cuda default


def test_no_valid_kmers_raises_like_jax(tmp_path):
    fasta = str(tmp_path / "barren.fa")
    with open(fasta, "w") as fh:
        fh.write(">a\nACGNNACG\n>b\nAC\n")
    with pytest.raises(ValueError, match="no valid k-mers"):
        jax_create(fasta, "s", fasta, 5, verbose=False)
    with pytest.raises(ValueError, match="no valid k-mers"):
        pykmer_tpu_torch.create_fasta_index(fasta, "s", fasta, 5, verbose=False,
                                            device="cpu")


@pytest.mark.parametrize("cfg,exc", [
    (IndexConfig(kmer_len=7, readback="2bit"), NotImplementedError),
    (IndexConfig(kmer_len=7, readback="sparse"), NotImplementedError),
    (IndexConfig(kmer_len=7, readback="3bit"), NotImplementedError),
    (IndexConfig(kmer_len=7, kernel="pallas"), ValueError),
])
def test_unported_configurations_raise(tmp_path, cfg, exc):
    fasta = make_random_fasta(str(tmp_path / "u.fa"), np.random.default_rng(2))
    with pytest.raises(exc, match="ROADMAP|kernel"):
        pykmer_tpu_torch.create_fasta_index(fasta, "s", fasta, cfg.kmer_len,
                                            config=cfg, verbose=False, device="cpu")
    assert not os.path.exists(fasta + f".{cfg.kmer_len:02d}.kin")


# ---- host helpers: the port's copies equal the originals -------------------

def _stream(rng, n=5000, kmer_len=7):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < 0.02] = 4
    codes[: 2000] = rng.integers(0, 4, size=2000)
    return codes


@pytest.mark.parametrize("chunk_windows", [64, 1000, 8192])
def test_host_chunk_helpers_match(chunk_windows):
    rng = np.random.default_rng(chunk_windows)
    k = 7
    codes = _stream(rng, kmer_len=k)
    pt, nt = tch.chunk_stream(codes.copy(), k, chunk_windows)
    pj, nj = jenc.chunk_stream(codes.copy(), k, chunk_windows)
    assert nt == nj and np.array_equal(pt, pj)
    for a, b in zip(tch.iter_chunks(pt, k, chunk_windows, nt),
                    jenc.iter_chunks(pj, k, chunk_windows, nj), strict=True):
        assert np.array_equal(a, b)
    packed_t, packed_j = tch.pack_base_stream(pt), jenc.pack_base_stream(pj)
    for a, b in zip(packed_t, packed_j, strict=True):
        assert np.array_equal(a, b)
    for (bt, mt), (bj, mj) in zip(
            tch.iter_chunks_packed(packed_t, k, chunk_windows, nt),
            jenc.iter_chunks_packed(packed_j, k, chunk_windows, nj), strict=True):
        assert np.array_equal(bt, bj) and np.array_equal(mt, mj)
        span = chunk_windows + k - 1
        assert tch.mask_all_valid(mt, span) == jenc.mask_all_valid(mj, span)
    lazy_t = list(tch.iter_chunks_packed_lazy(pt, k, chunk_windows, nt))
    lazy_j = list(jenc.iter_chunks_packed_lazy(pj, k, chunk_windows, nj))
    assert len(lazy_t) == len(lazy_j)
    for (bt, mt), (bj, mj) in zip(lazy_t, lazy_j):
        assert np.array_equal(bt, bj)
        assert (mt is None) == (mj is None)
        assert mt is None or np.array_equal(mt, mj)


def test_mask_all_valid_edges_match():
    full = np.full(4, 0xFF, dtype=np.uint8)
    broken = full.copy()
    broken[3] = 0xEF
    tail = np.array([0xFF, 0x0F], dtype=np.uint8)
    for mask, span in ((full, 32), (full, 29), (broken, 32), (broken, 29),
                       (broken, 28), (tail, 12), (tail, 13)):
        assert tch.mask_all_valid(mask, span) == jenc.mask_all_valid(mask, span)


def test_host_decode_helpers_match(tmp_path):
    from pykmer_tpu.io.fasta import decode_fasta_bytes

    fasta = _messy_fasta(str(tmp_path / "d.fa"), np.random.default_rng(3))
    data = _read(fasta)
    for k in (3, 7, 11):
        for rec in decode_fasta_bytes(data):
            assert tdec.record_has_valid_window(rec.codes, k) \
                == jix._record_has_valid_window(rec.codes, k)
        st, ct, bt = tdec.concat_records(decode_fasta_bytes(data), k)
        sj, cj, bj = jix._concat_records(decode_fasta_bytes(data), k)
        assert np.array_equal(st, sj) and ct == cj and bt == bj
        st, ct, bt = tdec.decode_joined_bytes(data, k, tail_headroom=64)
        sj, cj, bj = jix._decode_joined_bytes(data, k, tail_headroom=64)
        assert np.array_equal(st, sj) and ct == cj and bt == bj


@pytest.mark.parametrize("kmer_len", [3, 7, 9])
def test_unfold_matches(kmer_len, monkeypatch):
    rng = np.random.default_rng(kmer_len)
    folded = rng.integers(0, 256, size=4**kmer_len // 2).astype(np.uint8)
    want = jrb.unfold_canonical(folded.copy(), kmer_len)
    assert np.array_equal(trb.unfold_canonical(folded.copy(), kmer_len), want)
    # the numpy version used where the port's native library is absent
    calls = []
    real = trb._rc_codes_np
    monkeypatch.setattr(trb, "_rc_codes_np", lambda *a: calls.append(1) or real(*a))
    assert np.array_equal(trb.unfold_canonical(folded.copy(), kmer_len), want)
    assert not calls  # the native unfold
    monkeypatch.setitem(sys.modules, "pykmer_tpu_torch.io.native", None)
    assert np.array_equal(trb.unfold_canonical(folded.copy(), kmer_len), want)
    assert calls


def test_write_and_hash_matches(tmp_path):
    """The chase sink (regions in order, ragged last one) writes and hashes
    what the JAX package's whole-buffer ``_write_and_hash`` does, through a
    DirectWriter and through a raw fd."""
    from pykmer_tpu.io.direct import DirectWriter

    arr = np.random.default_rng(4).integers(0, 256, size=1 << 16).astype(np.uint8)
    half = arr.shape[0] // 2
    jpath = str(tmp_path / "j")
    with DirectWriter(jpath, size=arr.shape[0]) as fd:
        digests = [jrb._write_and_hash(fd, arr)]
    assert _read(jpath) == arr.tobytes()

    def chase(fd):
        sink = trb.ChaseSink(arr, fd)
        for lo in range(0, half, 5000):
            sink.region_done(lo, min(half, lo + 5000))
        return sink.finish()

    tpath = str(tmp_path / "t")
    with DirectWriter(tpath, size=arr.shape[0]) as fd:
        digests.append(chase(fd))
    raw = str(tmp_path / "raw")
    fd = os.open(raw, os.O_CREAT | os.O_WRONLY)
    try:
        digests.append(chase(fd))
    finally:
        os.close(fd)
    digests.append(chase(None))  # hash only
    for path in (tpath, raw):
        assert _read(path) == arr.tobytes()
    assert len(set(digests)) == 1


@pytest.mark.parametrize("hint,cuda_windows", [
    (None, 1 << 24), (100, 1 << 16), (70_000, 1 << 17), (3 << 20, 1 << 22),
    (10**10, 1 << 24),
])
def test_resolve_chunk_windows(hint, cuda_windows):
    """The CPU default equals the JAX package's on its CPU backend; CUDA
    starts from 2^24 windows under the same power-of-two input clamp."""
    from pykmer_tpu.config import resolve_chunk_windows as jax_resolve

    cfg = IndexConfig(kmer_len=11)
    got = resolve_chunk_windows(cfg, torch.device("cpu"), input_hint_bytes=hint)
    assert got == jax_resolve(cfg, input_hint_bytes=hint)
    cuda = resolve_chunk_windows(cfg, torch.device("cuda"), input_hint_bytes=hint)
    assert cuda.chunk_windows == cuda_windows
    explicit = IndexConfig(kmer_len=11, chunk_windows=808)
    assert resolve_chunk_windows(explicit, "cuda", hint) is explicit


def test_gz_and_plain_agree(tmp_path):
    rng = np.random.default_rng(5)
    fasta = make_random_fasta(str(tmp_path / "p.fa"), rng, n_records=5,
                              lengths=(900, 133, 67))
    gz = str(tmp_path / "p2.fa.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(_read(fasta))
    cfg = IndexConfig(kmer_len=7, chunk_windows=256)
    kin = []
    for path in (fasta, gz):
        h = pykmer_tpu_torch.create_fasta_index(path, "s", path, 7, config=cfg,
                                                verbose=False, device="cpu")
        kin.append(_read(h.index_file_root))
    assert kin[0] == kin[1]
