"""The port's input pipeline, strategies, readback tail and CLI vs the JAX
package, on the CPU.

Each test feeds the same seeded inputs to a JAX-package function and its
port and asserts exact equality: segment bounds, the streaming reader, the
pre-packed chunk views, the pipelined and host-strategy indexes (`.kin`
bytes and `.kin.json`), the int64 sort path, the chased readback tail (file
bytes, sha256, 256-bin counts), strategy resolution, and the CLI's `read`,
`index-batch`, `--bgzip` and `--accumulate`.
"""

import gzip
import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu import cli as jcli
from pykmer_tpu.config import IndexConfig
from pykmer_tpu.formats.header import fast_counts256
from pykmer_tpu.index import create_fasta_index as jax_create
from pykmer_tpu.index import indexer as jix
from pykmer_tpu.io.direct import DirectWriter
from pykmer_tpu.ops import encode as jenc
from pykmer_tpu.ops import readback as jrb
import pykmer_tpu_torch
from pykmer_tpu_torch import cli as tcli
from pykmer_tpu_torch.config import resolve_strategy
from pykmer_tpu_torch.host import chunks as tch
from pykmer_tpu_torch.host import segments as tseg
from pykmer_tpu_torch.index import indexer as tix
from pykmer_tpu_torch.io import direct
from pykmer_tpu_torch.ops import readback as trb

native = pytest.importorskip("pykmer_tpu_torch.io.native")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _take(root):
    """(.kin bytes, .kin.json dict) of an index, removing both files."""
    kin = _read(root)
    with open(root + ".json") as fh:
        meta = json.load(fh)
    os.remove(root)
    os.remove(root + ".json")
    return kin, meta


def _assert_same(want, got):
    (kin_w, meta_w), (kin_g, meta_g) = want, got
    assert kin_g == kin_w, ".kin differs"
    assert set(meta_g) == set(meta_w)
    for key in meta_w:
        if key not in VOLATILE_KIN_JSON_KEYS:
            assert meta_g[key] == meta_w[key], key


def _port(fasta, kmer_len, cfg, sample="s"):
    h = pykmer_tpu_torch.create_fasta_index(fasta, sample, fasta, kmer_len, config=cfg,
                                            verbose=False, device="cpu")
    return _take(h.index_file_root)


def _jax(fasta, kmer_len, cfg, sample="s"):
    h = jax_create(fasta, sample, fasta, kmer_len, config=cfg, verbose=False)
    return _take(h.index_file_root)


def _gzip_copy(src, dst):
    with gzip.open(dst, "wb") as fh:
        fh.write(_read(src))
    return dst


# ---- (a) segments, the streaming reader, pre-packed chunks -----------------

@pytest.mark.parametrize("target", [300, 1500, 2000, 1 << 30])
def test_segment_record_bounds_match_jax(tmp_path, target):
    fasta = make_random_fasta(str(tmp_path / "b.fa"), np.random.default_rng(target),
                              n_records=40, lengths=(500, 133, 67, 0))
    buf = np.fromfile(fasta, dtype=np.uint8)
    got = tseg.segment_record_bounds(buf, target)
    assert got == jix._segment_record_bounds(buf, target)
    assert got[0][0] == 0 and got[-1][1] == buf.shape[0]
    for lo, hi in ((0, buf.shape[0]), (5, 900), (buf.shape[0] - 40, buf.shape[0])):
        assert tseg.find_record_start(buf, lo, hi) == jix._find_record_start(buf, lo, hi)


@pytest.mark.parametrize("target", [1000, 64 << 20])
def test_segment_targets_match_jax(target):
    t, j = tseg.segment_targets(target), jix._segment_targets(target)
    assert [next(t) for _ in range(8)] == [next(j) for _ in range(8)]


@pytest.mark.parametrize("extent", [512, 7919])
def test_streaming_input_matches_jax(tmp_path, extent):
    fasta = make_random_fasta(str(tmp_path / "chase.fa"), np.random.default_rng(extent),
                              n_records=60, lengths=(700, 133, 67))
    buf = np.fromfile(fasta, dtype=np.uint8)
    stream = tseg.StreamingInput(fasta, extent=extent)
    got = list(tseg.iter_segments_streaming(stream, target=2000))
    jstream = jix._StreamingInput(fasta, extent=extent)
    assert got == list(jix._iter_segments_streaming(jstream, target=2000))
    assert got == jix._segment_record_bounds(buf, 2000)
    assert np.array_equal(stream.buf, buf)
    assert stream.input_checksum() == jstream.input_checksum() \
        == hashlib.sha256(buf.tobytes()).hexdigest()


def test_streaming_partial_fill_rescan_matches_jax(tmp_path, monkeypatch):
    """A one-byte wait slack and a 7-byte read extent make the scanner reach
    the fill point again and again, some fill points inside a ``\\n>`` pair,
    and rescan from there: the bounds still equal the JAX package's."""
    fasta = make_random_fasta(str(tmp_path / "rescan.fa"), np.random.default_rng(11),
                              n_records=8, lengths=(2500, 400, 0))
    buf = np.fromfile(fasta, dtype=np.uint8)
    want = jix._segment_record_bounds(buf, target=1000)
    scans = {"n": 0}
    real_find = tseg.find_record_start

    def counting_find(b, lo, hi):
        scans["n"] += 1
        return real_find(b, lo, hi)

    real_pread = direct.pread_into_mt

    def slow_pread(rd, dst, pos, **kw):
        time.sleep(0.0002)  # the scanner must catch up with the reader
        return real_pread(rd, dst, pos, **kw)

    monkeypatch.setattr(tseg, "find_record_start", counting_find)
    monkeypatch.setattr(direct, "pread_into_mt", slow_pread)
    stream = tseg.StreamingInput(fasta, extent=7)
    got = list(tseg.iter_segments_streaming(stream, target=1000, wait_slack=1))
    assert got == want
    assert np.array_equal(stream.buf, buf)
    assert scans["n"] > 4 * len(want)


def test_streaming_input_reports_read_errors(tmp_path, monkeypatch):
    fasta = make_random_fasta(str(tmp_path / "e.fa"), np.random.default_rng(12))

    def failing_pread(rd, dst, pos, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(direct, "pread_into_mt", failing_pread)
    stream = tseg.StreamingInput(fasta)
    with pytest.raises(OSError, match="disk gone"):
        list(tseg.iter_segments_streaming(stream, target=1000))
    with pytest.raises(OSError, match="disk gone"):
        stream.input_checksum()


@pytest.mark.parametrize("kmer_len,chunk_windows", [(5, 64), (7, 1000), (11, 8192)])
def test_iter_chunks_prepacked_matches_jax(tmp_path, kmer_len, chunk_windows):
    fasta = make_random_fasta(str(tmp_path / "p.fa"), np.random.default_rng(kmer_len),
                              n_records=9, lengths=(3000, 50, 700))
    data = _read(fasta)
    bases, mask, n_codes, _, _ = native.fasta_decode_joined_packed_native(
        data, kmer_len, tail_headroom=chunk_windows + kmer_len + 8)
    got = list(tch.iter_chunks_prepacked(bases, mask, n_codes, kmer_len, chunk_windows))
    want = list(jenc.iter_chunks_prepacked(bases, mask, n_codes, kmer_len, chunk_windows))
    assert len(got) == len(want) > 0
    for (bt, mt), (bj, mj) in zip(got, want):
        assert np.array_equal(bt, bj)
        assert (mt is None) == (mj is None)
        assert mt is None or np.array_equal(mt, mj)


# ---- (b) the pipelined index -----------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_pipelined_multisegment_index_matches_jax(tmp_path, monkeypatch, packed):
    """Forty records in ~1500-byte segments: the streaming index of the plain
    file and the pipelined index of its gzip copy equal the JAX index, with
    the packed decode and with the code-stream decode."""
    fasta = make_random_fasta(str(tmp_path / "pipe.fa"), np.random.default_rng(13),
                              n_records=40, lengths=(500, 133, 67))
    gz = _gzip_copy(fasta, str(tmp_path / "pipe2.fa.gz"))
    cfg = IndexConfig(kmer_len=7, chunk_windows=1000)
    want = _jax(fasta, 7, cfg)

    orig = tix.iter_pipelined_chunks
    segments = {"n": 0}

    def many_segments(data, k, cw, sink):
        for chunk in orig(data, k, cw, sink, target_segment=1500):
            segments["n"] += 1
            yield chunk

    monkeypatch.setattr(tix, "iter_pipelined_chunks", many_segments)
    if not packed:
        monkeypatch.setattr(native, "fasta_decode_joined_packed_native",
                            lambda *a, **kw: None)
    got = _port(fasta, 7, cfg)
    _assert_same(want, got)
    assert got[1]["input_file_cheksum"] == hashlib.sha256(_read(fasta)).hexdigest()
    assert segments["n"] > 10  # at least one chunk per segment
    zipped = _port(gz, 7, cfg)
    assert zipped[0] == got[0]
    for key in ("num_kmers", "hist", "vals_sum", "vals_count", "output_file_cheksum",
                "chromosomes"):
        assert zipped[1][key] == got[1][key], key


def test_pipelined_decode_error_reaches_consumer(tmp_path, monkeypatch):
    fasta = make_random_fasta(str(tmp_path / "err.fa"), np.random.default_rng(14),
                              n_records=20, lengths=(500,))

    def broken(*a, **kw):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(native, "fasta_decode_joined_packed_native", broken)
    with pytest.raises(RuntimeError, match="decode failed"):
        _port(fasta, 7, IndexConfig(kmer_len=7, chunk_windows=1000))
    assert not os.path.exists(fasta + ".07.kin")


# ---- (c) the host strategy -------------------------------------------------

def _messy_fasta(path, rng):
    seq = "".join(rng.choice(list("ACGT"), size=900))
    with open(path, "w") as fh:
        fh.write(">empty\n>alln\n" + "N" * 50 + "\n>short\nACG\n")
        fh.write(f">split\n{seq[:300]}NNNNN{seq[300:].lower()}\n")
        fh.write(">repeat\n" + "ACGTTGCA" * 400 + f"\n>tail\n{seq[::-1]}\n")
    return path


@pytest.mark.parametrize("kmer_len", [5, 7, 11])
def test_host_strategy_matches_jax_and_device(tmp_path, kmer_len):
    fasta = _messy_fasta(str(tmp_path / "h.fa"), np.random.default_rng(kmer_len))
    host = IndexConfig(kmer_len=kmer_len, chunk_windows=256, accumulate="host")
    want = _jax(fasta, kmer_len, host)
    got = _port(fasta, kmer_len, host)
    _assert_same(want, got)
    assert got[1]["vals_max"] == 255
    dev = _port(fasta, kmer_len, IndexConfig(kmer_len=kmer_len, chunk_windows=256,
                                             accumulate="device"))
    assert dev[0] == got[0]
    for key in ("num_kmers", "hist", "output_file_cheksum", "input_file_cheksum"):
        assert dev[1][key] == got[1][key], key


def test_unique_sorted_matches_jax():
    vals = np.sort(np.random.default_rng(15).integers(0, 50, size=3000))
    for a, b in zip(tix.unique_sorted(vals), jix._unique_sorted(vals)):
        assert np.array_equal(a, b)


# ---- (d) the int64 sort path -----------------------------------------------

@pytest.mark.parametrize("kmer_len", [7, 11])
def test_int64_sort_path_matches_jax(tmp_path, monkeypatch, kmer_len):
    """With the int32 limit lowered to 0 every chunk sorts and sweeps int64
    codes, the dtype K >= 17 uses; the index still equals the JAX one."""
    fasta = _messy_fasta(str(tmp_path / "w.fa"), np.random.default_rng(20 + kmer_len))
    cfg = IndexConfig(kmer_len=kmer_len, chunk_windows=512)
    want = _jax(fasta, kmer_len, cfg)
    dtypes = []
    real = tix.accumulate_sorted

    def spy(plane, codes):
        dtypes.append(codes.dtype)
        return real(plane, codes)

    monkeypatch.setattr(tix, "MAX_INT32_SORT_CELLS", 0)
    monkeypatch.setattr(tix, "accumulate_sorted", spy)
    _assert_same(want, _port(fasta, kmer_len, cfg))
    assert dtypes and set(dtypes) == {torch.int64}


# ---- (e) the chased readback tail ------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kmer_len", [7, 9, 11])
def test_chased_tail_matches_jax(tmp_path, monkeypatch, kmer_len, use_native):
    rng = np.random.default_rng(kmer_len)
    folded = rng.integers(0, 256, size=4**kmer_len // 2).astype(np.uint8)
    folded[rng.random(folded.shape[0]) < 0.7] = 0
    want = jrb.unfold_canonical(folded.copy(), kmer_len)
    jpath = str(tmp_path / "j.kin")
    with DirectWriter(jpath, size=want.shape[0]) as fd:
        want_hex = jrb._write_and_hash(fd, want)
    want_counts = fast_counts256(folded)

    calls = []
    real = trb._rc_codes_np
    monkeypatch.setattr(trb, "_rc_codes_np", lambda *a: calls.append(1) or real(*a))
    if not use_native:
        monkeypatch.setitem(sys.modules, "pykmer_tpu_torch.io.native", None)
    out = np.full(4**kmer_len, 77, dtype=np.uint8)
    tpath = str(tmp_path / "t.kin")
    slice_cells = folded.shape[0] // 5 + 3  # ragged last slice
    with DirectWriter(tpath, size=out.shape[0]) as fd:
        counts, hex_ = trb.stream_plane_to_out(torch.from_numpy(folded.copy()), kmer_len,
                                               out, fd, slice_cells=slice_cells)
    assert np.array_equal(out, want)
    assert _read(tpath) == _read(jpath)
    assert hex_ == want_hex
    assert np.array_equal(counts, want_counts)
    assert bool(calls) != use_native  # the numpy unfold ran iff native was blocked


def test_chased_tail_rejects_bad_shapes():
    with pytest.raises(ValueError):
        trb.stream_plane_to_out(torch.zeros(100, dtype=torch.uint8), 5,
                                np.empty(4**5, np.uint8))
    with pytest.raises(ValueError):
        trb.stream_plane_to_out(torch.zeros(4**5 // 2, dtype=torch.uint8), 5,
                                np.empty(4**5 - 1, np.uint8))
    sink = trb.ChaseSink(np.zeros(64, np.uint8))
    sink.region_done(0, 10)
    with pytest.raises(ValueError, match="out of order"):
        sink.region_done(11, 20)
    with pytest.raises(ValueError, match="not 32"):
        sink.finish()


# ---- (f) strategy resolution -----------------------------------------------

CARD_80GB = 80 * 10**9


@pytest.mark.parametrize("kmer_len,free,want", [
    (15, CARD_80GB, "device"), (17, CARD_80GB, "device"), (19, CARD_80GB, "host"),
    (17, 9 << 30, "host"), (17, 11 << 30, "device"), (21, CARD_80GB, "host"),
])
def test_strategy_on_a_card(kmer_len, free, want):
    assert resolve_strategy(kmer_len, "auto", "cuda", free, 1 << 24) == want
    for explicit in ("device", "host"):
        assert resolve_strategy(kmer_len, explicit, "cuda", free) == explicit


def test_strategy_on_the_cpu_is_the_jax_rule():
    for k in range(1, 23, 2):
        size = 4**k
        jax_rule = "device" if size <= (4 << 30) or jix._device_fits_folded(size, k) \
            else "host"
        assert resolve_strategy(k, "auto", "cpu") == jax_rule
    with pytest.raises(ValueError):
        resolve_strategy(7, "gpu", "cpu")
    with pytest.raises(ValueError):
        resolve_strategy(7, "auto", "cuda")  # the card's free bytes are needed


# ---- (g) the CLI: --accumulate, --bgzip, read, index-batch -----------------

def _cli_both(argv, tmp_path, files):
    """Run ``argv`` through the JAX CLI, then the port's (``--device cpu``);
    returns the two exit codes and each run's bytes of ``files``."""
    out = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        rc = main(argv + extra)
        got = {}
        for f in files:
            if os.path.exists(f):
                got[f] = _read(f)
                os.remove(f)
        out.append((rc, got))
    return out


def test_cli_index_accumulate_host_and_bgzip_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fasta = make_random_fasta(str(tmp_path / "c.fa"), np.random.default_rng(30),
                              n_records=3, lengths=(400, 90))
    root = fasta + ".07.kin"
    files = [root, root + ".json", root + ".bgz", root + ".bgz.gzi"]
    (rc_j, jax_files), (rc_t, port_files) = _cli_both(
        ["index", fasta, "s", "7", "--quiet", "--accumulate", "host", "--bgzip",
         "--chunk-windows", "128"], tmp_path, files)
    assert rc_j == rc_t == 0
    assert set(jax_files) == set(port_files) == set(files)
    for f in (root, root + ".bgz", root + ".bgz.gzi"):
        assert port_files[f] == jax_files[f], f
    _assert_same((jax_files[root], json.loads(jax_files[root + ".json"])),
                 (port_files[root], json.loads(port_files[root + ".json"])))


def test_cli_read_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    fasta = make_random_fasta(str(tmp_path / "r.fa"), np.random.default_rng(31),
                              n_records=2, lengths=(300, 150))
    assert tcli.main(["index", fasta, "s", "5", "--quiet", "--device", "cpu"]) == 0
    capsys.readouterr()
    outs = []
    for main in (jcli.main, tcli.main):
        assert main(["read", fasta, "5", "--debug"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "OK" in outs[1]
    # a corrupted .kin fails both checks the same way
    kin = fasta + ".05.kin"
    arr = np.fromfile(kin, dtype=np.uint8)
    arr[np.flatnonzero(arr)[0]] ^= 0x40
    arr.tofile(kin)
    errors = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(ValueError, match="stats mismatch") as exc:
            main(["read", fasta, "5"])
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_cli_index_batch_matches_jax(tmp_path, monkeypatch, capsys):
    """index-batch indexes every input as the JAX CLI does, skips existing
    outputs, re-indexes with --overwrite, and reports a failing input with
    exit code 1 while the others still index."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(32)
    fastas = [make_random_fasta(str(tmp_path / f"g{i}.fa"), rng, n_records=2,
                                lengths=(260, 140)) for i in range(3)]
    kins = [f + ".05.kin" for f in fastas]
    files = kins + [k + ".json" for k in kins]
    (rc_j, jax_files), (rc_t, port_files) = _cli_both(
        ["index-batch", "5", *fastas, "--quiet"], tmp_path, files)
    assert rc_j == rc_t == 0
    assert set(port_files) == set(jax_files) == set(files)
    for kin in kins:
        _assert_same((jax_files[kin], json.loads(jax_files[kin + ".json"])),
                     (port_files[kin], json.loads(port_files[kin + ".json"])))

    # skip-existing, then --overwrite
    assert tcli.main(["index-batch", "5", *fastas, "--quiet", "--device", "cpu"]) == 0
    mtimes = [os.path.getmtime(k) for k in kins]
    capsys.readouterr()
    assert tcli.main(["index-batch", "5", *fastas, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("skip ") == 3 and "0 indexed" in out.splitlines()[-1]
    assert mtimes == [os.path.getmtime(k) for k in kins]
    assert tcli.main(["index-batch", "5", fastas[0], "--overwrite", "--device",
                      "cpu"]) == 0
    assert "1 indexed" in capsys.readouterr().out.splitlines()[-1]

    # a failing input (no valid k-mers) is reported; the rest still index
    bad = str(tmp_path / "bad.fa")
    with open(bad, "w") as fh:
        fh.write(">only-ns\nNNNNNNNN\n")
    extra = make_random_fasta(str(tmp_path / "g3.fa"), rng, n_records=1, lengths=(200,))
    files = [extra + ".05.kin", extra + ".05.kin.json", bad + ".05.kin",
             bad + ".05.kin.tmp"]
    (rc_j, jax_files), (rc_t, port_files) = _cli_both(
        ["index-batch", "5", bad, extra, "--quiet"], tmp_path, files)
    assert rc_j == rc_t == 1
    assert set(port_files) == set(jax_files) == set(files[:2])
    assert port_files[files[0]] == jax_files[files[0]]
    assert "FAILED" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--shards", "2"], ["--data-parallel", "2"], ["--checkpoint-every", "3"],
    ["--num-processes", "1", "--process-id", "0", "--shards", "2"],
])
def test_cli_multi_device_flags_not_ported(tmp_path, capsys, flags):
    """No multi-device flag answers "not yet ported" any more: the sharded
    flags run the sharded index and the multi-host flags (one process here;
    tests/test_torch_multihost*.py run real jobs) the multi-host index, and
    each `.kin` is the single-device run's."""
    fasta = make_random_fasta(str(tmp_path / "m.fa"), np.random.default_rng(33))
    kin = fasta + ".05.kin"
    rc = tcli.main(["index", fasta, "s", "5", "--device", "cpu", "--quiet",
                    "--chunk-windows", "64", *flags])
    assert "not yet ported" not in capsys.readouterr().err
    assert rc == 0
    sharded = _read(kin)
    assert tcli.main(["index", fasta, "s", "5", "--device", "cpu", "--quiet",
                      "--chunk-windows", "64"]) == 0
    assert _read(kin) == sharded
