"""The port's BGZF streaming input on the CPU: ``host/segments.BgzfInput``
gives the bytes ``gzip.decompress`` gives and the segments
``segment_record_bounds`` finds, raises on a truncated or corrupt file, and
carries ``create_fasta_index`` of a BGZF ``.fa.gz`` or ``.bgz`` to the JAX
package's `.kin` and `.kin.json`, with spans whose counts add up. A gzip that
is not BGZF, and the host strategy, keep the whole-input route."""

import collections
import functools
import gzip
import hashlib
import json
import os
import struct
import sys
import threading
import zlib

import numpy as np
import pytest

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu.config import IndexConfig as JaxIndexConfig
from pykmer_tpu.index import create_fasta_index as jax_create
import pykmer_tpu_torch
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.host import segments as tseg
from pykmer_tpu_torch.index import indexer as tix
from pykmer_tpu_torch.utils import profiling

pytest.importorskip("pykmer_tpu_torch.io.native")

K = 7
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzip(payload, block=65280, level=6, eof=True):
    """``payload`` as BGZF, written with the standard library's zlib as
    htslib's bgzip lays it out: ``block``-byte payloads, each a gzip member
    with the ``BC`` subfield, and the 28-byte EOF block."""
    out = bytearray()
    for i in range(0, len(payload), block):
        part = payload[i:i + block]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        deflated = co.compress(part) + co.flush()
        bsize = 18 + len(deflated) + 8
        out += struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 0x42, 0x43, 2,
                           bsize - 1)
        out += deflated + struct.pack("<2I", zlib.crc32(part), len(part))
    return bytes(out + EOF_BLOCK) if eof else bytes(out)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _write(path, data):
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _fasta(tmp_path, seed=3, n_records=30, lengths=(900, 250, 61)):
    path = make_random_fasta(str(tmp_path / "g.fa"), np.random.default_rng(seed),
                             n_records=n_records, lengths=lengths)
    return path, _read(path)


def _source(monkeypatch, path, threads, extent, src=None):
    """The BGZF source of ``path`` on ``threads`` threads, a run of blocks
    being about ``extent`` inflated bytes."""
    monkeypatch.setattr(tseg, "inflate_threads", lambda: threads)
    monkeypatch.setattr(tseg, "INFLATE_EXTENT", extent)
    src = tseg.read_bgzf(path) if src is None else src
    assert src is not None
    return tseg.BgzfInput(src)


# ---- the source's bytes and segments ---------------------------------------

# (block, extent, threads, EOF block): many blocks in many runs; an extent
# smaller than a block (a run a block); blocks of 97 bytes, so records
# straddle them; no EOF block; a file of one block
SOURCE_CASES = {
    "many_blocks": (500, 2000, 3, True),
    "extent_below_a_block": (700, 1, 4, True),
    "records_straddle_blocks": (97, 1000, 2, True),
    "no_eof_block": (500, 3000, 3, False),
    "one_block": (65280, 1 << 20, 3, True),
}


@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_bgzf_source_bytes_equal_gzip(tmp_path, monkeypatch, case):
    block, extent, threads, eof = SOURCE_CASES[case]
    _, plain = _fasta(tmp_path)
    gz = _write(str(tmp_path / "g.fa.gz"), bgzip(plain, block=block, eof=eof))
    src = tseg.read_bgzf(gz)
    n_blocks = -(-len(plain) // block) + eof
    assert len(src.c_offs) - 1 == n_blocks
    assert src.size == len(plain) and int(src.c_offs[-1]) == os.path.getsize(gz)
    stream = _source(monkeypatch, gz, threads, extent, src=src)
    try:
        stream.wait_until(stream.size)
        assert stream.filled() == stream.size
        assert stream.buf.tobytes() == gzip.decompress(_read(gz)) == plain
        assert stream.input_checksum() == hashlib.sha256(_read(gz)).hexdigest()
    finally:
        stream.release()
    stream.release()  # a second call does nothing


def test_bgzf_empty_block_inside_the_file(tmp_path, monkeypatch):
    """An empty block (an EOF block) between blocks, as ``cat`` of two
    bgzip files leaves it, inflates to nothing."""
    _, plain = _fasta(tmp_path)
    half = len(plain) // 2
    gz = _write(str(tmp_path / "cat.fa.gz"),
                bgzip(plain[:half], block=800) + bgzip(plain[half:], block=800))
    stream = _source(monkeypatch, gz, 3, 1500)
    stream.wait_until(stream.size)
    assert stream.buf.tobytes() == gzip.decompress(_read(gz)) == plain
    stream.release()


def test_bgzf_source_under_thread_switches(tmp_path, monkeypatch):
    """More inflate threads than cores, a block a run and a switch interval
    of a microsecond: every run lands in place, ``filled`` reaches the end,
    and every thread has ended once the input is released."""
    _, plain = _fasta(tmp_path, n_records=80)
    gz = _write(str(tmp_path / "x.fa.gz"), bgzip(plain, block=61))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stream = _source(monkeypatch, gz, 4 * (os.cpu_count() or 1), 1)
        waiter = threading.Thread(target=stream.wait_until, args=(stream.size,))
        waiter.start()
        waiter.join(timeout=120)
        assert not waiter.is_alive()
        assert stream.filled() == stream.size
        assert stream.buf.tobytes() == plain
        threads = stream._inflaters + [stream._hasher]
        stream.release()
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("target,wait_slack,extent", [(2000, 1, 700), (5000, 8 << 20, 3000),
                                                      (1 << 30, 1, 1)])
def test_bgzf_segments_equal_record_bounds(tmp_path, monkeypatch, target, wait_slack,
                                           extent):
    _, plain = _fasta(tmp_path, seed=target % 97, n_records=60)
    gz = _write(str(tmp_path / "s.fa.gz"), bgzip(plain, block=300))
    stream = _source(monkeypatch, gz, 3, extent)
    try:
        got = list(tseg.iter_segments_streaming(stream, target=target, wait_slack=wait_slack))
        assert got == tseg.segment_record_bounds(np.frombuffer(plain, np.uint8), target)
    finally:
        stream.release()


def test_not_bgzf_is_none(tmp_path):
    path, plain = _fasta(tmp_path)
    gz = str(tmp_path / "plain.fa.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(plain)
    assert tseg.read_bgzf(gz) is None and tseg.read_bgzf(path) is None
    assert not tseg.is_bgzf(_write(str(tmp_path / "empty.gz"), b""))


# ---- errors ------------------------------------------------------------------

@pytest.mark.parametrize("cut", ["inside_a_header", "inside_a_block", "inside_the_eof"])
def test_bgzf_truncated_file_raises(tmp_path, cut):
    _, plain = _fasta(tmp_path)
    data = bgzip(plain, block=500)
    second = struct.unpack_from("<H", data, 16)[0] + 1  # the second block's start
    at = {"inside_a_header": second + 9, "inside_a_block": second + 40,
          "inside_the_eof": len(data) - 3}[cut]
    gz = _write(str(tmp_path / "cut.fa.gz"), data[:at])
    with pytest.raises(IOError, match="truncated|no BGZF block header"):
        tseg.read_bgzf(gz)


def _corrupt(data, what):
    """``data`` with its third block broken: its deflate bytes, its CRC or
    its ISIZE."""
    pos = 0
    for _ in range(2):
        pos += struct.unpack_from("<H", data, pos + 16)[0] + 1
    end = pos + struct.unpack_from("<H", data, pos + 16)[0] + 1
    out = bytearray(data)
    if what == "deflate":
        out[pos + 18:end - 8] = bytes(end - 8 - pos - 18)  # zeros: not a valid stream
    elif what == "crc":
        out[end - 8] ^= 0x01
    else:
        out[end - 4:end] = struct.pack("<I", struct.unpack_from("<I", data, end - 4)[0] - 1)
    return bytes(out), pos


@pytest.mark.parametrize("what", ["deflate", "crc", "isize"])
def test_bgzf_corrupt_block_raises_through_wait_until(tmp_path, monkeypatch, what):
    _, plain = _fasta(tmp_path)
    data, at = _corrupt(bgzip(plain, block=500), what)
    gz = _write(str(tmp_path / "bad.fa.gz"), data)
    stream = _source(monkeypatch, gz, 2, 400)
    try:
        with pytest.raises(IOError):
            list(tseg.iter_segments_streaming(stream, target=1000, wait_slack=1))
        with pytest.raises(IOError):
            stream.wait_until(stream.size)
        assert stream.filled() <= 2 * 500  # never past the bad block
    finally:
        stream.release()


def test_bgzf_index_of_a_corrupt_file_raises(tmp_path):
    _, plain = _fasta(tmp_path)
    gz = _write(str(tmp_path / "bad.fa.gz"), _corrupt(bgzip(plain, block=500), "crc")[0])
    with pytest.raises(IOError, match="CRC"):
        pykmer_tpu_torch.create_fasta_index(gz, "s", gz, K, verbose=False, device="cpu",
                                            config=IndexConfig(kmer_len=K, chunk_windows=512))
    assert not os.path.exists(gz + f".{K:02d}.kin")


# ---- the index --------------------------------------------------------------

def _take(root):
    kin = _read(root)
    with open(root + ".json") as fh:
        meta = json.load(fh)
    os.remove(root)
    os.remove(root + ".json")
    return kin, meta


def _route_spy(monkeypatch):
    """Counts of the streaming sources built and of read_input calls."""
    seen = collections.Counter()
    for name in ("BgzfInput", "StreamingInput", "read_input"):
        real = getattr(tix, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tix, name, spy)
    return seen


def _assert_same(want, got):
    assert got[0] == want[0], ".kin differs"
    assert set(got[1]) == set(want[1])
    for key in want[1]:
        if key not in VOLATILE_KIN_JSON_KEYS:
            assert got[1][key] == want[1][key], key


@pytest.mark.parametrize("suffix", [".fa.gz", ".bgz"])
def test_bgzf_index_matches_jax_and_the_plain_file(tmp_path, monkeypatch, suffix):
    path, plain = _fasta(tmp_path, n_records=40, lengths=(1500, 333, 67))
    gz = _write(str(tmp_path / f"g2{suffix}"), bgzip(plain, block=700))
    want = _take(jax_create(gz, "s", gz, K, verbose=False,
                            config=JaxIndexConfig(kmer_len=K, chunk_windows=1000))
                 .index_file_root)
    monkeypatch.setattr(tix, "iter_pipelined_chunks",
                        functools.partial(tix.iter_pipelined_chunks, target_segment=3000))
    monkeypatch.setattr(tseg, "INFLATE_EXTENT", 1500)
    seen = _route_spy(monkeypatch)
    cfg = IndexConfig(kmer_len=K, chunk_windows=1000)
    got = _take(pykmer_tpu_torch.create_fasta_index(gz, "s", gz, K, config=cfg, verbose=False,
                                                    device="cpu").index_file_root)
    assert seen == {"BgzfInput": 1}
    _assert_same(want, got)
    assert got[1]["input_file_cheksum"] == hashlib.sha256(_read(gz)).hexdigest()
    plain_kin = _take(pykmer_tpu_torch.create_fasta_index(
        path, "s", path, K, config=cfg, verbose=False, device="cpu").index_file_root)
    assert plain_kin[0] == got[0]
    for key in ("num_kmers", "hist", "output_file_cheksum", "chromosomes"):
        assert plain_kin[1][key] == got[1][key], key


@pytest.mark.parametrize("route", ["gzip_not_bgzf", "host_strategy"])
def test_other_compressed_routes_keep_read_input(tmp_path, monkeypatch, route):
    _, plain = _fasta(tmp_path, seed=5)
    gz = str(tmp_path / "o.fa.gz")
    if route == "gzip_not_bgzf":
        with gzip.open(gz, "wb") as fh:
            fh.write(plain)
    else:
        _write(gz, bgzip(plain, block=600))
    accumulate = "host" if route == "host_strategy" else "auto"
    want = _take(jax_create(gz, "s", gz, K, verbose=False, config=JaxIndexConfig(
        kmer_len=K, chunk_windows=512, accumulate=accumulate)).index_file_root)
    seen = _route_spy(monkeypatch)
    got = _take(pykmer_tpu_torch.create_fasta_index(
        gz, "s", gz, K, verbose=False, device="cpu",
        config=IndexConfig(kmer_len=K, chunk_windows=512, accumulate=accumulate))
        .index_file_root)
    assert seen == {"read_input": 1}
    _assert_same(want, got)


def test_bgzf_hint_is_the_inflated_size(tmp_path, monkeypatch):
    """The chunk size follows the inflated size, not 4 x the file's."""
    _, plain = _fasta(tmp_path, n_records=200, lengths=(1500,))
    gz = _write(str(tmp_path / "h.fa.gz"), bgzip(plain))
    hints = []
    real = tix.resolve_chunk_windows

    def spy(config, device, input_hint_bytes=None):
        hints.append(input_hint_bytes)
        return real(config, device, input_hint_bytes=input_hint_bytes)

    monkeypatch.setattr(tix, "resolve_chunk_windows", spy)
    _take(pykmer_tpu_torch.create_fasta_index(gz, "s", gz, K, verbose=False, device="cpu")
          .index_file_root)
    assert hints == [len(plain)] and len(plain) < 4 * os.path.getsize(gz)


# ---- spans ------------------------------------------------------------------

def test_bgzf_span_counts_add_up(tmp_path, monkeypatch):
    runs = collections.deque(maxlen=profiling.RUNS_KEPT)
    monkeypatch.setattr(profiling, "FINISHED_RUNS", runs)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR", raising=False)
    monkeypatch.setattr(tseg, "INFLATE_EXTENT", 3000)
    real_inflate = tseg.inflate_blocks

    def slow_inflate(*a):
        import time

        time.sleep(0.003)  # the scan must wait for blocks still inflating
        real_inflate(*a)

    monkeypatch.setattr(tseg, "inflate_blocks", slow_inflate)
    monkeypatch.setattr(tix, "iter_pipelined_chunks",
                        functools.partial(tix.iter_pipelined_chunks, target_segment=8000))
    _, plain = _fasta(tmp_path, n_records=60, lengths=(2000, 700))
    gz = _write(str(tmp_path / "sp.fa.gz"), bgzip(plain, block=900))
    _take(pykmer_tpu_torch.create_fasta_index(
        gz, "s", gz, K, verbose=False, device="cpu",
        config=IndexConfig(kmer_len=K, chunk_windows=2048)).index_file_root)
    (run,) = runs
    by = collections.defaultdict(list)
    for sp in run.spans:
        by[sp.name].append(sp)
    inflate = by["bgzf inflate"]
    assert len(inflate) > 10
    assert sum(s.counts["bytes"] for s in inflate) == len(plain)
    assert sum(s.counts["bytes_in"] for s in inflate) == os.path.getsize(gz)
    assert sum(s.counts["blocks"] for s in inflate) == -(-len(plain) // 900) + 1
    assert not [s for s in inflate if "card_blocks" in s.counts]  # the pool's, not the card's
    assert {s.thread.split("_")[0] for s in inflate} == {"bgzf-inflate"}
    assert {s.parent.name for s in inflate} == {"input read"}
    assert sum(s.counts["bytes"] for s in by["input sha256"]) == os.path.getsize(gz)
    assert sum(s.counts["bytes"] for s in by["decode"]) == len(plain)
    assert by["inflate wait"]
    assert {s.parent.name for s in by["inflate wait"]} == {"input wait"}
    assert not by["card decode"]
    assert [name for name, _ in run.stages][:2] == ["input read", "input read"]


# ---- the runs, the pool's route and the card's wrapper ------------------------

@pytest.mark.parametrize("first,most", [(2000, 2000), (1500, 9000), (1, 1), (700, 1 << 30)])
def test_bgzf_runs_tile_the_blocks_and_ramp(tmp_path, first, most):
    _, plain = _fasta(tmp_path, n_records=80)
    src = tseg.read_bgzf(_write(str(tmp_path / "r.fa.gz"), bgzip(plain, block=300)))
    u = src.u_offs
    runs = tseg.bgzf_runs(u, first, most)
    assert runs[0][0] == 0 and runs[-1][1] == len(u) - 1
    assert all(b0 < b1 for b0, b1 in runs)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    extent = first
    for b0, b1 in runs[:-1]:
        # the fewest whole blocks that reach the run's extent
        assert u[b1] - u[b0] >= extent and (b1 - b0 == 1 or u[b1 - 1] - u[b0] < extent)
        extent = min(2 * extent, most)


def test_pool_route_without_a_card(tmp_path, monkeypatch):
    """Without a card the input keeps the zlib pool: its threads, and runs
    of one size, ``INFLATE_EXTENT``."""
    _, plain = _fasta(tmp_path)
    gz = _write(str(tmp_path / "p.fa.gz"), bgzip(plain, block=500))
    stream = _source(monkeypatch, gz, 3, 2000)
    try:
        assert [t.name for t in stream._inflaters] == [f"bgzf-inflate_{i}" for i in range(3)]
        assert stream._runs == tseg.bgzf_runs(stream._src.u_offs, 2000, 2000)
        stream.wait_until(stream.size)
        assert stream.buf.tobytes() == plain
    finally:
        stream.release()


def test_card_inflate_refuses_cpu_tensors():
    import torch

    from pykmer_tpu_torch.ops import inflate

    offs = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        inflate.inflate_bgzf(torch.zeros(64, dtype=torch.uint8), offs, offs,
                             torch.zeros(8, dtype=torch.uint8),
                             torch.zeros(1, dtype=torch.int32))
    assert inflate.LAUNCHES == 0


def _case_names():
    from bgzf_cases import cases

    return sorted(cases())


@pytest.mark.parametrize("case", _case_names())
def test_host_inflate_of_every_deflate_form(tmp_path, monkeypatch, case):
    """The pool inflates every DEFLATE form of ``tests/bgzf_cases.py`` (the
    card tests' cases) to what ``gzip`` gives."""
    from bgzf_cases import bgzf_bytes, cases

    data = bgzf_bytes(cases()[case])
    stream = _source(monkeypatch, _write(str(tmp_path / "f.gz"), data), 2, 1)
    try:
        stream.wait_until(stream.size)
        assert stream.buf.tobytes() == gzip.decompress(data)
    finally:
        stream.release()


@pytest.mark.parametrize("what", ["crc", "isize", "stream", "truncated"])
def test_host_inflate_raises_on_every_planted_fault(tmp_path, monkeypatch, what):
    from bgzf_cases import bgzf_bytes, cases, corrupt

    data = corrupt(bgzf_bytes(cases()["dynamic_level6"] * 3), what, 1)
    stream = _source(monkeypatch, _write(str(tmp_path / "b.gz"), data), 2, 1)
    try:
        with pytest.raises(IOError):
            stream.wait_until(stream.size)
        assert stream.filled() <= 65280
    finally:
        stream.release()
