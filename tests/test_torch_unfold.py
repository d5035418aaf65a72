"""The card's file-order unfold (``ops/unfold``) on the CPU, through its
plain version: its bytes equal ``ops/readback.unfold_range``'s, byte for
byte, at K = 2..13 (odd, and even with its palindromes) over the whole file
and over first-half, second-half and straddling ranges, and over a 4-shard
interleave; its counts equal ``fast_counts256`` of the folded plane; the
file-order slice loop gives the `.kin` bytes, sha256 and counts of the host
unfold's path (and the JAX package's bytes); and the file-order
``ChaseSink`` writes and hashes each region once, in order, with no
remainder after them; and the card's output lands in the one page-locked
buffer of the process only while no other index holds it and only up to
``PINNED_OUT_MAX`` bytes."""

import hashlib
import os

import numpy as np
import pytest
import torch

from pykmer_tpu.ops import readback as jrb
from pykmer_tpu_torch.formats.header import fast_counts256
from pykmer_tpu_torch.io.direct import DirectWriter
from pykmer_tpu_torch.ops import readback as trb
from pykmer_tpu_torch.ops import unfold
from pykmer_tpu_torch.utils.profiling import StageTimer

K = 9
FULL = 4**K


def _folded(kmer_len, seed=0):
    """A folded plane with zeros, small counts and saturated cells."""
    rng = np.random.default_rng(seed + kmer_len)
    half = 4**kmer_len // 2
    vals = rng.choice(np.array([1, 1, 2, 3, 7, 100, 255], np.uint8), size=half)
    return vals * (rng.random(half) < 0.6).astype(np.uint8)


def _reference(folded, kmer_len):
    out = np.zeros(4**kmer_len, np.uint8)
    trb.unfold_range(folded, out, kmer_len, 0)
    return out


def _ranges(kmer_len):
    """Whole, first-half, second-half and straddling file ranges, none
    aligned to 16 where the plane allows."""
    full = 4**kmer_len
    half = full // 2
    return {"whole": (0, full),
            "first": (half // 3, half - half // 4 - 1),
            "second": (half + half // 4 + 1, full - half // 3),
            "straddle": (half - half // 3 - 1, half + half // 5 + 2)}


@pytest.mark.parametrize("kind", ["whole", "first", "second", "straddle"])
@pytest.mark.parametrize("kmer_len", range(2, 14))
def test_plain_unfold_equals_unfold_range(kmer_len, kind):
    folded = _folded(kmer_len)
    want = _reference(folded, kmer_len)
    a, b = _ranges(kmer_len)[kind]
    lo, hi = unfold.folded_range(kmer_len, a, b)
    got = unfold.unfold_file(torch.from_numpy(folded[lo:hi].copy()), lo, kmer_len, a, b)
    assert got.dtype == torch.uint8 and got.shape == (b - a,)
    assert np.array_equal(got.numpy(), want[a:b])


@pytest.mark.parametrize("kmer_len", [2, 4, 6])
def test_even_k_palindromes_land_in_the_first_half(kmer_len):
    """A palindrome u = rc(u) of even K keeps its count at u; its mirror
    M - u, also a palindrome, stays 0."""
    full = 4**kmer_len
    folded = np.full(full // 2, 9, np.uint8)
    got = unfold.unfold_file(torch.from_numpy(folded), 0, kmer_len, 0, full).numpy()
    assert np.array_equal(got, _reference(folded, kmer_len))
    u = np.arange(full // 2, dtype=np.uint64)
    pal = u[trb._rc_codes_np(u, kmer_len) == u].astype(np.int64)
    assert pal.shape[0] == 4 ** (kmer_len // 2) // 2
    assert (got[pal] == 9).all() and (got[full - 1 - pal] == 0).all()


@pytest.mark.parametrize("kmer_len", [5, 8, 11])
def test_plain_unfold_over_a_4_shard_interleave(kmer_len):
    folded = _folded(kmer_len, seed=3)
    want = _reference(folded, kmer_len)
    shards = [torch.from_numpy(folded[s::4].copy()) for s in range(4)]
    view = trb._interleaved(shards)
    full = 4**kmer_len
    half = full // 2
    for a, b in ((half // 4, half - half // 8), (half + half // 4, full - half // 8),
                 (half - half // 4, half + half // 8)):
        lo, hi = unfold.folded_range(kmer_len, a, b)
        got = unfold.unfold_file(view(lo, hi), lo, kmer_len, a, b)
        assert np.array_equal(got.numpy(), want[a:b]), (a, b)


@pytest.mark.parametrize("kmer_len", [3, 8, 11])
def test_counts_are_the_folded_planes(kmer_len):
    folded = _folded(kmer_len, seed=5)
    full = 4**kmer_len
    plane = torch.from_numpy(folded)
    counts = torch.zeros(256, dtype=torch.int64)
    unfold.unfold_file(plane, 0, kmer_len, full // 2, full, counts)  # the second half: none
    assert not counts.any()
    unfold.unfold_file(plane, 0, kmer_len, 0, full, counts)
    assert np.array_equal(counts.numpy(), fast_counts256(folded))
    assert np.array_equal(counts.numpy(), np.bincount(folded, minlength=256))


def test_folded_range():
    half = FULL // 2
    assert unfold.folded_range(K, 0, FULL) == (0, half)
    assert unfold.folded_range(K, 10, 20) == (10, 20)
    assert unfold.folded_range(K, FULL - 20, FULL - 10) == (10, 20)
    assert unfold.folded_range(K, half - 5, half + 3) == (half - 5, half)
    assert unfold.folded_range(K, half - 5, half + 30) == (half - 30, half)


def test_unfold_file_refuses_what_it_cannot_read():
    plane = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError, match="do not hold"):
        unfold.unfold_file(plane, 0, K, 50, 150)
    with pytest.raises(ValueError, match="do not hold"):
        unfold.unfold_file(plane, 10, K, FULL - 100, FULL - 5)
    with pytest.raises(ValueError, match="within"):
        unfold.unfold_file(plane, 0, K, 5, FULL + 1)
    with pytest.raises(ValueError, match="uint8"):
        unfold.unfold_file(plane.to(torch.int32), 0, K, 0, 10)
    with pytest.raises(ValueError, match="int64"):
        unfold.unfold_file(plane, 0, K, 0, 10, torch.zeros(256, dtype=torch.int32))
    before = unfold.LAUNCHES
    assert unfold.unfold_file(plane, 0, K, 7, 7).shape == (0,)
    assert unfold.LAUNCHES == before  # the plain version launches nothing


def _host_tail(folded, path, slice_cells):
    out = np.full(FULL, 77, np.uint8)
    with DirectWriter(path, size=FULL) as fd:
        counts, hex_ = trb.stream_plane_to_out(torch.from_numpy(folded.copy()), K, out, fd,
                                               slice_cells=slice_cells)
    return counts, hex_


@pytest.mark.parametrize("n_shards,slice_cells", [(1, FULL // 10 + 3), (1, FULL), (4, 6556 * 4)])
def test_file_order_loop_gives_the_host_tails_kin(tmp_path, monkeypatch, n_shards, slice_cells):
    """The file-order slice loop on CPU tensors, through the plain unfold:
    the `.kin`'s bytes, sha256 and counts of the host unfold's tail and the
    JAX package's bytes; its "unfold" spans count 4^K/2 cells, none on the
    card."""
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    folded = _folded(K, seed=11)
    want_counts, want_hex = _host_tail(folded, str(tmp_path / "host"), slice_cells)
    shards = [torch.from_numpy(folded[s::n_shards].copy()) for s in range(n_shards)]
    out = np.full(FULL, 77, np.uint8)
    path = str(tmp_path / "card")
    stages = StageTimer()
    with DirectWriter(path, size=FULL) as fd:
        sink = trb.ChaseSink(out, fd, mirrored=False)
        with stages.stage("copy + unfold"):
            counts = trb._file_order_to_out(shards, K, out, sink, slice_cells)
        hex_ = sink.finish()
    with open(path, "rb") as fh:
        kin = fh.read()
    with open(str(tmp_path / "host"), "rb") as fh:
        assert kin == fh.read()
    assert kin == jrb.unfold_canonical(folded.copy(), K).tobytes()
    assert hex_ == want_hex == hashlib.sha256(kin).hexdigest()
    assert np.array_equal(counts, want_counts)
    spans = [s for s in stages.spans if s.name == "unfold"]
    assert sum(s.counts["cells"] for s in spans) == FULL // 2
    assert sum(s.counts["card_cells"] for s in spans) == 0


def test_file_order_sink_hashes_each_region_once_in_order(tmp_path, monkeypatch):
    """Regions ascend through the whole file; each is written once, at its
    own offset, and hashed as it comes; finish adds no update; a region out
    of order, or a finish short of the file's end, is refused."""
    updates, writes = [], []
    real_update, real_write = trb._spanned_update, trb._spanned_pwrite

    def update(h, arr):
        updates.append(arr.shape[0])
        real_update(h, arr)

    def write(fd, arr, offset):
        writes.append((offset, arr.shape[0]))
        real_write(fd, arr, offset)

    monkeypatch.setattr(trb, "_spanned_update", update)
    monkeypatch.setattr(trb, "_spanned_pwrite", write)
    out = np.random.default_rng(2).integers(0, 256, 1000, dtype=np.uint8)
    path = str(tmp_path / "f")
    bounds = [(0, 300), (300, 500), (500, 900), (900, 1000)]
    with DirectWriter(path, size=1000) as fd:
        sink = trb.ChaseSink(out, fd, mirrored=False)
        for lo, hi in bounds:
            sink.region_done(lo, hi)
        with pytest.raises(ValueError, match="out of order"):
            sink.region_done(0, 10)
        assert sink.finish() == hashlib.sha256(out).hexdigest()
    assert updates == [hi - lo for lo, hi in bounds]
    assert sorted(writes) == [(lo, hi - lo) for lo, hi in bounds]
    with open(path, "rb") as fh:
        assert fh.read() == out.tobytes()
    short = trb.ChaseSink(out, mirrored=False)
    short.region_done(0, 500)  # half the file: a whole file is owed
    with pytest.raises(ValueError, match="not 1000"):
        short.finish()
    short.abort()


def test_mirrored_sink_still_hashes_the_second_half_after_the_loop():
    """The host unfold's layout: first-half regions, then one update of the
    whole second half in finish."""
    out = np.arange(64, dtype=np.uint8)
    sink = trb.ChaseSink(out)
    sink.region_done(0, 20)
    sink.region_done(20, 32)
    with pytest.raises(ValueError, match="out of order"):
        sink.region_done(40, 48)
    assert sink.finish() == hashlib.sha256(out).hexdigest()


class _PinnedStandIn:
    """Stands in for ``host/segments._Pinned``, which needs a card."""

    made = []

    def __init__(self, size):
        self.size, self.array = size, np.zeros(size, np.uint8)
        self.made.append(size)

    def free(self):
        self.array = None


@pytest.fixture
def pinned_out(monkeypatch):
    """A fresh page-locked output pool of stand-in buffers."""
    from pykmer_tpu_torch.host import segments

    _PinnedStandIn.made = []
    monkeypatch.setattr(segments, "_Pinned", _PinnedStandIn)
    pool = segments._PinnedPool()
    monkeypatch.setattr(trb, "PINNED_OUT", pool)
    return pool


def _as_card_planes(monkeypatch):
    """Take a raw CPU plane as the card's: ``card_unfolds`` holds only for
    a CUDA plane."""
    monkeypatch.setattr(trb, "card_unfolds", lambda plane, mode: mode == "raw")


def test_output_array_pins_one_output_at_a_time(pinned_out, monkeypatch):
    """The card's output lands in the pooled page-locked buffer; a second
    index while the first holds it (as two indexes in threads of one
    process) gets a pageable array rather than an error; the buffer is
    given back at the end of the block, also where the block raises."""
    _as_card_planes(monkeypatch)
    plane = torch.zeros(8, dtype=torch.uint8)
    stages = StageTimer()
    with trb.output_array(plane, "raw", 1000, stages) as first:
        pooled = pinned_out._buf.array
        assert np.shares_memory(first, pooled) and first.shape == (1000,)
        with trb.output_array(plane, "raw", 1000, stages) as second:
            assert second.shape == (1000,) and not np.shares_memory(second, pooled)
    with pytest.raises(KeyError):
        with trb.output_array(plane, "raw", 600, stages) as again:
            assert np.shares_memory(again, pooled)
            raise KeyError("the tail failed")
    with trb.output_array(plane, "raw", 1000, stages) as again:
        assert np.shares_memory(again, pooled)
    assert _PinnedStandIn.made == [1000]


@pytest.mark.parametrize("case", ["over the cap", "packed", "plane on the cpu"])
def test_output_array_is_pageable_where_the_card_output_is_not_pooled(
        pinned_out, monkeypatch, case):
    """No page-locked output above ``PINNED_OUT_MAX`` (16 GiB at K=17 would
    stay locked for the life of the process), for a mode the host unfolds,
    or for a plane on the CPU; the pool is neither leased nor grown."""
    plane = torch.zeros(8, dtype=torch.uint8)
    mode, size = "raw", 1000
    if case != "plane on the cpu":
        _as_card_planes(monkeypatch)
    if case == "over the cap":
        monkeypatch.setattr(trb, "PINNED_OUT_MAX", size - 1)
    elif case == "packed":
        mode = "packed"
    with trb.output_array(plane, mode, size, StageTimer()) as out:
        assert out.shape == (size,) and out.dtype == np.uint8
    assert _PinnedStandIn.made == [] and pinned_out._buf is None


def test_card_unfolds_only_a_raw_plane_on_cuda():
    """The one rule of the card's unfold, from what the code can see: the
    plane's device (a sharded run's first local plane) and the tail."""
    cpu = torch.zeros(8, dtype=torch.uint8)
    meta = torch.empty(8, dtype=torch.uint8, device="meta")
    for plane in (cpu, [cpu, cpu], meta):
        for mode in ("raw", "packed", "sparse"):
            assert not trb.card_unfolds(plane, mode)
