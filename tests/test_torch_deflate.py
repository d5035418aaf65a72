"""The card deflate's plain version (``ops/deflate.py``) on the CPU: every
raw stream equals the standard library's zlib level 6
(``zlib.compressobj(6, DEFLATED, -15)``) byte for byte, on payloads that
reach each rule the bytes depend on: the empty and tiny payloads, a zero
run, incompressible bytes (stored blocks), matches across MAX_DIST (32,506)
as a chain's head and further down it, 3-byte matches at distance 4,096 and
4,097 (TOO_FAR), matches that reach the payload's last byte, more than
16,383 symbols (several DEFLATE blocks, one ending exactly at the payload's
end), a head that zlib's slide of its window at 65,274 turns into NIL, a
code whose optimal lengths pass their limit, and every block of small
`.kin` files. Then the wrapper's Device rule: a CPU tensor takes the
host's zlib, any other device but CUDA is refused."""

import heapq
import itertools
import os
import zlib

import numpy as np
import pytest
import torch

import deflate_cases
from conftest import make_random_fasta

from pykmer_tpu_torch import create_fasta_index, testgen
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.io import bgzf
from pykmer_tpu_torch.ops import deflate

BLOCK = deflate.BLOCK


def _zlib(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


def _check(payload) -> None:
    data = bytes(payload)
    assert deflate.deflate_raw(np.frombuffer(data, dtype=np.uint8)) == _zlib(data)


@pytest.mark.parametrize("name", deflate_cases.NAMES)
def test_raw_stream_equals_zlib(name):
    _check(deflate_cases.case(name))


def test_empty_payload_is_the_fixed_empty_block():
    assert deflate.deflate_raw(np.zeros(0, np.uint8)) == b"\x03\x00"


def test_last_block_ends_on_the_last_byte():
    """The case's 16,383rd symbol ends the payload: two blocks, the last
    with no symbols."""
    payload = np.frombuffer(deflate_cases.case("last-block-empty"), dtype=np.uint8)
    blocks = list(deflate.parse(payload))
    assert len(blocks) == 2 and len(blocks[0][2]) == deflate.SYMBOLS_PER_BLOCK
    assert blocks[1][:3] == (payload.shape[0], payload.shape[0], [])


def test_slid_head_is_not_searched(monkeypatch):
    """At 65,274 zlib has slid its window, and the marker's head, exactly
    MAX_DIST back at 32,768, is NIL: a window that never slid would take
    the marker there, and its bytes would not be zlib's."""
    payload = deflate_cases.case("slid-head-65274")
    _check(payload)
    monkeypatch.setattr(deflate, "SLIDE_AT", 1 << 20)
    assert deflate.deflate_raw(np.frombuffer(payload, dtype=np.uint8)) != _zlib(payload)


@pytest.mark.parametrize("start", [20000, 32767, 32768])
def test_no_stored_block_once_its_start_slid_out(start):
    """Once the window has slid (by 32,768), a DEFLATE block that starts
    below 32,768 has no bytes in it, and zlib does not store it (no payload
    of the cases gets there: such a block spans 32,512 bytes or more in
    16,383 symbols, and compresses). Random literals, which are stored
    where they may be, then go as a fixed or dynamic block that inflates to
    them."""
    payload = np.random.default_rng(9).integers(0, 256, BLOCK, dtype=np.uint8)
    end = start + deflate.SYMBOLS_PER_BLOCK
    syms = [(0, b) for b in payload[start:end].tolist()]
    kinds = []
    for slid in (False, True):
        out = deflate._Bits()
        deflate._flush_block(out, payload, start, end, syms, True, slid)
        raw = out.tobytes()
        assert zlib.decompressobj(-15).decompress(raw) == payload[start:end].tobytes()
        kinds.append(raw[0] >> 1 & 3)  # BTYPE: 0 stored, 1 fixed, 2 dynamic
    assert kinds[0] == 0
    assert (kinds[1] == 0) == (start >= 32768)


def _optimal_depth(freqs) -> int:
    """The deepest code of an unlimited Huffman code of ``freqs``."""
    count = itertools.count()
    heap = [(f, next(count), {i: 0}) for i, f in enumerate(freqs) if f]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, next(count), {k: v + 1 for k, v in {**a, **b}.items()}))
    return max(heap[0][2].values())


def test_code_over_its_length_limit(monkeypatch):
    """zlib's ``gen_bitlen`` repairs a code whose optimal lengths pass its
    limit; the bytes still equal zlib's."""
    payload = deflate_cases.case("code-over-its-limit")
    depths = []
    build = deflate.build_tree

    def spy(freq, elems, *rest):
        depths.append((elems, rest[3], _optimal_depth(freq[:elems])))
        return build(freq, elems, *rest)

    monkeypatch.setattr(deflate, "build_tree", spy)
    _check(payload)
    assert any(depth > limit for _, limit, depth in depths)


@pytest.fixture(scope="module")
def small_kins(tmp_path_factory):
    """The `.kin` of the enumeration fixture and of a random genome, at
    K=9 (five blocks each)."""
    root = tmp_path_factory.mktemp("kins")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        enum = os.path.abspath(testgen.create_test_fasta("enum", 9))
    finally:
        os.chdir(cwd)
    rand = make_random_fasta(str(root / "r.fa"), np.random.default_rng(5), n_records=4,
                             lengths=(40_000, 9000, 20_000, 3000))
    kins = []
    for fasta, k in ((enum, 9), (rand, 9)):
        header = create_fasta_index(fasta, "s", fasta, k, verbose=False, device="cpu",
                                    config=IndexConfig(kmer_len=k, chunk_windows=4096))
        kins.append(np.fromfile(header.index_file_root, dtype=np.uint8))
    return kins


@pytest.mark.parametrize("which", [0, 1], ids=["enum-k9", "random-k9"])
def test_every_block_of_a_small_kin(small_kins, which):
    kin = small_kins[which]
    for a in range(0, kin.shape[0], BLOCK):
        _check(kin[a: a + BLOCK])


def test_members_are_bgzip_kins(small_kins, tmp_path):
    """The members around the plain streams are ``io/bgzf.bgzip_kin``'s
    `.kin.bgz` blocks."""
    kin = small_kins[1]
    path = str(tmp_path / "m.kin")
    kin.tofile(path)
    bgzf.bgzip_kin(path)
    with open(path + ".bgz", "rb") as fh:
        want = fh.read()
    got = b"".join(deflate.member(kin[a: a + BLOCK].tobytes(),
                                  deflate.deflate_raw(kin[a: a + BLOCK]))
                   for a in range(0, kin.shape[0], BLOCK))
    assert got + bgzf.BGZF_EOF == want


def test_cpu_tensor_takes_the_host_zlib(small_kins):
    kin = small_kins[1]
    before = deflate.LAUNCHES
    members, sizes = deflate.deflate_bgzf(torch.from_numpy(kin.copy()))
    want = [deflate.member(kin[a: a + BLOCK].tobytes(), _zlib(kin[a: a + BLOCK].tobytes()))
            for a in range(0, kin.shape[0], BLOCK)]
    assert sizes.tolist() == [len(m) for m in want]
    assert members.numpy().tobytes()[: int(sizes.sum())] == b"".join(want)
    assert deflate.LAUNCHES == before


def test_other_devices_and_tensors_are_refused():
    with pytest.raises(ValueError, match="no deflate for device meta"):
        deflate.deflate_bgzf(torch.empty(8, dtype=torch.uint8, device="meta"))
    for bad in (torch.zeros(8, dtype=torch.int32), torch.zeros((2, 4), dtype=torch.uint8),
                torch.zeros(16, dtype=torch.uint8)[::2]):
        with pytest.raises(ValueError, match="contiguous 1-D uint8"):
            deflate.deflate_bgzf(bad)


def test_length_and_distance_codes_are_zlibs():
    """``length_code`` and ``dist_code`` against the ranges RFC 1951 gives
    each code."""
    for lc in range(256):
        c = deflate.length_code(lc)
        if lc == 255:
            assert c == 28
        else:
            assert deflate.BASE_LENGTH[c] <= lc < deflate.BASE_LENGTH[c] \
                + (1 << deflate.EXTRA_LBITS[c])
    for d in range(32768):
        c = deflate.dist_code(d)
        assert deflate.BASE_DIST[c] <= d < deflate.BASE_DIST[c] + (1 << deflate.EXTRA_DBITS[c])
