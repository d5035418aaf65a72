"""The port's encoder (torch ops, CPU) vs ``pykmer_tpu.ops.encode`` (JAX).

Random chunks with N bases, record separators and tail padding are framed
and packed by the port's host layer, then unpacked and encoded by both
packages; every stage must agree exactly (values and dtype).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pykmer_tpu.ops import encode as jenc
from pykmer_tpu_torch.host.chunks import chunk_stream, iter_chunks_packed, pack_base_stream
from pykmer_tpu_torch.ops import encode as tenc

CHUNK_WINDOWS = 200


def _packed_chunks(kmer_len, seed=0, n=1700):
    """(bases2, maskbits) chunks of a random stream: a clean head (so some
    chunks are all-valid), then scattered Ns and K-1 separator runs; the
    framing pads the tail with invalid bases."""
    rng = np.random.default_rng(seed + kmer_len)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    tail = codes[2 * CHUNK_WINDOWS + kmer_len :]
    tail[rng.random(tail.shape[0]) < 0.03] = 4
    for s in rng.integers(0, tail.shape[0] - kmer_len, size=3):
        tail[s : s + kmer_len - 1] = 4
    padded, n_chunks = chunk_stream(codes, kmer_len, CHUNK_WINDOWS)
    assert n_chunks >= 5
    chunks = list(iter_chunks_packed(pack_base_stream(padded), kmer_len,
                                     CHUNK_WINDOWS, n_chunks))
    return chunks, CHUNK_WINDOWS + kmer_len - 1


def _same(t, j):
    j = np.asarray(j)
    got = t.numpy()
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    assert np.array_equal(got, j)


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 11, 13, 15, 17])
def test_unpack_matches(kmer_len):
    chunks, span = _packed_chunks(kmer_len)
    for b, m in chunks:
        _same(tenc.unpack_base_2bit_mask(torch.from_numpy(b), torch.from_numpy(m), span),
              jenc.unpack_base_2bit_mask(jnp.asarray(b), jnp.asarray(m), span))
        _same(tenc.unpack_base_2bit(torch.from_numpy(b), span),
              jenc.unpack_base_2bit(jnp.asarray(b), span))


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 11, 13, 15, 17])
def test_slice_encoder_matches(kmer_len):
    """canonical_codes and fold_codes, int32 up to K=15 and int64 at K=17."""
    chunks, span = _packed_chunks(kmer_len)
    for b, m in chunks:
        chunk = np.asarray(jenc.unpack_base_2bit_mask(jnp.asarray(b), jnp.asarray(m), span))
        t_codes = tenc.canonical_codes(torch.from_numpy(chunk.copy()), kmer_len)
        j_codes = jenc.canonical_codes(jnp.asarray(chunk), kmer_len)
        _same(t_codes, j_codes)
        _same(tenc.fold_codes(t_codes, kmer_len), jenc.fold_codes(j_codes, kmer_len))
    assert tenc.code_dtype(kmer_len) == (torch.int32 if kmer_len <= 15 else torch.int64)


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 11, 13, 15])
def test_slice_encoder_matches_jax_packed(kmer_len):
    """The JAX package encodes all-valid chunks with its bit-field packed
    encoder; the port's one encoder must give the same codes, for the masked
    form on every chunk and the mask-free form on all-valid chunks."""
    chunks, span = _packed_chunks(kmer_len)
    n_all_valid = 0
    for b, m in chunks:
        tb, tm = torch.from_numpy(b), torch.from_numpy(m)
        got = tenc.fold_codes(
            tenc.canonical_codes(tenc.unpack_base_2bit_mask(tb, tm, span), kmer_len), kmer_len)
        _same(got, jenc.canonical_codes_packed(jnp.asarray(b), jnp.asarray(m), span, kmer_len))
        if bool((got < 4**kmer_len // 2).all()):
            n_all_valid += 1
            free = tenc.fold_codes(
                tenc.canonical_codes(tenc.unpack_base_2bit(tb, span), kmer_len), kmer_len)
            _same(free, jenc.canonical_codes_packed(jnp.asarray(b), None, span, kmer_len))
    assert n_all_valid >= 2


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 9, 11, 13, 15])
@pytest.mark.parametrize("packed_encode", [True, False])
def test_chunk_sorted_codes_matches_jax_step_a(kmer_len, packed_encode):
    """The port's step A (encode, fold, sort, valid-window count) against
    the JAX package's program A with either of its encoders, on masked and
    all-valid chunks; and the packed encoder's counter, accumulated over
    every chunk, against program A's nvalid carried from chunk to chunk."""
    from pykmer_tpu.index.indexer import _make_chunk_sorted_codes_cached
    from pykmer_tpu_torch.host.chunks import mask_all_valid
    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes

    chunks, span = _packed_chunks(kmer_len)
    seen = set()
    j_total = 0  # program A donates its running count: carry it as an int
    count = torch.zeros((), dtype=torch.int64)
    for b, m in chunks:
        masked = not mask_all_valid(m, span)
        seen.add(masked)
        step = _make_chunk_sorted_codes_cached(kmer_len, span, masked, packed_encode)
        args = (jnp.asarray(b), jnp.asarray(m)) if masked else (jnp.asarray(b),)
        j_sorted, j_nk = step(jnp.asarray(j_total, dtype=jnp.int64), *args)
        tm = torch.from_numpy(m) if masked else None
        t_sorted, t_nvalid = chunk_sorted_codes(torch.from_numpy(b), tm, kmer_len, span)
        _same(t_sorted, j_sorted)
        assert int(t_nvalid) == int(j_nk) - j_total
        j_total = int(j_nk)
        tenc.canonical_codes_packed(torch.from_numpy(b), tm, span, kmer_len, count=count)
    assert seen == {True, False}
    assert count.dtype == torch.int64 and int(count) == j_total > 0


# ---- canonical_codes_packed: the CUDA kernel's entry, plain on the CPU ------

@pytest.mark.parametrize("kmer_len", [1, 3, 5, 7, 11, 13, 15])
def test_packed_encoder_matches_jax_packed(kmer_len):
    """The port's canonical_codes_packed against the JAX package's bit-field
    encoder, masked on every chunk and mask-free on every chunk (the
    mask-free form reads invalid bases as their packed code 0 in both)."""
    chunks, span = _packed_chunks(kmer_len)
    for b, m in chunks:
        tb, jb = torch.from_numpy(b), jnp.asarray(b)
        want = jenc.canonical_codes_packed(jb, jnp.asarray(m), span, kmer_len)
        count = torch.full((), 3, dtype=torch.int64)
        _same(tenc.canonical_codes_packed(tb, torch.from_numpy(m), span, kmer_len, count),
              want)
        assert int(count) == 3 + int((np.asarray(want) < 4**kmer_len // 2).sum())
        _same(tenc.canonical_codes_packed(tb, None, span, kmer_len),
              jenc.canonical_codes_packed(jb, None, span, kmer_len))


@pytest.mark.parametrize("kmer_len", [17, 19, 21])
def test_packed_encoder_matches_jax_slice_fold(kmer_len):
    """Above K=15 (int64 codes) the JAX package has only its slice encoder:
    unpack, canonical_codes, fold_codes; the port's packed entry must give
    the same codes, masked and mask-free."""
    chunks, span = _packed_chunks(kmer_len)
    for b, m in chunks:
        tb, jb = torch.from_numpy(b), jnp.asarray(b)
        want = jenc.fold_codes(jenc.canonical_codes(
            jenc.unpack_base_2bit_mask(jb, jnp.asarray(m), span), kmer_len), kmer_len)
        _same(tenc.canonical_codes_packed(tb, torch.from_numpy(m), span, kmer_len), want)
        want = jenc.fold_codes(jenc.canonical_codes(
            jenc.unpack_base_2bit(jb, span), kmer_len), kmer_len)
        _same(tenc.canonical_codes_packed(tb, None, span, kmer_len), want)


@pytest.mark.parametrize("kmer_len", [1, 19, 21, 31])
def test_bases_encoder_matches_jax(kmer_len):
    """canonical_codes (the halo encoder's entry) on chunks with invalid
    bases of several codes (4, 5, 255), up to K=31."""
    rng = np.random.default_rng(kmer_len)
    chunk = rng.integers(0, 4, size=900).astype(np.uint8)
    chunk[rng.random(900) < 0.01] = 4
    chunk[rng.integers(0, 900, size=3)] = 5
    chunk[rng.integers(0, 900, size=3)] = 255
    _same(tenc.canonical_codes(torch.from_numpy(chunk), kmer_len),
          jenc.canonical_codes(jnp.asarray(chunk), kmer_len))


@pytest.mark.parametrize("count", [
    torch.zeros((), dtype=torch.int32),  # not int64
    torch.zeros(1, dtype=torch.int64),  # not 0-d
    torch.zeros((), dtype=torch.int64, device="meta"),  # not the planes' device
])
def test_packed_encoder_rejects_a_wrong_counter(count):
    with pytest.raises(ValueError, match="count must be a 0-d int64 tensor on cpu"):
        tenc.canonical_codes_packed(torch.zeros(8, dtype=torch.uint8), None, 20, 5, count)


def test_packed_encoder_rejects_what_the_kernel_cannot_take():
    b = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="kmer_len"):
        tenc.canonical_codes_packed(b, None, 32, 32)
    with pytest.raises(ValueError, match="shorter than one window"):
        tenc.canonical_codes_packed(b, None, 4, 5)
    with pytest.raises(ValueError, match="bases, span"):
        tenc.canonical_codes_packed(b, None, 33, 5)
    with pytest.raises(ValueError, match="bits, span"):
        tenc.canonical_codes_packed(b, torch.zeros(2, dtype=torch.uint8), 20, 5)
    with pytest.raises(ValueError, match="uint8"):
        tenc.canonical_codes_packed(b.to(torch.int32), None, 20, 5)
    with pytest.raises(ValueError, match="contiguous"):
        tenc.canonical_codes(torch.zeros(40, dtype=torch.uint8)[::2], 5)


# ---- K >= 19 at reduced scale ------------------------------------------------

@pytest.mark.parametrize("top", [1 << 38, 1 << 42])
def test_sort_codes_fast_int64_large_codes_match_jax(top):
    """int64 codes up to 2^42 (K=21's unfolded sentinel) with the K=19 and
    K=21 folded and unfolded sentinels, sorted as the JAX package sorts."""
    from pykmer_tpu.ops.histogram import sort_codes_fast as jsort
    from pykmer_tpu_torch.ops.histogram import sort_codes_fast

    rng = np.random.default_rng(top.bit_length())
    codes = rng.integers(0, top, size=5000, dtype=np.int64)
    codes[rng.integers(0, 5000, size=400)] = 4**19 // 2
    codes[rng.integers(0, 5000, size=200)] = 4**19
    codes[rng.integers(0, 5000, size=100)] = min(4**21, top)
    codes[:50] = codes[50]  # a run
    _same(sort_codes_fast(torch.from_numpy(codes)), jsort(jnp.asarray(codes)))


@pytest.mark.parametrize("kmer_len,want", [(17, "device"), (19, "host"), (21, "host")])
def test_strategy_on_an_80gb_card(kmer_len, want):
    """K=17's 8 GiB folded plane fits an 80 GB card; K=19's 128 GiB does
    not, so the CUDA strategy is the host's."""
    from pykmer_tpu_torch.config import resolve_strategy

    assert resolve_strategy(kmer_len, "auto", "cuda", 80e9) == want
    assert tenc.code_dtype(kmer_len) == torch.int64
