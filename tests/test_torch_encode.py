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
    all-valid chunks."""
    from pykmer_tpu.index.indexer import _make_chunk_sorted_codes_cached
    from pykmer_tpu_torch.host.chunks import mask_all_valid
    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes

    chunks, span = _packed_chunks(kmer_len)
    seen = set()
    for b, m in chunks:
        masked = not mask_all_valid(m, span)
        seen.add(masked)
        step = _make_chunk_sorted_codes_cached(kmer_len, span, masked, packed_encode)
        nk0 = jnp.zeros((), dtype=jnp.int64)
        args = (jnp.asarray(b), jnp.asarray(m)) if masked else (jnp.asarray(b),)
        j_sorted, j_nk = step(nk0, *args)
        t_sorted, t_nvalid = chunk_sorted_codes(
            torch.from_numpy(b), torch.from_numpy(m) if masked else None, kmer_len, span)
        _same(t_sorted, j_sorted)
        assert int(t_nvalid) == int(j_nk)
    assert seen == {True, False}
