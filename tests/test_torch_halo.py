"""The port's halo encoder (``pykmer_tpu_torch.parallel.make_halo_encode``)
against the JAX package's on its 8-device virtual CPU mesh.

The port's meshes repeat the CPU device. Every comparison is exact: the
codes' values and dtype (unfolded, sentinel 4^K at invalid windows and past
the sequence's end), at K=7 (int32) and K=19 (int64), on a 1x8 and a 2x4
mesh.
"""

import numpy as np
import pytest
import torch

from pykmer_tpu.oracle import oracle_canonical_codes
from pykmer_tpu.parallel import make_halo_encode as jmake_halo_encode
from pykmer_tpu.parallel.mesh import make_mesh as jmake_mesh
from pykmer_tpu_torch.parallel import make_halo_encode, make_mesh


def _seq(seed, n):
    """Random bases with scattered invalid codes 4."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, size=n).astype(np.uint8)
    seq[rng.random(n) < 0.02] = 4
    return seq


@pytest.mark.parametrize("kmer_len", [7, 19])
@pytest.mark.parametrize("n_data,n_shards,shard_len", [(1, 8, 64), (2, 4, 48), (1, 8, 18)])
def test_halo_encode_matches_jax(kmer_len, n_data, n_shards, shard_len):
    """(1, 8, 18) at K=19: every shard is exactly its neighbour's halo."""
    seq = _seq(kmer_len * 100 + shard_len, n_shards * shard_len)
    want = np.asarray(jmake_halo_encode(
        jmake_mesh(n_shards=n_shards, n_data=n_data), kmer_len, shard_len)(seq))
    got = make_halo_encode(make_mesh(n_shards, n_data, device="cpu"), kmer_len, shard_len)(seq)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    sentinel = 4**kmer_len
    assert (want[-(kmer_len - 1):] == sentinel).all()
    assert np.array_equal(want[want < sentinel], oracle_canonical_codes(seq, kmer_len))


def test_halo_encode_shard_len_equal_to_the_halo():
    """shard_len == K-1: each shard's whole sequence is its neighbour's halo."""
    k, n_shards = 7, 8
    seq = _seq(1, n_shards * (k - 1))
    want = np.asarray(jmake_halo_encode(jmake_mesh(n_shards=n_shards), k, k - 1)(seq))
    got = make_halo_encode(make_mesh(n_shards, device="cpu"), k, k - 1)(torch.from_numpy(seq))
    assert np.array_equal(got.numpy(), want)


def test_halo_encode_rejects_short_shards():
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="halo"):
        make_halo_encode(mesh, 19, 17)
    with pytest.raises(ValueError, match="halo"):
        make_halo_encode(mesh, 1, 0)
    encode = make_halo_encode(mesh, 7, 64)
    with pytest.raises(ValueError, match="uint8"):
        encode(np.zeros(8 * 64 - 1, dtype=np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        encode(np.zeros(8 * 64, dtype=np.int32))
