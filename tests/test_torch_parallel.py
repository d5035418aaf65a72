"""The port's multi-device modules (``pykmer_tpu_torch.parallel``) vs the JAX
package's on its 8-device virtual CPU mesh.

The port's meshes repeat the CPU device (``make_mesh(..., device="cpu")``),
the counterpart of that virtual mesh. Every comparison is exact (integer
counts, tolerance 0): the copied numpy helpers and the checkpoint files
against their originals, the sharded step's state after every step against
JAX's (dense ``[S, local]``, ``num_valid``, ``max_bucket``, ``capacity``),
and the sharded merge step and pair matrix against JAX's.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pykmer_tpu.oracle import oracle_canonical_codes, oracle_count_stream
from pykmer_tpu.ops.encode import chunk_stream as jchunk_stream
from pykmer_tpu.ops.readback import unfold_canonical
from pykmer_tpu.parallel import compare as jcmp
from pykmer_tpu.parallel import histogram as jhist
from pykmer_tpu.parallel import multihost as jmh
from pykmer_tpu.parallel.mesh import SHARD_AXIS as JSHARD_AXIS
from pykmer_tpu.parallel.mesh import make_mesh as jmake_mesh
from pykmer_tpu_torch.host.chunks import chunk_stream
from pykmer_tpu_torch.ops import readback
from pykmer_tpu_torch.parallel import collectives, compare, histogram, multihost
from pykmer_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, make_mesh
from pykmer_tpu_torch.state import shards_from_numpy, shards_to_numpy

CPU = torch.device("cpu")
MESHES = [(1, 1), (1, 2), (2, 4), (1, 8)]


# ---- the copied numpy helpers ----------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_interleave_helpers_match_jax(rng, n_shards):
    flat = rng.integers(0, 256, size=1024).astype(np.uint8)
    shards = histogram.flat_to_interleaved(flat, n_shards)
    assert np.array_equal(shards, jhist.flat_to_interleaved(flat, n_shards))
    assert np.array_equal(histogram.interleaved_to_flat(shards),
                          jhist.interleaved_to_flat(shards))
    assert np.array_equal(histogram.interleaved_to_flat(shards), flat)


@pytest.mark.parametrize("n_rows,step", [(1, 0), (4, 0), (4, 2), (8, 5)])
def test_shard_batch_chunks_match_jax(rng, n_rows, step):
    k, cw = 5, 64
    seq = rng.integers(0, 5, size=1500).astype(np.uint8)
    padded, _ = jchunk_stream(seq, k, cw)
    assert np.array_equal(histogram.shard_batch_chunks(padded, k, cw, n_rows, step),
                          jhist.shard_batch_chunks(padded, k, cw, n_rows, step))
    got = histogram.shard_batch_chunks_packed(padded, k, cw, n_rows, step)
    want = jhist.shard_batch_chunks_packed(padded, k, cw, n_rows, step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoints_cross_packages(tmp_path, rng):
    """Each package loads the other's checkpoint; the files are the same."""
    dense = rng.integers(0, 256, size=(4, 64)).astype(np.uint8)
    meta = {"kmer_len": 5, "chunk_windows": 64, "rows": 4, "input_size": 99}
    files = []
    for save, load, name in ((multihost.save_shard_checkpoint, jmh.load_shard_checkpoint, "t"),
                             (jmh.save_shard_checkpoint, multihost.load_shard_checkpoint, "j")):
        tmp = str(tmp_path / f"{name}.kin.tmp")
        save(tmp, dense, next_step=3, num_kmers=1234, meta=meta, max_bucket=17)
        save(tmp, dense, next_step=5, num_kmers=2345, meta=meta, max_bucket=19)
        got, state = load(tmp)
        assert np.array_equal(got, dense)
        assert state == {**meta, "next_step": 5, "num_kmers": 2345,
                         "dense_file": "dense.5.npy", "max_bucket": 19}
        d = multihost.checkpoint_dir(tmp)
        assert d == jmh.checkpoint_dir(tmp)
        files.append({f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))})
        multihost.clear_shard_checkpoint(tmp)
        assert not os.path.exists(d) and multihost.load_shard_checkpoint(tmp) is None
    assert files[0] == files[1]


# ---- mesh and collectives ----------------------------------------------------

def test_make_mesh_shapes_and_errors():
    m = make_mesh(4, 2, device="cpu")
    assert m.shape == {DATA_AXIS: 2, SHARD_AXIS: 4} and m.first == CPU
    assert make_mesh(device="cpu").shape == {DATA_AXIS: 1, SHARD_AXIS: 1}
    m = make_mesh(n_data=2, devices=["cpu"] * 6)
    assert m.shape == {DATA_AXIS: 2, SHARD_AXIS: 3}
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh(4, 2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="positive"):
        make_mesh(0, device="cpu")


def test_make_mesh_cuda_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)


def test_collectives_order():
    devs = [CPU] * 3
    send = [torch.arange(6).reshape(3, 2) + 10 * i for i in range(3)]
    recv = collectives.all_to_all(send, devs)
    for j in range(3):
        # row i of destination j is row j of source i
        assert torch.equal(recv[j], torch.stack([send[i][j] for i in range(3)]))
    parts = [torch.full((2, 3), r) for r in range(2)]
    for g in collectives.all_gather(parts, [CPU, CPU]):
        assert torch.equal(g, torch.cat(parts))
    assert collectives.all_gather(parts[:1], [CPU])[0] is parts[0]
    vals = [torch.tensor(v) for v in (3, 9, 4)]
    assert int(collectives.psum(vals, CPU)) == 16 and int(vals[0]) == 3
    assert int(collectives.pmax(vals, CPU)) == 9
    with pytest.raises(ValueError, match="all_to_all"):
        collectives.all_to_all(send[:2], devs)


def test_ppermute_order():
    """jax.lax.ppermute's semantics: part i lands at j for each (i, j);
    positions no pair sends to receive zeros; a repeated source or
    destination, or a position out of range, raises."""
    parts = [torch.full((2,), 10 * i + 1) for i in range(4)]
    ring = collectives.ppermute(parts, [(i, (i - 1) % 4) for i in range(4)])
    for j in range(4):
        assert torch.equal(ring[j], parts[(j + 1) % 4])
    out = collectives.ppermute(parts, [(0, 2), (3, 1)])
    assert [o.tolist() for o in out] == [[0, 0], [31, 31], [1, 1], [0, 0]]
    for bad in ([(0, 1), (2, 1)], [(0, 1), (0, 2)], [(0, 4)], [(-1, 0)]):
        with pytest.raises(ValueError, match="ppermute"):
            collectives.ppermute(parts, bad)


# ---- the sharded step --------------------------------------------------------

def _run_both(seq, k, cw, n_data, n_shards, capacity_factor=2.0, check_each=True):
    """The JAX and the port's sharded steps over ``seq``, compared after
    every step; returns the final (JAX state, port state, port step_fn)."""
    jinit, jstep = jhist.make_sharded_accumulate(
        jmake_mesh(n_shards=n_shards, n_data=n_data), k, cw, capacity_factor)
    tinit, tstep = histogram.make_sharded_accumulate(
        make_mesh(n_shards, n_data, device="cpu"), k, cw, capacity_factor)
    for attr in ("capacity", "rows", "span", "local_size", "n_shards"):
        assert getattr(tstep, attr) == getattr(jstep, attr), attr
    jpad, n_chunks = jchunk_stream(seq, k, cw)
    tpad, t_chunks = chunk_stream(seq.copy(), k, cw)
    assert n_chunks == t_chunks
    n_steps = -(-n_chunks // tstep.rows)
    js, ts = jinit(), tinit()
    for s in range(n_steps):
        js = jstep(js, jhist.shard_batch_chunks_packed(jpad, k, cw, jstep.rows, s))
        ts = tstep(ts, histogram.shard_batch_chunks_packed(tpad, k, cw, tstep.rows, s))
        if check_each or s == n_steps - 1:
            assert np.array_equal(shards_to_numpy(ts[0]), np.asarray(js[0]))
            assert int(ts[1]) == int(js[1]) and int(ts[2]) == int(js[2])
    return js, ts, tstep


@pytest.mark.parametrize("n_data,n_shards", MESHES)
def test_sharded_step_matches_jax(rng, n_data, n_shards):
    k, cw = 5, 128
    seq = rng.integers(0, 5, size=4000).astype(np.uint8)
    _, ts, tstep = _run_both(seq, k, cw, n_data, n_shards)
    planes, nk, maxb = ts
    assert int(maxb) <= tstep.capacity
    want_codes = oracle_canonical_codes(seq, k)
    want = oracle_count_stream([want_codes], k, flush_every=10**9)
    got = unfold_canonical(histogram.interleaved_to_flat(shards_to_numpy(planes)), k)
    assert int(nk) == want_codes.shape[0] and np.array_equal(got, want)


def test_sharded_replicas_stay_equal(rng):
    seq = rng.integers(0, 5, size=3000).astype(np.uint8)
    _, (planes, _, _), _ = _run_both(seq, 5, 64, 2, 4, check_each=False)
    for s in range(4):
        assert torch.equal(planes[0][s], planes[1][s])
        assert int(planes[0][s].sum()) > 0


def test_sharded_saturation_matches_jax():
    # one code repeated 600x: saturates at 255, one bucket takes every code
    seq = np.zeros(600 + 2, dtype=np.uint8)
    _, (planes, nk, _), _ = _run_both(seq, 3, 600, 1, 2)
    flat = unfold_canonical(histogram.interleaved_to_flat(shards_to_numpy(planes)), 3)
    assert flat[0] == 255 and int(nk) == 600


def test_sharded_overflow_matches_jax():
    seq = np.zeros(4096 + 4, dtype=np.uint8)
    _, (_, _, maxb), tstep = _run_both(seq, 5, 4096, 1, 8, capacity_factor=0.5)
    assert int(maxb) == 4096 > tstep.capacity == 256


def test_sharded_int64_local_path(rng, monkeypatch):
    """With the int32 threshold lowered, the local codes go to the sweep as
    int64 and the state still equals JAX's (whose local plane is int32)."""
    seen = []
    real = histogram.accumulate_sorted

    def spy(plane, codes):
        seen.append(codes.dtype)
        return real(plane, codes)

    monkeypatch.setattr(histogram, "MAX_INT32_LOCAL_CELLS", 100)
    monkeypatch.setattr(histogram, "accumulate_sorted", spy)
    seq = rng.integers(0, 5, size=2000).astype(np.uint8)
    _run_both(seq, 5, 128, 1, 2)  # local plane of 256 cells > 100
    assert seen and set(seen) == {torch.int64}
    seen.clear()
    _run_both(seq, 5, 128, 1, 4)  # 128 cells: still int64
    _, _, tstep = _run_both(seq, 5, 128, 1, 8)  # 64 cells: int32
    assert tstep.local_size == 64 and torch.int32 in seen


def test_sharded_step_launches_per_row(rng, monkeypatch):
    """Each position applies every received row with one sweep call: (R·S)^2
    calls per step, each on one ascending row of ``capacity`` codes."""
    calls = []
    real = histogram.accumulate_sorted

    def spy(plane, codes):
        calls.append(codes.shape[0])
        return real(plane, codes)

    monkeypatch.setattr(histogram, "accumulate_sorted", spy)
    init, step = histogram.make_sharded_accumulate(make_mesh(2, 2, device="cpu"), 5, 64)
    seq = rng.integers(0, 4, size=600).astype(np.uint8)
    pad, _ = chunk_stream(seq, 5, 64)
    step(init(), histogram.shard_batch_chunks_packed(pad, 5, 64, 4, 0))
    assert calls == [step.capacity] * 16


def test_sharded_step_rejects_bad_mesh_and_rows():
    with pytest.raises(ValueError, match="power of two"):
        histogram.make_sharded_accumulate(make_mesh(3, device="cpu"), 5, 64)
    init, step = histogram.make_sharded_accumulate(make_mesh(2, device="cpu"), 5, 64)
    with pytest.raises(ValueError, match="takes 2 rows"):
        step(init(), (np.zeros((3, 17), np.uint8), np.zeros((3, 9), np.uint8)))


def test_shards_state_roundtrip(rng):
    mesh = make_mesh(4, 2, device="cpu")
    arr = rng.integers(0, 256, size=(4, 32)).astype(np.uint8)
    planes = shards_from_numpy(arr, mesh)
    assert len(planes) == 2 and all(len(r) == 4 for r in planes)
    assert planes[0][1] is not planes[1][1] and torch.equal(planes[0][1], planes[1][1])
    assert np.array_equal(shards_to_numpy(planes), arr)
    with pytest.raises(ValueError, match="uint8"):
        shards_from_numpy(arr[:2], mesh)


# ---- the sharded readback source ------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 8])
def test_readback_sharded_source_matches_flat(rng, n_shards):
    k = 5
    flat = rng.integers(0, 256, size=4**k // 2).astype(np.uint8)
    flat[rng.random(flat.shape[0]) < 0.5] = 0
    shards = [torch.from_numpy(s.copy())
              for s in histogram.flat_to_interleaved(flat, n_shards)]
    results = []
    for plane in (torch.from_numpy(flat), shards):
        out = np.empty(4**k, dtype=np.uint8)
        counts, sha = readback.stream_plane_to_out(plane, k, out, slice_cells=64)
        results.append((out, counts, sha))
    assert np.array_equal(results[0][0], results[1][0])
    assert np.array_equal(results[0][1], results[1][1])
    assert results[0][2] == results[1][2] == hashlib.sha256(results[0][0]).hexdigest()
    with pytest.raises(ValueError, match="equal in size"):
        readback.stream_plane_to_out([shards[0], shards[1][:3]], k, out)


# ---- the sharded merge step and pair matrix --------------------------------

def _jax_shard_mesh(n_shards):
    return JaxMesh(np.array(jax.devices()[:n_shards]).reshape(n_shards), (JSHARD_AXIS,))


@pytest.mark.parametrize("n,n_shards", [(3, 2), (5, 4), (2, 8)])
def test_sharded_merge_step_matches_jax(rng, n, n_shards):
    jstep = jcmp.make_sharded_merge_step(_jax_shard_mesh(n_shards), n)
    mesh = make_mesh(n_shards, device="cpu")
    tstep = compare.make_sharded_merge_step(mesh, n)
    assert tstep.n_shards == jstep.n_shards == n_shards
    jacc = jax.device_put(jnp.zeros((n, n), dtype=jnp.int64), jstep.acc_sharding)
    tacc = torch.zeros((n, n), dtype=torch.int64)
    want = np.zeros((n, n), dtype=np.int64)
    for _ in range(2):
        counts = rng.integers(0, 6, size=(n, 8 * n_shards * 37)).astype(np.uint8)
        valid = (counts >= 1) & (counts <= 4)
        jacc = jstep(jacc, np.packbits(valid, axis=1))  # the JAX step's bit order
        tbits = np.packbits(valid, axis=1, bitorder="little")
        assert tstep(tacc, compare.shard_bits(tbits, mesh)) is tacc
        want += valid.astype(np.int64) @ valid.T.astype(np.int64)
    assert np.array_equal(tacc.numpy(), np.asarray(jacc))
    assert np.array_equal(tacc.numpy(), want)


def test_sharded_pair_matrix_matches_jax(rng):
    n, cells = 5, 97
    blocks = rng.integers(0, 8, size=(n, 8 * cells)).astype(np.uint8)
    want = np.asarray(jcmp.make_sharded_pair_matrix(
        jmake_mesh(n_shards=8, n_data=1), n, cells, 1, 5)(blocks))
    got = compare.make_sharded_pair_matrix(make_mesh(8, device="cpu"), n, cells, 1, 5)(blocks)
    assert np.array_equal(got.numpy(), want)
    v = ((blocks >= 1) & (blocks <= 5)).astype(np.int64)
    assert np.array_equal(want, v @ v.T)


def test_sharded_compare_rejects_data_rows():
    with pytest.raises(ValueError, match="one data row"):
        compare.make_sharded_merge_step(make_mesh(2, 2, device="cpu"), 3)
    with pytest.raises(ValueError, match="do not split"):
        compare.shard_bits(np.zeros((2, 9), np.uint8), make_mesh(2, device="cpu"))
