"""The port's readback modes vs ``pykmer_tpu.ops.readback`` (JAX), on the CPU.

The same seeded numpy planes go through the JAX function and its port, and
every result must be equal exactly: the three fixed-width packs and the
escape counts, the host unpacks, ``pack_sparse_segment`` at densities 0, 0.08
and 0.6 (gaps over 83, values >= 3, a ragged segment), ``pick_mode``,
``fetch_dense``, the chased tail in every mode (the file's bytes, its sha256
and the 256-bin counts), and the arena-free pieces tail (the JAX function
run on two sub-planes of the same plane), with its 2-bit fallback, and the
port's chooser keeping a dense plane off it as the JAX package's gate does. The shapes are those of
``tests/test_readback_sparse.py`` and ``tests/test_ops.py``.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykmer_tpu.ops import readback as jrb
from pykmer_tpu_torch.io.direct import DirectWriter
from pykmer_tpu_torch.ops import packing
from pykmer_tpu_torch.ops import readback as trb
from pykmer_tpu_torch.utils.profiling import StageTimer

K = 9
FOLD = 4**K // 2


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _folded_plane(rng, fold, density, long_zero_runs=True):
    """The plane of tests/test_readback_sparse.py: values with escapes at
    every width, zero runs far beyond the 83-cell token gap."""
    folded = np.zeros(fold, dtype=np.uint8)
    nz = rng.random(fold) < density
    vals = rng.choice([1, 1, 1, 1, 1, 2, 2, 3, 7, 15, 100, 255], size=fold).astype(np.uint8)
    folded[nz] = vals[nz]
    if long_zero_runs:
        folded[:3000] = 0
        folded[fold // 3 : fold // 3 + 5000] = 0
    return folded


def _escape_heavy(rng, fold=FOLD):
    """The plane of tests/test_ops.py's readback tests."""
    return rng.integers(0, 64, fold, dtype=np.uint8) * (rng.random(fold) < 0.3)


def _jax_plane(folded):
    return jnp.asarray(folded.reshape(-1, 128))


def _sparse_knobs(monkeypatch, seg, min_cells=1):
    """The JAX package's sparse environment and the port's constants, alike."""
    monkeypatch.setenv("PYKMER_TPU_SPARSE_SEG", str(seg))
    monkeypatch.setenv("PYKMER_TPU_SPARSE_MIN", str(min_cells))
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", seg)
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", min_cells)


def _block_native(monkeypatch):
    monkeypatch.setitem(sys.modules, "pykmer_tpu_torch.io.native", None)
    monkeypatch.setitem(sys.modules, "pykmer_tpu.io.native", None)


# ---- device packs, escape counts, host unpacks ------------------------------------

@pytest.mark.parametrize("plane", ["escapes", "uniform"])
@pytest.mark.parametrize("width,jpack,junpack", [
    (2, jrb.pack_2bit, jrb.unpack_2bit),
    (3, jrb.pack_3bit, jrb.unpack_3bit),
    (4, jrb.pack_nibbles, jrb.unpack_nibbles),
])
def test_packs_match_jax(rng, monkeypatch, plane, width, jpack, junpack):
    folded = _escape_heavy(rng) if plane == "escapes" \
        else rng.integers(0, 256, FOLD, dtype=np.uint8)
    want = np.asarray(jpack(_jax_plane(folded))).reshape(-1)
    got = packing.PACKS[width](torch.from_numpy(folded)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert got.shape[0] == packing.packed_len(FOLD, width)
    clipped = np.minimum(folded, packing.ESCAPE_OF_WIDTH[width])
    assert np.array_equal(trb.unpack(got, width), junpack(want))
    assert np.array_equal(trb.unpack(got, width), clipped)
    _block_native(monkeypatch)  # the numpy unpacks, in both packages
    assert np.array_equal(trb.unpack(got, width), junpack(want))


def test_count_all_escapes_matches_jax(rng, monkeypatch):
    folded = _folded_plane(rng, FOLD, 0.2, long_zero_runs=False)
    want = tuple(int(v) for v in jrb.count_all_escapes(_jax_plane(folded)))
    assert packing.count_all_escapes(torch.from_numpy(folded)) == want
    # several reductions over the plane: the same sums
    monkeypatch.setattr(packing, "COUNT_SLICE_CELLS", 1 << 12)
    assert packing.count_all_escapes(torch.from_numpy(folded)) == want
    for n in (0, 5, 128, 1000, 12345):  # whole 128-cell rows and a ragged rest
        for t in (1, 3, 255):
            got = packing.count_at_least(torch.from_numpy(folded[:n]), t)
            assert got.dtype == torch.int64 and int(got) == int((folded[:n] >= t).sum())


def test_gather_cells_takes_int64_indices(rng):
    folded = rng.integers(0, 256, FOLD, dtype=np.uint8)
    idx = np.array([0, 7, FOLD - 1, 12345], dtype=np.uint32)
    assert np.array_equal(packing.gather_cells(torch.from_numpy(folded), idx), folded[idx])


# ---- the sparse token stream --------------------------------------------------------

@pytest.mark.parametrize("cells", [1 << 15, 3 * (1 << 13)])
@pytest.mark.parametrize("density", [0.0, 0.08, 0.6])
def test_pack_sparse_segment_matches_jax(rng, density, cells):
    seg = _folded_plane(rng, cells, density)
    cap = packing.sparse_cap(cells)
    jt, js, je, jm = jrb.pack_sparse_segment(jnp.asarray(seg.reshape(-1, 128)), cap, cap, cap)
    jm = tuple(int(v) for v in jm)
    tok, side, esc, meta = packing.pack_sparse_segment(torch.from_numpy(seg), cap)
    assert meta[0] == jm[0] == int((seg != 0).sum())
    if jm[0] > cap:  # overflow: both report it; the caller reads the 2-bit plane
        assert density == 0.6
        return
    assert meta == jm
    n_nz, n_long, n_esc = meta
    assert np.array_equal(tok.numpy(), np.asarray(jt)[:n_nz])
    assert np.array_equal(side.numpy(), np.asarray(js)[:n_long])
    assert np.array_equal(esc.numpy(), np.asarray(je)[:n_esc])
    assert side.dtype == esc.dtype == torch.int32
    if density:
        assert n_long and n_esc  # the long gaps and the >= 3 values were exercised


def test_pack_sparse_segment_refuses_oversized_segments(monkeypatch):
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", 1 << 10)
    with pytest.raises(ValueError, match="at most"):
        packing.pack_sparse_segment(torch.zeros(1 << 11, dtype=torch.uint8), 64)


def test_sparse_cap_is_the_jax_fraction():
    """The JAX package's token cap before its grain rounding."""
    assert packing.sparse_cap(1 << 28) == (1 << 28) // 5
    assert packing.sparse_cap(1 << 10) == 204
    assert packing.sparse_cap(40) == 40
    jcap, _ = jrb._sparse_caps(1 << 28)
    assert jcap - packing.sparse_cap(1 << 28) < jrb._TOK_GRAIN


# ---- the mode choice -----------------------------------------------------------------

PICK_CASES = [
    # (size, mode, escapes)
    (1 << 30, "auto", ((1 << 30) // 10, 1000, 100, 10)),  # sparse
    (1 << 30, "auto", ((1 << 30) * 4 // 5, 1000, 100, 10)),  # 2bit
    (1 << 30, "auto", ((1 << 30) // 2, 1 << 28, 1 << 27, 1 << 20)),  # 3bit / packed
    (1 << 30, "auto", ((1 << 30) // 2, 1 << 29, 1 << 29, 1 << 29)),  # raw (raw2d)
    (1 << 29, "auto", ((1 << 29) // 3, 7_000_000, 900_000, 50_000)),
    (1 << 25, "auto", (0, 0, 0, 0)),  # below the auto floor
    (1 << 30, "3bit", None),
    (1 << 30, "sparse", None),
    (1 << 30, "raw", None),
    (100, "2bit", None),  # not a multiple of 256
]


@pytest.mark.parametrize("sparse_on", [True, False])
@pytest.mark.parametrize("size,mode,escapes", PICK_CASES)
def test_pick_mode_matches_jax(monkeypatch, size, mode, escapes, sparse_on):
    _sparse_knobs(monkeypatch, 1 << 28, min_cells=1024)
    if not sparse_on:
        monkeypatch.setenv("PYKMER_TPU_SPARSE", "0")
        monkeypatch.setattr(packing, "SPARSE", False)
    probe = jnp.zeros((64, 128), dtype=jnp.uint8)  # the JAX test's shape probe
    want = jrb._pick_mode(probe, size, mode, escapes=escapes)
    got = packing.pick_mode(torch.zeros(64 * 128, dtype=torch.uint8), size, mode, escapes)
    assert got == {"raw2d": "raw"}.get(want, want)


def test_pick_mode_counts_the_plane_itself(rng, monkeypatch):
    """Without ``escapes`` the plane is counted: the choice is the one made
    on the JAX package's counts of it."""
    monkeypatch.setattr(packing, "AUTO_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    chosen = set()
    for density in (0.05, 0.5, 0.95):
        folded = _folded_plane(rng, FOLD, density, long_zero_runs=False)
        jax_counts = tuple(int(v) for v in jrb.count_all_escapes(_jax_plane(folded)))
        got = packing.pick_mode(torch.from_numpy(folded), FOLD, "auto")
        assert got == packing.pick_mode(None, FOLD, "auto", jax_counts)
        chosen.add(got)
    assert len(chosen) > 1
    with pytest.raises(ValueError, match="unknown readback mode"):
        packing.pick_mode(None, FOLD, "4bit")


def test_sparse_needs_the_native_decoder_to_be_priced(monkeypatch):
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    assert packing.sparse_viable(1 << 20)
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1 << 21)
    assert not packing.sparse_viable(1 << 20)
    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setitem(sys.modules, "pykmer_tpu_torch.io.native", None)
    assert not packing.sparse_viable(1 << 20)


# ---- fetch_dense ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "raw", "2bit", "3bit", "packed", "sparse"])
def test_fetch_dense_matches_jax(rng, mode):
    folded = _escape_heavy(rng)
    want = jrb.fetch_dense(_jax_plane(folded), mode="2bit" if mode == "sparse" else mode)
    got = trb.fetch_dense(torch.from_numpy(folded), mode, slice_cells=FOLD // 3)
    assert np.array_equal(want, folded)
    assert np.array_equal(got, folded)


# ---- the chased tail in every mode ------------------------------------------------------

def _jax_tail(folded, mode, path, **kw):
    out = np.zeros(4**K, np.uint8)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        counts, hex_ = jrb.stream_dense_to_out(_jax_plane(folded), K, out, mode=mode, fd=fd,
                                               hash_out=True, slice_bytes=1 << 12, **kw)
    finally:
        os.close(fd)
    return counts, hex_, out


def _port_tail(folded, mode, path, slice_cells=FOLD // 5 + 3):
    out = np.full(4**K, 77, np.uint8)
    stages = StageTimer()
    with DirectWriter(path, size=out.shape[0]) as fd:
        counts, hex_ = trb.stream_plane_to_out(torch.from_numpy(folded.copy()), K, out, fd,
                                               slice_cells=slice_cells, stages=stages,
                                               mode=mode)
    return counts, hex_, out, stages


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("mode", ["raw", "packed", "2bit", "3bit"])
def test_stream_plane_to_out_matches_jax(rng, tmp_path, monkeypatch, mode, use_native):
    folded = _escape_heavy(rng)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jcounts, jhex, jout = _jax_tail(folded, mode, jpath)
    if not use_native:
        _block_native(monkeypatch)
    counts, hex_, out, stages = _port_tail(folded, mode, tpath)
    assert np.array_equal(out, jout)
    assert _read(tpath) == _read(jpath) == jout.tobytes()
    assert hex_ == jhex == hashlib.sha256(jout).hexdigest()
    assert np.array_equal(counts, jcounts)
    assert np.array_equal(counts, np.bincount(folded, minlength=256))
    names = [name for name, _ in stages.stages]
    assert names == ["copy + unfold" if mode == "raw" else f"copy + unfold ({mode})",
                     "write + hash drain"]


@pytest.mark.parametrize("seg", [1 << 15, 3 * (1 << 13)])  # the second: a ragged tail
@pytest.mark.parametrize("density", [0.0, 0.08, 0.6])
def test_sparse_tail_matches_jax(rng, tmp_path, monkeypatch, density, seg):
    _sparse_knobs(monkeypatch, seg)
    folded = _folded_plane(rng, FOLD, density)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jcounts, jhex, jout = _jax_tail(folded, "sparse", jpath)
    counts, hex_, out, stages = _port_tail(folded, "sparse", tpath)
    assert np.array_equal(out, jout)
    assert _read(tpath) == _read(jpath)
    assert hex_ == jhex and np.array_equal(counts, jcounts)
    n_segs = -(-FOLD // seg)
    fallback = [name for name, _ in stages.stages if "2-bit fallback" in name]
    # 0.6 overflows the ~20% token cap of every segment but the empty ones
    assert fallback == ([f"2-bit fallback, {n_segs} of {n_segs} segs"] if density == 0.6
                        else [])


def test_sparse_tail_serialised_matches(rng, tmp_path, monkeypatch):
    """SPARSE_OVERLAP off (each segment decoded before the next packs):
    the same bytes."""
    _sparse_knobs(monkeypatch, 1 << 13)
    monkeypatch.setattr(trb, "SPARSE_OVERLAP", False)
    folded = _folded_plane(rng, FOLD, 0.08)
    counts, hex_, out, _ = _port_tail(folded, "sparse", str(tmp_path / "t"))
    want = jrb.unfold_canonical(folded, K)
    assert np.array_equal(out, want) and hex_ == hashlib.sha256(want).hexdigest()
    assert np.array_equal(counts, np.bincount(folded, minlength=256))


def test_sparse_tail_without_native_raises_like_jax(rng, tmp_path, monkeypatch):
    folded = _folded_plane(rng, FOLD, 0.08)
    _block_native(monkeypatch)
    with pytest.raises(ImportError):
        jrb.stream_dense_to_out(_jax_plane(folded), K, np.zeros(4**K, np.uint8),
                                mode="sparse")
    with pytest.raises(ImportError):
        _port_tail(folded, "sparse", str(tmp_path / "t"))


def test_stream_plane_to_out_rejects_modes():
    plane = torch.zeros(4**5 // 2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown readback mode"):
        trb.stream_plane_to_out(plane, 5, np.empty(4**5, np.uint8), mode="auto")
    with pytest.raises(ValueError, match="sharded plane reads back raw"):
        trb.stream_plane_to_out([plane[:256], plane[256:]], 5, np.empty(4**5, np.uint8),
                                mode="2bit")


# ---- the arena-free pieces tail -----------------------------------------------------------

def _jax_pieces(folded, path):
    half = FOLD // 2
    planes = [_jax_plane(folded[:half]), _jax_plane(folded[half:])]
    escapes = [jrb.count_all_escapes(p) for p in planes]
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        os.ftruncate(fd, 4**K)
        return jrb.stream_sparse_planes_pieces(planes, K, fd, path, escapes, hash_out=True)
    finally:
        os.close(fd)


def _port_pieces(folded, path):
    plane = torch.from_numpy(folded.copy())
    stages = StageTimer()
    with DirectWriter(path, size=4**K) as fd:
        res = trb.stream_sparse_pieces(plane, K, fd, path, stages=stages)
    return res, stages


@pytest.mark.parametrize("case", ["sparse", "overflow", "ragged"])
def test_pieces_match_jax(rng, tmp_path, monkeypatch, case):
    _sparse_knobs(monkeypatch, 3 * (1 << 12) if case == "ragged" else 1 << 14)
    monkeypatch.setattr(trb, "MIRROR_READ_CELLS", 5000)  # several re-reads, one short
    folded = _folded_plane(rng, FOLD, 0.05, long_zero_runs=case != "overflow")
    if case == "overflow":
        # the second half: one segment far above the 20% token cap, while
        # the plane's density stays under 1/8 (the recipe of
        # tests/test_readback_sparse.py)
        hot = np.zeros(FOLD // 2, dtype=np.uint8)
        hot[: 1 << 13] = rng.choice([1, 2, 9], size=1 << 13).astype(np.uint8)
        folded[FOLD // 2 :] = hot
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jcounts, jhex = _jax_pieces(folded, jpath)
    (counts, hex_), stages = _port_pieces(folded, tpath)
    want = jrb.unfold_canonical(folded, K)
    assert _read(tpath) == _read(jpath) == want.tobytes()
    assert hex_ == jhex == hashlib.sha256(want).hexdigest()
    assert np.array_equal(counts, jcounts)
    fallback = [name for name, _ in stages.stages if "2-bit fallback" in name]
    assert fallback == (["2-bit fallback, 1 of 8 segs"] if case == "overflow" else [])


def test_pieces_decline_a_dense_plane(rng, tmp_path, monkeypatch):
    """The JAX package's pieces gate refuses a plane denser than 1/8; the
    port's chooser, which holds that gate, keeps it on the arena "sparse"
    tail, with the pieces threshold lowered below it."""
    from pykmer_tpu_torch.index import indexer as tix

    _sparse_knobs(monkeypatch, 1 << 14)
    monkeypatch.setattr(tix, "PIECES_MIN_CELLS", 0)
    folded = _folded_plane(rng, FOLD, 0.7, long_zero_runs=False)
    assert _jax_pieces(folded, str(tmp_path / "j")) is None
    stages = StageTimer()
    assert tix.choose_tail(torch.from_numpy(folded), K, "sparse", torch.device("cpu"),
                           "device", stages) == "sparse"
    assert [name for name, _ in stages.stages] == ["escape counts"]


def test_piece_sink_drains_its_writers_on_error(tmp_path):
    """A write that fails surfaces from finish, after every queued write and
    hash has run."""
    sink = trb.PieceSink(-1, str(tmp_path / "none"), 8)  # fd -1: every pwrite fails
    sink.piece_done(0, 4, np.zeros(4, np.uint8), np.zeros(4, np.uint8))
    with pytest.raises(OSError):
        sink.finish()
    with pytest.raises(ValueError, match="out of order"):
        trb.PieceSink(-1, "x", 8).piece_done(2, 4, np.zeros(2, np.uint8), np.zeros(2, np.uint8))
