"""The port's merge on the CPU vs ``pykmer_tpu.merge`` (JAX).

Both packages merge the same `.kin` inputs, made from seeded FASTA by the
JAX package's indexer; the `.kma` files must be byte-identical and the
`.kma.json` equal key by key (exact equality throughout: the matrix is
integer counts). The per-block step and the copied host helpers are held
against numpy and the originals.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from conftest import make_random_fasta

from pykmer_tpu.formats.kma import read_kma
from pykmer_tpu.index import create_fasta_index
from pykmer_tpu.io.bgzf import compress_file
from pykmer_tpu.merge import merge as jax_merge
from pykmer_tpu.merge import merger as jmg
from pykmer_tpu_torch.merge import merge as port_merge
from pykmer_tpu_torch.merge import merger as tmg
from pykmer_tpu_torch.ops import compare


def _index_set(root, kmer_len, n, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        fasta = make_random_fasta(str(root / f"s{i}.fa"), rng, n_records=3,
                                  lengths=(300 + 40 * i, 150, 80))
        header = create_fasta_index(fasta, f"s{i}", fasta, kmer_len, verbose=False)
        paths.append(header.index_file_root)
    return paths


@pytest.fixture(scope="module")
def kins(tmp_path_factory):
    """K -> four sample indexes, made once for the module."""
    out = {}
    for k, seed in ((5, 50), (7, 70)):
        root = tmp_path_factory.mktemp(f"kin{k}")
        out[k] = _index_set(root, k, 4, seed)
    return out


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _merge_files(tmp_path, fn, paths, name, **kw):
    """Run ``fn("proj", paths, **kw)`` in ``tmp_path/name``; returns the
    matrix and the bytes of the `.kma` and `.kma.json`."""
    where = tmp_path / name
    where.mkdir()
    cwd = os.getcwd()
    os.chdir(where)
    try:
        _, matrix = fn("proj", paths, verbose=False, **kw)
    finally:
        os.chdir(cwd)
    mn, mx = kw.get("min_count", 1), kw.get("max_count", 255)
    kma = str(where / f"proj.{mn:03d}-{mx:03d}.kma")
    return matrix, _read(kma), _read(kma + ".json")


def _assert_same(jax_out, port_out):
    (mj, kma_j, js_j), (mt, kma_t, js_t) = jax_out, port_out
    assert mt.dtype == mj.dtype == np.uint64
    assert np.array_equal(mt, mj)
    assert kma_t == kma_j, ".kma differs from the JAX package's"
    dj, dt = json.loads(js_j), json.loads(js_t)
    assert set(dt) == set(dj)
    for key in dj:
        assert dt[key] == dj[key], key


def _both(tmp_path, paths, jax_engine, port_engine, **kw):
    j = _merge_files(tmp_path, jax_merge, paths, "jax", engine=jax_engine, **kw)
    t = _merge_files(tmp_path, port_merge, paths, "port", engine=port_engine,
                     device="cpu", **kw)
    _assert_same(j, t)
    return t[0]


@pytest.mark.parametrize("kmer_len", [5, 7])
@pytest.mark.parametrize("jax_engine", ["device", "host"])
@pytest.mark.parametrize("port_engine", ["device", "host"])
def test_merge_matches_jax(tmp_path, kins, kmer_len, jax_engine, port_engine):
    matrix = _both(tmp_path, kins[kmer_len], jax_engine, port_engine)
    assert matrix.shape == (4, 4, 3) and matrix[:, :, 2].min() > 0


@pytest.mark.parametrize("bounds", [(1, 255), (2, 200), (1, 1)])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_merge_count_bounds_match_jax(tmp_path, kins, bounds, engine):
    mn, mx = bounds
    _both(tmp_path, kins[7], "device", engine, min_count=mn, max_count=mx)


@pytest.mark.parametrize("block_size", [77, 101, 1024])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_merge_block_sizes_match_jax(tmp_path, kins, block_size, engine):
    """K=5 (1024 cells): blocks of 80 and 104 cells end ragged, 1024 not."""
    _both(tmp_path, kins[5], "device", engine, block_size=block_size)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_merge_bgz_input_matches_jax(tmp_path, kins, engine):
    paths = list(kins[5])
    bgz = str(tmp_path / "s1.fa.05.kin.bgz")
    compress_file(paths[1], bgz)
    shutil.copyfile(paths[1] + ".json", str(tmp_path / "s1.fa.05.kin.json"))
    paths[1] = bgz
    _both(tmp_path, paths, "host", engine, block_size=101)


def test_merge_hbm_clamp_matches_jax(tmp_path, kins, monkeypatch, capsys):
    """N=24 copies (24 rows, no zero padding): a 1536-byte budget clamps
    the device block to 64 cells in both packages, and the matrices agree
    with each other and with the port's host engine."""
    base = kins[5]
    paths = []
    for i in range(24):
        dup = str(tmp_path / f"dup{i:02d}.fa.05.kin")
        shutil.copyfile(base[i % 4], dup)
        shutil.copyfile(base[i % 4] + ".json", dup + ".json")
        paths.append(dup)
    monkeypatch.setenv("PYKMER_TPU_MERGE_HBM_BYTES", str(1536))
    clamp_lines = []
    results = []
    for fn, kw, name in ((jax_merge, {}, "jax"), (port_merge, {"device": "cpu"}, "port")):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        _, matrix = fn("proj", paths, engine="device", **kw)
        out = capsys.readouterr().out
        clamp_lines.append([ln for ln in out.splitlines() if "clamping" in ln])
        results.append((matrix, _read("proj.001-255.kma"), _read("proj.001-255.kma.json")))
    assert [len(c) for c in clamp_lines] == [1, 1]
    assert all("100,000,000 -> 64 (N=24" in c[0] for c in clamp_lines)
    _assert_same(*results)
    _, host = port_merge(str(tmp_path / "h"), paths, engine="host", verbose=False,
                         device="cpu")
    assert np.array_equal(host, results[1][0])
    assert np.array_equal(results[1][0][0, 4], results[1][0][0, 0])  # copies of s0


@pytest.mark.parametrize("env", [None, "1", "20"])
@pytest.mark.parametrize("n", [2, 8, 9])
def test_engine_auto_matches_jax(tmp_path, kins, monkeypatch, n, env):
    if env is None:
        monkeypatch.delenv("PYKMER_TPU_MERGE_HOST_MAX_N", raising=False)
    else:
        monkeypatch.setenv("PYKMER_TPU_MERGE_HOST_MAX_N", env)
    base = kins[5]
    paths = []
    for i in range(n):
        dup = str(tmp_path / f"a{i}.fa.05.kin")
        shutil.copyfile(base[i % 4], dup)
        shutil.copyfile(base[i % 4] + ".json", dup + ".json")
        paths.append(dup)
    chosen = []
    for mod, fn, kw in ((jmg, jax_merge, {}), (tmg, port_merge, {"device": "cpu"})):
        picked = []

        def record(name):
            def run(paths, *a, **k):
                picked.append(name)
                return np.zeros((len(paths), len(paths)), dtype=np.int64)
            return run

        monkeypatch.setattr(mod, "_pairwise_matrix_host", record("host"))
        monkeypatch.setattr(mod, "_pairwise_matrix_device", record("device"))
        fn(str(tmp_path / f"p{len(chosen)}"), paths, verbose=False, **kw)
        chosen.append(picked)
    assert chosen[0] == chosen[1] and len(chosen[0]) == 1
    want = "host" if n <= int(env or 8) else "device"
    assert chosen[1] == [want]


def _guard_case(tmp_path, kins, case):
    """(args, kwargs) of merge for one bad input; the project lives in
    tmp_path."""
    paths = kins[5][:2]
    proj = str(tmp_path / "p")
    if case == "min_count_0":
        return (proj, paths), {"min_count": 0}
    if case == "max_count_256":
        return (proj, paths), {"max_count": 256}
    if case == "not_a_kin":
        fa = paths[0][: -len(".05.kin")]
        return (proj, [fa]), {}
    if case == "missing_file":
        return (proj, [paths[0], str(tmp_path / "gone.fa.05.kin")]), {}
    if case == "missing_json":
        dup = str(tmp_path / "nojson.fa.05.kin")
        shutil.copyfile(paths[0], dup)
        return (proj, [paths[0], dup]), {}
    if case == "k_differs":
        return (proj, [paths[0], kins[7][0]]), {}
    if case == "block_size_0":
        return (proj, paths), {"block_size": 0}
    if case == "no_indexes":
        return (proj, []), {}
    if case == "buffer_size_0":
        return (proj, paths), {"buffer_size": 0}
    if case == "engine":
        return (proj, paths), {"engine": "gpu"}
    if case == "project_is_a_file":
        return (paths[0], paths), {}
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "min_count_0", "max_count_256", "not_a_kin", "missing_file", "missing_json",
    "k_differs", "block_size_0", "no_indexes", "buffer_size_0", "engine",
    "project_is_a_file",
])
def test_merge_guards_match_jax(tmp_path, kins, case):
    args, kw = _guard_case(tmp_path, kins, case)
    errors = []
    for fn, extra in ((jax_merge, {}), (port_merge, {"device": "cpu"})):
        with pytest.raises(Exception) as exc:
            fn(*args, verbose=False, **kw, **extra)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]
    assert not os.path.exists(str(tmp_path / "p.001-255.kma"))


def test_merge_exists_and_shards(tmp_path, kins):
    """A second merge into the same project raises FileExistsError in both
    packages; n_shards=2 gives the JAX package's sharded `.kma`."""
    paths = kins[5][:2]
    for fn, kw in ((jax_merge, {}), (port_merge, {"device": "cpu"})):
        proj = str(tmp_path / ("pj" if fn is jax_merge else "pt"))
        fn(proj, paths, verbose=False, **kw)
        with pytest.raises(FileExistsError):
            fn(proj, paths, verbose=False, **kw)
    sharded = []
    for fn, kw in ((jax_merge, {}), (port_merge, {"device": "cpu"})):
        proj = str(tmp_path / ("sj" if fn is jax_merge else "st"))
        fn(proj, paths, n_shards=2, verbose=False, **kw)
        sharded.append(_read(proj + ".001-255.kma"))
    assert sharded[0] == sharded[1] == _read(str(tmp_path / "pt.001-255.kma"))


def test_merge_cuda_without_card_raises(tmp_path, kins):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_merge(str(tmp_path / "p"), kins[5][:2], engine="host", verbose=False)


def _without_native(monkeypatch):
    """Block both packages' native libraries; returns the names of the
    validity counters the port's merge takes from then on (``pop`` is the
    numpy version, ``popcount_buf_native`` the native one)."""
    monkeypatch.setitem(sys.modules, "pykmer_tpu.io.native", None)
    monkeypatch.setitem(sys.modules, "pykmer_tpu_torch.io.native", None)
    taken = []
    real = tmg._validity_ops

    def spy(*args):
        ops = real(*args)
        taken.append(ops[1].__name__)
        return ops

    monkeypatch.setattr(tmg, "_validity_ops", spy)
    return taken


@pytest.mark.parametrize("engine", ["device", "host"])
def test_merge_without_native_library_matches_jax(tmp_path, kins, monkeypatch, engine):
    """Without the native library both packages pack and count with numpy."""
    taken = _without_native(monkeypatch)
    _both(tmp_path, kins[5], "host", engine, block_size=77)
    assert taken and set(taken) == {"pop"}


# ---- the per-block step ------------------------------------------------------

def _bits(rng, n, nbytes):
    return rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)


@pytest.mark.parametrize("n,rows,nbytes,wider", [
    (1, 24, 5, 0), (3, 24, 16, 8), (17, 24, 9, 0), (39, 40, 33, 64),
])
def test_unpack_validity_matches_numpy(n, rows, nbytes, wider):
    rng = np.random.default_rng(n)
    bits = _bits(rng, n, nbytes)
    out = None
    if wider:
        out = torch.zeros((rows, nbytes * 8 + wider), dtype=torch.int8)
    v = compare.unpack_validity(torch.from_numpy(bits), rows, out)
    assert v.dtype == torch.int8 and v.shape[0] == rows
    want = np.zeros(tuple(v.shape), dtype=np.int8)
    want[:n, : nbytes * 8] = np.unpackbits(bits, axis=1, bitorder="little")
    assert np.array_equal(v.numpy(), want)


def test_unpack_bit_order_matches_native_packer():
    """The unpack inverts the port's packer (the native one, or numpy's
    little-endian fallback): cell c of a block is column c of V."""
    rng = np.random.default_rng(3)
    blk = rng.integers(0, 6, size=203).astype(np.uint8)
    pack = tmg._validity_ops(2, 4)[0]
    out = np.zeros(26, dtype=np.uint8)
    packed = pack(blk, out)
    v = compare.unpack_validity(torch.from_numpy(out[None, :].copy()), 24)
    want = ((blk >= 2) & (blk <= 4)).astype(np.int8)
    assert packed.shape[0] == 26
    assert np.array_equal(v[0, :203].numpy(), want)
    assert not v[0, 203:].any()


@pytest.mark.parametrize("n,nbytes", [(2, 100), (17, 37), (39, 64)])
def test_block_contingency_matches_numpy(n, nbytes):
    rng = np.random.default_rng(100 + n)
    bits = _bits(rng, n, nbytes)
    bits[:, -1] &= 0x1F  # a ragged block: the last byte's top 3 bits are pad
    acc = torch.zeros((n, n), dtype=torch.int64)
    ws = compare.new_workspace(n, nbytes * 8, torch.device("cpu"))
    for _ in range(2):  # the workspace is reused across blocks
        compare.block_contingency(acc, torch.from_numpy(bits), ws)
    v = np.unpackbits(bits, axis=1, bitorder="little").astype(np.int64)
    assert np.array_equal(acc.numpy(), 2 * (v @ v.T))
    assert compare.STEPS == 0  # CPU steps are not counted


def test_block_contingency_accumulator_does_not_wrap():
    n, nbytes = 3, 8
    acc = torch.full((n, n), 2**31 - 1, dtype=torch.int64)
    bits = torch.full((n, nbytes), 0xFF, dtype=torch.uint8)
    compare.block_contingency(acc, bits)
    assert (acc == 2**31 - 1 + 64).all()


@pytest.mark.parametrize("s", [1, 2, 8, 32])
def test_stacked_product_equals_plain(s):
    """The CUDA path's segment stacking, with an int32 product on the CPU."""
    rng = np.random.default_rng(s)
    v = torch.from_numpy(rng.integers(0, 2, size=(24, 512)).astype(np.int8))
    w = v.to(torch.int32)
    got = compare.stacked_product(v, s, lambda a, b: a.to(torch.int32) @ b.to(torch.int32))
    assert got.dtype == torch.int64
    assert torch.equal(got, (w @ w.t()).to(torch.int64))


def test_workspace_shapes():
    assert [compare.padded_rows(n) for n in (1, 2, 17, 24, 25, 39, 128)] == \
        [24, 24, 24, 24, 32, 40, 128]
    assert [compare.segments(r) for r in (24, 40, 128, 2048)] == [32, 32, 8, 1]
    ws = compare.new_workspace(39, 1000, torch.device("cpu"))
    assert tuple(ws.shape) == (40, 1024) and not ws.any()


def test_block_contingency_rejects_bad_arguments():
    bits = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int64"):
        compare.block_contingency(torch.zeros((3, 3), dtype=torch.int32), bits)
    with pytest.raises(ValueError, match="int64"):
        compare.block_contingency(torch.zeros((2, 2), dtype=torch.int64), bits)
    with pytest.raises(ValueError, match="uint8"):
        compare.unpack_validity(bits.to(torch.int8), 24)
    with pytest.raises(ValueError, match="out must be"):
        compare.unpack_validity(bits, 24, torch.zeros((24, 30), dtype=torch.int8))


# ---- the copied host helpers -------------------------------------------------

def test_validate_inputs_matches_original(kins):
    paths = kins[7]
    dj, kj = jmg._validate_inputs(paths)
    dt, kt = tmg._validate_inputs(paths)
    assert kj == kt == 7
    for a, b in zip(dj, dt):
        assert a["header"].to_dict() == b["header"].to_dict()
        assert {k: a[k] for k in a if k != "header"} == \
            {k: b[k] for k in b if k != "header"}


def test_input_streams_match_original(tmp_path, kins):
    """Raw, BGZF and plain-gzip inputs read the same blocks as the
    original's readers."""
    import gzip

    raw = kins[7][0]
    bgz, _ = compress_file(raw, str(tmp_path / "b.kin.bgz"))
    gz = str(tmp_path / "g.kin.bgz")  # gzip without BGZF blocks
    with open(raw, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    paths = [raw, bgz, gz]
    size, block = 4**7, 3000
    with jmg._InputStreams(paths, block, None) as js, \
            tmg._InputStreams(paths, block, 4096) as ts:
        assert [k for k, _ in ts.streams] == ["raw", "bgz", "gz"]
        for off in range(0, size, block):
            want = min(block, size - off)
            for i in range(3):
                a = js.read_block(i, want, off).copy()
                assert np.array_equal(ts.read_block(i, want, off), a)


@pytest.mark.parametrize("bounds", [(1, 255), (2, 100)])
def test_pair_counts_match_original(tmp_path, kins, bounds):
    a, b = kins[5][:2]
    mn, mx = bounds
    want = jmg.pair_counts_stream(a, b, 4**5, mn, mx, block_size=97)
    assert tmg.pair_counts_stream(a, b, 4**5, mn, mx, block_size=97) == want
    assert tmg.pair_counts_scalar(a, b, mn, mx) == jmg.pair_counts_scalar(a, b, mn, mx)
    assert want == jmg.pair_counts_scalar(a, b, mn, mx)
    bgz, _ = compress_file(a, str(tmp_path / "a.kin.bgz"))
    assert tmg.pair_counts_scalar(bgz, b, mn, mx) == want


@pytest.mark.parametrize("native", [True, False])
def test_host_engine_matches_original(kins, monkeypatch, native):
    if not native:
        taken = _without_native(monkeypatch)
    paths = kins[7]
    want = jmg._pairwise_matrix_host(paths, 4**7, 2, 250, 1001, 3, False)
    got = tmg._pairwise_matrix_host(paths, 4**7, 2, 250, 1001, 3, False)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    dev = tmg._pairwise_matrix_device(paths, 4**7, 2, 250, 1001, 3, False,
                                      device=torch.device("cpu"))
    assert dev.dtype == np.int64 and np.array_equal(dev, want)
    if not native:
        assert taken and set(taken) == {"pop"}


def test_merge_matches_pair_counts(tmp_path, kins):
    paths = kins[7]
    _, matrix = port_merge(str(tmp_path / "p"), paths, engine="device",
                           block_size=999, verbose=False, device="cpu")
    again = read_kma(str(tmp_path / "p.001-255.kma"))
    assert np.array_equal(again, matrix)
    for k in range(4):
        for l in range(k + 1, 4):
            kc, lc, sc = tmg.pair_counts_stream(paths[k], paths[l], 4**7)
            assert tuple(int(x) for x in matrix[k, l]) == (kc, lc, sc)
            assert tuple(int(x) for x in matrix[l, k]) == (lc, kc, sc)
