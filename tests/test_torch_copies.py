"""The port imports nothing of the JAX package: its own copies of the JAX
package's JAX-free modules (``config``, ``utils``, ``formats``, ``io`` with
the C++ ``native`` library, ``analysis``, ``oracle``, ``testgen``) are held
here against their originals.

- an AST scan of every module of ``pykmer_tpu_torch`` and of
  ``chip_smoke.py``: no import of ``pykmer_tpu``, ``pykmer_tpu.*``,
  ``scripts.*`` or jax;
- each copy's code is its original's (docstrings aside), but for the native
  library's build, the profiling hooks and the merged ``config``; the C++
  source is byte-identical; single copied functions (multi-host input
  splitting and combine helpers, ``unfold_piece``) are compared function by
  function;
- on seeded inputs both give the same bytes: `.kin.json` headers, `.kin`
  and `.kma` files, bgzf files and `.gzi` indexes, FASTA decodes (plain, gz,
  bgz), every native function, ``sha256_file``, ``big_empty``, the oracle's
  `.kin`, testgen's file, distances and kwip comparisons;
- the port's native library builds under ``build/native/``, and
  ``StageTimer`` under a trace directory writes a torch profiler trace.
"""

import ast
import gzip
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

import pykmer_tpu
import pykmer_tpu.analysis.distance as jdist
import pykmer_tpu.analysis.kwip as jkwip
import pykmer_tpu.config as jconfig
import pykmer_tpu.formats.header as jheader
import pykmer_tpu.formats.kin as jkin
import pykmer_tpu.formats.kma as jkma
import pykmer_tpu.io.bgzf as jbgzf
import pykmer_tpu.io.fasta as jfasta
import pykmer_tpu.io.native as jnative
import pykmer_tpu.oracle as joracle
import pykmer_tpu.testgen as jtestgen
import pykmer_tpu.utils as jutils
import pykmer_tpu.utils.bigmem as jbigmem
import pykmer_tpu_torch
import pykmer_tpu_torch.analysis.distance as tdist
import pykmer_tpu_torch.analysis.kwip as tkwip
import pykmer_tpu_torch.config as tconfig
import pykmer_tpu_torch.formats.header as theader
import pykmer_tpu_torch.formats.kin as tkin
import pykmer_tpu_torch.formats.kma as tkma
import pykmer_tpu_torch.io.bgzf as tbgzf
import pykmer_tpu_torch.io.fasta as tfasta
import pykmer_tpu_torch.io.native as tnative
import pykmer_tpu_torch.oracle as toracle
import pykmer_tpu_torch.testgen as ttestgen
import pykmer_tpu_torch.utils as tutils
import pykmer_tpu_torch.utils.bigmem as tbigmem
from pykmer_tpu_torch.utils.profiling import StageTimer, annotate, device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.dirname(pykmer_tpu.__file__)
PORT_PKG = os.path.dirname(pykmer_tpu_torch.__file__)

# the copied modules, by their path under each package
COPIES = [
    "analysis/__init__.py", "analysis/cluster.py", "analysis/distance.py",
    "analysis/kwip.py", "analysis/metrics.py", "analysis/nj.py", "analysis/tree.py",
    "formats/__init__.py", "formats/header.py", "formats/kin.py", "formats/kma.py",
    "io/__init__.py", "io/bgzf.py", "io/direct.py", "io/fasta.py", "io/gzi.py",
    "io/native.py", "oracle/__init__.py", "oracle/gold.py", "testgen.py",
    "utils/__init__.py", "utils/bigmem.py", "utils/checksum.py",
    "utils/profiling.py", "utils/timer.py",
]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _port_sources():
    out = ["chip_smoke.py"]
    for root, _, files in os.walk(PORT_PKG):
        out += [os.path.relpath(os.path.join(root, f), REPO) for f in files
                if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("pykmer_tpu", "scripts", "jax", "jaxlib"))


@pytest.mark.parametrize("path", _port_sources())
def test_imports_nothing_of_the_jax_package(path):
    tree = ast.parse(_read(os.path.join(REPO, path)))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
            elif node.module in ("pykmer_tpu", "scripts"):
                bad += [a.name for a in node.names]
    assert not bad, f"{path} imports {bad}"


def _body(path, start=None):
    """The module's statements as an AST dump, its docstring left out; from
    the first statement whose source starts with ``start`` when given."""
    tree = ast.parse(_read(path))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    if start is not None:
        lines = _read(path).decode().splitlines()
        first = next(i for i, n in enumerate(body)
                     if lines[n.lineno - 1].startswith(start))
        body = body[first:]
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_faithful(rel):
    port, orig = os.path.join(PORT_PKG, rel), os.path.join(JAX_PKG, rel)
    doc = ast.get_docstring(ast.parse(_read(port))) or ""
    assert f"pykmer_tpu/{rel}" in doc  # each copy names its original
    if rel == "io/native.py":
        # the build differs (build/native/, hashed name); every binding after it is the same
        start = "_lib.fasta_decode.restype"
        assert _body(port, start) == _body(orig, start)
    elif rel == "utils/profiling.py":
        # jax.profiler mapped to torch.profiler in device_trace and annotate;
        # StageTimer is the original's
        def stage_timer(path):
            return next(ast.dump(n) for n in ast.parse(_read(path)).body
                        if isinstance(n, ast.ClassDef) and n.name == "StageTimer")

        assert stage_timer(port) == stage_timer(orig)
    else:
        assert _body(port) == _body(orig)


# copies of single functions in modules that are otherwise the port's own:
# (path under each package, function names)
FUNCTION_COPIES = [
    ("parallel/multihost.py", ["host_slice", "_record_boundary", "host_byte_slice",
                               "host_byte_slice_bgzf", "combine_partial_dense"]),
    ("ops/readback.py", ["unfold_piece"]),
    ("index/multihost.py", ["_stage_inflated", "_hash_and_counts"]),
]


def _function(path, name):
    """(docstring, AST dump of the signature and of the body without its
    docstring) of the module-level function ``name``."""
    fn = next(n for n in ast.parse(_read(path)).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    doc = ast.get_docstring(fn)
    body = fn.body[1:] if doc is not None else fn.body
    return doc or "", [ast.dump(fn.args), ast.dump(fn.returns) if fn.returns else None,
                       [ast.dump(d) for d in fn.decorator_list]] + [ast.dump(n) for n in body]


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in FUNCTION_COPIES
                                      for name in names])
def test_function_copy_is_faithful(rel, name):
    port_doc, port = _function(os.path.join(PORT_PKG, rel), name)
    _, orig = _function(os.path.join(JAX_PKG, rel), name)
    assert f"pykmer_tpu/{rel}::{name}" in " ".join(port_doc.split())  # names its original
    assert port == orig


def test_native_source_is_a_copy():
    assert _read(os.path.join(PORT_PKG, "native", "pykmer_native.cpp")) == \
        _read(os.path.join(JAX_PKG, "native", "pykmer_native.cpp"))


def test_config_copies_the_jax_config():
    for name in ("DEFAULT_FLUSH_EVERY", "DEFAULT_MIN_FRAG_SIZE", "DEFAULT_MAX_FRAG_SIZE",
                 "DEFAULT_MIN_COUNT", "DEFAULT_MAX_COUNT", "DEFAULT_BLOCK_SIZE",
                 "DEFAULT_THREADS", "MAX_VAL"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    for cls in ("IndexConfig", "MergeConfig"):
        t, j = getattr(tconfig, cls), getattr(jconfig, cls)
        assert [(f.name, f.default) for f in t.__dataclass_fields__.values()] == \
            [(f.name, f.default) for f in j.__dataclass_fields__.values()]
    assert tconfig.IndexConfig(kmer_len=7, chunk_windows=64) is not None
    for bad in ({"kmer_len": 4}, {"kmer_len": 5, "chunk_windows": 7}):
        with pytest.raises(ValueError) as te:
            tconfig.IndexConfig(**bad)
        with pytest.raises(ValueError) as je:
            jconfig.IndexConfig(**bad)
        assert str(te.value) == str(je.value)


# ---- the native library ------------------------------------------------------

def test_native_library_builds_under_build_native(tmp_path, monkeypatch):
    lib = tnative.library_path()
    assert lib == tnative._LIB_PATH and os.path.exists(lib)
    assert os.path.dirname(lib) == os.path.join(REPO, "build", "native")
    assert os.path.basename(lib).startswith("libpykmer_native_")
    # a fresh build from the port's source, into an empty directory
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "native"))
    fresh = tnative.library_path()
    assert not os.path.exists(fresh)
    tnative._build(fresh)
    assert os.path.exists(fresh)
    assert sorted(os.listdir(tmp_path / "native")) == ["build.lock", os.path.basename(fresh)]
    assert not any(f.startswith("libpykmer_native_")
                   for f in os.listdir(os.path.join(JAX_PKG, "native")))


def _native_cases():
    """(name, fn(native module, rng[, tmp dir]) -> comparable) for every
    native function."""
    k = 7
    half = 4**k // 2

    def plane(rng, n=half):
        p = rng.integers(0, 256, size=n).astype(np.uint8)
        p[rng.random(n) < 0.6] = 0
        return p

    def fasta_bytes(rng):
        seq = "".join(rng.choice(list("ACGTNacgtn"), size=5000))
        return (f">a x\n{seq[:3000]}\n>empty\n>b\n{seq[3000:]}\n").encode()

    def unfold(nat, rng):
        out = np.full(4**k, 9, np.uint8)
        nat.unfold_canonical_native(plane(rng), out, k)
        return out

    def unfold_range(nat, rng):
        out = np.full(4**k, 9, np.uint8)
        nat.unfold_canonical_range_native(plane(rng, 1000), out, k, 77)
        return out

    def unfold_piece(nat, rng):
        prim, mirr = np.full(999, 9, np.uint8), np.full(999, 9, np.uint8)
        nat.unfold_canonical_piece_native(plane(rng, 999), prim, mirr, k, 123)
        return prim, mirr

    def unpack(width):
        def fn(nat, rng):
            packed = rng.integers(0, 256, size=width * 300).astype(np.uint8)
            out = np.empty(packed.shape[0] * 8 // width, np.uint8)
            getattr(nat, f"unpack_{width}bit_native")(packed, out)
            return out
        return fn

    def unpack_unfold(width):
        def fn(nat, rng):
            packed = rng.integers(0, 256, size=width * 500).astype(np.uint8)
            out = np.full(4**k, 9, np.uint8)
            counts, esc = nat.unpack_unfold_native(packed, width, out, k, 8)
            return out, counts, esc
        return fn

    def sparse(piece):
        def fn(nat, rng):
            import jax.numpy as jnp

            from pykmer_tpu.ops.readback import pack_sparse_segment

            seg = plane(rng, 2048)
            tok, side, _, meta = pack_sparse_segment(
                jnp.asarray(seg.reshape(16, 128)), 2048, 2048, 2048)
            n_nz, n_long = int(meta[0]), int(meta[1])
            tok, side = np.asarray(tok)[:n_nz], np.asarray(side)[:n_long]
            if piece:
                prim, mirr = np.full(2048, 9, np.uint8), np.full(2048, 9, np.uint8)
                counts = nat.sparse_decode_segment_piece_native(
                    tok, side, prim, mirr, k, 4096, 2048)
                return counts, prim, mirr
            out = np.full(4**k, 9, np.uint8)
            return nat.sparse_decode_segment_native(tok, side, out, k, 4096, 2048), out
        return fn

    def joined(nat, rng):
        return nat.fasta_decode_joined_native(fasta_bytes(rng), k, tail_headroom=40)

    def joined_packed(nat, rng):
        bases, mask, n, chroms, bp = nat.fasta_decode_joined_packed_native(
            fasta_bytes(rng), k, tail_headroom=72)
        return bases, mask, n, chroms, bp

    def gzip_decompress(nat, rng, tmp):
        path = os.path.join(tmp, f"{nat.__name__}.gz")
        with gzip.open(path, "wb") as fh:
            fh.write(rng.integers(0, 256, size=300_000).astype(np.uint8).tobytes())
        return nat.gzip_decompress_native(path)

    return [
        ("fasta_decode_native", lambda nat, rng: nat.fasta_decode_native(fasta_bytes(rng))),
        ("bgzf_compress_native", lambda nat, rng: nat.bgzf_compress_native(
            plane(rng, 60000).tobytes(), 6)),
        ("bgzf_compress_buffer_native", lambda nat, rng: nat.bgzf_compress_buffer_native(
            plane(rng, 200_000), level=3)),
        ("gzip_decompress_native", gzip_decompress),
        ("pack_base_2bit_mask_native", lambda nat, rng: nat.pack_base_2bit_mask_native(
            rng.integers(0, 5, size=4096).astype(np.uint8))),
        ("pack_base_nibbles_native", lambda nat, rng: nat.pack_base_nibbles_native(
            rng.integers(0, 16, size=4097).astype(np.uint8))),
        ("unpack_2bit_native", unpack(2)),
        ("unpack_3bit_native", unpack(3)),
        ("unpack_4bit_native", unpack(4)),
        ("unfold_canonical_native", unfold),
        ("unfold_canonical_range_native", unfold_range),
        ("unfold_canonical_piece_native", unfold_piece),
        ("scan_escapes_native", lambda nat, rng: nat.scan_escapes_native(
            rng.integers(0, 256, size=3 * 400).astype(np.uint8), 3)),
        ("canon_bits_cached", lambda nat, rng: nat.canon_bits_cached(k)),
        ("unpack_unfold_native_2", unpack_unfold(2)),
        ("unpack_unfold_native_4", unpack_unfold(4)),
        ("sparse_decode_segment_native", sparse(False)),
        ("sparse_decode_segment_piece_native", sparse(True)),
        ("pack_valid_bits_native", lambda nat, rng: nat.pack_valid_bits_native(
            plane(rng, 10_001), 2, 200)),
        ("popcount_buf_native", lambda nat, rng: nat.popcount_buf_native(plane(rng, 9999))),
        ("popcount_and_native", lambda nat, rng: nat.popcount_and_native(
            plane(rng, 5000), plane(rng, 5000))),
        ("count256_native", lambda nat, rng: nat.count256_native(plane(rng))),
        ("_count_byte", lambda nat, rng: nat._count_byte(
            np.frombuffer(fasta_bytes(rng), np.uint8), ord(">"))),
        ("fasta_decode_joined_native", joined),
        ("fasta_decode_joined_packed_native", joined_packed),
    ]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name,fn", _native_cases(), ids=[c[0] for c in _native_cases()])
def test_native_function_matches_original(name, fn, tmp_path):
    args = (str(tmp_path),) if name == "gzip_decompress_native" else ()
    want = fn(jnative, np.random.default_rng(len(name)), *args)
    got = fn(tnative, np.random.default_rng(len(name)), *args)
    assert _equal(got, want)


def test_every_native_function_is_covered():
    names = {n for n, v in vars(tnative).items() if callable(v) and n.endswith("_native")}
    cases = {c[0] for c in _native_cases()}
    assert names <= cases | {"unpack_unfold_native"}
    assert {"unpack_unfold_native_2", "canon_bits_cached", "_count_byte"} <= cases


# ---- formats, io, utils ------------------------------------------------------

@pytest.mark.parametrize("kmer_len", [3, 5, 7])
def test_kin_header_and_files_match(tmp_path, kmer_len):
    rng = np.random.default_rng(kmer_len)
    arr = rng.integers(0, 256, size=4**kmer_len).astype(np.uint8)
    arr[rng.random(arr.shape[0]) < 0.5] = 0
    fa = str(tmp_path / "x.fa")
    with open(fa, "w") as fh:
        fh.write(">x\nACGT\n")
    metas, kins = [], []
    for fmt, hdr, tag in ((jkin, jheader, "j"), (tkin, theader, "t")):
        path = str(tmp_path / f"{tag}.kin")
        fmt.write_kin_array(path, arr)
        h = hdr.KinHeader("proj", input_file=fa, kmer_len=kmer_len)
        h.num_kmers = 1234
        h.chromosomes = [("x", 4)]
        h.write_metadata(path, stats_counts256=hdr.fast_counts256(arr),
                         input_checksum="0" * 64, output_checksum="1" * 64)
        meta = json.loads(_read(h.metadata_file))
        for key in VOLATILE_KIN_JSON_KEYS | {"output_file_name", "output_file_path"}:
            meta.pop(key, None)
        metas.append(meta)
        blocks = list(fmt.iter_kin_blocks(path, 4**kmer_len, 1000))
        kins.append((_read(path), np.concatenate(blocks)))
        assert hdr.stats_from_counts256(hdr.fast_counts256(arr)) == \
            jheader.stats_from_counts256(jheader.fast_counts256(arr))
    assert metas[0] == metas[1]
    assert kins[0][0] == kins[1][0] and np.array_equal(kins[0][1], kins[1][1])
    assert theader.frag_size_autotune(4**kmer_len) == jheader.frag_size_autotune(4**kmer_len)


def test_kma_files_match(tmp_path):
    rng = np.random.default_rng(8)
    m = rng.integers(0, 1 << 40, size=(4, 4, 3)).astype(np.uint64)
    data = [{"pos": i, "index_file": f"s{i}.kin", "header": {"k": i}} for i in range(4)]
    out = []
    for fmt, tag in ((jkma, "j"), (tkma, "t")):
        path = fmt.kma_path(str(tmp_path / tag), 1, 255)
        fmt.write_kma(path, m)
        fmt.write_kma_json(path + ".json", tag, 1, 255, data)
        assert np.array_equal(fmt.read_kma(path), m)
        out.append((_read(path), json.loads(_read(path + ".json"))))
    assert out[0][0] == out[1][0]
    out[0][1].pop("project_name"), out[1][1].pop("project_name")
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("level,block", [(6, 65280), (1, 10_000)])
def test_bgzf_and_gzi_match(tmp_path, level, block):
    data = np.random.default_rng(level).integers(0, 5, size=400_000).astype(np.uint8)
    out = []
    for mod, tag in ((jbgzf, "j"), (tbgzf, "t")):
        src = str(tmp_path / f"{tag}.bin")
        data.tofile(src)
        dst, gzi = mod.compress_file(src, level=level, block_size=block)
        rd = mod.BgzfRangeReader(dst)
        part = np.empty(77_777, np.uint8)
        rd.read_into(part, 123_456)
        rd.close()
        out.append((_read(dst), _read(gzi), mod.read_gzi(gzi), mod.decompress_file(dst),
                    part))
    assert _equal(out[0], out[1])
    assert out[1][3] == data.tobytes()


@pytest.mark.parametrize("kind", ["plain", "gz", "bgz"])
def test_fasta_decode_matches(tmp_path, kind):
    fa = make_random_fasta(str(tmp_path / "f.fa"), np.random.default_rng(9),
                           n_records=4, lengths=(700, 0, 90))
    if kind == "gz":
        with open(fa, "rb") as src, gzip.open(fa + ".gz", "wb") as dst:
            dst.write(src.read())
        fa += ".gz"
    elif kind == "bgz":
        fa = tbgzf.compress_file(fa, fa + ".bgz", write_index=False)[0]
    got, want = tfasta.open_input_bytes(fa), jfasta.open_input_bytes(fa)
    assert bytes(got) == bytes(want)
    for a, b in zip(tfasta.read_fasta_codes(fa), jfasta.read_fasta_codes(fa), strict=True):
        assert a.name == b.name and np.array_equal(a.codes, b.codes)
    for a, b in zip(tfasta.decode_fasta_bytes(bytes(got)),
                    jfasta.decode_fasta_bytes(bytes(want)), strict=True):
        assert a.name == b.name and np.array_equal(a.codes, b.codes)


def test_sha256_big_empty_and_timer(tmp_path):
    path = str(tmp_path / "h.bin")
    np.random.default_rng(10).integers(0, 256, size=300_001).astype(np.uint8).tofile(path)
    assert tutils.sha256_file(path) == jutils.sha256_file(path)
    for shape, dtype in ((1000, np.uint8), ((3, 77), np.int64), (1 << 22, np.uint8)):
        t, j = tbigmem.big_empty(shape, dtype), jbigmem.big_empty(shape, dtype)
        assert t.shape == j.shape and t.dtype == j.dtype and t.flags.writeable
        assert not tbigmem.big_zeros(shape, dtype).any()
    for n in (1000, 1 << 24):
        t = tbigmem.extend_view(tbigmem.big_empty(n)[:100], 200)
        j = jbigmem.extend_view(jbigmem.big_empty(n)[:100], 200)
        assert (t is None) == (j is None) and (t is None or t.shape == (200,))
    timer = tutils.Timer()
    timer.update(10)
    assert timer.val == 10 and "units" in timer.progress_line()


def test_oracle_and_testgen_match(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fa = make_random_fasta("o.fa", np.random.default_rng(11), n_records=3)
    out = []
    for oracle in (joracle, toracle):
        h = oracle.oracle_write_index("p", fa, 7)
        meta = json.loads(_read(h.index_file_root + ".json"))
        for key in VOLATILE_KIN_JSON_KEYS:
            meta.pop(key, None)
        out.append((_read(h.index_file_root), meta))
    assert out[0] == out[1]
    fixtures = []
    for gen, tag in ((jtestgen, "j"), (ttestgen, "t")):
        path = gen.create_test_fasta(f"{tag}-ex", 5)
        with gzip.open(path, "rb") as fh:  # gzip headers carry the write time
            fixtures.append(fh.read().replace(f">{tag}-ex".encode(), b">"))
    assert fixtures[0] == fixtures[1]


def test_distance_and_kwip_match(tmp_path):
    rng = np.random.default_rng(12)
    n = 4
    m = np.zeros((n, n, 3), np.uint64)
    for i in range(n):
        for j in range(n):
            a, b = rng.integers(100, 1000, size=2)
            m[i, j] = (a, b, rng.integers(0, min(a, b)))
    m[:, :, 0] = m[:, :, 0].T  # a symmetric pair table
    ids = [f"s{i}" for i in range(n)]
    kma = tkma.kma_path(str(tmp_path / "p"), 1, 255)
    tkma.write_kma(kma, m)
    tkma.write_kma_json(kma + ".json", "p", 1, 255, [
        {"pos": i, "index_file": f"{s}.fa.05.kin", "header": {"input_file_name": f"{s}.fa"}}
        for i, s in enumerate(ids)])
    assert _equal(tdist.jaccard_from_kma(kma), jdist.jaccard_from_kma(kma))
    assert np.array_equal(tdist.get_matrix(kma), jdist.get_matrix(kma))
    dist = str(tmp_path / "all.dist")
    d = rng.uniform(0.1, 1.0, size=(n, n))
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    with open(dist, "w") as fh:
        fh.write("\t" + "\t".join(s + ".fa.khmer" for s in ids) + "\n")
        for i, s in enumerate(ids):
            fh.write(s + ".fa.khmer\t" + "\t".join(f"{v:.6f}" for v in d[i]) + "\n")
    assert _equal(tkwip.read_kwip_dist(dist), jkwip.read_kwip_dist(dist))
    got, want = tkwip.compare_with_kma(dist, kma), jkwip.compare_with_kma(dist, kma)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


# ---- profiling ---------------------------------------------------------------

def test_stage_timer_writes_a_torch_trace(tmp_path, monkeypatch):
    trace_dir = str(tmp_path / "trace")
    stages = StageTimer()
    with device_trace(trace_dir):
        with stages.stage("decode stage"), annotate("decode span"):
            torch.ones(1000).cumsum(0)
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads(_read(os.path.join(trace_dir, files[0])))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"decode span", "aten::cumsum"} <= names
    # the directory may come from PYKMER_TPU_TRACE_DIR, as in the original
    monkeypatch.setenv("PYKMER_TPU_TRACE_DIR", str(tmp_path / "env"))
    with device_trace():
        torch.ones(3).sum()
    assert len(os.listdir(tmp_path / "env")) == 1
    assert [name for name, _ in stages.stages] == ["decode stage"]
    assert "decode stage" in stages.report()
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR")
    with device_trace(None):  # no directory, no PYKMER_TPU_TRACE_DIR: no trace
        pass
    assert sorted(os.listdir(tmp_path)) == ["env", "trace"]
