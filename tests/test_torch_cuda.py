"""Kernel tests that need an NVIDIA GPU and nvcc (marker ``cuda``).

They skip where no CUDA device is usable. This file imports no jax, so it
runs on a GPU machine without it; tests/conftest.py does import jax, hence:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import gzip
import os

import numpy as np
import pytest
import torch

import deflate_cases
from fasta_cases import CASES, case_bytes

from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch import create_fasta_index
from pykmer_tpu_torch.host.chunks import pack_base_stream
from pykmer_tpu_torch.ops import encode, fasta as fasta_ops, sweep
from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted

pytestmark = pytest.mark.cuda

IMAX = np.iinfo(np.int32).max


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(plane_np, codes_np, dtype, device):
    codes = torch.from_numpy(np.sort(codes_np)).to(dtype).to(device)
    a = torch.from_numpy(plane_np).to(device)
    b = a.clone()
    before = sweep.LAUNCHES
    assert sweep.accumulate_sorted(a, codes) is a
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + (codes.shape[0] > 0)
    saturating_accumulate_sorted(b, codes)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("cells", [1 << 16, (1 << 20) + 3])
def test_kernel_matches_plain(cuda, dtype, cells):
    rng = np.random.default_rng(cells)
    plane = rng.integers(0, 256, size=cells).astype(np.uint8)
    codes = rng.integers(-3, cells + 5, size=200_000)
    codes[:50_000] = rng.integers(0, 4, size=50_000)  # runs far above 255
    codes[50_000:50_010] = IMAX
    out = _kernel_vs_plain(plane, codes, dtype, cuda)
    assert (out[:4] == 255).all()


@pytest.mark.parametrize("codes", [
    [], [5], [0, 0, 0], [63, 63], [-1, 0, 64, IMAX], [64] * 10,
    list(range(64)) + [7] * 300,
])
def test_kernel_edge_batches(cuda, codes):
    plane = np.random.default_rng(1).integers(0, 256, size=64).astype(np.uint8)
    plane[:8] = 254
    _kernel_vs_plain(plane, np.asarray(codes, dtype=np.int64), torch.int64, cuda)


BLOCK = 1024  # sorted positions a block of the sweep kernel covers (csrc/sweep.cu)


def _block_edge_case(case, rng):
    """(cells, unsorted codes) that put a run where the kernel's blocks have
    an edge: each block covers BLOCK consecutive sorted positions, and a run
    belongs to the thread of its head, whatever block its tail lies in."""
    cells = 1 << 20
    m = 256 * BLOCK
    codes = rng.integers(0, cells, size=m)
    codes.sort()
    if case == "run_longer_than_block":
        codes[5000 : 5000 + 3 * BLOCK] = codes[5000]
    elif case == "run_across_block_boundary":
        codes[5 * BLOCK - 100 : 5 * BLOCK + 100] = codes[5 * BLOCK - 100]
    elif case == "run_from_block_last_position":
        codes[7 * BLOCK - 1 : 7 * BLOCK + 50] = codes[7 * BLOCK - 1]
    elif case == "run_from_last_position_to_batch_end":
        codes[-BLOCK - 1 :] = codes[-BLOCK - 1]
    elif case == "batch_smaller_than_block":
        codes = codes[:1000]
    elif case == "m_not_block_multiple":
        codes = codes[: 3 * BLOCK + 77]
    elif case == "one_run_whole_batch":
        codes = np.full(5 * BLOCK + 3, 12345)
    elif case == "m_is_1":
        codes = np.array([777])
    elif case == "bands":
        codes[:300] = -1
        codes[300 : 2 * BLOCK] = cells  # the folded sentinel, over a block edge
        codes[-BLOCK - 9 :] = IMAX
    else:
        raise ValueError(case)
    return cells, codes


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", [
    "run_longer_than_block", "run_across_block_boundary", "run_from_block_last_position",
    "run_from_last_position_to_batch_end", "batch_smaller_than_block",
    "m_not_block_multiple", "one_run_whole_batch", "m_is_1", "bands",
])
def test_kernel_block_edges(cuda, dtype, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    cells, codes = _block_edge_case(case, rng)
    plane = rng.integers(0, 256, size=cells).astype(np.uint8)
    _kernel_vs_plain(plane, codes, dtype, cuda)


@pytest.mark.parametrize("dtype,offset", [
    (torch.int32, 1), (torch.int32, 2), (torch.int32, 3), (torch.int64, 1)])
@pytest.mark.parametrize("m", [2, 5 * BLOCK + 11])
def test_kernel_unaligned_codes_view(cuda, dtype, offset, m):
    """A codes view at an offset that is not 16-byte aligned (as a row of the
    sharded path's received buffer may be)."""
    rng = np.random.default_rng(offset * 7 + m)
    cells = 1 << 18
    codes = np.sort(rng.integers(-2, cells + 2, size=m))
    codes[m // 3 : m // 3 + min(m // 3, 600)] = codes[m // 3]
    full = torch.cat([torch.full((offset,), -1, dtype=dtype),
                      torch.from_numpy(codes).to(dtype)]).to(cuda)
    view = full[offset:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    a = torch.from_numpy(rng.integers(0, 256, size=cells).astype(np.uint8)).to(cuda)
    b = a.clone()
    sweep.accumulate_sorted(a, view)
    saturating_accumulate_sorted(b, view)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernel_int64_codes_above_2_31(cuda):
    cells = (1 << 31) + (1 << 20)
    rng = np.random.default_rng(31)
    codes = rng.integers((1 << 31) - (1 << 16), cells + 100, size=80 * BLOCK)
    codes[:2000] = (1 << 31) + 5  # a run above 2^31
    codes[2000:2100] = (1 << 40)  # beyond the plane
    codes = torch.from_numpy(np.sort(codes)).to(cuda)
    a = torch.zeros(cells, dtype=torch.uint8, device=cuda)
    a[(1 << 31) - (1 << 16) :] = torch.randint(
        0, 256, ((1 << 20) + (1 << 16),), dtype=torch.uint8, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(0))
    b = a.clone()
    sweep.accumulate_sorted(a, codes)
    saturating_accumulate_sorted(b, codes)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert int(a[(1 << 31) + 5]) == 255


K19_WINDOW = 1 << 22  # the window plane of scripts/certify_k19_torch.py, part D


@pytest.mark.parametrize("base", [0, 3 << 31, (1 << 36) + (5 << 22), (1 << 37) - K19_WINDOW])
def test_kernel_int64_window_of_the_k19_range(cuda, base):
    # part D on the card: folded K=19 codes over the 2^37 range, shifted by a
    # window base (above 2^32 for the last two), into a 2^22-cell window
    rng = np.random.default_rng(base % 1000)
    codes = rng.integers(0, 1 << 37, size=1 << 20)
    codes[: 1 << 16] = rng.integers(base, base + K19_WINDOW, size=1 << 16)
    codes[(1 << 16) : (1 << 16) + 3000] = base + 17  # a saturating run in the window
    out = _kernel_vs_plain(np.zeros(K19_WINDOW, dtype=np.uint8), codes - base, torch.int64,
                           cuda)
    assert int(out[17]) == 255
    inside = np.unique(codes[(codes >= base) & (codes < base + K19_WINDOW)])
    assert int(out.count_nonzero()) == inside.shape[0]


def test_certify_k19_part_d_on_card(cuda):
    import sys

    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import certify_k19_torch as cert

    seq = cert.build_fixture(np.random.default_rng(cert.FIXTURE_SEED), piece=5000, n_pieces=2)
    before = sweep.LAUNCHES_I64
    cert.certify(cuda, seq, parts="D")
    assert sweep.LAUNCHES_I64 == before + 4  # one int64 launch a window


# ---- the encode kernels (csrc/encode.cu) -------------------------------------

ENCODE_K = [1, 15, 17, 19, 21, 31]
ENCODE_BLOCK = 2048  # windows a block of the encode kernels covers


def _packed_planes(rng, span, masked):
    """(bases2, maskbits or None) of ``span`` random bases as
    ``pack_base_stream`` packs them, cut to the chunk's bytes (not padded);
    a masked chunk holds scattered invalid bases and a run of 40."""
    codes = rng.integers(0, 4, size=span).astype(np.uint8)
    if masked:
        codes[rng.random(span) < 0.02] = 4
        codes[span // 3 : span // 3 + 40] = 4
    b, m = pack_base_stream(codes)
    return b[: (span + 3) // 4], (m[: (span + 7) // 8] if masked else None)


def _packed_vs_plain(db, dm, span, kmer_len):
    """The packed kernel against its plain version, and its fused count
    (started at 7) against the plain count of valid windows."""
    before = (encode.LAUNCHES, encode.LAUNCHES_I64)
    count = torch.full((), 7, dtype=torch.int64, device=db.device)
    got = encode.canonical_codes_packed(db, dm, span, kmer_len, count=count)
    torch.cuda.synchronize()
    assert (encode.LAUNCHES, encode.LAUNCHES_I64) == (before[0] + 1,
                                                      before[1] + (kmer_len > 15))
    want = encode.canonical_codes_packed_plain(db, dm, span, kmer_len)
    assert got.dtype == encode.code_dtype(kmer_len) == want.dtype
    assert torch.equal(got, want)
    assert int(count) == 7 + int((want < 4**kmer_len // 2).sum())
    assert torch.equal(encode.canonical_codes_packed(db, dm, span, kmer_len), want)
    return got


@pytest.mark.parametrize("kmer_len", ENCODE_K)
@pytest.mark.parametrize("masked", [True, False])
# windows beyond K: one window, two, three, 18 (a multiple of neither 4 nor
# 16), a block and one, a block and 7, many blocks and a ragged end
@pytest.mark.parametrize("extra", [0, 1, 2, 17, ENCODE_BLOCK, ENCODE_BLOCK + 6,
                                   37 * ENCODE_BLOCK + 5])
def test_encode_kernel_packed_matches_plain(cuda, kmer_len, masked, extra):
    span = kmer_len + extra
    b, m = _packed_planes(np.random.default_rng(kmer_len * 1000 + extra), span, masked)
    got = _packed_vs_plain(torch.from_numpy(b).to(cuda),
                           None if m is None else torch.from_numpy(m).to(cuda),
                           span, kmer_len)
    if masked:
        assert bool((got == 4**kmer_len // 2).any())


@pytest.mark.parametrize("kmer_len", [15, 31])
def test_encode_kernel_packed_unaligned_views(cuda, kmer_len):
    """Planes that start at odd byte offsets of larger buffers and carry
    trailing bytes past the span (the kernel reads bytes, guarded at each
    plane's end)."""
    span = (1 << 16) + 3
    b, m = _packed_planes(np.random.default_rng(kmer_len), span, True)
    big_b = torch.zeros(b.shape[0] + 20, dtype=torch.uint8, device=cuda)
    big_m = torch.zeros(m.shape[0] + 20, dtype=torch.uint8, device=cuda)
    big_b[3 : 3 + b.shape[0]] = torch.from_numpy(b).to(cuda)
    big_m[5 : 5 + m.shape[0]] = torch.from_numpy(m).to(cuda)
    _packed_vs_plain(big_b[3 : 3 + b.shape[0] + 7], big_m[5 : 5 + m.shape[0] + 9],
                     span, kmer_len)


@pytest.mark.parametrize("kmer_len", [15, 31])
@pytest.mark.parametrize("offset", range(16))
def test_encode_kernel_packed_views_at_every_offset(cuda, kmer_len, offset):
    """Planes at every byte offset 0..15 of larger buffers (the kernel
    stages 16-byte vectors from an aligned plane, bytes otherwise), the
    mask at another offset, and a span that ends inside a block."""
    span = 3 * ENCODE_BLOCK + kmer_len + 21
    b, m = _packed_planes(np.random.default_rng(offset), span, True)
    big_b = torch.zeros(b.shape[0] + 48, dtype=torch.uint8, device=cuda)
    big_m = torch.zeros(m.shape[0] + 48, dtype=torch.uint8, device=cuda)
    moff = (offset * 7) % 16
    big_b[offset : offset + b.shape[0]] = torch.from_numpy(b).to(cuda)
    big_m[moff : moff + m.shape[0]] = torch.from_numpy(m).to(cuda)
    view_b, view_m = big_b[offset : offset + b.shape[0]], big_m[moff : moff + m.shape[0]]
    assert view_b.data_ptr() % 16 == offset
    _packed_vs_plain(view_b, view_m, span, kmer_len)
    _packed_vs_plain(view_b, None, span, kmer_len)


@pytest.mark.parametrize("kmer_len", [1, 15, 17, 31])
def test_encode_kernel_packed_all_invalid(cuda, kmer_len):
    """A chunk with no valid base: every code the folded sentinel, a count
    of 0."""
    span = ENCODE_BLOCK + kmer_len + 10
    rng = np.random.default_rng(kmer_len)
    db = torch.from_numpy(rng.integers(0, 256, size=(span + 3) // 4).astype(np.uint8)).to(cuda)
    dm = torch.zeros((span + 7) // 8, dtype=torch.uint8, device=cuda)
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    got = encode.canonical_codes_packed(db, dm, span, kmer_len, count=count)
    torch.cuda.synchronize()
    assert int(count) == 0 and bool((got == 4**kmer_len // 2).all())
    assert torch.equal(got, encode.canonical_codes_packed_plain(db, dm, span, kmer_len))


def test_encode_kernel_packed_rejects_a_counter_elsewhere(cuda):
    db = torch.zeros(64, dtype=torch.uint8, device=cuda)
    for count in (torch.zeros((), dtype=torch.int64),
                  torch.zeros((), dtype=torch.int32, device=cuda),
                  torch.zeros(1, dtype=torch.int64, device=cuda)):
        with pytest.raises(ValueError, match="count must be"):
            encode.canonical_codes_packed(db, None, 200, 15, count=count)


def _bases_vs_plain(dc, kmer_len):
    before = encode.BASES_LAUNCHES
    got = encode.canonical_codes(dc, kmer_len)
    torch.cuda.synchronize()
    assert encode.BASES_LAUNCHES == before + 1
    want = encode.canonical_codes_plain(dc, kmer_len)
    assert got.dtype == encode.code_dtype(kmer_len) and torch.equal(got, want)


def _base_chunk(rng, n):
    chunk = rng.integers(0, 4, size=n).astype(np.uint8)
    chunk[rng.random(n) < 0.02] = 4
    chunk[rng.integers(0, n, size=3)] = 5
    chunk[rng.integers(0, n, size=3)] = 255
    return chunk


@pytest.mark.parametrize("kmer_len", ENCODE_K)
@pytest.mark.parametrize("extra", [0, 1, 2, 17, ENCODE_BLOCK, ENCODE_BLOCK + 6,
                                   41 * ENCODE_BLOCK + 3])
def test_encode_kernel_bases_matches_plain(cuda, kmer_len, extra):
    """The bases entry (unfolded codes, sentinel 4^K) with invalid bases of
    the codes 4, 5 and 255."""
    rng = np.random.default_rng(kmer_len + extra)
    _bases_vs_plain(torch.from_numpy(_base_chunk(rng, kmer_len + extra)).to(cuda), kmer_len)


@pytest.mark.parametrize("kmer_len", [15, 31])
@pytest.mark.parametrize("offset", range(16))
def test_encode_kernel_bases_views_at_every_offset(cuda, kmer_len, offset):
    """A chunk at every byte offset 0..15 of a larger buffer (16-byte
    vector loads where aligned, byte loads otherwise and at the end)."""
    n = 2 * ENCODE_BLOCK + kmer_len + 37
    chunk = torch.from_numpy(_base_chunk(np.random.default_rng(offset), n)).to(cuda)
    big = torch.full((n + 40,), 9, dtype=torch.uint8, device=cuda)
    big[offset : offset + n] = chunk
    view = big[offset : offset + n]
    assert view.data_ptr() % 16 == offset
    _bases_vs_plain(view, kmer_len)


@pytest.mark.parametrize("n_data,n_shards", [(1, 8), (2, 2)])
def test_encode_kernel_halo_on_card_matches_cpu(cuda, n_data, n_shards):
    """make_halo_encode at K=19 on logical shards of the card against the
    same mesh on the CPU; one bases-kernel launch per position."""
    from pykmer_tpu_torch.parallel import make_halo_encode, make_mesh

    k, shard_len = 19, 4096 + 7
    rng = np.random.default_rng(19)
    seq = rng.integers(0, 4, size=n_shards * shard_len).astype(np.uint8)
    seq[rng.random(seq.shape[0]) < 0.01] = 4
    before = encode.BASES_LAUNCHES
    got = make_halo_encode(make_mesh(n_shards, n_data, devices=[cuda] * (n_data * n_shards)),
                           k, shard_len)(seq)
    torch.cuda.synchronize()
    assert encode.BASES_LAUNCHES == before + n_data * n_shards
    want = make_halo_encode(make_mesh(n_shards, n_data, device="cpu"), k, shard_len)(seq)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_index_cuda_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(3)
    seq = rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04], size=20_000)
    fasta = str(tmp_path / "g.fa")
    with open(fasta, "w") as fh:
        fh.write(">a\n" + "".join(seq[:12_000]) + "\n>empty\n>b\n"
                 + "".join(seq[12_000:]) + "\n>rep\n" + "ACGTACGA" * 500 + "\n")
    cfg = IndexConfig(kmer_len=9, chunk_windows=2048)
    out = []
    for dev in ("cpu", "cuda"):
        sweep.LAUNCHES = 0
        h = create_fasta_index(fasta, "s", fasta, 9, config=cfg, verbose=False,
                               device=dev)
        with open(h.index_file_root, "rb") as fh:
            out.append((fh.read(), h.num_kmers, h.hist, sweep.LAUNCHES))
    assert out[0][:3] == out[1][:3]
    assert out[0][3] == 0 and out[1][3] > 1  # one launch per chunk on CUDA


def _genome(path, rng, n_records=12, length=30_000):
    seq = rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04],
                     size=n_records * length)
    with open(path, "w") as fh:
        for r in range(n_records):
            fh.write(f">r{r}\n" + "".join(seq[r * length : (r + 1) * length]) + "\n")
    return path


def _kin(header):
    with open(header.index_file_root, "rb") as fh:
        kin = fh.read()
    os.remove(header.index_file_root)
    os.remove(header.metadata_file)
    return kin, header.num_kmers, header.hist


def test_streaming_index_matches_gzip_on_card(cuda, tmp_path):
    """K=11 on the card: the streaming index of a plain file (many segments)
    equals the pipelined index of its gzip copy; both launch the sweep."""
    fasta = _genome(str(tmp_path / "s.fa"), np.random.default_rng(4))
    gz = str(tmp_path / "s2.fa.gz")
    with open(fasta, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16)
    out = []
    for path in (fasta, gz):
        sweep.LAUNCHES = 0
        out.append(_kin(create_fasta_index(path, "s", path, 11, config=cfg,
                                           verbose=False, device=cuda)))
        assert sweep.LAUNCHES > 1
    assert out[0] == out[1]


def test_host_strategy_matches_device_on_card(cuda, tmp_path):
    """K=11 on the card: step A on the card with the host's update equals
    the device strategy; only the device strategy launches the sweep."""
    fasta = _genome(str(tmp_path / "h.fa"), np.random.default_rng(5))
    out = []
    for accumulate in ("device", "host"):
        cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16, accumulate=accumulate)
        sweep.LAUNCHES = 0
        out.append(_kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg,
                                           verbose=False, device=cuda)))
        assert (sweep.LAUNCHES > 1) == (accumulate == "device")
    assert out[0] == out[1]


@pytest.mark.parametrize("readback", ["raw", "packed", "2bit", "3bit", "sparse", "pieces"])
def test_readback_modes_on_card(cuda, tmp_path, monkeypatch, readback):
    """K=11 on the card in every readback mode gives the CPU's raw `.kin`:
    the packs and the escape gathers on the card, the sparse stream over
    2^14-cell segments, and ("pieces", with the pieces threshold lowered)
    the arena-free tail."""
    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.ops import packing

    monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
    monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", 1 << 14)
    if readback == "pieces":
        monkeypatch.setattr(indexer, "PIECES_MIN_CELLS", 0)
        readback = "sparse"
    fasta = _genome(str(tmp_path / "m.fa"), np.random.default_rng(6))
    want = _kin(create_fasta_index(fasta, "s", fasta, 11, verbose=False, device="cpu",
                                   config=IndexConfig(kmer_len=11, chunk_windows=1 << 16)))
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16, readback=readback)
    assert _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                   device=cuda)) == want


def test_readback_ops_on_card_match_cpu(cuda):
    """The packs, the escape counts, the sparse compaction and fetch_dense
    in every mode: the card's results equal the CPU's."""
    from pykmer_tpu_torch.ops import packing, readback

    rng = np.random.default_rng(7)
    plane_np = (rng.integers(0, 64, 1 << 22, dtype=np.uint8)
                * (rng.random(1 << 22) < 0.1)).astype(np.uint8)
    cpu, card = torch.from_numpy(plane_np), torch.from_numpy(plane_np).to(cuda)
    for width, pack in packing.PACKS.items():
        assert torch.equal(pack(card).cpu(), pack(cpu)), width
    assert packing.count_all_escapes(card) == packing.count_all_escapes(cpu)
    cap = packing.sparse_cap(1 << 20)
    for a, b in zip(packing.pack_sparse_segment(card[: 1 << 20], cap)[:3],
                    packing.pack_sparse_segment(cpu[: 1 << 20], cap)[:3]):
        assert torch.equal(a.cpu(), b)
    idx = np.array([0, 5, (1 << 22) - 1], dtype=np.int64)
    assert np.array_equal(packing.gather_cells(card, idx), plane_np[idx])
    for mode in ("auto", "raw", "packed", "2bit", "3bit", "sparse"):
        assert np.array_equal(readback.fetch_dense(card, mode, slice_cells=3 << 18),
                              plane_np), mode


@pytest.mark.parametrize("n", [2, 17, 39])
def test_block_contingency_cuda_matches_cpu(cuda, n):
    """The stacked ``_int_mm`` step on the card equals the plain int32
    product on the CPU, over two blocks of which the second is ragged."""
    from pykmer_tpu_torch.ops import compare

    rng = np.random.default_rng(200 + n)
    nbytes = 100_003
    blocks = [rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8) for _ in range(2)]
    blocks[1][:, -1] &= 0x07  # the last byte's top 5 bits are pad
    blocks[1][:, -500:] = 0  # pad bytes of a ragged block
    accs = {}
    for dev in ("cpu", cuda):
        ws = compare.new_workspace(n, nbytes * 8, torch.device(dev))
        acc = torch.full((n, n), 2**31 - 5, dtype=torch.int64, device=dev)
        before = compare.STEPS
        for bits in blocks:
            compare.block_contingency(acc, torch.from_numpy(bits).to(dev), ws)
        assert compare.STEPS == before + (2 if dev is cuda else 0)
        accs[str(dev)] = acc.cpu()
    torch.cuda.synchronize()
    assert torch.equal(accs["cpu"], accs[str(cuda)])
    v = [np.unpackbits(b, axis=1, bitorder="little").astype(np.int64) for b in blocks]
    assert np.array_equal(accs["cpu"].numpy(), 2**31 - 5 + sum(x @ x.T for x in v))


def test_merge_cuda_matches_host(cuda, tmp_path):
    """A K=9 merge of three samples indexed on the card: the device engine on
    the card equals the host engine and the streamed pair counts."""
    from pykmer_tpu_torch.merge import merge, pair_counts_stream
    from pykmer_tpu_torch.ops import compare

    kins = []
    for i in range(3):
        fasta = _genome(str(tmp_path / f"m{i}.fa"), np.random.default_rng(10 + i),
                        n_records=3, length=20_000)
        kins.append(create_fasta_index(fasta, "s", fasta, 9, verbose=False,
                                       device=cuda).index_file_root)
    compare.STEPS = 0
    _, dev = merge(str(tmp_path / "d"), kins, engine="device", block_size=50_000,
                   verbose=False, device=cuda)
    assert compare.STEPS == -(-4**9 // 50_000)
    _, host = merge(str(tmp_path / "h"), kins, engine="host", verbose=False,
                    device=cuda)
    assert np.array_equal(dev, host)
    for k in range(3):
        for l in range(k + 1, 3):
            assert tuple(int(x) for x in dev[k, l]) == \
                pair_counts_stream(kins[k], kins[l], 4**9)


def test_serve_warmup_on_card(cuda):
    """warmup builds and loads the kernels and launches the sweep twice
    (a masked and a mask-free dummy chunk) without K's plane."""
    from pykmer_tpu_torch.serve import warmup

    sweep.LAUNCHES = sweep.LAUNCHES_I64 = 0
    torch.cuda.reset_peak_memory_stats()
    assert warmup(17, cuda) > 0
    assert sweep.LAUNCHES == sweep.LAUNCHES_I64 == 2
    assert torch.cuda.max_memory_allocated() < 4**17 // 2


def _sharded_run(mesh, seq, k, cw):
    from pykmer_tpu_torch.host.chunks import chunk_stream
    from pykmer_tpu_torch.parallel import histogram

    init, step = histogram.make_sharded_accumulate(mesh, k, cw)
    pad, n_chunks = chunk_stream(seq.copy(), k, cw)
    state = init()
    n_steps = -(-n_chunks // step.rows)
    for s in range(n_steps):
        state = step(state, histogram.shard_batch_chunks_packed(pad, k, cw, step.rows, s))
    planes, nk, maxb = state
    return [[p.cpu() for p in row] for row in planes], int(nk), int(maxb), n_steps


@pytest.mark.parametrize("n_data,n_shards", [(1, 4), (2, 2)])
def test_sharded_accumulate_cuda_matches_cpu(cuda, n_data, n_shards):
    """The sharded step on logical shards of one card equals the CPU mesh's:
    planes (every replica), num_valid and max_bucket; the sweep launches
    once per received row, (R·S)^2 times per step."""
    from pykmer_tpu_torch.parallel import make_mesh

    seq = np.random.default_rng(7).integers(0, 5, size=60_000).astype(np.uint8)
    seq[:3000] = 1  # a saturating run
    cpu = _sharded_run(make_mesh(n_shards, n_data, device="cpu"), seq, 9, 2048)
    sweep.LAUNCHES = 0
    card = _sharded_run(make_mesh(n_shards, n_data, devices=[cuda] * (n_shards * n_data)),
                        seq, 9, 2048)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == card[3] * (n_shards * n_data) ** 2
    assert card[1:] == cpu[1:]
    for r in range(n_data):
        for s in range(n_shards):
            assert torch.equal(card[0][r][s], cpu[0][r][s])


def test_sharded_merge_step_cuda_matches_cpu(cuda):
    from pykmer_tpu_torch.ops import compare
    from pykmer_tpu_torch.parallel import compare as pcompare
    from pykmer_tpu_torch.parallel import make_mesh

    n = 7
    rng = np.random.default_rng(8)
    blocks = [rng.integers(0, 256, size=(n, 4 * 25_000), dtype=np.uint8) for _ in range(2)]
    accs = []
    for mesh in (make_mesh(4, device="cpu"), make_mesh(devices=[cuda] * 4)):
        step = pcompare.make_sharded_merge_step(mesh, n)
        acc = torch.zeros((n, n), dtype=torch.int64, device=mesh.first)
        compare.STEPS = 0
        for bits in blocks:
            step(acc, pcompare.shard_bits(bits, mesh))
        assert compare.STEPS == (8 if mesh.first.type == "cuda" else 0)
        accs.append(acc.cpu())
    assert torch.equal(accs[0], accs[1])


def test_sharded_index_cuda_matches_cpu(cuda, tmp_path):
    from pykmer_tpu_torch.index import create_fasta_index_sharded
    from pykmer_tpu_torch.parallel import make_mesh

    fasta = _genome(str(tmp_path / "sh.fa"), np.random.default_rng(9), n_records=4)
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 14)
    want = _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                   device="cpu"))
    sweep.LAUNCHES = 0
    got = _kin(create_fasta_index_sharded(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                          mesh=make_mesh(4, devices=[cuda] * 4)))
    assert got == want and sweep.LAUNCHES > 0


@pytest.fixture()
def cards4():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("n_data,n_shards", [(1, 4), (2, 2)])
def test_sharded_accumulate_across_cards_matches_cpu(cards4, n_data, n_shards):
    """The sharded step over 4 real cards (peer copies in the exchange)
    equals the CPU mesh's, every replica included."""
    from pykmer_tpu_torch.parallel import make_mesh

    seq = np.random.default_rng(17).integers(0, 5, size=60_000).astype(np.uint8)
    cpu = _sharded_run(make_mesh(n_shards, n_data, device="cpu"), seq, 9, 2048)
    cards = _sharded_run(make_mesh(n_shards, n_data, devices=cards4), seq, 9, 2048)
    assert cards[1:] == cpu[1:]
    for r in range(n_data):
        for s in range(n_shards):
            assert torch.equal(cards[0][r][s], cpu[0][r][s])


def test_sharded_index_and_merge_across_cards(cards4, tmp_path):
    """A sharded index and a sharded merge over 4 real cards give the CPU's
    `.kin` and the single-device `.kma` matrix."""
    from pykmer_tpu_torch.index import create_fasta_index_sharded
    from pykmer_tpu_torch.merge import merge
    from pykmer_tpu_torch.parallel import make_mesh

    kins = []
    for i in range(3):
        fasta = _genome(str(tmp_path / f"x{i}.fa"), np.random.default_rng(20 + i),
                        n_records=3)
        cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 14)
        want = _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                       device="cpu"))
        h = create_fasta_index_sharded(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                       mesh=make_mesh(2, 2, devices=cards4))
        kins.append(h.index_file_root)
        with open(kins[-1], "rb") as fh:
            assert fh.read() == want[0]
    _, single = merge(str(tmp_path / "one"), kins, engine="device", block_size=100_000,
                      verbose=False, device=cards4[0])
    _, sharded = merge(str(tmp_path / "four"), kins, block_size=100_000, verbose=False,
                       device=cards4[0], mesh=make_mesh(devices=cards4))
    assert np.array_equal(single, sharded)


def test_multihost_two_processes_on_one_card(cuda, tmp_path):
    """A two-process K=11 job with both ranks on ``cuda:0`` (gloo between
    them, each its own CUDA context): the `.kin` and stats of the single-card
    index, and the sweep launched in both workers."""
    import json

    from test_torch_multihost import run_workers

    fasta = _genome(str(tmp_path / "mh.fa"), np.random.default_rng(12), n_records=6)
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 14)
    want = _kin(create_fasta_index(fasta, "mh", fasta, 11, config=cfg, verbose=False,
                                   device=cuda))
    results = run_workers(2, "index", [fasta, 11, 1 << 14, 0, 0, -1, "cuda:0"], timeout=300)
    for rc, out in results:
        assert rc == 0, out
    launches = [int(out.split("launches=")[1].split()[0]) for _, out in results]
    assert all(n > 0 for n in launches), launches
    with open(fasta + ".11.kin", "rb") as fh:
        assert fh.read() == want[0]
    with open(fasta + ".11.kin.json") as fh:
        meta = json.load(fh)
    assert (meta["num_kmers"], meta["hist"]) == want[1:]


@pytest.mark.parametrize("extra", [[], ["--shards", "1"]])
def test_cli_index_on_a_named_card_in_a_new_process(cuda, tmp_path, extra):
    """``--device cuda:0`` in a new process, single-device and sharded: the
    run's first CUDA call is a per-card one (the peak memory reset), which
    fails unless CUDA was initialised before it."""
    import subprocess
    import sys

    fasta = _genome(str(tmp_path / "named.fa"), np.random.default_rng(5), n_records=2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-m", "pykmer_tpu_torch", "index", fasta, "s", "9",
         "--device", "cuda:0", "--quiet", *extra],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(fasta + ".09.kin")


# ---- the FASTA decode kernel (csrc/fasta.cu) --------------------------------

FASTA_HEADROOM = (1 << 16) + 15 + 8


def _decode_vs_plain(raw_cpu, raw_dev, kmer_len):
    """The kernel's decode of ``raw_dev`` equals the plain decode of
    ``raw_cpu`` and, for the planes and n_codes, the native decoder's."""
    from pykmer_tpu_torch.io import native

    want = fasta_ops.decode_packed(raw_cpu, kmer_len, FASTA_HEADROOM)
    before = fasta_ops.LAUNCHES
    got = fasta_ops.decode_packed(raw_dev, kmer_len, FASTA_HEADROOM)
    torch.cuda.synchronize()
    assert fasta_ops.LAUNCHES == before + 1
    assert got.bases.device == raw_dev.device and got.n_codes == want.n_codes
    for field in ("bases", "mask", "name_off", "name_len", "seq_len", "has_valid"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    bases, mask, n_codes, _, _ = native.fasta_decode_joined_packed_native(
        raw_cpu.numpy(), kmer_len, threads=2, tail_headroom=FASTA_HEADROOM)
    assert n_codes == got.n_codes
    assert torch.equal(got.bases.cpu(), torch.from_numpy(bases))
    assert torch.equal(got.mask.cpu(), torch.from_numpy(mask))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fasta_kernel_matches_plain(cuda, case):
    data = case_bytes(case)
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(0, dtype=torch.uint8)
    for kmer_len in (1, 5, 15, 31):
        _decode_vs_plain(raw, raw.to(cuda), kmer_len)


@pytest.mark.parametrize("offset", [1, 2, 3, 13])
def test_fasta_kernel_unaligned_view(cuda, offset):
    """A segment that starts off a 16-byte boundary takes the byte loads."""
    data = case_bytes("fuzz_2")
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dev = torch.zeros(raw.shape[0] + offset, dtype=torch.uint8, device=cuda)
    dev[offset:] = raw.to(cuda)
    _decode_vs_plain(raw, dev[offset:], 15)


def test_fasta_kernel_on_a_seeded_genome(cuda, tmp_path):
    """The benchmark's genome recipe (kbench/genome.py) at 40 Mbp in 3
    records, cut into record-aligned segments: every segment's decode on the
    card equals the plain one."""
    from kbench import genome
    from pykmer_tpu_torch.host.segments import segment_record_bounds

    path = str(tmp_path / "g.fa")
    genome.make_genome(path, (1 << 31) + 77, genome_bp=40_000_000, records=3,
                       repeat_cover=0.65, max_divergence=0.2, n_bases=2_000_000, n_runs=5)
    buf = np.fromfile(path, dtype=np.uint8)
    bounds = segment_record_bounds(buf, 16 << 20)
    assert len(bounds) == 3
    for lo, hi in bounds:
        raw = torch.from_numpy(buf[lo:hi])
        _decode_vs_plain(raw, raw.to(cuda), 15)


def test_streaming_index_decodes_on_card(cuda, tmp_path, monkeypatch):
    """K=11 on the card, the streaming input in several segments: every
    segment is decoded on the card (one "card decode" span and one decode a
    segment, no host "decode"), the page-locked buffer is kept for the next
    index, and the files equal the gzip copy's, which the host decodes."""
    import functools

    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.utils import profiling

    fasta = _genome(str(tmp_path / "c.fa"), np.random.default_rng(6), n_records=40,
                    length=20_000)
    gz = str(tmp_path / "c2.fa.gz")
    with open(fasta, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    monkeypatch.setattr(indexer, "iter_card_chunks", functools.partial(
        indexer.iter_card_chunks, target_segment=100_000))
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16)
    fasta_ops.LAUNCHES = 0
    header = create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                device=cuda)
    chromosomes = header.chromosomes
    card = _kin(header)
    spans = profiling.FINISHED_RUNS[-1].spans
    decodes = [s for s in spans if s.name == "card decode"]
    assert len(decodes) == fasta_ops.LAUNCHES > 3
    assert sum(s.counts["bytes"] for s in decodes) == os.path.getsize(fasta)
    assert sum(s.counts["records"] for s in decodes) == 40
    assert not [s for s in spans if s.name == "decode"]
    assert sum(s.counts["bytes"] for s in spans if s.name == "input sha256") \
        == os.path.getsize(fasta)
    kept = segments.PINNED._buf
    assert kept is not None and not segments.PINNED._leased
    again = _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                    device=cuda))
    assert segments.PINNED._buf is kept
    header = create_fasta_index(gz, "s", gz, 11, config=cfg, verbose=False, device=cuda)
    assert header.chromosomes == chromosomes and len(chromosomes) == 40
    assert card == again == _kin(header)


def test_bgzf_index_decodes_on_card(cuda, tmp_path, monkeypatch):
    """K=11 on the card, a 40-record BGZF ``.fa.gz`` in several segments: it
    streams out of the inflate pool into the card decode ("card decode" and
    "bgzf inflate" bytes = the inflated size, no host "decode", "input
    sha256" bytes = the compressed file's), gives the page-locked buffer
    back, and its `.kin` equals the plain file's."""
    import functools
    import hashlib
    import json

    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.io import bgzf
    from pykmer_tpu_torch.utils import profiling

    fasta = _genome(str(tmp_path / "b.fa"), np.random.default_rng(9), n_records=40,
                    length=20_000)
    gz = bgzf.compress_file(fasta, str(tmp_path / "b2.fa.gz"), write_index=False)[0]
    monkeypatch.setattr(indexer, "iter_card_chunks", functools.partial(
        indexer.iter_card_chunks, target_segment=100_000))
    monkeypatch.setattr(segments, "INFLATE_EXTENT", 150_000)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16)
    plain = _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                    device=cuda))
    fasta_ops.LAUNCHES = 0
    header = create_fasta_index(gz, "s", gz, 11, config=cfg, verbose=False, device=cuda)
    with open(header.metadata_file) as fh:
        meta = json.load(fh)
    with open(gz, "rb") as fh:
        assert meta["input_file_cheksum"] == hashlib.sha256(fh.read()).hexdigest()
    assert _kin(header) == plain and len(header.chromosomes) == 40
    spans = profiling.FINISHED_RUNS[-1].spans
    decodes = [s for s in spans if s.name == "card decode"]
    assert len(decodes) == fasta_ops.LAUNCHES > 3
    assert sum(s.counts["bytes"] for s in decodes) == os.path.getsize(fasta)
    assert not [s for s in spans if s.name == "decode"]
    inflates = [s for s in spans if s.name == "bgzf inflate"]
    assert len(inflates) > 3
    assert sum(s.counts["bytes"] for s in inflates) == os.path.getsize(fasta)
    assert sum(s.counts["bytes_in"] for s in inflates) == os.path.getsize(gz)
    assert sum(s.counts["bytes"] for s in spans if s.name == "input sha256") \
        == os.path.getsize(gz)
    assert segments.PINNED._buf is not None and not segments.PINNED._leased


def test_pinned_pool_refuses_a_second_lease(cuda, tmp_path):
    """The page-locked buffer serves one streaming input at a time: a second
    input before the first is released is refused, and once it is released
    the next input reuses the same buffer."""
    from pykmer_tpu_torch.host import segments

    path = _genome(str(tmp_path / "p.fa"), np.random.default_rng(8), n_records=4)
    first = segments.StreamingInput(path, card=cuda)
    with pytest.raises(RuntimeError, match="leased"):
        segments.StreamingInput(path, card=cuda)
    first.input_checksum()
    pooled = first._pinned
    first.release()
    again = segments.StreamingInput(path, card=cuda)
    assert again._pinned is pooled
    again.release()


def test_streaming_k17_index_takes_the_pieces_tail(cuda, tmp_path, monkeypatch):
    """A streaming K=17 index of a small genome of the benchmark's recipe,
    readback "auto": it takes the arena-free pieces tail (the counter and
    the stage table say so, and its spans count the whole plane), and its `.kin`
    and `.kin.json` equal the benchmark's blocked plain reference, counted
    on the card."""
    import json

    from kbench import genome
    from kbench.reference import index as ref
    from kbench.reference import index_blocked
    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.utils import profiling

    path = str(tmp_path / "g.fa")
    records = genome.make_genome(path, (1 << 31) + 171, genome_bp=20_000_000, records=3,
                                 repeat_cover=0.65, max_divergence=0.2, n_bases=1_000_000,
                                 n_runs=5)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    before = indexer.TAILS["pieces"]
    create_fasta_index(path, "s", path, 17, verbose=False, device=cuda)
    run = profiling.FINISHED_RUNS[-1]
    assert indexer.TAILS["pieces"] == before + 1
    assert any(name == "copy + decode (pieces)" for name, _ in run.stages)
    half = 4**17 // 2
    for name, key in (("sparse pack", "cells"), ("piece decode", "cells"),
                      ("mirror read", "bytes")):
        assert sum(s.counts[key] for s in run.spans if s.name == name) == half, name
    assert sum(s.counts["bytes"] for s in run.spans if s.name == "sha256") == 2 * half
    kin = path + ".17.kin"
    expected, wrong, _ = index_blocked.judge(records, 17, cuda, ref.sha256_file(path),
                                             kin_paths=[kin])
    with open(kin + ".json") as fh:
        meta = json.load(fh)
    os.remove(kin)
    assert wrong == [0] and ref.fields_wrong(meta, expected) == []
    assert expected["num_kmers"] == genome.valid_windows(
        genome_bp=20_000_000, records=3, n_bases=1_000_000, n_runs=5, kmer_len=17)


def test_k15_verify_reads_the_file_beside_the_hash_on_card(cuda, tmp_path, monkeypatch):
    """A streaming K=15 index on the card: the verify's re-read starts after
    the `.kin`'s last write has ended, counts 4^15 bytes, and the stage table
    keeps its rows; the `.kin` and its sha256 equal those of the same index
    without the verify, which reads nothing back."""
    import hashlib

    from pykmer_tpu_torch.utils import profiling

    fasta = _genome(str(tmp_path / "v.fa"), np.random.default_rng(9))
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    shas, runs = [], []
    for verify in (True, False):
        header = create_fasta_index(fasta, "s", fasta, 15, verbose=False, device=cuda,
                                    verify=verify)
        h = hashlib.sha256()
        with open(header.index_file_root, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 26), b""):
                h.update(block)
        shas.append((h.hexdigest(), header.output_file_cheksum))
        runs.append(profiling.FINISHED_RUNS[-1])
    assert shas[0] == shas[1] and shas[0][0] == shas[0][1]
    on, off = runs

    def named(name):
        return [s for s in on.spans if s.name == name]

    reads, counts = named("verify read"), named("verify count")
    assert min(s.start for s in reads) >= max(s.end for s in named("pwrite"))
    assert sum(s.counts["bytes"] for s in reads) == 4**15
    assert sum(s.counts["bytes"] for s in counts) == 4**15
    assert [name for name, _ in on.stages] == [
        "input read", "decode + accumulate (pipelined)", "output alloc", "copy + unfold",
        "write + hash drain", "metadata", "verify"]
    assert not {"verify read", "verify count"} & {s.name for s in off.spans}


# ---- the file-order unfold on the card (ops/unfold, csrc/unfold.cu) ----------------


def _unfold_plane(kmer_len, seed):
    """A folded plane with zeros, small counts and saturated cells."""
    rng = np.random.default_rng(seed)
    half = 4**kmer_len // 2
    vals = rng.choice(np.array([1, 1, 2, 3, 7, 100, 255], np.uint8), size=half)
    return vals * (rng.random(half) < 0.6).astype(np.uint8)


@pytest.mark.parametrize("kmer_len", [11, 13, 15])
def test_unfold_kernel_matches_plain(cuda, kmer_len):
    """The whole file in one launch: the plain version's bytes and counts."""
    from pykmer_tpu_torch.ops import unfold

    full = 4**kmer_len
    plane = torch.from_numpy(_unfold_plane(kmer_len, kmer_len)).to(cuda)
    counts = torch.zeros(256, dtype=torch.int64, device=cuda)
    want_counts = torch.zeros_like(counts)
    before = unfold.LAUNCHES
    got = unfold.unfold_file(plane, 0, kmer_len, 0, full, counts)
    torch.cuda.synchronize()
    assert unfold.LAUNCHES == before + 1
    want = unfold.unfold_file_plain(plane, 0, kmer_len, 0, full, want_counts)
    assert torch.equal(got, want)
    assert torch.equal(counts, want_counts)
    assert int(counts.sum()) == full // 2


@pytest.mark.parametrize("kmer_len", [1, 2, 3, 4, 7, 11])
def test_unfold_kernel_any_range_and_view(cuda, kmer_len):
    """Ragged, unaligned, straddling and aligned ranges, from views that
    start at the range's first folded cell or one before it (an unaligned
    pointer): the plain version's bytes and counts, one launch each."""
    from pykmer_tpu_torch.ops import unfold

    full = 4**kmer_len
    half = full // 2
    plane = torch.from_numpy(_unfold_plane(kmer_len, 1)).to(cuda)
    rng = np.random.default_rng(kmer_len)
    pairs = [(0, full), (0, half), (half, full)]
    pairs += [tuple(sorted(int(x) for x in rng.integers(0, full + 1, 2))) for _ in range(40)]
    if full >= 256:
        pairs += [(16, half - 16), (half + 16, full - 32), (half - 32, half + 48)]
    for a, b in pairs:
        if a == b:
            continue
        lo, hi = unfold.folded_range(kmer_len, a, b)
        for c0 in {lo, max(lo - 1, 0)}:
            src = plane[c0:hi]
            counts = torch.zeros(256, dtype=torch.int64, device=cuda)
            want_counts = torch.zeros_like(counts)
            before = unfold.LAUNCHES
            got = unfold.unfold_file(src, c0, kmer_len, a, b, counts)
            assert unfold.LAUNCHES == before + 1
            want = unfold.unfold_file_plain(src, c0, kmer_len, a, b, want_counts)
            assert torch.equal(got, want), (a, b, c0)
            assert torch.equal(counts, want_counts), (a, b, c0)


def test_file_order_tail_on_card_whole_and_over_shards(cuda, tmp_path):
    """The raw tail of a K=11 plane on the card, whole and as a 4-shard
    interleave over a repeated device, in ragged slices: the `.kin`, sha256
    and counts of the CPU's host unfold; one unfold launch a slice."""
    from pykmer_tpu_torch.io.direct import DirectWriter
    from pykmer_tpu_torch.ops import readback, unfold

    k, slice_cells = 11, 3 << 17
    full = 4**k
    folded = _unfold_plane(k, 2)

    def tail(plane, path):
        out = np.full(full, 77, np.uint8)
        with DirectWriter(path, size=full) as fd:
            counts, hex_ = readback.stream_plane_to_out(plane, k, out, fd,
                                                        slice_cells=slice_cells)
        with open(path, "rb") as fh:
            return fh.read(), hex_, counts.tolist()

    want = tail(torch.from_numpy(folded), str(tmp_path / "cpu"))
    n_slices = 2 * -(-(full // 2) // slice_cells)
    for shards in ([torch.from_numpy(folded).to(cuda)],
                   [torch.from_numpy(folded[s::4].copy()).to(cuda) for s in range(4)]):
        before = unfold.LAUNCHES
        got = tail(shards[0] if len(shards) == 1 else shards, str(tmp_path / "card"))
        assert unfold.LAUNCHES == before + n_slices
        assert got == want


def test_raw_index_on_card_beside_a_held_pinned_output(cuda, tmp_path):
    """Two raw indexes of one process at once: while one holds the
    page-locked output (``ops/readback.output_array``), the other's card
    unfold lands in pageable memory, with the same `.kin`, and no error;
    then the pooled output is free again."""
    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.ops import readback, unfold
    from pykmer_tpu_torch.utils.profiling import StageTimer

    fasta = _genome(str(tmp_path / "o.fa"), np.random.default_rng(12))
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16, readback="raw")
    plane = torch.zeros(8, dtype=torch.uint8, device=cuda)
    assert readback.card_unfolds(plane, "raw") and readback.card_unfolds([plane] * 2, "raw")
    assert not readback.card_unfolds(plane, "packed")

    def index():
        return _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                       device=cuda))

    alone = index()
    with readback.output_array(plane, "raw", 4**11, StageTimer()) as held:
        assert np.shares_memory(held, segments.PINNED_OUT._buf.array)
        before = unfold.LAUNCHES
        beside = index()
        assert unfold.LAUNCHES > before
    assert beside == alone
    assert segments.PINNED_OUT.try_lease(4**11) is not None
    segments.PINNED_OUT.give_back()


def test_k15_index_unfolds_on_card_in_file_order(cuda, tmp_path, monkeypatch):
    """A streaming K=15 index on the card: one unfold launch a 64 Mi-cell
    slice of the file, "unfold" spans of 4^K/2 cells all on the card, every
    sha256 update a slice's (no serial remainder after the loop); its `.kin`
    and `.kin.json` equal the CPU index's, whose host unfold counts no card
    cells."""
    import json

    from reference_runner import VOLATILE_KIN_JSON_KEYS

    from pykmer_tpu_torch.ops import readback, unfold
    from pykmer_tpu_torch.utils import profiling

    fasta = _genome(str(tmp_path / "u.fa"), np.random.default_rng(10))
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    half = 4**15 // 2
    outs = []
    for dev in ("cpu", cuda):
        unfold.LAUNCHES = 0
        header = create_fasta_index(fasta, "s", fasta, 15, verbose=False, device=dev)
        run = profiling.FINISHED_RUNS[-1]
        with open(header.metadata_file) as fh:
            meta = json.load(fh)
        unfolds = [s for s in run.spans if s.name == "unfold"]
        hashes = [s.counts["bytes"] for s in run.spans if s.name == "sha256"]
        outs.append((_kin(header)[0], meta, unfold.LAUNCHES,
                     sum(s.counts["cells"] for s in unfolds),
                     sum(s.counts.get("card_cells", 0) for s in unfolds), hashes))
    (kin_c, meta_c, n_c, cells_c, card_c, _), (kin_g, meta_g, n_g, cells_g, card_g, hashes) = outs
    assert kin_g == kin_c
    assert set(meta_g) == set(meta_c)
    for key in meta_c:
        if key not in VOLATILE_KIN_JSON_KEYS:
            assert meta_g[key] == meta_c[key], key
    assert (n_c, cells_c, card_c) == (0, half, 0)
    assert n_g == 2 * half // readback.SLICE_CELLS
    assert cells_g == card_g == half
    assert sum(hashes) == 2 * half and max(hashes) <= readback.SLICE_CELLS


# ---- the BGZF inflate on the card (csrc/inflate.cu) -------------------------

def _card_inflate(data: bytes, device):
    """``data``'s BGZF blocks inflated by the kernel: (statuses, bytes)."""
    from bgzf_cases import walk

    from pykmer_tpu_torch.ops import inflate

    c, u = walk(data)
    padded = data + bytes(-len(data) % 4)
    comp = torch.frombuffer(bytearray(padded), dtype=torch.uint8).to(device)
    out = torch.full((u[-1] + 64,), 0xEE, dtype=torch.uint8, device=device)
    status = torch.full((len(c) - 1,), -1, dtype=torch.int32, device=device)
    before = inflate.LAUNCHES
    inflate.inflate_bgzf(comp, torch.tensor(c, device=device), torch.tensor(u, device=device),
                         out[: u[-1]], status)
    torch.cuda.synchronize()
    assert inflate.LAUNCHES == before + 1
    tail = out[u[-1]:].cpu()
    assert bool((tail == 0xEE).all())  # nothing written past the blocks
    return status.cpu().tolist(), out[: u[-1]].cpu().numpy().tobytes()


def _inflate_case_names():
    from bgzf_cases import cases

    return sorted(cases())


@pytest.mark.parametrize("case", _inflate_case_names())
def test_inflate_kernel_equals_zlib(cuda, case):
    """Every DEFLATE form, byte for byte against zlib, each block's status
    ok, the EOF block included."""
    from bgzf_cases import bgzf_bytes, cases

    data = bgzf_bytes(cases()[case])
    status, got = _card_inflate(data, cuda)
    assert status == [0] * len(status)
    assert got == gzip.decompress(data)


def test_inflate_kernel_many_blocks_at_offsets(cuda):
    """Several hundred blocks of every form in one launch, at a compressed
    and an inflated base inside larger buffers."""
    from bgzf_cases import bgzf_bytes, cases, walk

    from pykmer_tpu_torch.ops import inflate

    blocks = [b for _ in range(12) for bs in cases().values() for b in bs]
    data = bgzf_bytes(blocks)
    c, u = walk(data)
    lead_c, lead_u = 4 * 1001, 777
    padded = bytes(lead_c) + data + bytes(-len(data) % 4)
    comp = torch.frombuffer(bytearray(padded), dtype=torch.uint8).to(cuda)
    out = torch.zeros(lead_u + u[-1], dtype=torch.uint8, device=cuda)
    status = torch.full((len(c) - 1,), -1, dtype=torch.int32, device=cuda)
    c_dev = torch.tensor(c, device=cuda) + lead_c + 5
    u_dev = torch.tensor(u, device=cuda) + lead_u + 9
    inflate.inflate_bgzf(comp, c_dev, u_dev, out, status, c_base=5, u_base=9)
    torch.cuda.synchronize()
    assert status.cpu().tolist() == [0] * (len(c) - 1)
    assert out[lead_u:].cpu().numpy().tobytes() == gzip.decompress(data)


@pytest.mark.parametrize("what,code", [("crc", 3), ("isize", 2), ("stream", 1),
                                       ("truncated", 1)])
def test_inflate_kernel_reports_a_bad_block(cuda, what, code):
    from bgzf_cases import bgzf_bytes, cases, corrupt

    blocks = cases()["dynamic_level6"] * 3
    status, _ = _card_inflate(corrupt(bgzf_bytes(blocks), what, 1), cuda)
    assert status == [0, code, 0, 0]


def test_inflate_kernel_refuses_what_it_does_not_take(cuda):
    from pykmer_tpu_torch.ops import inflate

    offs = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = torch.zeros(8, dtype=torch.uint8, device=cuda)
    status = torch.zeros(1, dtype=torch.int32, device=cuda)
    comp = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4-byte"):
        inflate.inflate_bgzf(comp[1:], offs, offs, out, status)
    with pytest.raises(ValueError, match="multiple of 4"):
        inflate.inflate_bgzf(comp[:62], offs, offs, out, status)
    with pytest.raises(ValueError, match="entries"):
        inflate.inflate_bgzf(comp, offs[:1], offs, out, status)
    with pytest.raises(ValueError, match="on cpu"):
        inflate.inflate_bgzf(comp, offs, offs, out, status.cpu())


def _bgzf_input(path, device):
    from pykmer_tpu_torch.host import segments

    return segments.BgzfInput(segments.read_bgzf(path), card=device)


@pytest.mark.parametrize("what", ["crc", "isize", "stream", "truncated"])
def test_bgzf_card_input_raises_a_bad_block_through_wait_until(cuda, tmp_path, monkeypatch,
                                                              what):
    """A planted bad CRC, ISIZE, DEFLATE stream or a stream cut short, in the
    third run of blocks: ``wait_until`` raises the host's error (its inflate
    of the run again), never past the runs before it, and ``filled`` stops
    before the bad block."""
    from bgzf_cases import bgzf_bytes, cases, corrupt

    from pykmer_tpu_torch.host import segments

    monkeypatch.setattr(segments, "INFLATE_EXTENT", 3 * 65280)
    blocks = cases()["dynamic_level6"] * 16
    path = tmp_path / "bad.fa.gz"
    path.write_bytes(corrupt(bgzf_bytes(blocks), what, 10))
    stream = _bgzf_input(str(path), cuda)
    try:
        with pytest.raises(IOError) as err:
            stream.wait_until(stream.size)
        assert "the card's inflate" not in str(err.value)  # the host's own error
        assert stream.filled() <= 10 * 65280
    finally:
        stream.release()


def test_bgzf_card_input_names_a_block_the_host_inflates(cuda, tmp_path, monkeypatch):
    """Where the card reports a block bad that the host's zlib inflates, the
    input raises anyway, naming the block."""
    from bgzf_cases import bgzf_bytes, cases

    from pykmer_tpu_torch.ops import inflate

    real = inflate.inflate_bgzf

    def one_bad(comp, c_offs, u_offs, out, status, c_base=0, u_base=0):
        real(comp, c_offs, u_offs, out, status, c_base=c_base, u_base=u_base)
        status[-1] = inflate.BAD_CRC

    monkeypatch.setattr(inflate, "inflate_bgzf", one_bad)
    path = tmp_path / "ok.fa.gz"
    path.write_bytes(bgzf_bytes(cases()["dynamic_level6"] * 4))
    stream = _bgzf_input(str(path), cuda)
    try:
        with pytest.raises(IOError, match=r"block 4\) reports CRC mismatch, but the host"):
            stream.wait_until(stream.size)
        assert stream.filled() == 0
    finally:
        stream.release()


def test_bgzf_card_input_spans_add_up(cuda, tmp_path, monkeypatch):
    """A BGZF index of many runs on the card: every "bgzf inflate" span is
    the card's (``card_blocks`` = ``blocks``), on the one card thread,
    ``bytes`` add up to the inflated size and ``bytes_in`` to the file's;
    the runs grow from ``INFLATE_EXTENT`` to an eighth of the file; the
    `.kin` equals the plain file's, and one launch ran a run."""
    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.io import bgzf
    from pykmer_tpu_torch.ops import inflate
    from pykmer_tpu_torch.utils import profiling

    fasta = _genome(str(tmp_path / "c.fa"), np.random.default_rng(12), n_records=30,
                    length=40_000)
    gz = bgzf.compress_file(fasta, str(tmp_path / "c2.fa.gz"), write_index=False)[0]
    monkeypatch.setattr(segments, "INFLATE_EXTENT", 40_000)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    cfg = IndexConfig(kmer_len=11, chunk_windows=1 << 16)
    plain = _kin(create_fasta_index(fasta, "s", fasta, 11, config=cfg, verbose=False,
                                    device=cuda))
    inflate.LAUNCHES = 0
    header = create_fasta_index(gz, "s", gz, 11, config=cfg, verbose=False, device=cuda)
    assert _kin(header) == plain
    runs = [s for s in profiling.FINISHED_RUNS[-1].spans if s.name == "bgzf inflate"]
    src = segments.read_bgzf(gz)
    want = segments.bgzf_runs(src.u_offs, 40_000, src.size // 8)
    assert len(runs) == inflate.LAUNCHES == len(want) > 3
    assert [s.counts["bytes"] for s in runs] == [src.u_offs[b1] - src.u_offs[b0]
                                                 for b0, b1 in want]
    assert all(s.counts["card_blocks"] == s.counts["blocks"] for s in runs)
    assert {s.thread for s in runs} == {"bgzf-inflate_card"}
    assert sum(s.counts["blocks"] for s in runs) == len(src.c_offs) - 1
    assert sum(s.counts["bytes"] for s in runs) == os.path.getsize(fasta)
    assert sum(s.counts["bytes_in"] for s in runs) == os.path.getsize(gz)
    sizes = [s.counts["bytes"] for s in runs]
    assert sizes[0] < 70_000 < src.size // 8 < max(sizes)


def test_bgzip_output_on_card(cuda, tmp_path, monkeypatch):
    """A BGZF genome indexed at K=15 on the card with ``bgzip=True``: the
    `.kin.bgz` inflates under the standard library to the 1 GiB `.kin`, its
    `.kin.bgz` and `.gzi` are ``io/bgzf.bgzip_kin``'s bytes, and the spans of
    the "bgzip" stage add up (deflate bytes 4^15, blocks ceil(4^15 / 65,280),
    ``bytes_out`` + 28 and the writes the file's size); the card deflated
    every block (``card_blocks``), one launch a run of 1,024 blocks, from the
    plane, with no "kin read"."""
    import filecmp
    import hashlib
    import shutil

    from pykmer_tpu_torch.io import bgzf
    from pykmer_tpu_torch.ops import deflate
    from pykmer_tpu_torch.utils import profiling

    fasta = _genome(str(tmp_path / "z.fa"), np.random.default_rng(25), n_records=20,
                    length=100_000)
    gz = bgzf.compress_file(fasta, str(tmp_path / "z2.fa.gz"), write_index=False)[0]
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    launches = deflate.LAUNCHES
    header = create_fasta_index(gz, "z", gz, 15, verbose=False, device=cuda, bgzip=True)
    root, size = header.index_file_root, 4 ** 15
    spans = profiling.FINISHED_RUNS[-1].spans
    deflates = [s for s in spans if s.name == "bgzf deflate"]
    assert sum(s.counts["bytes"] for s in deflates) == size
    assert sum(s.counts["blocks"] for s in deflates) == -(-size // 65280)
    bgz_size = os.path.getsize(root + ".bgz")
    assert sum(s.counts["bytes_out"] for s in deflates) + 28 == bgz_size
    assert sum(s.counts["bytes"] for s in spans if s.name == "bgzf write") == bgz_size
    # the card deflated every block, from the plane: nothing was read back
    assert sum(s.counts["card_blocks"] for s in deflates) == -(-size // 65280)
    assert all(s.thread == "bgzf-deflate_card" for s in deflates)
    assert not [s for s in spans if s.name == "kin read"]
    assert deflate.LAUNCHES - launches == len(deflates) == -(-size // (65280 * 1024))
    inflated, kin = hashlib.sha256(), hashlib.sha256()
    with gzip.open(root + ".bgz", "rb") as fh, open(root, "rb") as raw:
        while True:
            piece = fh.read(64 << 20)
            if not piece:
                break
            inflated.update(piece)
            kin.update(raw.read(len(piece)))
        assert raw.read(1) == b""
    assert inflated.hexdigest() == kin.hexdigest()
    copy = str(tmp_path / "copy.kin")
    shutil.copy(root, copy)
    bgzf.bgzip_kin(copy)
    assert filecmp.cmp(root + ".bgz", copy + ".bgz", shallow=False)
    assert filecmp.cmp(root + ".bgz.gzi", copy + ".bgz.gzi", shallow=False)


def _card_members(data: bytes, device):
    """``ops/deflate.deflate_bgzf`` of ``data`` on the card: each block's
    member."""
    from pykmer_tpu_torch.ops import deflate

    members, sizes = deflate.deflate_bgzf(
        torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy()).to(device))
    sizes = sizes.cpu().tolist()
    packed = members[: sum(sizes)].cpu().numpy().tobytes()
    at = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    return [packed[a:b] for a, b in zip(at[:-1], at[1:])]


def _zlib_members(data: bytes):
    from pykmer_tpu_torch.ops import deflate

    return [deflate.member(data[a: a + 65280], deflate.zlib_raw(data[a: a + 65280]))
            for a in range(0, len(data), 65280)]


@pytest.mark.parametrize("name", deflate_cases.NAMES)
def test_deflate_kernel_equals_zlib(cuda, name):
    """Each case of ``tests/deflate_cases.py`` as one block: the member's
    bytes are zlib level 6's (the empty payload has no block)."""
    from pykmer_tpu_torch.ops import deflate

    data = deflate_cases.case(name)
    before = deflate.LAUNCHES
    got = _card_members(data, cuda)
    assert got == _zlib_members(data)
    assert deflate.LAUNCHES == before + (len(data) > 0)


def test_deflate_kernel_over_many_blocks(cuda):
    """Whole-block cases side by side with a ragged last block, in one
    launch."""
    whole = [n for n in deflate_cases.NAMES if len(deflate_cases.case(n)) == 65280]
    data = b"".join(deflate_cases.case(n) for n in whole) + deflate_cases.case("ends-in-copy-258")
    assert len(whole) >= 6
    assert _card_members(data, cuda) == _zlib_members(data)


def test_deflate_kernel_on_a_k15_plane(cuda, tmp_path):
    """2,000 blocks of a K=15 `.kin` (its first, middle and last, with the
    ragged end) against the standard library's zlib, member by member."""
    fasta = _genome(str(tmp_path / "d.fa"), np.random.default_rng(26), n_records=20,
                    length=100_000)
    header = create_fasta_index(fasta, "d", fasta, 15, verbose=False, device=cuda)
    kin = np.fromfile(header.index_file_root, dtype=np.uint8)
    blocks = -(-kin.shape[0] // 65280)
    mid = blocks // 2 - 350
    for b0, b1 in ((0, 700), (mid, mid + 700), (blocks - 600, blocks)):
        data = kin[b0 * 65280: b1 * 65280].tobytes()
        assert _card_members(data, cuda) == _zlib_members(data)


def test_deflate_kernel_refuses_what_it_does_not_take(cuda):
    from pykmer_tpu_torch.ops import deflate

    for bad in (torch.zeros(8, dtype=torch.int32, device=cuda),
                torch.zeros(16, dtype=torch.uint8, device=cuda)[::2]):
        with pytest.raises(ValueError, match="contiguous 1-D uint8"):
            deflate.deflate_bgzf(bad)


def _bgzip_index(index, fasta, name, **kw):
    """``index`` ``fasta`` at K=13 with ``bgzip=True``: its `.kin.bgz`, `.gzi`
    and `.kin` bytes, and the spans of the run."""
    from pykmer_tpu_torch.utils import profiling

    header = index(fasta, name, fasta, 13, verbose=False, bgzip=True, **kw)
    root = header.index_file_root
    out = []
    for path in (root + ".bgz", root + ".bgz.gzi", root):
        with open(path, "rb") as fh:
            out.append(fh.read())
    return out, profiling.FINISHED_RUNS[-1].spans


def test_sharded_bgzip_reads_back_on_card(cuda, tmp_path, monkeypatch):
    """A sharded ``bgzip=True`` index over two logical shards of the card
    writes the single card's `.kin.bgz` and `.gzi`, deflated on the card from
    the file read back."""
    from pykmer_tpu_torch.index import create_fasta_index_sharded
    from pykmer_tpu_torch.parallel import make_mesh

    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    fasta = _genome(str(tmp_path / "s.fa"), np.random.default_rng(27), n_records=8,
                    length=60_000)
    single, single_spans = _bgzip_index(create_fasta_index, fasta, "a", device=cuda)
    sharded, spans = _bgzip_index(create_fasta_index_sharded, fasta, "b",
                                  mesh=make_mesh(2, 1, devices=[cuda, cuda]))
    assert sharded == single
    size = 4 ** 13
    deflates = [s for s in spans if s.name == "bgzf deflate"]
    assert sum(s.counts["card_blocks"] for s in deflates) == -(-size // 65280)
    assert sum(s.counts["bytes"] for s in spans if s.name == "kin read") == size
    assert not [s for s in single_spans if s.name == "kin read"]


@pytest.mark.parametrize("readback", ["raw", "packed", "sparse", "pieces"])
def test_bgzip_from_the_plane_after_each_tail(cuda, tmp_path, monkeypatch, readback):
    """The card deflates the plane the tail has just written: after every
    tail, sparse and pieces with their thresholds lowered, the `.kin.bgz`
    and `.gzi` are those ``io/bgzf.bgzip_kin`` makes from the `.kin`."""
    import shutil

    from pykmer_tpu_torch.config import IndexConfig
    from pykmer_tpu_torch.index import indexer
    from pykmer_tpu_torch.io import bgzf
    from pykmer_tpu_torch.ops import packing

    if readback in ("sparse", "pieces"):
        monkeypatch.setattr(packing, "SPARSE_MIN_CELLS", 1)
        monkeypatch.setattr(packing, "SPARSE_SEG_CELLS", 1 << 16)
    if readback == "pieces":
        monkeypatch.setattr(indexer, "PIECES_MIN_CELLS", 0)
    monkeypatch.setenv("PYKMER_TPU_STAGE_TIMING", "1")
    fasta = _genome(str(tmp_path / "t.fa"), np.random.default_rng(28), n_records=8,
                    length=60_000)
    mode = "sparse" if readback == "pieces" else readback
    tails = dict(indexer.TAILS)
    (bgz, gzi, kin), _ = _bgzip_index(create_fasta_index, fasta, "t", device=cuda,
                                      config=IndexConfig(kmer_len=13, readback=mode))
    assert indexer.TAILS[readback] == tails.get(readback, 0) + 1
    copy = str(tmp_path / "copy.kin")
    with open(copy, "wb") as fh:
        fh.write(kin)
    bgzf.bgzip_kin(copy)
    with open(copy + ".bgz", "rb") as fh:
        assert bgz == fh.read()
    with open(copy + ".bgz.gzi", "rb") as fh:
        assert gzi == fh.read()
