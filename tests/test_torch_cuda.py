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

from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch import create_fasta_index
from pykmer_tpu_torch.ops import sweep
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
