"""Kernel tests that need an NVIDIA GPU and nvcc (marker ``cuda``).

They skip where no CUDA device is usable. This file imports no jax, so it
runs on a GPU machine without it; tests/conftest.py does import jax, hence:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pykmer_tpu.config import IndexConfig
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
