"""pykmer_tpu_torch never imports jax, directly or through pykmer_tpu.

A fresh interpreter blocks jax (``sys.modules["jax"] = None`` makes any
``import jax`` raise), imports the port and runs a K=5 index on the CPU.
"""

import os
import subprocess
import sys

import numpy as np

from conftest import make_random_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from pykmer_tpu.config import IndexConfig
import pykmer_tpu_torch
from pykmer_tpu_torch import cli, state
from pykmer_tpu_torch.ops import _build, encode, histogram, readback, sweep
h = pykmer_tpu_torch.create_fasta_index(
    sys.argv[1], "s", sys.argv[1], 5,
    config=IndexConfig(kmer_len=5, chunk_windows=64), verbose=False, device="cpu")
assert h.num_kmers > 0
for name in ("pykmer_tpu.ops", "pykmer_tpu.index", "pykmer_tpu.parallel",
             "pykmer_tpu.merge", "pykmer_tpu._jax_setup"):
    assert name not in sys.modules, name
print("NOJAX_OK", h.num_kmers)
"""


def test_port_runs_without_jax(tmp_path):
    fasta = make_random_fasta(str(tmp_path / "nj.fa"), np.random.default_rng(0),
                              n_records=3, lengths=(300, 40, 500))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, fasta], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout
    assert os.path.exists(fasta + ".05.kin")
