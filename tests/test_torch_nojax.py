"""pykmer_tpu_torch never imports jax, directly or through pykmer_tpu.

A fresh interpreter blocks jax (``sys.modules["jax"] = None`` makes any
``import jax`` raise), imports the port and runs, on the CPU, a K=5 index,
a sharded index with a checkpoint, a merge of two indexes and its sharded
version, the CLI's ``distance`` and a two-line serve session. Neither jax
nor ``pykmer_tpu.parallel`` is imported by any of it.
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
import io, json, shutil
from pykmer_tpu_torch import cli, serve, state
from pykmer_tpu_torch.host import chunks, decode, pipeline, segments
from pykmer_tpu_torch.index import index_batch, read_fasta_index
from pykmer_tpu_torch.merge import merge, pair_counts_stream
from pykmer_tpu_torch.ops import _build, compare, encode, histogram, readback, sweep
from pykmer_tpu_torch.index import create_fasta_index_sharded
from pykmer_tpu_torch.index import sharded as sharded_index
from pykmer_tpu_torch.parallel import collectives, make_mesh, mesh, multihost
from pykmer_tpu_torch.parallel import compare as pcompare
from pykmer_tpu_torch.parallel import histogram as phist
h = pykmer_tpu_torch.create_fasta_index(
    sys.argv[1], "s", sys.argv[1], 5,
    config=IndexConfig(kmer_len=5, chunk_windows=64), verbose=False, device="cpu")
assert h.num_kmers > 0
assert cli.main(["index", sys.argv[1], "s", "5", "--quiet", "--device", "cpu",
                 "--accumulate", "host", "--bgzip"]) == 0
read_fasta_index(sys.argv[1], input_file=sys.argv[1], kmer_len=5, verbose=False)
kin = sys.argv[1] + ".05.kin"
shutil.copyfile(sys.argv[1], "b.fa")
pykmer_tpu_torch.create_fasta_index("b.fa", "b", "b.fa", 5, verbose=False, device="cpu")
_, m = merge("proj", [kin, "b.fa.05.kin"], engine="device", verbose=False, device="cpu")
assert tuple(int(x) for x in m[0, 1]) == pair_counts_stream(kin, "b.fa.05.kin", 4**5)
_, ms = merge("projs", [kin, "b.fa.05.kin"], n_shards=4, verbose=False, device="cpu")
assert (ms == m).all()
single = open(kin, "rb").read()
hs = create_fasta_index_sharded(
    sys.argv[1], "s", sys.argv[1], 5, config=IndexConfig(kmer_len=5, chunk_windows=64),
    mesh=make_mesh(2, 2, device="cpu"), checkpoint_every=1, verbose=False)
assert open(hs.index_file_root, "rb").read() == single
assert cli.main(["distance", "proj.001-255.kma"]) == 0
out = io.StringIO()
assert serve.serve(io.StringIO('{"cmd": "ping"}\n{"cmd": "shutdown"}\n'), out,
                   device="cpu") == 0
assert [json.loads(x)["ok"] for x in out.getvalue().splitlines()] == [True, True]
for name in ("pykmer_tpu.ops", "pykmer_tpu.index", "pykmer_tpu.parallel",
             "pykmer_tpu.parallel.histogram", "pykmer_tpu.parallel.multihost",
             "pykmer_tpu.merge", "pykmer_tpu._jax_setup", "pykmer_tpu.serve",
             "pykmer_tpu.cli"):
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
    assert os.path.exists(str(tmp_path / "proj.001-255.kma.dist.jaccard.npz"))
