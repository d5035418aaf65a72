"""pykmer_tpu_torch imports neither jax nor anything of pykmer_tpu.

A fresh interpreter installs a meta-path finder that refuses ``jax``,
``jaxlib``, ``pykmer_tpu`` and every ``pykmer_tpu.*`` module, imports every
module of the port and runs, on the CPU, the CLI's subcommands: index of a
plain, a gzip and a bgzip FASTA, read, index with the host strategy and
``--bgzip``, a sharded index with checkpoints, merge and its sharded
version, distance, kwip, gzi, testgen and bgzip; then a serve session and a
sharded index through the Python API. The test process runs the same
commands through the JAX package's CLI, outside the block and in the same
directory, and every output file and printed output of the two must be
equal, byte for byte (a `.kin.json` / `.kma.json` up to its creation times
and speed, a testgen file up to its gzip header's write time).
"""

import gzip
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu import cli as jcli
from pykmer_tpu.io.bgzf import compress_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every command runs through both CLIs; the port's gets --device cpu where
# it takes one
COMMANDS = [
    ["testgen", "ex-", "5"],
    ["index", "nj.fa", "s", "5", "--quiet", "--chunk-windows", "64"],
    ["index", "nj.fa.gz", "z", "5", "--quiet"],
    ["index", "nj.fa.bgz", "g", "5", "--quiet"],
    ["read", "nj.fa", "5"],
    ["index", "b.fa", "b", "5", "--quiet", "--accumulate", "host", "--bgzip"],
    ["index", "c.fa", "c", "5", "--quiet", "--shards", "4", "--checkpoint-every", "1",
     "--chunk-windows", "64"],
    ["merge", "proj", "nj.fa.05.kin", "b.fa.05.kin.bgz", "c.fa.05.kin", "--quiet"],
    ["merge", "projs", "nj.fa.05.kin", "b.fa.05.kin.bgz", "c.fa.05.kin", "--shards", "4",
     "--quiet"],
    ["distance", "proj.001-255.kma"],
    ["kwip", "all.dist", "--compare-kma", "proj.001-255.kma"],
    ["gzi", "nj.fa.bgz.gzi"],
    ["bgzip", "nj.fa.05.kin"],
]
DEVICE_COMMANDS = ("index", "merge")
# printed output compared between the two (index and merge print progress
# notes of their own engines)
PRINTING = ("read", "distance", "kwip", "gzi", "testgen", "bgzip")

_SCRIPT = r"""
import importlib.abc
import sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == p or name.startswith(p + ".")
               for p in ("jax", "jaxlib", "pykmer_tpu")):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Refuse())
import io, json, os, shutil
from contextlib import redirect_stdout

import pykmer_tpu_torch
from pykmer_tpu_torch import cli, serve, state, testgen
from pykmer_tpu_torch.analysis import cluster, distance, kwip, metrics, nj, tree
from pykmer_tpu_torch.config import IndexConfig
from pykmer_tpu_torch.formats import header, kin, kma
from pykmer_tpu_torch.host import chunks, decode, pipeline, segments
from pykmer_tpu_torch.index import create_fasta_index_sharded, index_batch, read_fasta_index
from pykmer_tpu_torch.index import sharded as sharded_index
from pykmer_tpu_torch.io import bgzf, direct, fasta, gzi, native
from pykmer_tpu_torch.merge import merge, pair_counts_stream
from pykmer_tpu_torch.ops import _build, compare, encode, histogram, readback, sweep
from pykmer_tpu_torch.oracle import gold
from pykmer_tpu_torch.parallel import collectives, make_mesh, mesh, multihost
from pykmer_tpu_torch.parallel import compare as pcompare
from pykmer_tpu_torch.parallel import histogram as phist
from pykmer_tpu_torch.utils import bigmem, checksum, profiling, timer

commands, device_commands = json.loads(sys.argv[1]), json.loads(sys.argv[2])
results = []
for argv in commands:
    extra = ["--device", "cpu"] if argv[0] in device_commands else []
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(argv + extra)
    results.append((rc, out.getvalue()))

# a serve session, the sharded index through the API and a merge, on a copy
# of nj.fa whose outputs are removed after their checks
single = open("nj.fa.05.kin", "rb").read()
shutil.copyfile("nj.fa", "d.fa")
out = io.StringIO()
reqs = ('{"cmd": "ping"}\n'
        '{"cmd": "index", "input": "d.fa", "sample": "v", "kmer_len": 5}\n'
        '{"cmd": "shutdown"}\n')
assert serve.serve(io.StringIO(reqs), out, device="cpu") == 0
assert [json.loads(x)["ok"] for x in out.getvalue().splitlines()] == [True] * 3
assert open("d.fa.05.kin", "rb").read() == single
hs = create_fasta_index_sharded(
    "d.fa", "s", "d.fa", 5, config=IndexConfig(kmer_len=5, chunk_windows=64),
    mesh=make_mesh(2, 2, device="cpu"), checkpoint_every=1, verbose=False)
assert open(hs.index_file_root, "rb").read() == single
_, m = merge("pair", ["d.fa.05.kin", "c.fa.05.kin"], engine="device", verbose=False,
             device="cpu")
assert tuple(int(x) for x in m[0, 1]) == pair_counts_stream("d.fa.05.kin", "c.fa.05.kin",
                                                            4**5)
for f in ("d.fa", "d.fa.05.kin", "d.fa.05.kin.json", "pair.001-255.kma",
          "pair.001-255.kma.json"):
    os.remove(f)
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "pykmer_tpu"))
assert not leaked, leaked
print(json.dumps(results))
"""


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _write_dist(path, ids, rng):
    d = rng.uniform(0.1, 1.0, size=(len(ids), len(ids)))
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    with open(path, "w") as fh:
        fh.write("\t" + "\t".join(ids) + "\n")
        for i, row_id in enumerate(ids):
            fh.write(row_id + "\t" + "\t".join(f"{v:.6f}" for v in d[i]) + "\n")


def _stable(printed):
    """Printed output without its creation-time and speed lines."""
    volatile = VOLATILE_KIN_JSON_KEYS | {"creation_speed"}
    return [ln for ln in printed.splitlines() if ln.split(" ")[0] not in volatile]


def _take_outputs(inputs):
    """Every file in the cwd but the inputs, comparable form; each is removed."""
    got = {}
    for f in sorted(set(os.listdir(".")) - inputs):
        data = _read(f)
        if f.endswith((".kin.json", ".kma.json")):
            meta = json.loads(data)
            for h in [meta] + [d["header"] for d in meta.get("data", [])]:
                for key in VOLATILE_KIN_JSON_KEYS | {"creation_speed"}:
                    h.pop(key, None)
            data = meta
        elif f.endswith(".fasta.gz"):
            data = gzip.decompress(data)  # its header carries the write time
        elif f.endswith(".png"):
            data = None  # the rendered tree's pixels are matplotlib's
        got[f] = data
        os.remove(f)
    return got


def test_port_runs_without_jax_or_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    make_random_fasta("nj.fa", rng, n_records=3, lengths=(300, 40, 500))
    with open("nj.fa", "rb") as src, gzip.open("nj.fa.gz", "wb") as dst:
        dst.write(src.read())
    compress_file("nj.fa", "nj.fa.bgz")
    make_random_fasta("b.fa", rng, n_records=2, lengths=(400, 90))
    shutil.copyfile("b.fa", "c.fa")
    _write_dist("all.dist", [f"{s}.fa.khmer" for s in ("nj", "b", "c")], rng)
    inputs = set(os.listdir("."))

    want = []
    for argv in COMMANDS:
        out = io.StringIO()
        with redirect_stdout(out):
            rc = jcli.main(argv)
        want.append((rc, out.getvalue()))
    want_files = _take_outputs(inputs)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, json.dumps(COMMANDS), json.dumps(DEVICE_COMMANDS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = [tuple(r) for r in json.loads(proc.stdout.splitlines()[-1])]
    got_files = _take_outputs(inputs)

    for argv, (rc_j, out_j), (rc_t, out_t) in zip(COMMANDS, want, got):
        assert rc_j == rc_t == 0, argv
        if argv[0] in PRINTING:
            assert _stable(out_t) == _stable(out_j), argv
    assert sorted(got_files) == sorted(want_files)
    for name in ("nj.fa.05.kin", "nj.fa.gz.05.kin", "nj.fa.bgz.05.kin", "b.fa.05.kin.bgz",
                 "c.fa.05.kin", "proj.001-255.kma", "projs.001-255.kma",
                 "proj.001-255.kma.dist.jaccard.npz", "ex--05.fasta.gz",
                 "nj.fa.05.kin.bgz", "nj.fa.05.kin.bgz.gzi"):
        assert name in got_files, name
    for name, data in want_files.items():
        assert got_files[name] == data, name
