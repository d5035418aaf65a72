"""The check of loaded modules compares whole top-level names, and a run
of a cell loads neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

from kbench import harness


def test_whole_top_level_names():
    mods = {"pykmer_tpu_torch": 1, "pykmer_tpu_torch.ops.sweep": 1, "jaxtyping": 1,
            "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules({**mods, "jax": 1}) == ["jax"]
    assert harness.forbidden_modules({**mods, "pykmer_tpu.ops": 1}) == ["pykmer_tpu.ops"]
    assert harness.forbidden_modules({"jaxlib.xla_client": 1, "flax": 1}) \
        == ["flax", "jaxlib.xla_client"]
    assert harness.forbidden_modules({"bench": 1, "bench_gpu": 1}) == ["bench", "bench_gpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A small index run in a fresh process, then the loaded modules are
    checked."""
    code = f"""
import json, sys
sys.path.insert(0, {harness.ROOT!r})
from kbench import harness
cfg = dict(harness.data_file("configs", "plants-k15"), kmer_len=7, genome_bp=100000,
           records=2, n_bases=5000)
wl = dict(harness.data_file("workloads", "plants-k15.index"), warm_bp=50000)
a = harness.execute("plants-k15.index", 3, 0.0, False, "cpu", config=cfg, workload=wl,
                    say=lambda s: None, directory="run_a")
print(json.dumps([a["correct"], harness.forbidden_modules()]))
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(harness.KBENCH, "reference")
    for name in sorted(n for n in os.listdir(folder) if n.endswith(".py")):
        path = os.path.join(folder, name)
        with open(path) as fh:
            text = fh.read()
        assert "pykmer" not in text.replace("sauloal/pykmer", "").replace(
            "reference pykmer", "")
