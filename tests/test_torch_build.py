"""The kernels' build (``pykmer_tpu_torch/ops/_build.py``) with a
stand-in for nvcc: one compile process a source, then one link of the
objects, the library moved into place atomically, nothing left behind.
nvcc itself exists only on the GPU machine (``tests/test_torch_cuda.py``)."""

import os
import stat
import sys

import pytest

from pykmer_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as fh:
    fh.write(" ".join(args) + "\\n")
out = args[args.index("-o") + 1]
if "-c" in args and "bad.cu" in args[-1]:
    print("bad.cu(1): error: broken")
    sys.exit(2)
with open(out, "w") as fh:
    fh.write("built from " + " ".join(os.path.basename(a) for a in args if a.endswith((".cu", ".o"))))
print("ptxas info    : compiled " + os.path.basename(out))
"""


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return log


def _sources(tmp_path, names):
    paths = []
    for name in names:
        p = tmp_path / "csrc" / name
        p.parent.mkdir(exist_ok=True)
        p.write_text("// " + name)
        paths.append(str(p))
    return paths


def test_build_compiles_each_source_then_links(tmp_path, fake_nvcc):
    srcs = _sources(tmp_path, ["encode.cu", "sweep.cu"])
    so = str(tmp_path / "out" / "lib.so")
    os.makedirs(os.path.dirname(so))
    log = _build._compile_and_link(srcs, so)
    calls = fake_nvcc.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    links = [c for c in calls if c.startswith("-shared")]
    assert len(compiles) == 2 and len(links) == 1
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert not any("-shared" in c.split() for c in compiles)
    assert {c.split()[-1] for c in compiles} == set(srcs)
    assert open(so).read() == "built from encode.cu.o sweep.cu.o"
    assert "compiled encode.cu.o" in log and "compiled lib.so" in log
    assert os.listdir(os.path.dirname(so)) == ["lib.so"]  # the objects are gone


def test_build_failure_raises_with_nvcc_output(tmp_path, fake_nvcc):
    srcs = _sources(tmp_path, ["bad.cu", "sweep.cu"])
    so = str(tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="error: broken"):
        _build._compile_and_link(srcs, so)
    assert not os.path.exists(so)
    assert not [c for c in fake_nvcc.read_text().splitlines() if c.startswith("-shared")]
    assert sorted(os.listdir(tmp_path)) == ["csrc", "nvcc", "nvcc.log"]
