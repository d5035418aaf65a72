"""BENCHMARK.json and the files it names: found by name, within the rules."""

import json
import os

import pytest

from kbench import harness


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_has_exactly_the_contract_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "kbench/run.py"]
    assert manifest["paths"] == ["kbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(harness.MANIFEST) <= 64 << 10


def test_names_units_and_files(manifest):
    assert harness.manifest_errors(manifest) == []
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in manifest[key]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "-a", "é", "x" * 65])
def test_name_rule_rejects(bad):
    assert not harness.NAME.match(bad)


@pytest.mark.parametrize("unit,ok", [("bp/s", True), ("%", True), ("s/Gbp", True),
                                     ("tokens per second", False), ("µs", False)])
def test_unit_rule(unit, ok):
    assert bool(harness.UNIT.match(unit)) == ok


def test_every_cell_loads_its_files_by_name(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for cell in manifest["workloads"]:
        assert cell["chips"] == 1
        assert len(cell["why"]) <= 200
        config = harness.data_file("configs", cell["config"])
        workload = harness.data_file("workloads", cell["traffic"])
        assert workload["config"] == cell["config"]
        kind = harness.code_file("jobs", workload["job"])
        for fn in ("setup", "call", "end_to_end", "check", "control"):
            assert callable(getattr(kind, fn))
        assert config["kmer_len"] % 2 == 1
        reported = harness.metrics_of(manifest, "end_to_end", cell["name"])
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        layers = harness.metrics_of(manifest, "per_layer", cell["name"])
        assert layers and all(m["moves"] in {r["name"] for r in reported} for m in layers)
        for m in layers:
            assert callable(harness.code_file("metrics", m["name"]).read)
            assert m["moves"] in e2e


def test_configs_name_their_files_and_sources(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kbench/") and len(c["source"]) <= 200
        with open(os.path.join(harness.ROOT, c["file"])) as fh:
            own = json.load(fh)
        assert own["source"] == c["source"] and own["reduced"] == c["reduced"]


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert "bound" not in m and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
