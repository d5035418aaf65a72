"""The port's JSON-lines service on the CPU vs ``pykmer_tpu.serve`` (JAX).

The scenarios of tests/test_serve.py run against
``pykmer_tpu_torch.serve.serve(device="cpu")``; the pipeline's `.kin` and
`.kma` files must equal those of the JAX service on the same inputs.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu import serve as jax_serve
from pykmer_tpu_torch import serve as port_serve
from pykmer_tpu_torch.ops import sweep


def _session(serve_fn, lines, **kw):
    out = io.StringIO()
    rc = serve_fn(stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out, **kw)
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line]


def _port(lines):
    return _session(port_serve.serve, lines, device="cpu")


def _pipeline_requests(tmp_path, fa1, fa2, k):
    return [
        {"cmd": "ping"},
        {"cmd": "nope"},  # unknown command -> error, service survives
        {"cmd": "index", "input": fa1, "sample": "s1", "kmer_len": k},
        {"cmd": "index", "input": "/does/not/exist.fa", "sample": "x",
         "kmer_len": k},  # per-job failure isolation
        {"cmd": "index", "input": fa2, "sample": "s2", "kmer_len": k,
         "bgzip": True},
        {"cmd": "merge", "project": str(tmp_path / "proj"),
         "indexes": [f"{fa1}.{k:02d}.kin", f"{fa2}.{k:02d}.kin"]},
        {"cmd": "distance",
         "matrix_file": str(tmp_path / "proj.001-255.kma")},
        {"cmd": "shutdown"},
    ]


def _take(paths):
    got = {}
    for p in paths:
        with open(p, "rb") as fh:
            got[p] = fh.read()
        os.remove(p)
    return got


def test_serve_pipeline_matches_jax(tmp_path):
    """index x2 -> merge -> distance through one service in each package:
    the same replies (apart from timings) and the same `.kin`, `.kin.bgz`,
    `.kma` and distance files."""
    k = 5
    rng = np.random.default_rng(40)
    fa1 = make_random_fasta(str(tmp_path / "s1.fa"), rng, n_records=2,
                            lengths=(600, 300))
    fa2 = make_random_fasta(str(tmp_path / "s2.fa"), rng, n_records=2,
                            lengths=(500, 250))
    reqs = [json.dumps(r) for r in _pipeline_requests(tmp_path, fa1, fa2, k)]
    kins = [f"{fa1}.{k:02d}.kin", f"{fa2}.{k:02d}.kin"]
    kma = str(tmp_path / "proj.001-255.kma")
    files = kins + [kins[1] + ".bgz", kins[1] + ".bgz.gzi", kma,
                    kma + ".dist.jaccard.npz"]
    metas = [p + ".json" for p in kins] + [kma + ".json"]

    runs = []
    for fn, kw in ((jax_serve.serve, {}), (port_serve.serve, {"device": "cpu"})):
        rc, resps = _session(fn, reqs, **kw)
        assert rc == 0
        for r in resps:
            r.pop("seconds", None)
        meta = {}
        for p in metas:
            with open(p) as fh:
                meta[p] = json.load(fh)
        runs.append((resps, _take(files), meta))
        for p in os.listdir(tmp_path):
            if ".kin" in p or ".kma" in p:
                os.remove(str(tmp_path / p))
    (rj, fj, mj), (rt, ft, mt) = runs
    assert [r["cmd"] for r in rt] == [json.loads(q)["cmd"] for q in reqs]
    assert [r["ok"] for r in rt] == [True, False, True, False, True, True, True, True]
    assert rt[2]["num_kmers"] > 0 and rt[5]["samples"] == 2
    assert "FileNotFoundError" in rt[3]["error"] or "No such file" in rt[3]["error"]
    assert rt == rj
    for p in files:
        assert ft[p] == fj[p], p
    for p in metas[:2]:
        for key in mj[p]:
            if key not in VOLATILE_KIN_JSON_KEYS:
                assert mt[p][key] == mj[p][key], (p, key)
    for dj, dt in zip(mj[kma + ".json"]["data"], mt[kma + ".json"]["data"]):
        for key in dj["header"]:
            if key not in VOLATILE_KIN_JSON_KEYS:
                assert dt["header"][key] == dj["header"][key], key
        assert {x: dt[x] for x in dt if x != "header"} == \
            {x: dj[x] for x in dj if x != "header"}


def test_serve_malformed_json_lines():
    rc, resps = _port([
        "{not json", "[1, 2, 3]", '"just a string"', "42", "",
        '{"cmd": "ping"}', '{"cmd": "shutdown"}',
    ])
    assert rc == 0
    assert len(resps) == 6  # the blank line produces nothing
    assert [r["ok"] for r in resps] == [False] * 4 + [True, True]
    assert "bad json" in resps[0]["error"]
    assert "JSON object" in resps[1]["error"]
    assert resps[4]["cmd"] == "ping"


def test_serve_missing_fields_isolated():
    lines = [
        '{"cmd": "index"}',
        '{"cmd": "index", "kmer_len": "seven"}',
        '{"cmd": "merge"}',
        '{"cmd": "distance"}',
        '{"cmd": "warmup"}',
        '{"cmd": "ping"}',
        '{"cmd": "shutdown"}',
    ]
    rc, resps = _port(lines)
    assert rc == 0
    assert len(resps) == 7
    assert [r["ok"] for r in resps[:5]] == [False] * 5
    assert all("error" in r for r in resps[:5])
    assert resps[5]["ok"] is True
    assert _session(jax_serve.serve, lines) == (rc, resps)


def test_serve_shutdown_stops_queue():
    rc, resps = _port(['{"cmd": "ping"}', '{"cmd": "shutdown"}',
                       '{"cmd": "ping"}', '{"cmd": "bogus"}'])
    assert rc == 0
    assert len(resps) == 2
    assert resps[1]["cmd"] == "shutdown" and resps[1]["ok"] is True


def test_serve_batched_lines_in_order():
    lines = ['{"cmd": "ping", "seq": %d}' % i for i in range(20)]
    rc, resps = _port(lines + ['{"cmd": "shutdown"}'])
    assert rc == 0
    assert len(resps) == 21
    assert all(r["ok"] for r in resps)
    assert [r["cmd"] for r in resps[:20]] == ["ping"] * 20


def test_serve_eof_without_shutdown():
    out = io.StringIO()
    assert port_serve.serve(stdin=io.StringIO('{"cmd": "ping"}\n'), stdout=out,
                            device="cpu") == 0
    assert json.loads(out.getvalue().strip())["ok"] is True


def test_serve_survives_out_of_memory(tmp_path, monkeypatch):
    """A job that runs out of device memory fails alone; the next job runs."""
    import pykmer_tpu_torch.index as tindex

    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(tindex, "create_fasta_index", oom)
    rc, resps = _port(['{"cmd": "index", "input": "g.fa", "sample": "g", "kmer_len": 5}',
                       '{"cmd": "ping"}'])
    assert rc == 0
    assert resps[0]["ok"] is False and "OutOfMemoryError" in resps[0]["error"]
    assert resps[1] == {"ok": True, "cmd": "ping"}


@pytest.mark.parametrize("kmer_len", [5, 9])
def test_serve_warmup_on_cpu(kmer_len):
    """warmup runs step A and a sweep of one dummy chunk (no launches on the
    CPU) and answers with its seconds."""
    sweep.LAUNCHES = 0
    rc, resps = _port([json.dumps({"cmd": "warmup", "kmer_len": kmer_len})])
    assert rc == 0 and resps[0]["ok"] is True and resps[0]["seconds"] >= 0
    assert resps[0]["cmd"] == "warmup" and sweep.LAUNCHES == 0


def test_serve_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.serve(stdin=io.StringIO('{"cmd": "ping"}\n'), stdout=io.StringIO())
