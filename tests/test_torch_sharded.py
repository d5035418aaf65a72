"""The port's sharded index and sharded merge on the CPU vs the JAX package.

The JAX side runs on its 8-device virtual CPU mesh, the port on meshes that
repeat the CPU device. The `.kin` and `.kma` files must be byte-identical
(and the `.kin.json` stats equal), checkpoints must resume across runs and
across the two packages, and the CLI and the service must reach the sharded
paths.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_random_fasta

from pykmer_tpu import cli as jcli
from pykmer_tpu.config import IndexConfig
from pykmer_tpu.index import create_fasta_index_sharded as jax_sharded
from pykmer_tpu.index import sharded as jsharded_mod
from pykmer_tpu.merge import merge as jax_merge
from pykmer_tpu.parallel import make_mesh as jmake_mesh
from pykmer_tpu_torch import cli as tcli
from pykmer_tpu_torch import create_fasta_index
from pykmer_tpu_torch import serve as port_serve
from pykmer_tpu_torch.index import create_fasta_index_sharded
from pykmer_tpu_torch.index import sharded as tsharded_mod
from pykmer_tpu_torch.merge import merge as port_merge
from pykmer_tpu_torch.parallel import make_mesh
from pykmer_tpu_torch.parallel.multihost import load_shard_checkpoint, save_shard_checkpoint

STATS_KEYS = ("num_kmers", "chromosomes", "hist", "vals_sum", "vals_count")


class Abort(Exception):
    pass


def _take(header):
    """(.kin bytes, .kin.json dict) of ``header``; both files are removed."""
    with open(header.index_file_root, "rb") as fh:
        kin = fh.read()
    with open(header.metadata_file) as fh:
        meta = json.load(fh)
    os.remove(header.index_file_root)
    os.remove(header.metadata_file)
    return kin, meta


def _fasta(tmp_path, name, seed, lengths=(700, 300, 90, 500)):
    return make_random_fasta(str(tmp_path / name), np.random.default_rng(seed),
                             n_records=len(lengths), lengths=lengths)


@pytest.mark.parametrize("n_data,n_shards", [(1, 1), (1, 2), (2, 4), (1, 8)])
def test_sharded_kin_matches_jax_and_single(tmp_path, n_data, n_shards):
    fasta = _fasta(tmp_path, "s.fa", 80 + n_shards)
    k = 5
    cfg = IndexConfig(kmer_len=k, chunk_windows=128)
    want = _take(jax_sharded(fasta, "x", fasta, k, config=cfg, verbose=False,
                             mesh=jmake_mesh(n_shards=n_shards, n_data=n_data)))
    single = _take(create_fasta_index(fasta, "x", fasta, k, config=cfg,
                                      verbose=False, device="cpu"))
    got = _take(create_fasta_index_sharded(
        fasta, "x", fasta, k, config=cfg, verbose=False,
        mesh=make_mesh(n_shards, n_data, device="cpu")))
    assert got[0] == want[0] == single[0]
    for key in STATS_KEYS:
        assert got[1][key] == want[1][key] == single[1][key], key
    assert got[1]["output_file_cheksum"] == single[1]["output_file_cheksum"]
    assert got[1]["input_file_cheksum"] == want[1]["input_file_cheksum"]


def _abort_after(monkeypatch, module, n):
    """Make ``module.multihost.save_shard_checkpoint`` raise Abort after its
    ``n``th save."""
    real = module.multihost.save_shard_checkpoint
    calls = {"n": 0}

    def save_and_abort(*args, **kwargs):
        real(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == n:
            raise Abort()

    monkeypatch.setattr(module.multihost, "save_shard_checkpoint", save_and_abort)
    return real


def test_sharded_checkpoint_abort_and_resume(tmp_path, monkeypatch, capsys):
    fasta = _fasta(tmp_path, "r.fa", 90, lengths=(900, 600, 400))
    cfg = IndexConfig(kmer_len=5, chunk_windows=64)
    mesh = make_mesh(4, device="cpu")
    want = _take(create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg,
                                            mesh=mesh, verbose=False))
    real = _abort_after(monkeypatch, tsharded_mod, 2)
    with pytest.raises(Abort):
        create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg, mesh=mesh,
                                   checkpoint_every=1, verbose=False)
    monkeypatch.setattr(tsharded_mod.multihost, "save_shard_checkpoint", real)
    tmp = fasta + ".05.kin.tmp"
    shards, state = load_shard_checkpoint(tmp)
    assert state["next_step"] == 2 and shards.shape == (4, 4**5 // 8)
    capsys.readouterr()
    header = create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg, mesh=mesh)
    assert "resuming from checkpoint at step 2/" in capsys.readouterr().out
    assert load_shard_checkpoint(tmp) is None
    got = _take(header)
    assert got[0] == want[0]
    assert all(got[1][key] == want[1][key] for key in STATS_KEYS)


def test_sharded_stale_checkpoint_ignored(tmp_path, capsys):
    fasta = _fasta(tmp_path, "t.fa", 91)
    cfg = IndexConfig(kmer_len=5, chunk_windows=64)
    mesh = make_mesh(2, device="cpu")
    want = _take(create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg,
                                            mesh=mesh, verbose=False))
    tmp = fasta + ".05.kin.tmp"
    # a plane of the right shape, saved for another chunk size
    save_shard_checkpoint(tmp, np.full((2, 4**5 // 4), 7, np.uint8), next_step=1,
                          num_kmers=5, meta={"kmer_len": 5, "chunk_windows": 128,
                                             "rows": 2,
                                             "input_size": os.path.getsize(fasta)})
    capsys.readouterr()
    header = create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg, mesh=mesh)
    assert "stale checkpoint ignored" in capsys.readouterr().out
    assert load_shard_checkpoint(tmp) is None
    assert _take(header)[0] == want[0]


def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch, capsys):
    """A checkpoint written by the JAX package's sharded index, cut after its
    second save, resumes in the port to the bytes of an uncut run."""
    fasta = _fasta(tmp_path, "j.fa", 92, lengths=(900, 600, 400))
    cfg = IndexConfig(kmer_len=5, chunk_windows=64)
    want = _take(jax_sharded(fasta, "x", fasta, 5, config=cfg, verbose=False,
                             mesh=jmake_mesh(n_shards=4, n_data=1)))
    _abort_after(monkeypatch, jsharded_mod, 2)
    with pytest.raises(Abort):
        jax_sharded(fasta, "x", fasta, 5, config=cfg, verbose=False,
                    mesh=jmake_mesh(n_shards=4, n_data=1), checkpoint_every=1)
    tmp = fasta + ".05.kin.tmp"
    assert load_shard_checkpoint(tmp)[1]["next_step"] == 2
    capsys.readouterr()
    header = create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg,
                                        mesh=make_mesh(4, device="cpu"))
    assert "resuming from checkpoint at step 2/" in capsys.readouterr().out
    got = _take(header)
    assert got[0] == want[0]
    assert all(got[1][key] == want[1][key] for key in STATS_KEYS)
    assert load_shard_checkpoint(tmp) is None


def test_sharded_overflow_raises_as_jax(tmp_path):
    fasta = str(tmp_path / "aaa.fa")
    with open(fasta, "w") as fh:
        fh.write(">r\n" + "A" * 5000 + "\n")
    cfg = IndexConfig(kmer_len=5, chunk_windows=4096)
    errors = []
    for fn, mesh in ((jax_sharded, jmake_mesh(n_shards=8, n_data=1)),
                     (create_fasta_index_sharded, make_mesh(8, device="cpu"))):
        with pytest.raises(RuntimeError, match="bucket overflow") as exc:
            fn(fasta, "x", fasta, 5, config=cfg, mesh=mesh, capacity_factor=0.1,
               verbose=False)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert not os.path.exists(fasta + ".05.kin")


def test_overflow_before_checkpoint_survives_resume(tmp_path):
    """A checkpoint's bucket high-water mark above the capacity fails the
    resumed run, though no step after it overflows."""
    fasta = _fasta(tmp_path, "o.fa", 93, lengths=(900, 600, 400))
    cfg = IndexConfig(kmer_len=5, chunk_windows=64)
    mesh = make_mesh(2, device="cpu")
    save_shard_checkpoint(fasta + ".05.kin.tmp", np.zeros((2, 4**5 // 4), np.uint8),
                          next_step=1, num_kmers=100, max_bucket=10_000,
                          meta={"kmer_len": 5, "chunk_windows": 64, "rows": 2,
                                "input_size": os.path.getsize(fasta)})
    with pytest.raises(RuntimeError, match=r"shard bucket overflow \(10000 > 64\)"):
        create_fasta_index_sharded(fasta, "x", fasta, 5, config=cfg, mesh=mesh,
                                   verbose=False)


def test_sharded_no_valid_kmers_and_stdin(tmp_path):
    fasta = str(tmp_path / "n.fa")
    with open(fasta, "w") as fh:
        fh.write(">r\nNNNNNNNNNN\n")
    for fn, mesh in ((jax_sharded, jmake_mesh(n_shards=2, n_data=1)),
                     (create_fasta_index_sharded, make_mesh(2, device="cpu"))):
        with pytest.raises(ValueError, match="no valid k-mers"):
            fn(fasta, "x", fasta, 5, mesh=mesh, verbose=False,
               config=IndexConfig(kmer_len=5, chunk_windows=64))
    with pytest.raises(ValueError, match="stdin"):
        create_fasta_index_sharded("-", "x", "-", 5, mesh=make_mesh(2, device="cpu"))


def test_sharded_cuda_without_cards_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fasta = _fasta(tmp_path, "c.fa", 94)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_fasta_index_sharded(fasta, "x", fasta, 5, n_shards=2, verbose=False)
    assert not os.path.exists(fasta + ".05.kin")


# ---- the CLI and the service ------------------------------------------------

def _cli_files(main, argv, files):
    rc = main(argv)
    got = {}
    for f in files:
        if os.path.exists(f):
            with open(f, "rb") as fh:
                got[f] = fh.read()
            os.remove(f)
    return rc, got


@pytest.mark.parametrize("flags", [["--shards", "4"], ["--shards", "2", "--data-parallel", "2"],
                                   ["--data-parallel", "2", "--checkpoint-every", "1"]])
def test_cli_index_sharded_matches_jax(tmp_path, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    fasta = _fasta(tmp_path, "cli.fa", 95)
    kin = fasta + ".05.kin"
    argv = ["index", fasta, "s", "5", "--quiet", "--chunk-windows", "128", *flags]
    rc_j, jax_files = _cli_files(jcli.main, argv, [kin, kin + ".json"])
    rc_t, port_files = _cli_files(tcli.main, argv + ["--device", "cpu"], [kin, kin + ".json"])
    assert rc_j == rc_t == 0 and set(port_files) == {kin, kin + ".json"}
    assert port_files[kin] == jax_files[kin]
    jm, tm = (json.loads(f[kin + ".json"]) for f in (jax_files, port_files))
    assert all(tm[key] == jm[key] for key in STATS_KEYS)


def test_cli_index_sharded_refuses_stdin(capsys):
    assert tcli.main(["index", "-", "s", "5", "--shards", "2", "--device", "cpu"]) == 2
    assert "stdin" in capsys.readouterr().err


@pytest.fixture()
def kins(tmp_path, monkeypatch):
    """Four K=5 indexes in the cwd, by the port's indexer."""
    monkeypatch.chdir(tmp_path)
    paths = []
    for i in range(4):
        fa = _fasta(tmp_path, f"m{i}.fa", 100 + i, lengths=(400 + 60 * i, 200))
        paths.append(create_fasta_index(fa, "s", fa, 5, verbose=False,
                                        device="cpu").index_file_root)
    return paths


def test_cli_merge_sharded_matches_jax(kins):
    out = {}
    for main, extra, proj in ((jcli.main, [], "pj"), (tcli.main, ["--device", "cpu"], "pt")):
        assert main(["merge", proj, *kins, "--shards", "4", "--quiet", *extra]) == 0
        with open(f"{proj}.001-255.kma", "rb") as fh:
            out[proj] = fh.read()
    assert out["pj"] == out["pt"]


def test_merge_sharded_mesh_and_guards(kins):
    """A repeated-device mesh gives the unsharded `.kma`; the host engine is
    refused with --shards in both packages."""
    _, want = port_merge("p1", kins, engine="device", verbose=False, device="cpu")
    _, got = port_merge("p2", kins, verbose=False, device="cpu",
                        mesh=make_mesh(4, device="cpu"))
    assert np.array_equal(got, want)
    with open("p1.001-255.kma", "rb") as a, open("p2.001-255.kma", "rb") as b:
        assert a.read() == b.read()
    errors = []
    for fn, kw in ((jax_merge, {}), (port_merge, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            fn("p3", kins, engine="host", n_shards=2, verbose=False, **kw)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] == "--shards requires the device engine"
    with pytest.raises(ValueError, match="n_shards 2 != the mesh's 4"):
        port_merge("p4", kins, n_shards=2, mesh=make_mesh(4, device="cpu"),
                   verbose=False, device="cpu")


def test_merge_sharded_ragged_blocks_match_jax(kins):
    """Small blocks that do not divide 4^5: the sharded alignment and the
    ragged last block give the JAX package's matrix."""
    _, want = jax_merge("pj", kins, n_shards=4, block_size=100, verbose=False)
    _, got = port_merge("pt", kins, n_shards=4, block_size=100, verbose=False,
                        device="cpu")
    assert np.array_equal(got, want)


def test_serve_merge_with_shards(kins):
    reqs = [{"cmd": "merge", "project": "served", "indexes": kins, "n_shards": 4},
            {"cmd": "merge", "project": "plain", "indexes": kins},
            {"cmd": "shutdown"}]
    out = io.StringIO()
    assert port_serve.serve(io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)),
                            out, device="cpu") == 0
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["ok"] for r in resps] == [True, True, True]
    assert resps[0]["samples"] == 4
    with open("served.001-255.kma", "rb") as a, open("plain.001-255.kma", "rb") as b:
        assert a.read() == b.read()
