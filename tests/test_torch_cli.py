"""The port's CLI subcommands merge, distance, kwip, gzi, testgen and bgzip,
and ``index`` with the multi-host flags in a single process, vs ``python -m
pykmer_tpu`` (JAX) on the same inputs: equal exit codes, equal output files
and equal printed output."""

import gzip
import json
import os

import numpy as np
import pytest

from conftest import make_random_fasta
from reference_runner import VOLATILE_KIN_JSON_KEYS

from pykmer_tpu import cli as jcli
from pykmer_tpu.index import create_fasta_index
from pykmer_tpu_torch import cli as tcli


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _outputs(before):
    """Bytes of every file in the cwd not in ``before``; each is removed."""
    got = {}
    for f in sorted(set(os.listdir(".")) - before):
        got[f] = _read(f)
        os.remove(f)
    return got


def _cli_both(argv, capsys, port_extra=("--device", "cpu")):
    """Run ``argv`` through the JAX CLI, then the port's; returns, for each,
    (exit code, new files' bytes, stdout)."""
    out = []
    for main, extra in ((jcli.main, []), (tcli.main, list(port_extra))):
        before = set(os.listdir("."))
        capsys.readouterr()
        rc = main(argv + extra)
        out.append((rc, _outputs(before), capsys.readouterr().out))
    return out


@pytest.fixture()
def kins(tmp_path, monkeypatch):
    """Three K=5 indexes (one also as .kin.bgz) in the cwd, by the JAX
    package's indexer."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(60)
    paths = []
    for i in range(3):
        fa = make_random_fasta(f"c{i}.fa", rng, n_records=2, lengths=(300 + 50 * i, 150))
        paths.append(create_fasta_index(fa, "s", fa, 5, verbose=False).index_file_root)
    from pykmer_tpu.io.bgzf import compress_file

    compress_file(paths[2], paths[2] + ".bgz")
    return paths


@pytest.mark.parametrize("flags", [
    ["--quiet"],
    ["--engine", "device", "--block-size", "77", "--quiet"],
    ["--engine", "host", "--min-count", "2", "--max-count", "9", "--quiet"],
    ["--engine", "device", "--threads", "1"],
])
def test_cli_merge_matches_jax(kins, capsys, flags):
    (rc_j, files_j, out_j), (rc_t, files_t, out_t) = _cli_both(
        ["merge", "proj", *kins, *flags], capsys)
    assert rc_j == rc_t == 0
    assert files_t == files_j and len(files_t) == 2
    # the port's device engine clamps its block on its padded rows (24 here)
    assert [ln for ln in out_t.splitlines() if "clamping" not in ln] == \
        out_j.splitlines()


def test_cli_merge_bgz_buffer_size_matches_jax(kins, capsys):
    inputs = [kins[0], kins[1], kins[2] + ".bgz"]
    (rc_j, files_j, _), (rc_t, files_t, _) = _cli_both(
        ["merge", "pb", *inputs, "--quiet", "--buffer-size", "4096"], capsys)
    assert rc_j == rc_t == 0 and files_t == files_j


def test_cli_merge_needs_two_and_shards(kins, capsys):
    (rc_j, files_j, out_j), (rc_t, files_t, out_t) = _cli_both(
        ["merge", "p", kins[0]], capsys)
    assert rc_j == rc_t == 1 and files_j == files_t == {}
    assert out_j == out_t == "needs at least 2 files\n"
    (rc_j, files_j, _), (rc_t, files_t, _) = _cli_both(
        ["merge", "p", *kins, "--shards", "2", "--quiet"], capsys)
    assert rc_j == rc_t == 0
    assert files_t == files_j and "p.001-255.kma" in files_t


def test_cli_distance_matches_jax(kins, capsys):
    assert tcli.main(["merge", "proj", *kins, "--quiet", "--device", "cpu"]) == 0
    names = "names.tsv"
    with open(names, "w") as fh:
        for i, k in enumerate(kins):
            fh.write(f"{os.path.basename(k)}\tsample_{i}\n")
    for extra in ([], [names]):
        (rc_j, files_j, out_j), (rc_t, files_t, out_t) = _cli_both(
            ["distance", "proj.001-255.kma", *extra], capsys, port_extra=())
        assert rc_j == rc_t == 0
        assert set(files_t) == set(files_j) and len(files_t) >= 3
        for f in files_j:
            if not f.endswith(".png"):  # the rendered tree's pixels are matplotlib's
                assert files_t[f] == files_j[f], f
        assert out_t == out_j


def _write_dist(path, ids, matrix):
    with open(path, "w") as fh:
        fh.write("\t" + "\t".join(ids) + "\n")
        for i, row_id in enumerate(ids):
            fh.write(row_id + "\t" + "\t".join(f"{v:.6f}" for v in matrix[i]) + "\n")


def test_cli_kwip_matches_jax(kins, capsys):
    assert tcli.main(["merge", "proj", *kins, "--quiet", "--device", "cpu"]) == 0
    ids = [os.path.basename(k)[: -len(".05.kin")] for k in kins]  # the FASTA names
    rng = np.random.default_rng(61)
    m = rng.uniform(0.1, 1.0, size=(3, 3))
    m = (m + m.T) / 2
    np.fill_diagonal(m, 0.0)
    _write_dist("all.dist", [i + ".khmer" for i in ids], m)
    for extra in ([], ["--compare-kma", "proj.001-255.kma"]):
        (rc_j, files_j, out_j), (rc_t, files_t, out_t) = _cli_both(
            ["kwip", "all.dist", *extra], capsys, port_extra=())
        assert rc_j == rc_t == 0
        assert set(files_t) == set(files_j) and len(files_t) >= 6
        for f in files_j:
            if not f.endswith(".png"):
                assert files_t[f] == files_j[f], f
        assert out_t == out_j


def test_cli_gzi_matches_jax(kins, capsys):
    (rc_j, _, out_j), (rc_t, _, out_t) = _cli_both(
        ["gzi", kins[2] + ".bgz.gzi"], capsys, port_extra=())
    assert rc_j == rc_t == 0
    assert out_t == out_j and "number_entries" in out_t


def test_cli_testgen_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    outs = []
    for main in (jcli.main, tcli.main):
        capsys.readouterr()
        assert main(["testgen", "fix/ex-", "3", "5"]) == 0
        got = {}
        for f in sorted(os.listdir("fix")):
            with gzip.open(os.path.join("fix", f), "rb") as fh:
                got[f] = fh.read()  # gzip headers carry the write time
            os.remove(os.path.join("fix", f))
        outs.append((got, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert set(outs[1][0]) == {"ex--03.fasta.gz", "ex--05.fasta.gz"}


@pytest.mark.parametrize("flags", [[], ["--level", "1", "--delete"]])
def test_cli_bgzip_matches_jax(tmp_path, monkeypatch, capsys, flags):
    monkeypatch.chdir(tmp_path)
    data = np.random.default_rng(62).integers(0, 4, size=300_000).astype(np.uint8)
    outs = []
    for main in (jcli.main, tcli.main):
        data.tofile("x.bin")
        capsys.readouterr()
        assert main(["bgzip", "x.bin", *flags]) == 0
        outs.append((_read("x.bin.bgz"), _read("x.bin.bgz.gzi"),
                     os.path.exists("x.bin"), capsys.readouterr().out))
        for f in os.listdir("."):
            os.remove(f)
    assert outs[0] == outs[1]
    assert outs[1][2] == ("--delete" not in flags)


@pytest.mark.parametrize("flags", [
    ["--process-id", "0"],
    ["--num-processes", "1"],
    ["--num-processes", "1", "--process-id", "0", "--bgzip"],
])
def test_cli_index_multihost_flags_in_one_process_match_jax(tmp_path, monkeypatch, capsys,
                                                            flags):
    """``--process-id`` alone builds the ordinary single-host `.kin`;
    ``--num-processes 1`` runs the one-process multi-host path. Either way
    the files are the JAX CLI's (`.kin.json` up to its creation times)."""
    monkeypatch.chdir(tmp_path)
    fa = make_random_fasta("ix.fa", np.random.default_rng(63), n_records=3,
                           lengths=(500, 90, 700))
    (rc_j, files_j, _), (rc_t, files_t, _) = _cli_both(
        ["index", fa, "s", "11", "--quiet", *flags], capsys)
    assert rc_j == rc_t == 0
    assert set(files_t) == set(files_j)
    assert {"ix.fa.11.kin", "ix.fa.11.kin.json"} <= set(files_t)
    assert ("ix.fa.11.kin.bgz" in files_t) == ("--bgzip" in flags)
    for name in files_j:
        if name.endswith(".json"):
            got, want = json.loads(files_t[name]), json.loads(files_j[name])
            assert set(got) == set(want)
            for key in set(want) - VOLATILE_KIN_JSON_KEYS:
                assert got[key] == want[key], key
        else:
            assert files_t[name] == files_j[name], name


def test_cli_index_multihost_refuses_stdin(capsys):
    for main in (jcli.main, tcli.main):
        capsys.readouterr()
        assert main(["index", "-", "s", "5", "--coordinator", "127.0.0.1:1",
                     "--num-processes", "2", "--process-id", "0"]) == 2
        assert "not supported for multi-host jobs" in capsys.readouterr().err
