"""The benchmark's blocked plain reference (``kbench/reference/index_blocked.py``)
against its whole-plane original (``kbench/reference/index.py``) on the CPU:
the same plane, the same `.kin.json` fields and the same count of wrong
cells, whatever the block size, with blocks small enough that every plane
crosses many block edges; and the K=17 deployment it judges."""

import numpy as np
import pytest
import torch

from kbench import genome, harness
from kbench.reference import index as ref
from kbench.reference import index_blocked as bref

CPU = torch.device("cpu")
SPEC = dict(genome_bp=120_001, records=2, repeat_cover=0.65, max_divergence=0.2,
            n_bases=6_000, n_runs=3)
SHA = "0" * 64


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Two seeded genomes with N runs, one of a single record, each with a
    record of lowercase bases whose 1,500-base run of A saturates its cells;
    their paths and records."""
    out = {}
    for name, seed, spec in (("two", 2**33 + 9, SPEC), ("one", 71, dict(SPEC, records=1))):
        path = str(tmp_path_factory.mktemp("g") / f"{name}.fa")
        records = genome.make_genome(path, seed, **spec)
        rng = np.random.default_rng(seed)
        tail = np.frombuffer(b"acgtN", np.uint8)[rng.integers(0, 5, 3_000)].copy()
        tail[1_000:2_500] = ord("A")
        records.append(("run of A", tail))
        genome.write_fasta(path, records)
        out[name] = (path, records)
    return out


def _whole(records, k):
    counts, n_windows, chromosomes = ref.count_records(records, k, CPU)
    plane = ref.saturate(counts)
    return plane, ref.expected_metadata(plane, n_windows, chromosomes, k, SHA)


@pytest.mark.parametrize("which", ["two", "one"])
@pytest.mark.parametrize("kmer_len", [9, 11])
@pytest.mark.parametrize("block_cells", [1 << 12, 30_001, 1 << 17, 1 << 31])
def test_blocks_give_the_whole_planes_answers(genomes, tmp_path, which, kmer_len,
                                               block_cells):
    path, records = genomes[which]
    plane, expected = _whole(records, kmer_len)
    assert int(plane.max()) == 255  # the repeats saturate cells
    codes, chromosomes = bref.count_codes(records, kmer_len, CPU)
    parts = list(bref.blocks(codes, kmer_len, block_cells))
    assert [lo for lo, _ in parts] == list(range(0, 4**kmer_len, block_cells))
    assert torch.equal(torch.cat([p for _, p in parts]), plane)
    assert chromosomes == expected["chromosomes"]
    kin = str(tmp_path / "x.kin")
    plane.numpy().tofile(kin)
    fields, wrong, distinct = bref.judge(records, kmer_len, CPU, SHA, kin_paths=[kin],
                                         block_cells=block_cells)
    assert fields == expected
    assert wrong == [ref.bytes_wrong(kin, plane)] == [0]
    assert distinct == int(torch.count_nonzero(plane))


@pytest.mark.parametrize("block_cells", [1 << 12, 30_001, 1 << 18])
def test_wrong_files_count_as_the_whole_planes_comparison_counts_them(genomes, tmp_path,
                                                                      block_cells):
    _, records = genomes["two"]
    k = 9
    plane, _ = _whole(records, k)
    good = plane.numpy()
    altered = good.copy()
    altered[30_000] ^= 1  # one byte, inside the second block of 30,001 cells
    files = {"altered": altered, "short": good[: 4**k - 5_000],
             "long": np.append(good, np.uint8(0)), "empty": good[:0]}
    paths = []
    for name, data in files.items():
        paths.append(str(tmp_path / f"{name}.kin"))
        data.tofile(paths[-1])
    paths.append(str(tmp_path / "missing.kin"))
    _, wrong, _ = bref.judge(records, k, CPU, SHA, kin_paths=paths, block_cells=block_cells)
    assert wrong == [ref.bytes_wrong(p, plane) for p in paths] == [1, 5_000, 1, 4**k, 4**k]


def test_the_control_plane_is_written_block_by_block(genomes, tmp_path):
    """Counts that wrap at 256 (the control) are written where asked, in
    file order, and their fields are the wrapped plane's."""
    _, records = genomes["two"]
    k = 9
    counts, n_windows, chromosomes = ref.count_records(records, k, CPU)
    wrapped = (counts % 256).to(torch.uint8)
    out = str(tmp_path / "control.kin")
    fields, _, _ = bref.judge(records, k, CPU, SHA, write_path=out, block_cells=5_000,
                              cells=lambda c: c.remainder_(256).to(torch.uint8))
    assert np.array_equal(np.fromfile(out, dtype=np.uint8), wrapped.numpy())
    assert fields == ref.expected_metadata(wrapped, n_windows, chromosomes, k, SHA)
    assert fields != _whole(records, k)[1]


@pytest.mark.parametrize("block_cells", [0, (1 << 31) + 1])
def test_a_block_holds_at_most_2_31_cells(block_cells):
    with pytest.raises(ValueError, match="block"):
        next(bref.blocks(torch.zeros(1, dtype=torch.int64), 3, block_cells))


def test_the_k17_deployment_is_the_k15_genome():
    """plants-k17 keeps plants-k15's genome keys (the same seed gives the
    same bytes), runs nothing cut, and has the 782,468,874 valid 17-mers
    that its file states."""
    k15 = harness.data_file("configs", "plants-k15")
    k17 = harness.data_file("configs", "plants-k17")
    assert genome.spec(k17) == genome.spec(k15)
    assert k17["kmer_len"] == 17 and k17["reduced"] == []
    assert k17["guarantees"] == k15["guarantees"]
    assert genome.valid_windows(kmer_len=17, **genome.spec(k17)) == 782_468_874
    assert any("782,468,874" in a for a in k17["assumed"])
    workload = harness.data_file("workloads", "plants-k17.index")
    assert (workload["config"], workload["job"], workload["readback"], workload["verify"],
            workload["warm_bp"], workload["check_kin_files"]) == \
        ("plants-k17", "index_blocked", "auto", True, 17_000_000, 1)
