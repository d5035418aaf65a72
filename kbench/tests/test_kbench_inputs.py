"""The genome generator repeats at a seed, differs across seeds, and gives
every seed the valid windows of its spec."""

import numpy as np
import pytest
import torch

from kbench import genome, harness


SPEC = dict(genome_bp=400_003, records=3, repeat_cover=0.65, max_divergence=0.2,
            n_bases=30_000, n_runs=5)


def test_genome_repeats_at_a_seed(tmp_path):
    a = genome.make_genome(str(tmp_path / "a.fa"), 2**31 + 5, **SPEC)
    b = genome.make_genome(str(tmp_path / "b.fa"), 2**31 + 5, **SPEC)
    c = genome.make_genome(str(tmp_path / "c.fa"), 7, **SPEC)
    assert (tmp_path / "a.fa").read_bytes() == (tmp_path / "b.fa").read_bytes()
    assert (tmp_path / "a.fa").read_bytes() != (tmp_path / "c.fa").read_bytes()
    assert [n for n, _ in a] == ["chr1 synthetic", "chr2 synthetic", "chr3 synthetic"]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert genome.genome_bases(a) == genome.genome_bases(c) == 400_003


@pytest.mark.parametrize("seed", [1, 2**40 + 3])
@pytest.mark.parametrize("kmer_len", [5, 15])
def test_every_seed_gives_the_valid_windows_of_the_spec(tmp_path, seed, kmer_len):
    from kbench.reference import index as ref

    records = genome.make_genome(str(tmp_path / "g.fa"), seed, **SPEC)
    assert sum(int((seq == ord("N")).sum()) for _, seq in records) == SPEC["n_bases"]
    _, n_windows, _ = ref.count_records(records, kmer_len, torch.device("cpu"))
    assert n_windows == genome.valid_windows(kmer_len=kmer_len, **SPEC)


def test_the_genome_config_holds_the_sources_kmer_count():
    """The tomato's 782,469,030 k-mers at K=15 (sauloal/pykmer README)."""
    spec = genome.spec(harness.data_file("configs", "plants-k15"))
    assert genome.valid_windows(kmer_len=15, **spec) == 782_469_030


def test_repeat_copies_diverge_and_saturate(tmp_path):
    from kbench.reference import index as ref

    spec = dict(SPEC, genome_bp=4_000_000, records=1, n_bases=0)
    records = genome.make_genome(str(tmp_path / "g.fa"), 9, **spec)
    counts, _, _ = ref.count_records(records, 11, torch.device("cpu"))
    exact = genome.make_genome(str(tmp_path / "e.fa"), 9, **dict(spec, max_divergence=0.0))
    exact_counts, _, _ = ref.count_records(exact, 11, torch.device("cpu"))
    # random 11-mers of 4 Mbp land ~1 a cell; the head families reach far
    # higher, and their diverged copies add cells that exact copies lack
    assert int((counts > 20).sum()) > 1000
    assert int((counts > 0).sum()) > int((exact_counts > 0).sum())


def test_genome_file_holds_the_records(tmp_path):
    recs = genome.make_genome(str(tmp_path / "g.fa"), 3, 20_030, 2)
    lines = (tmp_path / "g.fa").read_bytes().split(b"\n")
    assert lines[0] == b">chr1 synthetic"
    rows = -(-len(recs[0][1]) // genome.LINE)
    assert b"".join(lines[1: 1 + rows]) == recs[0][1].tobytes()
    assert lines[1 + rows] == b">chr2 synthetic"
    assert set(b"".join(lines[1: 1 + rows])) <= set(b"ACGT")
    assert len(recs[0][1]) % genome.LINE != 0
