"""K=19 at reduced scale on the CPU: the mechanisms of
``scripts/certify_k19_torch.py`` on a small version of its fixture (random
bases, N runs, a motif tiled 300 times), against the numpy oracle:

- the sweep into a 2^22-cell window plane at each window base the script
  picks (bottom, middle, top above 2^32, the motif's saturated cell), with
  ``sorted_codes - base``; at a 2^16-cell window also against the JAX
  package's ``localize_sorted`` followed by its sweep (interpret mode);
- ``index/indexer.accumulate_host`` at K=19, over several chunks, into a
  2^37-cell host plane that holds only the cells written;
- the sharded step at K=19 on 8 logical CPU shards, its planes reduced to
  windows of the 2^34-cell local planes (at local cell 0, and above 2^32);
- the per-shard plan of the full plane, and every part of the script.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import certify_k19_torch as cert  # noqa: E402
from pykmer_tpu_torch.index import indexer  # noqa: E402
from pykmer_tpu_torch.ops import sweep  # noqa: E402

CPU = torch.device("cpu")
JAX_WINDOW = 1 << 16  # the window of the JAX comparison (interpret mode is slow)


@pytest.fixture(scope="module")
def k19():
    seq = cert.build_fixture(np.random.default_rng(cert.FIXTURE_SEED), piece=5000, n_pieces=2)
    codes, folded = cert.oracle_codes(seq)
    uniq, counts = np.unique(folded, return_counts=True)
    return {"seq": seq, "codes": codes, "folded": folded, "sorted": np.sort(folded),
            "uniq": uniq, "counts": counts, "motif": int(uniq[counts.argmax()])}


def test_fixture_spans_the_k19_range(k19):
    assert k19["codes"].max() > 2**37 and k19["folded"].max() < cert.FOLD_SIZE
    assert (k19["uniq"] > 2**32).sum() > k19["uniq"].shape[0] // 2
    assert k19["counts"].max() >= 255  # the motif saturates its cell


def _bases(k19, width=cert.WINDOW_CELLS):
    bases = cert.window_bases(k19["sorted"], k19["motif"], width)
    assert len(bases) == 4 and bases[-1] > 2**32
    return bases


@pytest.mark.parametrize("which", range(4))
def test_window_sweep_at_each_base_matches_the_oracle(k19, which):
    base = _bases(k19)[which]
    plane = torch.zeros(cert.WINDOW_CELLS, dtype=torch.uint8)
    assert sweep.accumulate_sorted(plane, torch.from_numpy(k19["sorted"]) - base) is plane
    got = plane.numpy()
    uniq, counts = k19["uniq"], k19["counts"]
    inside = (uniq >= base) & (uniq < base + cert.WINDOW_CELLS)
    assert inside.any()
    want = np.zeros(cert.WINDOW_CELLS, dtype=np.uint8)
    want[uniq[inside] - base] = np.minimum(counts[inside], 255)
    assert np.array_equal(got, want)
    assert (got.max() == 255) == (base == k19["motif"] // cert.WINDOW_CELLS * cert.WINDOW_CELLS)


def test_window_sweep_part_d(k19):
    bases = cert.part_d_window_sweep(k19["sorted"], CPU)
    assert bases == _bases(k19)


@pytest.mark.parametrize("which", range(4))
def test_window_sweep_matches_jax_localize_and_sweep(k19, which):
    import jax.numpy as jnp

    from pykmer_tpu.ops.pallas_hist import accumulate_sorted_pallas, localize_sorted

    base = _bases(k19, JAX_WINDOW)[which]
    plane = torch.zeros(JAX_WINDOW, dtype=torch.uint8)
    sweep.accumulate_sorted(plane, torch.from_numpy(k19["sorted"]) - base)
    local = localize_sorted(jnp.asarray(k19["sorted"]), base, base + JAX_WINDOW)
    want = accumulate_sorted_pallas(jnp.zeros((JAX_WINDOW // 128, 128), jnp.uint8), local,
                                    tile_rows=JAX_WINDOW // 128, interpret=True)
    assert np.array_equal(plane.numpy(), np.asarray(want).reshape(-1))
    assert plane.numpy().any()


def test_accumulate_host_k19_matches_the_oracle(k19, monkeypatch):
    from pykmer_tpu_torch.host.chunks import chunk_stream, iter_chunks_packed_lazy

    planes = []
    monkeypatch.setattr(indexer, "big_zeros",
                        lambda n: planes.append(cert.sparse_plane(n)) or planes[-1])
    cw = 1 << 12
    padded, n_chunks = chunk_stream(k19["seq"], cert.KMER_LEN, cw)
    assert n_chunks > 4
    plane, nk = indexer.accumulate_host(iter_chunks_packed_lazy(padded, cert.KMER_LEN, cw,
                                                                n_chunks),
                                        cert.KMER_LEN, cw, CPU)
    assert plane.shape == (cert.FOLD_SIZE,) and nk == k19["codes"].shape[0]
    cells = planes[0].cells
    assert sorted(cells) == k19["uniq"].tolist()
    assert [cells[c] for c in k19["uniq"].tolist()] == np.minimum(k19["counts"], 255).tolist()


def test_part_e_says_why_it_replaces_big_zeros(k19, capsys):
    real = indexer.big_zeros
    cert.part_e_accumulate_host(k19["seq"], k19["uniq"], k19["counts"],
                                k19["folded"].shape[0], CPU, cw=1 << 13)
    out = capsys.readouterr().out
    assert "MemAvailable" in out and "holds only the cells written" in out
    assert indexer.big_zeros is real  # restored


def test_sparse_plane_reads_and_writes_only_its_cells():
    plane = cert.sparse_plane(cert.FOLD_SIZE)
    assert plane.shape == (cert.FOLD_SIZE,) and plane.dtype == np.uint8
    idx = np.array([0, 2**32 + 5, cert.FOLD_SIZE - 1])
    assert plane[idx].tolist() == [0, 0, 0]
    plane[idx] = np.array([1, 255, 9], dtype=np.uint8)
    assert plane[idx].tolist() == [1, 255, 9] and plane[np.array([7])].tolist() == [0]
    assert plane.cells == {0: 1, 2**32 + 5: 255, cert.FOLD_SIZE - 1: 9}
    assert torch.from_numpy(plane).shape == (cert.FOLD_SIZE,)
    with pytest.raises(TypeError):
        plane[3] = 1


def test_sharded_step_k19_on_reduced_planes(k19):
    bases = cert.sharded_step_windows(k19["seq"], k19["uniq"], k19["counts"],
                                      k19["folded"].shape[0], CPU, k19["motif"])
    assert bases and all(b > 2**32 for b in bases)


@pytest.mark.parametrize("free,want", [(80 * 10**9, 2), (40 * 10**9, 4), (20 * 10**9, 8),
                                       (12 * 10**9, 16), (8 * 10**9, None)])
def test_shard_plan_of_the_full_plane(free, want):
    rows, fit = cert.shard_plan(free, 1 << 24)
    assert [s for s, _, _ in rows] == [2, 4, 8, 16]
    assert all(local * s == cert.FOLD_SIZE for s, local, _ in rows)
    assert fit == want


def test_every_part_passes_on_cpu(k19, capsys):
    cert.certify(CPU, k19["seq"])
    out = capsys.readouterr().out
    for part in "ABCDE":
        assert f"\n{part}. " in "\n" + out, part
