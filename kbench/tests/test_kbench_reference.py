"""The plain references against brute force at K=5."""

import numpy as np
import torch

from kbench.reference import index as iref

CPU = torch.device("cpu")


def _brute_counts(records, k):
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    counts = np.zeros(4**k, dtype=np.int64)
    n = 0
    for _, seq in records:
        s = seq.tobytes().decode().upper()
        for i in range(len(s) - k + 1):
            w = s[i: i + k]
            if any(ch not in code for ch in w):
                continue
            fwd = sum(code[ch] * 4 ** (k - 1 - p) for p, ch in enumerate(w))
            rev = sum((3 - code[ch]) * 4**p for p, ch in enumerate(w))
            counts[min(fwd, rev)] += 1
            n += 1
    return counts, n


def _records():
    rng = np.random.default_rng(0)
    seqs = []
    for n in (3000, 4, 2500):
        s = np.frombuffer(b"ACGTacgtN"[:], np.uint8)[rng.integers(0, 9, n)].copy()
        seqs.append(s)
    seqs[2][:1200] = ord("A")  # a long run: its code saturates
    return [("r1", seqs[0]), ("short", seqs[1]), ("r3 x", seqs[2])]


def test_index_reference_matches_brute_force_at_k5():
    records = _records()
    counts, n, chromosomes = iref.count_records(records, 5, CPU)
    want, want_n = _brute_counts(records, 5)
    assert np.array_equal(counts.numpy(), want) and n == want_n
    assert chromosomes == [["r1", 3000], ["r3 x", 2500]]
    plane = iref.saturate(counts)
    assert int(plane.max()) == 255
    assert np.array_equal(plane.numpy(), np.minimum(want, 255).astype(np.uint8))
    stats = iref.stats(plane)
    assert stats["vals_sum"] == int(np.minimum(want, 255).sum())
    assert stats["hist"][254] == int((want >= 255).sum())


def test_bytes_and_fields_wrong(tmp_path):
    plane = torch.arange(64, dtype=torch.uint8)
    path = tmp_path / "x.kin"
    changed = plane.numpy().copy()
    changed[[3, 9]] += 1
    changed.tofile(path)
    assert iref.bytes_wrong(str(path), plane) == 2
    changed[:60].tofile(path)
    assert iref.bytes_wrong(str(path), plane) == 2 + 4
    assert iref.bytes_wrong(str(tmp_path / "missing.kin"), plane) == 64
    assert iref.fields_wrong({"a": 1, "b": 2}, {"a": 1, "b": 3, "c": 0}) == ["b", "c"]
