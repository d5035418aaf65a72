"""The synthetic plant genome, made from the run's seed.

Grown from the repository's ``bench.make_genome`` recipe (a LUT over random
bytes, power-law repeat families, N runs, 80-column FASTA) and kept here, so
that a later change to that script cannot move the benchmark's inputs. It
departs from that recipe where the configuration states the assembly: each
record draws from its own child stream of the seed (the records are made on
a thread pool), the repeats cover a stated share of the bases as copies
that diverge from their motif, and the N content is a stated number of
bases in runs that never touch, so that the valid windows are the same for
every seed. The records are returned as written, for the reference to count.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np

LINE = 80
MOTIFS, MOTIF_LEN = 2000, 5000  # the repeat library: 2000 motifs of 5 kb
MIN_SEGMENT = 1000  # the shortest run of bases between two N runs
BATCH = 512  # repeat copies mutated at once
THREADS = 8
SPEC_KEYS = ("genome_bp", "records", "repeat_cover", "max_divergence", "n_bases",
             "n_runs")

Record = Tuple[str, np.ndarray]  # (header name, ASCII bases as written)


def seed_sequence(seed: int, *path: int) -> np.random.SeedSequence:
    """The seed's stream, or one of its children: any whole number works,
    negative or above 64 bits."""
    return np.random.SeedSequence([seed % (1 << 128), *path])


def spec(config: Dict[str, Any]) -> Dict[str, Any]:
    """The genome's parameters out of a configuration."""
    return {key: config[key] for key in SPEC_KEYS}


def valid_windows(genome_bp: int, records: int, n_bases: int, n_runs: int,
                  kmer_len: int, **_) -> int:
    """The valid windows of any genome of this spec: every run of bases
    between N runs is at least ``MIN_SEGMENT`` long."""
    segments = sum(n_runs + 1 if _share(n_bases, records, c) else 1 for c in range(records))
    return genome_bp - n_bases - (kmer_len - 1) * segments


def _share(total: int, parts: int, i: int) -> int:
    return total // parts + (i < total % parts)


def _partition(rng: np.random.Generator, total: int, parts: int, least: int) -> np.ndarray:
    """``parts`` lengths of at least ``least`` that sum to ``total``."""
    free = total - parts * least
    if free < 0:
        raise ValueError(f"{total} cannot hold {parts} parts of {least}")
    cuts = np.sort(rng.integers(0, free + 1, size=parts - 1))
    return np.diff(np.concatenate([[0], cuts, [free]])) + least


def make_genome(path: str, seed: int, genome_bp: int, records: int,
                repeat_cover: float = 0.0, max_divergence: float = 0.0, n_bases: int = 0,
                n_runs: int = 0) -> List[Record]:
    """Write ``genome_bp`` bases in ``records`` records to ``path`` and
    return the records.

    - ``repeat_cover``: the share of each record covered by copies of a
      library of motifs whose insertion weights follow 1/(i+1) (copies land
      at random and may overlap, so -ln(1 - cover) bases a base are
      inserted). Each copy diverges from its motif by its own rate, drawn
      uniform in [0, ``max_divergence``): each base is redrawn at that rate.
      The head families saturate their cells; old copies add new k-mers.
    - ``n_bases``: bases set to N, in ``n_runs`` runs a record that neither
      touch each other nor a record's end.
    """
    lut = np.tile(np.frombuffer(b"ACGT", dtype=np.uint8), 64)
    lib = weights = None
    if repeat_cover:
        rng = np.random.default_rng(seed_sequence(seed, 0))
        lib = lut[np.frombuffer(rng.bytes(MOTIFS * MOTIF_LEN), dtype=np.uint8)]
        lib = lib.reshape(MOTIFS, MOTIF_LEN)
        weights = 1.0 / np.arange(1, MOTIFS + 1)
        weights /= weights.sum()

    def record(c: int) -> Record:
        rng = np.random.default_rng(seed_sequence(seed, 1, c))
        length = _share(genome_bp, records, c)
        seq = lut[np.frombuffer(rng.bytes(length), dtype=np.uint8)]
        if repeat_cover:
            n_ins = round(-math.log1p(-repeat_cover) * length / MOTIF_LEN)
            which = rng.choice(MOTIFS, size=n_ins, p=weights)
            where = rng.integers(0, length - MOTIF_LEN, size=n_ins)
            # a base is redrawn where its random byte u < rate, as lut[u]:
            # rate is a multiple of 4, so the redrawn base is uniform
            rate = (rng.random(n_ins) * max_divergence * 64).astype(np.uint8) * 4
            for b in range(0, n_ins, BATCH):
                copies = lib[which[b: b + BATCH]]
                if max_divergence:
                    u = np.frombuffer(rng.bytes(copies.size), np.uint8).reshape(copies.shape)
                    redraw = u < rate[b: b + BATCH, None]
                    copies[redraw] = lut[u[redraw]]
                for copy, pos in zip(copies, where[b: b + BATCH]):
                    seq[pos: pos + MOTIF_LEN] = copy
        n_here = _share(n_bases, records, c)
        if n_here:
            segments = _partition(rng, length - n_here, n_runs + 1, MIN_SEGMENT)
            runs = _partition(rng, n_here, n_runs, 1)
            start = 0
            for seg, run in zip(segments, runs):
                start += int(seg)
                seq[start: start + int(run)] = ord("N")
                start += int(run)
        return f"chr{c + 1} synthetic", seq

    with ThreadPoolExecutor(THREADS) as pool:
        out = list(pool.map(record, range(records)))
    write_fasta(path, out)
    return out


def write_fasta(path: str, records: List[Record]) -> None:
    """Records as FASTA with ``LINE``-column rows, the last row of a record
    shorter where its length is not a multiple of ``LINE``."""
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(f">{name}\n".encode())
            full = seq.shape[0] // LINE * LINE
            rows = np.empty((full // LINE, LINE + 1), np.uint8)
            rows[:, :LINE] = seq[:full].reshape(-1, LINE)
            rows[:, LINE] = ord("\n")
            fh.write(rows.tobytes())
            if full < seq.shape[0]:
                fh.write(seq[full:].tobytes() + b"\n")


def genome_bases(records: List[Record]) -> int:
    return sum(int(seq.shape[0]) for _, seq in records)
