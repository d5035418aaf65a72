"""Test-fixture generation: complete-enumeration FASTA files.

Writes ``{seq_name}-{K:02d}.fasta.gz`` containing every one of the 4^K k-mers
as its own record (reference test.py:8-33). Oracle property for odd K: no
k-mer equals its own reverse complement, so the correct `.kin` has every
canonical cell == 2 and every non-canonical cell == 0; ``num_kmers == 4^K``
and ``vals_count == 4^K / 2``.

Copy of ``pykmer_tpu/testgen.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator

ALPHABET = "ACGT"


def enumerate_kmers(kmer_len: int) -> Iterator[str]:
    """All 4^K k-mer strings in lexicographic order."""
    if kmer_len == 0:
        yield ""
        return
    for head in ALPHABET:
        for tail in enumerate_kmers(kmer_len - 1):
            yield head + tail


def create_test_fasta(seq_name: str, kmer_len: int) -> str:
    """Write the enumeration fixture (skipped if it already exists)."""
    fasta_file = f"{seq_name}-{kmer_len:02d}.fasta.gz"
    if os.path.exists(fasta_file):
        return fasta_file
    with gzip.open(fasta_file, "wt") as fh:
        for num, seq in enumerate(enumerate_kmers(kmer_len)):
            fh.write(f">{seq_name}-{kmer_len:02d}-{num + 1:010d}\n{seq}\n")
    return fasta_file


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    out_prefix = argv[0] if argv else "examples/example-"
    kmer_lens = [int(a) for a in argv[1:]] or [3, 5, 7, 9, 11, 13, 15, 17, 19, 21]
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    for kmer_len in kmer_lens:
        print(kmer_len)
        create_test_fasta(out_prefix, kmer_len)


if __name__ == "__main__":
    main()
