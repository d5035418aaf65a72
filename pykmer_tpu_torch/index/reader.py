"""Index reading and verification: port of ``pykmer_tpu/index/reader.py``.

Host-only: the `.kin` metadata and a re-derivation of its stats from the
file, through the port's copy of ``formats``.
"""

from __future__ import annotations

from typing import Optional

from ..formats import kin as kinfmt
from ..formats.header import KinHeader


def read_fasta_index(
    project_name: str,
    input_file: Optional[str] = None,
    kmer_len: Optional[int] = None,
    index_file: Optional[str] = None,
    debug: bool = False,
    verbose: bool = True,
) -> KinHeader:
    """Load a `.kin` index's metadata, verify the stored stats against the
    file (raises ``ValueError`` on a mismatch), and optionally dump the bytes
    at K <= 5."""
    header = KinHeader(
        project_name, input_file=input_file, kmer_len=kmer_len, index_file=index_file
    )
    if index_file is None:
        header.read_metadata()
    if verbose:
        print(header)
        print(
            f"project_name {header.project_name} kmer_len {header.kmer_len:15,d} "
            f"num_kmers {header.num_kmers:15,d} kmer_size {header.kmer_size:15,d}"
        )
    header.check_data()
    if verbose:
        print("OK")
    if debug and header.kmer_len <= 5:
        arr = kinfmt.read_kin_array(header.input_file_path, header.kmer_len)
        print(" ".join(str(int(v)) for v in arr))
    return header
