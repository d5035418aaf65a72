"""Copy of ``pykmer_tpu/io/__init__.py``, held against it
by ``tests/test_torch_copies.py``."""

from .fasta import (
    BASE_LUT,
    INVALID,
    FastaRecord,
    decode_fasta_bytes,
    read_fasta_codes,
    open_input_bytes,
)
