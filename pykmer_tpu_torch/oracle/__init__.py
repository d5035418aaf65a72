"""Copy of ``pykmer_tpu/oracle/__init__.py``, held against it
by ``tests/test_torch_copies.py``."""

from .gold import (
    oracle_canonical_codes,
    oracle_count_stream,
    oracle_index_arrays,
    oracle_write_index,
    oracle_pair_counts,
)
