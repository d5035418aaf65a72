"""Copy of ``pykmer_tpu/formats/__init__.py``, held against it
by ``tests/test_torch_copies.py``."""

from .header import KinHeader, frag_size_autotune, array_stats, stats_from_counts256
from .kin import (
    kin_root_path,
    kin_tmp_path,
    kin_bgz_path,
    metadata_path,
    resolve_kin_path,
    init_sparse_file,
    open_kin_stream,
    iter_kin_blocks,
    write_kin_array,
)
from .kma import kma_path, write_kma, read_kma, write_kma_json
