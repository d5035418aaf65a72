"""File checksumming (sha256, chunked) — reference tools.py:548-556 semantics.

Copy of ``pykmer_tpu/utils/checksum.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import hashlib


def sha256_file(path: str, chunk_size: int = 2**16) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()
