"""GZI index inspection (reference gzireader.py parity).

Copy of ``pykmer_tpu/io/gzi.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import os

from .bgzf import read_gzi


def print_index(index_file: str) -> None:
    """Dump a `.gzi` (reference gzireader.py:21-37 output shape)."""
    tgtfile = index_file[:-4]
    filesize = os.path.getsize(tgtfile) if os.path.exists(tgtfile) else -1
    entries = read_gzi(index_file)

    print(f"number_entries: {len(entries):15,d}")
    print(f"filesize      : {filesize:15,d}")
    for pos, (cofs, uofs) in enumerate(entries):
        print(
            f"pos: {pos:15,d} compressed_offset {cofs:15,d} "
            f"uncompressed_offset {uofs:15,d}"
        )
    print(f"number_entries: {len(entries):15,d}")
    print(f"filesize      : {filesize:15,d}")


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    print_index(argv[0])


if __name__ == "__main__":
    main()
