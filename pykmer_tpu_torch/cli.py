"""Command-line interface of the port.

    python -m pykmer_tpu_torch index <input.fa[.gz]|-> <sample_name> <K>
        [--chunk-windows N] [--no-verify] [--no-overwrite] [--quiet]
        [--device cuda]

The argument names are those of ``pykmer_tpu.cli``. The JAX package's other
subcommands are listed so that they answer "not yet ported" (exit code 2)
instead of an argparse error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from pykmer_tpu.config import IndexConfig

NOT_PORTED = ("index-batch", "read", "merge", "distance", "kwip", "gzi",
              "testgen", "bgzip", "serve")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pykmer_tpu_torch",
        description="k-mer counting on an NVIDIA GPU (PyTorch + CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="build a .kin index from FASTA")
    p.add_argument("input_file",
                   help="FASTA path, or '-' to read stdin (outputs are then "
                        "named {sample_name}.{K:02d}.kin)")
    p.add_argument("sample_name")
    p.add_argument("kmer_len", type=int)
    p.add_argument("--no-overwrite", action="store_true")
    p.add_argument("--chunk-windows", type=int, default=None,
                   help="window starts per device chunk "
                        "(default: 16M on CUDA, 4M on the CPU)")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails when CUDA is "
                        "unavailable — pass cpu explicitly)")

    for name in NOT_PORTED:
        q = sub.add_parser(name, help="not yet ported (see pykmer_tpu)")
        q.add_argument("args", nargs=argparse.REMAINDER)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command != "index":
        print(f"error: '{args.command}' is not yet ported to pykmer_tpu_torch; "
              "use python -m pykmer_tpu", file=sys.stderr)
        return 2
    try:
        cfg = IndexConfig(kmer_len=args.kmer_len, chunk_windows=args.chunk_windows)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    from .index import create_fasta_index

    from_stdin = args.input_file == "-"
    project = args.sample_name if from_stdin else args.input_file
    create_fasta_index(
        project, args.sample_name, args.input_file, args.kmer_len,
        overwrite=not args.no_overwrite, config=cfg,
        verify=not args.no_verify, verbose=not args.quiet, device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
