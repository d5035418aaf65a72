"""Command-line interface of the port.

    python -m pykmer_tpu_torch index <input.fa[.gz]|-> <sample_name> <K>
        [--chunk-windows N] [--accumulate auto|device|host] [--bgzip]
        [--no-verify] [--no-overwrite] [--quiet] [--device cuda]
    python -m pykmer_tpu_torch index-batch <K> <a.fa> <b.fa> ...
        [--overwrite] [--chunk-windows N] [--accumulate auto|device|host]
        [--bgzip] [--no-verify] [--quiet] [--device cuda]
    python -m pykmer_tpu_torch read <input> <K> [--debug]

The argument names and exit codes are those of ``pykmer_tpu.cli``. Its
multi-device flags of ``index`` and its other subcommands are accepted so
that they answer "not yet ported" (exit code 2) instead of an argparse error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from pykmer_tpu.config import IndexConfig

NOT_PORTED = ("merge", "distance", "kwip", "gzi", "testgen", "bgzip", "serve")
DEVICE_HELP = ("torch device (default cuda; fails when CUDA is unavailable — "
               "pass cpu explicitly)")


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
    p.add_argument("--accumulate", choices=["auto", "device", "host"],
                   default="auto",
                   help="where the count plane lives (auto: on the device "
                        "when it fits)")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--bgzip", action="store_true",
                   help="also produce .kin.bgz + .gzi")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    # multi-device and multi-host runs: not yet ported
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)

    p = sub.add_parser("index-batch", help="index many FASTAs in one process")
    p.add_argument("kmer_len", type=int)
    p.add_argument("inputs", nargs="+", help="FASTA files (.fa[.gz|.bgz])")
    p.add_argument("--overwrite", action="store_true",
                   help="re-index files whose .kin already exists "
                        "(default: skip them — resumable batch)")
    p.add_argument("--chunk-windows", type=int, default=None)
    p.add_argument("--accumulate", choices=["auto", "device", "host"],
                   default="auto")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--bgzip", action="store_true",
                   help="also produce .kin.bgz + .gzi per file")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)

    p = sub.add_parser("read", help="verify and dump a .kin index")
    p.add_argument("input_file")
    p.add_argument("kmer_len", type=int)
    p.add_argument("--debug", action="store_true")

    for name in NOT_PORTED:
        q = sub.add_parser(name, help="not yet ported (see pykmer_tpu)")
        q.add_argument("args", nargs=argparse.REMAINDER)
    return parser


def _not_ported(what: str) -> int:
    print(f"error: {what} is not yet ported to pykmer_tpu_torch; "
          "use python -m pykmer_tpu", file=sys.stderr)
    return 2


def _config(args) -> IndexConfig:
    return IndexConfig(kmer_len=args.kmer_len, chunk_windows=args.chunk_windows,
                       accumulate=args.accumulate)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "index":
        if args.coordinator or args.num_processes:
            return _not_ported("multi-host index (--coordinator/--num-processes)")
        if args.shards or args.data_parallel > 1 or args.checkpoint_every:
            return _not_ported("sharded index "
                               "(--shards/--data-parallel/--checkpoint-every)")
        try:
            cfg = _config(args)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        from .index import create_fasta_index

        from_stdin = args.input_file == "-"
        project = args.sample_name if from_stdin else args.input_file
        header = create_fasta_index(
            project, args.sample_name, args.input_file, args.kmer_len,
            overwrite=not args.no_overwrite, config=cfg,
            verify=not args.no_verify, verbose=not args.quiet, device=args.device,
        )
        if args.bgzip:
            from pykmer_tpu.io.bgzf import bgzip_kin

            bgz, gzi = bgzip_kin(header.index_file_root)
            if not args.quiet:
                print(f"wrote {bgz} + {gzi}")
        return 0

    if args.command == "index-batch":
        try:
            cfg = _config(args)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        from .index import index_batch

        result = index_batch(
            args.inputs, args.kmer_len, config=cfg,
            overwrite=args.overwrite, bgzip=args.bgzip,
            verify=not args.no_verify, verbose=not args.quiet, device=args.device,
        )
        return 1 if result.failed else 0

    if args.command == "read":
        from .index import read_fasta_index

        read_fasta_index(args.input_file, input_file=args.input_file,
                         kmer_len=args.kmer_len, debug=args.debug)
        return 0

    return _not_ported(f"'{args.command}'")


if __name__ == "__main__":
    sys.exit(main())
