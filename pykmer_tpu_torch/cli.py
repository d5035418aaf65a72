"""Command-line interface of the port.

    python -m pykmer_tpu_torch index <input.fa[.gz]|-> <sample_name> <K>
        [--chunk-windows N] [--accumulate auto|device|host] [--bgzip]
        [--no-verify] [--no-overwrite] [--quiet] [--device cuda]
        [--shards S] [--data-parallel R] [--checkpoint-every N]
        [--coordinator HOST:PORT --num-processes N --process-id I]
    python -m pykmer_tpu_torch index-batch <K> <a.fa> <b.fa> ...
        [--overwrite] [--chunk-windows N] [--accumulate auto|device|host]
        [--bgzip] [--no-verify] [--quiet] [--device cuda]
    python -m pykmer_tpu_torch read <input> <K> [--debug]
    python -m pykmer_tpu_torch merge <Project> <a.kin> <b.kin> ...
        [--min-count N] [--max-count N] [--buffer-size B] [--block-size N]
        [--threads N] [--engine auto|host|device] [--quiet] [--device cuda]
        [--shards S]
    python -m pykmer_tpu_torch distance <matrix.kma> [names.tsv]
    python -m pykmer_tpu_torch kwip <all.dist> [names.tsv] [--compare-kma X.kma]
    python -m pykmer_tpu_torch gzi <file.gzi>
    python -m pykmer_tpu_torch testgen [prefix] [K ...]
    python -m pykmer_tpu_torch bgzip <file> [--level N] [--delete]
    python -m pykmer_tpu_torch serve [--warmup-k K] [--device cuda]

The argument names and exit codes are those of ``pykmer_tpu.cli``.
``distance``, ``kwip``, ``gzi``, ``testgen`` and ``bgzip`` run the JAX
package's JAX-free functions. ``index --shards/--data-parallel/
--checkpoint-every`` runs the sharded index on a mesh of ``--device``'s
type (on CUDA it needs S·R visible cards), and ``merge --shards`` the
sharded compare. ``index --coordinator/--num-processes`` runs one process of
a multi-host build (a gloo ``torch.distributed`` job; run the same command
on every process with its own ``--process-id``): process 0 writes the `.kin`
and every other process exits 0 once its share is written. ``--process-id``
alone builds the ordinary single-host `.kin`, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .config import (
    DEFAULT_BLOCK_SIZE,
    DEFAULT_MAX_COUNT,
    DEFAULT_MIN_COUNT,
    DEFAULT_THREADS,
    IndexConfig,
)

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
    p.add_argument("--shards", type=int, default=None,
                   help="count-space shards (default: the devices per data row)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="data-parallel rows of the mesh")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="checkpoint the sharded state every N steps")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the multi-host job's process 0 (gloo) — "
                        "run this same command on every process of the job")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count of the multi-host job")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index in the multi-host job")

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

    p = sub.add_parser("merge", help="merge kmer databases into a .kma matrix")
    p.add_argument("Project_Name")
    p.add_argument("Kmers", nargs="+", help="list of .kin[.bgz] files")
    p.add_argument("--min-count", type=int, default=DEFAULT_MIN_COUNT)
    p.add_argument("--max-count", type=int, default=DEFAULT_MAX_COUNT)
    p.add_argument("--buffer-size", type=int, default=None,
                   help="raw-file buffer for gzip-wrapped .bgz streams (raw "
                        ".kin inputs use O_DIRECT block reads)")
    p.add_argument("--block-size", type=int, default=DEFAULT_BLOCK_SIZE)
    p.add_argument("--threads", type=int, default=DEFAULT_THREADS)
    p.add_argument("--engine", choices=("auto", "host", "device"),
                   default="auto",
                   help="auto: host popcount engine for small N, the device "
                        "engine at fan-in scale")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p.add_argument("--shards", type=int, default=None,
                   help="shard the device engine's compare over this many devices")

    p = sub.add_parser("distance", help="Jaccard distances + NJ tree from .kma")
    p.add_argument("matrix_file")
    p.add_argument("names_file", nargs="?", default=None)

    p = sub.add_parser("kwip", help="cluster a kWIP .dist matrix; optionally "
                                    "cross-validate vs a .kma")
    p.add_argument("dist_file")
    p.add_argument("names_file", nargs="?", default=None)
    p.add_argument("--compare-kma", default=None,
                   help="also report distance/topology agreement vs this "
                        ".kma matrix")

    p = sub.add_parser("gzi", help="dump a .gzi random-access index")
    p.add_argument("index_file")

    p = sub.add_parser("testgen", help="write 4^K enumeration fixtures")
    p.add_argument("prefix", nargs="?", default="examples/example-")
    p.add_argument("kmer_lens", nargs="*", type=int)

    p = sub.add_parser("bgzip", help="BGZF-compress a file (+ .gzi index)")
    p.add_argument("file")
    p.add_argument("--level", type=int, default=6)
    p.add_argument("--delete", action="store_true", help="remove the source")

    p = sub.add_parser("serve", help="long-lived JSON-lines service "
                                     "(stdin->stdout): index/merge/distance")
    p.add_argument("--warmup-k", type=int, default=None,
                   help="pay the first-use costs of an index at this K "
                        "before accepting commands")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    return parser


def _config(args) -> IndexConfig:
    return IndexConfig(kmer_len=args.kmer_len, chunk_windows=args.chunk_windows,
                       accumulate=args.accumulate)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "index":
        try:
            cfg = _config(args)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        from_stdin = args.input_file == "-"
        if args.coordinator or args.num_processes:
            if from_stdin:
                print("error: stdin input ('-') is not supported for "
                      "multi-host jobs", file=sys.stderr)
                return 2
            from .index import create_fasta_index_multihost

            header = create_fasta_index_multihost(
                args.input_file, args.sample_name, args.input_file,
                args.kmer_len, overwrite=not args.no_overwrite, config=cfg,
                n_shards_local=args.shards, n_data_local=args.data_parallel,
                coordinator_address=args.coordinator,
                num_processes=args.num_processes, process_id=args.process_id,
                checkpoint_every=args.checkpoint_every,
                verify=not args.no_verify, verbose=not args.quiet, device=args.device,
                bgzip=args.bgzip,
            )
            if header is None:  # a non-zero process of the job
                return 0
        elif args.shards or args.data_parallel > 1 or args.checkpoint_every:
            if from_stdin:
                print("error: stdin input ('-') is not supported with "
                      "--shards/--data-parallel/--checkpoint-every",
                      file=sys.stderr)
                return 2
            from .index import create_fasta_index_sharded

            header = create_fasta_index_sharded(
                args.input_file, args.sample_name, args.input_file,
                args.kmer_len, overwrite=not args.no_overwrite, config=cfg,
                n_shards=args.shards, n_data=args.data_parallel,
                checkpoint_every=args.checkpoint_every,
                verify=not args.no_verify, verbose=not args.quiet, device=args.device,
                bgzip=args.bgzip,
            )
        else:
            from .index import create_fasta_index

            project = args.sample_name if from_stdin else args.input_file
            header = create_fasta_index(
                project, args.sample_name, args.input_file, args.kmer_len,
                overwrite=not args.no_overwrite, config=cfg,
                verify=not args.no_verify, verbose=not args.quiet, device=args.device,
                bgzip=args.bgzip,
            )
        if args.bgzip and not args.quiet:
            bgz = header.index_file_root + ".bgz"
            print(f"wrote {bgz} + {bgz}.gzi")
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

    if args.command == "merge":
        if len(args.Kmers) <= 1:
            print("needs at least 2 files")
            return 1
        from .merge import merge

        merge(
            args.Project_Name, sorted(args.Kmers),
            min_count=args.min_count, max_count=args.max_count,
            block_size=args.block_size, threads=args.threads,
            buffer_size=args.buffer_size, n_shards=args.shards, engine=args.engine,
            verbose=not args.quiet, device=args.device,
        )
        return 0

    if args.command == "distance":
        from .analysis.distance import load

        load(args.matrix_file, names_file=args.names_file)
        return 0

    if args.command == "kwip":
        from .analysis.kwip import compare_with_kma, load_kwip

        load_kwip(args.dist_file, names_file=args.names_file)
        if args.compare_kma:
            rep = compare_with_kma(args.dist_file, args.compare_kma)
            print(f"samples matched     : {rep['n_samples']}")
            print(f"pearson (condensed) : {rep['pearson']:.4f}")
            print(f"spearman (condensed): {rep['spearman']:.4f}")
            print(f"nearest-neighbour agreement: {rep['nn_agreement']:.2%}")
        return 0

    if args.command == "serve":
        from .serve import serve, warmup

        if args.warmup_k is not None:
            warmup(args.warmup_k, args.device)
        return serve(device=args.device)

    if args.command == "gzi":
        from .io.gzi import print_index

        print_index(args.index_file)
        return 0

    if args.command == "testgen":
        from . import testgen

        os.makedirs(os.path.dirname(args.prefix) or ".", exist_ok=True)
        for k in args.kmer_lens or [3, 5, 7, 9, 11, 13, 15, 17, 19, 21]:
            print(k)
            testgen.create_test_fasta(args.prefix, k)
        return 0

    if args.command == "bgzip":
        from .io.bgzf import compress_file

        bgz, gzi = compress_file(args.file, level=args.level)
        if args.delete:
            os.remove(args.file)
        print(f"wrote {bgz} + {gzi}")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
