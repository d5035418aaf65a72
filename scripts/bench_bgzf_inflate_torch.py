#!/usr/bin/env python3
"""Times of the BGZF streaming input against the size of its inflate pool.

Makes the ``plants-k15`` genome (``kbench/genome.py``, 840 Mbp at the
default) from a seed, compresses it as bgzip does (65,280-byte payloads,
zlib level 6, with ``kbench/jobs/index_bgzf.bgzip``), then, for each pool
size:

- the inflate alone: ``host/segments.BgzfInput`` of the walked file into the
  page-locked buffer (or a pooled host block without a card), from its start
  to the last block in place, beside the whole-file inflate the route took
  before the BGZF source (``io/native.gzip_decompress_native`` on 2
  threads);
- on a card, the index: ``create_fasta_index`` of the ``.fa.gz`` at K=15
  (readback auto, verify on), its pool size set by replacing
  ``host/segments.inflate_threads``.

    python3 scripts/bench_bgzf_inflate_torch.py [--bp N] [--threads 1,2,4,6,8]
        [--reps 3] [--dir build/bgzf_bench]

Host times are medians of ``--reps`` by the host clock. Prints the card's
name and power limit first, one line a measurement, and a JSON object of
every number last. The directory is removed at the end.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_s(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def main() -> int:
    import torch

    from kbench import genome, harness
    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.config import IndexConfig
    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.io import native

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bp", type=int, default=840_000_000)
    parser.add_argument("--threads", default="1,2,4,6,8")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=2147483647 + 23)
    parser.add_argument("--dir", default=os.path.join(ROOT, "build", "bgzf_bench"))
    args = parser.parse_args()
    card = torch.device("cuda") if torch.cuda.is_available() else None
    if card is not None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    out = {"cpus": len(os.sched_getaffinity(0)), "default_threads": segments.inflate_threads()}
    shutil.rmtree(args.dir, ignore_errors=True)
    os.makedirs(args.dir)
    try:
        cfg = harness.data_file("configs", "plants-k15-bgzf")
        spec = dict(genome.spec(cfg), genome_bp=args.bp,
                    n_bases=cfg["n_bases"] * args.bp // cfg["genome_bp"])
        fasta = os.path.join(args.dir, "g.fa")
        t0 = time.perf_counter()
        genome.make_genome(fasta, args.seed, **spec)
        with open(fasta, "rb") as fh:
            data = fh.read()
        t1 = time.perf_counter()
        gz = fasta + ".gz"
        job = harness.code_file("jobs", "index_bgzf")
        blocks = job.bgzip(data, gz, cfg["input"]["block_payload"], cfg["input"]["level"])
        out.update(genome_s=t1 - t0, bgzip_s=time.perf_counter() - t1, inflated=len(data),
                   compressed=os.path.getsize(gz), blocks=blocks,
                   ratio=len(data) / os.path.getsize(gz))
        del data
        os.remove(fasta)
        print(json.dumps({k: out[k] for k in ("bgzip_s", "compressed", "blocks", "ratio")}),
              flush=True)

        t, times = median_s(lambda: native.gzip_decompress_native(gz, threads=2), args.reps)
        out["whole_file_inflate_2_threads_s"] = t
        print(f"whole-file inflate on 2 threads {t:.4f} s {times}", flush=True)
        src = segments.read_bgzf(gz)
        t, _ = median_s(lambda: segments.read_bgzf(gz), args.reps)
        out["read_and_walk_s"] = t
        print(f"read + walk {t:.4f} s", flush=True)

        def inflate():
            stream = segments.BgzfInput(src, card=card)
            try:
                stream.wait_until(stream.size)
            finally:
                stream.release()

        index_cfg = IndexConfig(kmer_len=15, readback="auto")

        def index():
            h = create_fasta_index(gz, "s", gz, 15, config=index_cfg, verbose=False,
                                   device=card)
            os.remove(h.index_file_root)
            os.remove(h.metadata_file)

        pools = [int(x) for x in args.threads.split(",")]
        out["inflate_s"], out["index_s"] = {}, {}
        real = segments.inflate_threads
        try:
            for n in pools:
                segments.inflate_threads = lambda n=n: n
                t, times = median_s(inflate, args.reps)
                out["inflate_s"][n] = t
                print(f"inflate, {n} threads: {t:.4f} s ({src.size / t / 1e9:.3f} GB/s) "
                      f"{times}", flush=True)
            del src
            if card is not None:
                index()  # the kernels' build and the buffers
                for n in pools:
                    segments.inflate_threads = lambda n=n: n
                    t, times = median_s(index, args.reps)
                    out["index_s"][n] = t
                    print(f"index at K=15, {n} threads: {t:.4f} s "
                          f"({args.bp / t / 1e6:.2f} M bp/s) {times}", flush=True)
        finally:
            segments.inflate_threads = real
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
