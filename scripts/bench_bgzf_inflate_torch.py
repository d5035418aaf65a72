#!/usr/bin/env python3
"""Times of the BGZF streaming input: the card's inflate beside the host's
zlib pool at each pool size.

Makes the ``plants-k15`` genome (``kbench/genome.py``, 840 Mbp at the
default) from a seed, compresses it as bgzip does (65,280-byte payloads,
zlib level 6, with ``kbench/jobs/index_bgzf.bgzip``), then times:

- the pool, at each size: ``host/segments.BgzfInput`` of the walked file
  without a card, into a pooled host block, from its start to the last block
  in place, beside the whole-file inflate the route took before the BGZF
  source (``io/native.gzip_decompress_native`` on 2 threads);
- on a card, the kernel alone (``ops/inflate.inflate_bgzf`` over every block
  of the file at once, the compressed file already on the card; CUDA events,
  its output checked against the pool's), and with its copies: the
  ``BgzfInput`` of the card route, whose runs ramp from ``INFLATE_EXTENT`` to
  an eighth of the file, each copied in, inflated and copied out into the
  page-locked buffer;
- on a card, the index: ``create_fasta_index`` of the ``.fa.gz`` at K=15
  (readback auto, verify on), which takes the card's inflate.

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


def card_inflate(src, want, card, reps):
    """The kernel alone over every block of ``src``, the compressed file
    already on ``card``: its median time by CUDA events, checked against
    ``want``, the pool's bytes."""
    import numpy as np
    import torch

    from pykmer_tpu_torch.ops import inflate

    n = src.data.shape[0]
    comp = torch.zeros(-(-n // 4) * 4, dtype=torch.uint8, device=card)
    comp[:n].copy_(torch.from_numpy(src.data))
    c_offs, u_offs = torch.from_numpy(src.c_offs).to(card), torch.from_numpy(src.u_offs).to(card)
    out = torch.empty(src.size, dtype=torch.uint8, device=card)
    status = torch.empty(src.c_offs.shape[0] - 1, dtype=torch.int32, device=card)
    inflate.inflate_bgzf(comp, c_offs, u_offs, out, status)  # the build
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        status.fill_(-1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        inflate.inflate_bgzf(comp, c_offs, u_offs, out, status)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    bad = int((status != 0).sum())
    same = bool(np.array_equal(out.cpu().numpy(), want))
    t = sorted(times)[len(times) // 2]
    print(f"card inflate, kernel alone: {t * 1e3:.3f} ms ({src.size / t / 1e9:.2f} GB/s "
          f"inflated, {n / t / 1e9:.2f} GB/s compressed) {times}; bad blocks {bad}, "
          f"equal to the pool's {same}", flush=True)
    if bad or not same:
        raise SystemExit("the card's inflate differs from the pool's")
    return {"card_kernel_s": t, "card_kernel_times_s": times}


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

        def inflate(device=None, keep=False):
            stream = segments.BgzfInput(src, card=device)
            try:
                stream.wait_until(stream.size)
                return stream.buf.copy() if keep else None
            finally:
                stream.release()

        index_cfg = IndexConfig(kmer_len=15, readback="auto")

        def index():
            h = create_fasta_index(gz, "s", gz, 15, config=index_cfg, verbose=False,
                                   device=card)
            os.remove(h.index_file_root)
            os.remove(h.metadata_file)

        pools = [int(x) for x in args.threads.split(",")]
        out["inflate_s"] = {}
        real = segments.inflate_threads
        try:
            for n in pools:
                segments.inflate_threads = lambda n=n: n
                t, times = median_s(inflate, args.reps)
                out["inflate_s"][n] = t
                print(f"pool inflate, {n} threads: {t:.4f} s ({src.size / t / 1e9:.3f} GB/s) "
                      f"{times}", flush=True)
        finally:
            segments.inflate_threads = real
        if card is not None:
            want = inflate(keep=True)
            out.update(card_inflate(src, want, card, args.reps))
            inflate(card)  # the buffers
            t, times = median_s(lambda: inflate(card), args.reps)
            out["card_inflate_with_copies_s"] = t
            print(f"card inflate with its copies: {t:.4f} s ({src.size / t / 1e9:.3f} GB/s) "
                  f"{times}", flush=True)
            del src, want
            index()  # the kernels' build and the buffers
            t, times = median_s(index, args.reps)
            out["index_s"] = t
            print(f"index at K=15, card inflate: {t:.4f} s "
                  f"({args.bp / t / 1e6:.2f} M bp/s) {times}", flush=True)
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
