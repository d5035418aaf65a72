#!/usr/bin/env python3
"""Times of the bgzip output's deflate: the card's kernels beside the host's
zlib pool, on the `.kin` of the ``plants-k15`` genome.

Makes the genome (``kbench/genome.py``, 840 Mbp at the default) from a
seed, indexes it at K=15 on the card (no bgzip), then, on the 1 GiB `.kin`:

- the card: ``ops/deflate.deflate_bgzf`` over the file in runs of
  ``index/bgzip.CARD_RUN_BLOCKS`` blocks, the file already on the card
  (CUDA events over all runs; the best of ``--reps``), each kernel's share
  from ``torch.profiler``, and a sample of blocks checked against the
  standard library's zlib member by member;
- the host: the native codec over an eighth of the file on one thread a core
  (what the host pool runs), scaled to the file;
- ``index/bgzip.write_bgzip`` on the card, the file read back (the sharded
  and multi-host route), end to end.

    python3 scripts/bench_deflate_torch.py [--bp N] [--reps 3] [--check 256]
        [--dir build/deflate_bench]

Prints the card's name and power limit first, one line a measurement, and a
JSON object of every number last. The directory is removed at the end.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_name() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    import numpy as np
    import torch

    from kbench import genome
    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.index import bgzip
    from pykmer_tpu_torch.io import native
    from pykmer_tpu_torch.ops import deflate

    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=840_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", type=int, default=256)
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "deflate_bench"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = torch.device("cuda")
    print(f"card: {card_name()}", flush=True)
    os.makedirs(args.dir, exist_ok=True)
    result = {"card": card_name(), "bp": args.bp}
    try:
        fasta = os.path.join(args.dir, "g.fa")
        t0 = time.perf_counter()
        genome.make_genome(fasta, args.seed, args.bp, 13, 0.65, 0.2,
                           args.bp * 57_529_878 // 840_000_000, 5)
        header = create_fasta_index(fasta, "g", fasta, 15, verbose=False, device=card)
        print(f"genome and index: {time.perf_counter() - t0:.1f} s", flush=True)
        kin_path = header.index_file_root
        kin = np.fromfile(kin_path, dtype=np.uint8)
        size = kin.shape[0]
        data = torch.from_numpy(kin).to(card)
        run_bytes = bgzip.CARD_RUN_BLOCKS * deflate.BLOCK
        runs = [(a, min(size, a + run_bytes)) for a in range(0, size, run_bytes)]

        def card_pass():
            outs = []
            for a, b in runs:
                members, sizes = deflate.deflate_bgzf(data[a:b])
                outs.append((members, sizes))
            return outs

        card_pass()  # builds the library, warms the allocator
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs = card_pass()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        sizes = torch.cat([s for _, s in outs]).cpu().numpy()
        out_bytes = int(sizes.sum())
        result.update(card_s=min(times), card_times_s=times, bytes=size, bytes_out=out_bytes,
                      ratio=out_bytes / size, card_gb_per_s=size / min(times) / 1e9,
                      peak_bytes=torch.cuda.max_memory_allocated(card))
        print(f"card deflate: {min(times):.4f} s ({size / min(times) / 1e9:.3f} GB/s), "
              f"{out_bytes} bytes out, runs {len(runs)}, times {times}", flush=True)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            card_pass()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if "kernel" in ev.key:
                kernels[ev.key] = getattr(ev, "device_time_total", 0) / 1e6
        result["kernels_s"] = kernels
        print(f"kernels: {kernels}", flush=True)

        # a sample of blocks, member by member, against the standard library
        rng = np.random.default_rng(args.seed)
        blocks = sizes.shape[0]
        picks = sorted(set(rng.integers(0, blocks, args.check).tolist()) | {0, blocks - 1})
        offs = np.concatenate([[0], np.cumsum(sizes)])
        per_run = [int(s.shape[0]) for _, s in outs]
        run_of = np.repeat(np.arange(len(runs)), per_run)
        run_first = np.concatenate([[0], np.cumsum(per_run)])
        wrong = 0
        for blk in picks:
            r = int(run_of[blk])
            lo = int(offs[blk] - offs[run_first[r]])
            got = outs[r][0][lo: lo + int(sizes[blk])].cpu().numpy().tobytes()
            payload = kin[blk * deflate.BLOCK: (blk + 1) * deflate.BLOCK].tobytes()
            wrong += got != deflate.member(payload, deflate.zlib_raw(payload))
        result.update(checked_blocks=len(picks), blocks_wrong=int(wrong))
        print(f"checked {len(picks)} blocks against zlib: {wrong} differ", flush=True)
        del outs, data

        threads = bgzip.deflate_threads()
        part = kin[: (size // 8 // deflate.BLOCK) * deflate.BLOCK]
        t0 = time.perf_counter()
        native.bgzf_compress_buffer_native(part, level=6, block_size=deflate.BLOCK,
                                           threads=threads)
        host_s = (time.perf_counter() - t0) * size / part.shape[0]
        result.update(host_s=host_s, host_threads=threads)
        print(f"host zlib, {threads} threads: {host_s:.3f} s for the file (from an eighth)",
              flush=True)

        t0 = time.perf_counter()
        bgzip.write_bgzip(kin_path, size, card)
        result["write_bgzip_readback_s"] = time.perf_counter() - t0
        print(f"write_bgzip on the card, read back: {result['write_bgzip_readback_s']:.3f} s",
              flush=True)
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    print(json.dumps(result))
    return 0 if result.get("blocks_wrong") == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
