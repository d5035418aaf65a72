#!/usr/bin/env python3
"""Times of the raw readback tail's file-order unfold on the card.

The unfold kernel (``ops/unfold.unfold_file`` → ``csrc/unfold.cu``) on one
64 Mi-cell slice of the K=15 file (``ops/readback.SLICE_CELLS``), in the first
half (with the 256-bin counts) and in the mirror half, beside its byte bound
(64 MiB of folded cells read, 64 MiB written, at the H100's published 3.35
TB/s) and the plain version's time on the card; the slice's copy into the
page-locked output (``host/segments.PINNED_OUT``); and the whole slice loop
(``ops/readback._file_order_to_out``) with a sink that writes and hashes
nothing, i.e. the dispatch thread's time for the whole file, into that
output and into a pageable one.

    python3 scripts/bench_unfold_torch.py [K]

Device times are the median of 20 runs by CUDA events, with a ~1 ms spin
queued ahead of each start event; host times the median of 5 by the host
clock. The plane is seeded random (60% of cells nonzero). Needs a card.
Prints the card's name and power limit first and a JSON object of every
number last.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # published HBM3 bandwidth of the H100 SXM
SPIN_CYCLES = 2_000_000  # ~1 ms of card clock queued ahead of each timing


def device_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_ms(fn, reps=10):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class _NoSink:
    """A sink that takes the regions and does nothing with them."""

    def region_done(self, lo: int, hi: int) -> None:
        pass


def main() -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from pykmer_tpu_torch.host.segments import PINNED_OUT
    from pykmer_tpu_torch.ops import readback, unfold
    from pykmer_tpu_torch.utils.bigmem import big_empty

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 15
    dev = torch.device("cuda")
    full, n = 4**k, min(readback.SLICE_CELLS, 4**k // 2)
    rng = np.random.default_rng(7)
    folded = (rng.integers(1, 256, full // 2, dtype=np.uint8)
              * (rng.random(full // 2) < 0.6)).astype(np.uint8)
    plane = torch.from_numpy(folded).to(dev)
    counts = torch.zeros(256, dtype=torch.int64, device=dev)
    res = {"kmer_len": k, "slice_cells": n, "device": torch.cuda.get_device_name(dev)}
    res["bound_ms"] = 2 * n / HBM_BYTES_PER_S * 1e3
    res["kernel_first_ms"] = device_ms(
        lambda: unfold.unfold_file(plane[:n], 0, k, 0, n, counts))
    half = full // 2  # file bytes [half, half + n) read folded cells [half - n, half)
    res["kernel_mirror_ms"] = device_ms(
        lambda: unfold.unfold_file(plane[half - n:], half - n, k, half, half + n))
    res["kernel_first_share"] = res["bound_ms"] / res["kernel_first_ms"]
    res["kernel_mirror_share"] = res["bound_ms"] / res["kernel_mirror_ms"]
    res["plain_ms"] = device_ms(lambda: unfold.unfold_file_plain(plane[:n], 0, k, 0, n), reps=3)
    want = readback.unfold_canonical(folded, k)
    out = PINNED_OUT.lease(full).array[:full]
    slice_dev = unfold.unfold_file(plane[:n], 0, k, 0, n)
    res["d2h_pinned_ms"] = device_ms(
        lambda: torch.from_numpy(out[:n]).copy_(slice_dev, non_blocking=True))
    for name, dst in (("pinned", out), ("pageable", big_empty(full))):
        res[f"loop_{name}_ms"] = host_ms(lambda: readback._file_order_to_out(
            [plane], k, dst, _NoSink(), readback.SLICE_CELLS), reps=5)
        res[f"loop_{name}_bytes_equal"] = bool(np.array_equal(dst, want))
    PINNED_OUT.give_back()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
