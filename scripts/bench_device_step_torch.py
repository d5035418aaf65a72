#!/usr/bin/env python3
"""Per-stage times of one chunk's device step in the PyTorch / CUDA port.

Counterpart of ``scripts/bench_device_step.py``: the stages of the step the
single-card index runs per chunk (``index/indexer.accumulate_device``), at the
main path's chunk size by default (K=15, 2^24 windows):

- the upload of the packed chunk (2-bit bases and, for a masked chunk, the
  validity bits), from pageable and from pinned host memory;
- the encode kernel with its fused valid-window count
  (``ops/encode.canonical_codes_packed``), and its plain version;
- the sort (``ops/histogram.sort_codes_fast``);
- step A (``index/indexer.chunk_sorted_codes``: encode, count, sort);
- the sweep (``ops/sweep.accumulate_sorted``) into the folded plane;
- A+B, one chunk's whole step.

    python3 scripts/bench_device_step_torch.py [K] [windows] [--device cuda|cpu]

Each time is the median of 10 runs: on the card by CUDA events, with a ~1 ms
spin queued ahead of each start event so that a short kernel's time is not its
enqueue; on the CPU by the host clock, where the wrappers run their plain
versions. On the card, beside each hand kernel stands its bound and its share
of it: the encode kernel's bytes (the planes read once, the codes written
once), the sweep's (the codes read once, one 32-byte sector read and written
back per distinct sector the codes touch) over the H100's published 3.35
TB/s. The chunk is uniform random bases from seed 7, all valid
(the input of the JAX script). The JAX script's bf16 / int8 MXU sweep variants
are TPU variants and have no counterpart. Runs on the card unless given
``--device cpu``, and raises where CUDA is missing. Prints the card's name and
power limit first and a JSON object of every number last.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # published HBM3 bandwidth of the H100 SXM
SPIN_CYCLES = 2_000_000  # ~1 ms of card clock queued ahead of each timing
REPS = 10


def median_ms(fn, dev, reps=REPS):
    """Median ms of ``fn`` after one warm-up call: device time by CUDA events
    on a CUDA ``dev`` (a ~1 ms spin queued before each start event), the host
    clock on the CPU."""
    import torch

    fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sweep_bound_ms(batches, cells):
    """The least time the card could take to apply these sorted batches to a
    plane of ``cells`` cells: every code read once, plus one 32-byte sector
    read and one written back for each distinct sector of the plane that the
    in-range codes touch (``unique_consecutive(codes >> 5)``, over the union
    of the batches), at the published HBM3 bandwidth. Returns (ms, distinct
    sectors, bytes)."""
    import torch

    code_bytes = sum(c.numel() * c.element_size() for c in batches)
    sectors = torch.cat([c[(c >= 0) & (c < cells)].to(torch.int64) >> 5 for c in batches])
    if len(batches) > 1:
        sectors = torch.sort(sectors).values
    n_sectors = int(torch.unique_consecutive(sectors).numel())
    moved = code_bytes + n_sectors * 2 * 32
    return moved / HBM_BYTES_PER_S * 1e3, n_sectors, moved


def random_chunk(kmer_len, windows, seed=7):
    """One all-valid packed chunk of ``windows`` windows of uniform random
    bases: (2-bit bases, None), as the index frames an all-valid chunk."""
    import numpy as np

    from pykmer_tpu_torch.host.chunks import pack_base_stream

    span = windows + kmer_len - 1
    bases = np.random.default_rng(seed).integers(0, 4, size=span).astype(np.uint8)
    return pack_base_stream(bases)[0][: (span + 3) // 4], None


def step_times(dev, chunk, kmer_len, windows, reps=REPS):
    """Median ms of each stage of one chunk's step on ``dev`` (module
    docstring), with the kernels' bounds; returns a dict. ``chunk`` is
    (2-bit bases, validity bits or None) as the pipeline yields it. The
    sweep runs into a zeroed folded plane (4^K / 2 cells)."""
    import torch

    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.encode import (canonical_codes_packed,
                                             canonical_codes_packed_plain, code_dtype)
    from pykmer_tpu_torch.ops.histogram import sort_codes_fast

    k, span = kmer_len, windows + kmer_len - 1
    b, m = chunk
    hb, hm = torch.from_numpy(b), None if m is None else torch.from_numpy(m)
    in_bytes = b.nbytes + (0 if m is None else m.nbytes)
    db, dm = hb.to(dev), None if hm is None else hm.to(dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    codes = canonical_codes_packed(db, dm, span, k, count=count)
    sorted_codes, _ = chunk_sorted_codes(db, dm, k, span)
    plane = torch.zeros(4**k // 2, dtype=torch.uint8, device=dev)
    code_bytes = windows * torch.empty((), dtype=code_dtype(k)).element_size()
    out = {"kmer_len": k, "windows": windows, "device": str(dev),
           "chunk": "all-valid" if m is None else "masked", "upload_bytes": in_bytes}
    if dev.type == "cuda":
        pb = hb.pin_memory()
        pm = None if hm is None else hm.pin_memory()
        out["h2d_pageable_ms"] = median_ms(
            lambda: (hb.to(dev), None if hm is None else hm.to(dev)), dev, reps)
        out["h2d_pinned_ms"] = median_ms(
            lambda: (db.copy_(pb, non_blocking=True),
                     None if dm is None else dm.copy_(pm, non_blocking=True)), dev, reps)
    out["encode_kernel_ms"] = median_ms(
        lambda: canonical_codes_packed(db, dm, span, k, count=count), dev, reps)
    out["encode_plain_ms"] = median_ms(
        lambda: canonical_codes_packed_plain(db, dm, span, k), dev, reps)
    out["sort_ms"] = median_ms(lambda: sort_codes_fast(codes), dev, reps)
    out["stepA_ms"] = median_ms(lambda: chunk_sorted_codes(db, dm, k, span), dev, reps)
    out["sweep_ms"] = median_ms(lambda: sweep.accumulate_sorted(plane, sorted_codes), dev, reps)
    out["stepAB_ms"] = median_ms(
        lambda: sweep.accumulate_sorted(plane, chunk_sorted_codes(db, dm, k, span)[0]),
        dev, reps)
    if dev.type == "cuda":  # the H100's bounds; no share is stated for a CPU run
        out["encode_bound_ms"] = (in_bytes + code_bytes) / HBM_BYTES_PER_S * 1e3
        out["sweep_bound_ms"] = sweep_bound_ms([sorted_codes], plane.shape[0])[0]
    out["windows_per_s"] = windows / (out["stepAB_ms"] / 1e3)
    del plane, codes, sorted_codes, db, dm, count
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def format_table(t):
    """The stage table of :func:`step_times`'s result, as text."""
    rows = [("upload, pageable", "h2d_pageable_ms", None),
            ("upload, pinned", "h2d_pinned_ms", None),
            ("encode, count fused (kernel)", "encode_kernel_ms", "encode_bound_ms"),
            ("encode, plain version", "encode_plain_ms", None),
            ("sort (sort_codes_fast)", "sort_ms", None),
            ("step A (encode + count + sort)", "stepA_ms", None),
            ("sweep kernel (step B)", "sweep_ms", "sweep_bound_ms"),
            ("A+B", "stepAB_ms", None)]
    lines = [f"== device step on {t['device']}, K={t['kmer_len']}, {t['windows']:,} windows "
             f"({t['chunk']} chunk, {t['upload_bytes']:,} upload bytes) ==",
             f"{'stage':32s} {'ms':>10s} {'M windows/s':>12s} {'bound ms':>10s} {'share':>6s}"]
    for label, key, bound in rows:
        if key not in t:
            continue
        ms = t[key]
        tail = f" {t[bound]:10.4f} {t[bound] / ms:6.2f}" if bound in t else ""
        lines.append(f"{label:32s} {ms:10.4f} {t['windows'] / ms / 1e3:12.1f}{tail}")
    return "\n".join(lines)


def main(argv):
    import torch

    from pykmer_tpu_torch import resolve_device

    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    k = int(argv[0]) if len(argv) > 0 else 15
    windows = int(argv[1]) if len(argv) > 1 else 1 << 24
    dev = resolve_device(device)
    if dev.type == "cuda":
        from bench_gpu import card_line

        print(card_line(), flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(dev)}", flush=True)
    t = step_times(dev, random_chunk(k, windows), k, windows)
    print(format_table(t), flush=True)
    print(json.dumps(t))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
