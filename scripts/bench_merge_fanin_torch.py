#!/usr/bin/env python3
"""Merge fan-in benchmark of the PyTorch / CUDA port: N synthetic `.kin`
samples through ``pykmer_tpu_torch.merge.merge``.

Counterpart of ``scripts/bench_merge_fanin.py``: the reference's 39-genome
merge shape (N streams, N block buffers, raw and `.kin.bgz` inputs mixed) at a
chosen K, with the same fabricated samples (``fabricate_kin``: seeds 1000+i,
the first ``n_bgz`` compressed), written with the port's ``formats`` and
``io``.

    python3 scripts/bench_merge_fanin_torch.py [N] [K] [n_bgz] [block_size] [--device cuda|cpu]

Writes the samples under ``MERGE_BENCH_DIR`` (default ``./merge_bench_data``),
reusing those already there, then merges them once and prints the wall time,
MB/s streamed, the engine that ran and the peak RSS of the process. Runs on the
card unless given ``--device cpu``; raises where CUDA is missing.
"""

import os
import resource
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FABRICATE_THREADS = 8  # samples fabricated at once (numpy and zlib release the GIL)


def fabricate_kin(path_stem, kmer_len, seed, bgz=False):
    """Write a synthetic {stem}.fa.{K:02d}.kin(.bgz) + .kin.json with a
    plausible coverage distribution (Poisson-ish + saturated tail): the
    recipe of ``scripts/bench_merge_fanin.fabricate_kin``, the same bytes at
    the same seed."""
    import numpy as np

    from pykmer_tpu_torch.formats.header import KinHeader, fast_counts256
    from pykmer_tpu_torch.io.bgzf import compress_file

    data_size = 4**kmer_len
    rng = np.random.default_rng(seed)
    # ~half the cells empty, heavy tail, some saturation
    plane = rng.poisson(1.2, size=data_size).astype(np.uint16)
    hot = rng.integers(0, data_size, size=data_size // 1000)
    plane[hot] += rng.integers(200, 400, size=hot.shape[0]).astype(np.uint16)
    plane = np.minimum(plane, 255).astype(np.uint8)

    fake_input = f"{path_stem}.fa"
    with open(fake_input, "w") as fh:
        fh.write(">synthetic\nACGT\n")
    kin = f"{fake_input}.{kmer_len:02d}.kin"
    with open(kin, "wb") as fh:
        fh.write(plane.tobytes())
    h = KinHeader(fake_input, input_file=fake_input, kmer_len=kmer_len)
    h.num_kmers = int(plane.astype(np.int64).sum())
    h.chromosomes = [("synthetic", 4)]
    h.write_metadata(kin, stats_counts256=fast_counts256(plane))
    if bgz:
        compress_file(kin)
        os.remove(kin)
        return f"{kin}.bgz"
    return kin


def ensure_fanin_inputs(d, n, k, n_bgz, verbose=False):
    """The N fan-in samples under ``d``, fabricated where missing: sample i is
    ``s{i:02d}.fa.{K:02d}.kin``, ``.kin.bgz`` for i < ``n_bgz``, seed 1000+i
    (the naming of ``scripts/bench_merge_fanin.ensure_fanin_inputs``).
    Returns their paths, in order."""
    os.makedirs(d, exist_ok=True)

    def one(i):
        stem = os.path.join(d, f"s{i:02d}")
        path = f"{stem}.fa.{k:02d}.kin" + (".bgz" if i < n_bgz else "")
        if os.path.exists(path):
            return path
        path = fabricate_kin(stem, k, seed=1000 + i, bgz=i < n_bgz)
        if verbose:
            print(f"fabricated {path}", flush=True)
        return path

    with ThreadPoolExecutor(FABRICATE_THREADS) as pool:
        return list(pool.map(one, range(n)))


def merge_fanin(d, kins, device, block_size=None, engine="auto"):
    """Merge ``kins`` into ``{d}/fanin{N}.001-255.kma`` (an earlier output
    removed first); returns (wall seconds, the engine that ran, the .kma
    path, the matrix)."""
    from pykmer_tpu_torch.merge import merge
    from pykmer_tpu_torch.merge.merger import resolve_engine

    out = os.path.join(d, f"fanin{len(kins)}")
    for suffix in (".001-255.kma", ".001-255.kma.json"):
        if os.path.exists(out + suffix):
            os.remove(out + suffix)
    kwargs = {"block_size": block_size} if block_size else {}
    t0 = time.monotonic()
    _, matrix = merge(out, sorted(kins), engine=engine, verbose=False, device=device,
                      **kwargs)
    dt = time.monotonic() - t0
    return dt, resolve_engine(engine, len(kins), sharded=False), out + ".001-255.kma", matrix


def main(argv):
    from pykmer_tpu_torch import resolve_device

    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    n = int(argv[0]) if len(argv) > 0 else 39
    k = int(argv[1]) if len(argv) > 1 else 13
    n_bgz = int(argv[2]) if len(argv) > 2 else 8
    block_size = int(argv[3]) if len(argv) > 3 else None
    dev = resolve_device(device)
    if dev.type == "cuda":
        from bench_gpu import card_line

        print(card_line(), flush=True)
    d = os.environ.get("MERGE_BENCH_DIR", "merge_bench_data")
    kins = ensure_fanin_inputs(d, n, k, n_bgz, verbose=True)
    print(f"device={dev}", flush=True)
    dt, engine, _, matrix = merge_fanin(d, kins, dev, block_size)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"N={n} K={k} ({n_bgz} bgz, block={block_size}, engine {engine}): merge {dt:.3f}s  "
          f"{n * 4**k / dt / 1e6:.0f} MB/s streamed  peak RSS {rss:.1f} GB")
    print(f"matrix diag sample: {matrix[0, 0]}  off: {matrix[0, 1]}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
