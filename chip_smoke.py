#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pykmer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases — each one passes or raises, and any failure exits non-zero:

1. build the CUDA kernels from ``pykmer_tpu_torch/csrc`` (nvcc, sm_90a) and
   print the card's name and power limit;
2. the sweep kernel vs its plain torch version on the card, byte for byte:
   the K=15 shape (a 2^29-cell plane prefilled with random values, 2^24
   sorted int32 codes with runs far above 255, sentinels and the -1 /
   int32-max bands), then an int64 batch on a plane of more than 2^31 cells
   with codes above 2^31; median kernel and plain times at the K=15 shape;
3. oracle: a small FASTA (Ns, several records, an empty one) indexed at K=11
   through ``python -m pykmer_tpu_torch index`` gives the `.kin` and stats of
   ``pykmer_tpu.oracle`` (numpy);
4. the slice at real size: a seeded 256 Mbp genome with repeat families,
   indexed at K=15 through the CLI entry point with verify on; the kernel's
   launch count equals the chunk count, and a re-run of the same chunks with
   the plain sweep gives the same `.kin` byte for byte;
5. where the time goes: one chunk's steps timed with CUDA events, then a
   second index run of the genome under ``torch.profiler``, whose device
   activity (kernels and copies, overlaps merged) gives the busy and idle
   shares of its wall time;
6. a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is unavailable or outside
a checkout of the repository. It never imports jax. Scratch files go under
``build/smoke`` (git-ignored) and are removed at the end.
"""

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
K15_CELLS = 1 << 29  # folded plane at K=15
K15_CODES = 1 << 24  # codes per chunk at K=15 on CUDA
BIG_CELLS = (1 << 32) + 17  # > 2^31 cells: int64 indexing
BIG_CODES = 1 << 22
GENOME_BP = 256_000_000
SLICE_K = 15
ORACLE_K = 11
H100_SXM_BYTES_PER_S = 3.35e12  # published HBM3 bandwidth of the H100 SXM
PROFILE_TOP = 8  # device items listed by the profiled run


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps):
    """Median device time of ``fn`` (CUDA events), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def max_abs_err(a, b):
    import torch

    step = 1 << 28
    err = 0
    for lo in range(0, a.shape[0], step):
        d = (a[lo : lo + step].to(torch.int16) - b[lo : lo + step].to(torch.int16))
        err = max(err, int(d.abs().max()))
    return err


def sorted_batch(rng, cells, m, hot_cells, dtype):
    """m sorted codes over ``cells``: uniform codes, runs of 256..100k copies
    at ``hot_cells``, short runs, the folded sentinel, -1, and int32 max."""
    import numpy as np

    codes = rng.integers(0, cells, size=m, dtype=np.int64)
    pos = 0
    for c, n in zip(hot_cells, rng.integers(256, 100_000, size=len(hot_cells))):
        codes[pos : pos + n] = c
        pos += n
    for c in rng.integers(0, cells, size=2000):  # runs of 2..254
        n = int(rng.integers(2, 255))
        codes[pos : pos + n] = c
        pos += n
    codes[pos : pos + 100_000] = cells
    codes[pos + 100_000 : pos + 200_000] = -1
    codes[pos + 200_000 : pos + 201_000] = np.iinfo(np.int32).max
    return np.sort(codes).astype(dtype)


def phase_kernels(dev):
    """Kernel vs plain at the K=15 shape (int32) and on a >2^31 plane (int64)."""
    import numpy as np
    import torch

    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted

    rng = np.random.default_rng(SEED)
    plane0 = torch.from_numpy(rng.integers(0, 256, size=K15_CELLS, dtype=np.uint8)).to(dev)
    hot = rng.integers(0, K15_CELLS, size=64)
    plane0[torch.from_numpy(hot[:16]).to(dev)] = 250  # hot runs on near-full cells
    codes = torch.from_numpy(sorted_batch(rng, K15_CELLS, K15_CODES, hot, np.int32)).to(dev)
    a, b = plane0.clone(), plane0.clone()
    sweep.accumulate_sorted(a, codes)
    torch.cuda.synchronize()
    saturating_accumulate_sorted(b, codes)
    torch.cuda.synchronize()
    err32 = max_abs_err(a, b)
    if err32 or not bool((a[torch.from_numpy(hot).to(dev)] == 255).all()):
        raise AssertionError(f"int32 K=15 shape: kernel != plain (max abs err {err32})")
    log(f"kernel vs plain, int32, {K15_CELLS} cells, {K15_CODES} codes: equal")
    # alternate plain / kernel / kernel / plain on scratch copies
    t_plain = [median_ms(lambda: saturating_accumulate_sorted(b, codes), 10)]
    t_kernel = [median_ms(lambda: sweep.accumulate_sorted(a, codes), 20)]
    t_kernel.append(median_ms(lambda: sweep.accumulate_sorted(a, codes), 20))
    t_plain.append(median_ms(lambda: saturating_accumulate_sorted(b, codes), 10))
    log(f"sweep time at the K=15 shape (median ms): kernel {t_kernel} "
        f"plain {t_plain}")
    # the kernel's memory floor: the codes once, plus one 32-byte sector read
    # and one written back per distinct in-range code
    distinct = int(torch.unique_consecutive(
        codes[(codes >= 0) & (codes < K15_CELLS)]).numel())
    moved = codes.numel() * codes.element_size() + distinct * 2 * 32
    floor_ms = moved / H100_SXM_BYTES_PER_S * 1e3
    log(f"sweep memory floor: {distinct} distinct in-range codes, {moved} bytes "
        f"-> {floor_ms:.4f} ms at {H100_SXM_BYTES_PER_S / 1e12} TB/s "
        f"(published HBM3 bandwidth); kernel at {floor_ms / min(t_kernel):.3f} of it")
    del a, b, plane0, codes
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(SEED)
    big0 = torch.randint(0, 256, (BIG_CELLS,), dtype=torch.uint8, device=dev, generator=g)
    hot = rng.integers(1 << 31, BIG_CELLS, size=16)
    codes = sorted_batch(rng, BIG_CELLS, BIG_CODES, hot, np.int64)
    codes[-10:] = 1 << 40
    codes = torch.from_numpy(codes).to(dev)
    if not bool((codes >= (1 << 31)).sum() > BIG_CODES // 4):
        raise AssertionError("int64 batch holds too few codes above 2^31")
    a, b = big0.clone(), big0.clone()
    del big0
    sweep.accumulate_sorted(a, codes)
    torch.cuda.synchronize()
    saturating_accumulate_sorted(b, codes)
    torch.cuda.synchronize()
    err64 = max_abs_err(a, b)
    if err64 or not bool((a[torch.from_numpy(hot).to(dev)] == 255).all()):
        raise AssertionError(f"int64 >2^31 plane: kernel != plain (max abs err {err64})")
    log(f"kernel vs plain, int64, {BIG_CELLS} cells, {BIG_CODES} codes: equal")
    del a, b, codes
    torch.cuda.empty_cache()
    return max(err32, err64), min(t_kernel), min(t_plain)


def write_small_fasta(path, rng):
    """~30 kbp: Ns, lowercase, odd line width, an empty record (the recipe
    of tests/conftest.make_random_fasta, inline: that module imports jax)."""
    import numpy as np

    alphabet = np.array(list("ACGTacgtN"), dtype="U1")
    probs = np.array([1, 1, 1, 1, 0.3, 0.3, 0.3, 0.3, 0.6])
    probs = probs / probs.sum()
    out = []
    for i, n in enumerate((12_000, 0, 9_000, 9_000, 5)):
        seq = "".join(rng.choice(alphabet, size=n, p=probs))
        out.append(f">rec-{i} desc text\n")
        for j in range(0, n, 61):
            out.append(seq[j : j + 61] + "\n")
    with open(path, "w") as fh:
        fh.write("".join(out))


def phase_oracle(work, dev):
    import numpy as np

    from pykmer_tpu.oracle import oracle_write_index

    fa = os.path.join(work, "small.fa")
    write_small_fasta(fa, np.random.default_rng(SEED))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "pykmer_tpu_torch", "index", fa, "small",
         str(ORACLE_K), "--device", str(dev), "--quiet"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"port CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    kin = fa + f".{ORACLE_K}.kin"
    meta = kin + ".json"
    port_kin = open(kin, "rb").read()
    port_meta = json.load(open(meta))
    os.remove(kin)
    os.remove(meta)
    oracle_write_index(fa, fa, ORACLE_K)
    if open(kin, "rb").read() != port_kin:
        raise AssertionError(f"K={ORACLE_K} .kin differs from the numpy oracle's")
    oracle_meta = json.load(open(meta))
    for key in ("num_kmers", "hist", "vals_sum", "chromosomes"):
        if port_meta[key] != oracle_meta[key]:
            raise AssertionError(f"K={ORACLE_K} .kin.json {key} differs from the oracle's")
    log(f"oracle K={ORACLE_K}: .kin identical, num_kmers {port_meta['num_kmers']}, "
        f"{len(port_meta['chromosomes'])} chromosomes")


def phase_slice(work, dev):
    """The genome at SLICE_K through the CLI entry; launch count; plain re-run."""
    import numpy as np
    import torch

    import bench
    from pykmer_tpu.config import IndexConfig
    from pykmer_tpu.io.fasta import open_input_bytes
    from pykmer_tpu_torch import cli
    from pykmer_tpu_torch.config import resolve_chunk_windows
    from pykmer_tpu_torch.host.chunks import chunk_stream, iter_chunks_packed_lazy
    from pykmer_tpu_torch.host.decode import decode_joined_bytes
    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted
    from pykmer_tpu_torch.ops.readback import unfold_canonical

    k = SLICE_K
    genome = os.path.join(work, "genome.fa")
    t0 = time.perf_counter()
    bench.make_genome(genome, GENOME_BP, seed=SEED, repeats=True)
    log(f"genome: {GENOME_BP} bp written in {time.perf_counter() - t0:.1f} s (set-up)")

    cw = resolve_chunk_windows(IndexConfig(kmer_len=k), dev,
                               os.path.getsize(genome)).chunk_windows
    stream, _, total_bp = decode_joined_bytes(open_input_bytes(genome), k,
                                              tail_headroom=cw + k)
    padded, n_chunks = chunk_stream(stream, k, cw)

    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    err = io.StringIO()
    sweep.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["index", genome, "s", str(k), "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = sweep.LAUNCHES
    os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    log(err.getvalue().rstrip())
    if rc != 0:
        raise RuntimeError(f"index exited {rc}")
    log(f"index K={k}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
        f"(verify on), {n_chunks} chunks of {cw} windows, {launches} sweep launches")
    if launches != n_chunks:
        raise AssertionError(f"sweep launched {launches} times for {n_chunks} chunks")

    # the same chunks through step A + the PLAIN sweep
    plane = torch.zeros(4**k // 2, dtype=torch.uint8, device=dev)
    nk = n_all_valid = 0
    span = cw + k - 1
    for b, m in iter_chunks_packed_lazy(padded, k, cw, n_chunks):
        n_all_valid += m is None
        codes, nvalid = chunk_sorted_codes(
            torch.from_numpy(b).to(dev),
            None if m is None else torch.from_numpy(m).to(dev), k, span)
        saturating_accumulate_sorted(plane, codes)
        nk += int(nvalid)
    want = unfold_canonical(plane.cpu().numpy(), k)
    got = np.fromfile(genome + f".{k}.kin", dtype=np.uint8)
    if not np.array_equal(got, want):
        raise AssertionError(f"K={k} .kin differs from the plain-sweep re-run")
    meta = json.load(open(genome + f".{k}.kin.json"))
    if meta["num_kmers"] != nk:
        raise AssertionError(f"num_kmers {meta['num_kmers']} != plain re-run {nk}")
    if meta["vals_max"] != 255:
        raise AssertionError("the repeat families did not saturate any cell")
    log(f"plain re-run: .kin identical, num_kmers {nk}, vals_max 255; "
        f"{n_all_valid} of {n_chunks} chunks all-valid")
    return launches, genome, padded, n_chunks, cw, total_bp


def chunk_step_times(dev, padded, n_chunks, cw):
    """Median device ms (CUDA events) of each step of the first chunk."""
    import torch

    from pykmer_tpu_torch.host.chunks import iter_chunks_packed_lazy
    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.encode import (
        canonical_codes, fold_codes, unpack_base_2bit, unpack_base_2bit_mask)
    from pykmer_tpu_torch.ops.histogram import sort_codes_fast

    k = SLICE_K
    span = cw + k - 1
    b, m = next(iter(iter_chunks_packed_lazy(padded, k, cw, n_chunks)))

    def upload():
        return (torch.from_numpy(b).to(dev),
                None if m is None else torch.from_numpy(m).to(dev))

    db, dm = upload()

    def encode():
        chunk = unpack_base_2bit(db, span) if dm is None \
            else unpack_base_2bit_mask(db, dm, span)
        return fold_codes(canonical_codes(chunk, k), k)

    codes = encode()
    sorted_codes, _ = chunk_sorted_codes(db, dm, k, span)
    plane = torch.zeros(4**k // 2, dtype=torch.uint8, device=dev)
    times = {
        "chunk": "all-valid" if m is None else "masked",
        "h2d_ms": median_ms(upload, 10),
        "encode_ms": median_ms(encode, 10),
        "sort_ms": median_ms(lambda: sort_codes_fast(codes), 10),
        "stepA_ms": median_ms(lambda: chunk_sorted_codes(db, dm, k, span), 10),
        "stepB_sweep_ms": median_ms(lambda: sweep.accumulate_sorted(plane, sorted_codes), 10),
    }
    log("one chunk, median device ms: " + json.dumps(times))
    del plane, codes, sorted_codes, db, dm
    torch.cuda.empty_cache()


def merged_us(intervals):
    """Total length of a set of [start, end) intervals, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def profiled_run(dev, genome, total_bp):
    """A second index of the genome under torch.profiler: its stage table,
    wall time and the device's busy share (device activity, overlaps merged,
    over the run's wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pykmer_tpu_torch import cli

    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    err = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["index", genome, "s", str(SLICE_K), "--device", str(dev)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    if rc != 0:
        raise RuntimeError(f"profiled index exited {rc}")
    log("profiled run, " + err.getvalue().rstrip())
    log(f"profiled run: {total_bp} bp in {wall_ms:.1f} ms = "
        f"{total_bp / wall_ms * 1e3:.0f} bp/s (verify on, under torch.profiler)")
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        log("profiled run: the profiler recorded no device activity; "
            "busy share not measured")
        return
    busy_ms = merged_us([(e.time_range.start, e.time_range.end)
                         for e in dev_events]) / 1e3
    by_name = {}
    for e in dev_events:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    summed_ms = sum(t for t, _ in by_name.values()) / 1e3
    log(f"profiled run: device busy {busy_ms:.1f} ms (merged intervals; "
        f"{summed_ms:.1f} ms summed over {len(dev_events)} device items) of "
        f"{wall_ms:.1f} ms wall -> busy share {busy_ms / wall_ms:.4f}, "
        f"idle share {1 - busy_ms / wall_ms:.4f}")
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]:
        log(f"  device {tot / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")


def main():
    sys.modules["jax"] = None  # any jax import below fails loudly
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(ROOT, "pykmer_tpu_torch", "__init__.py")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pykmer_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (set-up)\n{_build.BUILD_LOG.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        err, ms, plain_ms = phase_kernels(dev)
        phase_oracle(work, dev)
        launches, genome, padded, n_chunks, cw, total_bp = phase_slice(work, dev)
        chunk_step_times(dev, padded, n_chunks, cw)
        del padded
        profiled_run(dev, genome, total_bp)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "sweep_sorted",
        "route": "cuda",
        "source": "pykmer_tpu_torch/csrc/sweep.cu",
        "replaces": "pykmer_tpu/ops/pallas_hist.py:259",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
