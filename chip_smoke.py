#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pykmer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases — each one passes or raises, and any failure exits non-zero:

1. build the CUDA kernels from ``pykmer_tpu_torch/csrc`` (nvcc, sm_90a) and
   print the card's name and power limit;
2. the sweep kernel vs its plain torch version on the card, byte for byte:
   the K=15 shape (a 2^29-cell plane prefilled with random values, 2^24
   sorted int32 codes with runs far above 255, sentinels and the -1 /
   int32-max bands) and the K=17 shape (a 2^33-cell plane, 2^24 sorted int64
   codes, most above 2^31); median kernel and plain times at both shapes,
   beside the kernel's bound (the codes read once plus one 32-byte sector
   read and one written back per distinct in-range sector, at 3.35 TB/s)
   and its share of it; then the card tests of the kernel's edges (runs
   over block boundaries, ragged and tiny batches, unaligned codes views,
   the bands, int64 codes above 2^31: ``tests/test_torch_cuda.py -k
   test_kernel_``, in a pytest subprocess);
3. oracle: a small FASTA (Ns, several records, an empty one) indexed at K=11
   through ``python -m pykmer_tpu_torch index`` gives the `.kin` and stats of
   the port's copy of the numpy oracle (``pykmer_tpu_torch.oracle``);
4. the slice at real size: a seeded 256 Mbp genome with repeat families,
   indexed at K=15 through the CLI entry point with verify on (the streaming
   pipeline); the kernel's launch count equals the count of chunks the
   pipeline frames, and a replay of the same chunks with the plain sweep
   gives the same `.kin` byte for byte; a gzip -1 copy of the genome (the
   pipelined path that reads the input whole) and the host strategy give the
   same `.kin` sha256;
5. where the time goes: one chunk's steps timed with CUDA events, then a
   second index run of the genome under ``torch.profiler``, whose device
   activity (kernels and copies, overlaps merged) gives the busy and idle
   shares of its wall time;
6. K=17 (an 8 GiB folded plane on the card, int64 codes): phase 3's small
   FASTA through the CLI, every nonzero cell of its 16 GiB `.kin` equal to
   the sparse numpy oracle's counts and no other cell nonzero; then the
   genome through the CLI with verify on, with its stage table, bp/s and peak
   device memory; the int64 launches equal the chunk count, and a replay of
   the same chunks gives a kernel plane equal to the plain-sweep plane
   (``torch.equal`` on the card) whose stats are the `.kin`'s. Each 16 GiB
   `.kin` is removed as soon as it is checked;
7. merge fan-in at the reference's workload shape: 39 synthetic K=13
   samples, 8 of them `.kin.bgz` (``fabricate_kin``: the recipe of
   ``scripts/bench_merge_fanin.py`` on the port's ``formats``, seeds
   1000+i), merged through the CLI entry with the device engine on the card
   and with the host engine: equal `.kma` matrices, three pairs equal to
   ``pair_counts_stream``, the device block steps one per block; the device
   step's time per block (CUDA events) with its unpack and product apart,
   and the host-vs-device crossover in N;
8. a merge pair at K=15, full size: phase 4's `.kin` and a seeded
   perturbation of it, device engine vs host engine vs
   ``pair_counts_stream``, with wall times and MB/s streamed;
9. the service: ``python -m pykmer_tpu_torch serve --warmup-k 15`` as a
   subprocess indexes the genome and its gzip copy, fails a bad index,
   merges the two and runs distance; every reply as expected and both
   `.kin` sha256 equal to phase 4's;
10. the sharded paths, with logical shards on the one card
   (``make_mesh(devices=[cuda:0] * n)``): (a) the genome at K=15 through
   ``create_fasta_index_sharded`` on a 1x4 and a 2x2 mesh, a run with
   ``checkpoint_every=1`` stopped after its second save and then resumed,
   and ``index --shards <card count>`` through the CLI entry: each `.kin`
   sha256 equal to phase 4's and the sweep launched (R·S)^2 times per step;
   one step's parts timed with CUDA events (bucket, exchange, the received
   rows applied one launch per row against one re-sort and one launch);
   (d) one K=15 step set on ``[cuda:0] * 4`` ``torch.equal`` to the same
   step on ``[cpu] * 4``; (c) the fan-in of phase 7 through ``merge(...,
   n_shards=4, mesh=...)``: the `.kma` matrix of the single-device engine,
   four block steps per block; (b) the genome at K=17 over 8 shards (eight
   1 GiB local planes, int32 local codes) and over 4 (int64 local codes),
   each `.kin` sha256 equal to phase 6's;
11. multi-host, two processes of one gloo ``torch.distributed`` job on the
   one card (each its own CUDA context on ``cuda:0``, gloo on 127.0.0.1),
   each process accumulating its byte range of the input: (a) the genome at
   K=15 through ``python -m pykmer_tpu_torch index ... --coordinator
   --num-processes 2 --process-id i`` with verify on, then through this
   script's worker mode (``--mh-worker``: ``create_fasta_index_multihost``,
   one JSON line of the sweep's launches and peak memories a process, its
   stage table on stderr); (b) the gzip -1 copy through the CLI (staged by
   process 0, no ``*.inflated.tmp*`` left); (c) the genome at K=17 in worker mode, each
   process holding a full 8 GiB folded plane on the card. The `.kin`
   sha256 of (a) and (b) is phase 4's and of (c) phase 6's; the launches
   summed over the processes equal the steps of each process's byte range
   times (R·S)^2; process 0's received rows of one step are timed kernel
   against plain; each process's wall and stage table are logged, and at
   K=17 its peak device memory and peak host RSS. A worker that fails or
   times out fails the phase, and every worker is reaped;
12. a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Phases 7-9 run between phases 2 and 3 (7, with 10c) and after phase 5 (8,
9); 10a and 10d run after phase 9, 10b after phase 6, 11 after 10b. The
script exits non-zero, printing no result, where CUDA is unavailable or
outside a checkout of the repository. It never imports jax. Scratch files go
under ``build/smoke`` (git-ignored) and are removed at the end. It needs
about 35 GiB of free disk there (two 1 GiB K=15 files, one 16 GiB K=17 file
at a time) and 60 GiB of host memory (phase 11c: two processes, each with
its 8 GiB partial plane and 4 GiB of combined pieces).
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
K17_CELLS = 1 << 33  # folded plane at K=17: int64 codes and indexing
K17_CODES = 1 << 24  # codes per chunk at K=17 on CUDA
GENOME_BP = 256_000_000
SLICE_K = 15
BIG_K = 17
ORACLE_K = 11
H100_SXM_BYTES_PER_S = 3.35e12  # published HBM3 bandwidth of the H100 SXM
PROFILE_TOP = 8  # device items listed by the profiled run
FANIN_N, FANIN_K, FANIN_BGZ = 39, 13, 8  # the reference's 39-genome merge
FANIN_PAIRS = ((0, 1), (7, 8), (20, 38))  # bgz-bgz, bgz-raw, raw-raw
CROSSOVER_N = (2, 4, 8, 16, 31)  # merge sizes timed with both engines
SHARD_MESHES = ((1, 4), (2, 2))  # (data rows, shards) of the sharded K=15 runs
SHARD_CW = 1 << 22  # windows per row of a sharded step (the sharded default)
MERGE_SHARDS = 4
# K=17 shard counts: eight 1 GiB local planes take int32 local codes, four
# 2 GiB planes (over 2^31 - 1 cells) the int64 launcher
K17_SHARDS = (8, 4)
MH_PROCESSES = 2  # processes of the multi-host job (phase 11), on the one card
MH_TIMEOUT_S = 400  # a multi-host run's limit: its workers are killed after it


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
    return moved / H100_SXM_BYTES_PER_S * 1e3, n_sectors, moved


def kernel_vs_plain(dev, cells, codes, hot, label):
    """The kernel and the plain sweep on two copies of one random plane;
    returns (max abs err, min kernel ms, min plain ms, bound ms), each time
    the median of one round, rounds alternating plain, kernel, kernel,
    plain."""
    import torch

    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted

    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randint(0, 256, (cells,), dtype=torch.uint8, device=dev, generator=g)
    hot = torch.from_numpy(hot).to(dev)
    a[hot[:16]] = 250  # hot runs on near-full cells
    b = a.clone()
    sweep.accumulate_sorted(a, codes)
    torch.cuda.synchronize()
    saturating_accumulate_sorted(b, codes)
    torch.cuda.synchronize()
    err = max_abs_err(a, b)
    if err or not bool((a[hot] == 255).all()):
        raise AssertionError(f"{label}: kernel != plain (max abs err {err})")
    log(f"kernel vs plain, {label}, {cells} cells, {codes.numel()} codes: equal")
    # timed on the (now saturated) copies: the same cells, the same traffic
    t_plain = [median_ms(lambda: saturating_accumulate_sorted(b, codes), 10)]
    t_kernel = [median_ms(lambda: sweep.accumulate_sorted(a, codes), 20)]
    t_kernel.append(median_ms(lambda: sweep.accumulate_sorted(a, codes), 20))
    t_plain.append(median_ms(lambda: saturating_accumulate_sorted(b, codes), 10))
    bound, sectors, moved = sweep_bound_ms([codes], cells)
    log(f"sweep, {label} (median ms): kernel {t_kernel}, plain {t_plain}; bound "
        f"{bound:.4f} ms ({codes.numel() * codes.element_size()} bytes of codes + "
        f"2 x 32 B for each of {sectors} distinct in-range sectors = {moved} bytes at "
        f"{H100_SXM_BYTES_PER_S / 1e12} TB/s, the published HBM3 bandwidth); kernel at "
        f"{bound / min(t_kernel):.3f} of its bound")
    del a, b
    torch.cuda.empty_cache()
    return err, min(t_kernel), min(t_plain), bound


def kernel_edge_cases():
    """The card tests of the sweep's edges (runs longer than a block's
    positions, across a block boundary, from a block's last position to past
    it or to the batch's end; batches smaller than a block or not a multiple
    of it, one run over the whole batch, m = 1, codes views at unaligned
    offsets, the sentinel / -1 / int32-max bands, int64 codes above 2^31),
    each byte for byte against the plain version, in a pytest subprocess."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "-m", "cuda", "tests/test_torch_cuda.py", "-k", "test_kernel_"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:]
    if proc.returncode != 0 or not tail or " passed" not in tail[0] \
            or "skipped" in tail[0]:
        raise AssertionError(f"sweep edge cases failed:\n{proc.stdout[-4000:]}"
                             f"{proc.stderr[-2000:]}")
    log(f"sweep edge cases (tests/test_torch_cuda.py -k test_kernel_): {tail[0]} "
        f"in {time.perf_counter() - t0:.1f} s")


def phase_kernels(dev):
    """Kernel vs plain at the K=15 shape (int32) and the K=17 shape (int64)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    hot = rng.integers(0, K15_CELLS, size=64)
    codes = torch.from_numpy(sorted_batch(rng, K15_CELLS, K15_CODES, hot, np.int32)).to(dev)
    k15 = kernel_vs_plain(dev, K15_CELLS, codes, hot, "int32 at the K=15 shape")

    hot = rng.integers(1 << 31, K17_CELLS, size=64)
    codes = sorted_batch(rng, K17_CELLS, K17_CODES, hot, np.int64)
    codes[-10:] = 1 << 40
    codes = torch.from_numpy(codes).to(dev)
    if not bool((codes >= (1 << 31)).sum() > K17_CODES // 2):
        raise AssertionError("int64 batch holds too few codes above 2^31")
    k17 = kernel_vs_plain(dev, K17_CELLS, codes, hot, "int64 at the K=17 shape")
    del codes
    torch.cuda.empty_cache()
    kernel_edge_cases()
    return k15, k17


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


def cli_subprocess(args):
    """``python -m pykmer_tpu_torch <args>`` from the checkout; returns its
    wall time in seconds."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pykmer_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"port CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return time.perf_counter() - t0


def run_cli(argv):
    """``cli.main(argv)`` in this process with the stage table on; returns
    (wall seconds, the stage table)."""
    from pykmer_tpu_torch import cli

    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)} exited {rc}\n{err.getvalue()[-4000:]}")
    return wall, err.getvalue().rstrip()


def take_outputs(kin):
    """The `.kin.json` of ``kin``; both files are removed."""
    with open(kin + ".json") as fh:
        meta = json.load(fh)
    os.remove(kin)
    os.remove(kin + ".json")
    return meta


def phase_oracle(work, dev):
    import numpy as np

    from pykmer_tpu_torch.oracle import oracle_write_index

    fa = os.path.join(work, "small.fa")
    write_small_fasta(fa, np.random.default_rng(SEED))
    cli_subprocess(["index", fa, "small", str(ORACLE_K), "--device", str(dev), "--quiet"])
    kin = fa + f".{ORACLE_K:02d}.kin"
    port_kin = open(kin, "rb").read()
    port_meta = take_outputs(kin)
    oracle_write_index(fa, fa, ORACLE_K)
    if open(kin, "rb").read() != port_kin:
        raise AssertionError(f"K={ORACLE_K} .kin differs from the numpy oracle's")
    oracle_meta = take_outputs(kin)
    for key in ("num_kmers", "hist", "vals_sum", "chromosomes"):
        if port_meta[key] != oracle_meta[key]:
            raise AssertionError(f"K={ORACLE_K} .kin.json {key} differs from the oracle's")
    log(f"oracle K={ORACLE_K}: .kin identical, num_kmers {port_meta['num_kmers']}, "
        f"{len(port_meta['chromosomes'])} chromosomes")
    return fa


def pipelined_chunks(genome, k, cw):
    """The chunks the index of ``genome`` runs, in order: the pipelined
    producer over the file's bytes finds the streaming run's segment bounds.
    Returns (chunks, total bp)."""
    from pykmer_tpu_torch.io.fasta import open_input_bytes
    from pykmer_tpu_torch.host.pipeline import iter_pipelined_chunks

    sink = {}
    chunks = list(iter_pipelined_chunks(open_input_bytes(genome), k, cw, sink))
    return chunks, sink["total_bp"]


def replay(chunks, k, cw, dev, sweeps):
    """Step A of every chunk on the card; each sorted batch goes through each
    of ``sweeps`` into its own plane. Returns (planes, number of k-mers)."""
    import torch

    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes

    span = cw + k - 1
    planes = [torch.zeros(4**k // 2, dtype=torch.uint8, device=dev) for _ in sweeps]
    nk = 0
    for b, m in chunks:
        codes, nvalid = chunk_sorted_codes(
            torch.from_numpy(b).to(dev),
            None if m is None else torch.from_numpy(m).to(dev), k, span)
        for plane, sweep_fn in zip(planes, sweeps):
            sweep_fn(plane, codes)
        nk += int(nvalid)
    return planes, nk


def chunk_windows_for(genome, k, dev):
    from pykmer_tpu_torch.config import IndexConfig, resolve_chunk_windows

    return resolve_chunk_windows(IndexConfig(kmer_len=k), dev,
                                 os.path.getsize(genome)).chunk_windows


def phase_slice(work, dev):
    """The genome at SLICE_K through the CLI entry; launch count; plain replay."""
    import numpy as np

    import bench
    from pykmer_tpu_torch.utils.checksum import sha256_file
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted
    from pykmer_tpu_torch.ops.readback import unfold_canonical

    k = SLICE_K
    genome = os.path.join(work, "genome.fa")
    t0 = time.perf_counter()
    bench.make_genome(genome, GENOME_BP, seed=SEED, repeats=True)
    log(f"genome: {GENOME_BP} bp written in {time.perf_counter() - t0:.1f} s (set-up)")
    cw = chunk_windows_for(genome, k, dev)
    chunks, total_bp = pipelined_chunks(genome, k, cw)

    sweep.LAUNCHES = 0
    wall, table = run_cli(["index", genome, "s", str(k), "--device", str(dev)])
    launches = sweep.LAUNCHES
    log(table)
    log(f"index K={k}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
        f"(verify on, streaming input), {len(chunks)} chunks of {cw} windows, "
        f"{launches} sweep launches")
    if launches != len(chunks):
        raise AssertionError(f"sweep launched {launches} times for {len(chunks)} chunks")

    (plane,), nk = replay(chunks, k, cw, dev, [saturating_accumulate_sorted])
    want = unfold_canonical(plane.cpu().numpy(), k)
    del plane
    kin = genome + f".{k:02d}.kin"
    if not np.array_equal(np.fromfile(kin, dtype=np.uint8), want):
        raise AssertionError(f"K={k} .kin differs from the plain-sweep replay")
    del want
    meta = json.load(open(kin + ".json"))
    if meta["num_kmers"] != nk:
        raise AssertionError(f"num_kmers {meta['num_kmers']} != plain replay {nk}")
    if meta["vals_max"] != 255:
        raise AssertionError("the repeat families did not saturate any cell")
    sha = meta["output_file_cheksum"]
    if sha256_file(kin) != sha:
        raise AssertionError("the recorded output sha256 is not the file's")
    n_all_valid = sum(m is None for _, m in chunks)
    log(f"plain replay: .kin identical, num_kmers {nk}, vals_max 255, output "
        f"sha256 {sha} (the file's); {n_all_valid} of {len(chunks)} chunks all-valid")
    return launches, genome, chunks, cw, total_bp, sha


def phase_k15_variants(work, dev, genome, total_bp, want_sha):
    """A gzip -1 copy of the genome (read whole, then pipelined) and the host
    strategy give the streaming run's `.kin` sha256."""
    import gzip

    from pykmer_tpu_torch.ops import sweep

    k = SLICE_K
    gz = os.path.join(work, "genome_gz1.fa.gz")
    t0 = time.perf_counter()
    with open(genome, "rb") as src, gzip.open(gz, "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 16 << 20)
    log(f"gzip -1 copy: {os.path.getsize(gz)} bytes in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    for path, extra, label in ((gz, [], "gzip -1 input"),
                               (genome, ["--accumulate", "host"], "host strategy")):
        sweep.LAUNCHES = 0
        wall, table = run_cli(["index", path, "s", str(k), "--device", str(dev), *extra])
        meta = take_outputs(path + f".{k:02d}.kin")
        log(table)
        log(f"index K={k}, {label}: {total_bp} bp in {wall:.3f} s = "
            f"{total_bp / wall:.0f} bp/s (verify on), {sweep.LAUNCHES} sweep launches, "
            f"output sha256 {meta['output_file_cheksum']}")
        if meta["output_file_cheksum"] != want_sha:
            raise AssertionError(f"K={k} {label}: .kin sha256 differs from the streaming run's")
        if (sweep.LAUNCHES == 0) != (label == "host strategy"):
            raise AssertionError(f"K={k} {label}: {sweep.LAUNCHES} sweep launches")
    return gz


def chunk_step_times(dev, chunk, cw):
    """Median device ms (CUDA events) of each step of one chunk."""
    import torch

    from pykmer_tpu_torch.index.indexer import chunk_sorted_codes
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.encode import (
        canonical_codes, fold_codes, unpack_base_2bit, unpack_base_2bit_mask)
    from pykmer_tpu_torch.ops.histogram import sort_codes_fast

    k = SLICE_K
    span = cw + k - 1
    b, m = chunk

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
        "h2d_pageable_ms": median_ms(upload, 10),
        "encode_ms": median_ms(encode, 10),
        "sort_ms": median_ms(lambda: sort_codes_fast(codes), 10),
        "stepA_ms": median_ms(lambda: chunk_sorted_codes(db, dm, k, span), 10),
        "stepB_sweep_ms": median_ms(lambda: sweep.accumulate_sorted(plane, sorted_codes), 10),
    }
    log("one chunk, median device ms: " + json.dumps(times))
    del plane, codes, sorted_codes, db, dm
    torch.cuda.empty_cache()


def phase_k17_oracle(work, dev, fa):
    """Phase 3's small FASTA at K=17 through the CLI: the `.kin`'s nonzero
    cells are exactly the numpy oracle's canonical codes, clipped counts."""
    import numpy as np

    from pykmer_tpu_torch.formats.kin import iter_kin_blocks
    from pykmer_tpu_torch.io.fasta import read_fasta_codes
    from pykmer_tpu_torch.oracle.gold import oracle_canonical_codes

    k = BIG_K
    wall = cli_subprocess(["index", fa, "small", str(k), "--device", str(dev), "--quiet"])
    codes = np.concatenate([oracle_canonical_codes(r.codes, k)
                            for r in read_fasta_codes(fa)])
    want_idx, counts = np.unique(codes, return_counts=True)
    want_val = np.minimum(counts, 255)
    kin = fa + f".{k:02d}.kin"
    idx, val, off = [], [], 0
    for block in iter_kin_blocks(kin, 4**k, 1 << 30, reuse_buffer=True):
        nz = np.flatnonzero(block)
        idx.append(nz + off)
        val.append(block[nz])
        off += block.shape[0]
    meta = take_outputs(kin)
    idx, val = np.concatenate(idx), np.concatenate(val)
    if not (np.array_equal(idx, want_idx) and np.array_equal(val, want_val)):
        raise AssertionError(f"K={k} .kin nonzero cells differ from the numpy oracle's")
    if meta["num_kmers"] != codes.shape[0]:
        raise AssertionError(f"K={k} num_kmers {meta['num_kmers']} != oracle {codes.shape[0]}")
    log(f"oracle K={k}: the {off}-byte .kin holds exactly the oracle's {idx.shape[0]} "
        f"nonzero cells (num_kmers {codes.shape[0]}); CLI run {wall:.1f} s")


def device_counts256(plane):
    """256-bin histogram of a uint8 plane, on its device."""
    import torch

    counts = torch.zeros(256, dtype=torch.int64, device=plane.device)
    step = 1 << 28
    for lo in range(0, plane.shape[0], step):
        counts += torch.bincount(plane[lo : lo + step].to(torch.int32), minlength=256)
    return counts.cpu().numpy()


def phase_k17(work, dev, genome):
    """The genome at K=17 through the CLI with verify on; int64 launches ==
    chunks; replay: kernel plane == plain plane, with the `.kin`'s stats."""
    import torch

    from pykmer_tpu_torch.formats.header import stats_from_counts256
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted

    k = BIG_K
    cw = chunk_windows_for(genome, k, dev)
    chunks, total_bp = pipelined_chunks(genome, k, cw)
    log(f"disk free before K={k}: {shutil.disk_usage(work).free} bytes")
    sweep.LAUNCHES = 0
    sweep.LAUNCHES_I64 = 0
    wall, table = run_cli(["index", genome, "s", str(k), "--device", str(dev)])
    launches, launches_i64 = sweep.LAUNCHES, sweep.LAUNCHES_I64
    # create_fasta_index resets the peak at its start
    peak = torch.cuda.max_memory_allocated(dev)
    meta = take_outputs(genome + f".{k:02d}.kin")
    log(table)
    log(f"index K={k}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
        f"(verify on, streaming input), peak device memory {peak} bytes, "
        f"{len(chunks)} chunks of {cw} windows, {launches_i64} int64 sweep launches")
    if launches_i64 != len(chunks) or launches != launches_i64:
        raise AssertionError(f"K={k}: {launches_i64} int64 launches ({launches} in all) "
                             f"for {len(chunks)} chunks")

    torch.cuda.empty_cache()
    (kern, plain), nk = replay(chunks, k, cw, dev,
                               [sweep.accumulate_sorted, saturating_accumulate_sorted])
    torch.cuda.synchronize()
    if not torch.equal(kern, plain):
        raise AssertionError(f"K={k}: the kernel plane differs from the plain-sweep plane")
    err = max_abs_err(kern, plain)
    counts = device_counts256(kern)
    del kern, plain
    torch.cuda.empty_cache()
    counts[0] += 4**k // 2  # each folded cell's structural-zero partner
    stats = stats_from_counts256(counts)
    for key, val in stats.items():
        if meta[key] != val:
            raise AssertionError(f"K={k}: .kin.json {key} differs from the replay plane's")
    if meta["num_kmers"] != nk:
        raise AssertionError(f"K={k}: num_kmers {meta['num_kmers']} != replay {nk}")
    log(f"replay K={k}: kernel plane == plain plane ({4**k // 2} cells, torch.equal), "
        f"its stats and num_kmers {nk} are the .kin's, vals_max {meta['vals_max']}")
    return launches_i64, err, meta["output_file_cheksum"]


def device_blocks(n, k, n_shards=1):
    """Blocks of the device engine for ``n`` samples at ``k`` with the
    default block size (the engine's own clamp and alignment)."""
    from pykmer_tpu_torch.config import DEFAULT_BLOCK_SIZE
    from pykmer_tpu_torch.merge.merger import _aligned_block
    from pykmer_tpu_torch.ops.compare import padded_rows

    align = 8 * n_shards
    clamp = (2 << 30) * n_shards // padded_rows(n) // align * align
    block = _aligned_block(min(DEFAULT_BLOCK_SIZE, clamp), 4**k, align)
    return block, -(-4**k // block)


def merge_both(work, name, kins, dev, k):
    """``merge`` through the CLI entry in this process, with the device
    engine on the card and with the host engine; the two `.kma` matrices
    must be equal and the device engine must step once per block. Returns
    (matrix, {engine: wall seconds})."""
    from pykmer_tpu_torch.formats.kma import read_kma
    from pykmer_tpu_torch import cli
    from pykmer_tpu_torch.ops import compare

    if "PYKMER_TPU_MERGE_HBM_BYTES" in os.environ:
        raise RuntimeError("PYKMER_TPU_MERGE_HBM_BYTES is set: the block count check "
                           "assumes the default budget")
    matrices, walls = {}, {}
    for engine in ("device", "host"):
        proj = os.path.join(work, f"{name}_{engine}")
        compare.STEPS = 0
        t0 = time.perf_counter()
        rc = cli.main(["merge", proj, *kins, "--engine", engine, "--device", str(dev),
                       "--quiet"])
        walls[engine] = time.perf_counter() - t0
        steps = compare.STEPS
        if rc != 0:
            raise RuntimeError(f"merge --engine {engine} exited {rc}")
        want = device_blocks(len(kins), k)[1] if engine == "device" else 0
        if steps != want:
            raise AssertionError(f"merge --engine {engine}: {steps} device block steps, "
                                 f"expected {want}")
        kma = proj + ".001-255.kma"
        matrices[engine] = read_kma(kma)
        os.remove(kma)
        os.remove(kma + ".json")
    import numpy as np

    if not np.array_equal(matrices["device"], matrices["host"]):
        raise AssertionError(f"{name}: the device engine's .kma differs from the host's")
    return matrices["device"], walls


def check_pairs(matrix, kins, pairs, k):
    from pykmer_tpu_torch.merge import pair_counts_stream

    for i, j in pairs:
        want = pair_counts_stream(kins[i], kins[j], 4**k)
        got = tuple(int(x) for x in matrix[i, j])
        if got != want:
            raise AssertionError(f"pair ({i}, {j}): .kma {got} != pair_counts_stream {want}")


def merge_step_times(dev, n, k):
    """The device step at the engine's block shape for ``n`` samples on
    random bits: median ms of the pinned upload, the unpack, the stacked
    product and the whole step, and of the unstacked product it replaces
    (checked equal). Returns the step's ms."""
    import torch

    from pykmer_tpu_torch.ops import compare

    block, n_blocks = device_blocks(n, k)
    rows = compare.padded_rows(n)
    s = compare.segments(rows)
    g = torch.Generator(device=dev).manual_seed(SEED)
    bits = torch.randint(0, 256, (n, block // 8), dtype=torch.uint8, device=dev,
                         generator=g)
    pinned = bits.cpu().pin_memory()
    ws = compare.new_workspace(n, block, dev)
    acc = torch.zeros((n, n), dtype=torch.int64, device=dev)
    compare.unpack_validity(bits, rows, ws)
    stacked = compare.stacked_product(ws, s, torch._int_mm)
    plain = torch._int_mm(ws, ws.t())
    if not torch.equal(stacked, plain.to(torch.int64)):
        raise AssertionError("the stacked product differs from the unstacked _int_mm")
    times = {
        "n": n, "rows": rows, "segments": s, "block_cells": block, "blocks": n_blocks,
        "h2d_pinned_ms": median_ms(lambda: bits.copy_(pinned, non_blocking=True), 10),
        "unpack_ms": median_ms(lambda: compare.unpack_validity(bits, rows, ws), 10),
        "product_stacked_ms": median_ms(
            lambda: compare.stacked_product(ws, s, torch._int_mm), 10),
        "step_ms": median_ms(lambda: compare.block_contingency(acc, bits, ws), 10),
        "product_unstacked_ms": median_ms(lambda: torch._int_mm(ws, ws.t()), 3),
    }
    log("merge device step, median device ms: " + json.dumps(times))
    del bits, pinned, ws, acc, stacked, plain
    torch.cuda.empty_cache()
    return times["step_ms"]


def fabricate_kin(path_stem, kmer_len, seed, bgz=False):
    """Write a synthetic {stem}.fa.{K:02d}.kin(.bgz) + .kin.json with a
    plausible coverage distribution (Poisson-ish + saturated tail): the
    recipe of ``scripts/bench_merge_fanin.fabricate_kin``, written on the
    port's ``formats`` and ``io``."""
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


def phase_merge_fanin(work, dev):
    """N=39 at K=13 (8 .bgz): device vs host engine through the CLI entry,
    three pairs vs pair_counts_stream, the device step's time, and the
    host-vs-device crossover in N."""
    from concurrent.futures import ThreadPoolExecutor

    from pykmer_tpu_torch.merge import merge

    k, d = FANIN_K, os.path.join(work, "fanin")
    os.makedirs(d)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        kins = list(pool.map(
            lambda i: fabricate_kin(os.path.join(d, f"s{i:02d}"), k, seed=1000 + i,
                                    bgz=i < FANIN_BGZ), range(FANIN_N)))
    log(f"fan-in: {FANIN_N} K={k} samples ({FANIN_BGZ} .kin.bgz) fabricated in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    kins = sorted(kins)
    matrix, walls = merge_both(work, "fanin", kins, dev, k)
    check_pairs(matrix, kins, FANIN_PAIRS, k)
    phase_merge_sharded(work, dev, kins, k, matrix)
    streamed = FANIN_N * 4**k
    log(f"merge fan-in N={FANIN_N} K={k}: device engine {walls['device']:.3f} s, host "
        f"engine {walls['host']:.3f} s ({device_blocks(FANIN_N, k)[1]} device blocks); "
        f".kma equal, pairs {list(FANIN_PAIRS)} equal to pair_counts_stream; "
        f"{streamed / walls['device'] / 1e6:.0f} MB/s streamed by the device engine")
    step_ms = merge_step_times(dev, FANIN_N, k)

    raw = kins[FANIN_BGZ:]
    for nn in CROSSOVER_N:
        sub, got = raw[:nn], {"host": [], "device": []}
        for i, engine in enumerate(("host", "device", "device", "host")):
            t0 = time.perf_counter()
            merge(os.path.join(d, f"x{nn}_{i}"), sub, engine=engine, verbose=False,
                  device=dev)
            got[engine].append(round(time.perf_counter() - t0, 3))
        log(f"merge crossover N={nn} K={k} raw .kin: host {got['host']} s, "
            f"device {got['device']} s")
    shutil.rmtree(d)
    return step_ms


def phase_merge_sharded(work, dev, kins, k, want):
    """Phase 10c: the fan-in through ``merge(..., n_shards=4, mesh=...)`` with
    the 4 logical shards on the card: the single-device engine's matrix,
    four block steps per block."""
    import numpy as np

    from pykmer_tpu_torch.formats.kma import read_kma
    from pykmer_tpu_torch.merge import merge
    from pykmer_tpu_torch.ops import compare
    from pykmer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev] * MERGE_SHARDS)
    proj = os.path.join(work, "fanin_sharded")
    compare.STEPS = 0
    t0 = time.perf_counter()
    _, matrix = merge(proj, kins, n_shards=MERGE_SHARDS, mesh=mesh, verbose=False,
                      device=dev)
    wall = time.perf_counter() - t0
    steps = compare.STEPS
    block, n_blocks = device_blocks(len(kins), k, MERGE_SHARDS)
    if steps != MERGE_SHARDS * n_blocks:
        raise AssertionError(f"sharded merge: {steps} block steps for {n_blocks} blocks")
    kma = proj + ".001-255.kma"
    if not (np.array_equal(matrix, want) and np.array_equal(read_kma(kma), want)):
        raise AssertionError("sharded merge: the .kma differs from the single-device engine's")
    os.remove(kma)
    os.remove(kma + ".json")
    log(f"sharded merge N={len(kins)} K={k}, {MERGE_SHARDS} shards on {dev}: {wall:.3f} s, "
        f"{n_blocks} blocks of {block} cells, {steps} block steps; .kma equal to the "
        f"single-device engine's")


def perturb(kin, out, dev):
    """A seeded copy of ``kin``: nonzero counts jittered by -3..3 (clipped
    to 0..255), 2% of the empty cells set to 1, then 5% of all cells
    zeroed, so that neither sample's valid cells hold the other's."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.from_numpy(np.fromfile(kin, dtype=np.uint8)).to(dev)
    jitter = torch.randint(-3, 4, t.shape, dtype=torch.int16, device=dev, generator=g)
    fresh = (torch.rand(t.shape, device=dev, generator=g) < 0.02).to(torch.int16)
    t16 = torch.where(t > 0, t.to(torch.int16) + jitter, fresh).clamp_(0, 255)
    del jitter, fresh
    t16[torch.rand(t.shape, device=dev, generator=g) < 0.05] = 0
    t16.to(torch.uint8).cpu().numpy().tofile(out)
    del t, t16
    torch.cuda.empty_cache()


def phase_merge_pair(work, dev, genome):
    """Phase 4's K=15 `.kin` and a perturbation of it: device engine vs host
    engine vs pair_counts_stream. Both files are removed."""
    from pykmer_tpu_torch.merge import pair_counts_stream

    k = SLICE_K
    kin = genome + f".{k:02d}.kin"
    pert = os.path.join(work, f"pert.fa.{k:02d}.kin")
    t0 = time.perf_counter()
    perturb(kin, pert, dev)
    shutil.copyfile(kin + ".json", pert + ".json")
    log(f"merge pair: perturbed copy written in {time.perf_counter() - t0:.1f} s (set-up)")
    kins = sorted([kin, pert])
    matrix, walls = merge_both(work, "pair", kins, dev, k)
    want = pair_counts_stream(kins[0], kins[1], 4**k)
    if tuple(int(x) for x in matrix[0, 1]) != want or want[2] in (0, min(want[:2])):
        raise AssertionError(f"merge pair: {matrix[0, 1]} vs pair_counts_stream {want}")
    streamed = 2 * 4**k
    log(f"merge pair K={k}: device engine {walls['device']:.3f} s "
        f"({streamed / walls['device'] / 1e6:.0f} MB/s streamed), host engine "
        f"{walls['host']:.3f} s ({streamed / walls['host'] / 1e6:.0f} MB/s); .kma "
        f"equal, (a, b, shared) = {want} = pair_counts_stream")
    for p in (kin, pert):
        os.remove(p)
        os.remove(p + ".json")


def phase_serve(work, dev, genome, gz, want_sha, want_kmers):
    """``serve --warmup-k 15`` in a subprocess: index the genome and its gzip
    copy, a failing index, merge, distance, shutdown."""
    from pykmer_tpu_torch.formats.kma import read_kma
    from pykmer_tpu_torch.utils.checksum import sha256_file

    k = SLICE_K
    kins = [p + f".{k:02d}.kin" for p in (genome, gz)]
    proj = os.path.join(work, "served")
    kma = proj + ".001-255.kma"
    reqs = [
        {"cmd": "ping"},
        {"cmd": "index", "input": genome, "sample": "s", "kmer_len": k},
        {"cmd": "index", "input": gz, "sample": "g", "kmer_len": k},
        {"cmd": "index", "input": os.path.join(work, "missing.fa"), "sample": "x",
         "kmer_len": k},
        {"cmd": "merge", "project": proj, "indexes": kins},
        {"cmd": "distance", "matrix_file": kma},
        {"cmd": "shutdown"},
    ]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pykmer_tpu_torch", "serve", "--warmup-k", str(k),
         "--device", str(dev)],
        input="".join(json.dumps(r) + "\n" for r in reqs), cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"serve exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    resps = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    oks = [r.get("ok") for r in resps]
    if [r.get("cmd") for r in resps] != [r["cmd"] for r in reqs] \
            or oks != [True, True, True, False, True, True, True]:
        raise AssertionError(f"serve replies: {resps}")
    for r, kin in zip(resps[1:3], kins):
        if r["output"] != kin or r["num_kmers"] != want_kmers:
            raise AssertionError(f"serve index reply {r}")
        if sha256_file(kin) != want_sha:
            raise AssertionError(f"served {kin}: sha256 differs from phase 4's")
    if resps[4]["samples"] != 2 or "error" not in resps[3]:
        raise AssertionError(f"serve replies: {resps}")
    m = read_kma(kma)
    if not (m[0, 1, 0] == m[0, 1, 1] == m[0, 1, 2] > 0):
        raise AssertionError(f"served merge of two equal samples: {m[0, 1]}")
    if not os.path.exists(kma + ".dist.jaccard.npz"):
        raise AssertionError("served distance wrote no .dist.jaccard.npz")
    log(f"serve: {len(reqs)} requests answered as expected in {wall:.1f} s (process "
        f"start and warmup included); index seconds: genome {resps[1]['seconds']}, "
        f"gzip -1 copy {resps[2]['seconds']}; merge {resps[4]['seconds']} s, distance "
        f"{resps[5]['seconds']} s; both .kin sha256 {want_sha}")
    for kin in kins:
        os.remove(kin)
        os.remove(kin + ".json")


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


class _Stop(Exception):
    """Raised by the checkpoint hook to cut a sharded run after a save."""


def sharded_frames(genome, k, cw):
    """The genome decoded whole and framed as the sharded index frames it:
    (padded stream, number of chunks)."""
    from pykmer_tpu_torch.io.fasta import open_input_bytes
    from pykmer_tpu_torch.host.chunks import chunk_stream
    from pykmer_tpu_torch.host.decode import decode_joined_bytes

    stream, _, _ = decode_joined_bytes(open_input_bytes(genome), k, tail_headroom=cw + k)
    return chunk_stream(stream, k, cw)


def run_sharded(genome, k, mesh, label, total_bp, want_sha, n_chunks, **kw):
    """``create_fasta_index_sharded`` over ``mesh`` with verify on and the
    stage table on: the `.kin` sha256 must be ``want_sha`` and the sweep
    launched (R·S)^2 times per step it ran. Returns (wall s, launches)."""
    import torch

    from pykmer_tpu_torch.index import create_fasta_index_sharded
    from pykmer_tpu_torch.ops import sweep

    rows = len(mesh.devices) * len(mesh.devices[0])
    n_steps = -(-n_chunks // rows)
    first = kw.pop("first_step", 0)
    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    err = io.StringIO()
    sweep.LAUNCHES = sweep.LAUNCHES_I64 = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            create_fasta_index_sharded(genome, "s", genome, k, mesh=mesh, verbose=False, **kw)
    finally:
        os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    wall = time.perf_counter() - t0
    launches, launches_i64 = sweep.LAUNCHES, sweep.LAUNCHES_I64
    peak = torch.cuda.max_memory_allocated(mesh.first)
    meta = take_outputs(genome + f".{k:02d}.kin")
    log(err.getvalue().rstrip())
    log(f"sharded index K={k}, {label}: {total_bp} bp in {wall:.3f} s = "
        f"{total_bp / wall:.0f} bp/s (verify on), {n_steps - first} steps of {rows} rows "
        f"x {SHARD_CW} windows, {launches} sweep launches ({launches_i64} int64), peak "
        f"device memory {peak} bytes, output sha256 {meta['output_file_cheksum']}")
    if meta["output_file_cheksum"] != want_sha:
        raise AssertionError(f"sharded K={k} {label}: .kin sha256 differs from the "
                             f"single-device run's")
    if launches != (n_steps - first) * rows * rows:
        raise AssertionError(f"sharded K={k} {label}: {launches} sweep launches, expected "
                             f"{(n_steps - first) * rows * rows}")
    return wall, launches


def sharded_step_times(dev, mesh_shape, rows_np):
    """One K=15 step on a mesh of logical shards on ``dev``: median device ms
    (CUDA events) of the whole step, one position's bucket (encode, key,
    sort, gather), the exchange, and shard 0's received rows applied by one
    sweep launch per row, by the plain sweep per row, and by one re-sort and
    one launch (the three planes checked equal)."""
    import torch

    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted, sort_codes_fast
    from pykmer_tpu_torch.parallel import histogram, make_mesh

    n_data, n_shards = mesh_shape
    mesh = make_mesh(n_shards, n_data, devices=[dev] * (n_data * n_shards))
    init, step = histogram.make_sharded_accumulate(mesh, SLICE_K, SHARD_CW)
    state = init()
    bases, mask = (torch.from_numpy(a[0]).to(dev) for a in rows_np)
    sends = [[step.bucket(bases, mask)[0] for _ in row] for row in mesh.devices]
    received = step.exchange(sends)[0][0]
    rows = list(received)
    planes = [torch.zeros(step.local_size, dtype=torch.uint8, device=dev) for _ in range(3)]
    for row in rows:
        sweep.accumulate_sorted(planes[0], row)
        saturating_accumulate_sorted(planes[1], row)
    sweep.accumulate_sorted(planes[2], sort_codes_fast(received.reshape(-1)))
    torch.cuda.synchronize()
    if not (torch.equal(planes[0], planes[1]) and torch.equal(planes[0], planes[2])):
        raise AssertionError(f"mesh {mesh_shape}: per-row, plain and re-sorted sweeps differ")
    times = {
        "mesh": f"{n_data}x{n_shards}",
        "rows": len(rows), "capacity": step.capacity,
        "step_ms": median_ms(lambda: step(state, rows_np), 5),
        "bucket_ms": median_ms(lambda: step.bucket(bases, mask), 10),
        "exchange_ms": median_ms(lambda: step.exchange(sends), 10),
        "rows_kernel_ms": median_ms(lambda: [sweep.accumulate_sorted(planes[0], r)
                                             for r in rows], 10),
        "rows_plain_ms": median_ms(lambda: [saturating_accumulate_sorted(planes[1], r)
                                            for r in rows], 5),
        "resort_kernel_ms": median_ms(lambda: sweep.accumulate_sorted(
            planes[2], sort_codes_fast(received.reshape(-1))), 10),
    }
    times["rows_kernel_ms_2"] = median_ms(
        lambda: [sweep.accumulate_sorted(planes[0], r) for r in rows], 10)
    times["rows_bound_ms"] = sweep_bound_ms(rows, step.local_size)[0]
    log("sharded step, median device ms: " + json.dumps(times))
    del state, planes, sends, received, rows, bases, mask
    torch.cuda.empty_cache()
    return times


def phase_sharded_k15(work, dev, genome, total_bp, want_sha):
    """Phase 10a: the genome at K=15 over 1x4 and 2x2 meshes of logical
    shards on the card, a checkpointed run cut and resumed, and the CLI's
    ``index --shards <card count>``; every `.kin` sha256 phase 4's."""
    import torch

    from pykmer_tpu_torch.index import sharded as sharded_mod
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.parallel import histogram, make_mesh, multihost

    k = SLICE_K
    padded, n_chunks = sharded_frames(genome, k, SHARD_CW)
    results = {}
    for n_data, n_shards in SHARD_MESHES:
        mesh = make_mesh(n_shards, n_data, devices=[dev] * (n_data * n_shards))
        label = f"mesh {n_data}x{n_shards} on {dev}"
        results[label] = run_sharded(genome, k, mesh, label, total_bp, want_sha, n_chunks)

    mesh = make_mesh(4, devices=[dev] * 4)
    real_save, saves = multihost.save_shard_checkpoint, []

    def save_then_stop(*args, **kwargs):
        real_save(*args, **kwargs)
        saves.append(kwargs["next_step"])
        if len(saves) == 2:
            raise _Stop()

    sharded_mod.multihost.save_shard_checkpoint = save_then_stop
    t0 = time.perf_counter()
    try:
        sharded_mod.create_fasta_index_sharded(genome, "s", genome, k, mesh=mesh,
                                               checkpoint_every=1, verbose=False)
        raise AssertionError("the checkpointed run was not cut at its second save")
    except _Stop:
        pass
    finally:
        sharded_mod.multihost.save_shard_checkpoint = real_save
    log(f"sharded index K={k}, checkpoint every step: cut after the saves at steps "
        f"{saves} in {time.perf_counter() - t0:.3f} s")
    tmp = genome + f".{k:02d}.kin.tmp"
    results["resumed"] = run_sharded(genome, k, mesh, "resumed at step 2, mesh 1x4",
                                     total_bp, want_sha, n_chunks, first_step=saves[-1])
    if multihost.load_shard_checkpoint(tmp) is not None:
        raise AssertionError("the resumed run left its checkpoint behind")

    n_cards = torch.cuda.device_count()
    sweep.LAUNCHES = 0
    wall, table = run_cli(["index", genome, "s", str(k), "--shards", str(n_cards),
                           "--device", str(dev), "--quiet"])
    launches = sweep.LAUNCHES
    meta = take_outputs(genome + f".{k:02d}.kin")
    log(table)
    steps = -(-n_chunks // n_cards)
    log(f"sharded index K={k} via the CLI, --shards {n_cards}: {total_bp} bp in "
        f"{wall:.3f} s = {total_bp / wall:.0f} bp/s (verify on), {launches} sweep launches")
    if meta["output_file_cheksum"] != want_sha or launches != steps * n_cards**2:
        raise AssertionError(f"CLI --shards {n_cards}: sha256 or {launches} launches off")

    rows = histogram.shard_batch_chunks_packed(padded, k, SHARD_CW, 4, n_chunks // 8)
    del padded
    times = [sharded_step_times(dev, shape, rows) for shape in SHARD_MESHES]
    return results, times, rows


def phase_sharded_vs_cpu(dev, rows):
    """Phase 10d: one K=15 step (4 rows of 2^22 windows) on ``[cuda:0] * 4``
    and on ``[cpu] * 4``: torch.equal shards, num_valid and max_bucket."""
    import torch

    from pykmer_tpu_torch.parallel import histogram, make_mesh

    out = []
    for mesh in (make_mesh(devices=[dev] * 4), make_mesh(4, device="cpu")):
        init, step = histogram.make_sharded_accumulate(mesh, SLICE_K, SHARD_CW)
        t0 = time.perf_counter()
        planes, nk, maxb = step(init(), rows)
        out.append(([p.cpu() for p in planes[0]], int(nk), int(maxb)))
        log(f"sharded step on {mesh.first} x4: {time.perf_counter() - t0:.3f} s wall, "
            f"num_valid {int(nk)}, max_bucket {int(maxb)} (capacity {step.capacity})")
    if out[0][1:] != out[1][1:] or not all(
            torch.equal(a, b) for a, b in zip(out[0][0], out[1][0])):
        raise AssertionError("the sharded step on the card differs from the CPU mesh's")
    err = max(max_abs_err(a, b) for a, b in zip(out[0][0], out[1][0]))
    log(f"sharded step: the card's 4 shards torch.equal to the CPU mesh's, "
        f"num_valid and max_bucket equal (max abs err {err})")
    return err


def phase_sharded_k17(dev, genome, total_bp, want_sha):
    """Phase 10b: the genome at K=17 over 8 logical shards on the card (eight
    1 GiB planes, int32 local codes), then over 4 (2 GiB planes, int64 local
    codes); each `.kin` sha256 phase 6's."""
    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.parallel import make_mesh

    k = BIG_K
    _, n_chunks = sharded_frames(genome, k, SHARD_CW)
    for n_shards in K17_SHARDS:
        mesh = make_mesh(devices=[dev] * n_shards)
        _, launches = run_sharded(genome, k, mesh, f"mesh 1x{n_shards} on {dev}",
                                  total_bp, want_sha, n_chunks)
        want_i64 = launches if 4**k // 2 // n_shards > 2**31 - 1 else 0
        if sweep.LAUNCHES_I64 != want_i64:
            raise AssertionError(f"K={k} over {n_shards} shards: {sweep.LAUNCHES_I64} int64 "
                                 f"launches of {launches}, expected {want_i64}")


def mh_worker(argv):
    """Worker mode (``--mh-worker <pid> <nproc> <port> <input> <K>``): one
    process of a multi-host build on ``cuda:0`` through
    ``create_fasta_index_multihost``, verify on; prints one JSON line of its
    wall, the sweep's launches, peak device memory and peak host RSS
    (sampled). Its stage table goes to stderr (``PYKMER_TPU_STAGE_TIMING``,
    set by the caller)."""
    import torch

    from pykmer_tpu_torch.index import create_fasta_index_multihost
    from pykmer_tpu_torch.ops import sweep

    peak_rss = rss_sampler()
    pid, nproc, port, path, k = int(argv[0]), int(argv[1]), argv[2], argv[3], int(argv[4])
    dev = torch.device("cuda", 0)
    sweep.LAUNCHES = sweep.LAUNCHES_I64 = 0
    t0 = time.perf_counter()
    header = create_fasta_index_multihost(
        path, "s", path, k, coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
        process_id=pid, verbose=False, device=dev, local_devices=[dev])
    wall = time.perf_counter() - t0
    launches, launches_i64 = sweep.LAUNCHES, sweep.LAUNCHES_I64
    print(json.dumps({
        "pid": pid, "wall_s": wall, "launches": launches, "launches_i64": launches_i64,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "peak_rss_bytes": peak_rss(),  # sampled every 50 ms
        "header": header is not None,
    }), flush=True)
    return 0


def rss_sampler(period_s=0.05):
    """Start sampling this process's resident set from ``/proc/self/statm``
    every ``period_s``; returns a function giving the peak in bytes so far,
    or None where statm cannot be read. (``ru_maxrss`` keeps the parent's
    high-water mark across fork and exec, and the card's machine shows no
    ``VmHWM``.)"""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    peak = [None]

    def sample():
        while True:
            try:
                with open("/proc/self/statm") as fh:
                    rss = int(fh.read().split()[1]) * page
            except (OSError, ValueError, IndexError):
                return
            peak[0] = max(peak[0] or 0, rss)
            time.sleep(period_s)

    threading.Thread(target=sample, daemon=True).start()
    return lambda: peak[0]


def run_job(argvs, work, label, env_extra=None):
    """The processes of one multi-host job, ``python <argv>`` each, from the
    checkout: all started together, waited for, the rest killed 20 s after
    one fails and all at ``MH_TIMEOUT_S``; no process outlives the call.
    Raises unless every process exits 0. Returns (wall s, [(stdout,
    stderr)])."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env_extra or {}))
    logs = [[open(os.path.join(work, f"mh{i}.{tag}"), "w+") for tag in ("out", "err")]
            for i in range(len(argvs))]
    procs = []
    t0 = time.perf_counter()
    try:
        for argv, (out, err) in zip(argvs, logs):
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                          stdout=out, stderr=err))
        t_end = t0 + MH_TIMEOUT_S
        while any(p.poll() is None for p in procs) and time.perf_counter() < t_end:
            if any(p.poll() not in (None, 0) for p in procs):
                t_end = min(t_end, time.perf_counter() + 20)
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for out, err in logs:
        texts.append(tuple(f.seek(0) or f.read() for f in (out, err)))
        out.close()
        err.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * len(procs):
        raise RuntimeError(f"multi-host {label}: exit codes {rcs}\n" + "\n".join(
            f"--- process {i}:\n{o[-2000:]}\n{e[-3000:]}" for i, (o, e) in enumerate(texts)))
    return wall, texts


def mh_frames(genome, pid, k, cw):
    """Process ``pid``'s share of a multi-host job over ``genome``: its
    record-aligned byte range, decoded and framed as the job frames it.
    Returns (padded stream, number of chunks), or (None, 0) for no k-mer."""
    import numpy as np

    from pykmer_tpu_torch.host.chunks import chunk_stream
    from pykmer_tpu_torch.host.decode import decode_joined_bytes
    from pykmer_tpu_torch.parallel.multihost import host_byte_slice

    lo, hi = host_byte_slice(genome, pid, MH_PROCESSES)
    with open(genome, "rb") as fh:
        fh.seek(lo)
        stream, _, _ = decode_joined_bytes(np.frombuffer(fh.read(hi - lo), np.uint8), k,
                                           tail_headroom=cw + k)
    return chunk_stream(stream, k, cw) if stream.shape[0] >= k else (None, 0)


def mh_rows_times(dev, genome, k, cw):
    """Process 0's received rows of one step of the K=15 job (its byte
    range's middle step, a one-card local mesh): one sweep launch per row on
    a zeroed local plane against the plain sweep (checked equal), median
    device ms (CUDA events). Returns (max abs err, kernel ms, plain ms,
    bound ms)."""
    import torch

    from pykmer_tpu_torch.ops import sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted
    from pykmer_tpu_torch.parallel import histogram, make_mesh

    padded, n_chunks = mh_frames(genome, 0, k, cw)
    mesh = make_mesh(devices=[dev])
    _, step = histogram.make_sharded_accumulate(mesh, k, cw)
    bases, mask = (torch.from_numpy(a[0]).to(dev) for a in histogram.shard_batch_chunks_packed(
        padded, k, cw, step.rows, n_chunks // 2))
    rows = list(step.exchange([[step.bucket(bases, mask)[0]]])[0][0])
    planes = [torch.zeros(step.local_size, dtype=torch.uint8, device=dev) for _ in range(2)]
    for row in rows:
        sweep.accumulate_sorted(planes[0], row)
        saturating_accumulate_sorted(planes[1], row)
    torch.cuda.synchronize()
    err = max_abs_err(planes[0], planes[1])
    if err:
        raise AssertionError(f"multi-host rows: kernel != plain (max abs err {err})")
    t_kernel = [median_ms(lambda: [sweep.accumulate_sorted(planes[0], r) for r in rows], 10)]
    t_plain = [median_ms(lambda: [saturating_accumulate_sorted(planes[1], r) for r in rows], 5)]
    t_kernel.append(median_ms(lambda: [sweep.accumulate_sorted(planes[0], r) for r in rows], 10))
    bound, sectors, moved = sweep_bound_ms(rows, step.local_size)
    log(f"multi-host rows, process 0's step {n_chunks // 2} of {n_chunks}: {len(rows)} row(s) "
        f"of {rows[0].numel()} {rows[0].dtype} codes on a {step.local_size}-cell plane, kernel "
        f"== plain; median ms kernel {t_kernel}, plain {t_plain}; bound {bound:.4f} ms "
        f"({sectors} distinct sectors, {moved} bytes)")
    del planes, rows, bases, mask
    torch.cuda.empty_cache()
    return err, min(t_kernel), min(t_plain), bound


def phase_multihost(work, dev, genome, gz, total_bp, sha15, sha17):
    """Phase 11: two processes of one gloo job on the one card. (a) K=15
    through the CLI, then in worker mode; (b) the gzip -1 copy through the
    CLI; (c) K=17 in worker mode. Returns (summed K=15 launches, the rows'
    (err, ms, plain ms, bound ms))."""
    import glob

    import torch

    from pykmer_tpu_torch.index.sharded import SHARDED_CHUNK_WINDOWS as cw

    torch.cuda.empty_cache()  # the card's memory goes to the workers
    n = MH_PROCESSES
    timing = {"PYKMER_TPU_STAGE_TIMING": "1"}

    def log_tables(label, texts):
        for pid, (_, err) in enumerate(texts):
            log(f"multi-host {label}, process {pid}: "
                + "\n".join(ln for ln in err.splitlines() if "socket.cpp" not in ln))

    def cli_job(path, k, label):
        port = free_port()
        wall, texts = run_job(
            [["-m", "pykmer_tpu_torch", "index", path, "s", str(k), "--quiet",
              "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
              "--process-id", str(pid)] for pid in range(n)],
            work, label, env_extra=timing)
        meta = take_outputs(path + f".{k:02d}.kin")
        log_tables(label, texts)
        log(f"multi-host {label}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
            f"({n} processes on {dev}, started together; verify on), output sha256 "
            f"{meta['output_file_cheksum']}")
        return meta

    def worker_job(k, label, want_sha):
        port = free_port()
        wall, texts = run_job(
            [[os.path.join(ROOT, "chip_smoke.py"), "--mh-worker", str(pid), str(n), str(port),
              genome, str(k)] for pid in range(n)], work, label, env_extra=timing)
        meta = take_outputs(genome + f".{k:02d}.kin")
        res = [json.loads(out.strip().splitlines()[-1]) for out, _ in texts]
        log_tables(label, texts)
        for r in res:
            log(f"multi-host {label}, process {r['pid']}: " + json.dumps(r))
        # a one-card local mesh (R·S = 1): one received row a step, a step a chunk
        steps = [mh_frames(genome, pid, k, cw)[1] for pid in range(n)]
        launches = sum(r["launches"] for r in res)
        launches_i64 = sum(r["launches_i64"] for r in res)
        log(f"multi-host {label}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
            f"(verify on), steps per process {steps}, {launches} sweep launches "
            f"({launches_i64} int64), output sha256 {meta['output_file_cheksum']}")
        if meta["output_file_cheksum"] != want_sha:
            raise AssertionError(f"multi-host {label}: .kin sha256 differs from the "
                                 f"single-card run's")
        want_i64 = sum(steps) if 4**k // 2 > 2**31 - 1 else 0
        if launches != sum(steps) or launches_i64 != want_i64 \
                or [r["header"] for r in res] != [True] + [False] * (n - 1):
            raise AssertionError(f"multi-host {label}: {launches} launches ({launches_i64} "
                                 f"int64) for steps {steps}")
        return launches, res

    meta = cli_job(genome, SLICE_K, f"K={SLICE_K} via the CLI")
    if meta["output_file_cheksum"] != sha15:
        raise AssertionError("multi-host K=15 via the CLI: .kin sha256 differs from phase 4's")
    launches, _ = worker_job(SLICE_K, f"K={SLICE_K} worker mode", sha15)
    meta = cli_job(gz, SLICE_K, f"K={SLICE_K} gzip -1 copy via the CLI")
    left = glob.glob(gz + ".*.inflated.tmp*")
    if meta["output_file_cheksum"] != sha15 or left:
        raise AssertionError(f"multi-host gzip -1 copy: sha256 or staged files {left}")
    os.remove(gz)
    log(f"disk free before the K={BIG_K} multi-host run: {shutil.disk_usage(work).free} bytes")
    worker_job(BIG_K, f"K={BIG_K} worker mode", sha17)
    return launches, mh_rows_times(dev, genome, SLICE_K, cw)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    sys.modules["jax"] = None  # any jax import below fails loudly
    if sys.argv[1:2] == ["--mh-worker"]:
        sys.path.insert(0, ROOT)
        return mh_worker(sys.argv[2:])
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
    t_start = t0 = time.perf_counter()
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
        k15_sweep, k17_sweep = phase_kernels(dev)
        phase_merge_fanin(work, dev)
        small_fa = phase_oracle(work, dev)
        launches, genome, chunks, cw, total_bp, sha = phase_slice(work, dev)
        gz = phase_k15_variants(work, dev, genome, total_bp, sha)
        chunk_step_times(dev, chunks[len(chunks) // 2], cw)
        del chunks
        profiled_run(dev, genome, total_bp)
        num_kmers = json.load(open(genome + f".{SLICE_K:02d}.kin.json"))["num_kmers"]
        phase_merge_pair(work, dev, genome)  # removes the K=15 .kin
        phase_serve(work, dev, genome, gz, sha, num_kmers)
        sharded, step_times, rows = phase_sharded_k15(work, dev, genome, total_bp, sha)
        sharded_err = phase_sharded_vs_cpu(dev, rows)
        del rows
        phase_k17_oracle(work, dev, small_fa)
        launches_i64, replay_err, k17_sha = phase_k17(work, dev, genome)
        phase_sharded_k17(dev, genome, total_bp, k17_sha)
        mh_launches, mh_rows = phase_multihost(work, dev, genome, gz, total_bp, sha, k17_sha)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    rows_1x4 = step_times[0]
    for name, n, (err, ms, plain_ms, bound_ms) in (
            ("sweep_sorted", launches, k15_sweep),
            ("sweep_sorted_i64", launches_i64,
             (max(k17_sweep[0], replay_err), *k17_sweep[1:])),
            # the sharded path's launches (the 1x4 run); times: one shard's 4
            # received rows of one step, one launch each, kernel vs plain
            ("sweep_sorted_sharded_rows", sharded[f"mesh 1x4 on {dev}"][1],
             (sharded_err, min(rows_1x4["rows_kernel_ms"], rows_1x4["rows_kernel_ms_2"]),
              rows_1x4["rows_plain_ms"], rows_1x4["rows_bound_ms"])),
            # the multi-host path's launches (the K=15 worker-mode job, summed
            # over its processes); times: process 0's received rows of one step
            ("sweep_sorted_multihost", mh_launches, mh_rows)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pykmer_tpu_torch/csrc/sweep.cu",
            "replaces": "pykmer_tpu/ops/pallas_hist.py:259",
            "launches": n,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            # no PyTorch call computes a saturating uint8 accumulate
            "library_ms": None,
        })
    log(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
