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
   the bands, int64 codes above 2^31) and of the encode kernels (K from 1 to
   31, ragged spans, the fused count, planes at every byte offset 0..15, an
   all-invalid chunk, invalid bases, the halo encoder):
   ``tests/test_torch_cuda.py -k "test_kernel_ or test_encode_kernel_"``,
   in a pytest subprocess;
2b. the encode kernels vs their plain torch versions on the card, with
   ``torch.equal``: 2^24-window chunks at K=15 (int32), 17 and 19 (int64),
   the packed entry on masked and all-valid planes (its fused valid-window
   count equal to the plain count) and the bases entry with and without
   invalid bases; median kernel and plain times beside the kernel's bound
   (the planes read once and the codes written once, at 3.35 TB/s); then
   ``scripts/bench_encode_variants.py``'s comparison in this process: both
   entries timed beside their earlier design (``scripts/encode_variants.cu``,
   built by its own nvcc started beside the port's), each checked against
   the plain encoder, and the SASS instructions of each encode kernel where
   ``cuobjdump`` is present; then the halo encoder at K=15 and K=19 on
   ``[cuda:0] * 8`` against ``[cpu] * 8``, one bases-kernel launch per
   shard;
2c. part D of ``scripts/certify_k19_torch.py``: the K=19 fixture's sorted
   folded int64 codes swept into a 2^22-cell window plane at bases across
   the 2^37-cell range (one above 2^32), one int64 kernel launch a window,
   every touched cell the numpy oracle's count, no other cell nonzero, one
   cell saturated;
3. oracle: a small FASTA (Ns, several records, an empty one) indexed at K=11
   through ``python -m pykmer_tpu_torch index`` gives the `.kin` and stats of
   the port's copy of the numpy oracle (``pykmer_tpu_torch.oracle``);
4. the slice at real size: a seeded 256 Mbp genome with repeat families,
   indexed at K=15 through the CLI entry point with verify on (the streaming
   pipeline); the kernel's launch count equals the count of chunks the
   pipeline frames, and so does the packed encode kernel's, and the card's
   FASTA decode launches once for each record-aligned segment, and the
   file-order unfold of the raw tail once for each 64 Mi-byte slice of the
   `.kin`; a replay of the same chunks with the plain encoder and the plain sweep gives the same
   `.kin` byte for byte; a gzip -1 copy of the genome (the pipelined path
   that reads the input whole) and the host strategy (one encode launch a
   chunk, no sweep) give the same `.kin` sha256; then the readback modes on
   the replay's plane:
   ``fetch_dense`` in every mode ``torch.equal`` to the plane, the escape
   counts and the JAX package's choice (``packing.pick_mode``), and each
   device op of the modes timed with CUDA events;
4a. the card's FASTA decode (``ops/fasta.decode_packed``, ``csrc/fasta.cu``)
   on each of those segments and on one steady-state segment (the records
   up to the first record start past ``TARGET_SEGMENT``, 192 MiB), against
   its plain torch version on the CPU copy of the same bytes: planes,
   ``n_codes`` and record table equal; its median time on the card beside
   its byte bound (the raw bytes read once and the planes written once, at
   3.35 TB/s), and the plain version's on the card;
4c. the card's file-order unfold (``ops/unfold.unfold_file``,
   ``csrc/unfold.cu``) on the replay's plane against its plain torch version
   on the card, on the 64 Mi-byte slice of the file below its middle (with
   the 256-bin counts) and the mirror slice above it: bytes and counts
   equal; each one's median time beside its byte bound (the slice's folded
   cells read once and its bytes written once, at 3.35 TB/s), and the plain
   version's;
4d. a BGZF copy of the genome (what bgzip writes) through
   ``create_fasta_index`` on the card, which inflates its blocks there
   (``ops/inflate.inflate_bgzf``, ``csrc/inflate.cu``): the `.kin` sha256
   phase 4's, the input sha256 the compressed file's, one inflate launch
   for each run of ``host/segments.bgzf_runs`` and every ``bgzf inflate``
   span's blocks counted as the card's; then the kernel over every block of
   the file in one launch against the host's zlib on the same bytes, output
   and statuses equal, its median time beside its byte bound (the
   compressed bytes read once and the inflated bytes written once, at
   3.35 TB/s) and zlib's on one host thread;
4e. the genome at K=15 through ``create_fasta_index(..., bgzip=True)`` on
   the card: the finish deflates the plane it holds on the card
   (``ops/deflate.deflate_bgzf``, ``csrc/deflate.cu``), one launch and one
   ``bgzf deflate`` span a run of ``index/bgzip.CARD_RUN_BLOCKS`` blocks,
   every block in ``card_blocks`` and no ``kin read``; the `.kin` sha256
   phase 4's, the `.kin.bgz` and `.gzi` ``io/bgzf.bgzip_kin``'s byte for
   byte; then the kernels alone over the `.kin`, their median time beside
   their byte bound (the file read once and the members written once, at
   3.35 TB/s) and ``bgzip_kin``'s on the host;
4b. the genome at K=15 in this process through ``create_fasta_index`` with
   ``IndexConfig(readback=...)`` raw, packed, 2bit, 3bit, sparse, raw again:
   each `.kin` sha256 phase 4's, each stage table logged, and whether the
   sparse run's segments overflowed the token caps and took the 2-bit
   fallback;
5. where the time goes: one chunk's steps timed with CUDA events
   (``scripts/bench_device_step_torch.step_times``: the uploads, the encode
   kernel with its fused count and the plain encode, the sort, step A, the
   sweep, A+B, beside the kernels' bounds), then a
   second index run of the genome under ``torch.profiler``, whose device
   activity (kernels and copies, overlaps merged) gives the busy and idle
   shares of its wall time;
5b. ``bench_gpu.py`` in a subprocess at a reduced schedule on the genome
   (K=15, one run a leg, no spaced runs, the K=17 leg off; the merge pair,
   the device step and the fan-in over phase 7's samples): it exits 0, every
   `.kin` sha256 of its runs is phase 4's, and its launch counts show the
   sweep and the encode kernel ran;
6. K=17 (an 8 GiB folded plane on the card, int64 codes): phase 3's small
   FASTA through the CLI, every nonzero cell of its 16 GiB `.kin` equal to
   the sparse numpy oracle's counts and no other cell nonzero; then the
   genome through the CLI with verify on (``readback="auto"``: the pieces
   tail), with its stage table, bp/s and peak device memory; the int64
   launches of the sweep and of the encode kernel equal the chunk count, the
   FASTA decode's the segment count, and
   a replay of the same chunks (plain encoder) gives a kernel plane equal to
   the plain-sweep plane
   (``torch.equal`` on the card) whose stats are the `.kin`'s; the readback
   modes on that plane as in phase 4. Each 16 GiB `.kin` is removed as soon
   as it is checked;
6b. the genome at K=17 in a fresh process each (``--index-worker``:
   ``create_fasta_index``), ``readback="raw"`` and then ``readback="sparse"``,
   which takes the arena-free pieces tail: each `.kin` sha256 phase 6's,
   each stage table, wall time, peak device memory and sampled peak host RSS
   logged, the pieces run's peak device memory at most the raw run's plus
   1 GiB;
7. merge fan-in at the reference's workload shape: 39 synthetic K=13
   samples, 8 of them `.kin.bgz` (``scripts/bench_merge_fanin_torch``'s
   ``ensure_fanin_inputs``: the recipe of ``scripts/bench_merge_fanin.py``
   on the port's ``formats``, seeds 1000+i), merged through the CLI entry
   with the device engine on the card and with the host engine: equal `.kma` matrices, three pairs equal to
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
   sha256 equal to phase 4's, the sweep launched (R·S)^2 times per step and
   the encode kernel once per position per step, the unfold once a slice of
   the file;
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
   sha256 of (a) and (b) is phase 4's and of (c) phase 6's; the sweep's
   launches summed over the processes equal the steps of each process's
   byte range times (R·S)^2, the encode kernel's the steps times R·S; process 0's received rows of one step are timed kernel
   against plain; each process's wall and stage table are logged, and at
   K=17 its peak device memory and peak host RSS. A worker that fails or
   times out fails the phase, and every worker is reaped;
12. a JSON line of the kernels (the sweep's four rows, the encode
   kernels' four, the FASTA decode's one, the unfold's one, the inflate's
   one), then the last line
   ``{"ok": true, "device": {...}}``.

Phase 2b runs after phase 2, then 2c; 4c inside phase 4, after its readback
modes; 4d after phase 4a and the gzip copy, then 4e; phases 7-9 between phases 2c and 3
(7, with 10c) and after phase 5b (8, 9); 10a and 10d run after phase 9, 10b
after phase 6b, 11 after 10b. The script exits non-zero, printing no result, where CUDA is unavailable or
outside a checkout of the repository. It never imports jax. Scratch files go
under ``build/smoke`` (git-ignored) and are removed at the end. It needs
about 35 GiB of free disk there (two 1 GiB K=15 files, one 16 GiB K=17 file
at a time) and 60 GiB of host memory (phase 11c: two processes, each with
its 8 GiB partial plane and 4 GiB of combined pieces; phase 4a's plain decode
of its steady-state segment takes about 32 GiB, on the host and on the card).
"""

import contextlib
import io
import json
import os
import shutil
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
ENCODE_K = (15, 17, 19)  # phase 2b: int32 codes, then int64 (K=19's are the halo's)
ENCODE_WINDOWS = 1 << 24  # windows per chunk on CUDA at every K
HALO_K, HALO_SHARDS, HALO_SHARD_LEN = 19, 8, 1 << 20  # the halo encoder's run
HALO_K32 = 15  # the halo encoder's int32 run (the bases entry's 32-bit path)
MH_TIMEOUT_S = 400  # a multi-host run's limit: its workers are killed after it
BENCH_TIMEOUT_S = 300  # phase 5b's limit on bench_gpu.py


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps):
    """Median device time of ``fn`` on the card, after one warm-up call
    (``scripts/bench_device_step_torch.median_ms``: CUDA events, a ~1 ms
    spin queued before each start event, so the card is still busy while the
    host enqueues ``fn``'s launches and a short kernel's time is its own, not
    its wrapper's enqueue)."""
    import torch

    from bench_device_step_torch import median_ms as device_median_ms

    return device_median_ms(fn, torch.device("cuda"), reps)


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


def kernel_vs_plain(dev, cells, codes, hot, label):
    """The kernel and the plain sweep on two copies of one random plane;
    returns (max abs err, min kernel ms, min plain ms, bound ms), each time
    the median of one round, rounds alternating plain, kernel, kernel,
    plain."""
    import torch

    from bench_device_step_torch import sweep_bound_ms
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
    offsets, the sentinel / -1 / int32-max bands, int64 codes above 2^31)
    and of the encode kernels' (K = 1, 15, 17, 19, 21, 31, spans of one
    window to many blocks with a ragged end, the fused valid-window count,
    planes at every byte offset 0..15, an all-invalid chunk, invalid bases,
    the halo encoder on the card), each exactly against the plain version,
    in a pytest subprocess."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "-m", "cuda", "tests/test_torch_cuda.py", "-k",
         "test_kernel_ or test_encode_kernel_"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:]
    if proc.returncode != 0 or not tail or " passed" not in tail[0] \
            or "skipped" in tail[0]:
        raise AssertionError(f"kernel edge cases failed:\n{proc.stdout[-4000:]}"
                             f"{proc.stderr[-2000:]}")
    log(f"sweep and encode edge cases (tests/test_torch_cuda.py -k 'test_kernel_ or "
        f"test_encode_kernel_'): {tail[0]} in {time.perf_counter() - t0:.1f} s")


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


def encode_planes(dev, k, gen):
    """A 2^24-window chunk at ``k`` made on the card: random packed bases,
    validity bits with ~1% invalid bases and a run of 1000, and the same
    bases unpacked to uint8 codes with and without the invalid ones (4).
    Returns (span, bases2, maskbits, chunk with 4s, chunk without)."""
    import torch

    from pykmer_tpu_torch.ops.encode import unpack_base_2bit, unpack_base_2bit_mask

    span = ENCODE_WINDOWS + k - 1
    bases2 = torch.randint(0, 256, ((span + 3) // 4,), dtype=torch.uint8, device=dev,
                           generator=gen)
    n_bits = (span + 7) // 8 * 8
    valid = torch.rand(n_bits, device=dev, generator=gen) >= 0.01
    valid[span // 2 : span // 2 + 1000] = False
    valid[span:] = False  # past the span, as pack_base_stream pads
    weights = torch.arange(8, dtype=torch.uint8, device=dev)
    maskbits = (valid.view(-1, 8).to(torch.uint8) << weights).sum(1, dtype=torch.uint8)
    return (span, bases2, maskbits, unpack_base_2bit_mask(bases2, maskbits, span),
            unpack_base_2bit(bases2, span))


def encode_vs_plain(label, kernel, plain, bound_bytes):
    """One encode kernel against its plain version on the same inputs
    (``torch.equal``, dtype included); returns (max abs err, min kernel ms,
    min plain ms, bound ms), each time the median of one round, rounds
    alternating plain, kernel, kernel, plain."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"encode {label}: kernel != plain")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    t_plain = [median_ms(plain, 5)]
    t_kernel = [median_ms(kernel, 20), median_ms(kernel, 20)]
    t_plain.append(median_ms(plain, 5))
    bound = bound_bytes / H100_SXM_BYTES_PER_S * 1e3
    log(f"encode {label}, {got.numel()} {got.dtype} codes: kernel == plain; median ms "
        f"kernel {t_kernel}, plain {t_plain}; bound {bound:.4f} ms ({bound_bytes} bytes "
        f"read once and written once at {H100_SXM_BYTES_PER_S / 1e12} TB/s); kernel at "
        f"{bound / min(t_kernel):.3f} of its bound")
    del got, want
    return err, min(t_kernel), min(t_plain), bound


def phase_encode(dev, variants_build):
    """Phase 2b: the encode kernels against their plain versions at the main
    path's chunk size, K = 15, 17, 19, both entries, masked and all-valid
    (the packed entry with its fused count, checked against the plain
    count); then both entries beside their earlier design
    (``scripts/bench_encode_variants.py``, whose library ``variants_build``
    is building); then the halo encoder at K=15 and K=19 on ``[cuda:0] * 8``
    against ``[cpu] * 8``. Returns ({(entry, K, variant): (err, ms, plain
    ms, bound ms)}, {K: the halo run's bases-kernel launches})."""
    import numpy as np
    import torch

    import bench_encode_variants as bev
    from pykmer_tpu_torch.ops import _build, encode
    from pykmer_tpu_torch.parallel import make_halo_encode, make_mesh

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for k in ENCODE_K:
        span, bases2, maskbits, chunk, clean = encode_planes(dev, k, gen)
        m = span - k + 1
        code_bytes = m * torch.empty((), dtype=encode.code_dtype(k)).element_size()
        count = torch.zeros((), dtype=torch.int64, device=dev)
        for variant, mb in (("masked", maskbits), ("all-valid", None)):
            in_bytes = bases2.numel() + (0 if mb is None else mb.numel())
            count.zero_()
            codes = encode.canonical_codes_packed(bases2, mb, span, k, count=count)
            want = int((encode.canonical_codes_packed_plain(bases2, mb, span, k)
                        < 4**k // 2).sum())
            if int(count) != want or int((codes < 4**k // 2).sum()) != want:
                raise AssertionError(f"encode packed K={k} {variant}: fused count "
                                     f"{int(count)}, plain count {want}")
            log(f"encode packed K={k} {variant}: fused count {int(count)} == plain count")
            del codes
            out[("packed", k, variant)] = encode_vs_plain(
                f"packed K={k} {variant}",
                lambda: encode.canonical_codes_packed(bases2, mb, span, k, count=count),
                lambda: encode.canonical_codes_packed_plain(bases2, mb, span, k),
                in_bytes + code_bytes)
        for variant, c in (("masked", chunk), ("all-valid", clean)):
            out[("bases", k, variant)] = encode_vs_plain(
                f"bases K={k} {variant}", lambda: encode.canonical_codes(c, k),
                lambda: encode.canonical_codes_plain(c, k), c.numel() + code_bytes)
        del bases2, maskbits, chunk, clean, count
        torch.cuda.empty_cache()

    vlib = bev.finish_build(variants_build)
    bev.log_sass({"port": bev.sass_counts(_build.load()._name),
                  "earlier design": bev.sass_counts(variants_build[0])}, log)
    log("encode variants (scripts/bench_encode_variants.py): " + json.dumps(
        bev.compare(dev, log, vlib)))

    rng = np.random.default_rng(SEED)
    seq = rng.integers(0, 4, size=HALO_SHARDS * HALO_SHARD_LEN).astype(np.uint8)
    seq[rng.random(seq.shape[0]) < 0.01] = 4
    mesh = make_mesh(HALO_SHARDS, devices=[dev] * HALO_SHARDS)
    halo_launches = {}
    for k in (HALO_K32, HALO_K):
        encode.BASES_LAUNCHES = 0
        t0 = time.perf_counter()
        got = make_halo_encode(mesh, k, HALO_SHARD_LEN)(seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = halo_launches[k] = encode.BASES_LAUNCHES
        want = make_halo_encode(make_mesh(HALO_SHARDS, device="cpu"), k, HALO_SHARD_LEN)(seq)
        if not torch.equal(got.cpu(), want) or launches != HALO_SHARDS:
            raise AssertionError(f"halo encoder K={k}: the card's codes differ from the "
                                 f"CPU mesh's, or {launches} launches for {HALO_SHARDS} shards")
        log(f"halo encoder K={k} on {dev} x{HALO_SHARDS}, {HALO_SHARD_LEN} bases a shard: "
            f"torch.equal to [cpu] x{HALO_SHARDS}, {launches} bases-kernel launches, "
            f"{wall:.3f} s wall (first call)")
    return out, halo_launches


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
    """Step A of every chunk on the card with the plain encoder (unpack, K
    shifted slices, fold) and the sort; each sorted batch goes through each
    of ``sweeps`` into its own plane. Returns (planes, number of k-mers)."""
    import torch

    from pykmer_tpu_torch.ops.encode import canonical_codes_packed_plain
    from pykmer_tpu_torch.ops.histogram import sort_codes_fast

    span = cw + k - 1
    planes = [torch.zeros(4**k // 2, dtype=torch.uint8, device=dev) for _ in sweeps]
    nk = 0
    for b, m in chunks:
        codes = canonical_codes_packed_plain(
            torch.from_numpy(b).to(dev),
            None if m is None else torch.from_numpy(m).to(dev), span, k)
        nk += int((codes < 4**k // 2).sum())
        codes = sort_codes_fast(codes)
        for plane, sweep_fn in zip(planes, sweeps):
            sweep_fn(plane, codes)
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
    from pykmer_tpu_torch.ops import encode, fasta, sweep, unfold
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted
    from pykmer_tpu_torch.ops.readback import unfold_canonical

    k = SLICE_K
    genome = os.path.join(work, "genome.fa")
    t0 = time.perf_counter()
    bench.make_genome(genome, GENOME_BP, seed=SEED, repeats=True)
    log(f"genome: {GENOME_BP} bp written in {time.perf_counter() - t0:.1f} s (set-up)")
    cw = chunk_windows_for(genome, k, dev)
    chunks, total_bp = pipelined_chunks(genome, k, cw)

    segments = len(card_segments(genome))
    sweep.LAUNCHES = encode.LAUNCHES = fasta.LAUNCHES = unfold.LAUNCHES = 0
    wall, table = run_cli(["index", genome, "s", str(k), "--device", str(dev)])
    launches, enc_launches, dec_launches = sweep.LAUNCHES, encode.LAUNCHES, fasta.LAUNCHES
    unf_launches = unfold.LAUNCHES
    log(table)
    log(f"index K={k}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
        f"(verify on, streaming input), {len(chunks)} chunks of {cw} windows, "
        f"{launches} sweep launches, {enc_launches} encode launches, {dec_launches} "
        f"FASTA decode launches for {segments} segments, {unf_launches} unfold launches")
    if launches != len(chunks) or enc_launches != len(chunks) or dec_launches != segments:
        raise AssertionError(f"sweep launched {launches} times and the encode kernel "
                             f"{enc_launches} for {len(chunks)} chunks, the FASTA decode "
                             f"{dec_launches} times for {segments} segments")
    if unf_launches != unfold_launches(k):
        raise AssertionError(f"the unfold launched {unf_launches} times, not once for each "
                             f"of the file's {unfold_launches(k)} slices")

    (plane,), nk = replay(chunks, k, cw, dev, [saturating_accumulate_sorted])
    want = unfold_canonical(plane.cpu().numpy(), k)
    choice = readback_ops(dev, plane, k)
    unf_times = phase_unfold(dev, plane, k)
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
    log(f"plain replay (plain encoder, plain sweep): .kin identical, num_kmers {nk}, "
        f"vals_max 255, output sha256 {sha} (the file's); {n_all_valid} of {len(chunks)} "
        f"chunks all-valid")
    return ((launches, enc_launches, dec_launches, unf_launches), genome, chunks, cw, total_bp,
            sha, choice, unf_times)


def unfold_launches(k):
    """The card unfold's launches in an index's raw tail on the card: one
    for each ``SLICE_CELLS``-byte slice of the 4^K file."""
    from pykmer_tpu_torch.ops import readback

    return 2 * -(-(4**k // 2) // readback.SLICE_CELLS)


def phase_unfold(dev, plane, k):
    """Phase 4c: the card's file-order unfold (``ops/unfold.unfold_file``,
    the kernel of ``csrc/unfold.cu``) on phase 4's replayed plane against
    its plain torch version on the card, on the two slices of the file that
    meet at its middle: the ``SLICE_CELLS`` bytes below 4^K/2, whose folded
    cells the kernel also counts into the 256 bins, and the mirror slice
    above, which reads the same cells in descending order. Bytes and counts
    equal; each slice's median ms (CUDA events) beside its byte bound (its
    folded cells read once and its bytes written once, at 3.35 TB/s); the
    plain version timed on the first. Returns (max abs err, the slower
    slice's ms, plain ms, bound ms)."""
    import torch

    from pykmer_tpu_torch.ops import readback, unfold

    n = readback.SLICE_CELLS
    half = 4**k // 2
    bound = 2 * n / H100_SXM_BYTES_PER_S * 1e3
    err, times, plain_ms = 0, [], None
    for a, label in ((half - n, "first half, counted"), (half, "mirror half")):
        f0, f1 = unfold.folded_range(k, a, a + n)
        src = plane[f0:f1]
        counts = torch.zeros(256, dtype=torch.int64, device=dev)
        want_counts = torch.zeros_like(counts)
        got = unfold.unfold_file(src, f0, k, a, a + n, counts)
        want = unfold.unfold_file_plain(src, f0, k, a, a + n, want_counts)
        if not torch.equal(got, want) or not torch.equal(counts, want_counts):
            raise AssertionError(f"unfold of file bytes [{a}, {a + n}): card != plain")
        err = max(err, max_abs_err(got, want), int((counts - want_counts).abs().max()))
        del got, want
        ms = median_ms(lambda: unfold.unfold_file(src, f0, k, a, a + n, counts), 20)
        times.append(ms)
        log(f"unfold K={k}, file bytes [{a}, {a + n}) ({label}): card == plain on the card, "
            f"counts equal; median {ms:.4f} ms; bound {bound:.4f} ms ({2 * n} bytes read once "
            f"and written once at {H100_SXM_BYTES_PER_S / 1e12} TB/s); at {bound / ms:.3f} of "
            f"its bound")
        if plain_ms is None:
            plain_ms = median_ms(lambda: unfold.unfold_file_plain(src, f0, k, a, a + n), 3)
            log(f"unfold K={k}, {label}: plain torch on the card, median {plain_ms:.3f} ms")
    torch.cuda.empty_cache()
    return err, max(times), plain_ms, bound


def card_segments(genome):
    """The record-aligned segments (lo, hi) that a streaming index decodes
    on the card, one decode launch each."""
    import numpy as np

    from pykmer_tpu_torch.host.pipeline import TARGET_SEGMENT
    from pykmer_tpu_torch.host.segments import segment_record_bounds

    return segment_record_bounds(np.fromfile(genome, dtype=np.uint8), TARGET_SEGMENT)


def decode_parts(dec):
    """A decode's planes, joined length and record table, in the order compared."""
    import torch

    return (dec.bases, dec.mask, torch.tensor([dec.n_codes]), dec.name_off, dec.name_len,
            dec.seq_len, dec.has_valid)


def phase_fasta(dev, genome, cw):
    """Phase 4a: the card's FASTA decode (``ops/fasta.decode_packed``, the
    kernels of ``csrc/fasta.cu``) against its plain torch version on the
    CPU copy of the same bytes, on each segment that phase 4's index
    decoded and on one steady-state segment (the records up to the first
    record start at or past ``TARGET_SEGMENT``), with phase 4's framing
    headroom: the planes, ``n_codes`` and the record table (name offsets
    and lengths, ``seq_len``, ``has_valid``) equal. Each segment's median
    ms on the card (CUDA events; the call's one wait for its totals
    included) beside its byte bound: the raw bytes read once and the
    planes' ceil(n_codes / 4) + ceil(n_codes / 8) bytes written once, at
    3.35 TB/s; the plain version on the card timed on the steady-state
    segment. Returns that segment's (max abs err, ms, plain ms, bound ms)."""
    import numpy as np
    import torch

    from pykmer_tpu_torch.host.pipeline import TARGET_SEGMENT
    from pykmer_tpu_torch.host.segments import find_record_start
    from pykmer_tpu_torch.ops import fasta

    k = SLICE_K
    headroom = cw + k + 8  # host/pipeline.iter_card_chunks' framing room
    buf = np.fromfile(genome, dtype=np.uint8)
    steady = (0, find_record_start(buf, TARGET_SEGMENT - 1, buf.shape[0]) or buf.shape[0])
    out = None
    for lo, hi in card_segments(genome) + [steady]:
        src = torch.from_numpy(buf[lo:hi])
        raw = src.to(dev)
        got = decode_parts(fasta.decode_packed(raw, k, headroom))
        want = decode_parts(fasta.decode_packed(src, k, headroom))
        err = 0
        for a, b in zip(got, want):
            a = a.cpu()
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"FASTA decode of bytes [{lo}, {hi}): card != plain")
            if a.numel():
                err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
        n_codes = int(want[2])
        del got, want
        ms = median_ms(lambda: fasta.decode_packed(raw, k, headroom), 10)
        bound_bytes = (hi - lo) + (n_codes + 3) // 4 + (n_codes + 7) // 8
        bound = bound_bytes / H100_SXM_BYTES_PER_S * 1e3
        label = "steady-state segment" if (lo, hi) == steady else "segment"
        log(f"FASTA decode K={k}, {label} [{lo}, {hi}): {hi - lo} bytes, {n_codes} codes: "
            f"card == plain (CPU); median {ms:.4f} ms; bound {bound:.4f} ms ({bound_bytes} "
            f"bytes read once and written once at {H100_SXM_BYTES_PER_S / 1e12} TB/s); "
            f"at {bound / ms:.3f} of its bound")
        if (lo, hi) == steady:
            plain_ms = median_ms(lambda: fasta.decode_packed_plain(raw, k, headroom), 3)
            log(f"FASTA decode K={k}, steady-state segment: plain torch on the card, median "
                f"{plain_ms:.3f} ms")
            out = (err, ms, plain_ms, bound)
        del src, raw
        torch.cuda.empty_cache()
    return out


READBACK_MODES = ("raw", "packed", "2bit", "3bit", "sparse")
# the stages of an index's readback tail, by the start of their names
TAIL_STAGES = ("escape counts", "output alloc", "copy + ", "write ", "2-bit fallback")


def readback_ops(dev, plane, k):
    """The readback modes on a folded plane on the card: ``fetch_dense`` in
    every mode ``torch.equal`` to the plane (the raw copy against the card's
    plane in 1 GiB slices, every other mode against the raw copy), the
    escape counts and the JAX package's auto choice on them, and each device
    op's median ms (CUDA events) beside its bytes bound and its calls in one
    index. Returns the choice."""
    import torch

    from pykmer_tpu_torch.ops import packing, readback

    size = plane.shape[0]
    t0 = time.perf_counter()
    escapes = packing.count_all_escapes(plane)
    choice = packing.pick_mode(plane, size, "auto", escapes)
    log(f"readback K={k}: escape counts (>=1, >=3, >=7, >=15) {escapes} in "
        f"{time.perf_counter() - t0:.3f} s; the JAX package's auto choice: {choice}")
    ref, walls = None, {}
    for mode in READBACK_MODES:
        t0 = time.perf_counter()
        host = readback.fetch_dense(plane, mode)
        walls[mode] = round(time.perf_counter() - t0, 3)
        if ref is None:
            step = 1 << 30
            if not all(torch.equal(torch.from_numpy(host[lo : lo + step]).to(dev),
                                   plane[lo : lo + step]) for lo in range(0, size, step)):
                raise AssertionError(f"K={k}: fetch_dense({mode!r}) differs from the plane")
            ref = host
        elif not torch.equal(torch.from_numpy(host), torch.from_numpy(ref)):
            raise AssertionError(f"K={k}: fetch_dense({mode!r}) differs from the plane")
        del host
    del ref
    log(f"readback K={k}: fetch_dense torch.equal to the plane in every mode; wall s {walls}")

    sl = plane[: readback.SLICE_CELLS]
    seg = plane[: packing.SPARSE_SEG_CELLS]
    cap = packing.sparse_cap(seg.shape[0])
    idx = torch.nonzero(sl >= packing.ESCAPE2).squeeze(1).cpu().numpy()
    seg_nz = int(torch.count_nonzero(seg))
    ops = {
        "count_all_escapes_ms": median_ms(lambda: packing.count_all_escapes(plane), 5),
        "count_all_escapes_bound_ms": size / H100_SXM_BYTES_PER_S * 1e3,
        "slice_cells": sl.shape[0],
        "pack_2bit_ms": median_ms(lambda: packing.pack_2bit(sl), 10),
        "pack_3bit_ms": median_ms(lambda: packing.pack_3bit(sl), 10),
        "pack_nibbles_ms": median_ms(lambda: packing.pack_nibbles(sl), 10),
        # the slice read once, the packed bytes written once
        "pack_bound_ms": {w: (sl.shape[0] + packing.packed_len(sl.shape[0], w))
                          / H100_SXM_BYTES_PER_S * 1e3 for w in (2, 3, 4)},
        "gather_2bit_escapes_of_a_slice_ms": median_ms(
            lambda: packing.gather_cells(plane, idx), 5),
        "gather_cells": int(idx.shape[0]),
        "segment_cells": seg.shape[0],
        "segment_nonzeros": seg_nz,
        "segment_overflows_the_cap": seg_nz > cap,
        "pack_sparse_segment_ms": median_ms(lambda: packing.pack_sparse_segment(seg, cap), 5),
        "calls_per_index": {
            "count_all_escapes": 1, "pack (each width)": -(-size // readback.SLICE_CELLS),
            "pack_sparse_segment": -(-size // packing.SPARSE_SEG_CELLS)},
    }
    log(f"readback device ops K={k}, median ms (CUDA events): " + json.dumps(ops))
    torch.cuda.empty_cache()
    return choice


def index_in_process(genome, k, dev, readback):
    """``create_fasta_index(..., config=IndexConfig(readback=readback))`` in
    this process with the stage table on; returns (wall s, stage table,
    `.kin.json`), the `.kin` removed."""
    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.config import IndexConfig

    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            create_fasta_index(genome, "s", genome, k, verbose=False, device=dev,
                               config=IndexConfig(kmer_len=k, readback=readback))
    finally:
        os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    wall = time.perf_counter() - t0
    return wall, err.getvalue().rstrip(), take_outputs(genome + f".{k:02d}.kin")


def tail_s(table):
    """Seconds of an index's readback tail: the stages of ``TAIL_STAGES`` in
    its stage table."""
    total = 0.0
    for line in table.splitlines():
        parts = line.split()  # "<name> <ms> ms <share>%", as StageTimer.report
        if "ms" in parts and " ".join(parts[: parts.index("ms") - 1]).startswith(TAIL_STAGES):
            total += float(parts[parts.index("ms") - 1]) / 1e3
    return total


def phase_k15_modes(dev, genome, total_bp, want_sha, choice):
    """Phase 4b: the genome at K=15 in this process in every readback mode,
    raw first and last; each `.kin` sha256 phase 4's. Logs each stage
    table, its wall and tail seconds, whether the sparse segments took the
    2-bit fallback, and raw against the JAX package's choice."""
    k = SLICE_K
    runs = {}
    for readback in ("raw", "packed", "2bit", "3bit", "sparse", "raw"):
        wall, table, meta = index_in_process(genome, k, dev, readback)
        log(table)
        tail = tail_s(table)
        runs.setdefault(readback, []).append([round(wall, 3), round(tail, 3)])
        log(f"index K={k}, readback={readback} (in process): {total_bp} bp in {wall:.3f} s = "
            f"{total_bp / wall:.0f} bp/s (verify on), readback tail {tail:.3f} s, output "
            f"sha256 {meta['output_file_cheksum']}")
        if meta["output_file_cheksum"] != want_sha:
            raise AssertionError(f"K={k} readback={readback}: .kin sha256 differs from phase 4's")
        if readback == "sparse":
            fb = [ln.strip() for ln in table.splitlines() if "2-bit fallback" in ln]
            log(f"index K={k}, readback=sparse: segments over the token cap read through the "
                f"2-bit plane: {fb[0] if fb else 'none'}")
    log(f"auto at K={k}: [wall s, tail s] of raw {runs['raw']}, of the JAX package's choice "
        f"({choice}) {runs[choice]}")
    return runs


def index_worker(argv):
    """Worker mode (``--index-worker <input> <K> <readback>``): one
    ``create_fasta_index`` on ``cuda:0`` with ``IndexConfig(readback=...)``,
    verify on; prints one JSON line of its wall, the sweep's launches, peak
    device memory and peak host RSS (sampled). Its stage table goes to
    stderr (``PYKMER_TPU_STAGE_TIMING``, set by the caller)."""
    import torch

    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.config import IndexConfig
    from pykmer_tpu_torch.ops import encode, sweep

    peak_rss = rss_sampler()
    path, k, readback = argv[0], int(argv[1]), argv[2]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    create_fasta_index(path, "s", path, k, verbose=False, device=dev,
                       config=IndexConfig(kmer_len=k, readback=readback))
    print(json.dumps({
        "readback": readback, "wall_s": time.perf_counter() - t0,
        "launches": sweep.LAUNCHES, "launches_i64": sweep.LAUNCHES_I64,
        "encode_launches": encode.LAUNCHES,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "peak_rss_bytes": peak_rss(),  # sampled every 50 ms
    }), flush=True)
    return 0


def phase_k17_pieces(work, genome, total_bp, want_sha, peak6):
    """Phase 6b: the genome at K=17 in a fresh process each, readback raw
    and then sparse (the pieces tail): each `.kin` sha256 phase 6's, the
    pieces run's peak device memory at most the raw run's plus 1 GiB; stage
    tables, walls, peak device memory and peak host RSS logged side by side
    with phase 6's peak (``readback="auto"``, which takes the pieces tail
    at K=17 on CUDA)."""
    k = BIG_K
    runs = {}
    for readback in ("raw", "sparse"):
        label = f"K={k} readback={readback}"
        wall, ((out, err),) = run_job(
            [[os.path.join(ROOT, "chip_smoke.py"), "--index-worker", genome, str(k), readback]],
            work, label, env_extra={"PYKMER_TPU_STAGE_TIMING": "1"})
        meta = take_outputs(genome + f".{k:02d}.kin")
        r = json.loads(out.strip().splitlines()[-1])
        r["tail_s"] = tail_s(err)
        r["bp_per_s"] = total_bp / r["wall_s"]
        r["process_wall_s"] = wall
        log(err.rstrip())
        log(f"index {label} (fresh process): " + json.dumps(r))
        if meta["output_file_cheksum"] != want_sha:
            raise AssertionError(f"{label}: .kin sha256 differs from phase 6's")
        if r["encode_launches"] != r["launches"]:
            raise AssertionError(f"{label}: {r['encode_launches']} encode launches for "
                                 f"{r['launches']} sweep launches")
        runs[readback] = (r, err)
    r, err = runs["sparse"]
    raw = runs["raw"][0]
    if "(pieces)" not in err or "(pieces)" in runs["raw"][1]:
        raise AssertionError(f"K={k}: only readback=sparse may take the pieces tail")
    if r["peak_device_bytes"] > raw["peak_device_bytes"] + (1 << 30):
        raise AssertionError(f"K={k} pieces: peak device memory {r['peak_device_bytes']} over "
                             f"the raw run's {raw['peak_device_bytes']} + 1 GiB")
    log(f"K={k} raw vs pieces: wall {raw['wall_s']:.3f} / {r['wall_s']:.3f} s, tail "
        f"{raw['tail_s']:.3f} / {r['tail_s']:.3f} s, peak device memory "
        f"{raw['peak_device_bytes']} / {r['peak_device_bytes']} bytes (phase 6 {peak6}), "
        f"peak host RSS {raw['peak_rss_bytes']} / {r['peak_rss_bytes']} bytes")
    return runs


def phase_k15_variants(work, dev, genome, total_bp, want_sha, cw):
    """A gzip -1 copy of the genome (read whole, then pipelined) and the host
    strategy give the streaming run's `.kin` sha256; the encode kernel runs
    once a chunk on both, the sweep on the gzip copy's only."""
    import gzip

    from pykmer_tpu_torch.ops import encode, sweep

    k = SLICE_K
    gz = os.path.join(work, "genome_gz1.fa.gz")
    t0 = time.perf_counter()
    with open(genome, "rb") as src, gzip.open(gz, "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 16 << 20)
    log(f"gzip -1 copy: {os.path.getsize(gz)} bytes in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    for path, extra, label in ((gz, [], "gzip -1 input"),
                               (genome, ["--accumulate", "host"], "host strategy")):
        sweep.LAUNCHES = encode.LAUNCHES = 0
        wall, table = run_cli(["index", path, "s", str(k), "--device", str(dev), *extra])
        meta = take_outputs(path + f".{k:02d}.kin")
        log(table)
        log(f"index K={k}, {label}: {total_bp} bp in {wall:.3f} s = "
            f"{total_bp / wall:.0f} bp/s (verify on), {sweep.LAUNCHES} sweep launches, "
            f"{encode.LAUNCHES} encode launches, output sha256 {meta['output_file_cheksum']}")
        if meta["output_file_cheksum"] != want_sha:
            raise AssertionError(f"K={k} {label}: .kin sha256 differs from the streaming run's")
        # the host strategy frames the whole decoded genome and runs no sweep
        host = label == "host strategy"
        n = sharded_frames(genome, k, cw)[1] if host else sweep.LAUNCHES
        if n == 0 or (sweep.LAUNCHES, encode.LAUNCHES) != (0 if host else n, n):
            raise AssertionError(f"K={k} {label}: {sweep.LAUNCHES} sweep and "
                                 f"{encode.LAUNCHES} encode launches")
    return gz


def phase_bgzf(work, dev, genome, total_bp, want_sha):
    """Phase 4d: a BGZF copy of the genome (``io/bgzf.compress_file``, what
    bgzip writes) through ``create_fasta_index`` on the card, which inflates
    its blocks there (``host/segments.BgzfInput`` → ``ops/inflate`` →
    ``csrc/inflate.cu``): the `.kin` sha256 phase 4's, the input sha256 the
    compressed file's, one inflate launch for each run of
    ``segments.bgzf_runs`` and every ``bgzf inflate`` span's blocks on the
    card. Then the kernel over every block of the file in one launch against
    the host's zlib (``segments.inflate_blocks``) on the same bytes: output
    and statuses equal; its median ms beside its byte bound (the compressed
    file read once and the inflated bytes written once, at 3.35 TB/s) and
    the host's zlib on one thread. Returns (launches, (max abs err, ms,
    zlib ms, bound ms))."""
    import hashlib

    import numpy as np
    import torch

    from pykmer_tpu_torch.host import segments
    from pykmer_tpu_torch.io import bgzf
    from pykmer_tpu_torch.ops import inflate
    from pykmer_tpu_torch.utils import profiling

    k = SLICE_K
    gz = os.path.join(work, "genome_bgzf.fa.gz")
    t0 = time.perf_counter()
    bgzf.compress_file(genome, gz, write_index=False)
    src = segments.read_bgzf(gz)
    n_blocks = src.c_offs.shape[0] - 1
    runs = segments.bgzf_runs(src.u_offs, segments.INFLATE_EXTENT,
                              max(segments.INFLATE_EXTENT, src.size // 8))
    log(f"BGZF copy: {os.path.getsize(gz)} bytes, {n_blocks} blocks, {src.size} bytes "
        f"inflated, in {time.perf_counter() - t0:.1f} s (set-up); the card route's runs: "
        f"{len(runs)}")

    inflate.LAUNCHES = 0
    wall, table, meta = index_in_process(gz, k, dev, "auto")
    launches = inflate.LAUNCHES
    spans = [s for s in profiling.FINISHED_RUNS[-1].spans if s.name == "bgzf inflate"]
    log(table)
    log(f"index K={k}, BGZF input: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
        f"(verify on), {launches} inflate launches, {len(spans)} bgzf inflate spans, output "
        f"sha256 {meta['output_file_cheksum']}")
    if meta["output_file_cheksum"] != want_sha:
        raise AssertionError(f"K={k} BGZF input: .kin sha256 differs from phase 4's")
    with open(gz, "rb") as fh:
        if meta["input_file_cheksum"] != hashlib.sha256(fh.read()).hexdigest():
            raise AssertionError(f"K={k} BGZF input: the input sha256 is not the file's")
    if launches != len(runs) or len(spans) != len(runs):
        raise AssertionError(f"the card inflate launched {launches} times in {len(spans)} "
                             f"spans for {len(runs)} runs")
    if (sum(s.counts.get("card_blocks", 0) for s in spans) != n_blocks
            or sum(s.counts["blocks"] for s in spans) != n_blocks
            or sum(s.counts["bytes"] for s in spans) != src.size):
        raise AssertionError(f"the bgzf inflate spans count {[s.counts for s in spans]}")

    want = np.empty(src.size, dtype=np.uint8)
    t0 = time.perf_counter()
    segments.inflate_blocks(src.data, want, src.c_offs, src.u_offs)
    zlib_ms = (time.perf_counter() - t0) * 1e3
    n = src.data.shape[0]
    comp = torch.zeros(-(-n // 4) * 4, dtype=torch.uint8, device=dev)
    comp[:n].copy_(torch.from_numpy(src.data))
    c_offs = torch.from_numpy(src.c_offs).to(dev)
    u_offs = torch.from_numpy(src.u_offs).to(dev)
    out = torch.empty(src.size, dtype=torch.uint8, device=dev)
    status = torch.full((n_blocks,), -1, dtype=torch.int32, device=dev)
    inflate.inflate_bgzf(comp, c_offs, u_offs, out, status)
    bad = int((status != inflate.OK).sum())
    got = out.cpu().numpy()
    if bad or not np.array_equal(got, want):
        raise AssertionError(f"the card inflate of the whole file: {bad} blocks not ok, output "
                             f"equal to zlib's {np.array_equal(got, want)}")
    err = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) if src.size else 0
    del got, want
    ms = median_ms(lambda: inflate.inflate_bgzf(comp, c_offs, u_offs, out, status), 10)
    bound = (n + src.size) / H100_SXM_BYTES_PER_S * 1e3
    log(f"inflate of the BGZF copy, {n_blocks} blocks in one launch: card == zlib, every status "
        f"ok; median {ms:.4f} ms ({src.size / ms / 1e6:.2f} GB/s inflated); bound {bound:.4f} ms "
        f"({n} bytes read once and {src.size} written once at {H100_SXM_BYTES_PER_S / 1e12} "
        f"TB/s); at {bound / ms:.4f} of its bound; zlib on one host thread {zlib_ms:.1f} ms")
    del comp, out, status
    os.remove(gz)
    torch.cuda.empty_cache()
    return launches, (err, ms, zlib_ms, bound)


def phase_deflate(work, dev, genome, want_sha):
    """Phase 4e: the bgzip output on the card, on its main path: the genome
    at K=15 through ``create_fasta_index(..., bgzip=True)``, whose finish
    deflates runs of ``index/bgzip.CARD_RUN_BLOCKS`` blocks unfolded from
    the plane on the card (``ops/deflate.deflate_bgzf``, the kernels of
    ``csrc/deflate.cu``, on the thread "bgzf-deflate_card"): the `.kin`
    sha256 phase 4's; one deflate launch a run and a ``bgzf deflate`` span
    each, every block in ``card_blocks``; no ``kin read``; the `.kin.bgz`
    and `.gzi` ``io/bgzf.bgzip_kin``'s (the native codec at level 6 on every
    core), byte for byte. Then the kernels alone over the `.kin` on the
    card, run by run: the members those of the file; their median ms beside
    the byte bound (the file read once and the members written once, at
    3.35 TB/s; the chain walks bind, not the bytes) and ``bgzip_kin``'s
    wall. Returns (launches, (max abs err, ms, bgzip_kin ms, bound ms))."""
    import numpy as np
    import torch

    from pykmer_tpu_torch import create_fasta_index
    from pykmer_tpu_torch.config import IndexConfig
    from pykmer_tpu_torch.index import bgzip
    from pykmer_tpu_torch.io import bgzf
    from pykmer_tpu_torch.ops import deflate
    from pykmer_tpu_torch.utils import profiling

    k = SLICE_K
    link = os.path.join(work, "genome_bgzip.fa")
    os.symlink(os.path.abspath(genome), link)
    kin = link + f".{k:02d}.kin"
    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    table = io.StringIO()
    deflate.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(table):
            create_fasta_index(link, "s", link, k, verbose=False, device=dev, bgzip=True,
                               config=IndexConfig(kmer_len=k))
    finally:
        os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    wall = time.perf_counter() - t0
    launches = deflate.LAUNCHES
    log(table.getvalue().rstrip())
    spans = profiling.FINISHED_RUNS[-1].spans
    deflates = [s for s in spans if s.name == "bgzf deflate"]
    reads = [s for s in spans if s.name == "kin read"]
    with open(kin + ".json") as fh:
        meta = json.load(fh)
    size = os.path.getsize(kin)
    blocks = -(-size // deflate.BLOCK)
    runs = -(-blocks // bgzip.CARD_RUN_BLOCKS)
    log(f"index K={k} with bgzip on the card: {wall:.3f} s, {launches} deflate launches, "
        f"{len(deflates)} bgzf deflate spans "
        f"({sum(s.end - s.start for s in deflates) / 1e6:.1f} ms), "
        f"{len(reads)} kin reads, .kin.bgz {os.path.getsize(kin + '.bgz')} bytes")
    if meta["output_file_cheksum"] != want_sha:
        raise AssertionError(f"K={k} with bgzip: .kin sha256 differs from phase 4's")
    if launches != runs or len(deflates) != runs:
        raise AssertionError(f"the card deflate launched {launches} times in {len(deflates)} "
                             f"spans for {runs} runs of {blocks} blocks")
    if (sum(s.counts.get("card_blocks", 0) for s in deflates) != blocks
            or sum(s.counts["blocks"] for s in deflates) != blocks
            or any(s.thread != "bgzf-deflate_card" for s in deflates) or reads):
        raise AssertionError(f"the bgzf deflate spans count {[s.counts for s in deflates]} on "
                             f"{sorted({s.thread for s in deflates})}; {len(reads)} kin reads")
    card = {ext: open(kin + ext, "rb").read() for ext in (".bgz", ".bgz.gzi")}
    for ext in (".bgz", ".bgz.gzi"):
        os.remove(kin + ext)
    t0 = time.perf_counter()
    bgzf.bgzip_kin(kin)
    host_ms = (time.perf_counter() - t0) * 1e3
    for ext, got in card.items():
        with open(kin + ext, "rb") as fh:
            if fh.read() != got:
                raise AssertionError(f"the card's {ext} is not io/bgzf.bgzip_kin's")
    want = np.frombuffer(card[".bgz"], dtype=np.uint8)[: -len(bgzf.BGZF_EOF)]

    data = torch.from_numpy(np.fromfile(kin, dtype=np.uint8)).to(dev)
    run = bgzip.CARD_RUN_BLOCKS * deflate.BLOCK

    def kernels():
        return [deflate.deflate_bgzf(data[a: a + run]) for a in range(0, size, run)]

    got = np.concatenate([m[: int(s.sum())].cpu().numpy() for m, s in kernels()])
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"the kernels over the .kin: {got.shape[0]} bytes against the "
                             f"file's {want.shape[0]}")
    err = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
    ms = median_ms(kernels, 3)
    bound = (size + got.shape[0]) / H100_SXM_BYTES_PER_S * 1e3
    log(f"deflate of the K={k} .kin, {blocks} blocks in {runs} launches: the .kin.bgz and .gzi "
        f"io/bgzf.bgzip_kin's, byte for byte ({got.shape[0]} bytes of members); the kernels "
        f"alone median {ms:.1f} ms ({size / ms / 1e6:.3f} GB/s); bound {bound:.4f} ms ({size} "
        f"bytes read once and {got.shape[0]} written once at {H100_SXM_BYTES_PER_S / 1e12} "
        f"TB/s); at {bound / ms:.5f} of its bound; bgzip_kin on the host "
        f"({bgzip.deflate_threads()} cores) {host_ms:.1f} ms")
    del data, got, want
    for path in (kin, kin + ".json", kin + ".bgz", kin + ".bgz.gzi", link):
        os.remove(path)
    torch.cuda.empty_cache()
    return launches, (err, ms, host_ms, bound)


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
    from pykmer_tpu_torch.ops import encode, fasta, sweep
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted

    k = BIG_K
    cw = chunk_windows_for(genome, k, dev)
    chunks, total_bp = pipelined_chunks(genome, k, cw)
    log(f"disk free before K={k}: {shutil.disk_usage(work).free} bytes")
    segments = len(card_segments(genome))
    sweep.LAUNCHES = sweep.LAUNCHES_I64 = encode.LAUNCHES = encode.LAUNCHES_I64 = 0
    fasta.LAUNCHES = 0
    wall, table = run_cli(["index", genome, "s", str(k), "--device", str(dev)])
    launches, launches_i64 = sweep.LAUNCHES, sweep.LAUNCHES_I64
    enc_launches = (encode.LAUNCHES, encode.LAUNCHES_I64)
    dec_launches = fasta.LAUNCHES
    # create_fasta_index resets the peak at its start
    peak = torch.cuda.max_memory_allocated(dev)
    meta = take_outputs(genome + f".{k:02d}.kin")
    log(table)
    log(f"index K={k}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
        f"(verify on, streaming input), peak device memory {peak} bytes, "
        f"{len(chunks)} chunks of {cw} windows, {launches_i64} int64 sweep launches, "
        f"{enc_launches[1]} int64 encode launches, {dec_launches} FASTA decode launches "
        f"for {segments} segments")
    if launches_i64 != len(chunks) or launches != launches_i64 \
            or enc_launches != (len(chunks), len(chunks)) or dec_launches != segments:
        raise AssertionError(f"K={k}: {launches_i64} int64 launches ({launches} in all), "
                             f"encode {enc_launches}, for {len(chunks)} chunks; FASTA "
                             f"decode {dec_launches} for {segments} segments")

    torch.cuda.empty_cache()
    (kern, plain), nk = replay(chunks, k, cw, dev,
                               [sweep.accumulate_sorted, saturating_accumulate_sorted])
    torch.cuda.synchronize()
    if not torch.equal(kern, plain):
        raise AssertionError(f"K={k}: the kernel plane differs from the plain-sweep plane")
    err = max_abs_err(kern, plain)
    counts = device_counts256(kern)
    del plain
    torch.cuda.empty_cache()
    readback_ops(dev, kern, k)
    del kern
    torch.cuda.empty_cache()
    counts[0] += 4**k // 2  # each folded cell's structural-zero partner
    stats = stats_from_counts256(counts)
    for key, val in stats.items():
        if meta[key] != val:
            raise AssertionError(f"K={k}: .kin.json {key} differs from the replay plane's")
    if meta["num_kmers"] != nk:
        raise AssertionError(f"K={k}: num_kmers {meta['num_kmers']} != replay {nk}")
    log(f"replay K={k} (plain encoder): kernel plane == plain plane ({4**k // 2} cells, "
        f"torch.equal), "
        f"its stats and num_kmers {nk} are the .kin's, vals_max {meta['vals_max']}")
    return (launches_i64, enc_launches[1]), err, meta["output_file_cheksum"], peak


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


def phase_merge_fanin(work, dev):
    """N=39 at K=13 (8 .bgz): device vs host engine through the CLI entry,
    three pairs vs pair_counts_stream, the device step's time, and the
    host-vs-device crossover in N."""
    from bench_merge_fanin_torch import ensure_fanin_inputs
    from pykmer_tpu_torch.merge import merge

    # where bench_gpu.py's fan-in leg looks for its samples (phase 5b)
    k, d = FANIN_K, os.path.join(work, "bench", "merge_fanin")
    t0 = time.perf_counter()
    kins = sorted(ensure_fanin_inputs(d, FANIN_N, k, FANIN_BGZ))
    log(f"fan-in: {FANIN_N} K={k} samples ({FANIN_BGZ} .kin.bgz) fabricated in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    matrix, walls = merge_both(work, "fanin", kins, dev, k)
    check_pairs(matrix, kins, FANIN_PAIRS, k)
    phase_merge_sharded(work, dev, kins, k, matrix)
    streamed = FANIN_N * 4**k
    log(f"merge fan-in N={FANIN_N} K={k}: device engine {walls['device']:.3f} s, host "
        f"engine {walls['host']:.3f} s ({device_blocks(FANIN_N, k)[1]} device blocks); "
        f".kma equal, pairs {list(FANIN_PAIRS)} equal to pair_counts_stream; "
        f"{streamed / walls['device'] / 1e6:.0f} MB/s streamed by the device engine")
    step_ms = merge_step_times(dev, FANIN_N, k)

    raw, x = kins[FANIN_BGZ:], os.path.join(work, "crossover")
    os.makedirs(x)
    for nn in CROSSOVER_N:
        sub, got = raw[:nn], {"host": [], "device": []}
        for i, engine in enumerate(("host", "device", "device", "host")):
            t0 = time.perf_counter()
            merge(os.path.join(x, f"x{nn}_{i}"), sub, engine=engine, verbose=False,
                  device=dev)
            got[engine].append(round(time.perf_counter() - t0, 3))
        log(f"merge crossover N={nn} K={k} raw .kin: host {got['host']} s, "
            f"device {got['device']} s")
    shutil.rmtree(x)
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


def phase_certify_k19(dev):
    """Phase 2c: part D of ``scripts/certify_k19_torch.py`` on the card: the
    K=19 fixture's sorted folded codes swept into a 2^22-cell window at bases
    across the 2^37-cell range (one above 2^32), one int64 kernel launch a
    window, each window equal to the numpy oracle's counts, one saturated."""
    import numpy as np

    import certify_k19_torch as cert

    t0 = time.perf_counter()
    cert.certify(dev, cert.build_fixture(np.random.default_rng(cert.FIXTURE_SEED)), parts="D")
    log(f"K=19 certification, part D: passed in {time.perf_counter() - t0:.1f} s")


def phase_bench(work, genome, want_sha):
    """Phase 5b: ``bench_gpu.py`` in a subprocess at a reduced schedule on
    the genome (K=15, one run a leg, no spaced runs, no K=17 leg; the merge
    pair, the device step and phase 7's fan-in samples): it must exit 0, its
    every `.kin` sha256 must be phase 4's, and its index must have launched
    the sweep and the encode kernel."""
    import torch

    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    d = os.path.join(work, "bench")
    os.makedirs(d, exist_ok=True)
    os.symlink(genome, os.path.join(d, f"synthetic_repeat_{GENOME_BP}.fa"))
    env = dict(os.environ, BENCH_K=str(SLICE_K), BENCH_BP=str(GENOME_BP),
               BENCH_GENOME="repeat", BENCH_RUNS="1", BENCH_SPACED="0", BENCH_LEG_RUNS="1",
               BENCH_K17="0", BENCH_MERGE="1", BENCH_FANIN="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_gpu.py"), "--bench-dir", d],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines else {}
    log(f"bench_gpu.py (reduced schedule) exited {proc.returncode} in {wall:.1f} s: "
        + json.dumps(res))
    sums = res.get("output_checksums", [])
    launches = res.get("launches", {})
    if proc.returncode != 0 or any(key.endswith("_error") for key in res) or not sums \
            or any(x != want_sha for x in sums) \
            or not (launches.get("sweep") and launches.get("encode_packed")):
        raise AssertionError(f"bench_gpu.py: exit {proc.returncode}, checksums {sums} (phase "
                             f"4's {want_sha}), launches {launches}\n{proc.stderr[-4000:]}")
    shutil.rmtree(d)


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
    launched (R·S)^2 times and the encode kernel R·S times per step it ran.
    Returns (wall s, sweep launches, encode launches)."""
    import torch

    from pykmer_tpu_torch.index import create_fasta_index_sharded
    from pykmer_tpu_torch.ops import encode, sweep, unfold

    rows = len(mesh.devices) * len(mesh.devices[0])
    n_steps = -(-n_chunks // rows)
    first = kw.pop("first_step", 0)
    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    err = io.StringIO()
    sweep.LAUNCHES = sweep.LAUNCHES_I64 = encode.LAUNCHES = encode.LAUNCHES_I64 = 0
    unfold.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            create_fasta_index_sharded(genome, "s", genome, k, mesh=mesh, verbose=False, **kw)
    finally:
        os.environ.pop("PYKMER_TPU_STAGE_TIMING")
    wall = time.perf_counter() - t0
    launches, launches_i64 = sweep.LAUNCHES, sweep.LAUNCHES_I64
    enc_launches = (encode.LAUNCHES, encode.LAUNCHES_I64)
    peak = torch.cuda.max_memory_allocated(mesh.first)
    meta = take_outputs(genome + f".{k:02d}.kin")
    log(err.getvalue().rstrip())
    log(f"sharded index K={k}, {label}: {total_bp} bp in {wall:.3f} s = "
        f"{total_bp / wall:.0f} bp/s (verify on), {n_steps - first} steps of {rows} rows "
        f"x {SHARD_CW} windows, {launches} sweep launches ({launches_i64} int64), encode "
        f"launches {enc_launches[0]} ({enc_launches[1]} int64), {unfold.LAUNCHES} unfold "
        f"launches, peak device memory {peak} bytes, output sha256 "
        f"{meta['output_file_cheksum']}")
    if meta["output_file_cheksum"] != want_sha:
        raise AssertionError(f"sharded K={k} {label}: .kin sha256 differs from the "
                             f"single-device run's")
    steps = n_steps - first
    want_enc = (steps * rows, steps * rows if k > 15 else 0)
    if launches != steps * rows * rows or enc_launches != want_enc:
        raise AssertionError(f"sharded K={k} {label}: {launches} sweep launches, encode "
                             f"{enc_launches}, expected {steps * rows * rows}, {want_enc}")
    if unfold.LAUNCHES != unfold_launches(k):
        raise AssertionError(f"sharded K={k} {label}: {unfold.LAUNCHES} unfold launches, "
                             f"expected {unfold_launches(k)}")
    return wall, launches, enc_launches[0]


def sharded_step_times(dev, mesh_shape, rows_np):
    """One K=15 step on a mesh of logical shards on ``dev``: median device ms
    (CUDA events) of the whole step, one position's bucket (encode, key,
    sort, gather), the exchange, and shard 0's received rows applied by one
    sweep launch per row, by the plain sweep per row, and by one re-sort and
    one launch (the three planes checked equal)."""
    import torch

    from bench_device_step_torch import sweep_bound_ms
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
    from pykmer_tpu_torch.ops import encode, sweep
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
    sweep.LAUNCHES = encode.LAUNCHES = 0
    wall, table = run_cli(["index", genome, "s", str(k), "--shards", str(n_cards),
                           "--device", str(dev), "--quiet"])
    launches, enc_launches = sweep.LAUNCHES, encode.LAUNCHES
    meta = take_outputs(genome + f".{k:02d}.kin")
    log(table)
    steps = -(-n_chunks // n_cards)
    log(f"sharded index K={k} via the CLI, --shards {n_cards}: {total_bp} bp in "
        f"{wall:.3f} s = {total_bp / wall:.0f} bp/s (verify on), {launches} sweep launches, "
        f"{enc_launches} encode launches")
    if meta["output_file_cheksum"] != want_sha or launches != steps * n_cards**2 \
            or enc_launches != steps * n_cards:
        raise AssertionError(f"CLI --shards {n_cards}: sha256, {launches} sweep or "
                             f"{enc_launches} encode launches off")

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
        _, launches, _ = run_sharded(genome, k, mesh, f"mesh 1x{n_shards} on {dev}",
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
    from pykmer_tpu_torch.ops import encode, sweep

    peak_rss = rss_sampler()
    pid, nproc, port, path, k = int(argv[0]), int(argv[1]), argv[2], argv[3], int(argv[4])
    dev = torch.device("cuda", 0)
    sweep.LAUNCHES = sweep.LAUNCHES_I64 = encode.LAUNCHES = 0
    t0 = time.perf_counter()
    header = create_fasta_index_multihost(
        path, "s", path, k, coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
        process_id=pid, verbose=False, device=dev, local_devices=[dev])
    wall = time.perf_counter() - t0
    launches, launches_i64 = sweep.LAUNCHES, sweep.LAUNCHES_I64
    print(json.dumps({
        "pid": pid, "wall_s": wall, "launches": launches, "launches_i64": launches_i64,
        "encode_launches": encode.LAUNCHES,
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

    from bench_device_step_torch import sweep_bound_ms
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
    CLI; (c) K=17 in worker mode. Returns (the K=15 worker job's sweep and
    encode launches, summed over the processes; the rows' (err, ms, plain
    ms, bound ms))."""
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
        enc_launches = sum(r["encode_launches"] for r in res)
        log(f"multi-host {label}: {total_bp} bp in {wall:.3f} s = {total_bp / wall:.0f} bp/s "
            f"(verify on), steps per process {steps}, {launches} sweep launches "
            f"({launches_i64} int64), {enc_launches} encode launches, output sha256 "
            f"{meta['output_file_cheksum']}")
        if meta["output_file_cheksum"] != want_sha:
            raise AssertionError(f"multi-host {label}: .kin sha256 differs from the "
                                 f"single-card run's")
        want_i64 = sum(steps) if 4**k // 2 > 2**31 - 1 else 0
        if launches != sum(steps) or launches_i64 != want_i64 or enc_launches != sum(steps) \
                or [r["header"] for r in res] != [True] + [False] * (n - 1):
            raise AssertionError(f"multi-host {label}: {launches} launches ({launches_i64} "
                                 f"int64), {enc_launches} encode launches for steps {steps}")
        return (launches, enc_launches), res

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
    if sys.argv[1:2] == ["--index-worker"]:
        sys.path.insert(0, ROOT)
        return index_worker(sys.argv[2:])
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

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_encode_variants
    from bench_device_step_torch import format_table, step_times

    dev = torch.device("cuda")
    t_start = t0 = time.perf_counter()
    variants_build = bench_encode_variants.start_build()  # beside the port's build
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
        enc_times, halo_launches = phase_encode(dev, variants_build)
        phase_certify_k19(dev)
        phase_merge_fanin(work, dev)
        small_fa = phase_oracle(work, dev)
        (launches, enc_launches, dec_launches, unf_launches), genome, chunks, cw, total_bp, \
            sha, choice, unf_times = phase_slice(work, dev)
        dec_times = phase_fasta(dev, genome, cw)
        gz = phase_k15_variants(work, dev, genome, total_bp, sha, cw)
        inf_launches, inf_times = phase_bgzf(work, dev, genome, total_bp, sha)
        def_launches, def_times = phase_deflate(work, dev, genome, sha)
        phase_k15_modes(dev, genome, total_bp, sha, choice)
        log(format_table(step_times(dev, chunks[len(chunks) // 2], SLICE_K, cw)))
        del chunks
        profiled_run(dev, genome, total_bp)
        phase_bench(work, genome, sha)
        num_kmers = json.load(open(genome + f".{SLICE_K:02d}.kin.json"))["num_kmers"]
        phase_merge_pair(work, dev, genome)  # removes the K=15 .kin
        phase_serve(work, dev, genome, gz, sha, num_kmers)
        sharded, step_times, rows = phase_sharded_k15(work, dev, genome, total_bp, sha)
        sharded_err = phase_sharded_vs_cpu(dev, rows)
        del rows
        phase_k17_oracle(work, dev, small_fa)
        (launches_i64, enc_launches_i64), replay_err, k17_sha, k17_peak = \
            phase_k17(work, dev, genome)
        phase_k17_pieces(work, genome, total_bp, k17_sha, k17_peak)
        phase_sharded_k17(dev, genome, total_bp, k17_sha)
        (mh_launches, _), mh_rows = phase_multihost(work, dev, genome, gz, total_bp, sha,
                                                    k17_sha)
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
    # launches: the K=15 index (phase 4), the K=17 index (phase 6), the halo
    # encoder's runs (phase 2b); times: phase 2b's masked 2^24-window chunks
    for name, n, key, replaces in (
            ("encode_packed_i32", enc_launches, ("packed", 15, "masked"),
             "pykmer_tpu/ops/encode.py:154"),
            ("encode_packed_i64", enc_launches_i64, ("packed", 17, "masked"),
             "pykmer_tpu/ops/encode.py:154"),
            ("encode_bases_i32", halo_launches[HALO_K32], ("bases", HALO_K32, "masked"),
             "pykmer_tpu/ops/encode.py:69"),
            ("encode_bases", halo_launches[HALO_K], ("bases", HALO_K, "masked"),
             "pykmer_tpu/ops/encode.py:69")):
        err, ms, plain_ms, bound_ms = enc_times[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pykmer_tpu_torch/csrc/encode.cu",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            # no PyTorch call computes canonical k-mer codes
            "library_ms": None,
        })
    # launches: the K=15 index (phase 4); times: phase 4a's steady-state segment
    err, ms, plain_ms, bound_ms = dec_times
    kernels.append({
        "name": "fasta_decode",
        "route": "cuda",
        "source": "pykmer_tpu_torch/csrc/fasta.cu",
        # the JAX package decodes on the host, with this native decoder
        "replaces": "pykmer_tpu/native/pykmer_native.cpp:1377",
        "launches": dec_launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        # no PyTorch call parses FASTA
        "library_ms": None,
    })
    # launches: the K=15 index (phase 4); times: phase 4c's slower slice
    err, ms, plain_ms, bound_ms = unf_times
    kernels.append({
        "name": "unfold_file",
        "route": "cuda",
        "source": "pykmer_tpu_torch/csrc/unfold.cu",
        # the JAX package unfolds on the host
        "replaces": "pykmer_tpu/ops/readback.py:323",
        "launches": unf_launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        # no PyTorch call unfolds a folded canonical plane
        "library_ms": None,
    })
    # launches: phase 4d's index of the BGZF copy; times: its whole file in one launch
    err, ms, plain_ms, bound_ms = inf_times
    kernels.append({
        "name": "inflate_kernel",
        "route": "cuda",
        "source": "pykmer_tpu_torch/csrc/inflate.cu",
        # the JAX package inflates a gzip input on the host, with zlib
        "replaces": "pykmer_tpu/native/pykmer_native.cpp:288",
        "launches": inf_launches,
        "max_abs_err": err,
        "ms": ms,
        # its plain version is the host's zlib, on one thread
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        # no PyTorch call inflates DEFLATE
        "library_ms": None,
    })
    # launches: phase 4e's index with bgzip; times: the kernels over its .kin, run by run
    err, ms, plain_ms, bound_ms = def_times
    kernels.append({
        "name": "deflate_kernel",
        "route": "cuda",
        "source": "pykmer_tpu_torch/csrc/deflate.cu",
        # the JAX package deflates the .kin's BGZF blocks on the host, with zlib
        "replaces": "pykmer_tpu/io/bgzf.py:35",
        "launches": def_launches,
        "max_abs_err": err,
        "ms": ms,
        # its plain version is the host's zlib: io/bgzf.bgzip_kin, every core
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        # no PyTorch call deflates
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
