#!/usr/bin/env python3
"""Certify the K=19 mechanisms of the PyTorch / CUDA port at reduced scale.

Counterpart of ``scripts/certify_k19_sharded.py``. At K=19 the folded plane is
2^37 cells (128 GiB of uint8): one 80 GB card cannot hold it, so the single-card
index takes the host strategy, and a sharded build needs the plane split over
cards. This script checks every K=19-specific mechanism on the fixture of the
JAX script (``build_fixture``: ~620 kbp of random bases, N runs, a motif tiled
300 times) against the port's numpy oracle (``pykmer_tpu_torch.oracle``):

 A. the halo encoder (``parallel/encode.make_halo_encode``) at K=19 on 8
    shards (``[cuda:0] * 8`` on the card): int64 canonical codes above 2^37;
 B. ``sort_codes_fast`` on the folded int64 codes with trailing sentinels,
    which sort last;
 C. the plan at full size: ``config.resolve_strategy`` picks ``host`` at K=19
    on an 80 GB card; the per-shard plane bytes at S = 2, 4, 8, 16 over the
    full 2^37-cell plane, and the smallest S whose shard fits the card's free
    memory; one sharded step (``parallel/histogram.make_sharded_accumulate``)
    at K=19 on 8 logical shards whose planes are reduced to 2^22-cell windows
    of each shard's 2^34 local cells: the step itself into the windows at
    local cell 0, then the step's received rows applied at local windows
    above 2^32 (``rows - base``);
 D. the sweep (``ops/sweep.accumulate_sorted``, on the card the int64
    kernel) on a 2^22-cell window plane at window bases spanning the 2^37
    range (bottom, middle, top above 2^32, and the motif's cell): each window
    gets ``sorted_codes - base``, whose codes below 0 or at or above the
    window's cells the sweep ignores; every touched cell equals the oracle,
    no other cell is nonzero, and one window holds a 255;
 E. ``index/indexer.accumulate_host`` at K=19 over the fixture's chunks (step
    A on the device, the saturating update into a host plane): the cells it
    writes are exactly the oracle's, with its counts, and so is the k-mer
    count. ``accumulate_host`` allocates its plane with
    ``utils/bigmem.big_zeros``, a populated 2^37-byte map, which no 96 GiB
    host holds (the run says what the host has, and whether its kernel grants
    even an unpopulated map of that size). Nor does a lazily faulted map do:
    where anonymous memory is handed out in 2 MiB units (16 writes took 32 MiB
    on the H100 machine), a plane written all over takes its whole size. So
    ``accumulate_host`` gets a plane of 2^37 cells that holds only the cells
    written (``sparse_plane``): the function runs unchanged, at the full
    index range.

Torch has no ahead-of-time lowering, so part C of the JAX script (the step
lowered at full shapes without allocating) has no counterpart.

    python3 scripts/certify_k19_torch.py [--device cuda|cpu]

Runs on the card unless given ``--device cpu``, and raises where CUDA is
missing. About a minute on the CPU (the oracle is a Python loop), under 1 GB of
host memory.
"""

import mmap
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KMER_LEN = 19
FOLD_SIZE = 4**KMER_LEN // 2  # 2^37
WINDOW_CELLS = 1 << 22  # the reduced window plane (the mechanism is size-blind)
SHARDS = 8
PLAN_SHARDS = (2, 4, 8, 16)
CARD_BYTES = 80 * 10**9  # an 80 GB card, for the plan off the card
HOST_CHUNK_WINDOWS = 1 << 17  # part E: the fixture in several chunks
FIXTURE_SEED = 19  # the JAX script's


def log(msg):
    print(msg, flush=True)


def build_fixture(rng, piece=100_000, n_pieces=6):
    """~620 kbp mostly-N-free random sequence (dense, uniform folded codes
    across the full 2^37 range) plus sparse N runs (valid-window gating) and
    a motif tiled 300x (drives K=19 cells to the 255 ceiling): the fixture of
    ``scripts/certify_k19_sharded.build_fixture`` at its defaults; tests take
    smaller pieces."""
    import numpy as np

    pieces = []
    motif = np.tile(rng.integers(0, 4, size=KMER_LEN).astype(np.uint8), 300)
    for _ in range(n_pieces):
        pieces.append(rng.integers(0, 4, size=piece).astype(np.uint8))
        pieces.append(rng.integers(0, 5, size=2_000).astype(np.uint8))
        pieces.append(motif)
    return np.concatenate(pieces)


def oracle_codes(seq):
    """(canonical codes of every valid window in order, their folded codes)."""
    import numpy as np

    from pykmer_tpu_torch.oracle import oracle_canonical_codes

    codes = oracle_canonical_codes(seq, KMER_LEN)
    return codes, np.minimum(codes, np.int64(4**KMER_LEN - 1) - codes)


def part_a_halo_encode(seq, want_codes, dev):
    import numpy as np
    import torch

    from pykmer_tpu_torch.parallel import make_halo_encode, make_mesh

    mesh = make_mesh(SHARDS, devices=[dev] * SHARDS)
    shard_len = -(-seq.shape[0] // SHARDS)
    pad = np.full(shard_len * SHARDS - seq.shape[0], 4, np.uint8)
    got = make_halo_encode(mesh, KMER_LEN, shard_len)(np.concatenate([seq, pad]))
    if got.dtype != torch.int64:
        raise AssertionError(f"halo encode K=19 gave {got.dtype} codes")
    got = got.cpu().numpy()
    if not np.array_equal(got[got < 4**KMER_LEN], want_codes):
        raise AssertionError("A. halo encode K=19 differs from the oracle")
    if int(want_codes.max()) <= 2**37:
        raise AssertionError("A. the fixture must give codes above 2^37")
    log(f"A. halo encode K=19 on {dev} x{SHARDS}: {want_codes.shape[0]:,} codes, max "
        f"{int(want_codes.max()):,} (> 2^37), equal to the oracle")


def part_b_sort(folded, dev):
    """Returns the sorted valid folded codes (numpy)."""
    import numpy as np
    import torch

    from pykmer_tpu_torch.ops.histogram import sort_codes_fast

    stream = np.concatenate([folded, np.full(1024, FOLD_SIZE, np.int64)])
    got = sort_codes_fast(torch.from_numpy(stream).to(dev)).cpu().numpy()
    want = np.sort(stream)
    if not np.array_equal(got, want) or got[-1] != FOLD_SIZE:
        raise AssertionError("B. int64 sort at K=19 differs from np.sort, or the "
                             "sentinels do not sort last")
    log(f"B. sort_codes_fast int64 K=19 on {dev}: {stream.shape[0]:,} keys (sentinels "
        f"last), equal to np.sort")
    return want[: folded.shape[0]]


def window_bases(codes, motif_code, width=WINDOW_CELLS):
    """Window bases (multiples of ``width``) of the bottom, middle and top of
    the sorted ``codes`` and of ``motif_code``."""
    picks = (codes[0], codes[codes.shape[0] // 2], codes[-1], motif_code)
    return sorted({int(c) // width * width for c in picks})


def check_window(got, uniq, counts, base, label, allow_empty=False):
    """``got`` (numpy, one window of cells from ``base``) against the oracle's
    (uniq, counts) in that window: every touched cell equal, no other cell
    nonzero. Returns (the window's largest value, its oracle cells)."""
    import numpy as np

    in_w = (uniq >= base) & (uniq < base + got.shape[0])
    cells = uniq[in_w] - base
    want = np.minimum(counts[in_w], 255).astype(np.uint8)
    if cells.shape[0] == 0 and not allow_empty:
        raise AssertionError(f"{label} @{base:,}: no oracle cell in the window")
    if cells.shape[0] == 0:
        if np.count_nonzero(got):
            raise AssertionError(f"{label} @{base:,}: stray nonzeros")
        return 0, 0
    if not np.array_equal(got[cells], want):
        raise AssertionError(f"{label} @{base:,}: a touched cell differs from the oracle")
    if int(got.astype(np.int64).sum()) != int(want.astype(np.int64).sum()):
        raise AssertionError(f"{label} @{base:,}: stray nonzeros")
    return int(want.max()), cells.shape[0]


def shard_plan(free_bytes, chunk_windows):
    """Per-shard bytes of the full K=19 plane at each S of ``PLAN_SHARDS``
    (the local plane plus step A's workspace), and the smallest S whose shard
    fits ``free_bytes``."""
    from pykmer_tpu_torch.config import STEP_A_BYTES_PER_WINDOW

    rows = [(s, FOLD_SIZE // s, FOLD_SIZE // s + STEP_A_BYTES_PER_WINDOW * chunk_windows)
            for s in PLAN_SHARDS]
    fit = next((s for s, _, need in rows if need <= free_bytes), None)
    return rows, fit


def sharded_step_windows(seq, uniq, counts, nk_want, dev, motif_code):
    """Part C's step (module docstring); returns the local bases checked."""
    import numpy as np
    import torch

    from pykmer_tpu_torch.host.chunks import chunk_stream
    from pykmer_tpu_torch.ops.sweep import accumulate_sorted
    from pykmer_tpu_torch.parallel import make_mesh, make_sharded_accumulate
    from pykmer_tpu_torch.parallel.histogram import shard_batch_chunks_packed

    n_windows = seq.shape[0] - KMER_LEN + 1
    cw = (-(-n_windows // SHARDS) + 7) // 8 * 8  # one step of 8 rows covers the fixture
    mesh = make_mesh(SHARDS, devices=[dev] * SHARDS)
    _, step_fn = make_sharded_accumulate(mesh, KMER_LEN, cw)
    if step_fn.local_size != FOLD_SIZE // SHARDS:
        raise AssertionError(f"local plane {step_fn.local_size} cells")
    padded, n_chunks = chunk_stream(seq, KMER_LEN, cw)
    if n_chunks > SHARDS:
        raise AssertionError(f"{n_chunks} chunks for one step of {SHARDS} rows")
    rows = shard_batch_chunks_packed(padded, KMER_LEN, cw, SHARDS, 0)
    local_of = [(uniq[uniq % SHARDS == s] // SHARDS, counts[uniq % SHARDS == s])
                for s in range(SHARDS)]

    # the step itself, its planes reduced to each shard's first window
    zero = torch.zeros((), dtype=torch.int64, device=mesh.first)
    planes = [[torch.zeros(WINDOW_CELLS, dtype=torch.uint8, device=d) for d in mesh.devices[0]]]
    planes, nk, maxb = step_fn((planes, zero, zero.clone()), rows)
    if int(nk) != nk_want or int(maxb) > step_fn.capacity:
        raise AssertionError(f"C. sharded step: {int(nk)} valid windows (oracle {nk_want}), "
                             f"largest bucket {int(maxb)} of {step_fn.capacity}")
    hits = sum(check_window(plane.cpu().numpy(), *local_of[s], 0, f"C. shard {s} window",
                            allow_empty=True)[1] for s, plane in enumerate(planes[0]))

    # the same step's received rows at local windows above 2^32
    sends = [[step_fn.bucket(torch.from_numpy(rows[0][p]).to(d),
                             torch.from_numpy(rows[1][p]).to(d))[0]
              for p, d in enumerate(mesh.devices[0])]]
    received = step_fn.exchange(sends)[0]
    locals_all = np.sort(uniq // SHARDS)
    bases = [b for b in window_bases(locals_all, motif_code // SHARDS) if b > 2**32]
    if not bases:
        raise AssertionError("C. no local window above 2^32")
    for base in bases:
        for s, recv in enumerate(received):
            if recv.dtype != torch.int64:
                raise AssertionError(f"C. local codes are {recv.dtype}, not int64")
            win = torch.zeros(WINDOW_CELLS, dtype=torch.uint8, device=mesh.devices[0][s])
            for row in recv:
                accumulate_sorted(win, row - base)
            hits += check_window(win.cpu().numpy(), *local_of[s], base,
                                 f"C. shard {s} window", allow_empty=True)[1]
    log(f"C. sharded step K=19 on {dev} x{SHARDS} ({cw:,} windows a row, local planes "
        f"of {step_fn.local_size:,} cells reduced to {WINDOW_CELLS:,}-cell windows): "
        f"{int(nk):,} valid windows, largest bucket {int(maxb)} of {step_fn.capacity}; "
        f"windows at local cell 0 and at {bases} (> 2^32): {hits:,} touched cells equal "
        f"to the oracle")
    return bases


def part_c_plan(seq, uniq, counts, nk_want, dev, motif_code):
    import torch

    from pykmer_tpu_torch.config import CUDA_CHUNK_WINDOWS, resolve_strategy

    if dev.type == "cuda":
        free, where = torch.cuda.mem_get_info(dev)[0], f"{dev}'s free memory"
    else:
        free, where = CARD_BYTES, "an 80 GB card"
    strategy = resolve_strategy(KMER_LEN, "auto", "cuda", free, CUDA_CHUNK_WINDOWS)
    if strategy != "host":
        raise AssertionError(f"C. resolve_strategy(19) picks {strategy} with {free} bytes")
    rows, fit = shard_plan(free, CUDA_CHUNK_WINDOWS)
    table = ", ".join(f"S={s}: {local:,} cells / {need:,} bytes" for s, local, need in rows)
    log(f"C. plan K=19 against {where} ({free:,} bytes): strategy host; per shard {table}; "
        f"smallest S that fits: {fit}")
    if fit is None:
        raise AssertionError("C. no shard count of the plan fits one card")
    sharded_step_windows(seq, uniq, counts, nk_want, dev, motif_code)
    return fit


def part_d_window_sweep(sorted_folded, dev):
    """Returns the bases swept."""
    import numpy as np
    import torch

    from pykmer_tpu_torch.ops import sweep

    uniq, counts = np.unique(sorted_folded, return_counts=True)
    bases = window_bases(sorted_folded, int(uniq[counts.argmax()]))
    if max(bases) <= 2**32:
        raise AssertionError("D. the top window must lie above 2^32")
    stream = torch.from_numpy(sorted_folded).to(dev)
    sat = False
    for base in bases:
        t0 = time.monotonic()
        plane = torch.zeros(WINDOW_CELLS, dtype=torch.uint8, device=dev)
        launches = sweep.LAUNCHES_I64
        sweep.accumulate_sorted(plane, stream - base)
        got = plane.cpu().numpy()
        top, n = check_window(got, uniq, counts, base, "D. sweep window")
        sat |= top == 255
        kernel = sweep.LAUNCHES_I64 - launches
        if dev.type == "cuda" and kernel != 1:
            raise AssertionError(f"D. {kernel} int64 sweep launches for one window")
        log(f"D. sweep window @ base {base:,} on {dev}: {n:,} cells equal to the oracle, "
            f"max {top}, {kernel} int64 kernel launch, {time.monotonic() - t0:.2f}s")
    if not sat:
        raise AssertionError("D. no window holds a saturated (255) cell")
    return bases


def big_zeros_refusal():
    """Why ``big_zeros``'s populated 2^37-byte map is not used here: the
    host's MemAvailable (the map must fit it) and what the kernel answers to
    an accounted, unpopulated map of that size. The populated map itself is
    never tried: on a host that cannot hold it, it would take all memory."""
    with open("/proc/meminfo") as fh:
        info = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in fh if ln.strip()}
    try:
        mmap.mmap(-1, FOLD_SIZE, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS).close()
        probe = "an unpopulated map of that size is granted"
    except OSError as exc:
        probe = f"the kernel refuses even an unpopulated map of that size ({exc})"
    return f"MemAvailable {info.get('MemAvailable', 0):,} bytes; {probe}"


def sparse_plane(n):
    """A zero uint8 plane of ``n`` cells that holds only the cells written
    into it; stands in for ``big_zeros`` in part E."""
    import numpy as np

    class SparsePlane(np.ndarray):
        """``n`` cells over one zero byte (stride 0): integer-array reads
        and writes go to ``cells``, a dict of the cells written."""

        def __getitem__(self, idx):
            if isinstance(idx, np.ndarray) and idx.dtype.kind in "iu":
                return np.fromiter((self.cells.get(i, 0) for i in idx.tolist()), np.uint8,
                                   idx.shape[0])
            return super().__getitem__(idx)

        def __setitem__(self, idx, vals):
            if not (isinstance(idx, np.ndarray) and idx.dtype.kind in "iu"):
                raise TypeError(f"a sparse plane takes integer-array writes, not {type(idx)}")
            self.cells.update(zip(idx.tolist(), np.broadcast_to(vals, idx.shape).tolist()))

    plane = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), shape=(n,),
                                            strides=(0,)).view(SparsePlane)
    plane.cells = {}
    return plane


def part_e_accumulate_host(seq, uniq, counts, nk_want, dev, cw=HOST_CHUNK_WINDOWS):
    import numpy as np

    from pykmer_tpu_torch.host.chunks import chunk_stream, iter_chunks_packed_lazy
    from pykmer_tpu_torch.index import indexer

    padded, n_chunks = chunk_stream(seq, KMER_LEN, cw)
    chunks = iter_chunks_packed_lazy(padded, KMER_LEN, cw, n_chunks)
    log(f"E. big_zeros's populated {FOLD_SIZE:,}-byte map is not used "
        f"({big_zeros_refusal()}): accumulate_host gets a plane of {FOLD_SIZE:,} cells "
        f"that holds only the cells written")
    planes = []
    real = indexer.big_zeros
    indexer.big_zeros = lambda n: planes.append(sparse_plane(n)) or planes[-1]
    try:
        plane, nk = indexer.accumulate_host(chunks, KMER_LEN, cw, dev)
    finally:
        indexer.big_zeros = real
    if tuple(plane.shape) != (FOLD_SIZE,) or len(planes) != 1:
        raise AssertionError(f"E. host plane of {tuple(plane.shape)} cells")
    cells = planes[0].cells
    got_idx = np.fromiter(sorted(cells), np.int64, len(cells))
    got = np.fromiter((cells[i] for i in got_idx.tolist()), np.int64, len(cells))
    want = np.minimum(counts, 255)
    if not np.array_equal(got_idx, uniq):
        raise AssertionError(f"E. accumulate_host wrote {len(cells)} cells, the oracle "
                             f"touches {uniq.shape[0]}")
    if not np.array_equal(got, want):
        raise AssertionError("E. accumulate_host: a touched cell differs from the oracle")
    if nk != nk_want:
        raise AssertionError(f"E. accumulate_host counted {nk} k-mers, the oracle {nk_want}")
    log(f"E. accumulate_host K=19 on {dev} ({n_chunks} chunks of {cw:,} windows): the "
        f"{uniq.shape[0]:,} cells it wrote ({int((uniq >= 2**32).sum()):,} above 2^32, "
        f"max {int(want.max())}) are the oracle's cells with its counts, num_kmers "
        f"{nk:,} the oracle's")


def certify(dev, seq, parts="ABCDE"):
    """Run ``parts`` of the certification on ``seq`` (module docstring)."""
    import numpy as np

    t0 = time.monotonic()
    want_codes, folded = oracle_codes(seq)
    log(f"oracle: {want_codes.shape[0]:,} K=19 codes in {time.monotonic() - t0:.1f}s")
    uniq, counts = np.unique(folded, return_counts=True)
    motif_code = int(uniq[counts.argmax()])
    if "A" in parts:
        part_a_halo_encode(seq, want_codes, dev)
    sorted_folded = part_b_sort(folded, dev) if "B" in parts or "D" in parts \
        else np.sort(folded)
    if "C" in parts:
        part_c_plan(seq, uniq, counts, folded.shape[0], dev, motif_code)
    if "D" in parts:
        part_d_window_sweep(sorted_folded, dev)
    if "E" in parts:
        part_e_accumulate_host(seq, uniq, counts, folded.shape[0], dev)


def main(argv):
    import numpy as np
    import torch

    from pykmer_tpu_torch import resolve_device

    dev = resolve_device(argv[argv.index("--device") + 1] if "--device" in argv else "cuda")
    if dev.type == "cuda":
        from bench_gpu import card_line

        log(card_line())
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(dev)}")
    t0 = time.monotonic()
    certify(dev, build_fixture(np.random.default_rng(FIXTURE_SEED)))
    log(f"K=19 certification PASSED on {dev} in {time.monotonic() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
