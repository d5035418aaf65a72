#!/usr/bin/env python3
"""Benchmark of the PyTorch / CUDA port: end-to-end indexing throughput (bp/s)
at K=15 on one NVIDIA GPU.

Counterpart of ``bench.py``, on ``pykmer_tpu_torch``: the same inputs
(``bench.make_genome``: a seeded synthetic genome of ``BENCH_BP`` bases,
uniform or with power-law repeat families), the same legs and the same fixed
sample schedule, the same baselines (``bench.BASELINES``: the reference's
published bp/s by K). Prints ONE JSON line on stdout: {"metric", "value",
"unit", "vs_baseline", ...}, with every run listed.

Legs, in order:

- a warm run on a 1 Mbp fixture (untimed): it builds or loads the kernel
  library (``pykmer_tpu_torch/csrc``, nvcc) and the native host library
  (g++), so no compiler time lands in a timed run;
- K (``BENCH_K``, 15) through ``create_fasta_index(..., device=)``: a fixed
  ``BENCH_RUNS`` back-to-back + ``BENCH_SPACED`` runs spaced ``BENCH_GAP_S``
  apart, then 2 runs with verify on (unless ``BENCH_VERIFY=1`` already
  verifies every run);
- the merge pair: the K-mer `.kin` and a copy of it through
  ``pykmer_tpu_torch.merge.merge``, 3 runs;
- the device step: one real chunk of the genome (the second the pipeline
  frames) through step A (``index/indexer.chunk_sorted_codes``) and step B
  (``ops/sweep.accumulate_sorted``), each stage's median time by CUDA events
  (``scripts/bench_device_step_torch.step_times``), and the step's windows/s;
- K=17 (``readback="auto"``: the pieces tail): a warm run on the fixture,
  3 back-to-back + 2 spaced runs, 2 verified; the 16 GiB outputs are removed
  afterwards;
- the merge fan-in: 39 fabricated K=13 samples, 8 of them `.kin.bgz`
  (``scripts/bench_merge_fanin_torch``), 2 runs;
- a probe of the host link before, between and after the legs: 32 MiB up
  and down, from pinned and from pageable host memory (``pcie_probes_mb_s``).

A wall-clock budget (``BENCH_BUDGET_S``, 3300 s) may cut a leg: before every
sample the worst sample so far (or a prior) must fit what is left, by the
clock only, never by a result; the JSON records planned and completed counts
and each cut. Every timed run of one K must write the first run's `.kin`
sha256 (``output_checksums``). The JSON also holds the card's name and power
limit (``nvidia-smi``), the kernels' launch counts in this process, and the
merge engine that ran. A leg that fails is recorded (``<leg>_error``), the
other legs still run, the JSON line is printed, and the process exits 1.

Knobs (environment): BENCH_K (15), BENCH_BP (840M), BENCH_VERIFY (0),
BENCH_GENOME (uniform|repeat), BENCH_RUNS (4), BENCH_SPACED (4), BENCH_GAP_S
(60), BENCH_BUDGET_S (3300), BENCH_CHUNK_WINDOWS (the device default),
BENCH_K17 (1: on the card at K=15; 0: off), and BENCH_MERGE, BENCH_FANIN (1:
on the card at K=15, as ``bench.py`` runs them on the TPU; 0: off; force: on
any device and K). The device step runs on the card at K=15. BENCH_LEG_RUNS=n,
where set, makes every leg after the first n runs (K=17: n back-to-back, none
spaced).

    python3 bench_gpu.py [--device cuda|cpu] [--bench-dir DIR]

``--device`` is ``cuda`` unless given; without a usable card the run fails.
Inputs and outputs go under ``--bench-dir`` (``bench_data/`` at the root).
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PROBE_BYTES = 32 << 20
PROBE_REPS = 5
MERGE_PAIR_REF_S = 27.03  # the reference's seconds per K=15 pair (bench.py)
FANIN_REF_S = 333 * 60 + 57  # the reference's 39-genome K=15 merge wall
FANIN_N, FANIN_K, FANIN_BGZ = 39, 13, 8
DEVICE_STEP_CHUNK = 1  # the genome's chunk the device step times (its second)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def leg_wanted(knob, on_card, kmer_len):
    """A leg's knob: "1" runs it on the card at K=15, "0" never, "force"
    always."""
    val = os.environ.get(knob, "1")
    if val not in ("0", "1", "force"):
        raise ValueError(f"{knob} must be 0, 1 or force, got {val!r}")
    return val == "force" or val == "1" and on_card and kmer_len == 15


def pcie_probe(dev, n_bytes=PROBE_BYTES):
    """MB/s of ``n_bytes`` host -> card and back, from pinned and from
    pageable host memory: the median of ``PROBE_REPS`` copies each, by the
    host clock around the copy and a synchronize."""
    import statistics

    import torch

    pageable = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8)
    pinned = pageable.pin_memory()
    out_pageable = torch.empty_like(pageable)
    out_pinned = torch.empty_like(pinned).pin_memory()
    card = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    rates = {}
    for key, dst, src in (("h2d_pageable", card, pageable), ("h2d_pinned", card, pinned),
                          ("d2h_pageable", out_pageable, card),
                          ("d2h_pinned", out_pinned, card)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(PROBE_REPS):
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        rates[key] = n_bytes / statistics.median(times) / 1e6
    if not torch.equal(out_pinned, pageable) or not torch.equal(out_pageable, pageable):
        raise AssertionError("the probe's bytes came back changed")
    return rates


def genome_chunk(fasta, kmer_len, chunk_windows, index=DEVICE_STEP_CHUNK):
    """The ``index``-th chunk (or the last, if fewer) that the index's
    pipeline frames from ``fasta``: (2-bit bases, validity bits or None)."""
    import numpy as np

    from pykmer_tpu_torch.host.pipeline import iter_pipelined_chunks

    chunk = None
    it = iter_pipelined_chunks(np.memmap(fasta, dtype=np.uint8, mode="r"), kmer_len,
                               chunk_windows, {})
    try:
        for i, (b, m) in enumerate(it):
            chunk = (b.copy(), None if m is None else m.copy())
            if i == index:
                break
    finally:
        it.close()
    return chunk


class Bench:
    """One benchmark run: the schedule, its clock budget, and the JSON."""

    def __init__(self, dev, bench_dir):
        import bench

        self.dev = dev
        self.on_card = dev.type == "cuda"
        self.bench_dir = bench_dir
        self.baselines = bench.BASELINES
        self.make_genome = bench.make_genome
        self.kmer_len = int(os.environ.get("BENCH_K", "15"))
        self.total_bp = int(os.environ.get("BENCH_BP", str(840_000_000)))
        self.verify = os.environ.get("BENCH_VERIFY", "0") == "1"
        self.genome = os.environ.get("BENCH_GENOME", "uniform")
        if self.genome not in ("uniform", "repeat"):
            raise ValueError(f"BENCH_GENOME must be uniform|repeat, got {self.genome}")
        self.n_btb = max(1, int(os.environ.get("BENCH_RUNS", "4")))
        self.n_spaced = max(0, int(os.environ.get("BENCH_SPACED", "4")))
        self.gap_s = float(os.environ.get("BENCH_GAP_S", "60"))
        self.budget_s = float(os.environ.get("BENCH_BUDGET_S", "3300"))
        leg_runs = os.environ.get("BENCH_LEG_RUNS")
        self.leg_runs = None if leg_runs is None else max(1, int(leg_runs))
        self.tag = "" if self.genome == "uniform" else "_repeat"
        self.t0 = time.time()
        self.errors = []
        where = "gpu" if self.on_card else "cpu"
        self.result = {
            "metric": f"index_bp_per_s_k{self.kmer_len}_1{where}{self.tag}",
            "unit": "bp/s",
            "device": str(dev),
            "card": card_line() if self.on_card else None,
            "protocol": (f"fixed {self.n_btb} back-to-back + {self.n_spaced} x "
                         f"{self.gap_s:.0f}s-spaced samples, best-of reported with "
                         f"full per-run list; truncation by clock budget only"),
        }

    def runs_of(self, fixed):
        return fixed if self.leg_runs is None else self.leg_runs

    def budget_left(self):
        return self.budget_s - (time.time() - self.t0)

    def run_schedule(self, label, btb, spaced_n, sample_fn, est_s=0.0):
        """The fixed schedule of one leg (``bench.run_schedule``): returns
        (values, planned, worst seconds); a cut by the clock is recorded as
        ``<label>_cut``."""
        vals, planned, worst = [], btb + spaced_n, est_s
        for i in range(planned):
            gap = self.gap_s if i >= btb else 0.0
            if (i > 0 or worst > 0.0) and self.budget_left() < gap + 1.2 * worst + 30:
                log(f"{label}: clock budget exhausted after {len(vals)}/{planned} samples "
                    f"(clock-only truncation)")
                self.result[f"{label}_cut"] = f"clock budget after {len(vals)} of {planned}"
                break
            if gap:
                time.sleep(gap)
            t0 = time.time()
            vals.append(sample_fn(i, planned))
            worst = max(worst, time.time() - t0)
        return vals, planned, worst

    def leg(self, name, fn):
        """Run one leg; a failure is logged with its traceback and recorded
        as ``<name>_error``, and the run goes on to the next leg."""
        try:
            fn()
        except Exception as exc:  # every leg reports; the exit code says it failed
            log(f"{name} leg failed:\n{traceback.format_exc()}")
            self.result[f"{name}_error"] = f"{type(exc).__name__}: {exc}"[:200]
            self.errors.append(name)

    def timed_index(self, path, k, cfg, do_verify):
        from pykmer_tpu_torch import create_fasta_index

        t0 = time.time()
        header = create_fasta_index(path, "bench", path, k, overwrite=True, config=cfg,
                                    verify=do_verify, verbose=False, device=self.dev)
        elapsed = time.time() - t0
        total_seq_bp = sum(c[1] for c in header.chromosomes)
        return total_seq_bp / elapsed, header, elapsed

    def index_leg(self, key, path, k, cfg, btb, spaced_n, do_verify, est_s=0.0):
        """Timed runs of one K; every run's `.kin` sha256 must be the first's.
        Returns (bp/s values, planned, worst seconds, checksums)."""
        sums = []

        def sample(i, planned):
            bp_s, header, elapsed = self.timed_index(path, k, cfg, do_verify)
            sums.append(header.output_file_cheksum)
            log(f"{key} run {i + 1}/{planned}: K={k} verify={do_verify} bp/s={bp_s:,.0f} "
                f"elapsed={elapsed:.3f}s num_kmers={header.num_kmers:,} sha256={sums[-1]}")
            return bp_s

        vals, planned, worst = self.run_schedule(key, btb, spaced_n, sample, est_s)
        if len(set(sums)) > 1:
            raise AssertionError(f"{key}: the runs' .kin sha256 differ: {sums}")
        return vals, planned, worst, sums

    def probe(self, where):
        """One host-link probe, on the card, into ``pcie_probes_mb_s``."""
        def run():
            self.result.setdefault("pcie_probes_mb_s", []).append(pcie_probe(self.dev))
            log(f"pcie probe ({where}): {self.result['pcie_probes_mb_s'][-1]}")

        if self.on_card:
            self.leg("pcie_probe", run)

    def run(self):
        from pykmer_tpu_torch.config import IndexConfig
        from pykmer_tpu_torch import create_fasta_index

        k = self.kmer_len
        os.makedirs(self.bench_dir, exist_ok=True)
        fasta = os.path.join(self.bench_dir, f"synthetic{self.tag}_{self.total_bp}.fa")
        t_setup = time.time()
        if not os.path.exists(fasta):
            log(f"generating {self.total_bp:,} bp {self.genome} synthetic genome at {fasta}")
            self.make_genome(fasta, self.total_bp, repeats=self.genome == "repeat")
        cw = os.environ.get("BENCH_CHUNK_WINDOWS")
        cfg = IndexConfig(kmer_len=k, **({"chunk_windows": int(cw)} if cw else {}))
        warm = os.path.join(self.bench_dir, "warm.fa")
        if not os.path.exists(warm):
            self.make_genome(warm, 1 << 20, seed=1)
        create_fasta_index(warm, "warm", warm, k, overwrite=True, config=cfg, verify=False,
                           verbose=False, device=self.dev)
        self.result["setup_s"] = time.time() - t_setup
        log(f"set-up (genome, kernel and native builds, warm run): "
            f"{self.result['setup_s']:.1f}s on {self.result['device']} "
            f"({self.result['card']})")
        self.probe("start")

        base = self.baselines.get(k)
        self.result.update(value=0, vs_baseline=None)

        def k_leg():
            runs, planned, worst, sums = self.index_leg(
                "runs", fasta, k, cfg, self.n_btb, self.n_spaced, self.verify)
            self.result.update(value=max(runs), runs=runs, runs_planned=planned,
                               output_checksums=sums)
            self.result["vs_baseline"] = max(runs) / base if base else None
            if not self.verify:
                v_runs, v_planned, _, v_sums = self.index_leg(
                    "verified_runs", fasta, k, cfg, self.runs_of(2), 0, True, 2 * worst)
                if v_sums and v_sums[0] != sums[0]:
                    raise AssertionError("the verified runs' .kin sha256 is not the timed "
                                         "runs'")
                self.result["output_checksums"] = sums + v_sums
                self.result["verified_runs_planned"] = v_planned
                if v_runs:
                    self.result.update(verified_bp_per_s=max(v_runs), verified_runs=v_runs)
                    if base:
                        self.result["verified_vs_baseline"] = max(v_runs) / base
                else:
                    self.result["verified_skipped"] = "clock budget"

        self.leg("k", k_leg)
        if leg_wanted("BENCH_MERGE", self.on_card, k):
            self.leg("merge", lambda: self.merge_pair(fasta, k))
        if self.on_card and k == 15:
            self.leg("device_step", lambda: self.device_step(fasta, k, cfg))
        self.probe("mid")
        want_k17 = os.environ.get("BENCH_K17", "1") == "1" and self.on_card and k == 15
        if want_k17 and self.budget_left() > 600:
            self.leg("k17", lambda: self.k17(fasta, warm))
        elif want_k17:
            self.result["k17_skipped"] = "clock budget"
        if leg_wanted("BENCH_FANIN", self.on_card, k):
            if self.budget_left() > 240:
                self.leg("merge_fanin", self.fanin)
            else:
                self.result["merge_fanin_skipped"] = "clock budget"
        self.probe("end")
        self.launches()

    def merge_pair(self, fasta, k):
        """The K-mer `.kin` and a copy of it merged (``bench.bench_merge_pair``)."""
        import shutil

        from pykmer_tpu_torch.merge import merge
        from pykmer_tpu_torch.merge.merger import resolve_engine

        kin = f"{fasta}.{k:02d}.kin"
        kin2 = f"{fasta}2.{k:02d}.kin"
        if not os.path.exists(kin2) or os.path.getmtime(kin2) < os.path.getmtime(kin):
            shutil.copyfile(kin, kin2)
            shutil.copyfile(f"{kin}.json", f"{kin2}.json")
        out = os.path.join(os.path.dirname(fasta), "bench_merge")
        streamed = os.path.getsize(kin) + os.path.getsize(kin2)

        def sample(i, planned):
            for suffix in (".001-255.kma", ".001-255.kma.json"):
                if os.path.exists(out + suffix):
                    os.remove(out + suffix)
            t0 = time.time()
            merge(out, [kin, kin2], verbose=False, device=self.dev)
            dt = time.time() - t0
            log(f"merge pair run {i + 1}/{planned}: {dt:.3f}s "
                f"({streamed / dt / 1e6:,.0f} MB/s streamed)")
            return dt

        times, planned, _ = self.run_schedule("merge_pair", self.runs_of(3), 0, sample)
        self.result.update(merge_pair_runs_s=times, merge_pair_runs_planned=planned,
                           merge_engine=resolve_engine("auto", 2, sharded=False))
        if times:
            best = min(times)
            self.result.update(merge_pair_s=best, merge_mb_per_s=streamed / best / 1e6,
                               merge_vs_baseline=MERGE_PAIR_REF_S / best)

    def device_step(self, fasta, k, cfg):
        """Steps A and B of one real chunk (module docstring)."""
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        from bench_device_step_torch import format_table, step_times
        from pykmer_tpu_torch.config import resolve_chunk_windows

        cw = resolve_chunk_windows(cfg, self.dev, os.path.getsize(fasta)).chunk_windows
        t = step_times(self.dev, genome_chunk(fasta, k, cw), k, cw)
        log(format_table(t))
        self.result["device_windows_per_s"] = t["windows_per_s"]
        self.result["device_step"] = t

    def k17(self, fasta, warm):
        """K=17 runs (``bench.py``'s K=17 rows); the 16 GiB outputs removed."""
        from pykmer_tpu_torch.config import IndexConfig
        from pykmer_tpu_torch import create_fasta_index

        cfg = IndexConfig(kmer_len=17)
        base = self.baselines[17]
        try:
            t0 = time.time()
            create_fasta_index(warm, "warm17", warm, 17, overwrite=True, config=cfg,
                               verify=False, verbose=False, device=self.dev)
            log(f"K=17 warm run: {time.time() - t0:.1f}s")
            btb, spaced_n = (3, 2) if self.leg_runs is None else (self.leg_runs, 0)
            runs, planned, worst, sums = self.index_leg(
                "k17_runs", fasta, 17, cfg, btb, spaced_n, self.verify)
            self.result["k17_output_checksums"] = sums
            if runs:
                self.result.update(k17_bp_per_s=max(runs), k17_runs=runs,
                                   k17_runs_planned=planned,
                                   k17_vs_baseline=max(runs) / base)
            if not self.verify and runs and self.budget_left() > 300:
                v_runs, _, _, v_sums = self.index_leg(
                    "k17_verified_runs", fasta, 17, cfg, self.runs_of(2), 0, True, 2 * worst)
                if v_sums and v_sums[0] != sums[0]:
                    raise AssertionError("the K=17 verified runs' .kin sha256 is not the "
                                         "timed runs'")
                self.result["k17_output_checksums"] = sums + v_sums
                if v_runs:
                    self.result.update(k17_verified_bp_per_s=max(v_runs),
                                       k17_verified_runs=v_runs,
                                       k17_verified_vs_baseline=max(v_runs) / base)
        finally:
            for stem in (fasta, warm):
                for suffix in (".17.kin", ".17.kin.json", ".17.kin.tmp"):
                    if os.path.exists(stem + suffix):
                        os.remove(stem + suffix)

    def fanin(self):
        """The N=39 K=13 fan-in (``bench.bench_merge_fanin``), 2 runs."""
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        from bench_merge_fanin_torch import ensure_fanin_inputs, merge_fanin

        d = os.path.join(self.bench_dir, "merge_fanin")
        t0 = time.time()
        kins = ensure_fanin_inputs(d, FANIN_N, FANIN_K, FANIN_BGZ)
        log(f"fan-in inputs ready in {time.time() - t0:.1f}s")
        engines = set()

        def sample(i, planned):
            dt, engine, _, _ = merge_fanin(d, kins, self.dev)
            engines.add(engine)
            log(f"merge fan-in N={FANIN_N} K={FANIN_K} run {i + 1}/{planned}: {dt:.3f}s "
                f"({FANIN_N * 4**FANIN_K / dt / 1e6:,.0f} MB/s streamed, engine {engine})")
            return dt

        times, planned, _ = self.run_schedule("merge_fanin", self.runs_of(2), 0, sample)
        self.result.update(merge_fanin_runs_s=times, merge_fanin_runs_planned=planned,
                           merge_fanin_n=FANIN_N, merge_fanin_k=FANIN_K,
                           merge_fanin_engine=",".join(sorted(engines)))
        if times:
            best = min(times)
            # bytes-linear extrapolation K=13 -> K=15 (x16 plane bytes)
            k15_s = best * 4**15 / 4**FANIN_K
            self.result.update(merge_fanin_s=best, merge_fanin_extrapolated_k15_s=k15_s,
                               merge_fanin_vs_baseline=FANIN_REF_S / k15_s)

    def launches(self):
        """The kernels' launches in this process; on the card a K leg that
        ran must have launched the sweep and the encode kernel."""
        from pykmer_tpu_torch.ops import compare, encode, sweep

        self.result["launches"] = {
            "sweep": sweep.LAUNCHES, "sweep_i64": sweep.LAUNCHES_I64,
            "encode_packed": encode.LAUNCHES, "encode_packed_i64": encode.LAUNCHES_I64,
            "encode_bases": encode.BASES_LAUNCHES, "merge_block_steps": compare.STEPS,
        }
        if self.on_card and self.result.get("runs") and not (sweep.LAUNCHES and encode.LAUNCHES):
            self.result["launches_error"] = "the index ran without launching its kernels"
            self.errors.append("launches")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--bench-dir", default=os.path.join(ROOT, "bench_data"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import bench  # noqa: F401  (sets the host pool's cap before the port's import)

    kmer_len = os.environ.get("BENCH_K", "15")
    try:
        from pykmer_tpu_torch import resolve_device

        run = Bench(resolve_device(args.device), os.path.abspath(args.bench_dir))
        run.run()
    except Exception as exc:  # surface failures as a valid bench line
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": f"index_bp_per_s_k{kmer_len}_1gpu", "value": 0,
                          "unit": "bp/s", "vs_baseline": 0.0,
                          "error": f"{type(exc).__name__}: {exc}"[:200]}))
        return 1
    print(json.dumps(run.result))
    return 1 if run.errors else 0


if __name__ == "__main__":
    sys.exit(main())
