#!/usr/bin/env python3
"""Index walls of two checkouts of the port on one NVIDIA GPU, in turns.

Run from the root of a checkout:

    python3 ab_index.py <checkout A> <checkout B> [--rounds N] [--k K ...]

Writes the seeded 256 Mbp genome with repeat families that ``chip_smoke.py``
indexes (``bench.make_genome``) under ``build/ab/``, then at each K runs A, B,
B, A for each round. Each run is a fresh process that imports that
checkout's ``pykmer_tpu_torch``, builds its host library and kernels and
initialises CUDA untimed, then times one ``index`` through the CLI entry
(``cli.main``, verify on, ``--device cuda``) and reports its wall, its stage
table and the `.kin`'s sha256; the outputs are removed after each run.
Every run at one K must write the same sha256. The card's name and power limit come first, a
JSON object of every wall last. Needs ~17 GiB of free disk at K=17.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 256_000_000
SEED = 0


def run_one(root, genome, k):
    """Worker mode: one timed index from checkout ``root``; prints JSON."""
    sys.path.insert(0, root)
    import torch

    from pykmer_tpu_torch import cli
    from pykmer_tpu_torch.io import native  # noqa: F401  builds the host library
    from pykmer_tpu_torch.ops import _build

    _build.load()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    t0 = time.perf_counter()
    rc = cli.main(["index", genome, "s", str(k), "--device", "cuda", "--quiet"])
    wall = time.perf_counter() - t0
    kin = genome + f".{k:02d}.kin"
    with open(kin + ".json") as fh:
        sha = json.load(fh)["output_file_cheksum"]
    os.remove(kin)
    os.remove(kin + ".json")
    print(json.dumps({"rc": rc, "wall_s": wall, "sha256": sha}), flush=True)
    return rc


def main():
    if sys.argv[1:2] == ["--run"]:
        return run_one(*sys.argv[2:4], int(sys.argv[4]))
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--k", type=int, nargs="+", default=[15])
    args = ap.parse_args()
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"A = {roots['A']}, B = {roots['B']}", flush=True)

    sys.path.insert(0, ROOT)
    import bench

    work = os.path.join(ROOT, "build", "ab")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    genome = os.path.join(work, "genome.fa")
    bench.make_genome(genome, GENOME_BP, seed=SEED, repeats=True)
    walls = {}
    try:
        for k in args.k:
            shas = set()
            for r in range(args.rounds):
                for side in "ABBA":
                    proc = subprocess.run(
                        [sys.executable, os.path.abspath(__file__), "--run", roots[side],
                         genome, str(k)], capture_output=True, text=True, timeout=900)
                    if proc.returncode != 0:
                        raise RuntimeError(f"{side} K={k} failed ({proc.returncode}):\n"
                                           f"{proc.stderr[-4000:]}")
                    res = json.loads(proc.stdout.strip().splitlines()[-1])
                    shas.add(res["sha256"])
                    walls.setdefault(f"K={k} {side}", []).append(res["wall_s"])
                    print(f"K={k} round {r} {side}: {res['wall_s']:.3f} s, sha256 "
                          f"{res['sha256']}\n{proc.stderr.strip()}", flush=True)
            if len(shas) != 1:
                raise AssertionError(f"K={k}: the runs wrote different .kin files: {shas}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(walls))
    return 0


if __name__ == "__main__":
    sys.exit(main())
