"""A/B of the port's `index` between another checkout and this one, on one card.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/ab_torch_index.py build/parent

Writes the seeded 256 Mbp genome of ``chip_smoke.py`` under ``build/ab``,
then runs parent, this tree, this tree, parent: each a fresh process that
builds or loads its kernels, initialises CUDA and indexes the genome twice at
K=15 with the stage table on (``PYKMER_TPU_STAGE_TIMING=1``), printing each
run's wall time. Then this tree alone: once with ``--accumulate host`` and
once at K=17 (a 16 GiB `.kin`, removed afterwards). Needs CUDA; prints the
card's name and power limit first.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME_BP = 256_000_000

DRIVER = r"""
import os, sys, time, torch
from pykmer_tpu_torch.ops import _build
from pykmer_tpu_torch import cli
_build.load()
torch.zeros(1, device="cuda"); torch.cuda.synchronize()
os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
genome, reps, k, extra = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4:]
for run in range(reps):
    t0 = time.perf_counter()
    rc = cli.main(["index", genome, "s", k, "--device", "cuda", "--quiet", *extra])
    print(f"RUN {run} rc {rc} wall_s {time.perf_counter() - t0:.4f}", file=sys.stderr,
          flush=True)
"""


def run(tree, genome, reps, k=15, extra=()):
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", DRIVER, genome, str(reps), str(k), *extra],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    print(f"===== {tree} K={k} {' '.join(extra)} rc={proc.returncode}")
    print(proc.stderr[-6000:], flush=True)
    if proc.returncode:
        raise SystemExit(f"{tree}: index failed\n{proc.stdout[-2000:]}")


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = os.path.abspath(sys.argv[1])
    sys.path.insert(0, ROOT)
    import bench

    work = os.path.join(ROOT, "build", "ab")
    os.makedirs(work, exist_ok=True)
    genome = os.path.join(work, "genome.fa")
    t0 = time.perf_counter()
    bench.make_genome(genome, GENOME_BP, seed=0, repeats=True)
    print(f"genome: {GENOME_BP} bp written in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    for tree in (parent, ROOT, ROOT, parent):
        run(tree, genome, 2)
    run(ROOT, genome, 1, extra=("--accumulate", "host"))
    run(ROOT, genome, 1, k=17)
    for ext in (".17.kin", ".17.kin.json"):
        os.remove(genome + ext)


if __name__ == "__main__":
    main()
