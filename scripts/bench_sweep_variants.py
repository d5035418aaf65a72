#!/usr/bin/env python3
"""Time the sweep kernel's design variants on one NVIDIA GPU, in one process.

Run from the root of a checkout:  python3 scripts/bench_sweep_variants.py

Builds the port's kernels (``pykmer_tpu_torch/csrc``) and
``scripts/sweep_variants.cu`` (the port's earlier 256-thread kernel and
micro-variants of it, the tiled design at several shapes and tile orders,
and two diagnostics) with nvcc for sm_90a, then at the two shapes of
``chip_smoke.py``'s phase 2 (the K=15 shape: 2^24 sorted int32 codes on a
2^29-cell plane; the K=17 shape: 2^24 int64 codes on a 2^33-cell plane)
checks every sweep variant byte for byte against the plain torch sweep and
times it: the median of 20 launches (CUDA events), in two rounds, the
second in the reverse order. Each time is printed beside the sector-counted bound of
``scripts/bench_device_step_torch.sweep_bound_ms`` and its share of it. The last line is a JSON
object of every time. The card's name and power limit come first.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "scripts", "sweep_variants.cu")
# pykmer_sweep_sorted: the port's kernel (csrc/sweep.cu, from the port's own
# build); the others from scripts/sweep_variants.cu; diag_*: diagnostics, not
# the sweep's function (not checked)
VARIANTS = ("pykmer_sweep_sorted", "sweep_gridstride_256", "sweep_gridstride_128", "sweep_gridstride_1024",
            "sweep_gridstride_256_cs", "sweep_gridstride_256_cg", "sweep_gridstride_1024_wt",
            "sweep_gridstride_1024_stcs", "sweep_tiles_4_2", "sweep_tiles_16_2",
            "sweep_tiles_16_3", "sweep_tiles_4_2_il", "sweep_tiles_16_2_il",
            "sweep_tiles_8_2_nb", "sweep_tiles_16_2_nb", "sweep_tiles_4_2_il_nb",
            "diag_read", "diag_write")
REPS = 20


def build():
    from pykmer_tpu_torch.ops import _build

    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update(open(SRC, "rb").read())
    so = os.path.join(_build.BUILD_DIR, f"libsweep_variants_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True)
        print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode})")
        os.replace(tmp, so)
    lab, port = ctypes.CDLL(so), _build.load()
    fns = {}
    for v in VARIANTS:
        for suffix in ("_i32", "_i64"):
            fn = getattr(port if v == "pykmer_sweep_sorted" else lab, v + suffix)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[v + suffix] = fn
    return fns


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_sweep_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from bench_device_step_torch import sweep_bound_ms
    from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    fns = build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    shapes = []
    hot = rng.integers(0, cs.K15_CELLS, size=64)
    shapes.append(("K=15 shape, int32", cs.K15_CELLS, hot, cs.sorted_batch(
        rng, cs.K15_CELLS, cs.K15_CODES, hot, np.int32)))
    hot = rng.integers(1 << 31, cs.K17_CELLS, size=64)
    codes = cs.sorted_batch(rng, cs.K17_CELLS, cs.K17_CODES, hot, np.int64)
    codes[-10:] = 1 << 40
    shapes.append(("K=17 shape, int64", cs.K17_CELLS, hot, codes))

    result = {}
    for label, cells, hot, codes_np in shapes:
        codes = torch.from_numpy(codes_np).to(dev)
        suffix = "_i32" if codes.dtype == torch.int32 else "_i64"
        bound, sectors, moved = sweep_bound_ms([codes], cells)
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        base = torch.randint(0, 256, (cells,), dtype=torch.uint8, device=dev, generator=g)
        want = base.clone()
        saturating_accumulate_sorted(want, codes)
        plane = torch.empty_like(base)
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn):
            err = fn(plane.data_ptr(), cells, codes.data_ptr(), codes.numel(), stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")

        for v in VARIANTS:
            if v.startswith("diag_"):
                continue
            plane.copy_(base)
            run(fns[v + suffix])
            torch.cuda.synchronize()
            if not torch.equal(plane, want):
                raise AssertionError(f"{label}: {v} differs from the plain sweep "
                                     f"(max abs err {cs.max_abs_err(plane, want)})")
        del want, base
        print(f"{label}: every sweep variant equal to the plain sweep; bound {bound:.4f} ms "
              f"({sectors} distinct in-range sectors, {moved} bytes)", flush=True)
        times = {v: [] for v in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for v in order:
                fn = fns[v + suffix]
                times[v].append(cs.median_ms(lambda: run(fn), REPS))
        for v in VARIANTS:
            best = min(times[v])
            print(f"  {v:22s} {times[v]} ms -> best {best:.4f} ms, share of bound "
                  f"{bound / best:.3f}", flush=True)
        result[label] = {"bound_ms": bound, "ms": times}
        del plane, codes
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
