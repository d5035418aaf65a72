"""Run one cell of the benchmark of ``pykmer_tpu_torch`` on this machine's card.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers that decided ``correct``, each
beside its limit. The run exits 1 without a result when CUDA is missing or
has fewer cards than the cell asks for, when the run fails, or when a module
of JAX or of the JAX package was loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    from kbench import harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.update(harness.CACHE_DIRS)

    manifest = harness.load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r}; cells: {', '.join(cells)}", file=sys.stderr)
        return 1
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    try:
        result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                                 "cuda:0", manifest=manifest, t_process=T_PROCESS)
    except Exception:
        traceback.print_exc()
        return 1
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or of the JAX package were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 1
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
