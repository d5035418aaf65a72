"""The control of a cell: the plain reference with one guarantee of the
configuration broken, put in the program's place, and judged by the cell's
own comparison. It has to come out as not correct.

    python3 kbench/control.py --workload <cell> --seeds <n> [<n> ...]

Each seed makes the cell's inputs on the card, runs the control once where
the window's first call would run, and prints the numbers the check compares, each beside
its limit, as one JSON line. The index cells' control lets a cell's count
wrap at 256 instead of saturating at 255. The benchmark's runs never run
it.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    import argparse

    from kbench import harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    os.environ.update(harness.CACHE_DIRS)
    manifest = harness.load_manifest()
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload),
                {"traffic": args.workload})
    kind = harness.code_file("jobs", harness.data_file("workloads", cell["traffic"])["job"])
    worst = {}
    for seed in args.seeds:
        result = harness.execute(args.workload, seed, 0.0, False, "cuda:0",
                                 manifest=manifest, call=kind.control, say=lambda s: None)
        readings = {k: v["value"] for k, v in result["check"].items()}
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": result["correct"], "check": result["check"]}),
              flush=True)
        for k, v in readings.items():
            worst[k] = min(worst.get(k, v), v)
    print(json.dumps({"control": args.workload, "smallest_readings": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
