"""The benchmark's driver: finds a cell's files by name, makes its inputs,
runs its window of jobs, judges what the window wrote, reads its metrics
and prints the result.

Everything that belongs to one configuration, traffic mix, job kind or
per-layer metric is a file of its own under ``kbench/``, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (sizes and guarantees);
- ``workloads/<traffic>.json``: the traffic mix (its job kind and
  parameters);
- ``jobs/<kind>.py``: ``setup(run)``, ``call(run, i)``,
  ``end_to_end(run)``, ``check(run)``, ``control(run, i)``;
- ``metrics/<metric>.py``: ``read(run)``, a number or None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import sys
import time
from typing import Any, Callable, Dict, List, Optional

KBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KBENCH)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
RUN_DIR = os.path.join(ROOT, "build", "kbench", "run")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
              "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton")}
FORBIDDEN = ("jax", "jaxlib", "flax", "pykmer_tpu", "bench", "bench_gpu", "scripts")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(path: str = MANIFEST) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def data_file(kind: str, name: str) -> Dict[str, Any]:
    """``kbench/<kind>/<name>.json`` as a dict."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    with open(os.path.join(KBENCH, kind, f"{name}.json")) as fh:
        return json.load(fh)


def code_file(kind: str, name: str):
    """``kbench/<kind>/<name>.py`` as a module (the name may hold dots)."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(KBENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"kbench.{kind}.{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest_errors(manifest: Dict[str, Any]) -> List[str]:
    """What in ``manifest`` breaks the naming rules or names a file that is
    not there."""
    errors = []
    metrics = manifest.get("end_to_end", []) + manifest.get("per_layer", [])
    names = [c["name"] for c in manifest.get("configs", [])] \
        + [w["name"] for w in manifest.get("workloads", [])] + [m["name"] for m in metrics]
    for name in names:
        if not NAME.match(name):
            errors.append(f"bad name {name!r}")
    for m in metrics:
        if not UNIT.match(m.get("unit", "")):
            errors.append(f"bad unit {m.get('unit')!r} of {m['name']}")
    for c in manifest.get("configs", []):
        if not os.path.exists(os.path.join(ROOT, c["file"])):
            errors.append(f"missing {c['file']}")
    for w in manifest.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                errors.append(f"bad {key} {w[key]!r}")
        if not os.path.exists(os.path.join(KBENCH, "workloads", f"{w['traffic']}.json")):
            errors.append(f"missing workloads/{w['traffic']}.json")
    for m in manifest.get("per_layer", []):
        if not os.path.exists(os.path.join(KBENCH, "metrics", f"{m['name']}.py")):
            errors.append(f"missing metrics/{m['name']}.py")
    return errors


def metrics_of(manifest: Dict[str, Any], section: str, cell: str) -> List[Dict[str, Any]]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Job:
    """One call in the window: its host-clock span and what it recorded."""

    index: int
    start: float
    end: float
    result: Dict[str, Any]
    stderr: str = ""
    error: Optional[str] = None

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Run:
    """What a run knows: its configuration, traffic and seed, and the
    window's jobs. The job kind keeps its own state in ``state`` and the
    sizes the reference works out in ``work``."""

    config: Dict[str, Any]
    workload: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    directory: str
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)
    jobs: List[Job] = dataclasses.field(default_factory=list)
    device_trace: Any = None
    memory_peak: int = 0

    @property
    def window_s(self) -> float:
        return self.jobs[-1].end - self.jobs[0].start if self.jobs else 0.0

    @property
    def completed(self) -> List[Job]:
        return [j for j in self.jobs if j.error is None]


def run_window(run: Run, call: Callable[[Run, int], Dict[str, Any]],
               after: Callable[[], None] = lambda: None,
               clock: Callable[[], float] = time.perf_counter) -> None:
    """Calls back to back until ``run.seconds`` have passed since the first
    began; the last runs to its end. A call that raises ends the window.
    ``after`` runs after each call, outside its span."""
    first = None
    while True:
        out = io.StringIO()
        start = clock()
        first = start if first is None else first
        try:
            with contextlib.redirect_stderr(out) if run.trace else contextlib.nullcontext():
                result, error = call(run, len(run.jobs)), None
        except Exception as exc:  # the run reports it and judges itself wrong
            result, error = {}, f"{type(exc).__name__}: {exc}"
        end = clock()
        run.jobs.append(Job(len(run.jobs), start, end, result, out.getvalue(), error))
        after()
        if error is not None or end - first >= run.seconds:
            return


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})


def dir_bytes(directory: str) -> int:
    """Bytes of the regular files under ``directory``."""
    total = 0
    for parent, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(parent, name)
            if not os.path.islink(path):
                total += os.path.getsize(path)
    return total


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: Any,
            manifest: Optional[Dict[str, Any]] = None, config: Optional[Dict] = None,
            workload: Optional[Dict] = None, t_process: Optional[float] = None,
            say: Callable[[str], None] = lambda s: print(s, flush=True),
            call: Optional[Callable] = None, directory: str = RUN_DIR) -> Dict[str, Any]:
    """One run of a cell on ``device``: returns the result line's object,
    or raises. A cell that ``BENCHMARK.json`` does not list is run from the
    traffic file of its name. ``config`` and ``workload`` replace the cell's
    files (tests run a cell at a size the CPU holds); ``call`` replaces the
    job kind's call (the control puts the reference there). The run's files
    live in ``directory``, emptied first and removed at the end."""
    import torch

    t_process = time.time() if t_process is None else t_process
    manifest = load_manifest() if manifest is None else manifest
    cell = next((w for w in manifest["workloads"] if w["name"] == cell_name),
                {"traffic": cell_name})
    workload = data_file("workloads", cell["traffic"]) if workload is None else workload
    config = data_file("configs", cell.get("config", workload["config"])) \
        if config is None else config
    kind = code_file("jobs", workload["job"])
    on_card = torch.device(device).type == "cuda"

    directory = os.path.abspath(directory)
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    run = Run(config, workload, seed, seconds, trace, torch.device(device), directory)

    def read_peak() -> None:
        if on_card:
            run.memory_peak = max(run.memory_peak, torch.cuda.max_memory_reserved(run.device))

    try:
        kind.setup(run)
        read_peak()
        written_setup = dir_bytes(directory) + run.state.get("removed_bytes", 0)
        setup_s = time.time() - t_process
        call = kind.call if call is None else call
        if trace:
            run.device_trace = _traced_window(run, call, read_peak)
        else:
            run_window(run, call, read_peak)
        read_peak()
        written_window = dir_bytes(directory) + run.state.get("removed_bytes", 0)
        gc.collect()
        if on_card:
            torch.cuda.synchronize(run.device)
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = kind.check(run)
        check_s = time.perf_counter() - t_check
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    failed = sum(j.error is not None for j in run.jobs) + run.state.get("jobs_wrong", 0)
    correct = all(value <= limit for value, limit in checks.values()) and failed == 0
    section = "per_layer" if trace else "end_to_end"
    values: Dict[str, Optional[float]] = {}
    if trace:
        for m in metrics_of(manifest, section, cell_name):
            values[m["name"]] = code_file("metrics", m["name"]).read(run)
    else:
        values = dict(kind.end_to_end(run), setup_s=setup_s)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in metrics_of(manifest, section, cell_name)
               if values.get(m["name"]) is not None}

    gib = 1 << 30
    say(json.dumps({"kbench_info": {
        "cell": cell_name, "seed": seed, "card": card_line() if on_card else None,
        "job_walls_s": [j.wall for j in run.jobs], "job_errors": [j.error for j in run.jobs
                                                                   if j.error],
        "written_gib": {"setup": written_setup / gib,
                        "window": (written_window - written_setup) / gib},
        "check_s": check_s, "launches": launch_counts(), **run.state.get("info", {})}}))
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": bool(correct), "attempted": len(run.jobs), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace and run.device_trace is not None:
        device_info.update(busy_s=run.device_trace.busy_s, window_s=run.device_trace.window_s)
        result["breakdown"] = {"device_ops": run.device_trace.top_ops(),
                               "idle_gaps": run.device_trace.idle_gaps()}
    result["check"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def _traced_window(run: Run, call, after):
    """The window under ``torch.profiler``, with the program's stage tables
    printed and its stages as spans; returns the trace of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from kbench.trace import WINDOW_SPAN, DeviceTrace, stage_spans

    activities = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.environ["PYKMER_TPU_STAGE_TIMING"] = "1"
    path = os.path.join(run.directory, "trace.json")

    def spanned(run: Run, i: int) -> Dict[str, Any]:
        with record_function(f"kbench.job.{run.workload['job']}"):
            return call(run, i)

    try:
        with profile(activities=activities) as prof, stage_spans():
            with record_function(WINDOW_SPAN):
                run_window(run, spanned, after)
                if run.device.type == "cuda":
                    torch.cuda.synchronize(run.device)
        prof.export_chrome_trace(path)
    finally:
        del os.environ["PYKMER_TPU_STAGE_TIMING"]
    trace = DeviceTrace.load(path)
    os.remove(path)
    return trace


def launch_counts() -> Dict[str, int]:
    """The program's own launch counters, as a sign that its kernels ran."""
    counts = {}
    for module, attr in (("pykmer_tpu_torch.ops.sweep", "LAUNCHES"),
                         ("pykmer_tpu_torch.ops.encode", "LAUNCHES")):
        value = getattr(sys.modules.get(module), attr, None)
        if value is not None:
            counts[f"{module.rsplit('.', 1)[1]}.{attr}"] = value
    return counts
