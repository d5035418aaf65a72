"""What a traced run reads: the profiler's device activity and the
program's stage tables.

The device side comes from a ``torch.profiler`` chrome trace of the window:
kernels, copies and fills on the card, their union (busy time), the time of
the kernels of a name, and the idle gaps named by the host spans open
across them (the program's stages and the harness's jobs). The program side
is the stage table the index prints under ``PYKMER_TPU_STAGE_TIMING``: one
row a stage, in order.
"""

from __future__ import annotations

import collections
import contextlib
import json
import re
from typing import Dict, Iterator, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "kbench.window"
TOP = 10

_ROW = re.compile(r"^  (.+?)\s+(-?\d+(?:\.\d+)?) ms\s+-?\d+(?:\.\d+)?%$")
_TITLE = "stage timing ("


def parse_stage_tables(text: str) -> List[List[Tuple[str, float]]]:
    """Each stage table in ``text``: its rows as (stage, seconds), in order."""
    tables: List[List[Tuple[str, float]]] = []
    for line in text.splitlines():
        if line.startswith(_TITLE):
            tables.append([])
            continue
        m = _ROW.match(line)
        if m and tables:
            tables[-1].append((m.group(1).strip(), float(m.group(2)) / 1e3))
    return tables


def stage_split(rows: List[Tuple[str, float]]) -> Optional[Dict[str, float]]:
    """One index's table as {"accumulate", "tail", "verify"} seconds: the
    accumulate row, the rows after it other than verify, and verify. None
    where the table has no accumulate row."""
    at = next((i for i, (name, _) in enumerate(rows) if "accumulate" in name), None)
    if at is None:
        return None
    rest = rows[at + 1:]
    return {
        "accumulate": rows[at][1],
        "tail": sum(dt for name, dt in rest if name != "verify"),
        "verify": sum(dt for name, dt in rest if name == "verify"),
    }


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name[len("void "):] if name.startswith("void ") else name


class DeviceTrace:
    """The device activity of one chrome trace inside its window span."""

    def __init__(self, trace: Dict):
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        windows = [e for e in events if e.get("name") == WINDOW_SPAN]
        if windows:
            w = windows[0]
            self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        else:
            ts = [float(e["ts"]) for e in events] or [0.0]
            self.start, self.end = min(ts), max(ts)
        self.device = []
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
                a, b = max(a, self.start), min(b, self.end)
                if b > a:
                    self.device.append((a, b, e.get("cat"), e.get("name", "")))
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                       e.get("name", "")) for e in events
                      if e.get("cat") == "user_annotation" and e.get("name") != WINDOW_SPAN]
        self.busy = _union([(a, b) for a, b, _, _ in self.device])

    @classmethod
    def load(cls, path: str) -> "DeviceTrace":
        with open(path) as fh:
            return cls(json.load(fh))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, substring: str) -> float:
        """Device seconds of the kernels whose name holds ``substring``."""
        return sum(b - a for a, b, cat, name in self.device
                   if cat == "kernel" and substring in name) / 1e6

    def top_ops(self, n: int = TOP) -> List[List]:
        """The device operations that took most time: [name, seconds]."""
        total: Dict[str, float] = collections.defaultdict(float)
        for a, b, _, name in self.device:
            total[short_name(name)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = TOP) -> List[List]:
        """Idle time summed by what the host was doing: each gap is cut at
        the edges of the host spans (the program's stages, the harness's
        jobs) and each piece named by the innermost span open across it.
        [name, seconds]."""
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        total: Dict[str, float] = collections.defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            cuts = sorted({a, b, *(x for s, e, _ in self.spans for x in (s, e) if a < x < b)})
            for p, q in zip(cuts, cuts[1:]):
                mid = (p + q) / 2
                open_spans = [(e - s, name) for s, e, name in self.spans if s <= mid <= e]
                name = min(open_spans)[1] if open_spans else "outside any span"
                total[name] += (q - p) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def stage_spans() -> Iterator[None]:
    """Put each of the program's ``StageTimer`` stages into the profiler's
    trace as a host span of the same name, while the block runs. The
    stage's own timing is untouched; where the program has no such timer,
    nothing is added."""
    try:
        from pykmer_tpu_torch.utils.profiling import StageTimer
    except ImportError:
        yield
        return
    from torch.profiler import record_function

    original = StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name):
        with record_function(name), original(self, name):
            yield

    StageTimer.stage = stage
    try:
        yield
    finally:
        StageTimer.stage = original
