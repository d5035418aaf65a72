"""Wall-clock throughput meter.

Only the *values* persisted into `.kin.json` are constrained by the reference
(reference tools.py:24-64): ``speed_ela`` must be the integer units/s since
construction (serialised as ``creation_speed``), and ``time_begin`` must be a
``datetime`` whose ``str()`` form becomes ``creation_time_start``.  Everything
else here — the rolling-window rate, the progress line — is our own design.

Copy of ``pykmer_tpu/utils/timer.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import datetime


class Timer:
    """Tracks cumulative and rolling (since last ``update``) throughput."""

    def __init__(self) -> None:
        self.time_begin = datetime.datetime.now()
        self._last_time = self.time_begin
        self._last_val = 0
        self.val = 0
        self.speed_ela = 0  # cumulative units/s (→ .kin.json creation_speed)
        self.speed_recent = 0  # units/s over the last update window

    def update(self, val: int) -> None:
        now = datetime.datetime.now()
        total_s = (now - self.time_begin).total_seconds()
        window_s = (now - self._last_time).total_seconds()
        self.speed_ela = int(val / total_s) if total_s > 0 else 0
        self.speed_recent = (
            int((val - self._last_val) / window_s) if window_s > 0 else 0
        )
        self._last_time = now
        self._last_val = val
        self.val = val

    @property
    def elapsed(self) -> datetime.timedelta:
        return datetime.datetime.now() - self.time_begin

    def progress_line(self) -> str:
        """Single-line human progress summary (whole seconds)."""
        ela = datetime.timedelta(seconds=int(self.elapsed.total_seconds()))
        return (
            f"[{ela}] {self.val:,} units"
            f" | {self.speed_ela:,}/s overall"
            f" | {self.speed_recent:,}/s recent"
        )
