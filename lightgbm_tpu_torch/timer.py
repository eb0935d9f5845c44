"""Named per-phase accumulating timers (the reference's USE_TIMETAG:
Timer / FunctionTimer, utils/common.h:979-1043, a global timer printed
at the end).

The port of lightgbm_tpu/timer.py's Timer. Phases are host regions
(dispatch, collect, eval). Work on the card is asynchronous, so a scope
that must include it passes `block=True`: the clock stops after
torch.cuda.synchronize on the training device. `timetag=true` in the
training parameters turns the global timer on (engine.train calls
enable_timetag) and train prints the summary when it returns. Not
ported yet: the LIGHTGBM_TPU_TIMETAG environment switch, the serving
latency statistics (LatencyStats, ROADMAP A.9) and the trace-sink
hooks of obs/ (A.11).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch


def _sync(device: Optional[torch.device]) -> None:
    """Wait for the work queued on the training card (no-op on the
    CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Accumulating named stopwatches (reference utils/common.h:979)."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}
        self.enabled = False
        self.device: Optional[torch.device] = None  # the training device

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @contextmanager
    def scope(self, name: str, block: bool = False) -> Iterator[None]:
        """Time a region; with block=True the clock stops once the card
        has finished the work queued in it."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block:
            _sync(self.device)
        self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Record an externally timed region, as scope() does."""
        if self.enabled:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._cnt[name] = self._cnt.get(name, 0) + 1

    def summary(self) -> Dict[str, Tuple[float, int]]:
        """{phase: (seconds, calls)}, the longest first."""
        return {k: (self._acc[k], self._cnt[k])
                for k in sorted(self._acc, key=lambda k: -self._acc[k])}

    def print_summary(self) -> None:
        """Per-phase totals (common.h:1012)."""
        from . import log

        if not self._acc:
            return
        log.info("LightGBM-TPU phase timings:")
        for name, (acc, cnt) in self.summary().items():
            log.info(f"  {name}: {acc:.3f}s ({cnt} calls)")

    def reset(self) -> None:
        self._acc.clear()
        self._cnt.clear()


global_timer = Timer()


def enable_timetag() -> None:
    """The `timetag=true` hook of engine.train: turn the global phase
    timer on mid-process."""
    global_timer.enable()
