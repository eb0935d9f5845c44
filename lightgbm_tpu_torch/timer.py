"""Named per-phase accumulating timers (the reference's USE_TIMETAG:
Timer / FunctionTimer, utils/common.h:979-1043, a global timer printed
at the end).

The port of lightgbm_tpu/timer.py's Timer. Phases are host regions
(dispatch, collect, eval). Work on the card is asynchronous, so a scope
that must include it passes `block=True`: the clock stops after
torch.cuda.synchronize on the training device. `timetag=true` in the
training parameters turns the global timer on (engine.train calls
enable_timetag) and train prints the summary when it returns. LatencyStats /
latency_stats are the serving paths' latency rings (a copy of the JAX
package's), exported on /metrics through obs/metrics.py.

Span sinks (the JAX package's trace-sink hooks): while a sink is
subscribed, every scope and add() also reports (name, start, seconds) to
it, timer on or off; obs/tracing.py's span recorder and
obs/recorder.py's per-round phases subscribe here. Not ported: the
LIGHTGBM_TPU_TIMETAG environment switch.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# subscribed span sinks, (name, start_s, dur_s) -> None: the slot that
# obs.tracing owns (set_trace_sink) plus any added ones (the flight
# recorder's); a tuple read without a lock on every scope
_trace_sinks: tuple = ()
_primary_sink: Optional[Callable[[str, float, float], None]] = None


def set_trace_sink(
        sink: Optional[Callable[[str, float, float], None]]) -> None:
    """Install (or with None remove) the tracing slot's sink; sinks
    added through add_trace_sink stay."""
    global _trace_sinks, _primary_sink
    sinks = [s for s in _trace_sinks if s is not _primary_sink]
    _primary_sink = sink
    if sink is not None:
        sinks.append(sink)
    _trace_sinks = tuple(sinks)


def add_trace_sink(sink: Callable[[str, float, float], None]) -> None:
    global _trace_sinks
    if sink not in _trace_sinks:
        _trace_sinks = _trace_sinks + (sink,)


def remove_trace_sink(sink: Callable[[str, float, float], None]) -> None:
    # == not `is`: a bound method is a new object at every attribute read
    global _trace_sinks
    _trace_sinks = tuple(s for s in _trace_sinks if s != sink)


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
        if not self.enabled and not _trace_sinks:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block:
            _sync(self.device)
        self.add(name, time.perf_counter() - t0, t0)

    def add(self, name: str, seconds: float,
            start: Optional[float] = None) -> None:
        """Record an externally timed region, as scope() does (`start`:
        its time.perf_counter() start, for the span sinks)."""
        if self.enabled:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._cnt[name] = self._cnt.get(name, 0) + 1
        sinks = _trace_sinks
        if sinks:
            if start is None:
                start = time.perf_counter() - seconds
            for sink in sinks:
                sink(name, start, seconds)

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


class LatencyStats:
    """Latency/throughput counters for serving paths.

    Unlike Timer scopes (accumulating host-region stopwatches for
    training phases), serving needs DISTRIBUTION statistics — a p99
    regression hides completely in an accumulated total. Keeps a ring
    of the most recent `window` request latencies plus lifetime count /
    row totals; `snapshot()` derives mean/p50/p95/p99 over the ring and
    rows/sec over the lifetime. Thread-safe: the serving server and the
    microbatch worker observe from different threads.
    """

    def __init__(self, window: int = 2048) -> None:
        self._window = int(window)
        self._ring: List[float] = []
        self._pos = 0
        self._count = 0
        self._rows = 0
        self._total_s = 0.0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def observe(self, seconds: float, rows: int = 1) -> None:
        with self._lock:
            if len(self._ring) < self._window:
                self._ring.append(float(seconds))
            else:
                self._ring[self._pos] = float(seconds)
                self._pos = (self._pos + 1) % self._window
            self._count += 1
            self._rows += int(rows)
            self._total_s += float(seconds)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            ring = sorted(self._ring)
            count, rows, total = self._count, self._rows, self._total_s
            uptime = time.perf_counter() - self._t0

        def pct(p: float) -> float:
            if not ring:
                return 0.0
            return ring[min(len(ring) - 1, int(p * (len(ring) - 1) + 0.5))]

        # mean over the same ring the percentiles cover — a lifetime
        # mean would stay inflated by cold-start outliers forever and
        # read as mean >> p99 on a warmed-up server
        mean = sum(ring) / len(ring) if ring else 0.0
        return {
            "count": count,
            "rows": rows,
            "mean_ms": round(1e3 * mean, 4),
            "p50_ms": round(1e3 * pct(0.50), 4),
            "p95_ms": round(1e3 * pct(0.95), 4),
            "p99_ms": round(1e3 * pct(0.99), 4),
            "rows_per_sec": round(rows / uptime, 2) if uptime > 0 else 0.0,
            "busy_frac": round(total / uptime, 4) if uptime > 0 else 0.0,
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pos = 0
            self._count = 0
            self._rows = 0
            self._total_s = 0.0
            self._t0 = time.perf_counter()


_latency: Dict[str, LatencyStats] = {}
_latency_lock = threading.Lock()


def latency_stats(name: str, model: Optional[str] = None) -> LatencyStats:
    """Named process-global LatencyStats (one per serving entry point,
    mirroring global_timer's named-scope registry). Each named ring
    registers itself on the obs metrics registry at creation, so
    `/metrics` scrapes and `ModelRegistry.stats()` read the SAME
    object — one source of truth for serving latency. ``model`` tags
    the exported series with a ``{model=...}`` label."""
    with _latency_lock:
        created = name not in _latency
        if created:
            _latency[name] = LatencyStats()
        stats = _latency[name]
    if created:
        from .obs.metrics import register_latency_collector

        register_latency_collector(name, stats, model=model)
    return stats


def latency_summary() -> Dict[str, Dict[str, float]]:
    with _latency_lock:
        return {k: v.snapshot() for k, v in sorted(_latency.items())}
