"""Span tracing: Chrome trace-event export layered on the phase timer.

The port of lightgbm_tpu/obs/tracing.py. While a ``TraceRecorder`` is
active, every ``timer.Timer.scope`` also records a complete-event span
(phase ``X``), and ad-hoc regions can use :func:`span` directly. The
result exports two ways:

- ``write_chrome(path)`` — Chrome trace-event JSON (open in Perfetto /
  chrome://tracing, beside the ``torch.profiler`` trace that the
  ``profile_dir`` CLI param captures over the same run);
- ``write_jsonl(path)`` — one event per line for ad-hoc analysis.

Recording is host-side only (a Python list behind a lock); nothing here
runs inside a captured CUDA graph.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .. import timer as _timer


class TraceRecorder:
    """Accumulates trace events; thread-safe."""

    def __init__(self, process_name: str = "lightgbm-tpu-torch"):
        self.process_name = process_name
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self.t0 = time.perf_counter()

    # ------------------------------------------------------------------
    def add_complete(self, name: str, start_s: float, dur_s: float,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """One finished span; start_s is a time.perf_counter() value."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": round((start_s - self.t0) * 1e6, 3),
            "dur": round(dur_s * 1e6, 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_instant(self, name: str,
                    args: Optional[Dict[str, Any]] = None) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": round((time.perf_counter() - self.t0) * 1e6, 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_counter(self, name: str, values: Dict[str, float]) -> None:
        ev = {
            "name": name,
            "ph": "C",
            "ts": round((time.perf_counter() - self.t0) * 1e6, 3),
            "pid": os.getpid(),
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": os.getpid(),
            "args": {"name": self.process_name},
        }]
        return {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
        }

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_jsonl(self, path: str) -> None:
        events = self.events()
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")


_lock = threading.Lock()
_active: Optional[TraceRecorder] = None


def active() -> Optional[TraceRecorder]:
    return _active


def start_tracing(process_name: str = "lightgbm-tpu-torch") -> TraceRecorder:
    """Install a recorder as the timer's trace sink; nested starts
    return the already-active recorder (one recorder per process)."""
    global _active
    with _lock:
        if _active is not None:
            return _active
        rec = TraceRecorder(process_name)
        _active = rec
    _timer.set_trace_sink(rec.add_complete)
    return rec


def stop_tracing() -> Optional[TraceRecorder]:
    """Uninstall and return the active recorder (None if none)."""
    global _active
    with _lock:
        rec = _active
        _active = None
    _timer.set_trace_sink(None)
    return rec


@contextmanager
def tracing(chrome_path: Optional[str] = None,
            jsonl_path: Optional[str] = None) -> Iterator[TraceRecorder]:
    """Record spans for the duration of the block; optionally export on
    exit. Owns start/stop, so it must not wrap a region that already
    has an active recorder (start_tracing would alias it)."""
    rec = start_tracing()
    try:
        yield rec
    finally:
        stop_tracing()
        if chrome_path:
            rec.write_chrome(chrome_path)
        if jsonl_path:
            rec.write_jsonl(jsonl_path)


@contextmanager
def span(name: str, **args: Any) -> Iterator[None]:
    """Ad-hoc host span: records into the active recorder (no-op when
    tracing is off) and accumulates in the phase timer when enabled —
    the same dual path timer scopes take."""
    with _timer.global_timer.scope(name):
        yield
    if args:
        rec = _active
        if rec is not None:
            rec.add_instant(name, args)
