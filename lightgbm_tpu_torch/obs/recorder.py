"""Training flight recorder: one JSONL record per boosting round.

The port of lightgbm_tpu/obs/recorder.py, the same stream format (schema
``lightgbm-tpu/flight-record/v1``). While training runs, every boosting
round appends one line carrying

- the round index (ABSOLUTE across a resume) and wall-clock timestamp,
- per-phase host durations for that round, drained from the timer's span
  sink (``update`` / ``eval`` on the eager loop; one
  ``round: fused step`` span per iteration on the fused loop, whose
  chunk-level scopes ride the chunk's first record as ``chunk_phases``),
- train/valid metric values (the learning curve),
- per-class tree stats: leaves / depth / best split gain / a
  finite-leaf flag,
- gradient/hessian norms √Σg², √Σh² over the round's (K, rows) f32
  gradients, on both loops: the fused step writes them after its eval
  values into the row it already copies back once a chunk,
- chunk-level throughput (trees/s over the collected chunk).

Enabled through the ``record_file=`` param (engine.train owns the
lifecycle); ``obs.anomaly`` sentinels watch the stream live. Every line
is written and flushed before the sentinels see the record, and
``close()`` (engine.train's ``finally``) detaches the span sink and
closes the file even when training aborts mid-round, so the tail stays
parseable and the run manifest reads the final summary
(``last_summary()``).

Host-side only; nothing here runs inside a captured CUDA graph.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import timer as _timer

SCHEMA = "lightgbm-tpu/flight-record/v1"

# module-global summary of the most recently closed recorder, so the
# run manifest (written later, possibly by cli.py's finally block) can
# fold the flight record in without holding a recorder reference
_last_lock = threading.Lock()
_last_summary: Optional[Dict[str, Any]] = None


def last_summary() -> Optional[Dict[str, Any]]:
    """Summary dict of the most recently closed FlightRecorder in this
    process (None if none closed yet). Consumed by obs.manifest."""
    with _last_lock:
        return dict(_last_summary) if _last_summary else None


def _set_last_summary(summary: Dict[str, Any]) -> None:
    global _last_summary
    with _last_lock:
        _last_summary = dict(summary)


def clear_last_summary() -> None:
    """Drop the published summary. engine.train calls this when a run
    WITHOUT a recorder starts, so a manifest written after that run
    cannot misattribute an earlier run's flight record (path, rounds,
    anomaly trips) to it."""
    global _last_summary
    with _last_lock:
        _last_summary = None


def tree_stats(trees) -> List[Dict[str, Any]]:
    """Per-tree stats for one round's K class-trees (host ``Tree``
    objects): leaves / depth / best gain / finite-leaf flag. The
    NaN/Inf flag is what the anomaly ``nan_leaf`` sentinel reads."""
    out: List[Dict[str, Any]] = []
    for t in trees:
        lv = np.asarray(t.leaf_value, np.float64)
        gain = np.asarray(t.split_gain, np.float64)
        out.append({
            "leaves": int(t.num_leaves),
            "depth": int(t.max_depth()),
            "best_gain": float(gain.max()) if gain.size else 0.0,
            "leaf_finite": bool(np.isfinite(lv).all()),
        })
    return out


class FlightRecorder:
    """Streams one JSONL record per boosting round; thread-safe.

    ``path=None`` runs the recorder in memory only (the anomaly
    sentinels still consume records; nothing is written) — that is the
    ``anomaly_policy != off`` without ``record_file`` configuration.

    ``resume_bytes`` (checkpoint/resume, resilience/checkpoint.py) truncates
    an existing stream back to that byte offset — the size the training
    checkpoint captured after its round's record was flushed — and
    appends, so a resumed run's record file carries each round exactly
    once with no torn tail and no duplicated header.
    """

    def __init__(self, path: Optional[str] = None,
                 resume_bytes: Optional[int] = None):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self._phases: Dict[str, List[float]] = {}
        self._attached = False
        self._closed = False
        self.rounds = 0
        self.last_record: Optional[Dict[str, Any]] = None
        self._t0 = time.time()
        self._anomalies: Dict[str, int] = {}
        if path:
            import os

            if resume_bytes is not None and os.path.exists(path):
                self._fh = open(path, "r+")
                self._fh.truncate(int(resume_bytes))
                self._fh.seek(0, 2)  # append after the surviving records
                self._fh.flush()
            else:
                self._fh = open(path, "w")
                header = {"schema": SCHEMA, "created_unix": self._t0}
                self._fh.write(json.dumps(header) + "\n")
                self._fh.flush()

    # ------------------------------------------------------- phase sink
    def attach(self) -> "FlightRecorder":
        """Subscribe to the timer's span stream (additive — the Chrome
        trace recorder keeps its own slot)."""
        if not self._attached:
            _timer.add_trace_sink(self._on_span)
            self._attached = True
        return self

    def _on_span(self, name: str, start_s: float, dur_s: float) -> None:
        with self._lock:
            self._phases.setdefault(name, []).append(dur_s)

    def drain_phases(self) -> Dict[str, List[float]]:
        """Spans observed since the last drain, name -> durations in
        observation order (the engine slices the fused loop's per-round
        ``round: fused step`` spans out of a chunk-level drain)."""
        with self._lock:
            out = self._phases
            self._phases = {}
        return out

    # ---------------------------------------------------------- records
    def record(self, rec: Dict[str, Any]) -> None:
        """Append one round record (written + flushed immediately so an
        abort mid-train never loses the rounds that already ran)."""
        with self._lock:
            if self._closed:
                return
            self.rounds += 1
            self.last_record = rec
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()

    def note_anomaly(self, kind: str) -> None:
        """Sentinel trips fold into the recorder summary (the manifest
        then carries the per-kind counts)."""
        with self._lock:
            self._anomalies[kind] = self._anomalies.get(kind, 0) + 1

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "schema": SCHEMA,
                "path": self.path,
                "rounds": self.rounds,
                "wall_s": round(time.time() - self._t0, 3),
            }
            if self._anomalies:
                out["anomalies"] = dict(self._anomalies)
            last = self.last_record
        if last and last.get("evals"):
            out["last_evals"] = dict(last["evals"])
        return out

    def close(self) -> Dict[str, Any]:
        """Detach the timer sink, flush and close the stream; safe to
        call twice and safe mid-exception (engine.train's finally).
        Returns the summary it published for the manifest."""
        if self._attached:
            _timer.remove_trace_sink(self._on_span)
            self._attached = False
        with self._lock:
            if not self._closed:
                self._closed = True
                if self._fh is not None:
                    try:
                        self._fh.flush()
                        self._fh.close()
                    finally:
                        self._fh = None
        s = self.summary()
        _set_last_summary(s)
        return s


def read_stream(path: str) -> List[Dict[str, Any]]:
    """Load a flight-record JSONL back into a list of round records
    (the header line is skipped). Round-trip partner of ``record``."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("schema") == SCHEMA:
                continue  # stream header
            out.append(rec)
    return out
