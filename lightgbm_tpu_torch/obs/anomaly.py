"""Anomaly sentinels over the flight-record stream.

The port of lightgbm_tpu/obs/anomaly.py.
The recorder (obs/recorder.py) turns a training run into a stream of
per-round records; this module WATCHES that stream and acts on it —
the step from "we can measure" to "the system notices". Four
sentinels, each cheap enough to run on every round:

- ``nan_metric`` — any train/valid metric value is NaN/Inf;
- ``nan_leaf`` — a freshly-materialized tree carries non-finite leaf
  values (``tree_stats``'s ``leaf_finite`` flag);
- ``loss_spike`` — a lower-is-better metric exceeds ``spike_ratio`` x
  its rolling-window median (divergence: huge learning rate, poisoned
  gradients). Higher-is-better metrics are covered by the NaN check
  only — their collapse is a modelling question, not a runtime fault;
- ``throughput_collapse`` — chunk trees/s falls below
  ``collapse_frac`` x the rolling median (a wedged device, a
  background compile storm, a degraded interconnect);
- ``dead_rounds`` — ``max_dead_rounds`` consecutive rounds where no
  class-tree found a positive-gain split (the model stopped learning
  but the loop keeps burning chip time).

Policy (``anomaly_policy`` config/CLI param):

- ``off``  — sentinels don't run;
- ``warn`` — each trip logs a warning, increments
  ``lgbmtpu_anomaly_trips_total{kind}`` and emits a trace instant
  event (in the span trace, at the round it happened);
- ``abort`` — same, then raises :class:`AnomalyAbort`. The engine
  flushes the flight recorder in its ``finally`` and lets the typed
  exception propagate, so the JSONL tail and the run manifest survive
  the abort;
- ``rollback`` — raises like ``abort``, but engine.train catches it
  and, when a ``snapshot_freq`` checkpoint exists, restores the last
  good round and retrains (optionally with a shrunken learning_rate,
  ``anomaly_rollback_lr_decay``) instead of discarding the run. Without
  a checkpoint it degrades to ``abort``.

Host-side only; consumes plain dict records, never device values.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from .. import log

POLICIES = ("off", "warn", "abort", "rollback")


class AnomalyAbort(RuntimeError):
    """Typed abort raised under ``anomaly_policy=abort``: carries the
    sentinel kind, the tripping round, and a human-readable detail."""

    def __init__(self, kind: str, round_idx: int, detail: str):
        super().__init__(
            f"anomaly sentinel {kind!r} tripped at round {round_idx}: "
            f"{detail}"
        )
        self.kind = kind
        self.round_idx = round_idx
        self.detail = detail


def _finite(v: Any) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return True  # non-numeric values are not this sentinel's job


class AnomalySentinel:
    """Stateful checker; feed it every round record via :meth:`check`."""

    def __init__(
        self,
        policy: str = "warn",
        *,
        spike_window: int = 8,
        spike_ratio: float = 2.0,
        spike_min_rounds: int = 3,
        collapse_window: int = 8,
        collapse_frac: float = 0.25,
        collapse_min_chunks: int = 3,
        max_dead_rounds: int = 10,
        recorder: Optional[Any] = None,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"anomaly_policy must be one of {POLICIES}, got {policy!r}"
            )
        self.policy = policy
        self.spike_window = int(spike_window)
        self.spike_ratio = float(spike_ratio)
        self.spike_min_rounds = int(spike_min_rounds)
        self.collapse_frac = float(collapse_frac)
        self.collapse_min_chunks = int(collapse_min_chunks)
        self.max_dead_rounds = int(max_dead_rounds)
        self.recorder = recorder
        self.trips: List[Dict[str, Any]] = []
        self._loss_hist: Dict[str, Deque[float]] = {}
        self._tps_hist: Deque[float] = deque(maxlen=int(collapse_window))
        self._dead_streak = 0

    # ------------------------------------------------------------- trip
    def _trip(self, kind: str, round_idx: int, detail: str) -> None:
        self.trips.append(
            {"kind": kind, "round": round_idx, "detail": detail}
        )
        if self.recorder is not None:
            self.recorder.note_anomaly(kind)
        from .metrics import default_registry

        reg = default_registry()
        if reg.enabled:
            reg.counter(
                "lgbmtpu_anomaly_trips_total",
                "anomaly sentinel trips over the training flight record",
                labels=("kind",),
            ).inc(1, kind=kind)
        from . import tracing

        rec = tracing.active()
        if rec is not None:
            rec.add_instant(
                f"anomaly: {kind}",
                {"round": round_idx, "detail": detail},
            )
        log.warning(f"anomaly[{kind}] at round {round_idx}: {detail}")
        if self.policy in ("abort", "rollback"):
            # rollback rides the same typed raise: engine.train owns the
            # checkpoint-restore decision, not the sentinel
            raise AnomalyAbort(kind, round_idx, detail)

    # ------------------------------------------------------------ check
    def check(self, rec: Dict[str, Any]) -> None:
        """Inspect one round record; raises AnomalyAbort under the
        abort policy. Under ``warn`` every tripped sentinel fires (one
        record can trip several kinds)."""
        if self.policy == "off":
            return
        it = int(rec.get("round", -1))
        evals = rec.get("evals") or {}

        # --- NaN/Inf in metric values
        bad = sorted(k for k, v in evals.items() if not _finite(v))
        if bad:
            self._trip(
                "nan_metric", it,
                f"non-finite metric value(s) {bad}",
            )

        # --- NaN/Inf in freshly-materialized leaf values
        trees = rec.get("trees") or []
        poisoned = [
            i for i, t in enumerate(trees)
            if not t.get("leaf_finite", True)
        ]
        if poisoned:
            self._trip(
                "nan_leaf", it,
                f"non-finite leaf values in class tree(s) {poisoned}",
            )

        # --- loss spike over the rolling median (lower-better metrics:
        # the eval key carries higher_better in rec["evals_hb"])
        hb = rec.get("evals_hb") or {}
        for key, v in evals.items():
            if hb.get(key, False) or not _finite(v):
                continue
            hist = self._loss_hist.setdefault(
                key, deque(maxlen=self.spike_window)
            )
            if len(hist) >= self.spike_min_rounds:
                med = sorted(hist)[len(hist) // 2]
                if med > 0 and float(v) > self.spike_ratio * med:
                    self._trip(
                        "loss_spike", it,
                        f"{key}={float(v):.6g} > {self.spike_ratio}x "
                        f"rolling median {med:.6g}",
                    )
            hist.append(float(v))

        # --- throughput collapse vs the rolling median of chunk tps
        tps = rec.get("trees_per_sec")
        if tps is not None and _finite(tps) and float(tps) > 0:
            if len(self._tps_hist) >= self.collapse_min_chunks:
                h = sorted(self._tps_hist)
                med = h[len(h) // 2]
                if med > 0 and float(tps) < self.collapse_frac * med:
                    self._trip(
                        "throughput_collapse", it,
                        f"{float(tps):.4g} trees/s < "
                        f"{self.collapse_frac}x rolling median "
                        f"{med:.4g}",
                    )
            self._tps_hist.append(float(tps))

        # --- dead (zero-gain) rounds
        if trees:
            dead = all(
                t.get("leaves", 1) <= 1 or t.get("best_gain", 0.0) <= 0.0
                for t in trees
            )
            self._dead_streak = self._dead_streak + 1 if dead else 0
            if self._dead_streak >= self.max_dead_rounds:
                streak = self._dead_streak
                self._dead_streak = 0  # re-arm after the trip
                self._trip(
                    "dead_rounds", it,
                    f"{streak} consecutive rounds without a "
                    "positive-gain split",
                )

    def summary(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for t in self.trips:
            counts[t["kind"]] = counts.get(t["kind"], 0) + 1
        return {"policy": self.policy, "trips": counts}


def make_sentinel(policy: str,
                  recorder: Optional[Any] = None
                  ) -> Optional[AnomalySentinel]:
    """Config hook: None for ``off`` (zero per-round overhead),
    otherwise a sentinel wired to the recorder's anomaly counters."""
    if policy == "off":
        return None
    return AnomalySentinel(policy, recorder=recorder)
