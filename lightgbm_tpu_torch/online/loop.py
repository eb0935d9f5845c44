"""The online train-and-serve loop.

The port of lightgbm_tpu/online/loop.py. The model registry serves v(n)
on the card while microbatches stream in through the serving transports'
``ingest`` op; each verdict cycle refits a candidate v(n+1) from the
spooled rows (warm-started through ``init_score`` = v(n)'s raw margins,
then spliced with ``boosting.splice_continued``), judges it on a fixed
holdout shard with the device metrics (online/gate.py), and promotes
it, or rejects it or reverts, recording the verdict durably. The refit
trains on ``device`` (the fused loop: one CUDA graph an iteration), the
gate evaluates there, and the registry's request threads keep scoring
v(n) meanwhile.

Crash consistency: the restart invariant is "the last persisted
promotion serves":

======================  ==============================================
kill -9 at…             restart state
======================  ==============================================
``loop_ingest``         v(n) serves; spool intact; cycle replays
``loop_refit``          v(n) serves; offset un-advanced; refit reruns
``loop_eval``           v(n) serves; candidate text durable but
                        unreferenced; cycle replays and overwrites it
``loop_promote``        verdict not yet persisted: v(n) serves, cycle
                        replays (an in-memory registry swap that beat
                        the kill died with the process)
mid state-write         ``os.replace`` atomicity: old or new verdict,
                        never torn
======================  ==============================================

Every phase passes a named ``resilience.fault_point`` site
(``loop_ingest`` / ``loop_refit`` / ``loop_eval`` / ``loop_promote``,
indexed by the absolute cycle), so a fault plan can kill, raise or
delay at each edge.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .. import log
from ..config import Config
from ..obs import metrics as obs_metrics
from ..obs.anomaly import AnomalyAbort
from ..resilience.errors import CheckpointError
from ..resilience.faultinject import fault_point
from ..resilience.heartbeat import HeartbeatWriter, health_report
from . import gate as gate_mod
from . import state as state_mod
from .ingest import IngestSpool, spool_path, stack_batches

EVENTS_NAME = "loop_events.jsonl"

# the refit's anomaly policy: the loop is the rollback mechanism, so
# ``rollback`` (the engine's retry with a decayed lr would retrain on the
# same poisoned rows) maps to ``abort``, and ``off`` to ``warn`` so the
# sentinel always runs and the gate always sees its trips
_REFIT_POLICY = {"off": "warn", "warn": "warn",
                 "abort": "abort", "rollback": "abort"}


class OnlineLoop:
    """One train-and-serve loop over a durable loop directory.

    ``params`` are training params (objective, metric, num_leaves, ...)
    plus the ``loop_*`` keys; ``holdout`` is the fixed ``(X, y)`` or
    ``(X, y, weight)`` shard the gate judges on; ``initial_model``
    (Booster, model text or path) seeds v0 when the loop directory has
    no state yet; a directory with state resumes from it and
    ``initial_model`` is ignored. ``device`` is where the refit trains,
    the margins are scored and the gate evaluates ("cuda", or "cpu" when
    asked for); it raises when the card is asked for and torch sees
    none. ``last_cycle`` holds the host seconds of the last verdict
    cycle's phases."""

    def __init__(self, params: Dict[str, Any], holdout,
                 initial_model=None, device="cuda"):
        from ..serving.forest import serve_device

        self.device = serve_device(device)
        self._params = dict(params)
        self._cfg = Config(params)
        self.loop_dir = self._cfg.loop_dir
        os.makedirs(self.loop_dir, exist_ok=True)
        self.min_rows = int(self._cfg.loop_min_rows)
        self.rounds = int(self._cfg.loop_rounds)
        self.margin = float(self._cfg.loop_gate_margin)
        self.poll_s = float(self._cfg.loop_poll_s)
        self.spool = IngestSpool(spool_path(self.loop_dir))
        self._lock = threading.Lock()
        # the default stop signal of run() (an embedder may pass its own)
        self.stop_event = threading.Event()
        self._registry = None
        self._model_name = self._cfg.serve_model_name
        self.last_cycle: Dict[str, Any] = {}

        hx, hy = holdout[0], holdout[1]
        self._hx = np.asarray(hx, dtype=np.float64)
        self._hy = np.asarray(hy, dtype=np.float64)
        self._hw = (np.asarray(holdout[2], dtype=np.float64)
                    if len(holdout) > 2 and holdout[2] is not None
                    else None)

        sp = state_mod.state_path(self.loop_dir)
        if os.path.exists(sp):
            self.state = state_mod.load_state(sp)
            text = self._read_model_text(self.state["model_path"])
        else:
            if initial_model is None:
                raise ValueError(
                    f"online loop: {self.loop_dir} has no state and no "
                    "initial_model was provided"
                )
            text = self._model_text_of(initial_model)
            st = state_mod.fresh_state()
            st["model_path"] = state_mod.model_path(self.loop_dir, 0)
            # the model text is durable before the state that names it
            state_mod.atomic_write_text(st["model_path"], text)
            state_mod.save_state(sp, st)
            self.state = st
        self._incumbent_text = text
        self._incumbent = self._booster_of(text)
        k = self._incumbent._gbdt.num_class
        self._eval_names, self._eval_hb, self._eval_fn = (
            gate_mod.make_holdout_evaluator(
                self._cfg, self._hy, weight=self._hw, num_class=k,
                device=self.device))

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _model_text_of(source) -> str:
        if hasattr(source, "model_to_string"):
            return source.model_to_string()
        s = str(source)
        if "\n" not in s and os.path.exists(s):
            with open(s) as f:
                return f.read()
        return s

    @staticmethod
    def _read_model_text(path: str) -> str:
        try:
            with open(path) as f:
                return f.read()
        except OSError as e:
            raise CheckpointError(
                f"loop state references model {path} which cannot be "
                f"read: {e}"
            ) from e

    @staticmethod
    def _booster_of(text: str):
        from ..basic import Booster

        return Booster(model_str=text)

    def _margins(self, booster, X) -> np.ndarray:
        return gate_mod.raw_margins(booster, X, self.device.type)

    # ----------------------------------------------------------- registry
    def attach(self, registry, name: Optional[str] = None) -> None:
        """Wire a ModelRegistry or ModelFleet: the incumbent becomes the
        active version of ``name``, the spool the transports' ``ingest``
        sink, and ``health()`` backs /readyz and /healthz."""
        with self._lock:
            self._registry = registry
            if name:
                self._model_name = name
        registry.ingest_sink = self.spool
        registry.health_probe = self.health
        registry.load(self._model_name, self.state["model_path"],
                      activate=True)

    # ------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        """The loop's liveness: the durable state and the heartbeat
        report (a wedged refit shows on the serving endpoint)."""
        with self._lock:
            st = dict(self.state)
        report = health_report(
            self.loop_dir, expected=1,
            stale_after_s=max(30.0, 10.0 * self.poll_s))
        offset = int(st["ingest_offset"])
        return {
            "loop": {
                "version": int(st["version"]),
                "cycle": int(st["cycle"]),
                "ingest_offset": offset,
                "spool_backlog_bytes": max(self.spool.size() - offset, 0),
                "counts": dict(st["counts"]),
                "last_outcome": st.get("last_outcome"),
            },
            "workers": report,
            "healthy": bool(report["healthy"]),
        }

    # -------------------------------------------------------------- cycle
    def cycle(self) -> Optional[str]:
        """One verdict attempt. Returns the outcome (``promoted`` /
        ``rejected`` / ``rolled_back``), or None while the spool holds
        fewer than ``loop_min_rows`` new rows. An InjectedFault from a
        fault plan propagates."""
        with self._lock:
            st = dict(self.state)
        c = int(st["cycle"])
        times: Dict[str, Any] = {}
        fault_point("loop_ingest", c)
        batches, end = self.spool.read_from(int(st["ingest_offset"]))
        nrows = sum(len(b["labels"]) for b in batches)
        if not batches or nrows < self.min_rows:
            return None
        X, y, w = stack_batches(batches)
        t0 = time.perf_counter()
        init_kn = self._margins(self._incumbent, X)
        times["margins_s"] = time.perf_counter() - t0

        fault_point("loop_refit", c)
        trips: Dict[str, int] = {}
        reason_extra = ""
        cand_text = None
        t0 = time.perf_counter()
        try:
            delta = self._train_delta(X, y, w, init_kn)
            trips = dict(
                (getattr(delta, "anomaly_summary", None) or {})
                .get("trips", {}))
        except AnomalyAbort as e:
            trips = {"abort": 1}
            reason_extra = str(e)
            delta = None
        except log.LightGBMError as e:
            # a microbatch the trainer itself refuses (bad labels,
            # degenerate features) is poison: absorb it as a rollback
            # verdict; the loop must outlive bad data
            trips = {"refit_error": 1}
            reason_extra = str(e)
            delta = None
        times["refit_s"] = time.perf_counter() - t0
        fused = getattr(getattr(delta, "_gbdt", None), "_fused", None)
        graph = getattr(fused, "graph", None)
        times["refit_capture_s"] = getattr(graph, "capture_s", None)

        cand_version = int(st["version"]) + 1
        cand_path = state_mod.model_path(self.loop_dir, cand_version)
        cand = None
        if delta is not None:
            cand_text = self._splice(delta)
            state_mod.atomic_write_text(cand_path, cand_text)
            cand = self._booster_of(cand_text)

        fault_point("loop_eval", c)
        t0 = time.perf_counter()
        inc_m = st.get("incumbent_metrics")
        if inc_m is None:
            inc_m = gate_mod.evaluate(
                self._eval_fn, self._margins(self._incumbent, self._hx))
        cand_m = None
        if cand is not None:
            cand_m = gate_mod.evaluate(
                self._eval_fn, self._margins(cand, self._hx))
            outcome, reason = gate_mod.decide(
                cand_m, inc_m, self._eval_names, self._eval_hb,
                self.margin, trips)
        else:
            outcome, reason = "rolled_back", (
                f"refit aborted, keeping v{st['version']}: {reason_extra}")
        times["eval_s"] = time.perf_counter() - t0

        fault_point("loop_promote", c)
        t0 = time.perf_counter()
        promoted = outcome == "promoted"
        if promoted and self._registry is not None:
            # the registry swaps atomically under its own lock; the load
            # and the warm-up captures it runs stay outside the loop lock
            self._registry.load(self._model_name, cand_path,
                                activate=True)
        with self._lock:
            if promoted:
                self._incumbent = cand
                self._incumbent_text = cand_text
            new = dict(self.state)
            new["counts"] = dict(new["counts"])
            new["counts"][outcome] = new["counts"].get(outcome, 0) + 1
            new["cycle"] = c + 1
            new["ingest_offset"] = int(end)
            new["last_outcome"] = outcome
            if promoted:
                new["version"] = cand_version
                new["model_path"] = cand_path
                new["incumbent_metrics"] = cand_m
            else:
                new["incumbent_metrics"] = inc_m
            state_mod.save_state(
                state_mod.state_path(self.loop_dir), new)
            self.state = new
        times["promote_s"] = time.perf_counter() - t0
        self._record_verdict(new, c, outcome, reason, nrows,
                             int(st["ingest_offset"]), int(end),
                             cand_version, cand_m, inc_m, trips)
        self.last_cycle = {"cycle": c, "outcome": outcome, "rows": nrows,
                           "candidate_metrics": cand_m,
                           "incumbent_metrics": inc_m, **times}
        log.info(
            f"online loop cycle {c}: {outcome} ({reason}); serving "
            f"v{new['version']}"
        )
        return outcome

    # ------------------------------------------------------------- phases
    def _train_delta(self, X, y, w, init_kn):
        """Refit a fresh delta booster over the microbatch rows with
        init_score = v(n)'s margins (class-major, flattened: the layout
        the Dataset's init_score reshapes back)."""
        from .. import engine
        from ..basic import Dataset

        p = dict(self._params)
        for k in ("task", "data", "valid", "valid_data", "input_model",
                  "output_model", "resume", "resume_from",
                  "checkpoint_file"):
            p.pop(k, None)
        p["snapshot_freq"] = 0
        p["num_iterations"] = self.rounds
        p["anomaly_policy"] = _REFIT_POLICY[self._cfg.anomaly_policy]
        p["device_type"] = "cpu" if self.device.type == "cpu" else "cuda"
        p.setdefault("record_file",
                     os.path.join(self.loop_dir, "refit_record.jsonl"))
        # engine.train configures the fault plan from its params: carry
        # the loop's plan through, or a refit would disarm it
        p["fault_plan"] = self._cfg.fault_plan
        ds = Dataset(
            X, label=y, weight=w,
            init_score=np.asarray(init_kn, np.float64).reshape(-1))
        return engine.train(p, ds, num_boost_round=self.rounds)

    def _splice(self, delta) -> str:
        from ..boosting import splice_continued
        from ..model_io import load_model_string, save_model_string

        base_cfg, base_gbdt = load_model_string(self._incumbent_text)
        splice_continued(base_gbdt, delta._gbdt)
        return save_model_string(base_gbdt, base_cfg)

    def _record_verdict(self, st, cycle, outcome, reason, nrows,
                        off0, off1, cand_version, cand_m, inc_m,
                        trips) -> None:
        """The verdict's provenance: the loop's event log, a run
        manifest, and the /metrics series."""
        event = {
            "t_unix": time.time(),
            "cycle": int(cycle),
            "outcome": outcome,
            "reason": reason,
            "serving_version": int(st["version"]),
            "candidate_version": int(cand_version),
            "rows": int(nrows),
            "spool_span": [int(off0), int(off1)],
            "metrics": {"names": self._eval_names,
                        "candidate": cand_m, "incumbent": inc_m},
            "anomaly_trips": trips,
        }
        try:
            with open(os.path.join(self.loop_dir, EVENTS_NAME), "a") as f:
                f.write(json.dumps(event) + "\n")
                f.flush()
        except OSError as e:
            log.warning(f"online loop: cannot append event log: {e}")
        obs_metrics.record_promotion_event(outcome)
        obs_metrics.record_loop_progress(
            int(st["version"]), int(st["cycle"]),
            int(st["ingest_offset"]))
        try:
            from ..obs.manifest import write_manifest

            write_manifest(
                os.path.join(self.loop_dir, "run_manifest.json"),
                config=self._cfg,
                extra={"online_loop": {k: v for k, v in st.items()
                                       if k != "schema"}},
            )
        except Exception as e:  # noqa: BLE001 — the manifest is advisory
            log.warning(f"online loop: manifest write failed: {e}")

    # ---------------------------------------------------------------- run
    def run(self, max_cycles: Optional[int] = None,
            stop: Optional[threading.Event] = None) -> int:
        """Drive verdict cycles until ``max_cycles`` verdicts land
        (``loop_max_cycles``; 0 / None: forever) or ``stop`` is set. A
        heartbeat covers the run, so a wedged refit shows as ``stale``
        in ``health()``. Returns the number of verdicts."""
        if max_cycles is None:
            max_cycles = int(self._cfg.loop_max_cycles)
        stop = stop or self.stop_event
        hb = HeartbeatWriter(self.loop_dir, rank=0,
                             interval_s=min(self.poll_s, 5.0)).start()
        verdicts = 0
        try:
            while not stop.is_set():
                outcome = self.cycle()
                if outcome is not None:
                    verdicts += 1
                    if max_cycles and verdicts >= max_cycles:
                        break
                    continue
                stop.wait(self.poll_s)
        finally:
            hb.stop()
        return verdicts
