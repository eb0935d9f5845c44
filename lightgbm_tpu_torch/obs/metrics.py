"""Thread-safe metrics registry: counters / gauges / histograms with
labels, plus Prometheus text exposition.

A copy of the part of lightgbm_tpu/obs/metrics.py that serving uses: the
registry (Sample through register_latency_collector) and the serving
recorders, with the same series names (lgbmtpu_serve_*), so a scrape of
the port's /metrics reads like the JAX package's. Modules record named
metrics on the host (never inside a captured CUDA graph); exporters read
one consistent snapshot:

- ``render_prometheus()`` — text exposition (format 0.0.4), served
  from serving/server.py's ``/metrics`` route;
- ``snapshot()`` — plain dicts for readiness checks and tests.

Collectors bridge existing stat objects without duplicating state:
``timer.LatencyStats`` registers a collector that derives its samples
from the SAME ring ``ModelRegistry.stats()`` reports, so the percentile
a scrape sees and the percentile the stats op returns never disagree.

Recording is a dict upsert under a per-metric lock. When the registry is
disabled (env LIGHTGBM_TPU_METRICS=0, or ``disable()``) every record call
is a single attribute check. The fleet's recorders are here
(lgbmtpu_fleet_*), the training, host-fallback and native-build
recorders, the online loop's (lgbmtpu_promotion_events_total,
lgbmtpu_ingest_*, lgbmtpu_online_*) and the gateway's
(lgbmtpu_gateway_*), under the JAX package's series names.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

# default histogram bucket bounds (seconds-flavored, Prometheus style)
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Sample(NamedTuple):
    """One exposition sample (collectors yield these)."""

    name: str
    kind: str  # "counter" | "gauge"
    help: str
    labels: Tuple[Tuple[str, str], ...]
    value: float


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    """Base: one named metric family with a fixed label-name set."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str], registry: "MetricsRegistry"):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._registry = registry
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def _pairs(self, key: Tuple[str, ...]) -> Tuple[Tuple[str, str], ...]:
        return tuple(zip(self.label_names, key))

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        k = self._key(labels)
        with self._lock:
            return float(self._values.get(k, 0.0))

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            Sample(self.name, self.kind, self.help, self._pairs(k), v)
            for k, v in items
        ]


class Gauge(_Metric):
    """Point-in-time value (queue depth, trees/s, ...)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        k = self._key(labels)
        with self._lock:
            self._values[k] = float(value)

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(value)

    def dec(self, value: float = 1.0, **labels: Any) -> None:
        self.inc(-value, **labels)

    def value(self, **labels: Any) -> float:
        k = self._key(labels)
        with self._lock:
            return float(self._values.get(k, 0.0))

    samples = Counter.samples  # same flat shape


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str], registry: "MetricsRegistry",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help_text, label_names, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")

    def observe(self, value: float, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        k = self._key(labels)
        v = float(value)
        with self._lock:
            state = self._values.get(k)
            if state is None:
                state = {"counts": [0] * len(self.buckets),
                         "sum": 0.0, "count": 0}
                self._values[k] = state
            for i, b in enumerate(self.buckets):
                if v <= b:
                    state["counts"][i] += 1
            state["sum"] += v
            state["count"] += 1

    def state(self, **labels: Any) -> Dict[str, Any]:
        k = self._key(labels)
        with self._lock:
            s = self._values.get(k)
            if s is None:
                return {"counts": [0] * len(self.buckets),
                        "sum": 0.0, "count": 0}
            return {"counts": list(s["counts"]), "sum": s["sum"],
                    "count": s["count"]}

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted(
                (k, {"counts": list(s["counts"]), "sum": s["sum"],
                     "count": s["count"]})
                for k, s in self._values.items()
            )
        out: List[Sample] = []
        for k, s in items:
            pairs = self._pairs(k)
            cum = 0
            for b, c in zip(self.buckets, s["counts"]):
                cum = c  # counts are already cumulative per-bucket
                out.append(Sample(
                    self.name + "_bucket", self.kind, self.help,
                    pairs + (("le", _fmt(b)),), float(cum),
                ))
            out.append(Sample(
                self.name + "_bucket", self.kind, self.help,
                pairs + (("le", "+Inf"),), float(s["count"]),
            ))
            out.append(Sample(self.name + "_sum", self.kind, self.help,
                              pairs, float(s["sum"])))
            out.append(Sample(self.name + "_count", self.kind, self.help,
                              pairs, float(s["count"])))
        return out


class MetricsRegistry:
    """Named metric families + scrape-time collectors."""

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []
        if enabled is None:
            enabled = os.environ.get(
                "LIGHTGBM_TPU_METRICS", "1"
            ) not in ("0", "false", "off")
        self.enabled = bool(enabled)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # ------------------------------------------------------------------
    def _get_or_create(self, cls, name: str, help_text: str,
                       labels: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, labels, self, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.label_names}"
            )
        return m

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets=buckets)

    def register_collector(
        self, fn: Callable[[], Iterable[Sample]]
    ) -> None:
        """Register a scrape-time sample source (e.g. a LatencyStats
        bridge). The callable runs on every render/snapshot."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(
        self, fn: Callable[[], Iterable[Sample]]
    ) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # ------------------------------------------------------------------
    def samples(self) -> List[Sample]:
        """Every current sample (metrics + collectors) — the public
        scrape view (each Sample carries its kind, so a merger knows
        counters sum and gauges don't)."""
        return self._all_samples()

    def _all_samples(self) -> List[Sample]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out: List[Sample] = []
        for m in metrics:
            out.extend(m.samples())
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception as e:  # noqa: BLE001 — one bad collector must not kill the scrape
                from .. import log

                log.warning(f"metrics collector {fn!r} failed: {e}")
        return out

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{metric name: {rendered label string: value}} over every
        metric and collector — the manifest/test view."""
        out: Dict[str, Dict[str, float]] = {}
        for s in self._all_samples():
            out.setdefault(s.name, {})[_render_labels(s.labels)] = s.value
        return out

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 (one scrape body)."""
        samples = self._all_samples()
        # group by family: histogram sample names share the base
        # metric's HELP/TYPE header
        by_family: "Dict[str, List[Sample]]" = {}
        family_meta: Dict[str, Tuple[str, str]] = {}
        for s in samples:
            fam = s.name
            for suffix in ("_bucket", "_sum", "_count"):
                if s.kind == "histogram" and fam.endswith(suffix):
                    fam = fam[: -len(suffix)]
                    break
            by_family.setdefault(fam, []).append(s)
            family_meta.setdefault(fam, (s.kind, s.help))
        lines: List[str] = []
        for fam in sorted(by_family):
            kind, help_text = family_meta[fam]
            if help_text:
                lines.append(f"# HELP {fam} {help_text}")
            lines.append(f"# TYPE {fam} {kind}")
            for s in by_family[fam]:
                lines.append(
                    f"{s.name}{_render_labels(s.labels)} {_fmt(s.value)}"
                )
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every recorded value (metric objects survive; tests)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


# ---------------------------------------------------------------- bridges
# Small helpers the instrumented modules call, so hot seams carry one
# obs call instead of registry plumbing.

_latency_bridged: Dict[str, Any] = {}
_latency_lock = threading.Lock()


def register_latency_collector(name: str, stats: Any,
                               model: Optional[str] = None) -> None:
    """Expose a timer.LatencyStats on /metrics. Samples derive from the
    same ``snapshot()`` the serving stats op reports — one ring, every
    reader (the dedupe contract for serving latency). ``model`` adds a
    ``{model=...}`` label (one series set per model)."""
    with _latency_lock:
        if name in _latency_bridged:
            return
        _latency_bridged[name] = stats

    def collect() -> List[Sample]:
        snap = stats.snapshot()
        lab = (("entry", name),)
        if model is not None:
            lab = lab + (("model", model),)
        out = [
            Sample("lgbmtpu_serve_requests_total", "counter",
                   "requests observed by the latency ring", lab,
                   float(snap["count"])),
            Sample("lgbmtpu_serve_rows_total", "counter",
                   "rows scored", lab, float(snap["rows"])),
            Sample("lgbmtpu_serve_rows_per_sec", "gauge",
                   "lifetime rows/second", lab,
                   float(snap["rows_per_sec"])),
            Sample("lgbmtpu_serve_busy_frac", "gauge",
                   "fraction of uptime spent scoring", lab,
                   float(snap["busy_frac"])),
        ]
        for stat in ("mean_ms", "p50_ms", "p95_ms", "p99_ms"):
            out.append(Sample(
                "lgbmtpu_serve_latency_ms", "gauge",
                "request latency over the recent window (ms)",
                lab + (("stat", stat[:-3]),), float(snap[stat]),
            ))
        return out

    _default.register_collector(collect)


def record_bucket_dispatch(entry: str, bucket: int, rows: int) -> None:
    """One padded device call through the serving shape ladder."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_serve_bucket_dispatch_total",
              "device calls per shape-ladder rung",
              labels=("entry", "bucket")).inc(
        1, entry=entry, bucket=bucket)
    r.counter("lgbmtpu_serve_padded_rows_total",
              "zero rows added to pad requests up to their rung",
              labels=("entry",)).inc(max(bucket - rows, 0), entry=entry)


def record_queue_depth(entry: str, depth: int) -> None:
    r = _default
    if not r.enabled:
        return
    r.gauge("lgbmtpu_serve_queue_depth",
            "requests waiting in the microbatch queue",
            labels=("entry",)).set(depth, entry=entry)


def record_coalesce(entry: str, n_requests: int, rows: int) -> None:
    """One microbatch drain: n_requests coalesced into one call."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_serve_coalesced_requests_total",
              "requests coalesced through the microbatch queue",
              labels=("entry",)).inc(n_requests, entry=entry)
    r.histogram("lgbmtpu_serve_coalesced_batch_rows",
                "rows per coalesced device call", labels=("entry",),
                buckets=(1, 4, 16, 64, 256, 1024, 4096)
                ).observe(rows, entry=entry)


def record_serve_rejection(entry: str, kind: str) -> None:
    """A serving request rejected before scoring: queue overflow
    (admission control) or deadline expiry."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_serve_rejected_total",
              "requests rejected by admission control or deadline "
              "expiry, by kind",
              labels=("entry", "kind")).inc(1, entry=entry, kind=kind)


def record_registry_event(event: str, model: str) -> None:
    """Model-registry lifecycle: load / swap / rollback / unload."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_registry_events_total",
              "model registry lifecycle events",
              labels=("event", "model")).inc(1, event=event, model=model)


def record_fleet_page(model: str, event: str) -> None:
    """Fleet device paging: ``page_in`` / ``evict`` / ``warmup`` /
    ``page_fail`` for one tenant (serving/fleet.py LRU residency)."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_fleet_page_events_total",
              "fleet device paging events, by model and kind",
              labels=("model", "event")).inc(1, model=model, event=event)


def record_fleet_resident(resident: int, capacity: int) -> None:
    """Current fleet residency against the configured capacity."""
    r = _default
    if not r.enabled:
        return
    r.gauge("lgbmtpu_fleet_resident_models",
            "models currently resident in device memory").set(resident)
    r.gauge("lgbmtpu_fleet_capacity_models",
            "configured fleet residency capacity").set(capacity)


def record_request_op(op: str, ok: bool) -> None:
    """One protocol request through handle_request (both transports)."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_serve_protocol_requests_total",
              "protocol requests handled, by op",
              labels=("op",)).inc(1, op=op)
    if not ok:
        r.counter("lgbmtpu_serve_protocol_errors_total",
                  "protocol requests answered with ok=false",
                  labels=("op",)).inc(1, op=op)


def record_training_round(n_iters: int, n_trees: int,
                          seconds: float) -> None:
    """One collected fused chunk, or one eager iteration."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_train_iterations_total",
              "boosting iterations completed").inc(n_iters)
    r.counter("lgbmtpu_train_trees_total",
              "trees trained (iterations x classes)").inc(n_trees)
    if seconds > 0:
        r.gauge("lgbmtpu_train_trees_per_sec",
                "trees/second over the most recent chunk"
                ).set(n_trees / seconds)
        r.histogram("lgbmtpu_train_chunk_seconds",
                    "wall seconds per dispatched training chunk"
                    ).observe(seconds)


def record_eval_values(evals) -> None:
    """Each round's ``(dataset, metric, value, higher_better)`` tuples on
    ``lgbmtpu_eval_metric{dataset,metric}``: the learning curve on
    /metrics with no callback."""
    r = _default
    if not r.enabled or not evals:
        return
    g = r.gauge("lgbmtpu_eval_metric",
                "most recent per-round evaluation metric value",
                labels=("dataset", "metric"))
    for item in evals:
        g.set(float(item[2]), dataset=item[0], metric=item[1])


def record_host_fallback(entry: str) -> None:
    """One serving chunk scored by the host walker after its device
    call raised (serving/dispatch.py)."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_serve_host_fallback_total",
              "chunks degraded to the host tree-walker after a device "
              "scoring fault",
              labels=("entry",)).inc(1, entry=entry)


def record_native_build(seconds: float, ok: bool) -> None:
    """One build of the native host library (native/__init__.py)."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_native_builds_total",
              "native fastparse toolchain builds",
              labels=("result",)).inc(1, result="ok" if ok else "failed")
    r.gauge("lgbmtpu_native_build_seconds",
            "wall seconds of the most recent native build").set(seconds)


def record_promotion_event(outcome: str) -> None:
    """One online-loop gate verdict: ``promoted`` (the gate passed, the
    registry swapped), ``rejected`` (the holdout metric fell),
    ``rolled_back`` (an anomaly sentinel tripped or the refit failed:
    a poisoned microbatch reverts to v(n)). online/loop.py."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_promotion_events_total",
              "online-loop promotion gate verdicts, by outcome",
              labels=("outcome",)).inc(1, outcome=outcome)


def record_ingest(rows: int) -> None:
    """One microbatch appended to the online loop's ingest spool."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_ingest_batches_total",
              "microbatches accepted through the ingest op").inc(1)
    r.counter("lgbmtpu_ingest_rows_total",
              "rows accepted through the ingest op").inc(rows)


def record_loop_progress(version: int, cycle: int, offset: int) -> None:
    """Online-loop liveness gauges: the promoted version, the verdict
    cycles and the spool bytes consumed."""
    r = _default
    if not r.enabled:
        return
    r.gauge("lgbmtpu_online_version",
            "currently promoted online-loop model version").set(version)
    r.gauge("lgbmtpu_online_cycles_total",
            "online-loop verdict cycles completed").set(cycle)
    r.gauge("lgbmtpu_online_ingest_offset_bytes",
            "ingest spool bytes consumed through the last verdict"
            ).set(offset)


def record_collective_wire(entry: str, nbytes: int) -> None:
    """Host-side estimate of the collective payload bytes a distributed
    learner dispatched (boosting._record_collective_wire)."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_collective_wire_bytes_total",
              "estimated collective payload bytes dispatched",
              labels=("entry",)).inc(nbytes, entry=entry)


# the gateway's recorders (serving/gateway.py): outcome is the gateway's
# verdict on a client request (ok / failed / shed / deadline /
# unavailable / drain / fanout_partial), result one backend attempt's
# fate (ok / 5xx / error / cancelled); a breaker's state is a coded
# gauge (0 closed, 1 half_open, 2 open) beside a transitions counter
_BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


def record_gateway_request(op: str, outcome: str, seconds: float) -> None:
    """One client request through Gateway.handle, end to end."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_gateway_requests_total",
              "gateway client requests, by op and outcome",
              labels=("op", "outcome")).inc(1, op=op, outcome=outcome)
    r.histogram("lgbmtpu_gateway_request_seconds",
                "gateway end-to-end request latency (incl. retries "
                "and hedges)", labels=("op",)).observe(seconds, op=op)


def record_gateway_attempt(backend: str, result: str) -> None:
    """One backend attempt (primary, retry or hedge)."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_gateway_attempts_total",
              "backend attempts, by backend and result",
              labels=("backend", "result")).inc(
        1, backend=backend, result=result)


def record_gateway_retry() -> None:
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_gateway_retries_total",
              "retry rounds scheduled (full-jitter backoff)").inc(1)


def record_gateway_hedge(outcome: str) -> None:
    """Hedge verdicts: ``fired`` / ``won`` / ``denied_budget`` /
    ``no_backend``."""
    r = _default
    if not r.enabled:
        return
    r.counter("lgbmtpu_gateway_hedges_total",
              "hedged-attempt verdicts, by outcome",
              labels=("outcome",)).inc(1, outcome=outcome)


def record_gateway_breaker(backend: str, state: str) -> None:
    """A breaker transition: the new state as a coded gauge and a
    counter."""
    r = _default
    if not r.enabled:
        return
    r.gauge("lgbmtpu_gateway_breaker_state",
            "circuit state per backend (0 closed, 1 half_open, 2 open)",
            labels=("backend",)).set(
        _BREAKER_STATE_CODE.get(state, -1), backend=backend)
    r.counter("lgbmtpu_gateway_breaker_transitions_total",
              "breaker transitions, by backend and destination state",
              labels=("backend", "to")).inc(1, backend=backend, to=state)


def record_gateway_pool(alive: int, ready: int, total: int) -> None:
    r = _default
    if not r.enabled:
        return
    r.gauge("lgbmtpu_gateway_backends_alive",
            "backends answering HTTP at the last probe sweep"
            ).set(alive)
    r.gauge("lgbmtpu_gateway_backends_ready",
            "backends passing /readyz at the last probe sweep"
            ).set(ready)
    r.gauge("lgbmtpu_gateway_backends_total",
            "configured backend slots").set(total)
