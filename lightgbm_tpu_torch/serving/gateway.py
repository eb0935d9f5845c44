"""Resilient serving gateway: the front end over many scoring processes.

The port of lightgbm_tpu/serving/gateway.py, the same decisions on the
same inputs. One ``task=serve`` process is a single point of failure and
of slowness; the gateway is the host-side HTTP front end that spreads
traffic over N backend processes (each a ``serve_http`` over a registry
on its card) and ties a client's latency to the fastest healthy replica
rather than the slowest (Dean & Barroso, "The Tail at Scale").

- **readiness-gated pool** — backends register by answering
  ``GET /readyz`` (liveness is ``/healthz``; ready also means: models
  loaded, queue under its cap, no device fault, the loop's heartbeat
  fresh, not draining). Only ready backends get traffic.
- **least-outstanding-requests balancing** — each request goes to the
  ready backend with the fewest gateway requests in flight.
- **retry with full jitter** — connect errors and 5xx on idempotent ops
  retry on another backend after
  ``resilience.backoff.full_jitter_delay``.
- **hedged requests** — a score / contrib attempt that outlives the
  rolling pXX latency fires one duplicate on another backend; the first
  answer wins, the loser's socket is closed and its breaker sees a
  cancel (not a failure). A budget caps hedges at ``burst + budget_frac
  * requests``, so hedging cannot melt a slow fleet.
- **per-backend circuit breaker** — closed -> open on consecutive
  failures or a window's error rate, open -> half-open after a
  cooldown, half-open admits bounded probes and closes on a success,
  reopens on a failure.
- **deadline propagation** — the client's ``deadline_ms`` (or the
  gateway's default) becomes an absolute budget; expired work is shed
  with 503 + Retry-After before it queues anywhere, and every backend
  attempt carries the remaining budget as its ``deadline_ms``.
- **graceful drain** — SIGTERM (cli.py task=gateway) turns readiness
  off, sheds new work with 503, finishes the requests in flight, then
  exits.

Every decision point is a named fault-injection site (``gw_connect``,
``gw_backend_5xx``, ``gw_slow_backend``, ``gw_drain``;
resilience/faultinject.py), and ``GET /metrics`` on the gateway serves
obs/aggregate.py's pull-and-merge of its own ``lgbmtpu_gateway_*``
series and every live backend's, so the process group reads as one.

Host-side stdlib only: the gateway does no device work, and
``task=gateway`` builds no kernel and touches no card.
"""

from __future__ import annotations

import http.client
import json
import queue
import random
import threading
import time
import urllib.parse
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import log
from ..obs import metrics as obs
from ..resilience.backoff import full_jitter_delay
from ..resilience.errors import InjectedFault
from ..resilience.faultinject import fault_point

# ops safe to retry/hedge (no observable side effect on a replay);
# score/contrib additionally hedge. load/swap/rollback FAN OUT to every
# ready backend instead — the shared registry directory makes the same
# op valid everywhere, and all replicas must agree on the active
# version. ingest is single-backend, no retry (an applied-but-unacked
# append would double rows in the spool).
IDEMPOTENT_OPS = frozenset(
    {"score", "contrib", "models", "stats", "fleet", "ping"})
HEDGED_OPS = frozenset({"score", "contrib"})
FANOUT_OPS = frozenset({"load", "swap", "rollback"})

BREAKER_STATES = ("closed", "open", "half_open")


class CircuitBreaker:
    """Per-backend breaker: closed -> open on consecutive failures or
    window error rate, open -> half-open after ``cooldown_s``,
    half-open admits ``half_open_max`` concurrent probes and closes on
    a probe success, reopens on a probe failure.

    A pure state machine on an injectable clock (``now``): tests drive
    it with a fake clock, no sleeps. Thread-safe; the
    ``on_transition(old, new)`` callback fires OUTSIDE the lock (it
    records metrics/logs and must not re-enter).
    """

    def __init__(self, *, failures: int = 5, error_rate: float = 0.5,
                 window: int = 20, cooldown_s: float = 2.0,
                 half_open_max: int = 1,
                 now: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[str, str], None]] = None):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self.failures = int(failures)
        self.error_rate = float(error_rate)
        self.window = int(window)
        self.cooldown_s = float(cooldown_s)
        self.half_open_max = int(half_open_max)
        self._now = now
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._results: deque = deque(maxlen=max(self.window, 1))
        self._opened_at = 0.0
        self._probes = 0

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            fire = self._age()
            st = self._state
        self._notify(fire)
        return st

    def _age(self) -> Optional[Tuple[str, str]]:
        # caller holds the lock; open ages into half_open lazily, so a
        # fake-clock test needs no background timer
        if (self._state == "open"
                and self._now() - self._opened_at >= self.cooldown_s):
            self._state = "half_open"
            self._probes = 0  # lint: allow[unlocked-write] — every caller holds _lock
            return ("open", "half_open")
        return None

    def _set(self, new: str) -> Optional[Tuple[str, str]]:
        old = self._state
        if old == new:
            return None
        self._state = new
        return (old, new)

    def _notify(self, fire: Optional[Tuple[str, str]]) -> None:
        if fire is not None and self._on_transition is not None:
            try:
                self._on_transition(*fire)
            except Exception as e:  # noqa: BLE001 — observer must not break the breaker
                log.warning(f"breaker transition observer failed: {e}")

    # ------------------------------------------------------------------
    def allow(self) -> bool:
        """May one request be sent through this breaker now?  A True
        answer in half-open claims a probe slot — the caller MUST
        follow with exactly one record_success / record_failure /
        record_cancel."""
        with self._lock:
            fire = self._age()
            st = self._state
            if st == "closed":
                ok = True
            elif st == "open":
                ok = False
            else:  # half_open: bounded probe admission
                ok = self._probes < self.half_open_max
                if ok:
                    self._probes += 1
        self._notify(fire)
        return ok

    def record_success(self) -> None:
        fire = None
        with self._lock:
            if self._state == "half_open":
                # probe succeeded: the backend is back
                self._probes = max(self._probes - 1, 0)
                fire = self._set("closed")
            self._consecutive = 0
            self._results.append(0)
        self._notify(fire)

    def record_failure(self) -> None:
        fire = None
        with self._lock:
            if self._state == "half_open":
                # probe failed: straight back to open, restart cooldown
                self._probes = max(self._probes - 1, 0)
                self._opened_at = self._now()
                fire = self._set("open")
            elif self._state == "closed":
                self._consecutive += 1
                self._results.append(1)
                trip = self._consecutive >= self.failures
                if not trip and len(self._results) >= self.window:
                    rate = sum(self._results) / len(self._results)
                    trip = rate >= self.error_rate
                if trip:
                    self._opened_at = self._now()
                    fire = self._set("open")
        self._notify(fire)

    def record_cancel(self) -> None:
        """A hedged loser was cancelled mid-flight: releases a probe
        slot but is NEITHER a success nor a failure — a cancel says
        nothing about backend health."""
        with self._lock:
            if self._state == "half_open":
                self._probes = max(self._probes - 1, 0)


class RollingLatency:
    """Fixed-window latency ring with a quantile read — feeds the hedge
    trigger delay. Thread-safe, tiny."""

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(window), 1))

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring.append(float(seconds))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._ring)
        if not vals:
            return None
        idx = min(int(q * len(vals)), len(vals) - 1)
        return vals[idx]


class HedgePolicy:
    """When and whether to fire a duplicate attempt.

    The trigger delay is the rolling ``quantile`` of observed attempt
    latencies (``default_delay_s`` until the ring warms up, never below
    ``min_delay_s``). The budget caps total hedges at
    ``burst + budget_frac * requests`` — the Dean & Barroso discipline
    that hedging may add only a few percent extra load. Pure state
    machine; fake-clock-free by construction (it never reads a clock).
    """

    def __init__(self, *, quantile: float = 0.95,
                 budget_frac: float = 0.05, min_delay_s: float = 0.001,
                 default_delay_s: float = 0.05, window: int = 256,
                 burst: int = 8):
        self.quantile = float(quantile)
        self.budget_frac = float(budget_frac)
        self.min_delay_s = float(min_delay_s)
        self.default_delay_s = float(default_delay_s)
        self.burst = int(burst)
        self.latency = RollingLatency(window)
        self._lock = threading.Lock()
        self._requests = 0
        self._hedges = 0

    def observe(self, seconds: float) -> None:
        self.latency.observe(seconds)

    def delay_s(self) -> float:
        q = self.latency.quantile(self.quantile)
        if q is None:
            q = self.default_delay_s
        return max(q, self.min_delay_s)

    def note_request(self) -> None:
        with self._lock:
            self._requests += 1

    def try_hedge(self) -> bool:
        """Claim budget for one hedge; False when spent (the caller
        must then wait out the slow primary instead of hedging)."""
        with self._lock:
            if self.budget_frac <= 0.0:
                return False
            cap = self.burst + self.budget_frac * self._requests
            if self._hedges + 1 > cap:
                return False
            self._hedges += 1
            return True

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"requests": self._requests, "hedges": self._hedges}


class Backend:
    """One backend slot. All mutable fields are owned by
    ``BackendPool._lock`` — the pool is the only writer."""

    __slots__ = ("url", "name", "breaker", "outstanding", "alive",
                 "ready", "detail")

    def __init__(self, url: str, breaker: CircuitBreaker):
        self.url = url.rstrip("/")
        self.name = urllib.parse.urlsplit(self.url).netloc or self.url
        self.breaker = breaker
        self.outstanding = 0
        self.alive = False
        self.ready = False
        self.detail = ""


class BackendPool:
    """Readiness-gated backend set with least-outstanding acquire."""

    def __init__(self, urls: Sequence[str],
                 breaker_factory: Callable[[str], CircuitBreaker]):
        if not urls:
            raise ValueError("gateway needs at least one backend url")
        self._lock = threading.Lock()
        self.backends: List[Backend] = [
            Backend(u, breaker_factory(u)) for u in urls
        ]
        seen = set()
        for b in self.backends:
            if b.url in seen:
                raise ValueError(f"duplicate backend url {b.url!r}")
            seen.add(b.url)

    # ------------------------------------------------------------------
    def acquire(self, exclude: Sequence[Backend] = ()
                ) -> Optional[Backend]:
        """Least-outstanding ready backend whose breaker admits the
        request, or None. Breaker admission runs OUTSIDE the pool lock
        (each breaker has its own lock; no nested acquisition)."""
        with self._lock:
            ranked = sorted(
                (b for b in self.backends
                 if b.ready and b not in exclude),
                key=lambda b: b.outstanding,
            )
        for b in ranked:
            if b.breaker.allow():
                with self._lock:
                    b.outstanding += 1
                return b
        return None

    def release(self, backend: Backend) -> None:
        with self._lock:
            backend.outstanding = max(backend.outstanding - 1, 0)

    def set_health(self, backend: Backend, alive: bool, ready: bool,
                   detail: str = "") -> None:
        with self._lock:
            backend.alive = bool(alive)
            backend.ready = bool(ready)
            backend.detail = detail

    def counts(self) -> Tuple[int, int]:
        with self._lock:
            alive = sum(1 for b in self.backends if b.alive)
            ready = sum(1 for b in self.backends if b.ready)
        return alive, ready

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            rows = [
                {"url": b.url, "alive": b.alive, "ready": b.ready,
                 "outstanding": b.outstanding, "detail": b.detail}
                for b in self.backends
            ]
        for row, b in zip(rows, self.backends):
            row["breaker"] = b.breaker.state
        return rows


class _Attempt:
    """One in-flight backend attempt. Plain flags, written by one
    thread and read by the coordinator — cancellation is best-effort
    (closing the socket unblocks the read; a cancel that races the
    response just means the result is ignored)."""

    __slots__ = ("backend", "hedge", "conn", "cancelled", "done")

    def __init__(self, backend: Backend, hedge: bool):
        self.backend = backend
        self.hedge = hedge
        self.conn: Optional[http.client.HTTPConnection] = None
        self.cancelled = False
        self.done = False


class Gateway:
    """The balancing/retry/hedge/drain coordinator. Transport-neutral:
    ``handle(op, payload) -> (status, response)`` is the whole request
    path; ``gateway_http`` wraps it in the stdlib HTTP front end."""

    def __init__(self, backend_urls: Sequence[str], *,
                 retries: int = 2, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0,
                 hedge_quantile: float = 0.95,
                 hedge_budget: float = 0.05,
                 hedge_min_delay_s: float = 0.001,
                 hedge_default_delay_s: float = 0.05,
                 breaker_failures: int = 5,
                 breaker_error_rate: float = 0.5,
                 breaker_window: int = 20,
                 breaker_cooldown_s: float = 2.0,
                 default_deadline_ms: float = 0.0,
                 health_interval_s: float = 1.0,
                 probe_timeout_s: float = 5.0,
                 attempt_timeout_s: float = 30.0,
                 rng: Optional[random.Random] = None):
        self.retries = int(retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.default_deadline_ms = float(default_deadline_ms)
        self.health_interval_s = float(health_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.hedge = HedgePolicy(
            quantile=hedge_quantile, budget_frac=hedge_budget,
            min_delay_s=hedge_min_delay_s,
            default_delay_s=hedge_default_delay_s)
        self._rng = rng if rng is not None else random.Random()

        def _make_breaker(url: str) -> CircuitBreaker:
            name = urllib.parse.urlsplit(url.rstrip("/")).netloc or url
            return CircuitBreaker(
                failures=breaker_failures, error_rate=breaker_error_rate,
                window=breaker_window, cooldown_s=breaker_cooldown_s,
                on_transition=lambda old, new, n=name:
                    self._on_breaker(n, old, new))

        self.pool = BackendPool(backend_urls, _make_breaker)
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Condition()  # guards _inflight
        self._inflight = 0
        self._health_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ health loop
    def _on_breaker(self, backend: str, old: str, new: str) -> None:
        log.warning(f"gateway breaker {backend}: {old} -> {new}")
        obs.record_gateway_breaker(backend, new)

    def _probe_backend(self, b: Backend) -> None:
        """One readiness probe: 200 /readyz = ready, live HTTP error =
        alive-not-ready, transport failure = dead. Plain urllib (NOT
        the fault-pointed attempt transport — a chaos plan aimed at
        request attempts must not corrupt health verdicts)."""
        alive = ready = False
        detail = ""
        try:
            with urllib.request.urlopen(
                    b.url + "/readyz", timeout=self.probe_timeout_s) as r:
                alive = True
                ready = 200 <= r.status < 300
        except urllib.error.HTTPError as e:
            alive = True  # a typed HTTP answer means the process is up
            detail = f"readyz {e.code}"
        except Exception as e:  # noqa: BLE001 — any transport failure = dead
            detail = f"{type(e).__name__}: {e}"
        self.pool.set_health(b, alive, ready, detail)

    def check_now(self) -> Tuple[int, int]:
        """Probe every backend once; returns (alive, ready) counts."""
        for b in self.pool.backends:
            self._probe_backend(b)
        alive, ready = self.pool.counts()
        obs.record_gateway_pool(alive, ready, len(self.pool.backends))
        return alive, ready

    def start(self, wait_ready_s: float = 0.0) -> None:
        """Initial probe sweep (optionally waiting for >=1 ready
        backend) then the periodic health loop."""
        deadline = time.monotonic() + float(wait_ready_s)
        while True:
            _, ready = self.check_now()
            if ready > 0 or time.monotonic() >= deadline:
                break
            if self._stop.wait(min(self.health_interval_s, 0.2)):
                break
        self._health_thread = threading.Thread(
            target=self._health_loop, name="gateway-health", daemon=True)
        self._health_thread.start()

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            self.check_now()

    def stop(self) -> None:
        self._stop.set()
        t = self._health_thread
        if t is not None:
            t.join(timeout=5.0)

    # ------------------------------------------------------------ drain
    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        """Stop accepting work (readyz goes 503, data ops shed)."""
        self._draining.set()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """begin_drain + wait for in-flight requests to finish. True
        when the gateway went idle inside the timeout."""
        self.begin_drain()
        fault_point("gw_drain")
        deadline = time.monotonic() + float(timeout_s)
        with self._idle:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(min(left, 0.25))
        return True

    def inflight(self) -> int:
        with self._idle:
            return self._inflight

    # ---------------------------------------------------------- request
    def handle(self, op: str,
               payload: Optional[Dict[str, Any]] = None
               ) -> Tuple[int, Dict[str, Any]]:
        """One client request -> (http status, response dict)."""
        payload = dict(payload or {})
        op = str(op or payload.get("op") or "score")
        payload.pop("op", None)
        t0 = time.monotonic()
        if self._draining.is_set():
            obs.record_gateway_request(op, "drain",
                                       time.monotonic() - t0)
            return 503, {"ok": False, "op": op,
                         "error": "gateway draining",
                         "error_kind": "shutdown", "retry_after_s": 1.0}
        with self._idle:
            self._inflight += 1
        try:
            status, resp, outcome = self._route(op, payload)
        finally:
            with self._idle:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()
        obs.record_gateway_request(op, outcome, time.monotonic() - t0)
        return status, resp

    def _route(self, op: str, payload: Dict[str, Any]
               ) -> Tuple[int, Dict[str, Any], str]:
        dl_ms = payload.get("deadline_ms")
        if dl_ms is None and self.default_deadline_ms > 0:
            dl_ms = self.default_deadline_ms
        deadline = (time.monotonic() + float(dl_ms) / 1000.0
                    if dl_ms else None)
        if op in FANOUT_OPS:
            return self._fanout(op, payload, deadline)
        return self._single(op, payload, deadline)

    @staticmethod
    def _remaining(deadline: Optional[float]) -> Optional[float]:
        return None if deadline is None else deadline - time.monotonic()

    @staticmethod
    def _shed(op: str) -> Tuple[int, Dict[str, Any], str]:
        # deadline budget exhausted before any backend work: shed with
        # 503 + Retry-After instead of queueing doomed work
        return 503, {"ok": False, "op": op,
                     "error": "deadline budget exhausted at gateway",
                     "error_kind": "shed", "retry_after_s": 1.0}, "shed"

    @staticmethod
    def _unavailable(op: str) -> Tuple[int, Dict[str, Any], str]:
        return 503, {"ok": False, "op": op,
                     "error": "no ready backend admits traffic",
                     "error_kind": "overloaded",
                     "retry_after_s": 1.0}, "unavailable"

    # ----------------------------------------------------------- fanout
    def _fanout(self, op: str, payload: Dict[str, Any],
                deadline: Optional[float]
                ) -> Tuple[int, Dict[str, Any], str]:
        """Control ops (load/swap/rollback) broadcast to every ALIVE
        backend — the shared registry directory makes the op valid
        everywhere and all replicas must agree on the active version.
        Alive (not ready) is deliberate: a fresh backend is not ready
        BECAUSE it has no models, and the bootstrap ``load`` is how it
        becomes ready. No automatic retry (rollback is not
        replay-safe); the caller re-issues on partial failure."""
        targets = [b for b in self.pool.snapshot() if b["alive"]]
        backends = {b.url: b for b in self.pool.backends}
        if not targets:
            return self._unavailable(op)
        results: Dict[str, Any] = {}
        all_ok = True
        for row in targets:
            b = backends[row["url"]]
            rem = self._remaining(deadline)
            if rem is not None and rem <= 0:
                results[b.name] = {"ok": False, "error": "deadline",
                                   "error_kind": "shed"}
                all_ok = False
                continue
            att = _Attempt(b, hedge=False)
            try:
                status, resp = self._http_call(att, op, dict(payload))
            except Exception as e:  # noqa: BLE001 — report per-backend, never die
                b.breaker.record_failure()
                obs.record_gateway_attempt(b.name, "error")
                results[b.name] = {
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                    "error_kind": "unreachable",
                }
                all_ok = False
                continue
            if status >= 500:
                b.breaker.record_failure()
                obs.record_gateway_attempt(b.name, "5xx")
            else:
                b.breaker.record_success()
                obs.record_gateway_attempt(b.name, "ok")
            results[b.name] = resp
            all_ok = all_ok and bool(resp.get("ok"))
        resp = {"ok": all_ok, "op": op, "fanout": len(targets),
                "results": results}
        return ((200, resp, "ok") if all_ok
                else (502, resp, "fanout_partial"))

    # ----------------------------------------------------- single + hedge
    def _single(self, op: str, payload: Dict[str, Any],
                deadline: Optional[float]
                ) -> Tuple[int, Dict[str, Any], str]:
        retriable = op in IDEMPOTENT_OPS
        hedgeable = op in HEDGED_OPS
        last_backend: Optional[Backend] = None
        attempt = 0
        while True:
            attempt += 1
            rem = self._remaining(deadline)
            if rem is not None and rem <= 0:
                return self._shed(op)
            exclude = (last_backend,) if last_backend is not None else ()
            backend = self.pool.acquire(exclude)
            if backend is None and exclude:
                # only the just-failed backend is available: use it
                backend = self.pool.acquire(())
            if backend is None:
                if not retriable or attempt > self.retries:
                    return self._unavailable(op)
                self._sleep_backoff(attempt, deadline)
                continue
            kind, status, resp = self._attempt_hedged(
                backend, op, payload, deadline, hedgeable)
            if kind == "ok":
                return int(status), resp, "ok"
            if kind == "deadline":
                return 504, {"ok": False, "op": op,
                             "error": "deadline expired in flight",
                             "error_kind": "deadline"}, "deadline"
            # backend failure (transport error or 5xx)
            last_backend = backend
            if not retriable or attempt > self.retries:
                if status is not None:
                    return int(status), resp, "failed"
                return 502, resp, "failed"
            self._sleep_backoff(attempt, deadline)

    def _sleep_backoff(self, attempt: int,
                       deadline: Optional[float]) -> None:
        obs.record_gateway_retry()
        d = full_jitter_delay(attempt, self.backoff_base_s,
                              self.backoff_cap_s, rand=self._rng.random)
        rem = self._remaining(deadline)
        if rem is not None:
            d = min(d, max(rem, 0.0))
        if d > 0:
            time.sleep(d)

    def _attempt_hedged(self, primary: Backend, op: str,
                        payload: Dict[str, Any],
                        deadline: Optional[float], hedgeable: bool):
        """Run one (possibly hedged) attempt round: primary now, one
        duplicate on a different backend if the primary outlives the
        rolling-pXX hedge delay and the budget allows. First answer
        wins; the loser's socket is closed and its breaker sees a
        cancel. Returns ("ok", status, resp) | ("fail", status, resp)
        | ("error", None, resp) | ("deadline", None, None)."""
        self.hedge.note_request()
        q: "queue.Queue" = queue.Queue()
        atts: List[_Attempt] = []
        self._spawn(primary, op, payload, deadline, q, atts, hedge=False)
        hedge_tried = False
        while True:
            rem = self._remaining(deadline)
            if rem is not None and rem <= 0:
                self._cancel(atts)
                return ("deadline", None, None)
            if hedgeable and not hedge_tried:
                wait = self.hedge.delay_s()
                if rem is not None:
                    wait = min(wait, rem)
            else:
                wait = rem if rem is not None else self.attempt_timeout_s
            try:
                att, kind, status, resp = q.get(timeout=max(wait, 0.001))
            except queue.Empty:
                if hedgeable and not hedge_tried:
                    hedge_tried = True
                    self._fire_hedge(op, payload, deadline, q, atts)
                continue
            pending = [a for a in atts if not a.done]
            if kind == "ok":
                self._cancel([a for a in atts if a is not att])
                if att.hedge:
                    obs.record_gateway_hedge("won")
                return ("ok", status, resp)
            if pending:
                continue  # the other racer may still win
            if kind == "cancelled":
                # only reachable when every attempt was cancelled with
                # no winner — treat as a transport failure
                kind, resp = "error", {
                    "ok": False, "op": op,
                    "error": "attempt cancelled",
                    "error_kind": "unreachable"}
            return (kind, status, resp)

    def _fire_hedge(self, op: str, payload: Dict[str, Any],
                    deadline: Optional[float], q: "queue.Queue",
                    atts: List[_Attempt]) -> None:
        second = self.pool.acquire(tuple(a.backend for a in atts))
        if second is None:
            obs.record_gateway_hedge("no_backend")
            return
        if not self.hedge.try_hedge():
            self.pool.release(second)
            obs.record_gateway_hedge("denied_budget")
            return
        obs.record_gateway_hedge("fired")
        self._spawn(second, op, payload, deadline, q, atts, hedge=True)

    def _spawn(self, backend: Backend, op: str, payload: Dict[str, Any],
               deadline: Optional[float], q: "queue.Queue",
               atts: List[_Attempt], hedge: bool) -> _Attempt:
        att = _Attempt(backend, hedge)
        atts.append(att)
        body = dict(payload)
        rem = self._remaining(deadline)
        if rem is not None:
            # deadline propagation: the backend sees what is LEFT of
            # the client budget, not the original figure
            body["deadline_ms"] = max(int(rem * 1000.0), 1)
        threading.Thread(
            target=self._run_attempt, args=(att, op, body, q),
            name=f"gw-attempt-{backend.name}", daemon=True,
        ).start()
        return att

    def _run_attempt(self, att: _Attempt, op: str,
                     body: Dict[str, Any], q: "queue.Queue") -> None:
        b = att.backend
        t0 = time.monotonic()
        try:
            status, resp = self._http_call(att, op, body)
        except BaseException as e:  # noqa: BLE001 — report, never kill the worker
            att.done = True
            self.pool.release(b)
            if att.cancelled:
                b.breaker.record_cancel()
                obs.record_gateway_attempt(b.name, "cancelled")
                q.put((att, "cancelled", None, None))
            else:
                b.breaker.record_failure()
                obs.record_gateway_attempt(b.name, "error")
                q.put((att, "error", None, {
                    "ok": False, "op": op,
                    "error": f"{type(e).__name__}: {e}",
                    "error_kind": "unreachable"}))
            return
        att.done = True
        self.pool.release(b)
        if status >= 500:
            b.breaker.record_failure()
            obs.record_gateway_attempt(b.name, "5xx")
            q.put((att, "fail", status, resp))
        else:
            b.breaker.record_success()
            self.hedge.observe(time.monotonic() - t0)
            obs.record_gateway_attempt(b.name, "ok")
            q.put((att, "ok", status, resp))

    def _http_call(self, att: _Attempt, op: str,
                   body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """One POST /v1/<op> to the attempt's backend. The three
        request-path fault sites live here: ``gw_connect`` (before the
        socket opens), ``gw_slow_backend`` (a delay clause stalls the
        response read), ``gw_backend_5xx`` (a raise clause turns the
        answer into a backend failure)."""
        b = att.backend
        parsed = urllib.parse.urlsplit(b.url)
        fault_point("gw_connect")
        conn = http.client.HTTPConnection(
            parsed.hostname, parsed.port or 80,
            timeout=self.attempt_timeout_s)
        att.conn = conn
        try:
            if att.cancelled:
                raise InjectedFault("attempt cancelled before send")
            data = json.dumps(body).encode()
            conn.request("POST", "/v1/" + op, body=data,
                         headers={"Content-Type": "application/json"})
            fault_point("gw_slow_backend")
            r = conn.getresponse()
            raw = r.read()
            status = int(r.status)
        finally:
            conn.close()
        fault_point("gw_backend_5xx")
        try:
            resp = json.loads(raw.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            resp = {"ok": status < 400,
                    "raw": raw[:200].decode(errors="replace")}
        return status, resp

    @staticmethod
    def _cancel(atts: Sequence[_Attempt]) -> None:
        for a in atts:
            if a.done:
                continue
            a.cancelled = True
            conn = a.conn
            if conn is not None:
                try:
                    conn.close()  # unblocks the loser's response read
                except Exception:  # noqa: BLE001 — cancel is best-effort
                    pass

    # ------------------------------------------------------- status/obs
    def status(self) -> Dict[str, Any]:
        alive, ready = self.pool.counts()
        return {
            "ok": ready > 0 and not self._draining.is_set(),
            "draining": self._draining.is_set(),
            "alive": alive,
            "ready": ready,
            "inflight": self.inflight(),
            "hedge": self.hedge.counters(),
            "backends": self.pool.snapshot(),
        }

    def merged_metrics(self) -> Dict[str, Any]:
        """Own registry + a pull from every live backend, folded by
        obs/aggregate.merge — the whole process group as one fleet."""
        from ..obs import aggregate

        snaps = [aggregate.snapshot_dict(process=0)]
        rows = self.pool.snapshot()
        for i, row in enumerate(rows):
            if not row["alive"]:
                continue
            try:
                snaps.append(aggregate.pull_snapshot(
                    row["url"], timeout=self.probe_timeout_s,
                    process=i + 1, retries=0))
            except Exception as e:  # noqa: BLE001 — a dead backend must not kill the scrape
                log.warning(
                    f"gateway metrics pull {row['url']} failed: {e}")
        return aggregate.merge(snaps)

    def merged_metrics_text(self) -> str:
        from ..obs.aggregate import render_merged

        return render_merged(self.merged_metrics())


# ------------------------------------------------------------ transport
def gateway_http(gateway: Gateway, port: int, host: str = "127.0.0.1",
                 block: bool = True, max_body_mb: float = 64.0,
                 socket_timeout_s: float = 30.0):
    """HTTP front end over ``Gateway.handle`` — same shape as
    serving.server.serve_http (port=0 = ephemeral; block=False returns
    the bound httpd for the caller's own thread). Routes:

    - ``POST /v1/<op>`` — proxied/balanced protocol ops;
    - ``GET /healthz`` — gateway liveness (always 200 while up);
    - ``GET /readyz`` — 200 only when >=1 backend is ready and the
      gateway is not draining;
    - ``GET /v1/status`` — pool/breaker/hedge introspection;
    - ``GET /metrics`` — MERGED fleet exposition (gateway + every live
      backend via obs/aggregate).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    max_body = int(max_body_mb * 1024 * 1024)

    class Handler(BaseHTTPRequestHandler):
        # hardened transport: a stalled/dead peer times the socket out
        # instead of pinning a handler thread forever
        timeout = socket_timeout_s

        def _reply(self, code: int, resp: Dict[str, Any]) -> None:
            body = json.dumps(resp).encode()
            self.send_response(int(code))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code in (429, 503) and resp.get("retry_after_s"):
                self.send_header(
                    "Retry-After",
                    str(max(int(resp["retry_after_s"]), 1)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path in ("/healthz", "/health"):
                self._reply(200, {"ok": True, "role": "gateway"})
            elif self.path == "/readyz":
                st = gateway.status()
                self._reply(200 if st["ok"] else 503, st)
            elif self.path == "/v1/status":
                self._reply(200, gateway.status())
            elif self.path == "/metrics":
                try:
                    body = gateway.merged_metrics_text().encode()
                except Exception as e:  # noqa: BLE001 — scrape must answer
                    self._reply(500, {"ok": False,
                                      "error": f"{type(e).__name__}: {e}"})
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path in ("/v1/models", "/v1/stats", "/v1/fleet"):
                op = self.path[len("/v1/"):]
                status, resp = gateway.handle(op, {})
                self._reply(status, resp)
            else:
                self._reply(404, {"ok": False, "error": "not found"})

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._reply(400, {"ok": False,
                                  "error": "bad Content-Length"})
                return
            if n > max_body:
                self._reply(413, {"ok": False,
                                  "error": f"body over {max_body} bytes"})
                return
            try:
                raw = self.rfile.read(n)
            except (OSError, TimeoutError) as e:
                # stalled client: socket timeout fired mid-body
                self._reply(408, {"ok": False,
                                  "error": f"body read: {e}"})
                return
            try:
                req = json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                self._reply(400, {"ok": False,
                                  "error": f"bad json: {e}"})
                return
            if not self.path.startswith("/v1/"):
                self._reply(404, {"ok": False, "error": "not found"})
                return
            op = self.path[len("/v1/"):] or str(req.get("op", "score"))
            if op == "quit":
                self._reply(400, {"ok": False,
                                  "error": "quit is not proxied"})
                return
            status, resp = gateway.handle(op, req)
            self._reply(status, resp)

        def log_message(self, fmt, *args):  # route through package log
            log.debug(f"gateway http: {fmt % args}")

    httpd = ThreadingHTTPServer((host, port), Handler)
    # non-daemon handlers: server_close joins them, so the SIGTERM
    # drain finishes in-flight responses (see serve_http)
    httpd.daemon_threads = False
    log.info(
        f"gateway on http://{host}:{httpd.server_address[1]}/v1 over "
        f"{len(gateway.pool.backends)} backends")
    if not block:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return httpd
