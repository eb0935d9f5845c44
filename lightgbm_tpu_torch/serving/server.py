"""Scoring server: JSONL request loop + HTTP front end.

The port of lightgbm_tpu/serving/server.py: two transports over ONE
request vocabulary, answering the same requests with the same response
fields as the JAX package.

- ``ScoringServer`` — line-delimited JSON over a pair of streams. One
  request per line, one response line per request.
- ``serve_http`` — a stdlib ThreadingHTTPServer mapping
  ``POST /v1/<op>`` to the same handler. Each request runs on its own
  thread; score requests carrying ``"queue": true`` coalesce through the
  model's MicroBatcher into shared padded device calls. ``GET /metrics``
  serves Prometheus text exposition from the obs metrics registry,
  ``GET /healthz`` answers liveness and ``GET /readyz`` readiness.

Request ops:
  {"op": "score", "model": "m", "rows": [[...], ...],
   "raw_score": false, "num_iteration": -1, "pred_leaf": false}
  {"op": "contrib", "model": "m", "rows": [[...], ...]}  # SHAP values
  {"op": "load", "model": "m", "path": "model.txt"}   # or "model_str"
  {"op": "swap", "model": "m", "version": 2}
  {"op": "rollback", "model": "m"}
  {"op": "models"} / {"op": "stats"} / {"op": "ping"} / {"op": "quit"}
  {"op": "fleet"}   # residency, paging and capture counts of a
                    # ModelFleet (serving/fleet.py); GET /v1/fleet too
  {"op": "ingest", "rows": [[...]], "labels": [...], "weights": [...]}
                    # a labeled microbatch into the attached online
                    # loop's spool (online/ingest.py); refused with no
                    # loop attached

Either transport serves a ModelRegistry or a ModelFleet: the load op's
"deadline_ms" / "queue_cap" set a fleet tenant's QoS.

Responses: {"ok": true, ...} or {"ok": false, "error": "..."}; scores
ride as nested lists, latency from timer.latency_stats rides in
"stats". The ``serve_request`` fault site runs before every request
(resilience/faultinject.py); cli.py's task=serve drives either
transport.
"""

from __future__ import annotations

import json
from typing import Any, Dict, IO, Optional

import numpy as np

from .. import log
from ..obs.metrics import default_registry, record_request_op
from ..resilience.errors import (
    DeadlineExceeded,
    InjectedFault,
    QueueOverflow,
    ShutdownError,
)
from ..resilience.faultinject import fault_point
from .registry import ModelRegistry

# typed failure -> HTTP status (the JSONL transport carries the same
# "error_kind" field)
ERROR_STATUS = {
    "overloaded": 503,  # queue admission rejected: retry later
    "deadline": 504,    # expired waiting in the microbatch queue
    "shutdown": 503,    # server draining: retry against a peer
    "fault": 500,       # injected / unexpected scoring fault
}


def _error_kind(e: Exception) -> Optional[str]:
    if isinstance(e, QueueOverflow):
        return "overloaded"
    if isinstance(e, DeadlineExceeded):
        return "deadline"
    if isinstance(e, ShutdownError):
        return "shutdown"
    if isinstance(e, InjectedFault):
        return "fault"
    return None


def handle_request(registry: ModelRegistry, req: Dict[str, Any]) -> Dict[str, Any]:
    """One request dict -> one response dict (shared by both transports).
    Every request counts into the obs metrics registry by op — the
    serve-loop counter /metrics and the stats op both read."""
    resp = _handle_request(registry, req)
    record_request_op(str(req.get("op", "score")), bool(resp.get("ok")))
    return resp


def _handle_request(registry: ModelRegistry, req: Dict[str, Any]) -> Dict[str, Any]:
    op = req.get("op", "score")
    try:
        # a planned fault can delay or fail the Nth request here
        # (fault_plan "serve_request:N:..."), through the degradation
        # paths a real failure takes
        fault_point("serve_request")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "models":
            return {"ok": True, "models": registry.models()}
        if op == "stats":
            return {"ok": True, "stats": registry.stats()}
        if op == "load":
            src = req.get("model_str") or req.get("path")
            if not src:
                raise ValueError("load needs 'path' or 'model_str'")
            kwargs: Dict[str, Any] = {
                "warmup": req.get("warmup"),
                "num_features": req.get("num_features"),
            }
            # per-tenant QoS rides the load op (fleet registries honor
            # it; the plain registry would reject unknown kwargs)
            for k in ("deadline_ms", "queue_cap"):
                if req.get(k) is not None:
                    kwargs[k] = req[k]
            v = registry.load(req.get("model", "default"), src, **kwargs)
            return {"ok": True, "version": v}
        if op == "swap":
            registry.swap(req["model"], int(req["version"]))
            return {"ok": True, "active": int(req["version"])}
        if op == "rollback":
            v = registry.rollback(req["model"])
            return {"ok": True, "active": v}
        if op in ("score", "contrib"):
            rows = np.asarray(req["rows"], np.float32)
            dl_ms = req.get("deadline_ms")
            pred = registry.predict(
                req.get("model", "default"), rows,
                raw_score=bool(req.get("raw_score", False)),
                start_iteration=int(req.get("start_iteration", 0)),
                num_iteration=int(req.get("num_iteration", -1)),
                pred_leaf=bool(req.get("pred_leaf", False)),
                pred_contrib=(op == "contrib"
                              or bool(req.get("pred_contrib", False))),
                via_queue=bool(req.get("queue", False)),
                version=req.get("version"),
                deadline_s=(float(dl_ms) / 1000.0
                            if dl_ms is not None else None),
            )
            return {"ok": True, "pred": np.asarray(pred).tolist()}
        if op == "fleet":
            if not hasattr(registry, "fleet_stats"):
                raise ValueError("not a fleet registry")
            return {"ok": True, "fleet": registry.fleet_stats()}
        if op == "ingest":
            # durable microbatch spool for the online loop; the sink is
            # attached by OnlineLoop.attach (same duck-typed-attribute
            # pattern as the fleet op above)
            sink = getattr(registry, "ingest_sink", None)
            if sink is None:
                raise ValueError(
                    "no online loop attached (task=loop owns ingest)")
            out = sink.append(req["rows"], req["labels"],
                              req.get("weights"))
            return {"ok": True, **out}
        if op == "quit":
            return {"ok": True, "quit": True}
        raise ValueError(f"unknown op {op!r}")
    except Exception as e:  # noqa: BLE001 — a bad request must not kill serving
        resp = {"ok": False, "op": op, "error": f"{type(e).__name__}: {e}"}
        kind = _error_kind(e)
        if kind is not None:
            resp["error_kind"] = kind
        if isinstance(e, QueueOverflow):
            resp["retry_after_s"] = e.retry_after_s
        return resp


class ScoringServer:
    """JSONL loop over (in_stream, out_stream)."""

    def __init__(self, registry: Optional[ModelRegistry] = None):
        self.registry = registry if registry is not None else ModelRegistry()

    def serve(self, in_stream: IO[str], out_stream: IO[str]) -> int:
        """Read one JSON request per line until EOF or op=quit; returns
        the number of requests handled."""
        handled = 0
        for line in in_stream:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                resp: Dict[str, Any] = {
                    "ok": False, "error": f"bad json: {e}"
                }
            else:
                resp = handle_request(self.registry, req)
            out_stream.write(json.dumps(resp) + "\n")
            out_stream.flush()
            handled += 1
            if resp.get("quit"):
                break
        return handled


def readiness(registry: ModelRegistry,
              draining: Optional[Any] = None) -> Dict[str, Any]:
    """The /readyz verdict (liveness is /healthz: "the process is
    up"). Ready means: not draining, >=1 model loaded, no device fault
    kept (device_faults), microbatch queue depth under the admission
    cap, and — when an online loop is attached — its heartbeat fresh. A
    gateway routes traffic on THIS verdict only."""
    out: Dict[str, Any] = {
        "ok": False, "role": "backend",
        "draining": bool(draining is not None and draining.is_set()),
    }
    if out["draining"]:
        out["reason"] = "draining"
        return out
    # registry.models() directly — NOT _handle_request: the protocol
    # counters count real requests, never health probes
    try:
        models = registry.models()
    except Exception as e:  # noqa: BLE001 — a broken registry is "not ready", not a crash
        out["reason"] = f"registry: {type(e).__name__}: {e}"
        return out
    out["models"] = len(models or {})
    if not models:
        out["reason"] = "no models loaded"
        return out
    faults_of = getattr(registry, "device_faults", None)
    faults = faults_of() if faults_of is not None else {}
    if faults:
        # a capture / launch / replay error: the card may be in a sticky
        # error state, so route traffic elsewhere
        out["device_faults"] = faults
        out["reason"] = "device fault"
        return out
    cap = int(getattr(registry, "queue_cap", 0) or 0)
    depths = default_registry().snapshot().get(
        "lgbmtpu_serve_queue_depth") or {}
    depth = int(max(depths.values(), default=0))
    out["queue_depth"] = depth
    out["queue_cap"] = cap
    if cap > 0 and depth >= cap:
        out["reason"] = "queue at admission cap"
        return out
    probe = getattr(registry, "health_probe", None)
    if probe is not None:
        try:
            health = probe()
        except Exception as e:  # noqa: BLE001 — probe must not kill /readyz
            health = {"healthy": False,
                      "error": f"{type(e).__name__}: {e}"}
        out["health"] = health
        if not health.get("healthy", True):
            out["reason"] = "loop heartbeat stale"
            return out
    out["ok"] = True
    return out


def serve_http(registry: ModelRegistry, port: int,
               host: str = "127.0.0.1", block: bool = True,
               socket_timeout_s: float = 30.0,
               max_body_mb: float = 64.0,
               draining: Optional[Any] = None):
    """HTTP server: POST /v1/<op> with the same JSON bodies ("op"
    inferred from the path); GET /v1/models, /v1/stats, /healthz,
    /readyz (liveness vs readiness — the gateway registers on
    readiness only), /metrics (Prometheus text exposition).
    port=0 binds an ephemeral port. With block=True (the task=serve
    mode) returns only when the process is interrupted; block=False
    returns the bound httpd immediately (serve it from your own
    thread; tests do this) — call .shutdown() to stop.

    Hardened transport: every accepted connection carries a
    ``socket_timeout_s`` timeout (a stalled or dead peer times out
    instead of pinning a handler thread forever; the stall answers
    408), and request bodies are bounded by ``max_body_mb`` (413 over
    the cap). ``draining`` is an optional threading.Event the SIGTERM
    path sets: readiness flips false so a gateway stops routing here,
    while in-flight requests finish."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    max_body = int(float(max_body_mb) * 1024 * 1024)

    class Handler(BaseHTTPRequestHandler):
        # per-connection socket timeout (BaseRequestHandler.setup
        # applies it): the slow-client hardening
        timeout = float(socket_timeout_s)

        def _reply(self, resp: Dict[str, Any], code: int = 200) -> None:
            body = json.dumps(resp).encode()
            if code == 200 and not resp.get("ok", True):
                # typed resilience failures map to their own statuses
                # (503 overloaded / 504 deadline); anything else is a
                # handler error; explicit codes (404) win
                code = ERROR_STATUS.get(resp.get("error_kind"), 400)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if resp.get("error_kind") == "overloaded":
                self.send_header(
                    "Retry-After",
                    str(max(int(resp.get("retry_after_s", 1)), 1)),
                )
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path in ("/healthz", "/health"):
                # registry read, NOT the request handler: a liveness
                # probe must not inflate the op="models" protocol
                # counter
                try:
                    listing = sorted(registry.models() or {})
                except Exception:  # noqa: BLE001 — liveness is "process up", not "registry ok"
                    listing = []
                payload: Dict[str, Any] = {
                    "ok": True,
                    "models": listing,
                }
                # an attached loop's liveness (the JAX package's online
                # loop; not ported): an operator sees a wedged refit
                # loop from the same endpoint that reports serving
                # health. "ok" stays serving-liveness; the loop's own
                # verdict rides in "health"["healthy"].
                probe = getattr(registry, "health_probe", None)
                if probe is not None:
                    try:
                        payload["health"] = probe()
                    except Exception as e:  # noqa: BLE001 — probe must not kill /healthz
                        payload["health"] = {
                            "healthy": False,
                            "error": f"{type(e).__name__}: {e}",
                        }
                self._reply(payload)
            elif self.path == "/readyz":
                ready = readiness(registry, draining)
                self._reply(ready, 200 if ready["ok"] else 503)
            elif self.path == "/metrics":
                # Prometheus text exposition:
                # scrape-time samples from the same registry + latency
                # rings the stats op reports
                body = default_registry().render_prometheus().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                self._reply(handle_request(registry, {"op": "models"}))
            elif self.path == "/v1/stats":
                self._reply(handle_request(registry, {"op": "stats"}))
            elif self.path == "/v1/fleet":
                self._reply(handle_request(registry, {"op": "fleet"}))
            else:
                self._reply({"ok": False, "error": "not found"}, 404)

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._reply({"ok": False,
                             "error": "bad Content-Length"}, 400)
                return
            if n > max_body:
                # bounded body read: refuse before reading, so an
                # oversize (or lying) client cannot balloon the heap
                self._reply({"ok": False,
                             "error": f"body over {max_body} bytes"}, 413)
                return
            try:
                raw = self.rfile.read(n)
            except (OSError, TimeoutError) as e:
                # stalled client: the per-connection socket timeout
                # fired mid-body — answer 408 and free the thread
                self._reply({"ok": False, "error": f"body read: {e}"},
                            408)
                return
            try:
                req = json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                self._reply({"ok": False, "error": f"bad json: {e}"}, 400)
                return
            if self.path.startswith("/v1/"):
                req.setdefault("op", self.path[len("/v1/"):])
            if draining is not None and draining.is_set():
                # stop ACCEPTING new work; in-flight requests on other
                # threads run to completion (the SIGTERM drain
                # contract; gateway peers retry elsewhere on the 503)
                self._reply({"ok": False, "op": req.get("op"),
                             "error": "server draining",
                             "error_kind": "shutdown",
                             "retry_after_s": 1.0})
                return
            if req.get("op") == "quit":  # no remote shutdown over HTTP
                self._reply({"ok": False, "error": "quit is stdio-only"}, 400)
                return
            self._reply(handle_request(registry, req))

        def log_message(self, fmt, *args):  # route through package log
            log.debug(f"serve http: {fmt % args}")

    httpd = ThreadingHTTPServer((host, port), Handler)
    # drain contract: ThreadingMixIn only TRACKS (and joins at
    # server_close) non-daemon handler threads — with the stock
    # daemon_threads=True a SIGTERM drain would drop in-flight
    # responses at process exit. Exit latency stays bounded by the
    # per-connection socket timeout above.
    httpd.daemon_threads = False
    log.info(f"serving on http://{host}:{httpd.server_address[1]}/v1")
    if not block:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return httpd
