"""Zero-downtime rolling restart of a ``task=gateway`` fleet (the
counterpart of tools/gateway_rolling.sh for lightgbm_tpu_torch).

    python3 -m lightgbm_tpu_torch.tools.gateway_rolling [--device cpu]
        [--backends 3] [--work build/gateway_rolling]

The runbook, end to end, with every server a process of its own (on the
card unless ``--device cpu`` is given; the gateway itself does no device
work):

1. train a small model and start N ``task=serve`` backends and the
   ``task=gateway`` front end; warm each backend directly;
2. run a continuous client against the gateway through every step,
   counting each non-200 answer, each transport error and each score
   more than 1e-5 from the host walker as a failure;
3. roll each backend in turn: SIGTERM (its /readyz turns 503, the
   gateway's health loop drops it, its requests in flight finish, it
   exits 0), a restart on the same port, and a wait until the gateway
   routes to it again (ready in its pool, its breaker closed);
4. kill -9 one backend under load, restart it on the same port, and
   score through the gateway until the victim's breaker has gone open
   -> half_open -> closed (read from the gateway process's /metrics);
5. drain the gateway itself with SIGTERM while a large request is in
   flight: readiness turns 503 and new work is shed as 503
   ``error_kind=shutdown``, the request in flight finishes 200, the
   process exits 0 and answers nothing after.

The client must see 0 failures across steps 3 and 4. The script prints
one JSON line of its numbers, then ``gateway_rolling: OK``. Run it only
as a module (``-m``).

The steps are functions (``roll``, ``kill9``, ``drain_gateway``) over
callables, so a test can drive the roll with in-process servers and
``chip_smoke.py`` with the processes of ``ProcessFleet``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import shutil
import signal
import threading
import time
import urllib.parse
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import _procs

TOL = 1e-5
# the gateway's settings for the runbook: a fast health loop, retries
# with short backoff, and a breaker that opens on one failure and probes
# again after 0.4 s (the kill -9 step reads its whole cycle). No hedges:
# after a SIGKILL a card process keeps its listening socket while the
# kernel tears down its memory (connects time out, then are refused),
# and a hedge that wins cancels the attempt stuck there; a cancel is
# neutral to the breaker, so with hedges the breaker of a killed card
# backend need never open (the health loop drops it instead)
GATEWAY_PARAMS = {
    "gateway_health_interval_s": 0.25, "gateway_retries": 3,
    "gateway_backoff_base_s": 0.02, "gateway_breaker_failures": 1,
    "gateway_breaker_cooldown_s": 0.4, "gateway_hedge_budget": 0.0,
    "verbosity": 0,
}


# --------------------------------------------------------------- clients
def _score(host: str, port: int, rows, deadline_ms: float = 20000.0,
           timeout: float = 60.0) -> Tuple[int, Dict[str, Any]]:
    """One score request on a connection of its own."""
    body = json.dumps({"rows": rows, "raw_score": True,
                       "deadline_ms": deadline_ms})
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/score", body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _pct(sorted_vals: Sequence[float], p: float) -> float:
    return float(sorted_vals[min(int(p / 100.0 * len(sorted_vals)),
                                 len(sorted_vals) - 1)])


class LoadClient:
    """Client threads sending batch-1 score requests (a row of ``pool``
    each, raw scores) to ``url`` until ``stop()``, or ``per_thread``
    requests each. A failure is a non-200 answer, a transport error, or
    a score more than TOL from ``ref`` (the host walker's raw score)."""

    def __init__(self, url: str, pool: np.ndarray, ref: np.ndarray,
                 threads: int = 3, per_thread: Optional[int] = None,
                 seed: int = 0):
        u = urllib.parse.urlsplit(url)
        self.host, self.port = u.hostname, u.port
        self.pool, self.ref = pool, ref
        self.n_threads, self.per_thread, self.seed = threads, per_thread, seed
        self._stop = threading.Event()  # lint: allow[per-call-lock] — one a client, shared by its threads
        self._lock = threading.Lock()  # lint: allow[per-call-lock] — one a client, guards its tallies
        self._threads: List[threading.Thread] = []
        self.lat: List[float] = []
        self.failures: List[str] = []
        self.worst = 0.0
        self._t0 = 0.0

    def _worker(self, k: int) -> None:
        rs = np.random.RandomState(self.seed * 100 + k)
        lat, bad, worst, n = [], [], 0.0, 0
        while not self._stop.is_set():
            if self.per_thread is not None and n >= self.per_thread:
                break
            n += 1
            i = int(rs.randint(0, len(self.pool)))
            t0 = time.perf_counter()
            try:
                st, out = _score(self.host, self.port,
                                 self.pool[i:i + 1].tolist())
                if st != 200 or not out.get("ok"):
                    raise OSError(f"HTTP {st}: {out}")
                err = abs(float(out["pred"][0]) - float(self.ref[i]))
                if err > TOL:
                    raise ValueError(f"row {i} off by {err}")
                lat.append(time.perf_counter() - t0)
                worst = max(worst, err)
            except (OSError, KeyError, ValueError) as e:
                bad.append(repr(e)[:200])
        with self._lock:
            self.lat.extend(lat)
            self.failures.extend(bad)
            self.worst = max(self.worst, worst)

    def start(self) -> "LoadClient":
        self._t0 = time.perf_counter()
        self._threads = [threading.Thread(target=self._worker, args=(k,),
                                          name=f"load-client-{k}",
                                          daemon=True)
                         for k in range(self.n_threads)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> Dict[str, Any]:
        """Stop (or, with per_thread, await) the threads; the summary."""
        if self.per_thread is None:
            self._stop.set()
        for t in self._threads:
            t.join(timeout=120)
        wall = time.perf_counter() - self._t0
        lat = sorted(self.lat)
        out: Dict[str, Any] = {
            "requests": len(lat) + len(self.failures),
            "failures": len(self.failures),
            "failure_samples": self.failures[:3],
            "max_abs_vs_host": self.worst, "wall_s": wall}
        if lat:
            out.update(qps=len(lat) / wall, p50_ms=1e3 * _pct(lat, 50),
                       p99_ms=1e3 * _pct(lat, 99),
                       mean_ms=1e3 * sum(lat) / len(lat))
        return out


def fixed_load(url: str, pool, ref, n_requests: int, threads: int = 8,
               seed: int = 0) -> Dict[str, Any]:
    """n_requests batch-1 score requests from ``threads`` client threads
    (a connection a request): qps, p50 / p99 ms, failures."""
    return LoadClient(url, pool, ref, threads=threads,
                      per_thread=n_requests // threads, seed=seed
                      ).start().stop()


# ------------------------------------------------------------- the steps
def roll(backends: Sequence[Tuple[Callable[[], int], Callable[[], Any]]],
         client: LoadClient, settle: Callable[[int], Any],
         log: Callable[[str], None] = lambda s: None) -> Dict[str, Any]:
    """The rolling restart under a running client. ``backends`` holds a
    (stop, start) pair for each backend: stop() drains it and returns its
    exit code, start() brings it back on the same port, ready; then
    settle(i) waits until the gateway routes to it again. Returns the
    client's summary with each stop's exit code and each roll's seconds.
    """
    rcs, secs = [], []
    client.start()
    try:
        time.sleep(0.5)  # traffic flowing before the first drain
        for i, (stop, start) in enumerate(backends):
            t0 = time.perf_counter()
            rcs.append(stop())
            start()
            settle(i)
            secs.append(time.perf_counter() - t0)
            log(f"gateway_rolling: rolled backend {i + 1}/{len(backends)}")
        time.sleep(0.5)
    finally:
        out = client.stop()
    out.update(rolled=len(rcs), exit_codes=rcs, roll_s=secs)
    return out


def kill9(client: LoadClient, kill: Callable[[], int],
          restart: Callable[[], Any], breaker: Callable[[], Dict[str, Any]],
          probe: Callable[[], None], timeout: float = 120.0,
          attempts: Optional[Callable[[], Dict[str, int]]] = None
          ) -> Dict[str, Any]:
    """kill -9 one backend under the running client, restart it, and
    probe through the gateway until its breaker has gone open ->
    half_open -> closed since the kill. breaker() returns {"state": ...,
    "transitions": {destination state: count}}; probe() sends one request
    through the gateway and raises if it fails; attempts(), when given,
    the victim's attempts by result (reported as the change over the
    kill window)."""
    before = breaker()["transitions"]
    tried = attempts() if attempts is not None else {}
    client.start()
    try:
        time.sleep(1.0)  # traffic through every backend
        t_kill = time.perf_counter()
        rc = kill()
        t_reaped = time.perf_counter()
        time.sleep(2.0)  # the survivors carry the load
    finally:
        out = client.stop()
    if attempts is not None:
        out["victim_attempts"] = {k: v - tried.get(k, 0)
                                  for k, v in attempts().items()
                                  if v != tried.get(k, 0)}
    out["kill_to_reaped_s"] = t_reaped - t_kill
    t_restart = time.perf_counter()
    restart()
    t_ready = time.perf_counter()
    probes = 0
    while True:
        probe()
        probes += 1
        b = breaker()
        seen = {k: v - before.get(k, 0) for k, v in b["transitions"].items()}
        if b["state"] == "closed" and all(
                seen.get(k, 0) > 0 for k in ("open", "half_open", "closed")):
            break
        if time.perf_counter() - t_ready > timeout:
            raise AssertionError(f"breaker never closed again: {b}, "
                                 f"transitions since the kill {seen}")
        time.sleep(0.05)
    t_closed = time.perf_counter()
    out.update(exit_code=rc, transitions=seen, breaker=b["state"],
               probes=probes, restart_s=t_ready - t_restart,
               ready_to_closed_s=t_closed - t_ready,
               kill_to_closed_s=t_closed - t_kill)
    return out


def breaker_of(metrics_text: str, backend: str) -> Dict[str, Any]:
    """A backend's breaker from the gateway's exposition: its coded state
    gauge and its transitions counter by destination state."""
    from lightgbm_tpu_torch.obs.aggregate import parse_prometheus

    m = parse_prometheus(metrics_text)["metrics"]
    states = {0: "closed", 1: "half_open", 2: "open"}
    tag = f'backend="{backend}"'
    state = next((states.get(int(v)) for k, v in m.get(
        "lgbmtpu_gateway_breaker_state", {}).get("values", {}).items()
        if tag in k), "closed")  # no transition yet: still closed
    trans = {}
    for k, v in m.get("lgbmtpu_gateway_breaker_transitions_total",
                      {}).get("values", {}).items():
        if tag in k:
            to = k.split('to="', 1)[1].split('"', 1)[0]
            trans[to] = trans.get(to, 0) + int(v)
    return {"state": state, "transitions": trans}


def attempts_of(metrics_text: str, backend: str) -> Dict[str, int]:
    """A backend's attempts by result (ok / 5xx / error / cancelled) from
    the gateway's exposition."""
    from lightgbm_tpu_torch.obs.aggregate import parse_prometheus

    vals = parse_prometheus(metrics_text)["metrics"].get(
        "lgbmtpu_gateway_attempts_total", {}).get("values", {})
    out: Dict[str, int] = {}
    for k, v in vals.items():
        if f'backend="{backend}"' in k:
            res = k.split('result="', 1)[1].split('"', 1)[0]
            out[res] = out.get(res, 0) + int(v)
    return out


def merged_processes(gateway_url: str, backend_urls: Sequence[str]) -> int:
    """How many processes the gateway's merged /metrics covers, read from
    outside it: 1 for the gateway's own series, plus each backend whose
    own protocol counters the merged ones add up from (the largest set
    whose sums match every merged sample). Call it with no traffic in
    flight: /readyz and /metrics pulls count no protocol request."""
    from itertools import combinations

    from lightgbm_tpu_torch.obs.aggregate import parse_prometheus

    name = "lgbmtpu_serve_protocol_requests_total"
    merged = parse_prometheus(_procs.get(gateway_url, "/metrics")[1]
                              )["metrics"]
    own = [parse_prometheus(_procs.get(u, "/metrics")[1])["metrics"]
           .get(name, {}).get("values", {}) for u in backend_urls]
    total = merged.get(name, {}).get("values", {})
    n = int(any(k.startswith("lgbmtpu_gateway_") for k in merged))
    for size in range(len(own), 0, -1):
        for pick in combinations(own, size):
            keys = set(total) | {k for vals in pick for k in vals}
            if keys and all(abs(total.get(k, 0.0) - sum(
                    v.get(k, 0.0) for v in pick)) < 0.5 for k in keys):
                return n + size
    return n


def drain_gateway(gateway: "_procs.Child", url: str, slow_rows,
                  quick_rows, timeout: float = 120.0) -> Dict[str, Any]:
    """SIGTERM the gateway process while a large request is in flight
    through it: /readyz turns 503, a new request is shed as 503
    error_kind=shutdown before the large one ends, the large one answers
    200, the process exits 0, and nothing answers after."""
    u = urllib.parse.urlsplit(url)
    slow: Dict[str, Any] = {}

    def send_slow():
        try:
            slow["status"], out = _score(u.hostname, u.port, slow_rows,
                                         deadline_ms=0.0, timeout=timeout)
            slow["rows"] = len(out.get("pred", []))
        except (OSError, ValueError) as e:
            slow["error"] = repr(e)[:200]
        slow["end"] = time.perf_counter()

    th = threading.Thread(target=send_slow, name="drain-inflight",
                          daemon=True)
    th.start()
    t0 = time.perf_counter()
    while json.loads(_procs.get(url, "/v1/status")[1])["inflight"] < 1:
        if not th.is_alive() or time.perf_counter() - t0 > timeout:
            raise AssertionError(f"the large request never went in "
                                 f"flight: {slow}")
        time.sleep(0.005)
    t_sig = time.perf_counter()
    gateway.signal(signal.SIGTERM)
    while _procs.get(url, "/readyz")[0] != 503:
        if time.perf_counter() - t_sig > timeout:
            raise AssertionError("the gateway's /readyz never turned 503")
        time.sleep(0.005)
    t_unready = time.perf_counter()
    st, shed = _score(u.hostname, u.port, quick_rows)
    t_shed = time.perf_counter()
    th.join(timeout=timeout)
    rc = gateway.wait(timeout)
    try:
        _score(u.hostname, u.port, quick_rows, timeout=5.0)
        answered_after = True
    except OSError:
        answered_after = False
    return {"shed_status": st, "shed_error_kind": shed.get("error_kind"),
            "shed_before_inflight_done": t_shed < slow.get("end", 0.0),
            "inflight_status": slow.get("status"),
            "inflight_rows": slow.get("rows"),
            "inflight_error": slow.get("error"),
            "signal_to_unready_ms": 1e3 * (t_unready - t_sig),
            "signal_to_inflight_done_ms": 1e3 * (slow.get("end", t_sig)
                                                  - t_sig),
            "exit_code": rc, "answered_after_exit": answered_after}


def routed(row: Dict[str, Any]) -> bool:
    """A row of the gateway's status: ready, and its breaker closed."""
    return bool(row["ready"]) and row["breaker"] == "closed"


# ----------------------------------------------------- process plumbing
class ProcessFleet:
    """N ``task=serve`` backend processes and one ``task=gateway``
    process over them, each with a log under ``work``."""

    def __init__(self, model_path, device: str, work, n_backends: int,
                 serve_params: Optional[Dict[str, Any]] = None,
                 gateway_params: Optional[Dict[str, Any]] = None):
        self.model_path, self.device = str(model_path), device
        self.work = Path(work)
        self.serve_params = {"serve_warmup": "true", "verbosity": -1,
                             **(serve_params or {})}
        self.gateway_params = dict(GATEWAY_PARAMS, **(gateway_params or {}))
        self.ports = [_procs.free_port() for _ in range(n_backends)]
        self.urls = [f"http://127.0.0.1:{p}" for p in self.ports]
        self.names = [f"127.0.0.1:{p}" for p in self.ports]
        self.backends: List[Optional[_procs.Child]] = [None] * n_backends
        self.gateway: Optional[_procs.Child] = None
        self.gateway_url = ""
        self.exit_codes: Dict[str, List[int]] = {}
        self._starts = [0] * n_backends
        self._ok_before = [0] * n_backends
        self.ready_s: Dict[str, List[float]] = {}

    def children(self) -> List[Optional[_procs.Child]]:
        return list(self.backends) + [self.gateway]

    def _spawn_backend(self, i: int) -> _procs.Child:
        self._starts[i] += 1
        return _procs.spawn(
            "serve", {"input_model": self.model_path,
                      "serve_port": self.ports[i], **self.serve_params},
            self.device, self.work / f"backend{i}.{self._starts[i]}.log",
            name=f"backend {i}")

    def start(self) -> None:
        """Every backend and the gateway at once (the gateway's health
        loop registers each backend as it turns ready); returns when all
        of them answer /readyz 200."""
        for i in range(len(self.ports)):
            self.backends[i] = self._spawn_backend(i)
        port = _procs.free_port()
        self.gateway_url = f"http://127.0.0.1:{port}"
        self.gateway = _procs.spawn(
            "gateway", {"gateway_backends": ",".join(self.urls),
                        "gateway_port": port, **self.gateway_params},
            self.device, self.work / "gateway.log", name="gateway")
        for i, u in enumerate(self.urls):
            self.ready_s.setdefault(f"backend{i}", []).append(
                _procs.wait_ready(u, self.backends[i]))
        self.ready_s["gateway"] = [_procs.wait_ready(self.gateway_url,
                                                     self.gateway)]
        for i in range(len(self.urls)):
            self.settle(i, require_answer=False)

    def record(self, name: str, rc: int) -> int:
        self.exit_codes.setdefault(name, []).append(rc)
        return rc

    def stop_backend(self, i: int) -> int:
        """SIGTERM: the backend drains and exits; its exit code."""
        return self.record(f"backend{i}", _procs.stop(self.backends[i]))

    def kill_backend(self, i: int) -> int:
        return self.record(f"backend{i}", _procs.stop(self.backends[i],
                                                       signal.SIGKILL))

    def start_backend(self, i: int) -> float:
        """Back on the same port; the seconds until /readyz answers 200."""
        self._ok_before[i] = self.ok_attempts(i)  # nothing answers yet
        _procs.wait_port_free(self.ports[i])
        self.backends[i] = self._spawn_backend(i)
        s = _procs.wait_ready(self.urls[i], self.backends[i])
        self.ready_s.setdefault(f"backend{i}", []).append(s)
        return s

    def status(self) -> Dict[str, Any]:
        return json.loads(_procs.get(self.gateway_url, "/v1/status")[1])

    def ok_attempts(self, i: int) -> int:
        return attempts_of(_procs.get(self.gateway_url, "/metrics")[1],
                           self.names[i]).get("ok", 0)

    def settle(self, i: int, timeout: float = 60.0,
               require_answer: bool = True) -> None:
        """Until the gateway routes to backend i again: an attempt on it
        answered since its restart (so the pool has seen it go and come
        back), ready in the pool, its breaker closed (an open or
        half-open breaker admits no traffic, or one probe, while the
        next backend drains)."""
        t0 = time.monotonic()
        while not ((not require_answer
                    or self.ok_attempts(i) > self._ok_before[i])
                   and routed(self.status()["backends"][i])):
            if self.gateway.poll() is not None:
                raise self.gateway.exited()
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"the gateway never re-registered "
                                     f"backend {i}: {self.status()}")
            time.sleep(0.05)

    def breaker(self, i: int) -> Dict[str, Any]:
        return breaker_of(_procs.get(self.gateway_url, "/metrics")[1],
                          self.names[i])

    def warm(self, rows) -> None:
        """One score straight to each backend (its first score after the
        warm-up must not fall inside a timed or faulted step)."""
        for u in self.urls:
            st, out = _procs.post(u, "score", {"rows": rows}, timeout=300)
            assert st == 200 and out["ok"], (u, st, out)

    def close(self) -> List[int]:
        return _procs.terminate_all(self.children())


def runbook(fleet: ProcessFleet, pool, ref, kill_victim: int = 0,
            drain_rows: int = 20_000, client_threads: int = 3,
            log: Callable[[str], None] = lambda s: None) -> Dict[str, Any]:
    """Steps 3-5 on a started fleet: the roll, kill -9 of one backend and
    its breaker's recovery, the merged /metrics's process count, and the
    gateway's drain. Returns the numbers; raises on a failed check."""
    n = len(fleet.urls)
    out: Dict[str, Any] = {}
    rolled = roll([(lambda i=i: fleet.stop_backend(i),
                    lambda i=i: fleet.start_backend(i))
                   for i in range(n)],
                  LoadClient(fleet.gateway_url, pool, ref,
                             threads=client_threads, seed=11),
                  fleet.settle, log)
    out["roll"] = rolled
    if rolled["failures"] or any(rolled["exit_codes"]):
        raise AssertionError(f"client-visible failures or a drain's exit "
                             f"code during the roll: {rolled}")

    def probe():
        st, resp = _procs.post(fleet.gateway_url, "score",
                               {"rows": pool[:1].tolist(),
                                "raw_score": True, "deadline_ms": 30000})
        if st != 200 or abs(resp["pred"][0] - ref[0]) > TOL:
            raise AssertionError(f"probe through the gateway: {st} {resp}")

    killed = kill9(LoadClient(fleet.gateway_url, pool, ref,
                              threads=client_threads, seed=12),
                   lambda: fleet.kill_backend(kill_victim),
                   lambda: fleet.start_backend(kill_victim),
                   lambda: fleet.breaker(kill_victim), probe,
                   attempts=lambda: attempts_of(
                       _procs.get(fleet.gateway_url, "/metrics")[1],
                       fleet.names[kill_victim]))
    out["kill9"] = killed
    if killed["failures"] or killed["exit_code"] != -signal.SIGKILL:
        raise AssertionError(f"kill -9 step: {killed}")
    log(f"gateway_rolling: backend {kill_victim} killed -9, its breaker "
        f"closed again {killed['kill_to_closed_s']:.2f} s later")
    fleet.settle(kill_victim)
    out["merged_processes"] = merged_processes(fleet.gateway_url,
                                               fleet.urls)
    if out["merged_processes"] != n + 1:
        raise AssertionError(f"the gateway's /metrics merged "
                             f"{out['merged_processes']} processes, not "
                             f"{n + 1}")
    rs = np.random.RandomState(3)
    big = rs.randn(drain_rows, pool.shape[1]).astype(np.float32).tolist()
    drained = drain_gateway(fleet.gateway, fleet.gateway_url, big,
                            pool[:1].tolist())
    fleet.record("gateway", drained["exit_code"])
    out["drain"] = drained
    if not (drained["shed_status"] == 503
            and drained["shed_error_kind"] == "shutdown"
            and drained["shed_before_inflight_done"]
            and drained["inflight_status"] == 200
            and drained["inflight_rows"] == drain_rows
            and drained["exit_code"] == 0
            and not drained["answered_after_exit"]):
        raise AssertionError(f"gateway drain: {drained}")
    return out


def _model(work: Path, device: str) -> Tuple[Path, np.ndarray, np.ndarray]:
    """The runbook's model (10 trees, 15 leaves, 800 rows x 5), trained
    through the command line; a row pool and its host raw scores."""
    import lightgbm_tpu_torch as lgb

    rs = np.random.RandomState(0)
    X = rs.randn(800, 5)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    np.savetxt(work / "train.csv", np.column_stack([y, X]), delimiter=",",
               fmt="%.6g")
    child = _procs.spawn("train", {
        "data": work / "train.csv", "objective": "binary",
        "num_leaves": 15, "num_trees": 10, "verbosity": -1,
        "output_model": work / "model.txt"}, device, work / "train.log")
    if child.wait(600) != 0:
        raise child.exited()
    pool = np.random.RandomState(5).randn(2000, 5).astype(np.float32)
    ref = lgb.Booster(model_file=str(work / "model.txt")).predict(
        pool, raw_score=True)
    return work / "model.txt", pool, ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backends", type=int, default=3)
    ap.add_argument("--work", default="build/gateway_rolling")
    args = ap.parse_args(argv)
    if args.backends < 2:
        ap.error("--backends must be at least 2 (a roll needs a survivor)")
    _procs.require_device(args.device)

    t_all = time.perf_counter()
    work = Path(args.work).resolve()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    line: Dict[str, Any] = {"device": args.device, "backends": args.backends,
                            "build": _procs.prebuild(args.device)}
    model, pool, ref = _model(work, args.device)
    fleet = ProcessFleet(model, args.device, work, args.backends,
                         serve_params={"serve_buckets": "16,64"})
    try:
        fleet.start()
        fleet.warm(pool[:4].tolist())
        line.update(runbook(fleet, pool, ref, log=lambda s: print(
            s, flush=True)))
        for i in range(args.backends):
            fleet.stop_backend(i)
    finally:
        fleet.close()
    line["exit_codes"] = fleet.exit_codes
    line["ready_s"] = fleet.ready_s
    line["seconds"] = time.perf_counter() - t_all
    bad = {k: v for k, v in fleet.exit_codes.items()
           if any(rc not in (0, -signal.SIGKILL) for rc in v)}
    if bad:
        raise AssertionError(f"a drained process exited non-zero: {bad}")
    print(json.dumps(line), flush=True)
    print(f"gateway_rolling: OK: {line['roll']['requests']} requests, 0 "
          f"failures across a roll of {args.backends} backends and a "
          f"kill -9; gateway drained clean (rc=0)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
