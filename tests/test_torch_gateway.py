"""The port's serving gateway (lightgbm_tpu_torch/serving/gateway.py)
against the JAX package's.

- the circuit breaker, the hedge policy, the full-jitter schedule and
  the backend pool driven through both packages' classes by the same
  seeded scripts on the same fake clock: the same decisions, step for
  step;
- the gateway's state machine (deadline shed, drain, no ready backend,
  the merged exposition) answering as the JAX package's;
- an in-process HTTP gateway over two serve_http backends on CPU
  registries: scores within 1e-5 of the host walker; zero client
  failures under gw_backend_5xx (retries counted) and gw_slow_backend
  (a hedge fires and wins); a backend's drain turns its /readyz to 503
  and traffic moves to the other; /metrics merges both backends';
- the readiness matrix of serving.readiness.
"""

import json
import queue
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.serving import gateway as gw_j
from lightgbm_tpu_torch.obs.metrics import (default_registry,
                                            record_queue_depth)
from lightgbm_tpu_torch.resilience import faultinject
from lightgbm_tpu_torch.serving import ModelRegistry, readiness, serve_http
from lightgbm_tpu_torch.serving import gateway as gw_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultinject.disarm()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------- decision sequences
def _breaker_trace(mod, seed, **kw):
    """A seeded random walk of breaker calls and clock steps; every
    call's answer, the state after it and every transition."""
    rs = random.Random(seed)
    clk = _Clock()
    seen = []
    br = mod.CircuitBreaker(now=clk,
                            on_transition=lambda o, n: seen.append((o, n)),
                            **kw)
    out = []
    for _ in range(400):
        op = rs.choice(("allow", "ok", "fail", "fail", "cancel", "tick",
                        "state"))
        if op == "allow":
            r = br.allow()
        elif op == "ok":
            r = br.record_success()
        elif op == "fail":
            r = br.record_failure()
        elif op == "cancel":
            r = br.record_cancel()
        elif op == "tick":
            clk.t += rs.choice((0.1, 0.5, 1.0, 2.5))
            r = None
        else:
            r = br.state
        out.append((op, r, br.state))
    return out, seen


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"failures": 2, "cooldown_s": 1.0}),
    (2, {"failures": 50, "error_rate": 0.4, "window": 8}),
    (3, {"failures": 1, "half_open_max": 2, "cooldown_s": 0.5})])
def test_breaker_decisions_match(seed, kw):
    tt, st = _breaker_trace(gw_t, seed, **kw)
    tj, sj = _breaker_trace(gw_j, seed, **kw)
    assert tt == tj and st == sj
    assert {n for _, n in st} >= {"open", "half_open", "closed"}


def _hedge_trace(mod, seed, **kw):
    rs = random.Random(seed)
    hp = mod.HedgePolicy(**kw)
    out = []
    for _ in range(300):
        op = rs.choice(("note", "note", "note", "hedge", "observe", "delay"))
        if op == "note":
            r = hp.note_request()
        elif op == "hedge":
            r = hp.try_hedge()
        elif op == "observe":
            r = hp.observe(rs.random() * 0.2)
        else:
            r = hp.delay_s()
        out.append((op, r))
    return out, hp.counters(), len(hp.latency)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"budget_frac": 0.2, "burst": 1, "quantile": 0.5}),
    (2, {"budget_frac": 0.0}), (3, {"window": 4, "min_delay_s": 0.05})])
def test_hedge_decisions_match(seed, kw):
    assert _hedge_trace(gw_t, seed, **kw) == _hedge_trace(gw_j, seed, **kw)


def test_jitter_sequences_match():
    """The gateway's retry sleeps: the same seeded Random gives the same
    full-jitter delays in both packages."""
    from lightgbm_tpu.resilience.backoff import full_jitter_delay as fj_j
    from lightgbm_tpu_torch.resilience.backoff import \
        full_jitter_delay as fj_t

    rt, rj = random.Random(9), random.Random(9)
    a = [fj_t(k % 6 + 1, 0.05, 1.0, rand=rt.random) for k in range(60)]
    b = [fj_j(k % 6 + 1, 0.05, 1.0, rand=rj.random) for k in range(60)]
    assert a == b and max(a) <= 1.0


def _pool_trace(mod, seed):
    rs = random.Random(seed)
    clk = _Clock()
    pool = mod.BackendPool(
        [f"http://127.0.0.1:{9100 + i}" for i in range(4)],
        lambda url: mod.CircuitBreaker(failures=2, cooldown_s=1.0, now=clk))
    for b in pool.backends:
        pool.set_health(b, alive=True, ready=True)
    held = []
    out = []
    for _ in range(300):
        op = rs.choice(("acq", "acq", "acq_ex", "rel", "health", "fail",
                        "ok", "tick"))
        i = rs.randrange(4)
        b = pool.backends[i]
        if op == "acq":
            got = pool.acquire()
            r = None if got is None else got.url
            if got is not None:
                held.append(got)
        elif op == "acq_ex":
            got = pool.acquire(exclude=(b,))
            r = None if got is None else got.url
            if got is not None:
                held.append(got)
        elif op == "rel" and held:
            r = held.pop(rs.randrange(len(held))).url
            pool.release(pool.backends[[x.url for x in pool.backends]
                                       .index(r)])
        elif op == "health":
            ready = rs.random() < 0.7
            pool.set_health(b, alive=True, ready=ready)
            r = ready
        elif op == "fail":
            b.breaker.record_failure()
            r = b.breaker.state
        elif op == "ok":
            b.breaker.record_success()
            r = b.breaker.state
        else:
            clk.t += 0.6
            r = None
        out.append((op, i, r, pool.counts()))
    snap = [{k: v for k, v in row.items()} for row in pool.snapshot()]
    return out, snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_decisions_match(seed):
    """Least-outstanding ranking, exclusion, readiness and breaker
    admission: the same backend chosen at every step."""
    assert _pool_trace(gw_t, seed) == _pool_trace(gw_j, seed)


def test_pool_refusals_and_op_classes_match():
    for mod in (gw_t, gw_j):
        with pytest.raises(ValueError):
            mod.BackendPool([], lambda u: mod.CircuitBreaker())
        with pytest.raises(ValueError):
            mod.BackendPool(["http://h:1", "http://h:1/"],
                            lambda u: mod.CircuitBreaker())
        with pytest.raises(ValueError):
            mod.CircuitBreaker(failures=0)
    assert gw_t.IDEMPOTENT_OPS == gw_j.IDEMPOTENT_OPS
    assert gw_t.HEDGED_OPS == gw_j.HEDGED_OPS
    assert gw_t.FANOUT_OPS == gw_j.FANOUT_OPS


def test_gateway_state_machine_matches():
    """With no backend up: the expired deadline sheds, a drain refuses
    new work, nothing ready answers 503 overloaded, a fan-out with no
    live backend too; the same statuses and error kinds as the JAX
    package's, and the merged exposition carries the gateway's series."""
    res = {}
    for name, mod in (("t", gw_t), ("j", gw_j)):
        gw = mod.Gateway(["http://127.0.0.1:1"], retries=0)
        shed = gw._single("score", {}, time.monotonic() - 1.0)
        unav = gw.handle("score", {"rows": [[0.0]]})
        fan = gw.handle("load", {"path": "x"})
        gw.begin_drain()
        drained = gw.handle("score", {"rows": [[0.0]]})
        idle = gw.drain(timeout_s=0.5)
        st = gw.status()
        res[name] = (shed[0], shed[2], shed[1]["error_kind"], unav[0],
                     unav[1]["error_kind"], fan[0], drained[0],
                     drained[1]["error_kind"], idle, st["draining"],
                     st["ok"], st["inflight"])
        text = gw.merged_metrics_text()
        assert "lgbmtpu_gateway_requests_total" in text
    assert res["t"] == res["j"]


def test_denied_hedge_gives_back_the_probe_slot():
    """A hedge the budget denies releases what acquiring its backend
    took: the pool's outstanding count and a half-open breaker's one
    probe slot. (Kept, the slot left the breaker half-open for good: it
    admitted no probe, so no success could close it.)"""
    gw = gw_t.Gateway(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                      hedge_budget=0.0, breaker_failures=1,
                      breaker_cooldown_s=0.0)
    a, b = gw.pool.backends
    for x in (a, b):
        gw.pool.set_health(x, True, True)
    b.breaker.record_failure()  # open, half-open at once (no cooldown)
    assert b.breaker.state == "half_open"
    gw._fire_hedge("score", {}, None, queue.Queue(),
                   [gw_t._Attempt(a, hedge=False)])
    assert gw.hedge.counters()["hedges"] == 0
    assert b.outstanding == 0
    assert b.breaker.allow()  # the probe slot is free again
    b.breaker.record_success()
    assert b.breaker.state == "closed"


# ------------------------------------------------------------ readiness
class _FakeRegistry:
    def __init__(self, models=None, queue_cap=0, probe=None, faults=None):
        self._models = dict(models or {})
        self.queue_cap = queue_cap
        self.health_probe = probe
        self._faults = faults or {}

    def models(self):
        return dict(self._models)

    def device_faults(self):
        return dict(self._faults)


def test_readiness_verdict_matrix():
    assert readiness(_FakeRegistry())["reason"] == "no models loaded"
    assert readiness(_FakeRegistry({"m": {}}))["ok"]
    ev = threading.Event()
    ev.set()
    out = readiness(_FakeRegistry({"m": {}}), draining=ev)
    assert not out["ok"] and out["reason"] == "draining"
    out = readiness(_FakeRegistry({"m": {}}, faults={"m": "replay"}))
    assert not out["ok"] and out["reason"] == "device fault"
    depths = default_registry().snapshot().get(
        "lgbmtpu_serve_queue_depth") or {}
    base = int(max(depths.values(), default=0))
    record_queue_depth("gwtest_t", base + 5)
    try:
        out = readiness(_FakeRegistry({"m": {}}, queue_cap=base + 5))
        assert not out["ok"] and out["reason"] == "queue at admission cap"
    finally:
        record_queue_depth("gwtest_t", 0)
    out = readiness(_FakeRegistry({"m": {}},
                                  probe=lambda: {"healthy": False}))
    assert not out["ok"] and out["reason"] == "loop heartbeat stale"
    out = readiness(_FakeRegistry({"m": {}},
                                  probe=lambda: {"healthy": True}))
    assert out["ok"] and out["health"] == {"healthy": True}


# ---------------------------------------------- HTTP over two backends
@pytest.fixture(scope="module")
def model():
    rs = np.random.RandomState(7)
    X = rs.randn(300, 5).astype(np.float32)
    y = (X @ rs.randn(5)).astype(np.float32)
    p = {"objective": "regression", "verbosity": -1, "num_leaves": 15,
         "min_data_in_leaf": 5, "device_type": "cpu"}
    bst = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 5)
    return bst, X


class _Backend:
    def __init__(self, text):
        self.draining = threading.Event()
        self.registry = ModelRegistry(device="cpu", warmup=True,
                                      buckets=(16, 64))
        self.registry.load("default", text)
        self.httpd = serve_http(self.registry, 0, block=False,
                                draining=self.draining)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _post(url, op, body, timeout=30.0):
    req = urllib.request.Request(
        f"{url}/v1/{op}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _attempts():
    return {s.labels: s.value for s in default_registry().samples()
            if s.name in ("lgbmtpu_gateway_attempts_total",
                          "lgbmtpu_gateway_retries_total",
                          "lgbmtpu_gateway_hedges_total")}


@pytest.mark.chaos
def test_http_gateway_over_two_cpu_backends(model):
    bst, X = model
    text = bst.model_to_string()
    backs = [_Backend(text), _Backend(text)]
    gw = gw_t.Gateway([b.url for b in backs], retries=2,
                      backoff_base_s=0.01, hedge_default_delay_s=0.05,
                      hedge_budget=0.5, health_interval_s=60.0,
                      rng=random.Random(0))
    gw.start(wait_ready_s=10.0)
    httpd = gw_t.gateway_http(gw, 0, block=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    ref = bst.predict(X)
    failures = []

    def score(i):
        st, resp = _post(url, "score", {"rows": X[i:i + 1].tolist()})
        if st != 200 or not resp.get("ok"):
            failures.append((i, st, resp))
            return None
        return float(resp["pred"][0])

    try:
        assert _get(url, "/readyz")[0] == 200
        assert gw.status()["ready"] == 2
        got = [score(i) for i in range(40)]
        assert not failures
        np.testing.assert_allclose(got, ref[:40], rtol=1e-5, atol=1e-5)

        # backend 5xx: every second and third attempt raises at the
        # gw_backend_5xx site; the retries answer every client
        # (no hedge here: each fault fails one attempt, a retry answers)
        gw.hedge.budget_frac = 0.0
        before = _attempts()
        faultinject.arm(";".join(f"gw_backend_5xx:{k}:raise"
                                 for k in (2, 3, 7, 11)))
        got = [score(i) for i in range(40, 60)]
        faultinject.disarm()
        gw.hedge.budget_frac = 0.5
        after = _attempts()
        retries = after.get((), 0.0) - before.get((), 0.0)
        errors = sum(v - before.get(k, 0.0) for k, v in after.items()
                     if ("result", "error") in k)
        assert not failures and errors == 4 and retries == 4
        np.testing.assert_allclose(got, ref[40:60], rtol=1e-5, atol=1e-5)

        # a slow backend: the first attempt stalls 1 s, a hedge on the
        # other backend answers within the budget
        hedges = lambda o: _attempts().get((("outcome", o),), 0.0)  # noqa: E731
        fired, won = hedges("fired"), hedges("won")
        faultinject.arm("gw_slow_backend:1:delay:1.0")
        t0 = time.perf_counter()
        got = score(61)
        dt = time.perf_counter() - t0
        faultinject.disarm()
        assert not failures and abs(got - ref[61]) < 1e-5
        assert hedges("fired") == fired + 1 and hedges("won") == won + 1
        assert dt < 0.9
        assert gw.hedge.counters()["hedges"] >= 1
        # the cancelled loser ends once its stall does
        t0 = time.perf_counter()
        while any(r["outstanding"] for r in gw.pool.snapshot()):
            assert time.perf_counter() - t0 < 10.0
            time.sleep(0.05)

        # a backend's drain: its /readyz turns 503, the pool drops it,
        # and traffic moves to the other with no failure
        backs[0].draining.set()
        assert _get(backs[0].url, "/readyz")[0] == 503
        assert gw.check_now() == (2, 1)
        name0 = gw.pool.backends[0].name
        sent0 = lambda: sum(v for k, v in _attempts().items()  # noqa: E731
                            if ("backend", name0) in k)
        before0 = sent0()
        got = [score(i) for i in range(62, 82)]
        assert not failures and sent0() == before0
        np.testing.assert_allclose(got, ref[62:82], rtol=1e-5, atol=1e-5)

        # the merged pane: the gateway's series and both backends'
        st, metrics = _get(url, "/metrics")
        assert st == 200 and "lgbmtpu_gateway_requests_total" in metrics
        assert "lgbmtpu_serve_protocol_requests_total" in metrics
        merged = gw.merged_metrics()
        assert merged["processes"] == 3

        # the gateway's own drain: readyz 503, new work shed
        assert gw.drain(timeout_s=5.0)
        assert _get(url, "/readyz")[0] == 503
        st, resp = _post(url, "score", {"rows": X[:1].tolist()})
        assert st == 503 and resp["error_kind"] == "shutdown"
    finally:
        faultinject.disarm()
        gw.stop()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        for b in backs:
            b.close()
