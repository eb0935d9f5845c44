"""The chaos matrix of the port's serving gateway and online loop across
real processes: the JAX package's tests of it (tests/test_gateway.py
hedge, gateway drain, kill -9 and backend SIGTERM drain;
tests/test_online.py's SIGKILL'd task=loop) with the same assertions,
on the port. The models and the loop's v0 are trained by the JAX
package on the JAX tests' inputs; every server and command line runs on
the CPU (device_type=cpu). Cases that spawn processes are also marked
slow; run the whole matrix with ``python3 -m
lightgbm_tpu_torch.tools.chaos --device cpu``.
"""

import json
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.online import load_state, state_path
from lightgbm_tpu_torch.resilience import faultinject
from lightgbm_tpu_torch.resilience.errors import CheckpointError
from lightgbm_tpu_torch.serving import Gateway, ModelRegistry, serve_http
from lightgbm_tpu_torch.tools import _procs
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


@pytest.fixture(autouse=True)
def _disarm_fault_plan():
    """Chaos tests arm process-global fault plans; none may leak."""
    yield
    faultinject.disarm()


@pytest.fixture(scope="module")
def model_and_data(tmp_path_factory):
    """tests/test_gateway.py's model, trained by the JAX package."""
    rs = np.random.RandomState(7)
    X = rs.randn(200, 5).astype(np.float32)
    y = (X @ rs.randn(5)).astype(np.float32)
    bst = lgb_j.train(
        {"objective": "regression", "verbosity": -1,
         "min_data_in_leaf": 5, "num_leaves": 15},
        lgb_j.Dataset(X, label=y, free_raw_data=False),
        num_boost_round=5,
    )
    path = tmp_path_factory.mktemp("gwmodel") / "model.txt"
    bst.save_model(str(path))
    return str(path), X


class _InProcBackend:
    """A real serve_http backend inside the test process."""

    def __init__(self, model_path: str):
        self.registry = ModelRegistry(warmup=False, device="cpu")
        self.registry.load("default", model_path)
        self.httpd = serve_http(self.registry, 0, block=False)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        host, port = self.httpd.server_address[:2]
        self.url = f"http://{host}:{port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _post(url, op, body, timeout=30.0):
    st, resp = _procs.post(url, op, body, timeout=timeout)
    return st, resp


# ------------------------------------------------ in-process gateway
@pytest.mark.chaos
def test_hedge_overtakes_stalled_attempt(model_and_data):
    """gw_slow_backend stalls the primary attempt; the hedge fires at
    the (default) trigger delay on the other backend and wins long
    before the stall clears."""
    model_path, X = model_and_data
    backends = [_InProcBackend(model_path), _InProcBackend(model_path)]
    gw = Gateway([b.url for b in backends], retries=2,
                 backoff_base_s=0.01, health_interval_s=0.2,
                 hedge_budget=1.0, hedge_default_delay_s=0.05,
                 attempt_timeout_s=20.0)
    try:
        gw.start(wait_ready_s=10.0)
        # warm BOTH backends (the first score builds the forest)
        for b in backends:
            st, _ = _post(b.url, "score", {"rows": X[:2].tolist()})
            assert st == 200
        faultinject.arm("gw_slow_backend:1:delay:3.0")
        t0 = time.monotonic()
        st, resp = gw.handle("score", {"rows": X[:2].tolist(),
                                       "deadline_ms": 15000})
        dt = time.monotonic() - t0
        assert st == 200 and resp["ok"], resp
        assert dt < 2.0, f"hedge did not overtake the stall ({dt:.2f}s)"
        assert gw.hedge.counters()["hedges"] >= 1
    finally:
        faultinject.disarm()
        gw.stop()
        for b in backends:
            b.close()


@pytest.mark.chaos
def test_gateway_drain_waits_for_inflight(model_and_data):
    """SIGTERM semantics without the signal: begin_drain sheds new
    work immediately while drain() blocks until the stalled in-flight
    request finishes — then the gateway is idle."""
    model_path, X = model_and_data
    backend = _InProcBackend(model_path)
    gw = Gateway([backend.url], retries=0, health_interval_s=0.2,
                 hedge_budget=0.0, attempt_timeout_s=20.0)
    try:
        gw.start(wait_ready_s=10.0)
        st, _ = gw.handle("score", {"rows": X[:2].tolist()})
        assert st == 200
        faultinject.arm("gw_slow_backend:1:delay:1.0")
        done = {}

        def call():
            done["r"] = gw.handle("score", {"rows": X[:2].tolist()})

        th = threading.Thread(target=call, daemon=True)
        th.start()
        deadline = time.monotonic() + 5.0
        while gw.inflight() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert gw.inflight() == 1
        t0 = time.monotonic()
        assert gw.drain(timeout_s=15.0)
        waited = time.monotonic() - t0
        assert gw.inflight() == 0
        th.join(timeout=10)
        assert done["r"][0] == 200  # the in-flight request finished
        assert waited > 0.2  # drain actually waited for it
        st, resp = gw.handle("score", {"rows": X[:2].tolist()})
        assert st == 503 and resp["error_kind"] == "shutdown"
    finally:
        faultinject.disarm()
        gw.stop()
        backend.close()


# --------------------------------------------- subprocess backends
def _spawn_serve(model_path, port, tmp_path, extra=None):
    return _procs.spawn("serve", {
        "input_model": model_path, "serve_port": port,
        "serve_warmup": "false", "verbosity": -1, **(extra or {})},
        "cpu", Path(tmp_path) / f"serve{port}.{time.monotonic_ns()}.log",
        name=f"backend :{port}")


@pytest.mark.slow
@pytest.mark.chaos
def test_kill9_backend_zero_client_failures(model_and_data, tmp_path):
    """kill -9 one of two real backend processes under concurrent client
    load: no client sees a failure (retry and exclusion absorb it), the
    victim's breaker opens, and after a restart on the same port the
    breaker recovers through half_open back to closed on real
    traffic."""
    model_path, X = model_and_data
    ports = [_procs.free_port(), _procs.free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    procs = [_spawn_serve(model_path, p, tmp_path) for p in ports]
    gw = None
    stop = threading.Event()
    threads = []
    try:
        for u, p in zip(urls, procs):
            _procs.wait_ready(u, p)
        gw = Gateway(urls, retries=3, backoff_base_s=0.02,
                     backoff_cap_s=0.2, breaker_failures=1,
                     breaker_cooldown_s=0.4, health_interval_s=0.5,
                     hedge_budget=0.2, attempt_timeout_s=15.0)
        transitions = []
        orig = gw._on_breaker
        gw._on_breaker = lambda name, old, new: (
            transitions.append((name, old, new)), orig(name, old, new))
        gw.start(wait_ready_s=15.0)
        assert gw.pool.counts()[1] == 2

        rows = X[:3].tolist()
        # warm each backend directly: its first score must not eat into
        # the chaos phase's deadlines
        for u in urls:
            st, _ = _post(u, "score", {"rows": rows}, timeout=300)
            assert st == 200
        failures = []
        flock = threading.Lock()

        def client():
            while not stop.is_set():
                st, resp = gw.handle(
                    "score", {"rows": rows, "deadline_ms": 30000})
                if st != 200:
                    with flock:
                        failures.append((st, resp))

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(1.0)  # traffic flowing through both backends

        procs[0].signal(signal.SIGKILL)
        procs[0].wait(timeout=30)
        assert procs[0].proc.returncode == -9
        time.sleep(2.0)  # keep hammering the survivor
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert failures == [], failures[:3]

        victim = gw.pool.backends[0]
        victim_name = victim.name
        # the raced / refused attempts tripped the breaker (failures=1),
        # and / or the health loop pulled the backend from the pool
        assert victim.breaker.state != "closed" or not victim.ready

        # restart on the same port; the health loop re-readies it and
        # real traffic walks the breaker open -> half_open -> closed
        procs[0] = _spawn_serve(model_path, ports[0], tmp_path)
        _procs.wait_ready(urls[0], procs[0])
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            st, resp = gw.handle(
                "score", {"rows": rows, "deadline_ms": 30000})
            assert st == 200, resp
            if victim.ready and victim.breaker.state == "closed":
                break
            time.sleep(0.05)
        assert victim.breaker.state == "closed"
        mine = [(o, n) for (b, o, n) in transitions if b == victim_name]
        assert ("closed", "open") in mine
        assert ("open", "half_open") in mine
        assert ("half_open", "closed") in mine
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        if gw is not None:
            gw.stop()
        _procs.terminate_all(procs)


@pytest.mark.slow
@pytest.mark.chaos
def test_backend_sigterm_drain_finishes_inflight(model_and_data, tmp_path):
    """SIGTERM to a real task=serve backend while a request is stalled
    in flight: the request still completes (server_close joins handler
    threads) and the process exits 0 — the backend half of the rolling
    restart."""
    model_path, X = model_and_data
    port = _procs.free_port()
    url = f"http://127.0.0.1:{port}"
    # hit 1 = the warm request; hit 2 = the stalled in-flight request
    # (/readyz and /healthz probes do not consume fault-plan hits)
    proc = _spawn_serve(model_path, port, tmp_path,
                        {"fault_plan": "serve_request:2:delay:1.5"})
    try:
        _procs.wait_ready(url, proc)
        st, _ = _post(url, "score", {"rows": X[:2].tolist()}, timeout=120)
        assert st == 200

        result = {}

        def slow_call():
            try:
                result["resp"] = _post(url, "score",
                                       {"rows": X[:2].tolist()},
                                       timeout=60)
            except Exception as e:  # noqa: BLE001 — reported below
                result["error"] = repr(e)

        th = threading.Thread(target=slow_call, daemon=True)
        th.start()
        time.sleep(0.5)  # the request is in flight, stalled at the fault
        proc.signal(signal.SIGTERM)
        th.join(timeout=60)
        assert "error" not in result, result
        st, resp = result["resp"]
        assert st == 200 and resp["ok"]
        assert proc.wait(timeout=60) == 0, proc.tail()  # clean exit
    finally:
        _procs.terminate_all([proc])


# ------------------------------------------ SIGKILL'd task=loop process
def _xy(seed: int, n: int):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 4)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    return X, y


def _batch(seed: int, n: int = 40):
    X, y = _xy(seed, n)
    return X.tolist(), y.tolist()


_CORE = {"objective": "binary", "metric": "auc", "num_leaves": 7,
         "min_data_in_leaf": 5, "learning_rate": 0.2, "verbosity": -1,
         "seed": 7}


@pytest.fixture(scope="module")
def loop_v0():
    """tests/test_online.py's v0, trained by the JAX package."""
    X, y = _xy(5, 300)
    return lgb_j.train(dict(_CORE), lgb_j.Dataset(X, label=y,
                                                  free_raw_data=False),
                       num_boost_round=6).model_to_string()


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("site", ["loop_ingest", "loop_refit",
                                  "loop_eval", "loop_promote"])
def test_sigkill_cli_loop_restart(tmp_path, loop_v0, site):
    """Per loop phase: a task=loop process SIGKILLed by the fault plan
    <site>:0:kill (no cleanup, no flush) restarts with the last promoted
    version serving, replays the spooled microbatches, and promotes v1,
    scored through the restarted process's own transport."""
    import subprocess

    (tmp_path / "model.txt").write_text(loop_v0)
    HX, Hy = _xy(9, 200)
    np.savetxt(tmp_path / "holdout.csv", np.column_stack([Hy, HX]),
               delimiter=",", fmt="%.8g")
    loop_dir = str(tmp_path / "loop")
    params = {
        "input_model": tmp_path / "model.txt",
        "valid_data": tmp_path / "holdout.csv",
        "objective": "binary", "metric": "auc", "num_leaves": 7,
        "min_data_in_leaf": 5, "learning_rate": 0.2, "seed": 7,
        "loop_dir": loop_dir, "loop_min_rows": 64, "loop_rounds": 4,
        # v0 nearly saturates this holdout (auc ~0.987): allow the usual
        # tiny refit jitter or the near-tie gate rejects forever
        "loop_gate_margin": 0.02, "loop_poll_s": 0.1, "verbosity": -1,
    }
    ingest_lines = "".join(
        json.dumps({"op": "ingest", "rows": r, "labels": lab}) + "\n"
        for r, lab in (_batch(61, 40), _batch(62, 40)))

    # phase 1: arm the kill, feed the spool, watch the process die -9
    proc = _procs.spawn("loop", {**params, "fault_plan": f"{site}:0:kill"},
                        "cpu", tmp_path / "killed.log",
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        try:
            proc.proc.stdin.write(ingest_lines)
            proc.proc.stdin.flush()
        except BrokenPipeError:
            pass  # loop_ingest kills on the first poll, before any ingest
        proc.wait(timeout=300)
    finally:
        _procs.terminate_all([proc])
    assert proc.proc.returncode == -9, (site, proc.tail())

    # the kill left the durable floor intact: v0 promoted, offset 0
    st = load_state(state_path(loop_dir))
    assert st["version"] == 0 and st["ingest_offset"] == 0, site
    assert Path(st["model_path"]).exists()

    # phase 2: restart WITHOUT the plan; replay / ingest, await the
    # promotion in the durable state, then score through the server
    proc = _procs.spawn("loop", params, "cpu", tmp_path / "restart.log",
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        proc.proc.stdin.write(ingest_lines)
        proc.proc.stdin.flush()
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise proc.exited("restart died")
            try:
                if load_state(state_path(loop_dir))["version"] >= 1:
                    break
            except CheckpointError:
                pass
            time.sleep(0.2)
        else:
            raise AssertionError(f"{site}: restart never promoted v1")
        probe = HX[:8]
        proc.proc.stdin.write(json.dumps(
            {"op": "score", "model": "default",
             "rows": probe.tolist()}) + "\n")
        proc.proc.stdin.write(json.dumps({"op": "quit"}) + "\n")
        proc.proc.stdin.flush()
        out, _ = proc.proc.communicate(timeout=300)
    finally:
        _procs.terminate_all([proc])
    assert proc.proc.returncode == 0, proc.tail()
    resp = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    scored = next(r for r in resp if "pred" in r)
    st = load_state(state_path(loop_dir))
    assert st["version"] == 1 and st["counts"]["promoted"] == 1
    v1 = lgb_t.Booster(model_file=st["model_path"])
    np.testing.assert_allclose(np.asarray(scored["pred"]),
                               v1.predict(probe), rtol=1e-5, atol=1e-6)
