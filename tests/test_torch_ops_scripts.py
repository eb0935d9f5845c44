"""The port's operations scripts (lightgbm_tpu_torch/tools/: serve_smoke,
gateway_rolling, chaos, obs_report and their process helpers _procs).

- obs_report against the JAX package's tools/obs_report.py (loaded by
  path): the same snapshot files, recorder streams and run manifest
  render to the same text;
- each script answers --help as a module, and without a card (and
  without --device cpu) refuses, naming the card;
- gateway_rolling.roll driven over two in-process serve_http backends on
  CPU registries behind an in-process gateway: each backend drained (its
  draining event), closed, restarted on the same port and re-registered
  under a running client, with 0 client failures; the HTTP servers
  allow reusing an address, which such a restart needs;
- gateway_rolling.breaker_of reading a gateway's exposition;
- each script's whole --device cpu run as child processes (slow, chaos).
"""

import importlib.util
import json
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.obs import aggregate
from lightgbm_tpu_torch.obs.manifest import write_manifest
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from lightgbm_tpu_torch.serving import ModelRegistry, serve_http
from lightgbm_tpu_torch.serving import gateway as gw_t
from lightgbm_tpu_torch.tools import (_procs, chaos, gateway_rolling,
                                      obs_report, serve_smoke)
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {"serve_smoke": serve_smoke, "gateway_rolling": gateway_rolling,
           "chaos": chaos, "obs_report": obs_report}


# ------------------------------------------------------------ obs_report
def _jax_obs_report():
    spec = importlib.util.spec_from_file_location(
        "jax_obs_report", REPO / "tools" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshots(d: Path):
    """Two processes' snapshots: a counter, a gauge apart (a spread), a
    labelled counter and a histogram."""
    for rank, (n, g) in enumerate(((3, 0.5), (4, 1.75))):
        r = MetricsRegistry(enabled=True)
        r.counter("lgbmtpu_probe_total", "probe").inc(n)
        r.gauge("lgbmtpu_probe_gauge", "gauge").set(g)
        r.counter("lgbmtpu_probe_ops_total", "ops", labels=("op",)).inc(
            rank + 1, op="score")
        r.histogram("lgbmtpu_probe_seconds", "latency").observe(0.01 * n)
        aggregate.write_snapshot(str(d / f"metrics_rank{rank:05d}.json"), r,
                                 process=rank)
    return ["--snapshots", str(d / "metrics_rank*.json")]


_CORE = {"objective": "binary", "metric": "auc", "num_leaves": 7,
         "min_data_in_leaf": 5, "verbosity": -1, "device_type": "cpu"}


def _recorded_run(path: Path, seed: int):
    rs = np.random.RandomState(seed)
    X = rs.randn(300, 4)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    p = {**_CORE, "seed": seed, "record_file": str(path)}
    ds = lgb_t.Dataset(X, label=y, params=p)
    return lgb_t.train(p, ds, 4, valid_sets=[ds], valid_names=["tr"]), p


def _recorders(d: Path):
    """Two flight-record streams of runs whose evals differ."""
    for seed in (1, 2):
        _recorded_run(d / f"run{seed}.jsonl", seed)
    return ["--recorder", str(d / "run1.jsonl"), str(d / "run2.jsonl")]


def _manifest(d: Path):
    """The run manifest of a recorded run (its flight-record summary)."""
    _, p = _recorded_run(d / "run.jsonl", 3)
    write_manifest(str(d / "manifest.json"), config=p)
    return ["--manifest", str(d / "manifest.json")]


@pytest.mark.parametrize("make", [_snapshots, _recorders, _manifest],
                         ids=["snapshots", "recorder", "manifest"])
def test_obs_report_renders_as_jax(tmp_path, capsys, make):
    args = make(tmp_path)
    assert _jax_obs_report().main(args) == 0
    want = capsys.readouterr().out
    assert obs_report.main(["--device", "cpu", *args]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("==")


def test_obs_report_all_inputs_as_jax(tmp_path, capsys):
    args = _snapshots(tmp_path) + _recorders(tmp_path) + _manifest(tmp_path)
    assert _jax_obs_report().main(args) == 0
    want = capsys.readouterr().out
    assert obs_report.main(["--device", "cpu", *args]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "[min 0.5 / max 1.75]" in got and "eval disagreement" in got


# --------------------------------------------------- the scripts' doors
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_help_as_module(name):
    p = subprocess.run([sys.executable, "-m",
                        f"lightgbm_tpu_torch.tools.{name}", "--help"],
                       cwd=str(REPO), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert "--device" in p.stdout


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_refuses_without_card(monkeypatch, name):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        SCRIPTS[name].main([])
    assert "CUDA card" in str(e.value.code) and "--device cpu" in str(
        e.value.code)


# ------------------------------------------------- the roll, in process
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
    """A serve_http backend on a CPU registry in this process; stop() is
    what task=serve's SIGTERM does (draining set, the listener shut and
    closed), start() a restart on the same port."""

    def __init__(self, text):
        self.registry = ModelRegistry(device="cpu", warmup=True,
                                      buckets=(16, 64))
        self.registry.load("default", text)
        self.port = 0
        self.start()

    def start(self):
        self.draining = threading.Event()
        self.httpd = serve_http(self.registry, self.port, block=False,
                                draining=self.draining)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.port}"

    def stop(self):
        self.draining.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        return 0 if not self.thread.is_alive() else 1


def test_roll_in_process_zero_failures(model):
    bst, X = model
    text = bst.model_to_string()
    backs = [_Backend(text), _Backend(text)]
    assert all(b.httpd.allow_reuse_address for b in backs)
    ports = [b.port for b in backs]
    gw = gw_t.Gateway([b.url for b in backs], retries=3,
                      backoff_base_s=0.01, breaker_failures=1,
                      breaker_cooldown_s=0.2, health_interval_s=0.05,
                      rng=random.Random(0))
    gw.start(wait_ready_s=10.0)
    front = gw_t.gateway_http(gw, 0, block=False)
    assert front.allow_reuse_address
    ft = threading.Thread(target=front.serve_forever, daemon=True)
    ft.start()
    url = f"http://127.0.0.1:{front.server_address[1]}"
    ref = bst.predict(X, raw_score=True)

    names = [f"127.0.0.1:{p}" for p in ports]
    ok_before = {}

    def ok_attempts(i):
        return gateway_rolling.attempts_of(
            default_registry().render_prometheus(), names[i]).get("ok", 0)

    def start(i):
        ok_before[i] = ok_attempts(i)  # the backend is down: no answers
        backs[i].start()

    def settle(i):
        # an answer since the restart (the pool saw it go and come back),
        # then ready with its breaker closed
        t0 = time.monotonic()
        while not (ok_attempts(i) > ok_before[i] and gateway_rolling.routed(
                gw.status()["backends"][i])):
            assert time.monotonic() - t0 < 10.0, gw.status()
            time.sleep(0.02)

    try:
        out = gateway_rolling.roll(
            [(b.stop, lambda i=i: start(i)) for i, b in enumerate(backs)],
            gateway_rolling.LoadClient(url, X, ref, threads=3), settle)
        assert out["failures"] == 0, out["failure_samples"]
        assert out["rolled"] == 2 and out["exit_codes"] == [0, 0]
        assert out["requests"] > 20 and out["max_abs_vs_host"] <= 1e-5
        assert [b.port for b in backs] == ports  # the same ports
        for i in range(2):  # each restarted backend answers again
            st, resp = _procs.post(backs[i].url, "score",
                                   {"rows": X[:2].tolist()})
            assert st == 200 and resp["ok"]
        # the gateway's pane: its own series and both backends' (one
        # registry in this process, so merged_processes, which tells
        # processes apart by their counters, is held by the process runs)
        assert gw.merged_metrics()["processes"] == 3
        text = _procs.get(url, "/metrics")[1]
        for b in backs:
            br = gateway_rolling.breaker_of(text, f"127.0.0.1:{b.port}")
            assert br["state"] == "closed"
    finally:
        gw.stop()
        front.shutdown()
        front.server_close()
        ft.join(timeout=10)
        for b in backs:
            if b.thread.is_alive():
                b.stop()


def test_breaker_of_reads_the_exposition():
    r = MetricsRegistry(enabled=True)
    g = r.gauge("lgbmtpu_gateway_breaker_state", "s", labels=("backend",))
    c = r.counter("lgbmtpu_gateway_breaker_transitions_total", "t",
                  labels=("backend", "to"))
    for to in ("open", "half_open", "open", "half_open", "closed"):
        c.inc(1, backend="h:1", to=to)
    g.set(0, backend="h:1")
    g.set(2, backend="h:2")
    c.inc(1, backend="h:2", to="open")
    text = r.render_prometheus()
    assert gateway_rolling.breaker_of(text, "h:1") == {
        "state": "closed",
        "transitions": {"open": 2, "half_open": 2, "closed": 1}}
    assert gateway_rolling.breaker_of(text, "h:2") == {
        "state": "open", "transitions": {"open": 1}}
    assert gateway_rolling.breaker_of(text, "h:3") == {
        "state": "closed", "transitions": {}}


# ------------------------------------------------- whole runs, processes
def _run(args, timeout):
    p = subprocess.run([sys.executable, "-m", *args], cwd=str(REPO),
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout


@pytest.mark.slow
@pytest.mark.chaos
def test_serve_smoke_script_cpu(tmp_path):
    out = _run(["lightgbm_tpu_torch.tools.serve_smoke", "--device", "cpu",
                "--work", str(tmp_path / "w")], 900)
    lines = out.strip().splitlines()
    assert lines[-1] == "serve_smoke: OK"
    nums = json.loads(lines[-2])
    assert nums["stdio"]["max_abs_vs_host"] < 1e-5
    assert nums["fleet"]["resident"] <= 12 and nums["loop"][
        "promoted_version"] == 1


@pytest.mark.slow
@pytest.mark.chaos
def test_gateway_rolling_script_cpu(tmp_path):
    out = _run(["lightgbm_tpu_torch.tools.gateway_rolling", "--device",
                "cpu", "--backends", "2", "--work", str(tmp_path / "w")],
               900)
    lines = out.strip().splitlines()
    assert lines[-1].startswith("gateway_rolling: OK")
    nums = json.loads(lines[-2])
    assert nums["roll"]["failures"] == 0 and nums["kill9"]["failures"] == 0
    assert nums["merged_processes"] == 3
    assert nums["drain"]["exit_code"] == 0


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_script_cpu():
    # one in-process case: the runner itself is a chaos case, so it
    # selects a narrow set rather than the whole matrix again
    out = _run(["lightgbm_tpu_torch.tools.chaos", "--device", "cpu",
                "tests/test_torch_ops_chaos.py", "-k",
                "gateway_drain_waits_for_inflight"], 600)
    assert "1 passed" in out


@pytest.mark.slow
@pytest.mark.chaos
def test_obs_report_script_cpu(tmp_path, model):
    """The tool as a module over a live /metrics pull and snapshots."""
    bst, X = model
    reg = ModelRegistry(device="cpu", warmup=False)
    reg.load("default", bst.model_to_string())
    httpd = serve_http(reg, 0, block=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        st, _ = _procs.post(url, "score", {"rows": X[:2].tolist()})
        assert st == 200
        out = _run(["lightgbm_tpu_torch.tools.obs_report", "--device",
                    "cpu", "--url", url, *_snapshots(tmp_path)], 300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    assert out.startswith("== fleet metrics (3 process(es)) ==")
    assert "lgbmtpu_serve_protocol_requests_total" in out
