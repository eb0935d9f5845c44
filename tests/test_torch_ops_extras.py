"""The port's retry / backoff, heartbeat and metric-aggregation modules
(lightgbm_tpu_torch/resilience/backoff.py, heartbeat.py,
obs/aggregate.py) against the JAX package's on the same inputs; the
online loop's and the gateway's metric recorders under the JAX
package's series names; tpu_debug_check_split (LightGBM's CheckSplit) on
the eager loop; and the concurrency lint over the whole port."""

import json
import shutil
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.obs import aggregate as agg_j
from lightgbm_tpu.obs import metrics as met_j
from lightgbm_tpu.resilience import backoff as bo_j
from lightgbm_tpu.resilience import heartbeat as hb_j
from lightgbm_tpu_torch.obs import aggregate as agg_t
from lightgbm_tpu_torch.obs import metrics as met_t
from lightgbm_tpu_torch.resilience import backoff as bo_t
from lightgbm_tpu_torch.resilience import heartbeat as hb_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


# ---------------------------------------------------------------- backoff
@pytest.mark.parametrize("base,cap", [(0.5, 120.0), (10.0, 120.0),
                                      (0.05, 1.0), (1.0, 3.0)])
def test_backoff_schedules_match(base, cap):
    for a in range(1, 12):
        assert bo_t.backoff_delay(a, base, cap) == \
            bo_j.backoff_delay(a, base, cap)
    assert list(bo_t.delays(6, base, cap)) == list(bo_j.delays(6, base, cap))
    import random

    rj, rt = random.Random(5), random.Random(5)
    for a in range(1, 9):
        assert bo_t.full_jitter_delay(a, base, cap, rand=rt.random) == \
            bo_j.full_jitter_delay(a, base, cap, rand=rj.random)
    for mod in (bo_t, bo_j):
        with pytest.raises(ValueError):
            mod.backoff_delay(0)


def _flaky(fails, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc
        return len(calls)

    return fn, calls


@pytest.mark.parametrize("fails,retries,pred", [
    (0, 3, None), (2, 3, None), (3, 3, None), (4, 3, None),
    (1, 3, "no_http")])
def test_retry_call_matches(fails, retries, pred):
    """The same attempts, sleeps, retry callbacks and outcome."""
    def run(mod, exc):
        fn, calls = _flaky(fails, exc)
        slept, seen = [], []
        retriable = (None if pred is None else
                     (lambda e: not isinstance(e, urllib.error.HTTPError)))
        try:
            out = mod.retry_call(fn, retries=retries, base_s=0.5,
                                 retry_on=(OSError,), retriable=retriable,
                                 on_retry=lambda a, d, e: seen.append((a, d)),
                                 sleep=slept.append)
        except OSError as e:
            out = type(e).__name__
        return out, len(calls), slept, seen

    exc = (urllib.error.HTTPError("u", 404, "nf", {}, None)
           if pred else ConnectionRefusedError("down"))
    assert run(bo_t, exc) == run(bo_j, exc)


# -------------------------------------------------------------- heartbeat
def test_heartbeat_files_and_reports_match(tmp_path):
    """A port writer's files read back by both packages' readers, and
    the alive / stale / missing verdicts of both reports at fixed
    clocks."""
    d = tmp_path / "hb"
    w0 = hb_t.HeartbeatWriter(str(d), rank=0, interval_s=0.05).start()
    w2 = hb_j.HeartbeatWriter(str(d), rank=2, interval_s=0.05).start()
    time.sleep(0.2)
    w2.stop()
    # w0 still beats every 0.05 s: both packages read one frozen copy
    # of the two beat files (each beat lands whole through os.replace,
    # so a copied file is a beat the live directory held).
    frozen = tmp_path / "hb_frozen"
    frozen.mkdir()
    for rank in (0, 2):
        shutil.copy(hb_t.heartbeat_path(str(d), rank), frozen)
    beats_t = hb_t.read_heartbeats(str(frozen))
    beats_j = hb_j.read_heartbeats(str(frozen))
    assert beats_t == beats_j and sorted(beats_t) == [0, 2]
    assert beats_t[0]["seq"] >= 2 and beats_t[2]["final"]
    assert hb_t.heartbeat_path(str(d), 7) == hb_j.heartbeat_path(str(d), 7)
    (frozen / "heartbeat_rank00009.json").write_text("{torn")
    t = beats_t[0]["t_unix"]
    for now in (t, t + 5.0, t + 31.0):
        rt = hb_t.health_report(str(frozen), expected=4, stale_after_s=30.0,
                                now=now)
        rj = hb_j.health_report(str(frozen), expected=4, stale_after_s=30.0,
                                now=now)
        assert rt == rj
    assert rt["stale"] == [0] and rt["alive"] == [2] and \
        rt["missing"] == [1, 3] and not rt["healthy"]
    w0.stop()
    assert hb_t.read_heartbeats(str(d))[0]["final"]


# -------------------------------------------------------------- aggregate
def _fill(mod, scale):
    reg = mod.MetricsRegistry()
    reg.counter("lgbmtpu_x_total", "x", labels=("op",)).inc(3 * scale,
                                                            op="score")
    reg.counter("lgbmtpu_x_total", "x", labels=("op",)).inc(scale, op="load")
    reg.gauge("lgbmtpu_rate", "rate").set(1.5 * scale)
    h = reg.histogram("lgbmtpu_lat_seconds", "lat", labels=("op",))
    for v in (0.0007, 0.02 * scale, 0.3):
        h.observe(v, op="score")
    return reg


def test_snapshots_merge_and_render_match(tmp_path):
    snaps_t = [agg_t.snapshot_dict(_fill(met_t, s), process=i)
               for i, s in enumerate((1, 2, 5))]
    snaps_j = [agg_j.snapshot_dict(_fill(met_j, s), process=i)
               for i, s in enumerate((1, 2, 5))]
    assert snaps_t == snaps_j
    merged = agg_t.merge(snaps_t)
    assert merged == agg_j.merge(snaps_j)
    assert merged["metrics"]["lgbmtpu_x_total"]["values"][
        '{op="score"}'] == 24.0
    assert merged["metrics"]["lgbmtpu_rate"]["min"][""] == 1.5
    assert agg_t.render_merged(merged) == agg_j.render_merged(merged)
    paths = []
    for i, s in enumerate((1, 3)):
        p = tmp_path / f"s{i}.json"
        agg_t.write_snapshot(str(p), _fill(met_t, s), process=i)
        paths.append(str(p))
    assert agg_t.merge_files(paths) == agg_j.merge_files(paths)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    for mod in (agg_t, agg_j):
        with pytest.raises(ValueError):
            mod.read_snapshot(str(bad))


def test_parse_prometheus_matches():
    """Both packages' exposition of the same series parse to the same
    snapshot, and the port parses the JAX package's exposition as its
    own."""
    text_t = _fill(met_t, 2).render_prometheus()
    text_j = _fill(met_j, 2).render_prometheus()
    assert agg_t.parse_prometheus(text_t, 3) == \
        agg_j.parse_prometheus(text_t, 3)
    assert agg_t.parse_prometheus(text_j) == agg_j.parse_prometheus(text_j)
    assert agg_t.parse_prometheus(text_t) == agg_t.parse_prometheus(text_j)
    for mod in (agg_t, agg_j):
        with pytest.raises(ValueError):
            mod.parse_prometheus("not a sample line at all {")


def test_pull_snapshot_over_http():
    """pull_snapshot scrapes a live /metrics (the route appended), and an
    HTTP error status is not retried."""
    body = _fill(met_t, 1).render_prometheus().encode()
    hits = []

    class H(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            hits.append(self.path)
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        snap = agg_t.pull_snapshot(base, process=4)
        assert snap == agg_j.pull_snapshot(base + "/metrics", process=4)
        assert snap["process"] == 4
        n = len(hits)
        with pytest.raises(urllib.error.HTTPError):
            agg_t.pull_snapshot(base + "/nope/metrics", retries=3)
        assert len(hits) == n + 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=5)


def test_merge_recorder_streams_matches():
    rs = np.random.RandomState(3)
    streams = []
    for p in range(3):
        recs = []
        for r in range(5):
            rec = {"round": r, "trees_per_sec": float(rs.rand() * 10),
                   "phases": {"grow": float(rs.rand()),
                              "eval": float(rs.rand())},
                   "evals": {"valid auc": 0.8 + 0.01 * r}}
            if p == 2 and r == 3:
                rec["evals"] = {"valid auc": 0.5}
            recs.append(rec)
        streams.append(recs)
    rows = agg_t.merge_recorder_streams(streams)
    assert rows == agg_j.merge_recorder_streams(streams)
    assert rows[3]["evals_disagree"] == ["valid auc"]
    assert "evals_disagree" not in rows[2]


# ------------------------------------------------------------- recorders
def _series(reg):
    return {(s.name, s.labels, s.kind): s.value for s in reg.samples()}


def _record_all(mod):
    mod.record_promotion_event("promoted")
    mod.record_promotion_event("rejected")
    mod.record_ingest(64)
    mod.record_loop_progress(3, 5, 4096)
    mod.record_gateway_request("score", "ok", 0.003)
    mod.record_gateway_attempt("127.0.0.1:1", "5xx")
    mod.record_gateway_retry()
    mod.record_gateway_hedge("fired")
    mod.record_gateway_breaker("127.0.0.1:1", "open")
    mod.record_gateway_pool(2, 1, 2)


def test_loop_and_gateway_recorders_match():
    """The online loop's and the gateway's recorders write the JAX
    package's series (names, kinds, labels, values), measured as the
    difference each makes to its default registry."""
    before_t = _series(met_t.default_registry())
    before_j = _series(met_j.default_registry())
    _record_all(met_t)
    _record_all(met_j)

    def delta(after, before):
        return {k: v - before.get(k, 0.0) for k, v in after.items()
                if k[0].startswith(("lgbmtpu_promotion", "lgbmtpu_ingest",
                                    "lgbmtpu_online", "lgbmtpu_gateway"))
                and (v != before.get(k, 0.0) or k[2] == "gauge")}

    dt = delta(_series(met_t.default_registry()), before_t)
    dj = delta(_series(met_j.default_registry()), before_j)
    assert set(dt) == set(dj) and len(dt) > 10
    for k in dt:
        if k[2] == "gauge":  # a gauge's delta depends on its last value
            continue
        assert dt[k] == pytest.approx(dj[k]), k


# --------------------------------------------------- tpu_debug_check_split
def _check_split_data():
    rs = np.random.RandomState(4)
    X = rs.randn(600, 6)
    return X, ((X[:, 0] + X[:, 1]) > 0).astype(float)


@pytest.mark.parametrize("extra", [{}, {"use_quantized_grad": True}])
def test_debug_check_split_same_trees(extra):
    """tpu_debug_check_split passes on healthy training, keeps the eager
    loop, and changes no tree: the model text equals the run without it
    (on the eager loop too), and the JAX package's with the option."""
    X, y = _check_split_data()
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
            "tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
            **extra}
    pt = {**base, "device_type": "cpu"}
    eager = lambda env: None  # noqa: E731 — keeps train() on the eager loop
    eager.before_iteration = True
    on = lgb_t.train({**pt, "tpu_debug_check_split": True},
                     lgb_t.Dataset(X, label=y, params=pt), 4)
    off = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt), 4,
                      callbacks=[eager])
    assert on._gbdt.fused_ineligible_reason() == \
        "tpu_debug_check_split reads back per iteration"
    strip = lambda b: b.model_to_string().split("\nparameters:")[0]  # noqa: E731
    assert strip(on) == strip(off)
    jx = lgb_j.train({**base, "tpu_debug_check_split": True},
                     lgb_j.Dataset(X, label=y, free_raw_data=False), 4)
    np.testing.assert_allclose(on.predict(X, raw_score=True),
                               jx.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-6)
    assert [t.num_leaves for t in on._gbdt.models] == \
        [int(t.num_leaves) for t in jx._gbdt.models]


@pytest.mark.parametrize("field,delta", [("leaf_count", 7.0),
                                         ("leaf_weight", 3.0)])
def test_debug_check_split_fatal_on_corruption(field, delta):
    """A tree whose histogram-derived counts (or hessian sums) disagree
    with its partition trips log.fatal("CheckSplit ...") at once, as in
    the JAX package."""
    X, y = _check_split_data()
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "device_type": "cpu", "tpu_debug_check_split": True}
    bst = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 2)
    g = bst._gbdt
    orig = g._grow_maybe_quantized

    def bad(*a, **k):
        arrays, rl = orig(*a, **k)
        return arrays._replace(
            **{field: getattr(arrays, field) + delta}), rl

    g._grow_maybe_quantized = bad
    with pytest.raises(lgb_t.LightGBMError, match="CheckSplit"):
        g.train_one_iter(None, None)


# ------------------------------------------------------- concurrency lint
def test_port_has_no_unsuppressed_concurrency_finding():
    """The JAX package's concurrency lint over the whole port (serving,
    gateway, online loop, CLI, kernels' build): every finding is fixed
    or carries a `# lint: allow[...]` with its reason."""
    from lightgbm_tpu.analysis.concurrency_lint import \
        concurrency_lint_package

    findings = concurrency_lint_package(pkg_root="lightgbm_tpu_torch")
    open_ = [f for f in findings if not f.suppressed]
    assert open_ == [], "\n".join(map(str, open_))
    paths = {str(f.path) for f in findings}
    assert any("serving" in p for p in paths)
