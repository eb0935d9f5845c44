"""The port's serving stack on the CPU against the JAX package's:
BucketDispatcher, MicroBatcher, ModelRegistry, ScoringServer and
serve_http (lightgbm_tpu_torch/serving), latency statistics and the
refusals of what is not ported yet.

Models are trained by the JAX package and loaded by both packages from
the same text. The dispatcher is held to one unbucketed forest_apply
over a 100-request mixed-size sequence, bit for bit (the port's class
sums run in a fixed order, so a row's score does not depend on its
batch), with at most one program per rung; the transports answer the
same requests with the same response fields as the JAX package's,
predictions within 1e-5, timings aside.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu.serving as serving_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.resilience.errors import (
    DeadlineExceeded,
    QueueOverflow,
    ShutdownError,
)
from lightgbm_tpu_torch.serving import (
    DEFAULT_BUCKETS,
    BucketDispatcher,
    MicroBatcher,
    ModelRegistry,
    ScoringServer,
    TensorForest,
)
from lightgbm_tpu_torch.serving import forest as forest_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

TOL = dict(rtol=1e-5, atol=1e-5)


def _train(params, X, y, rounds=10, **ds_kw):
    ds = lgb_j.Dataset(X, label=y, free_raw_data=False, **ds_kw)
    p = dict(verbosity=-1, min_data_in_leaf=5)
    p.update(params)
    return lgb_j.train(p, ds, num_boost_round=rounds).model_to_string()


@pytest.fixture(scope="module")
def models():
    """Model texts trained by the JAX package, with their rows."""
    rs = np.random.RandomState(5)
    X = rs.randn(1500, 6)
    X[rs.rand(1500) < 0.05, 4] = np.nan
    X[:, 2] = rs.randint(0, 9, 1500)
    y = (np.nan_to_num(X[:, 0]) + (X[:, 2] % 2) > 0.4).astype(float)
    return {
        "binary": (_train({"objective": "binary", "num_leaves": 23}, X, y,
                          rounds=11, categorical_feature=[2]), X),
        "binary6": (_train({"objective": "binary", "num_leaves": 15}, X, y,
                           rounds=6), X),
        "regression": (_train({"objective": "regression",
                               "num_leaves": 15}, X, X[:, 0] * 2), X),
    }


def _forest(text):
    return TensorForest.from_booster(lgb_t.Booster(model_str=text),
                                     device="cpu")


def _sizes(rs, top):
    """100 mixed request sizes: empty, one row, past the top rung."""
    sizes = [int(s) for s in rs.randint(1, 600, 94)]
    return sizes + [0, 1, top, top + 1, 2 * top + 37, 0]


# ---------------------------------------------------------------- dispatcher
def test_dispatcher_matches_unbucketed_forest(models):
    text, X = models["binary"]
    f = _forest(text)
    buckets = (32, 128, 512)
    disp = BucketDispatcher(f, buckets=buckets)
    assert disp.captures == 0 and not disp.programs
    tw = torch.ones(f.num_trees)
    full_score, full_leaf = f.apply(torch.from_numpy(X.astype(np.float32)),
                                    tw)
    full_score = full_score.numpy().T.astype(np.float64)
    full_leaf = full_leaf.numpy().astype(np.int64)
    rs = np.random.RandomState(3)
    for n in _sizes(rs, buckets[-1]):
        lo = int(rs.randint(0, X.shape[0] - n + 1))
        raw = disp.score_raw(X[lo:lo + n])
        assert raw.shape == (1, n)
        np.testing.assert_array_equal(raw, full_score[:, lo:lo + n])
        np.testing.assert_array_equal(disp.predict_leaf(X[lo:lo + n]),
                                      full_leaf[lo:lo + n])
    # at most one program per rung, all at the request width
    assert len(disp.programs) <= len(buckets)
    assert {b for b, _ in disp.programs} <= set(buckets)
    assert disp.captures == 0  # no graphs on the CPU
    np.testing.assert_allclose(full_score,
                               lgb_t.Booster(model_str=text)._gbdt
                               .predict_raw(X), **TOL)


def test_dispatcher_matches_jax_dispatcher(models):
    text, X = models["binary"]
    dj = serving_j.BucketDispatcher(
        serving_j.TensorForest.from_booster(lgb_j.Booster(model_str=text)),
        buckets=(16, 64, 256), name="vs_jax")
    dt = BucketDispatcher(_forest(text), buckets=(16, 64, 256),
                          name="vs_jax")  # a latency ring of its own
    for n in (1, 7, 64, 300, 0):
        np.testing.assert_allclose(dt.score_raw(X[:n]), dj.score_raw(X[:n]),
                                   **TOL)
        np.testing.assert_array_equal(dt.predict_leaf(X[:n], 2, 5),
                                      dj.predict_leaf(X[:n], 2, 5))
    np.testing.assert_allclose(dt.score_raw(X[7]), dj.score_raw(X[7]), **TOL)
    assert dt.stats()["count"] == dj.stats()["count"] == 9
    assert dt.stats()["rows"] == dj.stats()["rows"]


def test_dispatcher_warmup_builds_every_rung(models):
    text, X = models["regression"]
    disp = BucketDispatcher(_forest(text), buckets=(16, 64))
    disp.warmup(num_features=6)
    assert disp.programs == ((16, 6), (64, 6))
    disp.score_raw(X[:10])
    disp.score_raw(X[:60])
    assert disp.programs == ((16, 6), (64, 6))


def test_dispatcher_contrib_matches_forest(models):
    text, X = models["binary6"]
    f = _forest(text)
    disp = BucketDispatcher(f, buckets=(16, 64))
    np.testing.assert_allclose(disp.predict_contrib(X[:150]),
                               f.predict_contrib(X[:150]), **TOL)
    assert disp.predict_contrib(X[:0]).shape == (0, 7)


def test_serve_buckets_default_matches_dispatch():
    from lightgbm_tpu_torch.config import Config

    assert tuple(Config({}).serve_buckets) == DEFAULT_BUCKETS == \
        tuple(serving_j.DEFAULT_BUCKETS)


# ---------------------------------------------------------------- batcher
def test_microbatcher_concurrent_submits(models):
    text, X = models["binary6"]
    f = _forest(text)
    disp = BucketDispatcher(f, buckets=(64, 256))
    host = lgb_t.Booster(model_str=text)._gbdt.predict_raw(X[:360])
    mb = MicroBatcher(disp)
    try:
        out = {}

        def client(i):
            out[i] = mb.submit(X[i * 30: (i + 1) * 30]).result(timeout=30)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for i in range(12):
            np.testing.assert_allclose(out[i].T,
                                       host[:, i * 30: (i + 1) * 30], **TOL)
    finally:
        mb.close()


class _SlowDispatcher:
    """A dispatcher stand-in whose call blocks until released, so the
    queue fills behind it."""

    def __init__(self, disp):
        self.disp, self.forest, self.name = disp, disp.forest, disp.name
        self.buckets = disp.buckets
        self.release = threading.Event()
        self.entered = threading.Event()

    def score_raw(self, X):
        self.entered.set()
        self.release.wait(30)
        return self.disp.score_raw(X)


@pytest.mark.chaos
def test_microbatcher_overflow_deadline_and_close(models):
    text, X = models["binary6"]
    slow = _SlowDispatcher(BucketDispatcher(_forest(text), buckets=(16,)))
    mb = MicroBatcher(slow, queue_cap=20)
    try:
        busy = mb.submit(X[:4])  # the worker takes it and blocks
        assert slow.entered.wait(30)
        expiring = mb.submit(X[:5], deadline_s=0.01)
        queued = mb.submit(X[:10])
        with pytest.raises(QueueOverflow) as ei:
            mb.submit(X[:10])
        assert ei.value.retry_after_s == 1
        time.sleep(0.05)
        slow.release.set()
        assert busy.result(timeout=30).shape == (4, 1)
        with pytest.raises(DeadlineExceeded):
            expiring.result(timeout=30)
        assert queued.result(timeout=30).shape == (10, 1)
    finally:
        slow.release.set()
        mb.close()
    with pytest.raises(ShutdownError):
        mb.submit(X[:1])


# ---------------------------------------------------------------- registry
def test_registry_load_swap_rollback(models):
    t1, X = models["binary6"]
    t2, _ = models["binary"]
    b1, b2 = lgb_t.Booster(model_str=t1), lgb_t.Booster(model_str=t2)
    reg = ModelRegistry(device="cpu")
    v1 = reg.load("m", t1)
    assert v1 == 1 and reg.models()["m"]["active"] == 1
    np.testing.assert_allclose(reg.predict("m", X[:50]), b1.predict(X[:50]),
                               **TOL)
    v2 = reg.load("m", t2)
    assert reg.models()["m"]["active"] == v2
    np.testing.assert_allclose(reg.predict("m", X[:50]), b2.predict(X[:50]),
                               **TOL)
    assert reg.rollback("m") == v1
    np.testing.assert_allclose(reg.predict("m", X[:50]), b1.predict(X[:50]),
                               **TOL)
    np.testing.assert_allclose(reg.predict("m", X[:50], version=v2),
                               b2.predict(X[:50]), **TOL)
    reg.swap("m", v2)
    assert reg.models()["m"]["active"] == v2
    with pytest.raises(ValueError):
        reg.unload("m", v2)  # the active version is protected
    reg.unload("m", v1)
    assert [v["version"] for v in reg.models()["m"]["versions"]] == [v2]
    with pytest.raises(KeyError):
        reg.predict("nope", X[:5])


def test_registry_json_round_trip_and_sources(models, tmp_path):
    text, X = models["binary"]
    bt = lgb_t.Booster(model_str=text)
    d = lgb_j.Booster(model_str=text).dump_model()
    path = tmp_path / "m.json"
    path.write_text(json.dumps(d))
    reg = ModelRegistry(device="cpu")
    reg.load("t", text)
    reg.load("d", d)
    reg.load("f", str(path))
    reg.load("b", bt)
    Xq = X[:200].copy()
    Xq[:, 2] = np.random.RandomState(1).randint(-1, 12, 200)
    want = reg.predict("t", Xq)
    for name in ("d", "f", "b"):
        np.testing.assert_array_equal(reg.predict(name, Xq), want)
    np.testing.assert_allclose(want, bt.predict(Xq), **TOL)
    srcs = {n: m["versions"][0]["source"] for n, m in reg.models().items()}
    assert srcs == {"t": "model-string", "d": "json-dict", "f": str(path),
                    "b": "booster"}


def test_registry_path_named_like_model_string(models, tmp_path):
    text, X = models["regression"]
    path = tmp_path / "tree_v2.txt"
    path.write_text(text)
    reg = ModelRegistry(device="cpu")
    reg.load("m", str(path))
    np.testing.assert_allclose(reg.predict("m", X[:10]),
                               lgb_t.Booster(model_str=text).predict(X[:10]),
                               **TOL)


def test_registry_pred_leaf_rides_bucket_ladder(models):
    text, X = models["binary"]
    bt = lgb_t.Booster(model_str=text)
    reg = ModelRegistry(buckets=(32, 128), device="cpu")
    reg.load("m", text)
    rs = np.random.RandomState(2)
    for n in rs.randint(1, 200, 30):
        np.testing.assert_array_equal(reg.predict("m", X[:n], pred_leaf=True),
                                      bt.predict(X[:n], pred_leaf=True))
    assert {b for b, _ in reg._entry("m").dispatcher.programs} <= {32, 128}


def test_registry_queue_replicas_and_empty(models):
    text, X = models["binary6"]
    bt = lgb_t.Booster(model_str=text)
    reg = ModelRegistry(device="cpu", replicas=2, warmup=True)
    reg.load("m", text)
    mv = reg._entry("m")
    assert len(mv.replicas) == 2 and mv.replicas[0] is mv.dispatcher
    assert all(d.programs == tuple((b, 6) for b in DEFAULT_BUCKETS)
               for d in mv.replicas)
    np.testing.assert_allclose(reg.predict("m", X[:40], via_queue=True),
                               bt.predict(X[:40]), **TOL)
    np.testing.assert_allclose(
        reg.predict("m", X[:40], via_queue=True, num_iteration=3,
                    raw_score=True),
        bt.predict(X[:40], num_iteration=3, raw_score=True), **TOL)
    for _ in range(3):  # direct predicts round-robin over the replicas
        np.testing.assert_allclose(reg.predict("m", X[:9]),
                                   bt.predict(X[:9]), **TOL)
    assert all(d.stats()["count"] >= 1 for d in mv.replicas)
    assert reg.predict("m", np.zeros((0, 6))).shape == (0,)
    assert reg.predict("m", np.zeros((0, 6)), pred_leaf=True).shape == \
        (0, bt.num_trees())
    contrib = reg.predict("m", X[:5], pred_contrib=True)
    np.testing.assert_allclose(contrib, bt.predict(X[:5], pred_contrib=True),
                               **TOL)


def test_unload_closes_microbatcher(models):
    text, X = models["regression"]
    reg = ModelRegistry(device="cpu")
    reg.load("m", text)
    reg.predict("m", X[:10], via_queue=True)  # lazily creates the batcher
    mv = reg._entry("m")
    assert mv.batcher is not None
    assert all(w.is_alive() for w in mv.batcher._workers)
    reg.unload("m")
    assert not any(w.is_alive() for w in mv.batcher._workers)


# ------------------------------------------------------------------ servers
def _requests(text, X):
    return [
        {"op": "ping"},
        {"op": "score", "rows": X[:4].tolist()},
        {"op": "score", "rows": X[:4].tolist(), "raw_score": True},
        {"op": "score", "rows": X[:3].tolist(), "pred_leaf": True},
        {"op": "score", "rows": X[:3].tolist(), "num_iteration": 2,
         "start_iteration": 1},
        {"op": "score", "rows": X[:3].tolist(), "queue": True},
        {"op": "contrib", "rows": X[:2].tolist()},
        {"op": "score", "model": "missing", "rows": [[0.0] * 6]},
        {"op": "load", "model": "m2", "model_str": text},
        {"op": "load", "model": "m2"},
        {"op": "swap", "model": "m2", "version": 1},
        {"op": "rollback", "model": "m2"},
        {"op": "fleet"},
        {"op": "ingest", "rows": [[0.0] * 6], "labels": [1.0]},
        {"op": "nope"},
        {"op": "models"},
        {"op": "stats"},
        {"op": "quit"},
    ]


def _same_response(a, b):
    """Responses equal up to timings (stats' latencies, loaded_at), the
    process-wide queue-depth gauge, and f32 prediction noise."""
    assert set(a) == set(b), (a, b)
    for k in a:
        if k == "queue_depth":
            continue
        if k == "pred":
            np.testing.assert_allclose(np.asarray(a[k], float),
                                       np.asarray(b[k], float), **TOL)
        elif k == "stats":
            assert {n: set(s) for n, s in a[k].items()} == \
                {n: set(s) for n, s in b[k].items()}
            for n in a[k]:
                assert a[k][n]["count"] == b[k][n]["count"]
                assert a[k][n]["rows"] == b[k][n]["rows"]
        elif k == "models" and isinstance(a[k], dict):
            for n in a[k]:
                for va, vb in zip(a[k][n]["versions"], b[k][n]["versions"]):
                    va, vb = dict(va), dict(vb)
                    va.pop("loaded_at"), vb.pop("loaded_at")
                    assert va == vb
                assert a[k][n]["active"] == b[k][n]["active"]
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def test_scoring_server_matches_jax(models):
    text, X = models["binary6"]
    regs = []
    for mod, kw in ((serving_j, {}), (lgb_t.serving, {"device": "cpu"})):
        reg = mod.ModelRegistry(**kw)
        reg.load("default", text)
        regs.append(reg)
    reqs = _requests(text, X)
    outs = []
    for mod, reg in zip((serving_j, lgb_t.serving), regs):
        sin = io.StringIO("\n".join(json.dumps(r) for r in reqs)
                          + "\nnot json\n")
        sout = io.StringIO()
        assert mod.ScoringServer(reg).serve(sin, sout) == len(reqs)
        outs.append([json.loads(ln) for ln in sout.getvalue().splitlines()])
    assert len(outs[0]) == len(outs[1]) == len(reqs)
    for a, b in zip(*outs):
        _same_response(b, a)
    assert outs[1][0] == {"ok": True, "pong": True}
    assert outs[1][-1]["quit"]
    bad = io.StringIO()
    ScoringServer(regs[1]).serve(io.StringIO("not json\n"), bad)
    assert not json.loads(bad.getvalue())["ok"]


def _http(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t, f"http://127.0.0.1:{httpd.server_address[1]}"


def _call(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_http_matches_jax(models):
    text, X = models["binary6"]
    answers = []
    for mod, kw in ((serving_j, {}), (lgb_t.serving, {"device": "cpu"})):
        reg = mod.ModelRegistry(**kw)
        httpd = mod.serve_http(reg, port=0, block=False)
        t, base = _http(httpd)
        try:
            got = [_call(base, "/readyz")]  # 503: no model yet
            reg.load("default", text)
            got += [_call(base, p) for p in ("/healthz", "/readyz",
                                            "/v1/models", "/nope")]
            got += [_call(base, "/v1/score", {"rows": X[:5].tolist()}),
                    _call(base, "/v1/score", {"rows": X[:5].tolist(),
                                              "queue": True}),
                    _call(base, "/v1/contrib", {"rows": X[:2].tolist()}),
                    _call(base, "/v1/score", {"model": "missing",
                                              "rows": [[0.0] * 6]}),
                    _call(base, "/v1/quit", {})]
            metrics = _call(base, "/metrics")
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=5)
        answers.append(got)
        assert metrics[0] == 200
        for series in ("lgbmtpu_serve_requests_total",
                       "lgbmtpu_serve_bucket_dispatch_total",
                       "lgbmtpu_serve_latency_ms",
                       "lgbmtpu_serve_protocol_requests_total"):
            assert series in metrics[1]
    for (ca, ba), (cb, bb) in zip(*answers):
        assert ca == cb
        _same_response(json.loads(bb), json.loads(ba))
    assert [c for c, _ in answers[1]] == [503, 200, 200, 200, 404, 200, 200,
                                         200, 400, 400]
    np.testing.assert_allclose(
        json.loads(answers[1][5][1])["pred"],
        lgb_t.Booster(model_str=text).predict(X[:5]), **TOL)


def test_latency_stats_counters():
    from lightgbm_tpu_torch.timer import LatencyStats

    ls = LatencyStats(window=8)
    for ms in (1, 2, 3, 4, 100):
        ls.observe(ms / 1e3, rows=10)
    s = ls.snapshot()
    assert s["count"] == 5 and s["rows"] == 50
    assert s["p50_ms"] == pytest.approx(3.0, abs=0.01)
    assert s["p99_ms"] == pytest.approx(100.0, abs=0.01)
    assert s["mean_ms"] == pytest.approx(22.0, abs=0.01)
    ls.reset()
    assert ls.snapshot()["count"] == 0


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("name,item", [
    ("CircuitBreaker", "A.11"), ("Gateway", "A.11"),
    ("gateway_http", "A.11")])
def test_deferred_serving_names_raise(name, item):
    """The gateway's names waited for the second half of A.11, which
    ported them: each is the port's gateway object and no refusal, and
    an unknown serving name raises AttributeError."""
    import lightgbm_tpu_torch.serving as s
    from lightgbm_tpu_torch.serving import gateway

    assert item == "A.11" and name in s.__all__
    assert getattr(s, name) is getattr(gateway, name)
    assert not hasattr(s, "NOT_PORTED")
    with pytest.raises(AttributeError):
        getattr(s, "NoSuchServingName")


def test_deferred_options_raise(models):
    """A row-sharded forest (mesh=) is ported (A.8): a mesh of one rank
    scores as no mesh (tests/test_torch_serving_mesh.py runs two ranks).
    host_fallback was refused until the fault injection it answers came
    (A.11, first half): a registry with it scores as one without it."""
    text, X = models["regression"]
    fb = ModelRegistry(device="cpu", host_fallback=True)
    fb.load("m", text)
    plain = ModelRegistry(device="cpu")
    plain.load("m", text)
    np.testing.assert_array_equal(fb.predict("m", X[:5]),
                                  plain.predict("m", X[:5]))
    import types

    one = types.SimpleNamespace(size=1, rank=0)
    meshed = ModelRegistry(mesh=one, device="cpu")
    meshed.load("m", text)
    np.testing.assert_array_equal(meshed.predict("m", X[:5]),
                                  plain.predict("m", X[:5]))
    forest = TensorForest.from_booster(lgb_t.Booster(model_str=text),
                                       device="cpu", mesh=one)
    assert forest.mesh is None and forest.num_devices == 1


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", ["cuda", "gpu", "tpu"])
def test_card_asked_without_card_raises(no_card, models, device):
    text, X = models["regression"]
    bt = lgb_t.Booster(model_str=text)
    for call in (lambda: bt.predict(X[:3], device=device),
                 lambda: bt.predict(X[:3], device=device, pred_contrib=True),
                 lambda: TensorForest.from_booster(bt, device=device),
                 lambda: ModelRegistry(device=device)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
    # the host walker and the CPU forest need no card
    np.testing.assert_array_equal(bt.predict(X[:3], device="cpu"),
                                  bt.predict(X[:3]))
    assert ModelRegistry(device="cpu").device.type == "cpu"


def test_booster_predict_device_path(monkeypatch, models, capsys):
    """Booster.predict(device=...) as the JAX package's: the forest's
    scores and leaves, and a warning with the host path for pred_contrib
    and pred_early_stop; the card is stood in for by the CPU here."""
    text, X = models["binary"]
    monkeypatch.setattr(forest_t, "serve_device",
                        lambda d: torch.device("cpu"))
    bt = lgb_t.Booster(model_str=text, params={"verbosity": 0})
    bj = lgb_j.Booster(model_str=text)
    np.testing.assert_allclose(bt.predict(X[:100], device="cuda"),
                               bj.predict(X[:100], device="tpu"), **TOL)
    np.testing.assert_allclose(
        bt.predict(X[:100], device="cuda", raw_score=True),
        bt.predict(X[:100], raw_score=True), **TOL)
    np.testing.assert_array_equal(
        bt.predict(X[:100], device="cuda", pred_leaf=True),
        bt.predict(X[:100], pred_leaf=True))
    c = bt.predict(X[:5], device="cuda", pred_contrib=True)
    np.testing.assert_array_equal(c, bt.predict(X[:5], pred_contrib=True))
    assert "pred_contrib has no device implementation" in \
        capsys.readouterr().err
    es = bt.predict(X[:5], device="cuda", pred_early_stop=True)
    assert "pred_early_stop has no device implementation" in \
        capsys.readouterr().err
    np.testing.assert_array_equal(es, bt.predict(X[:5],
                                                 pred_early_stop=True))
    np.testing.assert_array_equal(
        bt.predict(X[:5], validate_features=True), bt.predict(X[:5]))
    with pytest.raises(NotImplementedError, match="num_threads"):
        bt.predict(X[:5], num_threads=2)
