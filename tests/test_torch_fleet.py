"""The multi-tenant model fleet (lightgbm_tpu_torch/serving/fleet.py) on
the CPU against the JAX package's (lightgbm_tpu.serving.fleet.ModelFleet)
on the same model texts and requests, mirroring tests/test_fleet.py:

- stacked-slot scores within 1e-5 of the JAX fleet's, the same bits as
  the tenant's own TensorForest, and the same bits in any slot;
- a page-in builds no new dispatcher program (on the card: captures no
  graph): a family's tenants share one ProgramSet;
- the same LRU page-ins, evictions and residency as the JAX fleet under
  one request trace;
- swap and rollback atomic under concurrent load: every answer is one
  version's bits, never a torn slot or another tenant's trees;
- QoS: a tenant's queue cap and deadline, and a residency held by pinned
  models, reject rather than block;
- device TreeSHAP and pred_leaf through the fleet;
- the fleet over HTTP (/v1/fleet, the fleet op, QoS on load, /metrics).
"""

import json
import sys
import threading
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.serving import ModelFleet as FleetJ
from lightgbm_tpu_torch.resilience.errors import QueueOverflow
from lightgbm_tpu_torch.serving import ModelFleet, TensorForest, serve_http
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


def _model(seed, leaves=15, rounds=8, feats=6, depth=None, **extra):
    """A regression model's text, trained by the port on the CPU."""
    r = np.random.RandomState(seed)
    X = r.randn(500, feats)
    y = X[:, 0] * (seed % 5 + 1) + X[:, 1] + 0.1 * r.randn(500)
    p = {"objective": "regression", "num_leaves": leaves, "verbosity": -1,
         "min_data_in_leaf": 5, "device_type": "cpu", **extra}
    if depth is not None:
        p["max_depth"] = depth
    return lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p),
                       rounds).model_to_string()


def _rows(seed, n=30, feats=6):
    return np.random.RandomState(seed).randn(n, feats)


def _fleets(**kw):
    return ModelFleet(device="cpu", **kw), FleetJ(**kw)


def _resident(fleet):
    return {n for n, m in fleet.models().items()
            if any(v["resident"] for v in m["versions"])}


def _slot(fleet, name):
    return fleet._names[name]["versions"][0].slot


# ---------------------------------------------------- stacked scoring
@pytest.fixture(scope="module")
def family():
    """Four models of one family (depth pinned; trees, nodes and leaves
    padding to the same powers of two)."""
    return {f"m{i}": _model(i, leaves=6 + (i % 3), rounds=5 + i, depth=3)
            for i in range(4)}


def test_stacked_scores_match_jax_and_every_slot(family):
    ft, fj = _fleets(buckets=(16, 64), capacity=2, slots_per_family=2)
    for name, text in family.items():
        ft.load(name, text)
        fj.load(name, text)
    Xq = _rows(7)
    seen = {}
    try:
        # the second order pages m1 and m0 into each other's slots
        for order in ((0, 1, 2, 3), (1, 0, 3, 2), (0, 1, 2, 3)):
            for name in (f"m{i}" for i in order):
                text = family[name]
                got = ft.predict(name, Xq, raw_score=True)
                want = np.asarray(fj.predict(name, Xq, raw_score=True))
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                own = TensorForest.from_booster(
                    lgb_t.Booster(model_str=text), device="cpu")
                np.testing.assert_array_equal(got, own.predict_raw(Xq)[0])
                seen.setdefault(name, {})[_slot(ft, name)] = got
        assert len(ft._stacks) == 1 and len(fj._stacks) == 1
        # a tenant paged into another slot scores the same bits
        moved = [n for n, by_slot in seen.items() if len(by_slot) > 1]
        assert moved, seen.keys()
        for name in moved:
            a, b = seen[name].values()
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            ft.predict("m1", Xq, pred_leaf=True),
            np.asarray(fj.predict("m1", Xq, pred_leaf=True)))
    finally:
        ft.close()
        fj.close()


def test_page_in_builds_no_new_program(family):
    """The family's rungs are built once: every later page-in replays
    them (on the card: no capture), and every tenant's dispatcher calls
    into the stack's one ProgramSet."""
    fleet = ModelFleet(buckets=(16, 64), capacity=2, slots_per_family=2,
                       device="cpu")
    for name, text in family.items():
        fleet.load(name, text)
    Xq = _rows(3)
    try:
        for name in family:
            fleet.predict(name, Xq)
        (st,), = fleet._stacks.values()
        shapes = dict(st.programs.by_shape)
        assert set(shapes) == {(16, 6), (64, 6)}
        pages = fleet.fleet_stats()["pages_in"]
        for _ in range(2):
            for name in reversed(list(family)):
                fleet.predict(name, Xq[:5])
                fleet.predict(name, Xq)
        assert fleet.fleet_stats()["pages_in"] > pages + 4
        assert st.programs.by_shape == shapes  # the same program objects
        sets = {id(e.dispatcher.program_set)
                for r in fleet._names.values() for e in r["versions"]}
        assert sets == {id(st.programs)}
        assert fleet.captures() == 0  # no graphs on the CPU
    finally:
        fleet.close()


# ------------------------------------------------------------- paging
def test_lru_order_and_counts_match_jax():
    """Six models of mixed shapes, residency 3, one request trace: after
    every request the same models are resident in both fleets, and the
    page-ins and evictions agree; resident <= capacity throughout."""
    texts = {f"m{i}": _model(10 + i, leaves=(7, 15, 31)[i % 3],
                             rounds=4 + 2 * (i % 2)) for i in range(6)}
    ft, fj = _fleets(buckets=(16, 64), capacity=3, slots_per_family=2)
    for name, text in texts.items():
        ft.load(name, text)
        fj.load(name, text)
    Xq = _rows(3, 20)
    trace = [0, 1, 2, 3, 0, 4, 1, 5, 2, 2, 3, 0, 5, 4, 1, 0]
    try:
        for i in trace:
            name = f"m{i}"
            got = ft.predict(name, Xq)
            np.testing.assert_allclose(got, np.asarray(fj.predict(name, Xq)),
                                       rtol=1e-5, atol=1e-5)
            assert _resident(ft) == _resident(fj), name
            assert ft.fleet_stats()["resident"] <= 3
        st, sj = ft.fleet_stats(), fj.fleet_stats()
        for k in ("resident", "capacity", "models", "pages_in",
                  "evictions"):
            assert st[k] == sj[k], k
        assert st["evictions"] > 0 and st["pages_in"] > len(texts)
        assert st["families"].keys() == {str(k) for k in fj._stacks}
    finally:
        ft.close()
        fj.close()


def test_paging_metrics():
    from lightgbm_tpu_torch.obs.metrics import default_registry

    fleet = ModelFleet(buckets=(16,), capacity=1, device="cpu")
    for i in range(2):
        fleet.load(f"pm{i}", _model(20 + i, rounds=3))
    try:
        for _ in range(2):
            for i in range(2):
                fleet.predict(f"pm{i}", _rows(1, 4))
        snap = default_registry().snapshot()
        pages = snap.get("lgbmtpu_fleet_page_events_total", {})
        for event in ("page_in", "evict", "warmup"):
            assert any('model="pm0"' in k and f'event="{event}"' in k
                       for k in pages), (event, pages.keys())
        assert "lgbmtpu_fleet_resident_models" in snap
        reqs = snap.get("lgbmtpu_serve_requests_total", {})
        assert any('model="pm1"' in k for k in reqs), reqs.keys()
    finally:
        fleet.close()


# ------------------------------------------------- swap under load
def test_swap_rollback_atomic_under_concurrent_load():
    """Readers hammer model A through a v1 -> v2 swap while a cold model
    B pages in beside them: every answer is bit-equal to v1's or v2's,
    never torn or another model's; after rollback, v1's again."""
    fleet = ModelFleet(buckets=(16,), capacity=2, slots_per_family=2,
                       device="cpu")
    t1, t2, tc = (_model(s, leaves=12, rounds=6) for s in (21, 22, 23))
    Xq = _rows(5, 16)
    scratch = ModelFleet(buckets=(16,), capacity=2, slots_per_family=2,
                         device="cpu")
    scratch.load("r1", t1)
    scratch.load("r2", t2)
    ref1 = scratch.predict("r1", Xq)
    ref2 = scratch.predict("r2", Xq)
    scratch.close()
    assert np.max(np.abs(ref1 - ref2)) > 1e-3
    fleet.load("A", t1)
    np.testing.assert_array_equal(fleet.predict("A", Xq), ref1)
    errors, torn = [], []
    stop = threading.Event()

    def hammer():
        try:
            while not stop.is_set():
                got = fleet.predict("A", Xq, via_queue=True)
                if not (np.array_equal(got, ref1)
                        or np.array_equal(got, ref2)):
                    torn.append(got)
                    return
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # thread switches inside the pager
    for t in threads:
        t.start()
    try:
        v2 = fleet.load("A", t2, activate=False)
        fleet.load("B", tc)  # a cold page-in during the storm
        want = TensorForest.from_booster(lgb_t.Booster(model_str=tc),
                                         device="cpu").predict_raw(Xq)[0]
        np.testing.assert_array_equal(fleet.predict("B", Xq), want)
        fleet.swap("A", v2)
        for _ in range(20):
            fleet.predict("A", Xq)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert not torn, "a torn or foreign prediction during the swap"
    np.testing.assert_array_equal(fleet.predict("A", Xq), ref2)
    assert fleet.rollback("A") == 1
    np.testing.assert_array_equal(fleet.predict("A", Xq), ref1)
    fleet.close()


# ---------------------------------------------------------------- QoS
def test_qos_and_residency_rejection():
    """A tenant's queue cap and deadline ride load(); a backlog past the
    cap is rejected with QueueOverflow; a residency held by pinned models
    rejects a page-in after page_timeout_s instead of blocking."""
    fleet = ModelFleet(buckets=(16,), capacity=1, slots_per_family=1,
                       page_timeout_s=0.2, device="cpu")
    fleet.load("a", _model(31))
    fleet.load("b", _model(32))
    Xq = _rows(9, 8)
    try:
        fleet.predict("a", Xq)
        fleet.predict("b", Xq)  # unpinned: evicts a and succeeds
        assert fleet.fleet_stats()["resident"] == 1
        # b pinned by a request in flight: a cannot page in
        entry_b = fleet._names["b"]["versions"][0]
        fleet._acquire(entry_b)
        try:
            with pytest.raises(QueueOverflow, match="all pinned"):
                fleet.predict("a", Xq)
        finally:
            fleet._release(entry_b)
        fleet.predict("a", Xq)  # released: pages in again
        v = fleet.load("q", _model(33), queue_cap=3, deadline_ms=2500)
        assert v == 1
        fleet.predict("q", Xq, via_queue=True)  # builds the batcher
        entry = fleet._names["q"]["versions"][0]
        assert entry.batcher.queue_cap == 3
        assert entry.batcher.deadline_s == pytest.approx(2.5)
        with pytest.raises(QueueOverflow):
            entry.batcher._pending.append(
                (np.zeros((1, 6), np.float32), object(), None))
            entry.batcher._pending_rows += 1
            try:
                fleet.predict("q", Xq, via_queue=True)
            finally:
                entry.batcher._pending.pop()
                entry.batcher._pending_rows -= 1
    finally:
        fleet.close()


def test_deferred_fleet_options_raise():
    """A mesh is ignored with a warning, as in the JAX package's fleet
    (A.8). host_fallback was refused until the fault injection it
    answers came (A.11, first half): now it is the fleet's setting
    (tests/test_torch_resilience.py drives it)."""
    assert ModelFleet(mesh=object(), device="cpu").capacity == 32
    assert ModelFleet(host_fallback=True, device="cpu").host_fallback
    assert not ModelFleet(device="cpu").host_fallback


# ------------------------------------------------------ explanations
def test_contrib_through_fleet_matches_jax_and_drops_on_eviction():
    texts = {"c0": _model(41, rounds=6), "c1": _model(42, rounds=6)}
    ft, fj = _fleets(buckets=(16,), capacity=1)
    for name, text in texts.items():
        ft.load(name, text)
        fj.load(name, text)
    Xq = _rows(11, 12)
    try:
        for name, text in texts.items():
            got = ft.predict(name, Xq, pred_contrib=True)
            want = np.asarray(fj.predict(name, Xq, pred_contrib=True))
            assert got.shape == want.shape == (12, 7)
            assert np.max(np.abs(got - want)) < 1e-5
            own = TensorForest.from_booster(lgb_t.Booster(model_str=text),
                                            device="cpu")
            np.testing.assert_allclose(got, own.predict_contrib(Xq),
                                       rtol=1e-6, atol=1e-7)
            assert ft._names[name]["versions"][0].ctables is not None
        # c0 was evicted for c1: its contrib tables went with its slot
        assert ft._names["c0"]["versions"][0].ctables is None
    finally:
        ft.close()
        fj.close()


# ------------------------------------------------------------- HTTP
def test_fleet_over_http():
    text = _model(61)
    bst = lgb_t.Booster(model_str=text)
    fleet = ModelFleet(buckets=(16,), capacity=4, device="cpu")
    httpd = serve_http(fleet, port=0, block=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    Xq = _rows(17, 6)
    try:
        def post(path, body):
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        out = post("/v1/load", {"model": "h", "model_str": text,
                                "deadline_ms": 2000, "queue_cap": 4096})
        assert out["version"] == 1
        entry = fleet._names["h"]["versions"][0]
        assert entry.deadline_s == 2.0 and entry.queue_cap == 4096
        out = post("/v1/score", {"model": "h", "rows": Xq.tolist()})
        np.testing.assert_allclose(out["pred"], bst.predict(Xq),
                                   rtol=1e-5, atol=1e-6)
        out = post("/v1/contrib", {"model": "h", "rows": Xq.tolist()})
        assert np.asarray(out["pred"]).shape == (6, 7)
        with urllib.request.urlopen(base + "/v1/fleet", timeout=30) as r:
            fl = json.loads(r.read())["fleet"]
        assert fl["resident"] == 1 and fl["capacity"] == 4
        assert fl["pages_in"] == 1 and fl["captures"] == 0
        assert post("/v1/fleet", {})["fleet"] == fl
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            body = r.read().decode()
        assert 'model="h"' in body
        assert "lgbmtpu_fleet_resident_models" in body
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)
        fleet.close()
