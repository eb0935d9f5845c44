"""The flight recorder, the anomaly sentinels, span tracing and the run
manifest of lightgbm_tpu_torch, against the JAX package's on the same
seeded inputs (JAX on the CPU).

- the stream (schema lightgbm-tpu/flight-record/v1): round trip, memory
  only, truncate-and-append on a resume;
- the sentinels trip as the JAX package's do on the same record
  sequences (nan_metric, nan_leaf, loss_spike, throughput_collapse,
  dead_rounds, each policy), counted on /metrics and marked in the span
  trace;
- a recorded run's records carry the JAX package's keys, the same rounds
  and tree stats, evaluations within the parity tolerance;
- the fused loop's records equal the eager loop's key for key and bit
  for bit (the gh norms the captured step writes after its evaluations
  included), but the timings and the evaluations (device metrics: within
  1e-6); the recorded step reads nothing back, and without record_file
  and anomaly_policy the step is the one without the norms;
- an abort leaves a parseable stream and the manifest's summary; an
  unrecorded run clears it; the manifest writes null for the JAX
  package's jaxpr analysis.
"""

import json

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.obs.anomaly import AnomalySentinel as SentinelJ
from lightgbm_tpu_torch import boosting, timer
from lightgbm_tpu_torch.learner import device_loop
from lightgbm_tpu_torch.obs import manifest, tracing
from lightgbm_tpu_torch.obs.anomaly import AnomalyAbort, AnomalySentinel
from lightgbm_tpu_torch.obs.metrics import default_registry
from lightgbm_tpu_torch.obs.recorder import (
    SCHEMA,
    FlightRecorder,
    read_stream,
)
from test_torch_fused import _NoReadBack
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "metric": "binary_logloss", **PINS}
TIMING = {"t_unix", "phases", "chunk_phases", "trees_per_sec"}


@pytest.fixture
def bounded(monkeypatch):
    monkeypatch.setattr(boosting._FusedProgram, "cpu_loop",
                        device_loop.BOUNDED)


def _no_op(env):
    """Keeps train() on the eager loop."""


_no_op.before_iteration = True


def _train_t(params, rounds=5, fused=True, data=None):
    X, y, Xv, yv = data or _data("binary")
    p = {**BASE, **params, "device_type": "cpu"}
    ds = lgb_t.Dataset(X, label=y, params=p)
    vs = lgb_t.Dataset(Xv, label=yv, reference=ds)
    return lgb_t.train(p, ds, rounds, valid_sets=[vs], valid_names=["v"],
                       callbacks=[] if fused else [_no_op])


# --------------------------------------------------------------- stream
def test_recorder_roundtrip_memory_and_resume(tmp_path):
    path = str(tmp_path / "r.jsonl")
    rec = FlightRecorder(path)
    for i in range(3):
        rec.record({"round": i, "evals": {"v l2": 1.0 / (i + 1)}})
    s = rec.close()
    assert s["rounds"] == 3 and s["last_evals"] == {"v l2": 1 / 3}
    assert [r["round"] for r in read_stream(path)] == [0, 1, 2]
    lines = open(path).read().splitlines(keepends=True)
    assert json.loads(lines[0])["schema"] == SCHEMA
    size_after_2 = sum(len(x) for x in lines[:3])
    again = FlightRecorder(path, resume_bytes=size_after_2)
    again.record({"round": 2, "evals": {"v l2": 0.3}})
    again.close()
    assert [r["round"] for r in read_stream(path)] == [0, 1, 2]
    mem = FlightRecorder(None)
    mem.record({"round": 0})
    assert mem.close()["path"] is None and mem.rounds == 1


# ------------------------------------------------------------ sentinels
def _rec(i, **kw):
    return dict({"round": i}, **kw)


SEQUENCES = {
    "nan_metric": [_rec(0, evals={"v l2": 1.0}, evals_hb={"v l2": False}),
                   _rec(1, evals={"v l2": float("nan")},
                        evals_hb={"v l2": False})],
    "nan_leaf": [_rec(0, trees=[{"leaves": 3, "best_gain": 1.0,
                                 "leaf_finite": True}]),
                 _rec(1, trees=[{"leaves": 3, "best_gain": 1.0,
                                 "leaf_finite": False}])],
    "loss_spike": [_rec(i, evals={"v l2": v, "v auc": 50.0 * v},
                        evals_hb={"v l2": False, "v auc": True})
                   for i, v in enumerate([1.0, 1.1, 0.9, 5.0])],
    "throughput_collapse": [_rec(i, trees_per_sec=t) for i, t in
                            enumerate([10.0, 11.0, 10.0, 1.0])],
    "dead_rounds": [_rec(i, trees=[{"leaves": 5 if i == 1 else 1,
                                    "best_gain": 2.0 if i == 1 else 0.0,
                                    "leaf_finite": True}])
                    for i in range(13)],
}


@pytest.mark.parametrize("kind", sorted(SEQUENCES))
def test_sentinels_trip_as_jax(kind):
    a, b = AnomalySentinel("warn"), SentinelJ("warn")
    for r in SEQUENCES[kind]:
        a.check(dict(r))
        b.check(dict(r))
    assert a.trips == b.trips and [t["kind"] for t in a.trips] == [kind]
    assert a.summary() == b.summary()
    hard = AnomalySentinel("abort")
    with pytest.raises(AnomalyAbort) as ei:
        for r in SEQUENCES[kind]:
            hard.check(dict(r))
    assert ei.value.kind == kind


def test_sentinel_policies_counter_and_trace():
    off = AnomalySentinel("off")
    off.check(_rec(0, evals={"v l2": float("nan")}))
    assert not off.trips
    with pytest.raises(ValueError):
        AnomalySentinel("explode")
    c = default_registry().counter("lgbmtpu_anomaly_trips_total",
                                   labels=("kind",))
    before = c.value(kind="nan_metric")
    with tracing.tracing() as rec:
        AnomalySentinel("warn").check(_rec(7, evals={"v l2": float("inf")}))
    assert c.value(kind="nan_metric") == before + 1
    inst = [e for e in rec.events() if e["name"] == "anomaly: nan_metric"]
    assert inst and inst[0]["args"]["round"] == 7


# --------------------------------------------------------- train records
def test_records_match_jax_keys(bounded, tmp_path):
    """Both on their fused loops, whose records carry the trees' stats
    (the JAX package's eager loop defers its trees and leaves them out)."""
    X, y, Xv, yv = _data("binary")
    paths = {}
    for name, lgb in (("jax", lgb_j), ("port", lgb_t)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        p = {**BASE, "record_file": paths[name], "anomaly_policy": "warn"}
        if lgb is lgb_t:
            p["device_type"] = "cpu"
        ds = lgb.Dataset(X, label=y, params={"device_type": "cpu"}
                         if lgb is lgb_t else None)
        vs = lgb.Dataset(Xv, label=yv, reference=ds)
        lgb.train(p, ds, 5, valid_sets=[vs], valid_names=["v"])
    rj, rt = read_stream(paths["jax"]), read_stream(paths["port"])
    assert [r["round"] for r in rt] == [r["round"] for r in rj] == \
        list(range(5))
    for a, b in zip(rj, rt):
        assert set(a) == set(b)
        assert set(a["phases"]) and set(b["phases"])
        assert [(t["leaves"], t["depth"]) for t in a["trees"]] == \
            [(t["leaves"], t["depth"]) for t in b["trees"]]
        np.testing.assert_allclose(b["trees"][0]["best_gain"],
                                   a["trees"][0]["best_gain"], rtol=1e-5)
        np.testing.assert_allclose(b["evals"]["v binary_logloss"],
                                   a["evals"]["v binary_logloss"],
                                   rtol=1e-5)
        assert a["evals_hb"] == b["evals_hb"]
        assert b["gnorm"] > 0 and b["hnorm"] > 0


@pytest.mark.parametrize("params", [{}, {"bagging_fraction": 0.7,
                                         "bagging_freq": 1},
                                    {"objective": "multiclass",
                                     "num_class": 3,
                                     "metric": "multi_logloss"}],
                         ids=["plain", "bagging", "multiclass"])
def test_fused_records_equal_eager_records(bounded, tmp_path, params):
    task = "multiclass" if params.get("num_class") else "binary"
    recs = {}
    for loop in ("fused", "eager"):
        path = str(tmp_path / f"{loop}.jsonl")
        b = _train_t({**params, "record_file": path}, fused=loop == "fused",
                     data=_data(task))
        assert (b._gbdt._fused is not None) == (loop == "fused")
        recs[loop] = read_stream(path)
    fr, er = recs["fused"], recs["eager"]
    assert len(fr) == len(er) == 5
    for a, b in zip(fr, er):
        assert set(a) - {"chunk_phases"} == set(b)
        for k in set(a) - TIMING - {"evals"}:
            assert a[k] == b[k], k
        for k in a["evals"]:
            assert abs(a["evals"][k] - b["evals"][k]) <= 1e-6
    assert "round: fused step" in fr[0]["phases"]
    assert "fused dispatch" in fr[0]["chunk_phases"]


def test_recorded_step_reads_nothing_back(bounded, monkeypatch, tmp_path):
    step = boosting._FusedProgram.step
    seen = []

    def guarded(self, loop):
        seen.append(self.want_gh)
        with _NoReadBack():
            step(self, loop)

    monkeypatch.setattr(boosting._FusedProgram, "step", guarded)
    b = _train_t({"record_file": str(tmp_path / "r.jsonl")}, rounds=3)
    assert seen and all(seen)
    rows_on = b._gbdt._fused.ring.shape[1]
    seen.clear()
    plain = _train_t({}, rounds=3)
    assert seen and not any(seen)
    # the norms are the only addition: two f32 words a row
    assert plain._gbdt._fused.ring.shape[1] + 2 == rows_on


def test_abort_leaves_stream_and_manifest(tmp_path):
    X, y, Xv, yv = _data("regression")
    path = tmp_path / "diverge.jsonl"
    sinks = len(timer._trace_sinks)
    p = {"objective": "regression", "metric": "l2", "num_leaves": 7,
         "learning_rate": 5.0, "record_file": str(path),
         "anomaly_policy": "abort", "device_type": "cpu", **PINS}
    ds = lgb_t.Dataset(X, label=y, params=p)
    vs = lgb_t.Dataset(Xv, label=yv, reference=ds)
    with pytest.raises(AnomalyAbort) as ei:
        lgb_t.train(p, ds, 14, valid_sets=[vs], valid_names=["v"])
    assert ei.value.kind == "loss_spike" and ei.value.round_idx <= 10
    assert len(timer._trace_sinks) == sinks
    parsed = [json.loads(x) for x in path.read_text().splitlines()]
    assert parsed[-1]["round"] == ei.value.round_idx
    m = manifest.write_manifest(str(tmp_path / "m.json"))
    assert m["flight_recorder"]["anomalies"]["loss_spike"] == 1
    assert m["compile"] is None
    assert m["collectives"]["static_budget_wire_bytes"] is None
    assert {"torch", "cuda", "numpy", "python"} <= set(m["versions"])
    lgb_t.train({**p, "record_file": "", "anomaly_policy": "off"}, ds, 2)
    assert manifest.build_manifest().get("flight_recorder") is None


def test_tracing_spans_and_chrome_export(tmp_path):
    with tracing.tracing(chrome_path=str(tmp_path / "t.json"),
                         jsonl_path=str(tmp_path / "t.jsonl")) as rec:
        with timer.global_timer.scope("outer"):
            with tracing.span("inner", rows=3):
                pass
    names = [e["name"] for e in rec.events()]
    assert "outer" in names and "inner" in names
    assert tracing.active() is None and not timer._trace_sinks
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["traceEvents"][0]["ph"] == "M"
    assert all("ts" in e for e in trace["traceEvents"][1:])
