"""Crash-consistent checkpoints, resume, fault injection, anomaly rollback
and the serving host fallback in lightgbm_tpu_torch, against the JAX
package on the same seeded inputs (JAX on the CPU).

- the checkpoint file (schema lightgbm-tpu/checkpoint/v1): round trip,
  corrupt / alien / missing files, the fingerprint, the eval history;
  a checkpoint written by either package loads in the other, and a JAX
  training checkpoint resumes in the port;
- the fault-plan grammar parses as the JAX package parses it, clauses
  fire once at their trigger, the env var arms a plan;
- a crash at round 7 (checkpoint at 5), then resume=auto: the model
  text is bit for bit an uninterrupted port run's, on the eager loop and
  on the fused loop (its graph's bounded loops), with the eval history
  replayed into record_evaluation; against the JAX package's resumed
  run the trees have the same structure and leaf values within the
  parity tolerance (pins rounds / int16); a SIGKILL through the port's
  command line resumes to the same model file;
- anomaly_policy=rollback after an injected NaN metric retrains from the
  checkpoint with a decayed learning rate;
- serving: device_put faults answered by the host fallback as the device
  answers them (and as the JAX package's fallback does), counted on
  /metrics; without the fallback the fault propagates; an out-of-memory
  copy is answered too, while a capture or launch error propagates with
  the fallback on and turns /readyz not ready; serve_request and
  fleet_page faults.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.resilience import checkpoint as ckpt_j
from lightgbm_tpu.resilience import faultinject as fi_j
from lightgbm_tpu_torch.learner import device_loop
from lightgbm_tpu_torch import boosting
from lightgbm_tpu_torch.resilience import checkpoint as ckpt
from lightgbm_tpu_torch.resilience import faultinject as fi
from lightgbm_tpu_torch.resilience.errors import CheckpointError, InjectedFault
from test_torch_sampling import assert_same_sampled_models
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

REPO = Path(__file__).resolve().parents[1]
PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
# relative output_model, a fault plan only through the env var: the model
# text holds the explicit params, which the runs compared must share
RESUME = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
          "min_data_in_leaf": 5, "seed": 7, "bagging_fraction": 0.7,
          "bagging_freq": 1, "snapshot_freq": 5, "resume": "auto",
          "output_model": "model.txt", "metric": "binary_logloss", **PINS}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fi.disarm()
    fi_j.disarm()


def _no_op(env):
    """Keeps train() on the eager loop."""


_no_op.before_iteration = True


# ---------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_errors(tmp_path):
    path = str(tmp_path / "c.ckpt")
    hist = [[("v", "auc", 0.5, True)], [("v", "auc", 0.75, True)]]
    ckpt.save_checkpoint(path, "tree\nmodel", engine_round=2, total_iters=2,
                         eval_history=hist, record_offset=99,
                         fingerprint="ab", extra={"train_padding_score":
                                                 [0.25]})
    st = ckpt.load_checkpoint(path)
    assert st["schema"] == "lightgbm-tpu/checkpoint/v1"
    assert st["eval_history"] == hist and st["record_offset"] == 99
    assert st["train_padding_score"] == [0.25]
    assert not os.path.exists(path + ".tmp")
    (tmp_path / "torn.ckpt").write_text('{"schema": "lightgbm-tp')
    (tmp_path / "alien.ckpt").write_text('{"schema": "other/v9"}')
    for bad in ("torn.ckpt", "alien.ckpt", "missing.ckpt"):
        with pytest.raises(CheckpointError):
            ckpt.load_checkpoint(str(tmp_path / bad))
    assert ckpt.find_resume_checkpoint("auto", "",
                                       str(tmp_path / "none")) == (None, None)
    with pytest.raises(CheckpointError):
        ckpt.find_resume_checkpoint("off", str(tmp_path / "none"), "")
    assert ckpt.truncate_eval_history(hist, 1) == hist[:1]


@pytest.mark.parametrize("params", [
    {"objective": "binary", "num_leaves": 7},
    {"objective": "binary", "num_leaves": 7, "learning_rate": 0.5,
     "resume": "auto", "fault_plan": "round:1:kill"},
    {"objective": "regression", "anomaly_policy": "rollback"}])
def test_fingerprint_and_schema_match_jax(params):
    assert ckpt.SCHEMA == ckpt_j.SCHEMA
    assert ckpt.config_fingerprint(params) == \
        ckpt_j.config_fingerprint(params)
    assert ckpt.config_fingerprint(params) == ckpt.config_fingerprint(
        {**params, "learning_rate": 9.0, "resume_from": "x.ckpt"})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    save = (ckpt_j if writer == "jax" else ckpt).save_checkpoint
    load = (ckpt if writer == "jax" else ckpt_j).load_checkpoint
    path = str(tmp_path / "c.ckpt")
    hist = [[("v", "l2", 0.1 * r, False)] for r in range(3)]
    save(path, "tree\nx", engine_round=3, total_iters=4, eval_history=hist,
         fingerprint="f00d", extra={"train_padding_score": [1.5, -2.0]})
    st = load(path)
    assert (st["engine_round"], st["total_iters"], st["model"],
            st["fingerprint"]) == (3, 4, "tree\nx", "f00d")
    assert st["eval_history"] == hist


# ----------------------------------------------------------- fault plans
@pytest.mark.parametrize("spec", [
    "round:7:kill; device_put:1:raise, serve_request:2:delay:0.25",
    "loop_refit:0:raise;gw_connect:3:delay:0.5", "round:0:raise"])
def test_fault_plan_parses_as_jax(spec):
    assert [repr(c) for c in fi.FaultPlan(spec).clauses] == \
        [repr(c) for c in fi_j.FaultPlan(spec).clauses]


@pytest.mark.parametrize("bad", ["round:7", "nowhere:1:raise",
                                 "round:1:explode", "serve_request:1:delay"])
def test_fault_plan_refuses_as_jax(bad):
    for mod in (fi, fi_j):
        with pytest.raises(ValueError):
            mod.FaultPlan(bad)


def test_fault_plan_triggers_once_and_env(monkeypatch):
    plan = fi.arm("round:5:raise; serve_request:2:raise; fleet_page:1:raise")
    plan.visit("round", index=4)
    with pytest.raises(InjectedFault):
        plan.visit("round", index=5)
    plan.visit("round", index=5)  # consumed
    plan.visit("serve_request")
    with pytest.raises(InjectedFault):
        fi.fault_point("serve_request")
    with pytest.raises(InjectedFault):
        fi.fault_point("fleet_page")
    fi.disarm()
    fi.fault_point("round", 5)  # no plan: nothing
    monkeypatch.setenv(fi.ENV_VAR, "round:1:raise")
    assert fi.configure("").spec == "round:1:raise"
    assert fi.configure("round:9:raise").spec == "round:9:raise"
    monkeypatch.delenv(fi.ENV_VAR)
    assert fi.configure("") is None and fi.active() is None


# ------------------------------------------------------- crash / resume
def _train_t(d, monkeypatch, plan=None, fused=True, rounds=10, **extra):
    monkeypatch.chdir(d)
    if plan:
        monkeypatch.setenv(fi.ENV_VAR, plan)
    else:
        monkeypatch.delenv(fi.ENV_VAR, raising=False)
    X, y, Xv, yv = _data("binary")
    p = {**RESUME, **extra, "device_type": "cpu"}
    ds = lgb_t.Dataset(X, label=y, params=p)
    vs = lgb_t.Dataset(Xv, label=yv, reference=ds)
    hist = {}
    cbs = [lgb_t.record_evaluation(hist)] + ([] if fused else [_no_op])
    b = lgb_t.train(p, ds, rounds, valid_sets=[vs], valid_names=["v"],
                    callbacks=cbs)
    return b, hist


@pytest.mark.parametrize("loop", ["eager", "fused"])
def test_crash_resume_bit_identical(tmp_path, monkeypatch, loop):
    monkeypatch.setattr(boosting._FusedProgram, "cpu_loop",
                        device_loop.BOUNDED)
    fused = loop == "fused"
    crashed, clean = tmp_path / "crashed", tmp_path / "clean"
    crashed.mkdir()
    clean.mkdir()
    with pytest.raises(InjectedFault):
        _train_t(crashed, monkeypatch, "round:7:raise", fused)
    st = ckpt.load_checkpoint(str(crashed / "model.txt.ckpt"))
    assert st["engine_round"] == 5 and len(st["eval_history"]) == 5
    assert st["train_padding_score"] is not None
    resumed, hist_r = _train_t(crashed, monkeypatch, fused=fused)
    whole, hist_c = _train_t(clean, monkeypatch, fused=fused)
    assert resumed._gbdt._fused is not None if fused else \
        resumed._gbdt._fused is None
    assert resumed.model_to_string() == whole.model_to_string()
    assert hist_r == hist_c and len(hist_r["v"]["binary_logloss"]) == 10
    assert (crashed / "model.txt.snapshot_iter_10").read_text() == \
        (clean / "model.txt.snapshot_iter_10").read_text()
    again, _ = _train_t(crashed, monkeypatch, fused=fused)  # 0 rounds left
    assert again.model_to_string() == whole.model_to_string()


def test_resume_trees_match_jax_resume(tmp_path, monkeypatch):
    """Both packages crash at round 7 and resume; the trees agree as the
    parity tests hold them (the JAX package's own resume is not bit for
    bit its uninterrupted run: ROADMAP C)."""
    X, y, Xv, yv = _data("binary")
    out = {}
    for name, lgb, fim in (("jax", lgb_j, fi_j), ("port", lgb_t, fi)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        p = dict(RESUME)
        if lgb is lgb_t:
            p["device_type"] = "cpu"
        cbs = [_no_op] if lgb is lgb_j else []
        for plan in ("round:7:raise", None):
            if plan:
                monkeypatch.setenv(fim.ENV_VAR, plan)
            else:
                monkeypatch.delenv(fim.ENV_VAR, raising=False)
            ds = lgb.Dataset(X, label=y, params={"device_type": "cpu"}
                             if lgb is lgb_t else None)
            try:
                out[name] = lgb.train(p, ds, 10, callbacks=cbs)
            except Exception as e:  # the planned fault
                assert "round:7:raise" in str(e)
    assert out["port"].num_trees() == out["jax"].num_trees() == 10
    assert_same_sampled_models(out["jax"], out["port"], X, Xv)


def test_port_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    X, y, Xv, _ = _data("binary")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(fi_j.ENV_VAR, "round:7:raise")
    with pytest.raises(Exception, match="round:7:raise"):
        lgb_j.train(dict(RESUME), lgb_j.Dataset(X, label=y), 10,
                    callbacks=[_no_op])
    monkeypatch.delenv(fi_j.ENV_VAR)
    p = {**RESUME, "device_type": "cpu"}
    b = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 10)
    assert b.num_trees() == 10
    st = ckpt.load_checkpoint("model.txt.ckpt")
    assert st["engine_round"] == 10 and "train_padding_score" in st
    head = lgb_t.Booster(model_str=ckpt_j.load_checkpoint(
        "model.txt.ckpt")["model"])
    jax_head = lgb_j.Booster(model_file="model.txt.snapshot_iter_5")
    np.testing.assert_allclose(
        head.predict(Xv, raw_score=True, num_iteration=5),
        jax_head.predict(Xv, raw_score=True), rtol=1e-6, atol=1e-6)


def test_sigkill_cli_resume(tmp_path):
    """A CLI training process killed by SIGKILL at round 7 resumes with
    resume=auto to the uninterrupted run's model file, byte for byte."""
    rs = np.random.RandomState(3)
    X = rs.randn(500, 5)
    y = ((X @ rs.randn(5)) > 0).astype(float)
    conf = ("task = train\ndata = train.tsv\nobjective = binary\n"
            "num_leaves = 15\nnum_trees = 8\nmin_data_in_leaf = 5\n"
            "bagging_fraction = 0.7\nbagging_freq = 1\nsnapshot_freq = 3\n"
            "resume = auto\noutput_model = model.txt\nverbosity = -1\n"
            "device_type = cpu\ntpu_growth_mode = rounds\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop(fi.ENV_VAR, None)

    def run(d, plan=None):
        e = dict(env, **({fi.ENV_VAR: plan} if plan else {}))
        return subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                               "config=train.conf"], cwd=d, env=e,
                              capture_output=True, text=True, timeout=300)

    for d in ("crashed", "clean"):
        (tmp_path / d).mkdir()
        np.savetxt(tmp_path / d / "train.tsv", np.column_stack([y, X]),
                   delimiter="\t", fmt="%.8g")
        (tmp_path / d / "train.conf").write_text(conf)
    p = run(tmp_path / "crashed", "round:7:kill")
    assert p.returncode == -9, p.stderr
    assert not (tmp_path / "crashed" / "model.txt").exists()
    assert ckpt.load_checkpoint(str(tmp_path / "crashed" / "model.txt.ckpt")
                                )["engine_round"] == 6
    for d in ("crashed", "clean"):
        q = run(tmp_path / d)
        assert q.returncode == 0, q.stderr
    assert (tmp_path / "crashed" / "model.txt").read_bytes() == \
        (tmp_path / "clean" / "model.txt").read_bytes()


# ------------------------------------------------------ anomaly rollback
def test_rollback_after_injected_nan(tmp_path):
    """A custom metric returns NaN once, at round 3: nan_metric trips,
    the run restores the checkpoint of round 2 and trains on with the
    learning rate halved; the trees up to the checkpoint are the
    uninterrupted run's."""
    X, y, Xv, yv = _data("regression")
    calls = []

    def feval(preds, data):
        calls.append(1)
        v = float("nan") if len(calls) == 4 else float(
            np.mean((preds - data.get_label()) ** 2))
        return "mse", v, False

    p = {"objective": "regression", "num_leaves": 7, "device_type": "cpu",
         "learning_rate": 0.2, "snapshot_freq": 2,
         "anomaly_policy": "rollback", "anomaly_rollback_lr_decay": 0.5,
         "anomaly_rollback_max": 1, "output_model": str(tmp_path / "m.txt"),
         "record_file": str(tmp_path / "r.jsonl"), **PINS}
    ds = lgb_t.Dataset(X, label=y, params=p)
    vs = lgb_t.Dataset(Xv, label=yv, reference=ds)
    b = lgb_t.train(p, ds, 6, valid_sets=[vs], valid_names=["v"],
                    feval=feval)
    assert b.num_trees() == 6
    assert "[learning_rate: 0.1]" in b.model_to_string()
    assert b.anomaly_summary["trips"] == {}
    plain = {k: v for k, v in p.items() if k not in (
        "anomaly_policy", "record_file")}
    ref = lgb_t.train(plain, lgb_t.Dataset(X, label=y, params=p), 2)
    for t in range(2):
        np.testing.assert_array_equal(b._gbdt.models[t].leaf_value,
                                      ref._gbdt.models[t].leaf_value)
    from lightgbm_tpu_torch.obs.recorder import read_stream

    assert [r["round"] for r in read_stream(str(tmp_path / "r.jsonl"))] \
        == list(range(6))
    # without a checkpoint the policy is abort
    from lightgbm_tpu_torch.obs.anomaly import AnomalyAbort

    calls.clear()
    with pytest.raises(AnomalyAbort):
        lgb_t.train({**p, "snapshot_freq": -1}, ds, 6, valid_sets=[vs],
                    valid_names=["v"], feval=feval)


# --------------------------------------------------------------- serving
def _model_text():
    rs = np.random.RandomState(5)
    X = rs.randn(600, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    b = lgb_j.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1}, lgb_j.Dataset(X, label=y), 6)
    return b.model_to_string(), X


def test_device_fault_host_fallback_parity():
    from lightgbm_tpu.serving import ModelRegistry as RegJ
    from lightgbm_tpu_torch.obs.metrics import default_registry
    from lightgbm_tpu_torch.serving import ModelRegistry

    text, X = _model_text()
    reg = ModelRegistry(device="cpu", buckets=(8, 32), host_fallback=True)
    reg.load("m", text)
    want = reg.predict("m", X[:20], raw_score=True)
    leaves = reg.predict("m", X[:20], pred_leaf=True)
    before = default_registry().snapshot().get(
        "lgbmtpu_serve_host_fallback_total", {})
    fi.arm("device_put:1:raise")
    got = reg.predict("m", X[:20], raw_score=True)
    fi.arm("device_put:1:raise")
    got_leaf = reg.predict("m", X[:20], pred_leaf=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_leaf, leaves)
    after = default_registry().snapshot()["lgbmtpu_serve_host_fallback_total"]
    assert sum(after.values()) == sum(before.values()) + 2
    # the JAX package's registry answers a faulted request the same way
    rj = RegJ(buckets=(8, 32))
    rj.load("m", text)
    fi_j.arm("device_put:1:raise")
    np.testing.assert_allclose(got, rj.predict("m", X[:20], raw_score=True),
                               rtol=1e-5, atol=1e-6)
    # without the fallback the fault is the request's error
    plain = ModelRegistry(device="cpu", buckets=(8, 32))
    plain.load("m", text)
    fi.arm("device_put:1:raise")
    with pytest.raises(InjectedFault):
        plain.predict("m", X[:3])


@pytest.mark.parametrize("where", ["capture", "launch", "copy_oom"])
def test_fallback_answers_only_copy_faults(monkeypatch, where):
    """host_fallback answers a chunk whose host-to-device copy failed (an
    out-of-memory copy here) and nothing else: an error of the program's
    build (the capture on the card) or of its launch propagates even with
    the fallback, is kept in device_faults() and turns /readyz not
    ready."""
    from lightgbm_tpu_torch.obs.metrics import default_registry
    from lightgbm_tpu_torch.serving import ModelFleet, ModelRegistry, dispatch
    from lightgbm_tpu_torch.serving.server import readiness

    text, X = _model_text()
    base = ModelRegistry(device="cpu", buckets=(8, 32))
    base.load("m", text)
    want = base.predict("m", X[:20], raw_score=True)
    err = RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")

    def boom(*a, **k):
        raise err

    def oom(site, index=None):
        if site == "device_put":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    for reg in (ModelRegistry(device="cpu", buckets=(8, 32),
                              host_fallback=True),
                ModelFleet(device="cpu", buckets=(8, 32),
                           host_fallback=True)):
        reg.load("m", text)
        reg.predict("m", X[:2])  # built (the fleet: paged in)
        count = lambda: sum(default_registry().snapshot().get(
            "lgbmtpu_serve_host_fallback_total", {}).values())
        before = count()
        with monkeypatch.context() as m:
            if where == "capture":
                m.setattr(dispatch.BucketDispatcher, "_program", boom)
            elif where == "launch":
                m.setattr(type(_forest_of(reg)), "apply", boom)
            else:
                m.setattr(dispatch, "fault_point", oom)
            if where == "copy_oom":
                got = reg.predict("m", X[:20], raw_score=True)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
                assert count() == before + 1
                assert reg.device_faults() == {}
                assert readiness(reg)["ok"]
                continue
            with pytest.raises(RuntimeError, match="illegal memory"):
                reg.predict("m", X[:20], raw_score=True)
        assert count() == before
        assert list(reg.device_faults()) == ["m:v1"]
        assert "illegal memory" in reg.device_faults()["m:v1"]
        ready = readiness(reg)
        assert not ready["ok"] and ready["reason"] == "device fault"


def _forest_of(reg):
    """The forest a registry's or a fleet's model "m" scores with."""
    if hasattr(reg, "_entry"):
        return reg._entry("m").forest
    return reg._names["m"]["versions"][0].forest


def test_serve_request_and_fleet_page_faults():
    from lightgbm_tpu_torch.serving import ModelFleet, ModelRegistry
    from lightgbm_tpu_torch.serving.server import handle_request

    text, X = _model_text()
    reg = ModelRegistry(device="cpu", buckets=(8,))
    reg.load("m", text)
    fi.arm("serve_request:2:raise")
    ok = handle_request(reg, {"op": "ping"})
    bad = handle_request(reg, {"op": "ping"})
    assert ok["ok"] and not bad["ok"] and bad["error_kind"] == "fault"
    fleet = ModelFleet(device="cpu", buckets=(8,), capacity=1,
                       host_fallback=True)
    fleet.load("a", text)
    fi.arm("fleet_page:1:raise")
    with pytest.raises(InjectedFault):
        fleet.predict("a", X[:2])
    np.testing.assert_allclose(fleet.predict("a", X[:2], raw_score=True),
                               reg.predict("m", X[:2], raw_score=True),
                               rtol=1e-6)
    fi.arm("device_put:1:raise")
    np.testing.assert_allclose(fleet.predict("a", X[:2], raw_score=True),
                               reg.predict("m", X[:2], raw_score=True),
                               rtol=1e-5, atol=1e-6)


def test_fallback_never_hides_a_missing_card(monkeypatch):
    """A fallback registry asked for the card without one raises at
    construction: the host path answers only a chunk whose host-to-device
    copy failed."""
    from lightgbm_tpu_torch.serving import ModelRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ModelRegistry(host_fallback=True)
