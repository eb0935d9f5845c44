"""Rules that keep later slices of the port honest: lightgbm_tpu_torch and
chip_smoke.py import neither jax nor lightgbm_tpu; without a card the
entry points refuse to run unless device_type=cpu is asked for; every
name of the JAX package is ported (NOT_PORTED is empty)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.learner.histogram import hist_nat_slots
from lightgbm_tpu_torch.learner.quantize import resolve_hist_dtype
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _port_files():
    files = sorted((ROOT / "lightgbm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_distributed_modules_import_no_jax_and_nothing_is_refused():
    """parallel/ and dask.py are scanned above, and importing them (and
    running the collective layer's set-up code) in a fresh interpreter
    loads no jax; NOT_PORTED is empty since A.8."""
    import subprocess
    import sys

    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"lightgbm_tpu_torch/dask.py",
            "lightgbm_tpu_torch/parallel/comm.py",
            "lightgbm_tpu_torch/parallel/data_parallel.py",
            "lightgbm_tpu_torch/parallel/feature_parallel.py",
            "lightgbm_tpu_torch/parallel/multihost.py"} <= names
    code = ("import sys, lightgbm_tpu_torch.parallel, lightgbm_tpu_torch.dask;"
            "from lightgbm_tpu_torch.parallel import multihost, comm;"
            "assert comm.make_mesh() is None;"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu')]")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    assert lgb.NOT_PORTED == {}


def _tiny():
    rs = np.random.RandomState(0)
    X = rs.randn(200, 3)
    return X, (X[:, 0] > 0).astype(float)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "gpu", "tpu"])
def test_train_without_card_raises(no_card, device):
    X, y = _tiny()
    params = {"objective": "binary", "verbosity": -1}
    if device is not None:
        params["device_type"] = device
    with pytest.raises(RuntimeError, match="device_type=cpu"):
        lgb.train(params, lgb.Dataset(X, label=y), 2)


@pytest.mark.parametrize("pins", [
    {"tpu_growth_mode": "exact"},
    {"tpu_growth_mode": "exact", "tpu_growth_rounds": True},
    {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2"},
], ids=["exact", "exact_rounds", "rounds_f32"])
def test_f32_paths_without_card_raise(no_card, pins):
    X, y = _tiny()
    params = {"objective": "binary", "verbosity": -1, **pins}
    with pytest.raises(RuntimeError, match="device_type=cpu"):
        lgb.train(params, lgb.Dataset(X, label=y), 2)


def test_dataset_construct_without_card_raises(no_card):
    X, y = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        lgb.Dataset(X, label=y).construct()


def test_cpu_must_be_asked_for(no_card):
    X, y = _tiny()
    p = {"objective": "binary", "verbosity": -1, "device_type": "cpu"}
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 2)
    assert bst.num_trees() == 2


def test_growth_mode_exact_raises():
    """The exact path trains, and so does the voting-parallel learner
    beside it since A.8: on one process it resolves to serial growth (as
    the JAX package does on one device) and grows the serial trees."""
    X, y = _tiny()
    p = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
         "tpu_growth_mode": "exact"}
    serial = lgb.train(p, lgb.Dataset(X, label=y, params=p), 1)
    assert serial.num_trees() == 1
    p = dict(p, tree_learner="voting")
    vote = lgb.train(p, lgb.Dataset(X, label=y, params=p), 1)
    assert vote._gbdt.tree_learner_resolved == "serial"
    np.testing.assert_array_equal(vote.predict(X), serial.predict(X))


@pytest.mark.parametrize("dtype,msg", [("bf16x2", "5-channel"),
                                       ("float32", "5-channel"),
                                       ("int8", "int8")])
def test_unported_hist_dtypes_raise(dtype, msg):
    """Every histogram channel layout is ported now: int8 takes the
    internal int-packed path at 127 levels, bf16x2 (alias float32) the
    f32 layout, and hist_nat's f32 mode (the percentile refit's, once
    the 5-channel mode) sums f32 channels instead of raising."""
    if dtype == "int8":
        assert resolve_hist_dtype(dtype, False, 4) == ("int8", 127), msg
        return
    assert resolve_hist_dtype(dtype, False, 4) == ("bf16x2", 0)
    out = hist_nat_slots(torch.zeros((1, 8), dtype=torch.int32),
                         torch.ones((3, 8)), torch.zeros(8, dtype=torch.int32),
                         1, 4, quant=False)
    assert out[0, :, 0, 0].tolist() == [8.0, 8.0, 8.0], msg


def test_auto_means_int16_everywhere():
    """`auto` is int16 on the rounds path on every device; the exact
    path's channels are always f32. Under use_quantized_grad the public
    levels govern: its default 4 levels ride int8."""
    assert resolve_hist_dtype("auto", False, 4) == ("int16", 256)
    assert resolve_hist_dtype("auto", False, 4, use_rounds=False) == \
        ("bf16x2", 0)
    assert resolve_hist_dtype("auto", True, 4) == ("int8", 0)


@pytest.mark.parametrize("extra", [
    {"num_machines": 2},
    {"tree_learner": "voting"},
    {"tree_learner": "voting", "monotone_constraints": [1, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"tree_learner": "feature", "monotone_constraints": [1, 0, 0],
     "monotone_constraints_method": "advanced"},
    {"tree_learner": "data"},
    {"tree_learner": "feature"},
    {"tree_learner": "data", "num_machines": 4},
])
def test_unported_options_raise(extra):
    """The distributed options are ported (A.8). num_machines > 1 joins
    a cluster, and with no machine list it raises as the JAX package's
    set_network does; on one process every tree learner trains serially
    (the JAX package on one device)."""
    X, y = _tiny()
    p = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
         **extra}
    if "num_machines" in extra:
        with pytest.raises(ValueError, match="machines"):
            lgb.train(p, lgb.Dataset(X, label=y, params=p), 1)
        return
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 1)
    assert bst._gbdt.tree_learner_resolved == "serial"
    assert bst.num_trees() == 1


@pytest.mark.parametrize("extra", [
    {"linear_tree": True},
    {"monotone_constraints": [1, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"monotone_constraints": [1, 0, 0],
     "monotone_constraints_method": "advanced"},
    {"tpu_debug_check_split": True},
    {"data_source": "chunked", "data_chunk_rows": 2048},
])
def test_formerly_refused_options_train(extra):
    """linear_tree, monotone intermediate / advanced,
    tpu_debug_check_split and data_source=chunked train now."""
    X, y = _tiny()
    p = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
         **extra}
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 2)
    assert bst.num_trees() == 2
    gb = bst._gbdt
    if "linear_tree" in extra:
        assert all(t.is_linear for t in gb.models)
        assert gb.fused_ineligible_reason() == \
            "linear_tree leaf fits run on host"
    elif "tpu_debug_check_split" in extra:
        assert gb.fused_ineligible_reason() == \
            "tpu_debug_check_split reads back per iteration"
    elif "data_source" in extra:
        ref = lgb.train({**p, "data_source": "memory"},
                        lgb.Dataset(X, label=y, params=p), 2)
        np.testing.assert_array_equal(bst.predict(X), ref.predict(X))
    else:
        assert gb.spec.mono_mode == {"intermediate": 1, "advanced": 2}[
            extra["monotone_constraints_method"]]


@pytest.mark.parametrize("key,value,item", [
    ("snapshot_freq", 1, "A.11"),
    ("resume", "auto", "A.11"),
    ("resume_from", "model.txt.ckpt", "A.11"),
    ("checkpoint_file", "ckpt.json", "A.11"),
    ("record_file", "rec.jsonl", "A.11"),
    ("anomaly_policy", "warn", "A.11"),
    ("anomaly_rollback_lr_decay", 0.5, "A.11"),
    ("anomaly_rollback_max", 3, "A.11"),
    ("fault_plan", "round:1:kill", "A.11"),
    ("data_source", "chunked", "A.10"),
    ("ram_budget_mb", 64, "A.10"),
])
def test_unported_keys_raise_naming_their_item(key, value, item, tmp_path,
                                               monkeypatch):
    """Keys the JAX package's engine.train acts on, each refused until it
    was ported and now acting: A.11's first half (checkpoints, resume,
    fault plans, the flight recorder, anomaly policies) trains and does
    what it says; A.10's data_source=chunked streams the Dataset through
    the data plane, and ram_budget_mb sizes its chunks."""
    X, y = _tiny()
    p = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
         key: value}
    if item == "A.10":
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.data import last_stats, reset_stats
        from lightgbm_tpu_torch.data.streaming import (StreamedBinnedDataset,
                                                       resolve_chunk_rows)

        reset_stats()
        p["data_source"] = "chunked"
        ds = lgb.Dataset(X, label=y, params=p)
        assert lgb.train(p, ds, 1).num_trees() == 1
        assert isinstance(ds._binned, StreamedBinnedDataset)
        st = last_stats()
        assert st["spool"]["rows"] == len(X)
        rows = resolve_chunk_rows(X.shape[1], Config(p))
        assert st["assemble"]["chunk_rows"] == rows
        if key == "ram_budget_mb":
            assert rows != resolve_chunk_rows(X.shape[1], Config({}))
        return
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LGBMTPU_FAULT_PLAN", raising=False)
    p.setdefault("snapshot_freq", 1)
    p["output_model"] = "model.txt"
    if key == "resume_from":  # the checkpoint it names, first
        lgb.train({**p, "resume_from": ""},
                  lgb.Dataset(X, label=y, params=p), 1)
    # round:1:kill would end this process at round 1: one round there
    rounds = 1 if key == "fault_plan" else 2
    b = lgb.train(p, lgb.Dataset(X, label=y, params=p), rounds)
    assert b.num_trees() == rounds
    assert (tmp_path / f"model.txt.snapshot_iter_{rounds}").exists()
    ckpt = tmp_path / ("ckpt.json" if key == "checkpoint_file"
                       else "model.txt.ckpt")
    assert json.loads(ckpt.read_text())["engine_round"] == rounds
    if key == "fault_plan":
        from lightgbm_tpu_torch.resilience import faultinject

        plan = faultinject.active()
        faultinject.disarm()
        assert plan.spec == value and not plan.clauses[0].done
    if key == "record_file":
        assert len((tmp_path / "rec.jsonl").read_text().splitlines()) == 3
    if key == "anomaly_policy":
        assert b.anomaly_summary == {"policy": "warn", "trips": {}}


@pytest.mark.parametrize("fused", [True, False])
def test_timetag_prints_the_timer_summary(capsys, fused):
    """timetag=true turns the phase timer on (timer.enable_timetag) and
    train prints its summary, on either loop; tpu_chunk_scan stays
    accepted."""
    from lightgbm_tpu_torch.timer import global_timer

    X, y = _tiny()
    p = {"objective": "binary", "verbosity": 1, "device_type": "cpu",
         "timetag": True, "tpu_chunk_scan": "off"}
    cbs = []
    if not fused:
        def before(env):
            pass
        before.before_iteration = True
        cbs = [before]
    try:
        global_timer.reset()
        lgb.train(p, lgb.Dataset(X, label=y, params=p), 2, callbacks=cbs)
    finally:
        global_timer.disable()
        global_timer.reset()
    out = capsys.readouterr().out
    assert "phase timings" in out
    assert ("fused dispatch" if fused else "update") in out
