"""The port's distributed learners (tree_learner=data / voting /
feature) on gloo ranks of the CPU, against the port's serial run and
the JAX package's learners.

Rank processes run tests/_torch_dist_worker.py (a file store under
tmp_path; each rank holds a contiguous block of the rows under data /
voting and bins it on the gathered sample). On the integer (int16 /
int8) rounds path and on the exact grower, whose f32 histograms cross
the wire as int64 fixed-point partials, N ranks grow the serial trees
bit for bit; the JAX package's learners (conftest's 8 virtual devices)
are held at tests/test_tree_learner_data.py's rtol 1e-4 / atol 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from _port_threads import one_torch_thread
from _torch_dist_worker import make_problem, spawn_ranks, trees_text

one_torch_thread()

BIN = ["binary", 600, 6, 3]
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2}

# cases held bit for bit at 2 and 4 ranks
BITWISE = [
    {"name": "binary", "problem": BIN, "params": BASE, "learner": "data",
     "rounds": 4},
    {"name": "regression_valid", "problem": ["regression", 700, 5, 4],
     "valid": ["regression", 200, 5, 5],
     "params": {"objective": "regression", "num_leaves": 15,
                "metric": "l2"}, "learner": "data", "rounds": 4},
    {"name": "multiclass", "problem": ["multiclass", 600, 5, 6],
     "params": {"objective": "multiclass", "num_class": 3, "num_leaves": 7},
     "learner": "data", "rounds": 3},
    {"name": "quantized_rs", "problem": ["binary", 800, 6, 11],
     "params": {"objective": "binary", "num_leaves": 15,
                "use_quantized_grad": True, "num_grad_quant_bins": 4},
     "learner": "data", "rounds": 4},
    {"name": "voting_saturated", "problem": BIN,
     "params": {**BASE, "top_k": 12}, "learner": "voting", "rounds": 4},
    {"name": "exact", "problem": BIN,
     "params": {**BASE, "tpu_growth_mode": "exact"}, "learner": "data",
     "rounds": 3},
    {"name": "feature", "problem": ["binary", 600, 7, 3],
     "params": {**BASE, "enable_bundle": False}, "learner": "feature",
     "rounds": 3},
]
# further statistics made global, held bit for bit at 2 ranks
EXTRA = [
    {"name": "bagging", "problem": ["binary", 700, 6, 8],
     "params": {**BASE, "bagging_fraction": 0.7, "bagging_freq": 1},
     "learner": "data", "rounds": 3},
    {"name": "goss", "problem": ["binary", 700, 6, 8],
     "params": {**BASE, "data_sample_strategy": "goss"},
     "learner": "data", "rounds": 3},
    {"name": "l1_refit", "problem": ["regression", 700, 5, 4],
     "params": {"objective": "regression_l1", "num_leaves": 15},
     "learner": "data", "rounds": 3},
    {"name": "lambdarank", "problem": ["lambdarank", 600, 5, 9],
     "params": {"objective": "lambdarank", "num_leaves": 15},
     "learner": "data", "rounds": 3},
    {"name": "exact_rounds", "problem": BIN,
     "params": {**BASE, "tpu_growth_mode": "exact",
                "tpu_growth_rounds": True}, "learner": "data", "rounds": 3},
    {"name": "voting_exact", "problem": BIN,
     "params": {**BASE, "top_k": 12, "tpu_growth_mode": "exact"},
     "learner": "voting", "rounds": 3},
    {"name": "data_for_voting", "problem": BIN, "params": BASE,
     "learner": "data", "rounds": 3},
    {"name": "voting_top2", "problem": BIN, "params": {**BASE, "top_k": 2},
     "learner": "voting", "rounds": 3},
]
CASES = {c["name"]: c for c in BITWISE + EXTRA}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: {case: [rank outputs]}}: one spawn of 2 ranks over every
    case, one of 4 over the bitwise ones."""
    return {2: spawn_ranks(tmp_path_factory.mktemp("r2"), 2,
                           BITWISE + EXTRA),
            4: spawn_ranks(tmp_path_factory.mktemp("r4"), 4, BITWISE)}


_SERIAL = {}


def _eager(env):
    """A before-iteration callback: keeps the serial run on the eager
    loop, which the ranks take (their collectives run there), so the
    host metrics compare bit for bit too."""


_eager.before_iteration = True


def _serial(name):
    """The port's serial run of a case (cached): every row in one
    process, the same params without the tree learner; feature's serial
    counterpart is the exact grower, which it rides."""
    if name not in _SERIAL:
        c = CASES[name]
        X, y, g = make_problem(*c["problem"])
        p = {**c["params"], "device_type": "cpu", "verbosity": -1}
        if c["learner"] == "feature":
            p["tpu_growth_mode"] = "exact"
        ds = lgb_t.Dataset(X, label=y, group=g, params=p)
        kw = {}
        if c.get("valid"):
            Xv, yv, gv = make_problem(*c["valid"])
            kw = dict(valid_sets=[lgb_t.Dataset(Xv, label=yv, group=gv,
                                                reference=ds)],
                      valid_names=["v"], evals_result={})
        bst = lgb_t.train(p, ds, c["rounds"], callbacks=[_eager], **kw)
        _SERIAL[name] = (bst, X, kw.get("evals_result"))
    return _SERIAL[name]


def _assert_bitwise(name, outs):
    bst, X, ev = _serial(name)
    want = trees_text(bst.model_to_string())
    pred = bst.predict(X)
    for r, o in enumerate(outs):
        assert o["trees"] == want, f"rank {r}"
        np.testing.assert_array_equal(np.asarray(o["pred"]), pred)
        if ev is not None:
            assert o["evals"] == ev


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [c["name"] for c in BITWISE])
def test_ranks_grow_the_serial_trees_bitwise(name, world, runs):
    outs = runs[world][name]
    _assert_bitwise(name, outs)
    want = {"voting": "voting", "feature": "feature"}.get(
        CASES[name]["learner"], "data")
    assert all(o["resolved"] == want and o["world"] == world for o in outs)


@pytest.mark.parametrize("name", ["bagging", "goss", "l1_refit",
                                  "lambdarank", "exact_rounds",
                                  "voting_exact"])
def test_global_statistics_bitwise_at_two_ranks(name, runs):
    """Bagging and GOSS masks drawn over the gathered rows, the L1
    refit's reduced range / totals / bin sums, query-aligned ranker
    blocks, the exact grower's round phase and its per-split voting."""
    _assert_bitwise(name, runs[2][name])


def test_quantized_rides_the_reduce_scatter(runs):
    """use_quantized_grad's int8 levels take use_rs: the histograms
    cross as an integer reduce-scatter with per-rank feature ownership,
    and no histogram is all-reduced whole."""
    for world in (2, 4):
        for o in runs[world]["quantized_rs"]:
            calls = o["stats"]["calls"]
            assert calls["reduce_scatter"] >= 4 * 2  # a root, a round a tree
            assert o["stats"]["total_bytes"] > 0


def test_eager_loop_and_the_manifest_under_a_mesh(runs):
    """A mesh keeps the eager loop (its collectives are not captured),
    and the run manifest reads the resolved learner and the wire the
    data-parallel grower counted (4 trees of the binary case), where it
    read a fixed 0 before the distributed learners."""
    for name, learner in (("binary", "data"), ("feature", "feature")):
        for o in runs[2][name]:
            assert o["fused_reason"].startswith("distributed runs")
            assert o["manifest_learner"] == learner
    for o in runs[2]["binary"]:
        assert o["manifest_wire"] >= 4 * o["wire_est"] > 0


def test_voting_saturated_matches_data(runs):
    """test_voting_on_rounds_matches_data_saturated's check: with top_k
    at least the features the election keeps every column, and voting
    grows data's trees (here bit for bit); with top_k = 2 it elects 4
    columns a round and only those cross the wire."""
    vote = runs[2]["voting_saturated"][0]
    data = runs[2]["data_for_voting"][0]
    # voting_saturated grows 4 trees, data_for_voting 3
    assert vote["trees"].split("Tree=3")[0] == data["trees"]
    assert vote["elected"] == 6
    small = runs[2]["voting_top2"]
    assert all(o["resolved"] == "voting" and o["elected"] == 4
               for o in small)
    assert small[0]["trees"] == small[1]["trees"]


# ------------------------------------------------ against the JAX package
_PIN = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16"}


@pytest.mark.parametrize("learner,case", [
    ("data", "data_for_voting"), ("voting", "voting_saturated"),
    ("feature", "feature")])
def test_predictions_match_the_jax_learners(learner, case, runs):
    """The port's ranks against the JAX package's learner over its 8
    virtual devices on the same rows and params: predictions within
    rtol 1e-4 / atol 1e-5, the same resolved learner, and the same wire
    estimate a tree (the JAX formula counts 4-byte lanes, which the
    port's int32 wire fills)."""
    c = CASES[case]
    params = {**c["params"], "tree_learner": learner, "verbosity": -1}
    if learner != "feature":
        params.update(_PIN)
    X, y, _ = make_problem(*c["problem"])
    bj = lgb_j.train(params, lgb_j.Dataset(X, label=y, free_raw_data=False),
                     num_boost_round=c["rounds"])
    gj = bj._gbdt
    assert gj.tree_learner_resolved == learner
    for o in runs[2][case]:
        np.testing.assert_allclose(np.asarray(o["pred"]), bj.predict(X),
                                   rtol=1e-4, atol=1e-5)
        assert o["resolved"] == gj.tree_learner_resolved
        if learner != "feature":
            F = int(gj.dev["bins"].shape[0])
            assert o["wire_est"] == gj._dp.wire_bytes_per_tree(F)
        if learner == "voting":
            assert o["elected"] == gj.voting_elected_cols
