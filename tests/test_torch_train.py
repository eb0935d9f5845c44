"""End to end: lightgbm_tpu_torch.train (device_type=cpu: the kernels'
plain versions) against lightgbm_tpu.train on tiny binary, regression and
multiclass cases, both pinned to the rounds grower and int16 levels (off
the chip the JAX package's `auto` resolves elsewhere). The tree sections
of the model text have the same structure, leaf values agree within rtol
1e-5, raw predictions within 1e-5, and the port loads the JAX package's
model text and predicts the same."""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.convert import booster_from_model_string

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}


def _data(task, n=800, f=6, seed=7):
    rs = np.random.RandomState(seed)
    X = rs.randn(n + 200, f)
    X[rs.rand(n + 200, f) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(f)
    if task == "binary":
        y = (z + 0.3 * rs.randn(n + 200) > 0).astype(float)
    elif task == "regression":
        y = z + 0.1 * rs.randn(n + 200)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


CASES = {
    "binary": ({"objective": "binary", "num_leaves": 15,
                "min_data_in_leaf": 5, "metric": "auc"}, 6),
    "regression": ({"objective": "regression", "num_leaves": 31,
                    "min_data_in_leaf": 5, "learning_rate": 0.2}, 5),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "min_data_in_leaf": 10}, 4),
}

_STRUCT = ("num_leaves", "split_feature", "threshold", "decision_type",
           "left_child", "right_child", "leaf_count", "internal_count")


def _trees(text):
    trees, cur = [], None
    for line in text.split("end of trees")[0].splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    return trees


@pytest.fixture(scope="module", params=list(CASES))
def trained(request):
    task = request.param
    params, rounds = CASES[task]
    X, y, Xv, yv = _data(task)
    pj = {**params, **PINS}
    pt = {**params, **PINS, "device_type": "cpu"}
    ev_j, ev_t = {}, {}
    bj = lgb_j.train(pj, lgb_j.Dataset(X, label=y), rounds,
                     valid_sets=[lgb_j.Dataset(Xv, label=yv)],
                     valid_names=["v"],
                     callbacks=[lgb_j.record_evaluation(ev_j)])
    dt = lgb_t.Dataset(X, label=y, params={"device_type": "cpu"})
    bt = lgb_t.train(pt, dt, rounds,
                     valid_sets=[lgb_t.Dataset(Xv, label=yv, reference=dt)],
                     valid_names=["v"], evals_result=ev_t)
    return task, bj, bt, Xv, ev_j, ev_t


def test_tree_structure_equal(trained):
    _, bj, bt, *_ = trained
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    for a, b in zip(tj, tt):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k


def test_leaf_values_close(trained):
    _, bj, bt, *_ = trained
    for a, b in zip(_trees(bj.model_to_string()),
                    _trees(bt.model_to_string())):
        va = np.array(a["leaf_value"].split(), float)
        vb = np.array(b["leaf_value"].split(), float)
        np.testing.assert_allclose(vb, va, rtol=1e-5, atol=1e-7)


def test_raw_predictions_close(trained):
    _, bj, bt, Xv, *_ = trained
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)


def test_eval_records_close(trained):
    *_, ev_j, ev_t = trained
    for metric, vals in ev_j["v"].items():
        np.testing.assert_allclose(ev_t["v"][metric], vals, rtol=1e-4,
                                   atol=1e-6, err_msg=metric)


def test_port_loads_jax_model_text(trained):
    _, bj, _, Xv, *_ = trained
    b = booster_from_model_string(bj.model_to_string())
    np.testing.assert_allclose(b.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-9)
    np.testing.assert_allclose(b.predict(Xv), bj.predict(Xv), atol=1e-9)


def test_model_text_round_trip(trained, tmp_path):
    _, _, bt, Xv, *_ = trained
    path = tmp_path / "model.txt"
    bt.save_model(path)
    loaded = lgb_t.Booster(model_file=path)
    np.testing.assert_array_equal(loaded.predict(Xv), bt.predict(Xv))


EDGE = {
    "no_split_possible": ({"objective": "binary", "min_data_in_leaf": 200},
                          {}),
    "weighted": ({"objective": "regression", "num_leaves": 7},
                 {"weight": True}),
    "two_leaves": ({"objective": "binary", "num_leaves": 2}, {}),
    "init_score": ({"objective": "binary", "num_leaves": 5},
                   {"init_score": True}),
}


@pytest.mark.parametrize("case", list(EDGE))
def test_edge_cases_match(case):
    """The stop rule (no leaf can split: one constant tree carrying the
    boost-from-average bias), sample weights, the smallest tree and a
    given init_score: same trees and raw predictions as lightgbm_tpu."""
    params, extra = EDGE[case]
    rs = np.random.RandomState(0)
    X = rs.randn(300, 4)
    z = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(300)
    y = z if params["objective"] == "regression" else (z > 0).astype(float)
    kw = {}
    if extra.get("weight"):
        kw["weight"] = rs.rand(300) + 0.5
    if extra.get("init_score"):
        kw["init_score"] = 0.3 * rs.randn(300)
    bj = lgb_j.train({**params, **PINS}, lgb_j.Dataset(X, label=y, **kw), 4)
    pt = {**params, **PINS, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt, **kw), 4)
    assert bt.num_trees() == bj.num_trees()
    for a, b in zip(_trees(bj.model_to_string()),
                    _trees(bt.model_to_string())):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
