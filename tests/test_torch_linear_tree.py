"""Linear trees (linear_tree=true), training: lightgbm_tpu_torch against
lightgbm_tpu on the same seeded inputs (test_torch_train._data, 5% NaNs),
JAX on the CPU, both pinned to the rounds grower and int16 levels (or the
exact grower).

- regression and binary, with bagging's row mask, with a categorical
  column (kept off the leaves' paths) and at several linear_lambda: the
  same trees, each leaf's path features equal, its constant within
  rtol 1e-6 (atol 1e-9) of the JAX package's and its coefficients within
  1e-6 of its largest one (a solve moves a small coefficient as much as a
  large one),
  validation scores and raw predictions within 1e-6. The binary
  objective's f32 gradients differ from the JAX package's in the last
  bit on a few rows (the sigmoid's exp), which the ridge solves of later
  trees magnify, so binary trees are also compared one at a time, each
  grown by both packages from the JAX model's scores before it;
- the train score equals a fresh predict(raw_score=True) within 1e-5,
  the model text round trip is identical and predicts the same, both
  packages load each other's text, the loop is the eager one with the
  JAX package's reason, pred_contrib stays fatal, and a dataset built
  without raw values is refused.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.convert import booster_from_model_string
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
ROUNDS = 5
BASE = {
    "regression": {"objective": "regression", "num_leaves": 15,
                   "min_data_in_leaf": 20, "learning_rate": 0.2},
    "binary": {"objective": "binary", "num_leaves": 15,
               "min_data_in_leaf": 20},
}
CASES = {
    "regression": ("regression", {"linear_lambda": 0.1}),
    "binary": ("binary", {"linear_lambda": 1.0}),
    "regression_no_lambda": ("regression", {}),
    "regression_bagging": ("regression", {"linear_lambda": 0.1,
                                          "bagging_fraction": 0.7,
                                          "bagging_freq": 1}),
    "binary_categorical": ("binary", {"linear_lambda": 0.1}),
    "regression_exact": ("regression", {"linear_lambda": 0.1,
                                        "tpu_growth_mode": "exact"}),
}


def _case_data(case):
    task, _ = CASES[case]
    X, y, Xv, yv = _data(task)
    cat = []
    if case.endswith("categorical"):
        # column 5 as 6 categories, NaNs kept
        for A in (X, Xv):
            A[:, 5] = np.where(np.isnan(A[:, 5]), np.nan,
                               np.floor(np.abs(A[:, 5]) * 3) % 6)
        cat = [5]
    return X, y, Xv, yv, cat


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(case):
        if case not in cache:
            task, extra = CASES[case]
            X, y, Xv, yv, cat = _case_data(case)
            p = {**BASE[task], **PINS, "linear_tree": True, **extra}
            dj = lgb_j.Dataset(X, label=y, params=p, categorical_feature=cat)
            vj = lgb_j.Dataset(Xv, label=yv, reference=dj, params=p,
                               categorical_feature=cat)
            bj = lgb_j.train(p, dj, ROUNDS, valid_sets=[vj])
            pt = {**p, "device_type": "cpu"}
            dt = lgb_t.Dataset(X, label=y, params=pt, categorical_feature=cat)
            vt = lgb_t.Dataset(Xv, label=yv, reference=dt,
                               categorical_feature=cat)
            bt = lgb_t.train(pt, dt, ROUNDS, valid_sets=[vt])
            cache[case] = (bj, bt, X, Xv, cat)
        return cache[case]

    return get


def assert_linear_trees_close(a, b, cat, rtol, what):
    assert a.is_linear and b.is_linear, what
    np.testing.assert_array_equal(b.split_feature, a.split_feature)
    np.testing.assert_array_equal(b.left_child, a.left_child)
    assert b.leaf_features == a.leaf_features, what
    np.testing.assert_allclose(b.leaf_const, a.leaf_const, rtol=rtol,
                               atol=1e-9, err_msg=what)
    for ca, cb in zip(a.leaf_coeff, b.leaf_coeff):
        # norm-wise: relative to the leaf's largest coefficient
        np.testing.assert_allclose(
            cb, ca, rtol=0, atol=rtol * max([1e-3] + np.abs(ca).tolist()),
            err_msg=what)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                               atol=1e-7)
    for feats in b.leaf_features:
        assert not set(feats) & set(cat), feats


@pytest.mark.parametrize("case", list(CASES))
def test_linear_leaves_match_jax(trained, case):
    bj, bt, X, Xv, cat = trained(case)
    task, extra = CASES[case]
    mj, mt = bj._gbdt.models, bt._gbdt.models
    assert len(mj) == len(mt) == ROUNDS
    binary = task == "binary"
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert_linear_trees_close(a, b, cat, 1e-5 if binary else 1e-6,
                                  f"tree {i}")
    assert any(len(c) for t in mt for c in t.leaf_coeff)
    if binary:
        _X, y, *_ = _case_data(case)
        p = {**BASE[task], **PINS, "linear_tree": True, **extra}
        pt = {**p, "device_type": "cpu"}
        for i in range(1, ROUNDS):
            init = bj.predict(X, raw_score=True, num_iteration=i)
            a = lgb_j.train(p, lgb_j.Dataset(
                X, label=y, init_score=init, params=p,
                categorical_feature=cat), 1)._gbdt.models[0]
            b = lgb_t.train(pt, lgb_t.Dataset(
                X, label=y, init_score=init, params=pt,
                categorical_feature=cat), 1)._gbdt.models[0]
            assert_linear_trees_close(a, b, cat, 1e-6, f"tree {i} alone")
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), rtol=1e-6,
                               atol=1e-6)
    vj = np.asarray(bj._gbdt.valids[0].score)[:, :len(Xv)]
    vt = bt._gbdt.valids[0].score.numpy()[:, :len(Xv)]
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["regression", "binary_categorical"])
def test_train_score_is_the_model(trained, case):
    _bj, bt, X, _Xv, _cat = trained(case)
    ts = bt._gbdt.train.score.numpy()[0, :len(X)]
    np.testing.assert_allclose(ts, bt.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("case", ["regression", "binary_categorical"])
def test_model_text_round_trip(trained, case, tmp_path):
    bj, bt, _X, Xv, _cat = trained(case)
    text = bt.model_to_string()
    assert "is_linear=1" in text and "leaf_coeff=" in text
    path = tmp_path / "linear.txt"
    bt.save_model(str(path))
    loaded = lgb_t.Booster(model_file=str(path))
    trees = lambda t: t.split("end of trees")[0]
    assert trees(loaded.model_to_string()) == trees(text)
    np.testing.assert_array_equal(loaded.predict(Xv, raw_score=True),
                                  bt.predict(Xv, raw_score=True))
    # each package reads the other's text
    np.testing.assert_allclose(
        lgb_j.Booster(model_str=text).predict(Xv, raw_score=True),
        bt.predict(Xv, raw_score=True), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        booster_from_model_string(bj.model_to_string()).predict(
            Xv, raw_score=True), bj.predict(Xv, raw_score=True), rtol=1e-9,
        atol=1e-9)


def test_eager_loop_and_refusals(trained):
    _bj, bt, _X, Xv, _cat = trained("regression")
    assert bt._gbdt.fused_ineligible_reason() == \
        "linear_tree leaf fits run on host"
    assert bt._gbdt._fused is None
    with pytest.raises(lgb_t.LightGBMError, match="linear trees"):
        bt.predict(Xv, pred_contrib=True)


def test_dataset_without_raw_values_is_refused():
    X, y, _Xv, _yv = _data("regression", n=200)
    ds = lgb_t.Dataset(X, label=y, params={"device_type": "cpu"})
    ds.construct()  # binned without linear_tree: no raw values kept
    p = {**BASE["regression"], **PINS, "linear_tree": True,
         "device_type": "cpu"}
    with pytest.raises(lgb_t.LightGBMError, match="raw feature values"):
        lgb_t.train(p, ds, 1)
