"""DART and random-forest boosting: lightgbm_tpu_torch against lightgbm_tpu
on the same seeded inputs, with JAX on the CPU.

- DART (default, xgboost_dart_mode, uniform_drop, max_drop): the same
  drop set at every iteration, the same trees, leaf values and
  shrinkage within rtol 1e-5 (atol 1e-5), raw predictions within 1e-6;
  a custom fobj is handed the dropped ensemble's scores, the same in
  both packages;
- RF: the same trees and predictions (binary with bagging and
  feature_fraction, regression_l1 through the percentile refit of
  label - init); the validation score is the mean of the trees'
  predictions; rollback takes the last trees out of the average as the
  JAX package does; the model text round trip; the fatal message without
  bagging or feature_fraction, and the refused custom objective;
  multiclass diverges only at a tie of exact zero gain (ROADMAP C.1);
- both run on the eager loop with the JAX package's reasons, and the
  scikit-learn estimators take boosting_type "dart" and "rf".
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu import boosting as boosting_j
from lightgbm_tpu.log import LightGBMError as ErrorJ
from lightgbm_tpu_torch import boosting as boosting_t
from test_torch_train import _STRUCT, _data, _trees
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        **PINS}
ROUNDS = 8
DART = {
    "default": {"drop_rate": 0.3, "skip_drop": 0.2},
    "xgboost": {"drop_rate": 0.3, "skip_drop": 0.2,
                "xgboost_dart_mode": True},
    "uniform": {"drop_rate": 0.3, "skip_drop": 0.2, "uniform_drop": True},
    "max_drop": {"drop_rate": 0.6, "skip_drop": 0.0, "max_drop": 1,
                 "drop_seed": 11},
}
RF = {"bagging_fraction": 0.632, "bagging_freq": 1, "feature_fraction": 0.8}


def _record_drops(monkeypatch, cls):
    """Wrap cls._select_drops to log every draw of every booster."""
    log = []
    orig = cls._select_drops

    def wrapped(self):
        drops = orig(self)
        log.append(list(drops))
        return drops

    monkeypatch.setattr(cls, "_select_drops", wrapped)
    return log


def _train_both(params, X, y, Xv, yv, rounds=ROUNDS):
    out = []
    for lgb in (lgb_j, lgb_t):
        p = dict(params)
        if lgb is lgb_t:
            p["device_type"] = "cpu"
        ds = lgb.Dataset(X, label=y, params=p if lgb is lgb_t else None)
        vs = lgb.Dataset(Xv, label=yv, reference=ds)
        out.append(lgb.train(p, ds, rounds, valid_sets=[vs],
                             valid_names=["v"]))
    return out


def assert_models_close(bj, bt, Xv, pred_atol):
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    for i, (a, b) in enumerate(zip(tj, tt)):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), (i, k)
        for k in ("leaf_value", "shrinkage"):
            np.testing.assert_allclose(
                np.array(b[k].split(), float), np.array(a[k].split(), float),
                rtol=1e-5, atol=1e-5, err_msg=f"tree {i} {k}")
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=pred_atol)


@pytest.mark.parametrize("case", list(DART))
def test_dart_matches_jax(monkeypatch, case):
    X, y, Xv, yv = _data("binary")
    drops_j = _record_drops(monkeypatch, boosting_j.DART)
    drops_t = _record_drops(monkeypatch, boosting_t.DART)
    bj, bt = _train_both({**BASE, "boosting": "dart", **DART[case]},
                         X, y, Xv, yv)
    assert drops_t == drops_j
    assert sum(len(d) for d in drops_t) >= 2  # the dropout did drop
    if case == "max_drop":
        assert max(len(d) for d in drops_t) == 1
    assert_models_close(bj, bt, Xv, pred_atol=1e-6)
    gb = bt._gbdt
    assert gb.fused_ineligible_reason() == \
        bj._gbdt.fused_ineligible_reason() == \
        "DART dropout mutates past trees every iteration"
    # the stored, renormalized model is what the train score holds
    np.testing.assert_allclose(
        gb.get_score(gb.train)[0],
        bt.predict(X, raw_score=True), atol=1e-5)


def test_dart_restores_its_drops_after_an_aborted_iteration(monkeypatch):
    """An iteration that stops (no splittable leaf) puts its dropped trees
    back: the train score again sums the stored ensemble, in both
    packages."""
    X, y, Xv, yv = _data("binary")
    params = {**BASE, "boosting": "dart", "drop_rate": 1.0,
              "skip_drop": 0.0, "max_drop": 2}
    bj, bt = _train_both(params, X, y, Xv, yv, rounds=3)
    drops = _record_drops(monkeypatch, boosting_t.DART)
    before_t = bt._gbdt.get_score(bt._gbdt.train)
    before_j = bj._gbdt.get_score(bj._gbdt.train)
    for mod in (boosting_j, boosting_t):
        monkeypatch.setattr(mod.GBDT, "train_one_iter",
                            lambda self, grad=None, hess=None: True)
    assert bj.update() and bt.update()
    assert drops and len(drops[0]) == 2
    np.testing.assert_allclose(bt._gbdt.get_score(bt._gbdt.train),
                               before_t, atol=1e-6)
    np.testing.assert_allclose(bt._gbdt.get_score(bt._gbdt.train),
                               bj._gbdt.get_score(bj._gbdt.train), atol=1e-6)
    np.testing.assert_allclose(before_j, before_t, atol=1e-6)
    assert bt._gbdt.iter_ == bj._gbdt.iter_ == 3


def _logloss_fobj(seen):
    def fobj(preds, train_set):
        seen.append(np.asarray(preds, np.float64).copy())
        p = 1.0 / (1.0 + np.exp(-preds))
        yl = train_set.get_label()
        return p - yl, p * (1.0 - p)

    return fobj


def test_dart_custom_objective_sees_the_dropped_scores(monkeypatch):
    X, y, _Xv, _yv = _data("binary")
    params = {**BASE, "objective": "none", "boosting": "dart",
              **DART["default"]}
    drops = _record_drops(monkeypatch, boosting_t.DART)
    seen = {}
    boosters = {}
    for name, lgb in (("jax", lgb_j), ("port", lgb_t)):
        p = dict(params, device_type="cpu") if lgb is lgb_t else params
        ds = lgb.Dataset(X, label=y, params=p if lgb is lgb_t else None)
        b = lgb.Booster(p, ds)
        seen[name] = []
        fobj = _logloss_fobj(seen[name])
        full = []
        for _ in range(ROUNDS):
            full.append(b.predict(X, raw_score=True))
            b.update(fobj=fobj)
        boosters[name] = (b, full)
    for pj, pt in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(pt, pj, atol=1e-6)
    # an iteration that dropped trees handed the fobj less than the full
    # ensemble; one that dropped none handed it all of it
    _b, full = boosters["port"]
    port_drops = drops[-ROUNDS:]
    assert any(port_drops)
    for it, d in enumerate(port_drops):
        gap = np.abs(seen["port"][it] - full[it]).max()
        assert (gap > 1e-4) if d else (gap < 1e-5), (it, d, gap)


@pytest.fixture(scope="module")
def rf_pair():
    X, y, Xv, yv = _data("binary")
    bj, bt = _train_both({**BASE, "boosting": "rf", **RF}, X, y, Xv, yv)
    return bj, bt, X, Xv


def test_rf_matches_jax(rf_pair):
    bj, bt, _X, Xv = rf_pair
    assert_models_close(bj, bt, Xv, pred_atol=1e-6)
    assert bt._gbdt.average_output
    assert bt._gbdt.fused_ineligible_reason() == \
        bj._gbdt.fused_ineligible_reason() == \
        "random forest averages scores per iteration"


def test_rf_scores_are_the_mean_of_the_trees(rf_pair):
    _bj, bt, _X, Xv = rf_pair
    gb = bt._gbdt
    per_tree = np.stack([t.predict(Xv) for t in gb.models])
    np.testing.assert_allclose(gb.get_score(gb.valids[0])[0],
                               per_tree.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               per_tree.mean(axis=0), atol=1e-12)


def test_rf_model_text_round_trip(rf_pair, tmp_path):
    _bj, bt, _X, Xv = rf_pair
    path = tmp_path / "rf.txt"
    bt.save_model(str(path))
    assert "average_output" in path.read_text()
    back = lgb_t.Booster(model_file=str(path))
    np.testing.assert_array_equal(back.predict(Xv), bt.predict(Xv))
    jax_reads = lgb_j.Booster(model_file=str(path))
    np.testing.assert_allclose(jax_reads.predict(Xv), bt.predict(Xv),
                               atol=1e-12)


def test_rf_rollback_matches_jax():
    X, y, Xv, yv = _data("binary")
    bj, bt = _train_both({**BASE, "boosting": "rf", **RF}, X, y, Xv, yv,
                         rounds=4)
    for b in (bj, bt):
        b.rollback_one_iter()
        b.rollback_one_iter()
    gj, gt = bj._gbdt, bt._gbdt
    assert gt.iter_ == gj.iter_ == 2 and len(gt.models) == 2
    for sj, st in ((gj.train, gt.train), (gj.valids[0], gt.valids[0])):
        np.testing.assert_allclose(gt.get_score(st), gj.get_score(sj),
                                   atol=1e-6)
    per_tree = np.stack([t.predict(Xv) for t in gt.models])
    np.testing.assert_allclose(gt.get_score(gt.valids[0])[0],
                               per_tree.mean(axis=0), atol=1e-5)


def test_rf_multiclass_diverges_only_at_ties(monkeypatch):
    """ROADMAP C.1 decided, a tie: RF multiclass with bagging. Trees 0-13
    match; in tree 14 (iteration 4, class 2) the port splits, at its
    node 6, an in-bag leaf whose rows are all of one class and so carry
    one gradient level and one hessian level: every split of it has
    children with equal g / h ratios, a gain of exactly zero, which the
    port's f32 evaluation rounds to +2^-17 (a unit in the last place of
    its leaf-gain terms) and the JAX package's to at most 0. The port's
    tree then lacks the JAX package's last split for want of leaves."""
    from test_torch_monotone import (_grad_recorder,
                                     assert_first_difference_is_tie)

    X, y, _Xv, _yv = _data("multiclass")
    p = {**BASE, "objective": "multiclass", "num_class": 3,
         "boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1}
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), ROUNDS)
    grads = _grad_recorder(monkeypatch)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt), ROUNDS)
    assert assert_first_difference_is_tie(bj, bt, X, grads) == (14, 6)


def test_rf_regression_l1_refits_on_label_minus_init():
    X, y, Xv, yv = _data("regression")
    bj, bt = _train_both({**BASE, "objective": "regression_l1",
                          "boosting": "rf", **RF}, X, y, Xv, yv, rounds=4)
    assert_models_close(bj, bt, Xv, pred_atol=1e-5)


def test_rf_needs_bagging_or_feature_fraction():
    X, y, _Xv, _yv = _data("binary", n=200)
    msgs = []
    for lgb, error in ((lgb_j, ErrorJ), (lgb_t, lgb_t.LightGBMError)):
        p = {**BASE, "boosting": "rf", "device_type": "cpu"}
        with pytest.raises(error, match="RF mode requires") as e:
            lgb.train(p, lgb.Dataset(X, label=y, params=p), 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rf_refuses_a_custom_objective():
    X, y, _Xv, _yv = _data("binary", n=200)
    p = {**BASE, "boosting": "rf", "device_type": "cpu", **RF}
    b = lgb_t.Booster(p, lgb_t.Dataset(X, label=y, params=p))
    with pytest.raises(lgb_t.LightGBMError,
                       match="RF mode does not support custom objective"):
        b.update(fobj=_logloss_fobj([]))
    p = {**p, "objective": "none"}
    with pytest.raises(lgb_t.LightGBMError,
                       match="RF mode does not support custom objective"):
        lgb_t.Booster(p, lgb_t.Dataset(X, label=y, params=p))


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_sklearn_boosting_type(boosting):
    X, y, Xv, _yv = _data("binary")
    kw = dict(boosting_type=boosting, n_estimators=5, num_leaves=15,
              min_child_samples=5, **PINS)
    if boosting == "rf":
        kw.update(subsample=0.632, subsample_freq=1, colsample_bytree=0.8)
    cj = lgb_j.LGBMClassifier(**kw).fit(X, y)
    ct = lgb_t.LGBMClassifier(device_type="cpu", **kw).fit(X, y)
    assert ct.booster_._gbdt.__class__.__name__ == boosting.upper()
    np.testing.assert_allclose(ct.predict_proba(Xv), cj.predict_proba(Xv),
                               atol=1e-6)


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_cv_runs_each_fold_on_the_eager_loop(boosting):
    X, y, _Xv, _yv = _data("binary", n=300)
    p = {**BASE, "boosting": boosting, "metric": "auc", "device_type": "cpu",
         **(RF if boosting == "rf" else DART["default"])}
    res = lgb_t.cv(p, lgb_t.Dataset(X, label=y, params=p), 4, nfold=3,
                   return_cvbooster=True)
    assert len(res["valid auc-mean"]) == 4
    for b in res["cvbooster"].boosters:
        assert type(b._gbdt).__name__ == boosting.upper()
        assert b._gbdt._fused is None
