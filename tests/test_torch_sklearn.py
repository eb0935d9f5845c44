"""The scikit-learn estimators of the port against the JAX package's on
the same seeded inputs (JAX on the CPU; both pinned to the rounds grower
and int16 levels through the estimators' **kwargs): binary, multiclass
with string labels, class_weight="balanced", a callable objective and a
callable metric, eval_set with early stopping, and LGBMRanker with
eval_at. The same trees (structure equal, leaf values within rtol 1e-5),
predictions and predict_proba within rtol 1e-5 / atol 1e-5, the fitted
attributes equal (eval histories and best scores within 1e-6), and
sklearn's clone / get_params / set_params."""

import numpy as np
import pytest
from sklearn.base import clone

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from test_torch_api import _same_trees
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
PRED = dict(rtol=1e-5, atol=1e-5)


def _xy(kind, n=600, f=6, seed=5):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    z = X @ rs.randn(f)
    if kind == "binary":
        y = (z + 0.4 * rs.randn(n) > 0).astype(int)
    elif kind == "imbalanced":
        y = (z + 0.4 * rs.randn(n) > 1.2).astype(int)
    elif kind == "strings":
        y = np.array(["cat", "dog", "eel"])[
            np.digitize(z, np.quantile(z, [0.3, 0.7]))]
    else:
        y = z + 0.2 * rs.randn(n)
    return X, y


def _l2(y_true, y_pred):
    return y_pred - y_true, np.ones_like(y_pred)


def _err(y_true, y_pred):
    p = 1.0 / (1.0 + np.exp(-y_pred))
    return "my_err", float(np.mean((p > 0.5) != y_true)), False


CASES = {
    "binary": ("LGBMClassifier", "binary", {}, {}),
    "strings_multiclass": ("LGBMClassifier", "strings", {"num_leaves": 7},
                           {}),
    "balanced": ("LGBMClassifier", "imbalanced",
                 {"class_weight": "balanced"}, {}),
    "callable_objective": ("LGBMRegressor", "regression",
                           {"objective": _l2}, {}),
    "callable_metric": ("LGBMClassifier", "binary", {},
                        {"eval_metric": _err, "eval": True}),
    "early_stopping": ("LGBMRegressor", "regression",
                       {"n_estimators": 40, "learning_rate": 0.5},
                       {"eval": True, "stop": 3, "eval_metric": "l1"}),
    "regressor_mapped": ("LGBMRegressor", "regression",
                         {"reg_alpha": 0.1, "reg_lambda": 0.2,
                          "min_child_samples": 7, "subsample": 0.8,
                          "subsample_freq": 1, "colsample_bytree": 0.8,
                          "random_state": 11}, {}),
}


def _fit(lgb, case):
    cls, kind, est_kw, fit_kw = CASES[case]
    X, y = _xy(kind)
    est = getattr(lgb, cls)(**{"n_estimators": 6, "num_leaves": 15,
                               "min_child_samples": 5, **est_kw, **PINS,
                               **({"device_type": "cpu"} if lgb is lgb_t
                                  else {})})
    fit_kw = dict(fit_kw)
    kw = {}
    if fit_kw.pop("eval", False):
        Xv, yv = _xy(kind, n=200, seed=9)
        kw["eval_set"] = [(Xv, yv)]
    if "stop" in fit_kw:
        kw["callbacks"] = [lgb.early_stopping(fit_kw.pop("stop"),
                                              verbose=False)]
    est.fit(X[:500], y[:500], **kw, **fit_kw)
    return est, X[500:]


def _close(a, b, **tol):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], **tol)
    else:
        np.testing.assert_allclose(a, b, **tol)


@pytest.fixture(scope="module", params=list(CASES))
def fitted(request):
    return (request.param, *_fit(lgb_j, request.param),
            _fit(lgb_t, request.param)[0])


def test_same_trees(fitted):
    _, ej, _, et = fitted
    _same_trees(ej.booster_.model_to_string(),
                et.booster_.model_to_string())


def test_predictions_close(fitted):
    case, ej, Xt, et = fitted
    np.testing.assert_allclose(et.predict(Xt, raw_score=True),
                               ej.predict(Xt, raw_score=True), **PRED)
    pj, pt = ej.predict(Xt), et.predict(Xt)
    if CASES[case][0] == "LGBMClassifier":
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_allclose(et.predict_proba(Xt),
                                   ej.predict_proba(Xt), **PRED)
    else:
        np.testing.assert_allclose(pt, pj, **PRED)
    np.testing.assert_array_equal(et.predict(Xt, pred_leaf=True),
                                  ej.predict(Xt, pred_leaf=True))


def test_fitted_attributes(fitted):
    case, ej, _, et = fitted
    for attr in ("n_features_", "n_features_in_", "best_iteration_",
                 "feature_name_", "objective_", "fitted_"):
        a, b = getattr(et, attr), getattr(ej, attr)
        assert a == b, attr
    np.testing.assert_array_equal(et.feature_names_in_, ej.feature_names_in_)
    np.testing.assert_array_equal(et.feature_importances_,
                                  ej.feature_importances_)
    _close(et.evals_result_, ej.evals_result_, rtol=0, atol=1e-6)
    _close(dict(et.best_score_), dict(ej.best_score_), rtol=0, atol=1e-6)
    if CASES[case][0] == "LGBMClassifier":
        np.testing.assert_array_equal(et.classes_, ej.classes_)
        assert et.n_classes_ == ej.n_classes_
    cfg_j, cfg_t = ej.booster_.config, et.booster_.config
    for key in ("lambda_l1", "lambda_l2", "min_data_in_leaf",
                "bagging_fraction", "bagging_freq", "feature_fraction",
                "seed", "num_class", "objective", "max_bin"):
        assert getattr(cfg_t, key) == getattr(cfg_j, key), key


def test_early_stopping_fires():
    est, _ = _fit(lgb_t, "early_stopping")
    assert 0 < est.best_iteration_ < 40
    assert est.booster_.num_trees() < 40
    assert list(est.evals_result_["valid_0"]) == ["l1", "l2"]


RANK_KW = {"n_estimators": 5, "num_leaves": 7, "min_child_samples": 5,
           **PINS}


def _rank_data(seed=7):
    rs = np.random.RandomState(seed)
    n, q = 400, 20
    X = rs.randn(n, 5)
    rel = np.clip((X[:, 0] * 2 + rs.randn(n)).astype(int) % 4, 0, 3)
    return X, rel, np.full(q, n // q)


@pytest.mark.parametrize("eval_at", [(1, 3), (2, 5, 10)])
def test_ranker_matches_jax(eval_at):
    X, y, group = _rank_data()
    Xv, yv, gv = _rank_data(seed=8)
    out = []
    for lgb in (lgb_j, lgb_t):
        est = lgb.LGBMRanker(**RANK_KW, **({"device_type": "cpu"}
                                           if lgb is lgb_t else {}))
        est.fit(X, y, group=group, eval_set=[(Xv, yv)], eval_group=[gv],
                eval_at=eval_at)
        out.append(est)
    ej, et = out
    _same_trees(ej.booster_.model_to_string(), et.booster_.model_to_string())
    np.testing.assert_allclose(et.predict(Xv), ej.predict(Xv), **PRED)
    assert list(et.evals_result_["valid_0"]) == \
        [f"ndcg@{k}" for k in eval_at]
    _close(et.evals_result_, ej.evals_result_, rtol=0, atol=1e-6)


def test_ranker_refuses_missing_groups():
    X, y, group = _rank_data()
    with pytest.raises(ValueError, match="group"):
        lgb_t.LGBMRanker(device_type="cpu").fit(X, y)
    with pytest.raises(ValueError, match="Eval_group"):
        lgb_t.LGBMRanker(device_type="cpu").fit(
            X, y, group=group, eval_set=[(X, y)])


def test_clone_get_set_params():
    for lgb in (lgb_t,):
        est = lgb.LGBMRegressor(n_estimators=7, num_leaves=9,
                                custom_thing=3, tpu_hist_dtype="int16")
        params = est.get_params()
        assert params["n_estimators"] == 7 and params["custom_thing"] == 3
        assert params["tpu_hist_dtype"] == "int16"
        twin = clone(est)
        assert twin.get_params() == params and twin is not est
        assert est.set_params(num_leaves=5, other=1) is est
        assert est.get_params()["num_leaves"] == 5
        assert est.get_params()["other"] == 1
    pj = lgb_j.LGBMClassifier(n_estimators=3, device_type="cpu").get_params()
    pt = lgb_t.LGBMClassifier(n_estimators=3, device_type="cpu").get_params()
    assert pt == pj


def test_kwargs_reach_the_booster():
    est, _ = _fit(lgb_t, "binary")
    g = est.booster_._gbdt
    assert g.hist_dtype == "int16" and g.device.type == "cpu"


def test_unfitted_raises():
    est = lgb_t.LGBMRegressor()
    for attr in ("booster_", "n_features_", "feature_importances_"):
        with pytest.raises(lgb_t.LightGBMError):
            getattr(est, attr)


def test_package_imports_without_sklearn():
    """The card's machine has no scikit-learn: the package imports, and
    making an estimator raises LightGBMError, as in the reference."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['sklearn'] = None\n"
            "import lightgbm_tpu_torch as lgb\n"
            "try:\n"
            "    lgb.LGBMClassifier()\n"
            "except lgb.LightGBMError as e:\n"
            "    print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "refused: scikit-learn is required" in out.stdout
