"""The port's prediction outputs and tensorized forest against the JAX
package (lightgbm_tpu_torch/serving/forest.py, shap.py, model_io.py's
JSON dump, Booster.predict's pred_leaf / pred_contrib).

Both packages load the SAME model text: five models trained by the JAX
package (the families of tests/test_serving.py: regression; binary with
a categorical column, NaN missing values and unseen / negative
categories at scoring time; multiclass; lambdarank; linear trees), read
by the port through its loader. The port's TensorForest runs on the CPU
(every gather through take_cols_plain) against the JAX package's
TensorForest on the CPU (XLA's take) and against the port's host walker:
raw scores within rtol 1e-5 / atol 1e-5, leaf indices exactly equal.
pred_leaf is exactly the JAX package's, host TreeSHAP within 1e-6 of
it, the device TreeSHAP within 1e-5 of the JAX package's, and every
contribution row sums to the raw score. dump_model's dict equals the
JAX package's, and the JSON loader round-trips to the same predictions.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.serving import TensorForest as JaxForest
from lightgbm_tpu_torch.convert import booster_from_model_dict
from lightgbm_tpu_torch.serving import TensorForest
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = ("regression", "binary_cat_nan", "multiclass", "lambdarank",
            "linear_tree")


def _train(params, X, y, rounds=10, **ds_kw):
    ds = lgb_j.Dataset(X, label=y, free_raw_data=False, **ds_kw)
    p = dict(verbosity=-1, min_data_in_leaf=5)
    p.update(params)
    return lgb_j.train(p, ds, num_boost_round=rounds)


@pytest.fixture(scope="module")
def families():
    """{name: (model text, scoring matrix)}, trained once by the JAX
    package (tests/test_serving.py _families, RandomState(42))."""
    rng = np.random.RandomState(42)
    out = {}
    X = rng.randn(1500, 8)
    yreg = X @ rng.randn(8) + 0.1 * rng.randn(1500)
    out["regression"] = (
        _train({"objective": "regression", "num_leaves": 31}, X, yreg),
        rng.randn(400, 8))

    Xc = rng.randn(1500, 8)
    Xc[:, 3] = rng.randint(0, 12, 1500)
    Xc[rng.rand(1500) < 0.07, 1] = np.nan  # NaN missing type
    yb = (np.nan_to_num(Xc[:, 0]) + (Xc[:, 3] % 3 == 0) > 0.3).astype(float)
    Xq = rng.randn(400, 8)
    Xq[:, 3] = rng.randint(-2, 20, 400)  # incl. unseen / negative cats
    Xq[rng.rand(400) < 0.07, 1] = np.nan
    out["binary_cat_nan"] = (
        _train({"objective": "binary", "num_leaves": 31}, Xc, yb,
               categorical_feature=[3]), Xq)

    ym = rng.randint(0, 3, 1500)
    out["multiclass"] = (
        _train({"objective": "multiclass", "num_class": 3,
                "num_leaves": 15}, X, ym, rounds=6), rng.randn(300, 8))

    yr = np.clip((X[:, 0] + 0.3 * rng.randn(1500)) * 2 + 2, 0, 4).astype(int)
    out["lambdarank"] = (
        _train({"objective": "lambdarank", "num_leaves": 15,
                "min_data_in_leaf": 2}, X, yr, rounds=6,
               group=np.full(30, 50)), rng.randn(300, 8))

    Xl = rng.randn(1200, 5)
    yl = Xl[:, 0] * 2 + Xl[:, 1] + 0.1 * rng.randn(1200)
    Xl[rng.rand(1200) < 0.04, 1] = np.nan
    Xlq = rng.randn(300, 5)
    Xlq[rng.rand(300) < 0.04, 1] = np.nan
    dsl = lgb_j.Dataset(Xl, label=yl, free_raw_data=False,
                        params={"linear_tree": True})
    out["linear_tree"] = (
        lgb_j.train({"objective": "regression", "num_leaves": 15,
                     "linear_tree": True, "verbosity": -1,
                     "min_data_in_leaf": 5}, dsl, num_boost_round=8), Xlq)
    return {k: (b.model_to_string(), Xq) for k, (b, Xq) in out.items()}


def _pair(text):
    """The same model text loaded by both packages."""
    return lgb_j.Booster(model_str=text), lgb_t.Booster(model_str=text)


@pytest.mark.parametrize("name", FAMILIES)
def test_forest_matches_jax_forest_and_host(families, name):
    text, Xq = families[name]
    bj, bt = _pair(text)
    host = bt._gbdt.predict_raw(Xq)
    ft = TensorForest.from_booster(bt, device="cpu")
    fj = JaxForest.from_booster(bj)
    raw_t = ft.predict_raw(Xq)
    np.testing.assert_allclose(raw_t, host, **TOL, err_msg=name)
    np.testing.assert_allclose(raw_t, fj.predict_raw(Xq), **TOL,
                               err_msg=name)
    leaf_t = ft.predict_leaf(Xq)
    np.testing.assert_array_equal(leaf_t, fj.predict_leaf(Xq))
    np.testing.assert_array_equal(leaf_t, bt._gbdt.predict_leaf_index(Xq))
    assert ft.levels == ft.meta["max_depth"] == fj.meta["max_depth"]


@pytest.mark.parametrize("start,num", [(0, 4), (2, 3), (5, -1)])
@pytest.mark.parametrize("name", ["binary_cat_nan", "multiclass"])
def test_forest_truncation_matches_jax(families, name, start, num):
    text, Xq = families[name]
    bj, bt = _pair(text)
    ft = TensorForest.from_booster(bt, device="cpu")
    fj = JaxForest.from_booster(bj)
    raw = ft.predict_raw(Xq, start, num)
    np.testing.assert_allclose(raw, bt._gbdt.predict_raw(Xq, start, num),
                               **TOL)
    np.testing.assert_allclose(raw, fj.predict_raw(Xq, start, num), **TOL)
    leaf = ft.predict_leaf(Xq, start, num)
    np.testing.assert_array_equal(leaf, fj.predict_leaf(Xq, start, num))
    np.testing.assert_array_equal(
        leaf, bt._gbdt.predict_leaf_index(Xq, start, num))


def test_forest_average_output_matches_jax(families):
    """A model text with `average_output` (the reference's random forest
    writes it): scores divided by the iterations used, in both."""
    text, Xq = families["regression"]
    lines = text.split("\n")
    at = next(i for i, ln in enumerate(lines) if ln.startswith("objective="))
    text = "\n".join(lines[:at + 1] + ["average_output"] + lines[at + 1:])
    bj, bt = _pair(text)
    assert bt._gbdt.average_output and bj._gbdt.average_output
    ft = TensorForest.from_booster(bt, device="cpu")
    fj = JaxForest.from_booster(bj)
    for start, num in ((0, -1), (3, 4)):
        raw = ft.predict_raw(Xq, start, num)
        np.testing.assert_allclose(
            raw, bt._gbdt.predict_raw(Xq, start, num), **TOL)
        np.testing.assert_allclose(raw, fj.predict_raw(Xq, start, num),
                                   **TOL)


def test_threshold_f32_cast_never_rounds_up(families):
    """tests/test_serving.py's hostile root split: f32(1 - 1e-12) rounds
    to exactly 1.0, and the packed threshold must round DOWN, so the
    exactly-f32 value 1.0 goes right as on the f64 host walker."""
    text, _ = families["regression"]
    trees = []
    for b in _pair(text):
        t = b._gbdt.models[0]
        t.split_feature[0] = 0
        t.threshold[0] = 1.0 - 1e-12
        t.decision_type[0] = 0  # numerical, no missing handling
        trees.append(t)
    assert np.float32(trees[1].threshold[0]) == np.float32(1.0)
    Xp = np.zeros((3, 8), np.float32)
    Xp[:, 0] = [1.0, 0.5, 2.0]  # exactly f32: right; left; right
    host_leaf = trees[1].predict_leaf(Xp.astype(np.float64))
    ft = TensorForest([trees[1]], 1, device="cpu")
    leaf = ft.predict_leaf(Xp)[:, 0]
    np.testing.assert_array_equal(leaf, host_leaf)
    np.testing.assert_array_equal(
        leaf, JaxForest([trees[0]], 1).predict_leaf(Xp)[:, 0])
    assert np.abs(ft.predict_raw(Xp)[0]
                  - trees[1].predict(Xp.astype(np.float64))).max() < 1e-6


@pytest.mark.parametrize("name", FAMILIES)
def test_pred_leaf_matches_jax(families, name):
    text, Xq = families[name]
    bj, bt = _pair(text)
    got = bt.predict(Xq, pred_leaf=True)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, bj.predict(Xq, pred_leaf=True))
    np.testing.assert_array_equal(
        bt.predict(Xq, pred_leaf=True, start_iteration=1, num_iteration=2),
        bj.predict(Xq, pred_leaf=True, start_iteration=1, num_iteration=2))


@pytest.mark.parametrize("name", FAMILIES[:4])
def test_pred_contrib_host_matches_jax(families, name):
    text, Xq = families[name]
    bj, bt = _pair(text)
    Xs = Xq[:60]
    got = bt.predict(Xs, pred_contrib=True)
    np.testing.assert_allclose(got, bj.predict(Xs, pred_contrib=True),
                               rtol=0, atol=1e-6)
    K = bt._gbdt.num_class
    raw = bt._gbdt.predict_raw(Xs)  # (K, N)
    sums = got.reshape(len(Xs), K, -1).sum(axis=2).T
    np.testing.assert_allclose(sums, raw, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", FAMILIES[:4])
def test_pred_contrib_device_matches_jax(families, name):
    text, Xq = families[name]
    bj, bt = _pair(text)
    Xs = Xq[:60]
    ft = TensorForest.from_booster(bt, device="cpu")
    got = ft.predict_contrib(Xs)
    np.testing.assert_allclose(
        got, JaxForest.from_booster(bj).predict_contrib(Xs), **TOL)
    np.testing.assert_allclose(got, bt.predict(Xs, pred_contrib=True),
                               **TOL)
    K = bt._gbdt.num_class
    sums = got.reshape(len(Xs), K, -1).sum(axis=2).T
    np.testing.assert_allclose(sums, bt._gbdt.predict_raw(Xs), **TOL)


def test_pred_contrib_linear_trees_fatal(families):
    text, Xq = families["linear_tree"]
    bj, bt = _pair(text)
    with pytest.raises(lgb_t.LightGBMError, match="linear trees"):
        bt.predict(Xq, pred_contrib=True)
    with pytest.raises(Exception, match="linear trees"):
        bj.predict(Xq, pred_contrib=True)


@pytest.mark.parametrize("name", FAMILIES)
def test_dump_model_equals_jax(families, name):
    text, _ = families[name]
    bj, bt = _pair(text)
    assert bt.dump_model() == bj.dump_model()
    assert (bt.dump_model(num_iteration=2, start_iteration=1,
                          importance_type="gain")
            == bj.dump_model(num_iteration=2, start_iteration=1,
                             importance_type="gain"))
    hook = lambda d: {**d, "seen": True}  # noqa: E731
    assert bt.dump_model(object_hook=hook) == bj.dump_model(object_hook=hook)


@pytest.mark.parametrize("name", FAMILIES)
def test_json_model_round_trip(families, name):
    """The JAX package's dump, loaded by the port's JSON loader, predicts
    what the model text predicts; the port's own dump round-trips too."""
    text, Xq = families[name]
    bj, bt = _pair(text)
    from_dict = booster_from_model_dict(bj.dump_model())
    want = bt.predict(Xq, raw_score=True)
    np.testing.assert_array_equal(from_dict.predict(Xq, raw_score=True),
                                  want)
    again = booster_from_model_dict(from_dict.dump_model())
    np.testing.assert_array_equal(again.predict(Xq, raw_score=True), want)
    np.testing.assert_array_equal(again.predict(Xq, pred_leaf=True),
                                  bt.predict(Xq, pred_leaf=True))


def test_tree_depth_and_gain_importance_match_jax(families):
    text, _ = families["binary_cat_nan"]
    bj, bt = _pair(text)
    for tj, tt in zip(bj._gbdt.models, bt._gbdt.models):
        assert tt.max_depth() == tj.max_depth()
        np.testing.assert_array_equal(tt.feature_importance_gain(8),
                                      tj.feature_importance_gain(8))


def test_narrow_input_raises_like_host(families):
    text, Xq = families["regression"]
    ft = TensorForest.from_booster(lgb_t.Booster(model_str=text),
                                   device="cpu")
    assert ft.max_feature >= 2
    with pytest.raises(IndexError):
        ft.predict_raw(Xq[:10, :2])
