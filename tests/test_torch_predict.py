"""Booster.predict's per-row prediction early stop
(prediction_early_stop.cpp) against the JAX package: pred_early_stop,
pred_early_stop_freq and pred_early_stop_margin read from the predict
kwargs first, then from the Booster's params; classification only, with
a warning otherwise. Both packages load the same model text and predict
the same rows; raw predictions agree within 1e-6."""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

ES = {"pred_early_stop": True, "pred_early_stop_freq": 1,
      "pred_early_stop_margin": 0.5}


def _model(objective, n=400, f=5, trees=10, seed=3):
    """The probe of the repair: 400 x 5, 10 trees, trained by the port."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    z = X @ rs.randn(f)
    p = {"objective": objective, "num_leaves": 7, "verbosity": -1,
         "device_type": "cpu"}
    if objective == "binary":
        y = (z + 0.5 * rs.randn(n) > 0).astype(float)
    elif objective == "multiclass":
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
        p["num_class"] = 3
    else:
        y = z + 0.1 * rs.randn(n)
    b = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), trees)
    return b.model_to_string(), X


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
@pytest.mark.parametrize("where", ["params", "kwargs"])
def test_pred_early_stop_matches_jax(objective, where):
    text, X = _model(objective)
    params = dict(ES) if where == "params" else {}
    kw = dict(ES) if where == "kwargs" else {}
    bt = lgb_t.Booster(params=params, model_str=text)
    bj = lgb_j.Booster(params=params, model_str=text)
    pt = bt.predict(X, raw_score=True, **kw)
    pj = bj.predict(X, raw_score=True, **kw)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    full = lgb_t.Booster(model_str=text).predict(X, raw_score=True)
    # the early stop changed some rows: the repair is not a no-op
    assert np.abs(pt - full).max() > 1e-3


def test_pred_early_stop_regression_warns_and_ignores(capsys):
    """What the JAX package's predict means to do (basic.py:1091-1094:
    warn, predict every tree). Its warning itself raises
    UnboundLocalError there (`log` is bound later in that function), so
    the port is held to the intent: the warning, and the full
    prediction."""
    text, X = _model("regression")
    bt = lgb_t.Booster(params={**ES, "verbosity": 0}, model_str=text)
    pt = bt.predict(X, raw_score=True)
    assert "only applies to classification" in capsys.readouterr().err
    np.testing.assert_array_equal(
        pt, lgb_t.Booster(model_str=text).predict(X, raw_score=True))


def test_other_predict_options_still_raise():
    """Options the port does not implement raise; pred_leaf and
    pred_contrib are ported and answer as the JAX package's."""
    text, X = _model("binary", trees=2)
    bt = lgb_t.Booster(model_str=text)
    bj = lgb_j.Booster(model_str=text)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    np.testing.assert_allclose(bt.predict(X[:20], pred_contrib=True),
                               bj.predict(X[:20], pred_contrib=True),
                               rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="num_threads"):
        bt.predict(X, num_threads=2)
