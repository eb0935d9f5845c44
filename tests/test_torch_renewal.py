"""The regression family: the percentile leaf refit of the renewing
objectives (regression_l1, huber, quantile, mape), the objectives that
need no refit (fair, poisson, gamma, tweedie) and the regression
metrics, lightgbm_tpu_torch against lightgbm_tpu on the same seeded
inputs, JAX on the CPU (its XLA fallbacks):

- hist_nat_slots in its f32 mode (plain version of the kernel's f32
  mode) against _hist_nat_fallback(quant=False): rtol 1e-5 / atol 1e-6,
  the f32 histogram tolerance of tests/test_torch_exact.py (the port
  sums as int64 fixed point, the fallback in f32 blocks);
- renew_leaf_values against the JAX function on the same (row_leaf,
  resid, w): leaf values within rtol 1e-5 / atol 1e-5;
- lightgbm_tpu_torch.train against lightgbm_tpu.train for each
  objective, pinned to the rounds grower and int16 levels: equal tree
  structure, leaf values within rtol 1e-5 / atol 1e-5, raw predictions
  within 1e-5; the port's converter loads the JAX package's model text
  and predicts the same, transformed output (exp) included;
- every ported metric against lightgbm_tpu.metrics on the same scores,
  and the default metric of each objective.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.learner.renewal import renew_leaf_values as renew_j
from lightgbm_tpu.metrics import create_metrics as metrics_j
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.learner import histogram as ht
from lightgbm_tpu_torch.learner.renewal import renew_leaf_values as renew_t
from lightgbm_tpu_torch.metrics import create_metrics as metrics_t
from test_torch_exact import _channels, _gh_both, assert_same_models
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

hj = importlib.import_module("lightgbm_tpu.learner.histogram")


@pytest.mark.parametrize("G,B,num_slots", [(5, 32, 1), (5, 32, 6),
                                           (1, 256, 15)])
def test_hist_nat_f32_matches_jax(G, B, num_slots):
    """The f32 mode, including the refit's shape: one column of 256
    residual bins, one slot per leaf, trash slot num_slots."""
    N = 1000
    rs = np.random.RandomState(G + num_slots)
    bins = rs.randint(0, B, (G, N)).astype(np.int32)
    slot = rs.randint(0, num_slots + 1, N).astype(np.int32)
    gh8, gh3 = _gh_both(*_channels(N, 5))
    ref = np.asarray(hj._hist_nat_fallback(
        jnp.asarray(bins), gh8, jnp.asarray(slot), num_slots, B,
        quant=False))
    out = ht.hist_nat_slots(torch.from_numpy(bins), gh3,
                            torch.from_numpy(slot), num_slots, B,
                            quant=False)
    assert out.shape == (num_slots, 3, G, B) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def _refit_inputs(weights, seed, n=1000, L=15):
    rs = np.random.RandomState(seed)
    row_leaf = rs.randint(-1, L, n).astype(np.int32)
    row_leaf[row_leaf == 7] = 3  # leaf 7 has no rows: keeps its value
    resid = (rs.randn(n) * 2.0).astype(np.float32)
    if weights == "ones":
        w = np.ones(n, np.float32)
    elif weights == "uniform":
        w = (rs.rand(n) + 0.5).astype(np.float32)
    else:  # MAPE's label weights 1 / max(1, |label|)
        w = (1.0 / np.maximum(1.0, np.abs(rs.randn(n) * 3.0))
             ).astype(np.float32)
    w[rs.rand(n) < 0.1] = 0.0  # padding / out-of-bag rows
    leaf_value = rs.randn(L).astype(np.float32)
    return leaf_value, row_leaf, resid, w, L


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.9])
@pytest.mark.parametrize("weights", ["ones", "uniform", "label"])
def test_renew_leaf_values_matches_jax(alpha, weights):
    """Leaf values within rtol 1e-5 / atol 1e-5 of the JAX function on
    the same inputs; an empty leaf keeps its value."""
    lv, rl, resid, w, L = _refit_inputs(weights, int(alpha * 10))
    ref = np.asarray(renew_j(jnp.asarray(lv), jnp.asarray(rl),
                             jnp.asarray(resid), jnp.asarray(w), alpha, L))
    out = renew_t(torch.from_numpy(lv), torch.from_numpy(rl),
                  torch.from_numpy(resid), torch.from_numpy(w), alpha, L)
    assert out.dtype == torch.float32 and out.shape == (L,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert out[7] == lv[7]


def test_renew_is_the_weighted_percentile():
    """On each leaf the refit lands within the bracket's width of the
    first residual whose cumulative weight reaches alpha * total."""
    lv, rl, resid, w, L = _refit_inputs("uniform", 4)
    out = renew_t(torch.from_numpy(lv), torch.from_numpy(rl),
                  torch.from_numpy(resid), torch.from_numpy(w), 0.3, L)
    for leaf in range(L):
        m = (rl == leaf) & (w > 0)
        if not m.any():
            continue
        order = np.argsort(resid[m], kind="stable")
        cw = np.cumsum(w[m][order].astype(np.float64))
        want = resid[m][order][np.searchsorted(cw, 0.3 * cw[-1])]
        assert abs(float(out[leaf]) - want) < 1e-5 * max(1.0, abs(want))


def test_refit_crossing_decided_by_f32_rounding():
    """A documented difference (ROADMAP C), shown: MAPE-like weights
    1 / max(1, |label|) of 2^-24 beside weights of 1. The leaf holds
    residuals [0, 0 x 16, 1] with weights [1, 2^-24 x 16, 1] and alpha
    just above 1/2. Both packages take the total in f32 (seg_sum: 2.0,
    the small weights lost) and so the target 1 + 2^-21. The JAX
    package's f32 bin sum at residual 0 loses the small weights too
    (1.0 < target: it crosses at residual 1); the port's fixed-point bin
    sum keeps them (1 + 2^-20 >= target: it crosses at residual 0)."""
    w = np.array([1.0] + [2.0 ** -24] * 16 + [1.0], np.float32)
    r = np.array([0.0] * 17 + [1.0], np.float32)
    rl = np.zeros(18, np.int32)
    lv = np.zeros(1, np.float32)
    alpha = float(np.float32(0.5 + 2.0 ** -22))
    ref = np.asarray(renew_j(jnp.asarray(lv), jnp.asarray(rl),
                             jnp.asarray(r), jnp.asarray(w), alpha, 1))
    out = renew_t(torch.from_numpy(lv), torch.from_numpy(rl),
                  torch.from_numpy(r), torch.from_numpy(w), alpha, 1)
    assert abs(float(ref[0]) - 1.0) < 1e-6
    assert abs(float(out[0])) < 1e-6


def _regression_data(task, n=800, f=6, seed=7):
    rs = np.random.RandomState(seed)
    X = rs.randn(n + 200, f)
    X[rs.rand(n + 200, f) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(f) * 0.5
    if task == "positive":
        y = np.exp(0.5 * z + 0.2 * rs.randn(n + 200))
    else:
        y = z + 0.3 * rs.randn(n + 200)
    return X[:n], y[:n], X[n:], rs


PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1}
# case -> (objective params, label kind, weighted, renews)
OBJECTIVES = {
    "regression_l1": ({"objective": "regression_l1"}, "real", False, True),
    "huber": ({"objective": "huber", "alpha": 0.9}, "real", False, True),
    "quantile_0.3": ({"objective": "quantile", "alpha": 0.3}, "real", False,
                     True),
    "quantile_weighted": ({"objective": "quantile", "alpha": 0.3}, "real",
                          True, True),
    "mape": ({"objective": "mape"}, "real", False, True),
    "fair": ({"objective": "fair"}, "real", False, False),
    "regression_sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real", False, False),
    "poisson": ({"objective": "poisson"}, "positive", False, False),
    "gamma": ({"objective": "gamma"}, "positive", False, False),
    "tweedie": ({"objective": "tweedie"}, "positive", False, False),
}


@pytest.fixture(scope="module", params=list(OBJECTIVES))
def trained(request):
    params, task, weighted, renews = OBJECTIVES[request.param]
    X, y, Xv, rs = _regression_data(task)
    kw = {"weight": rs.rand(len(y)) + 0.5} if weighted else {}
    p = {**params, **PINS}
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y, **kw), 5)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt, **kw), 5)
    return renews, bj, bt, Xv


def test_objective_train_matches_jax(trained):
    renews, bj, bt, Xv = trained
    assert bt._gbdt.objective.is_renew_tree_output == renews
    assert_same_models(bj, bt, Xv)


def test_objective_predictions_and_model_text(trained):
    """Transformed predictions (exp for poisson / gamma / tweedie, the
    signed square under reg_sqrt) agree, and the port's converter
    predicts like the JAX package's own load of the same model text
    (which, in both packages, does not carry reg_sqrt: ROADMAP C)."""
    _, bj, bt, Xv = trained
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=1e-5,
                               atol=1e-5)
    text = bj.model_to_string()
    b = booster_from_model_string(text)
    np.testing.assert_allclose(b.predict(Xv),
                               lgb_j.Booster(model_str=text).predict(Xv),
                               rtol=1e-9, atol=1e-9)


METRICS = ["l1", "mae", "mean_absolute_error", "regression_l1", "quantile",
           "huber", "fair", "poisson", "mape",
           "mean_absolute_percentage_error", "gamma", "gamma_deviance",
           "tweedie", "r2", "r_squared"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name, weighted):
    rs = np.random.RandomState(len(name))
    y = np.exp(rs.randn(300) * 0.5).astype(np.float32)
    score = (np.log(y) + 0.3 * rs.randn(300)).astype(np.float64)
    w = (rs.rand(300) + 0.5).astype(np.float32) if weighted else None
    params = {"metric": name, "alpha": 0.3}
    (mj,), (mt,) = metrics_j(ConfigJ(params)), metrics_t(ConfigT(params))
    mj.init(y, w, None)
    mt.init(y, w, None)
    assert mt.eval(score) == mj.eval(score)


@pytest.mark.parametrize("objective", ["regression", "regression_l1",
                                       "huber", "fair", "poisson",
                                       "quantile", "mape", "gamma",
                                       "tweedie", "binary", "multiclass"])
def test_default_metric_matches_jax(objective):
    params = {"objective": objective,
              "num_class": 3 if objective == "multiclass" else 1}
    assert [m.name for m in metrics_t(ConfigT(params))] == \
        [m.name for m in metrics_j(ConfigJ(params))]
