"""lightgbm_tpu_torch.device_metrics against lightgbm_tpu.device_metrics:
every metric with a device form, on the same padded scores, labels,
weights and validity (numpy from a seed), within rtol 1e-6; and which
metric sets keep the fused loop (supported_names)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu import device_metrics as dm_j
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu_torch import device_metrics as dm_t
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.metrics import create_metrics
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

POINTWISE = ["l2", "rmse", "l1", "r2", "quantile", "huber", "fair",
             "poisson", "mape", "gamma", "gamma_deviance", "tweedie",
             "binary_logloss", "binary_error", "cross_entropy", "auc"]
PARAMS = {"alpha": 0.7, "fair_c": 1.5, "tweedie_variance_power": 1.3,
          "sigmoid": 1.2}


def _inputs(name, weighted, K=1, n=700, pad=50, seed=3):
    rs = np.random.RandomState(seed)
    score = rs.randn(K, n + pad).astype(np.float32) * 0.7
    if K > 1:
        label = rs.randint(0, K, n + pad).astype(np.float32)
    elif name in ("binary_logloss", "binary_error", "auc"):
        label = (rs.rand(n + pad) < 0.4).astype(np.float32)
        # ties in the scores, which the AUC counts as halves
        score[0, : n // 2] = np.round(score[0, : n // 2], 1)
    elif name == "cross_entropy":
        label = rs.rand(n + pad).astype(np.float32)
    elif name in ("poisson", "gamma", "gamma_deviance", "tweedie"):
        label = rs.gamma(2.0, 1.0, n + pad).astype(np.float32)
        label[::7] = 0.0 if name in ("poisson", "tweedie") else label[::7]
    else:
        label = (rs.randn(n + pad) * 2).astype(np.float32)
    weight = (rs.rand(n + pad) + 0.2).astype(np.float32) if weighted else None
    valid = np.r_[np.ones(n), np.zeros(pad)].astype(np.float32)
    return score, label, weight, valid


def _both(names, hb, score, label, weight, valid, K, params=PARAMS):
    j = dm_j.DeviceEvalSet(
        ConfigJ({"num_class": K, "objective": "multiclass" if K > 1
                 else "regression", **params}), names, hb,
        jnp.asarray(label), None if weight is None else jnp.asarray(weight),
        jnp.asarray(valid), K)(jnp.asarray(score))
    t = dm_t.DeviceEvalSet(
        ConfigT({"num_class": K, "objective": "multiclass" if K > 1
                 else "regression", **params}), names, hb,
        torch.from_numpy(label),
        None if weight is None else torch.from_numpy(weight),
        torch.from_numpy(valid), K)(torch.from_numpy(score))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", POINTWISE)
def test_pointwise_and_auc_match_jax(name, weighted):
    score, label, weight, valid = _inputs(name, weighted)
    j, t = _both([name], [False], score, label, weight, valid, 1)
    assert t.dtype == np.float32 and np.isfinite(t).all()
    # r2 = 1 - ss_res / ss_tot: the subtraction from 1 rounds to an ulp
    # of 1.0 (1.2e-7) whatever the sums' precision; two ulps apart
    np.testing.assert_allclose(t, j, rtol=1e-6,
                               atol=2.4e-7 if name == "r2" else 1e-7)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,top_k", [("multi_logloss", 1),
                                        ("multi_error", 1),
                                        ("multi_error", 2)])
def test_multiclass_match_jax(name, top_k, weighted):
    score, label, weight, valid = _inputs(name, weighted, K=4)
    params = {**PARAMS, "multi_error_top_k": top_k}
    j, t = _both([name], [False], score, label, weight, valid, 4, params)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_one_row_per_set_in_metric_order():
    score, label, weight, valid = _inputs("auc", True)
    names = ["auc", "binary_logloss", "binary_error"]
    j, t = _both(names, [True, False, False], score, label, weight, valid, 1)
    assert t.shape == (3,)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("metric,expect", [
    ("auc", (["auc"], [True])),
    ("multi_error", (["multi_error@2"], [False])),
    ("average_precision", None),
    ("auc_mu", None),
    ("kullback_leibler", None),
])
def test_supported_names(metric, expect):
    """A metric with no device form (or ndcg / map, refused before)
    keeps the run on the eager loop."""
    p = {"objective": "multiclass" if metric.startswith("multi")
         or metric == "auc_mu" else "binary", "metric": metric,
         "multi_error_top_k": 2}
    if p["objective"] == "multiclass":
        p["num_class"] = 3
    assert dm_t.supported_names(create_metrics(ConfigT(p))) == expect
