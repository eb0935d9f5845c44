"""The last pointwise objectives and metrics: lightgbm_tpu_torch against
lightgbm_tpu on the same seeded inputs, with JAX on the CPU.

- multiclassova, cross_entropy (xentropy) and cross_entropy_lambda
  (xentlambda, unweighted and weighted) trained end to end on the int16
  rounds path: equal trees, leaf values within rtol 1e-5, eval records
  within rtol 1e-4 (atol 1e-6), converted predictions within 1e-5;
- average_precision, auc_mu, cross_entropy, cross_entropy_lambda and
  kullback_leibler (and their aliases) on the same labels, weights and
  raw scores: the same values (both sides are the same numpy).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.metrics import create_metrics as metrics_j
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.metrics import create_metrics as metrics_t
from test_torch_callbacks import _per_iteration
from test_torch_sampling import assert_same_sampled_models
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}


def _xent_data(n=800, nv=200, seed=3):
    """Labels in [0, 1] (a noisy sigmoid of a linear score) and positive
    weights."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n + nv, 5)
    p = 1.0 / (1.0 + np.exp(-(X @ rs.randn(5) + 0.3 * rs.randn(n + nv))))
    y = np.clip(p + 0.1 * rs.randn(n + nv), 0.0, 1.0)
    w = rs.rand(n + nv) * 1.5 + 0.25
    return X[:n], y[:n], w[:n], X[n:], y[n:], w[n:]


OBJECTIVES = {
    "multiclassova": ({"objective": "multiclassova", "num_class": 3,
                       "num_leaves": 7, "min_data_in_leaf": 10}, False),
    "xentropy": ({"objective": "xentropy", "num_leaves": 15,
                  "min_data_in_leaf": 5,
                  "metric": ["cross_entropy", "kullback_leibler",
                             "average_precision"]}, False),
    "xentlambda": ({"objective": "xentlambda", "num_leaves": 15,
                    "min_data_in_leaf": 5}, False),
    "xentlambda_weighted": ({"objective": "cross_entropy_lambda",
                             "num_leaves": 15, "min_data_in_leaf": 5,
                             "metric": ["xentlambda", "xentropy"]}, True),
}


@pytest.mark.parametrize("case", list(OBJECTIVES))
def test_objective_trains_as_jax(case):
    params, weighted = OBJECTIVES[case]
    if case == "multiclassova":
        X, y, Xv, yv = _data("multiclass")
        w = wv = None
    else:
        X, y, w, Xv, yv, wv = _xent_data()
        if not weighted:
            w = wv = None
    p = {**params, **PINS}
    out = {}
    for lgb in (lgb_j, lgb_t):
        pp = dict(p, device_type="cpu") if lgb is lgb_t else p
        ds = lgb.Dataset(X, label=y, weight=w,
                         params={"device_type": "cpu"} if lgb is lgb_t
                         else None)
        vs = lgb.Dataset(Xv, label=yv, weight=wv, reference=ds)
        ev = {}
        cbs = [lgb.record_evaluation(ev)]
        if lgb is lgb_j:
            cbs.append(_per_iteration)
        b = lgb.train(pp, ds, 5, valid_sets=[vs], valid_names=["v"],
                      callbacks=cbs)
        out[lgb] = (b, ev)
    (bj, ej), (bt, et) = out[lgb_j], out[lgb_t]
    assert bt._gbdt.objective.name == bj._gbdt.objective.name
    assert assert_same_sampled_models(bj, bt, X, Xv) is None
    assert ej["v"].keys() == et["v"].keys() and len(et["v"]) > 0
    for m in ej["v"]:
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=1e-4,
                                   atol=1e-6, err_msg=m)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), atol=1e-5)


METRICS = ["average_precision", "auc_mu", "cross_entropy", "xentropy",
           "cross_entropy_lambda", "xentlambda", "kullback_leibler",
           "kldiv"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", METRICS)
def test_metric_values(name, weighted):
    rs = np.random.RandomState(11)
    n = 500
    w = (rs.rand(n) + 0.2) if weighted else None
    if name == "auc_mu":
        params = {"objective": "multiclass", "num_class": 3, "metric": name}
        y = rs.randint(0, 3, n).astype(np.float32)
        score = rs.randn(3, n) + np.eye(3)[y.astype(int)].T
        # exact ties in the projected distances
        score[:, :40] = np.round(score[:, :40], 1)
    else:
        params = {"objective": "binary", "metric": name}
        y = (rs.rand(n) if "entropy" in name or "kl" in name
             or "kullback" in name else rs.rand(n) < 0.3).astype(np.float32)
        score = rs.randn(n)
        score[:50] = np.round(score[:50], 1)  # tied scores
    mj, mt = metrics_j(ConfigJ(params)), metrics_t(ConfigT(params))
    assert len(mj) == len(mt) == 1
    for m in (mj[0], mt[0]):
        m.init(y, w, None)
    vj, vt = mj[0].eval(score), mt[0].eval(score)
    assert vt == vj


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_ranking_metrics_still_refused(name):
    """Ported with ranking (tests/test_torch_ranking.py holds their
    values): the metric is built as the JAX package builds it, and
    without query groups its evaluation fails as the JAX package's
    does."""
    params = {"objective": "binary", "metric": name}
    mj, mt = metrics_j(ConfigJ(params)), metrics_t(ConfigT(params))
    assert [m.name for m in mt] == [m.name for m in mj] == [name]
    msgs = []
    for m in (mj[0], mt[0]):
        m.init(np.zeros(4, np.float32), None, None)
        with pytest.raises(Exception) as ex:
            m.eval(np.zeros(4))
        msgs.append(str(ex.value))
    assert msgs[0] == msgs[1] == f"{name} metric requires query information"
