"""The callback training loop: lightgbm_tpu_torch.train against
lightgbm_tpu.train on the same seeded inputs, with JAX on the CPU.

The JAX package takes its fused device loop when it can, and that loop
evaluates metrics on the device in f32; a no-op before-iteration callback
keeps it on its per-iteration loop, so both sides evaluate the host
metrics. Trees are the same on either JAX loop.

- early stopping (early_stopping_round in params, first_metric_only,
  min_delta, a train set among valid_sets): the same best_iteration,
  tree count, best_score and eval history (rtol 1e-4, atol 1e-6), on
  fixtures whose best value is apart from every other value of the
  patience window by more than 1e-4 relative (asserted, so a fixture
  cannot drift into a tie);
- reset_parameter (a learning-rate schedule under bagging), feval and
  fobj: the same trees and eval records;
- init_model: continued training from a model text the JAX package saved,
  with bagging (every draw keys on the global iteration), as a path and
  as a Booster; a num_class mismatch is refused.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from test_torch_sampling import assert_same_sampled_models
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
EVAL_TOL = dict(rtol=1e-4, atol=1e-6)
# lr 1 on 800 rows: the validation logloss bottoms out after a few trees
ES_BASE = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 3,
           "learning_rate": 1.0, **PINS}
ROUNDS = 8


def _per_iteration(env):
    """Keeps the JAX package on its per-iteration loop."""


_per_iteration.before_iteration = True


def _run(lgb, params, data, rounds=ROUNDS, valid="valid", callbacks=(),
         **kw):
    X, y, Xv, yv = data
    p = dict(params)
    if lgb is lgb_t:
        p["device_type"] = "cpu"
    ds = lgb.Dataset(X, label=y, params={"device_type": "cpu"}
                     if lgb is lgb_t else None)
    sets = {"valid": [lgb.Dataset(Xv, label=yv, reference=ds)],
            "train": [ds], "both": [ds, lgb.Dataset(Xv, label=yv,
                                                    reference=ds)]}[valid]
    names = {"valid": ["v"], "train": ["tr"], "both": ["tr", "v"]}[valid]
    ev = {}
    cbs = [lgb.record_evaluation(ev), *callbacks]
    if lgb is lgb_j:
        cbs.append(_per_iteration)
    b = lgb.train(p, ds, rounds, valid_sets=sets, valid_names=names,
                  callbacks=cbs, **kw)
    return b, ev


def _both(params, data=None, **kw):
    data = data or _data("binary")
    bj, ej = _run(lgb_j, params, data, **kw)
    bt, et = _run(lgb_t, params, data, **kw)
    return bj, ej, bt, et, data


def _assert_same_run(bj, ej, bt, et, data):
    assert bt.best_iteration == bj.best_iteration
    assert bt.num_trees() == bj.num_trees()
    assert ej.keys() == et.keys()
    for d in ej:
        assert ej[d].keys() == et[d].keys()
        for m in ej[d]:
            np.testing.assert_allclose(et[d][m], ej[d][m], **EVAL_TOL,
                                       err_msg=f"{d} {m}")
    assert bt.best_score.keys() == bj.best_score.keys()
    for d in bj.best_score:
        for m, v in bj.best_score[d].items():
            np.testing.assert_allclose(bt.best_score[d][m], v, **EVAL_TOL)
    X, _, Xv, _ = data
    assert assert_same_sampled_models(bj, bt, X, Xv) is None
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), atol=1e-5)


def _assert_separated(history, best, patience, higher_better):
    """The best value is apart from every value of the patience window
    after it by more than 1e-4 relative, and beats every earlier one."""
    h = np.asarray(history)
    b = h[best - 1]
    window = h[best: best + patience]
    sign = 1.0 if higher_better else -1.0
    assert (sign * (b - window) > 1e-4 * abs(b)).all(), (h, best)
    assert (sign * (b - h[:best - 1]) > 0).all(), (h, best)


ES = {
    "params": ({"early_stopping_round": 2, "metric": "binary_logloss"},
               {}),
    "first_metric_only": ({"early_stopping_round": 2,
                           "first_metric_only": True,
                           "metric": ["binary_logloss", "auc"]}, {}),
    "min_delta": ({"metric": "binary_logloss"},
                  {"callbacks": [lgb_t.early_stopping(2, min_delta=0.02)]}),
}


@pytest.mark.parametrize("case", list(ES))
def test_early_stopping_matches(case):
    extra, kw = ES[case]
    if "callbacks" in kw:
        cb = {"j": [lgb_j.early_stopping(2, min_delta=0.02)],
              "t": kw["callbacks"]}
        data = _data("binary")
        bj, ej = _run(lgb_j, {**ES_BASE, **extra}, data, callbacks=cb["j"])
        bt, et = _run(lgb_t, {**ES_BASE, **extra}, data, callbacks=cb["t"])
    else:
        bj, ej, bt, et, data = _both({**ES_BASE, **extra})
    _assert_same_run(bj, ej, bt, et, data)
    best = bt.best_iteration
    hist = et["v"]["binary_logloss"]
    assert 0 < best < ROUNDS and len(hist) == best + 2  # it stopped
    if case != "min_delta":
        _assert_separated(hist, best, 2, higher_better=False)
    else:
        # min_delta: the stop fires 2 rounds after the last improvement of
        # more than 0.02, whatever smaller gains came after it
        h = np.asarray(hist)
        assert h[best - 1] < h[best - 2] - 0.02 - 1e-4 if best > 1 else True
        assert (h[best:] > h[best - 1] - 0.02 + 1e-4).all(), h


def test_train_set_metrics_never_stop():
    """A training set among valid_sets never triggers the stop; at the
    last round the best training iteration is kept."""
    bj, ej, bt, et, data = _both({**ES_BASE, "early_stopping_round": 1,
                                  "metric": "binary_logloss"},
                                 valid="train", rounds=5)
    _assert_same_run(bj, ej, bt, et, data)
    assert bt.num_trees() == 5 and len(et["tr"]["binary_logloss"]) == 5
    assert bt.best_iteration == 5


def test_reset_parameter_under_bagging():
    """A learning-rate schedule (before-iteration callback, order 10) with
    bagging: the trees and evals of the JAX package."""
    lrs = [0.5, 0.4, 0.3, 0.2, 0.1, 0.05]
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "bagging_fraction": 0.7, "bagging_freq": 1, "metric": "auc",
         **PINS}
    data = _data("binary")
    bj, ej = _run(lgb_j, p, data, rounds=6,
                  callbacks=[lgb_j.reset_parameter(learning_rate=lrs)])
    bt, et = _run(lgb_t, p, data, rounds=6,
                  callbacks=[lgb_t.reset_parameter(learning_rate=lrs)])
    _assert_same_run(bj, ej, bt, et, data)
    assert bt._gbdt.shrinkage_rate == 0.05
    assert [t.shrinkage for t in bt._gbdt.models] == lrs


def _feval(preds, ds):
    y = ds.label if hasattr(ds, "label") else ds.get_label()
    return [("err_at_0.3", float(np.mean((preds > 0.3) != (y > 0.5))), False),
            ("mean_pred", float(np.mean(preds)), True)]


def test_feval_records():
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "metric": "auc", **PINS}
    bj, ej, bt, et, data = _both(p, valid="both", rounds=5, feval=_feval)
    _assert_same_run(bj, ej, bt, et, data)
    assert set(et["v"]) == {"auc", "err_at_0.3", "mean_pred"}
    assert set(et["tr"]) == {"auc", "err_at_0.3", "mean_pred"}


def _logistic_fobj(preds, ds):
    y = ds.label if hasattr(ds, "label") else ds.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def test_fobj_trees():
    """A custom logistic objective under objective none: no boost from
    average, the caller's gradients, identity-converted feval scores."""
    p = {"objective": "none", "num_leaves": 15, "min_data_in_leaf": 5,
         "metric": "binary_logloss", **PINS}
    bj, ej, bt, et, data = _both(p, rounds=5, fobj=_logistic_fobj,
                                 feval=_feval)
    _assert_same_run(bj, ej, bt, et, data)
    assert bt._gbdt.objective is None


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """3 bagged iterations of the JAX package, saved as model text."""
    X, y, _, _ = _data("binary")
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "bagging_fraction": 0.6, "bagging_freq": 2, **PINS}
    path = tmp_path_factory.mktemp("init") / "model.txt"
    lgb_j.train(p, lgb_j.Dataset(X, label=y), 3).save_model(str(path))
    return p, path


@pytest.mark.parametrize("as_booster", [False, True])
def test_init_model_continues_with_bagging(jax_model, as_booster):
    """Continued training draws the bag of the global iteration: trees 4-6
    equal the JAX package's continuation of the same model, and the
    validation scores start from the loaded model's predictions."""
    p, path = jax_model
    data = _data("binary")
    init_t = lgb_t.Booster(model_file=path) if as_booster else path
    bj, ej = _run(lgb_j, p, data, rounds=3, init_model=str(path))
    bt, et = _run(lgb_t, p, data, rounds=3, init_model=init_t)
    assert bt.num_trees() == 6 and bt._gbdt.iter_ == 6
    _assert_same_run(bj, ej, bt, et, data)
    Xv = data[2]
    # the loaded trees come first, unchanged
    start = lgb_t.Booster(model_file=path).predict(Xv, raw_score=True)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True,
                                          num_iteration=3), start,
                               atol=1e-12)


def test_init_model_scores_seeded():
    """_continue_from seeds the train and valid scores with the loaded
    trees' binned traversal: before any new tree the validation score is
    the loaded model's raw prediction."""
    X, y, Xv, yv = _data("binary")
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "device_type": "cpu", **PINS}
    ds = lgb_t.Dataset(X, label=y, params=p)
    src = lgb_t.train(p, ds, 3)
    b = lgb_t.Booster(p, lgb_t.Dataset(X, label=y, params=p))
    b.add_valid(lgb_t.Dataset(Xv, label=yv, reference=b.train_set), "v")
    b._continue_from(src)
    seeded = b._gbdt.valids[0].score[0, :len(Xv)].numpy()
    np.testing.assert_allclose(seeded, src.predict(Xv, raw_score=True),
                               atol=1e-5)
    train_seeded = b._gbdt.train.score[0, :len(X)].numpy()
    np.testing.assert_allclose(train_seeded, src.predict(X, raw_score=True),
                               atol=1e-5)


def test_init_model_num_class_mismatch():
    X, y, _, _ = _data("multiclass", n=300)
    p = {"objective": "multiclass", "num_class": 3, "device_type": "cpu",
         "verbosity": -1}
    src = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 1)
    pb = {"objective": "binary", "device_type": "cpu", "verbosity": -1}
    with pytest.raises(lgb_t.LightGBMError, match="models per iteration"):
        lgb_t.train(pb, lgb_t.Dataset(X, label=(y > 0) * 1.0, params=pb), 1,
                    init_model=src)


def test_keep_training_booster_accepted():
    X, y, _, _ = _data("binary", n=300)
    p = {"objective": "binary", "device_type": "cpu", "verbosity": -1}
    b = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 2,
                    keep_training_booster=True)
    assert b.update() is False and b.num_trees() == 3
