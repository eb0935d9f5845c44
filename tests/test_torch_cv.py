"""lightgbm_tpu_torch.cv against lightgbm_tpu.cv on the same seeded
inputs (JAX on the CPU), and the port's fused cv against its eager cv.

- _make_n_folds: the same fold indices, exactly;
- every results list within atol 1e-6 of the JAX package's, loop for
  loop (both eager: a no-op before-iteration callback; both fused: the
  device metrics), with metrics=, feval, fobj, fpreproc, a splitter and
  an iterable as folds=, eval_train_metric and early stopping, also when
  it fires inside a fused chunk;
- the port's fused cv against its eager cv: every fold's model text and
  validation scores bit for bit (the eval records come from the device
  metrics on one loop and the host metrics on the other: within 1e-6);
- a fold meeting the no-splittable-leaf stop: on the fused loop every
  fold's trees clamped to the iterations that have results, on the eager
  loop each fold stopping on its own while the results run on, as in the
  JAX package;
- return_cvbooster, init_model (every fold continues from it, as
  train() would; the JAX package drops init_model, ROADMAP C);
- ranking: query-aligned folds= on a constructed Dataset keep their
  groups and match the JAX package; the package's own shuffled folds cut
  queries and raw subsets carry no groups, and in both cases both
  packages raise that lambdarank needs the groups (ROADMAP C).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.boosting import _FusedProgram
from lightgbm_tpu_torch.learner.device_loop import BOUNDED
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
CPU = {"device_type": "cpu"}
TOL = dict(rtol=0, atol=1e-6)
BINARY = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "metric": ["auc", "binary_logloss"]}


def _eager(env):
    """A no-op before-iteration callback: keeps cv on its eager loop."""


_eager.before_iteration = True


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """The port's fused step on the CPU runs the graph's bounded loops."""
    monkeypatch.setattr(_FusedProgram, "cpu_loop", BOUNDED)


def _data(task="binary", n=500, f=5, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    z = X @ rs.randn(f)
    if task == "binary":
        y = (z + 0.5 * rs.randn(n) > 0).astype(float)
    elif task == "multiclass":
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    else:
        y = z + 0.2 * rs.randn(n)
    return X, y


def _cv(lgb, params, data, rounds=6, eager=False, ds_kw=None,
        construct=False, **kw):
    X, y = data
    p = {**params, **PINS, **(CPU if lgb is lgb_t else {})}
    ds = lgb.Dataset(X, label=y, free_raw_data=False,
                     params=CPU if lgb is lgb_t else None, **(ds_kw or {}))
    if construct:
        ds.construct()
    cbs = list(kw.pop("callbacks", []))
    if eager:
        cbs.append(_eager)
    return lgb.cv(p, ds, rounds, callbacks=cbs, **kw)


def _assert_results_close(rt, rj):
    assert sorted(k for k in rt if k != "cvbooster") == \
        sorted(k for k in rj if k != "cvbooster")
    for k, v in rj.items():
        if k == "cvbooster":
            continue
        assert len(rt[k]) == len(v), k
        np.testing.assert_allclose(rt[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("stratified", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("nfold", [2, 5])
def test_fold_indices_exact(stratified, shuffle, nfold):
    from lightgbm_tpu.engine import _make_n_folds as folds_j
    from lightgbm_tpu_torch.engine import _make_n_folds as folds_t

    X, y = _data("multiclass", n=203)
    fj = list(folds_j(lgb_j.Dataset(X, label=y), nfold, {}, 7, stratified,
                      shuffle))
    ft = list(folds_t(lgb_t.Dataset(X, label=y, params=CPU), nfold, {}, 7,
                      stratified, shuffle))
    assert len(ft) == len(fj) == nfold
    for (trj, tej), (trt, tet) in zip(fj, ft):
        np.testing.assert_array_equal(trt, trj)
        np.testing.assert_array_equal(tet, tej)


CASES = {
    "binary": (BINARY, "binary", {}),
    "regression": ({"objective": "regression", "num_leaves": 7,
                    "min_data_in_leaf": 5, "metric": ["l2", "l1"]},
                   "regression", {"stratified": False}),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 5, "min_data_in_leaf": 10},
                   "multiclass", {"nfold": 3}),
    "train_metric": (BINARY, "binary", {"eval_train_metric": True,
                                        "nfold": 3}),
    "metrics_arg": (BINARY, "binary", {"metrics": "binary_error",
                                       "shuffle": False}),
}


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_cv_results_match_jax(case, eager):
    params, task, kw = CASES[case]
    data = _data(task)
    rj = _cv(lgb_j, params, data, eager=eager, **kw)
    rt = _cv(lgb_t, params, data, eager=eager, **kw)
    _assert_results_close(rt, rj)


@pytest.mark.parametrize("case", ["binary", "multiclass", "train_metric"])
def test_fused_cv_equals_eager_cv(case):
    params, task, kw = CASES[case]
    data = _data(task)
    out = {}
    for eager in (False, True):
        r = _cv(lgb_t, params, data, eager=eager, return_cvbooster=True,
                **kw)
        out[eager] = r
    bf, be = (out[e]["cvbooster"].boosters for e in (False, True))
    assert len(bf) == len(be)
    for a, b in zip(bf, be):
        assert a.model_to_string() == b.model_to_string()
        for sa, sb in zip([a._gbdt.train] + a._gbdt.valids,
                          [b._gbdt.train] + b._gbdt.valids):
            assert np.array_equal(sa.score.numpy(), sb.score.numpy())
        assert a._gbdt._fused is not None and b._gbdt._fused is None
    _assert_results_close(out[False], out[True])


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "fused"])
def test_early_stopping_inside_a_chunk(eager):
    """lr 1 on 500 rows: the validation logloss bottoms out after a few
    trees, inside the first 64-iteration chunk of the fused loop."""
    params = {**BINARY, "learning_rate": 1.0, "metric": "binary_logloss",
              "early_stopping_round": 2}
    data = _data("binary")
    rj = _cv(lgb_j, params, data, rounds=20, eager=eager,
             return_cvbooster=True)
    rt = _cv(lgb_t, params, data, rounds=20, eager=eager,
             return_cvbooster=True)
    cj, ct = rj["cvbooster"], rt["cvbooster"]
    assert 0 < ct.best_iteration == cj.best_iteration < 18
    _assert_results_close(rt, rj)
    assert len(rt["valid binary_logloss-mean"]) == ct.best_iteration
    for b in ct.boosters:
        assert b.best_iteration == ct.best_iteration
        # the trees through the stop iteration stay (best + patience)
        assert b.num_trees() == ct.best_iteration + 2
    assert [b.num_trees() for b in ct.boosters] == \
        [b.num_trees() for b in cj.boosters]


def test_early_stopping_fused_equals_eager():
    params = {**BINARY, "learning_rate": 1.0, "metric": "binary_logloss",
              "early_stopping_round": 2}
    data = _data("binary")
    rf = _cv(lgb_t, params, data, rounds=20, return_cvbooster=True)
    re = _cv(lgb_t, params, data, rounds=20, eager=True,
             return_cvbooster=True)
    assert rf["cvbooster"].best_iteration == re["cvbooster"].best_iteration
    for a, b in zip(rf["cvbooster"].boosters, re["cvbooster"].boosters):
        assert a.model_to_string() == b.model_to_string()
    _assert_results_close(rf, re)


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "fused"])
def test_no_splittable_leaf_stop_clamps_every_fold(eager):
    """min_gain_to_split: the folds stop splitting after a few trees, not
    all at the same iteration; every fold keeps the iterations that have
    results, as in the JAX package."""
    params = {**BINARY, "learning_rate": 0.8, "metric": "binary_logloss",
              "min_gain_to_split": 6.0, "num_leaves": 4}
    data = _data("binary", n=300, seed=9)
    rj = _cv(lgb_j, params, data, rounds=12, eager=eager,
             return_cvbooster=True, nfold=3)
    rt = _cv(lgb_t, params, data, rounds=12, eager=eager,
             return_cvbooster=True, nfold=3)
    _assert_results_close(rt, rj)
    n = len(rt["valid binary_logloss-mean"])
    trees_t = [b.num_trees() for b in rt["cvbooster"].boosters]
    trees_j = [b.num_trees() for b in rj["cvbooster"].boosters]
    assert trees_t == trees_j
    if eager:
        # the eager loop runs on: the stopped folds evaluate unchanged
        assert n == 12 and len(set(trees_t)) > 1
    else:
        assert n < 12 and trees_t == [n] * 3


def test_feval_fobj_fpreproc_match_jax():
    def feval(preds, ds):
        return "mean_pred", float(np.mean(preds)), False

    def fobj(preds, ds):
        y = ds.get_label()
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - y, p * (1.0 - p)

    def fpreproc(tr, te, params):
        params = dict(params)
        params["learning_rate"] = 0.3
        return tr, te, params

    data = _data("binary")
    for kw in ({"feval": feval}, {"fobj": fobj,
                                  "params": {"objective": "none",
                                             "num_leaves": 7,
                                             "metric": "auc"}},
               {"fpreproc": fpreproc}):
        kw = dict(kw)
        params = kw.pop("params", BINARY)
        rj = _cv(lgb_j, params, data, **kw)
        rt = _cv(lgb_t, params, data, **kw)
        _assert_results_close(rt, rj)


def test_folds_argument_match_jax():
    from sklearn.model_selection import StratifiedKFold

    data = _data("binary")
    skf = StratifiedKFold(n_splits=3, shuffle=True, random_state=2)
    rj = _cv(lgb_j, BINARY, data, folds=skf)
    rt = _cv(lgb_t, BINARY, data, folds=skf)
    _assert_results_close(rt, rj)
    idx = np.arange(len(data[1]))
    folds = [(idx[idx % 4 != k], idx[idx % 4 == k]) for k in range(4)]
    rj = _cv(lgb_j, BINARY, data, folds=iter(folds))
    rt = _cv(lgb_t, BINARY, data, folds=iter(folds))
    _assert_results_close(rt, rj)


def test_return_cvbooster():
    data = _data("binary")
    r = _cv(lgb_t, BINARY, data, nfold=4, return_cvbooster=True)
    cvb = r["cvbooster"]
    assert isinstance(cvb, lgb_t.CVBooster) and len(cvb.boosters) == 4
    assert cvb.num_trees() == [6] * 4
    preds = cvb.predict(data[0][:10])
    assert len(preds) == 4 and all(p.shape == (10,) for p in preds)
    assert "cvbooster" not in _cv(lgb_t, BINARY, data)


def test_init_model_seeds_every_fold(tmp_path):
    data = _data("binary")
    X, y = data
    p = {**BINARY, **PINS, **CPU}
    init = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=CPU), 3)
    path = tmp_path / "init.txt"
    init.save_model(path)
    for model in (init, str(path)):
        r = _cv(lgb_t, BINARY, data, rounds=2, eager=True, nfold=2,
                init_model=model, return_cvbooster=True)
        ds = lgb_t.Dataset(X, label=y, params=CPU).construct()
        for b in r["cvbooster"].boosters:
            tr = b.train_set.used_indices
            te = b._valid_sets[0].used_indices
            ref = lgb_t.train(p, ds.subset(tr), 2, init_model=init,
                              valid_sets=[ds.subset(te)],
                              callbacks=[_eager])
            assert b.num_trees() == 5
            assert b.model_to_string() == ref.model_to_string()


def _ranking(n_q=12, seed=5):
    rs = np.random.RandomState(seed)
    sizes = rs.randint(15, 30, n_q)
    n = int(sizes.sum())
    X = rs.randn(n, 4)
    y = np.clip(np.round(X[:, 0] + 0.5 * rs.randn(n) + 1), 0, 3)
    return X, y, sizes


def test_lambdarank_cv_with_query_aligned_folds():
    X, y, sizes = _ranking()
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    q = np.repeat(np.arange(len(sizes)), sizes)
    folds = [(np.flatnonzero(q % 3 != k), np.flatnonzero(q % 3 == k))
             for k in range(3)]
    params = {"objective": "lambdarank", "num_leaves": 7,
              "min_data_in_leaf": 5, "eval_at": [3, 5]}
    out = {}
    for lgb in (lgb_j, lgb_t):
        # constructed first: a raw subset carries no groups (both
        # packages), so folds= on an unconstructed ranking set fails
        out[lgb] = _cv(lgb, params, (X, y), eager=True, folds=folds,
                       ds_kw={"group": sizes}, return_cvbooster=True,
                       construct=True)
    _assert_results_close(out[lgb_t], out[lgb_j])
    b0 = out[lgb_t]["cvbooster"].boosters[0]
    assert list(b0.train_set.get_group()) == \
        [int(s) for k, s in enumerate(sizes) if k % 3 != 0]
    assert bounds[-1] == len(y)


@pytest.mark.parametrize("how", ["shuffled_folds", "raw_subsets"])
def test_lambdarank_cv_without_groups_fails_alike(how):
    """The package's own folds shuffle rows across queries; folds= on a
    Dataset not yet constructed subsets the raw rows, which carry no
    groups. Both packages raise that lambdarank needs them."""
    X, y, sizes = _ranking()
    q = np.repeat(np.arange(len(sizes)), sizes)
    kw = ({"nfold": 3} if how == "shuffled_folds" else
          {"folds": [(np.flatnonzero(q % 2 != k), np.flatnonzero(q % 2 == k))
                     for k in range(2)]})
    params = {"objective": "lambdarank", "num_leaves": 7}
    for lgb in (lgb_j, lgb_t):
        with pytest.raises(Exception, match="query group"):
            _cv(lgb, params, (X, y), ds_kw={"group": sizes}, **kw)
