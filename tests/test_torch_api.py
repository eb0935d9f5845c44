"""The Python API surface of the port: the Dataset and Booster accessors,
Dataset.subset, rollback_one_iter and refit, held against the JAX
package on the same seeded inputs (JAX on the CPU), and the public names
of the JAX package, each present in the port or refused with its ROADMAP
item.

Tolerances: feature_importance split counts exact and gains within rtol
1e-5; scores after rollback_one_iter and refitted leaf values within
1e-6; subset bin matrices and metadata exact; trees_to_dataframe frames
equal (exactly on one model text; on two trained models the numbers
within rtol 1e-5, split gains within 1e-5 of the largest gain).
"""

import inspect
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu.sklearn as skl_j
import lightgbm_tpu_torch as lgb_t
import lightgbm_tpu_torch.sklearn as skl_t
from lightgbm_tpu_torch.log import LightGBMError
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
CPU = {"device_type": "cpu"}
TASKS = {
    "binary": {"objective": "binary", "num_leaves": 15,
               "min_data_in_leaf": 5, "metric": "auc"},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "num_leaves": 7, "min_data_in_leaf": 10},
    "regression": {"objective": "regression", "num_leaves": 15,
                   "min_data_in_leaf": 5, "lambda_l1": 0.5,
                   "max_delta_step": 0.4},
}
ROUNDS = 6


def _data(task, n=600, f=6, seed=11):
    rs = np.random.RandomState(seed)
    X = rs.randn(n + 200, f)
    X[rs.rand(n + 200, f) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(f)
    if task == "binary":
        y = (z + 0.3 * rs.randn(n + 200) > 0).astype(float)
    elif task == "regression":
        y = z + 0.1 * rs.randn(n + 200)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


def _train(lgb, task, rounds=ROUNDS, data=None, **kw):
    X, y, Xv, yv = data or _data(task)
    p = {**TASKS[task], **PINS, **(CPU if lgb is lgb_t else {})}
    ds = lgb.Dataset(X, label=y, free_raw_data=False,
                     params=CPU if lgb is lgb_t else None)
    vs = lgb.Dataset(Xv, label=yv, reference=ds)
    return lgb.train(p, ds, rounds, valid_sets=[vs], valid_names=["v"],
                     **kw)


def _eager(env):
    """A no-op before-iteration callback: keeps train on its eager loop."""


_eager.before_iteration = True


@pytest.fixture(scope="module", params=list(TASKS))
def pair(request):
    task = request.param
    return task, _train(lgb_j, task), _train(lgb_t, task)


# ---- Dataset accessors (module 1)
def test_dataset_accessors_match():
    X, y, Xv, yv = _data("binary")
    w = np.linspace(0.5, 1.5, len(y))
    out = {}
    for lgb in (lgb_j, lgb_t):
        ds = lgb.Dataset(X, label=y, free_raw_data=False,
                         params={"max_bin": 63, "learning_rate": 0.5,
                                 **(CPU if lgb is lgb_t else {})})
        shape0 = (ds.num_data(), ds.num_feature())
        ds.set_field("weight", w)
        ds.set_init_score(np.full(len(y), 0.25))
        ds.set_position(np.zeros(len(y), np.int32))
        vs = ds.create_valid(Xv, label=yv)
        ds.construct()
        params = ds.get_params()
        params.pop("device_type", None)
        out[lgb] = dict(
            shape0=shape0, shape=(ds.num_data(), ds.num_feature()),
            params=params,
            fields={f: ds.get_field(f) for f in
                    ("label", "weight", "init_score", "position", "group")},
            bins=[ds.feature_num_bin(i) for i in range(X.shape[1])]
            + [ds.feature_num_bin("Column_2")],
            names=ds.get_feature_name(), data=ds.get_data(),
            valid_ref=vs.reference is ds, chain=len(vs.get_ref_chain()),
            meta={f: getattr(ds._binned.metadata, f) for f in
                  ("label", "weight", "init_score", "position", "group")},
        )
        with pytest.raises(KeyError):
            ds.set_field("nope", y)
        with pytest.raises(LightGBMError if lgb is lgb_t
                           else lgb_j.basic.LightGBMError):
            ds.set_reference(vs)
    j, t = out[lgb_j], out[lgb_t]
    for k in ("shape0", "shape", "params", "bins", "names", "valid_ref",
              "chain"):
        assert t[k] == j[k], k
    np.testing.assert_array_equal(t["data"], j["data"])
    for f in j["fields"]:
        for d in ("fields", "meta"):
            a, b = j[d][f], t[d][f]
            assert (a is None) == (b is None), (d, f)
            if a is not None:
                np.testing.assert_array_equal(b, a)
                assert b.dtype == a.dtype, (d, f)


def test_get_data_after_free_and_names():
    X, y, *_ = _data("binary")
    ds = lgb_t.Dataset(X, label=y, params=CPU)
    ds.construct()
    with pytest.raises(LightGBMError):
        ds.get_data()
    ds.set_feature_name([f"g{i}" for i in range(X.shape[1])])
    assert ds.get_feature_name() == [f"g{i}" for i in range(X.shape[1])]
    with pytest.raises(LightGBMError):
        ds.set_feature_name(["too", "short"])
    with pytest.raises(LightGBMError):
        ds.set_categorical_feature([0])


@pytest.mark.parametrize("field", ["label", "weight", "init_score"])
def test_setter_after_construct_trains_as_jax(field):
    """A setter after construct reaches the binned metadata, and the
    Booster made afterwards trains on it, in both packages alike."""
    X, y, Xv, yv = _data("binary")
    rs = np.random.RandomState(5)
    new = {"label": 1.0 - y, "weight": rs.uniform(0.2, 2.0, len(y)),
           "init_score": rs.randn(len(y)) * 0.3}[field]
    texts = []
    for lgb in (lgb_j, lgb_t):
        ds = lgb.Dataset(X, label=y, params=CPU if lgb is lgb_t else None)
        ds.construct()
        getattr(ds, f"set_{field}")(new)
        p = {**TASKS["binary"], **PINS, **(CPU if lgb is lgb_t else {})}
        texts.append(lgb.train(p, ds, 3).model_to_string())
    _same_trees(texts[0], texts[1])


def _tree_part(text):
    return text.split("end of trees")[0]


def _trees(text):
    trees, cur = [], None
    for line in _tree_part(text).splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    return trees


def _same_trees(ta, tb):
    """The same structure and leaf values within rtol 1e-5."""
    a, b = _trees(ta), _trees(tb)
    assert len(a) == len(b) > 0
    for x, z in zip(a, b):
        for k in ("num_leaves", "split_feature", "threshold",
                  "left_child", "right_child", "leaf_count"):
            assert x.get(k) == z.get(k), k
        np.testing.assert_allclose(np.array(z["leaf_value"].split(), float),
                                   np.array(x["leaf_value"].split(), float),
                                   rtol=1e-5, atol=1e-7)
    return True


# ---- Dataset.subset and copy_subrow (module 2)
def _onehot(n=700, seed=3):
    """Columns that EFB bundles (one-hot levels of two fields) beside two
    dense ones, and a binary label."""
    rs = np.random.RandomState(seed)
    a = rs.randint(0, 6, n)
    b = rs.randint(0, 5, n)
    X = np.column_stack([np.eye(6)[a], np.eye(5)[b], rs.randn(n, 2)])
    y = ((a == 2) | (X[:, -1] > 0.5)).astype(float)
    return X, y


@pytest.mark.parametrize("constructed", [True, False])
def test_subset_bins_and_metadata_exact(constructed):
    X, y = _onehot()
    rs = np.random.RandomState(1)
    idx = np.sort(rs.choice(len(y), 333, replace=False))
    w = rs.uniform(0.5, 2.0, len(y))
    subs = {}
    for lgb in (lgb_j, lgb_t):
        ds = lgb.Dataset(X, label=y, weight=w, free_raw_data=False,
                         init_score=np.arange(len(y)) * 1e-3,
                         params=CPU if lgb is lgb_t else None)
        if constructed:
            ds.construct()
        sub = ds.subset(idx).construct()
        subs[lgb] = (ds, sub)
    (dj, sj), (dt, st) = subs[lgb_j], subs[lgb_t]
    bj, bt = sj._binned, st._binned
    assert bt.bundle_layout is not None  # the fixture bundles
    np.testing.assert_array_equal(bt.bins, bj.bins)
    assert bt.bins.dtype == bj.bins.dtype
    assert bt.num_data == bj.num_data == 333
    assert bt.num_rows_padded() == bj.num_rows_padded()
    assert bt.row_block == dt._binned.row_block
    assert bt.mappers is dt._binned.mappers
    assert bt.bundle_layout is dt._binned.bundle_layout
    np.testing.assert_array_equal(bt.used_features, bj.used_features)
    for f in ("label", "weight", "init_score", "position", "group"):
        a, b = getattr(bj.metadata, f), getattr(bt.metadata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(st.used_indices, idx)
    np.testing.assert_array_equal(st.get_label(), y[idx])
    assert st.reference is dt


def test_subset_pads_as_from_numpy():
    """A subset pads its rows as from_numpy pads a matrix of its size."""
    X, y = _onehot(n=2100)
    ds = lgb_t.Dataset(X, label=y, params={**CPU, "tpu_row_block": 1024})
    ds.construct()
    sub = ds.subset(np.arange(2003))
    direct = lgb_t.Dataset(X[:2003], label=y[:2003],
                           params={**CPU, "tpu_row_block": 1024}).construct()
    assert sub._binned.num_rows_padded() == \
        direct._binned.num_rows_padded() == 2048


def test_subset_query_alignment():
    X, y = _onehot(n=60)
    group = np.array([10, 20, 30])
    ds = lgb_t.Dataset(X, label=y, group=group, params=CPU)
    ds.construct()
    aligned = ds.subset(np.arange(10, 60))
    assert list(aligned.get_group()) == [20, 30]
    dj = lgb_j.Dataset(X, label=y, group=group)
    dj.construct()
    assert list(dj.subset(np.arange(10, 60)).get_group()) == [20, 30]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cut = ds.subset(np.arange(5, 60))
    assert cut.get_group() is None
    assert dj.subset(np.arange(5, 60)).get_group() is None


def test_subset_trains_as_jax():
    X, y = _onehot()
    idx = np.arange(0, len(y), 2)
    texts = []
    for lgb in (lgb_j, lgb_t):
        ds = lgb.Dataset(X, label=y, params=CPU if lgb is lgb_t else None)
        ds.construct()
        p = {**TASKS["binary"], **PINS, **(CPU if lgb is lgb_t else {})}
        texts.append(lgb.train(p, ds.subset(idx), 4).model_to_string())
    _same_trees(texts[0], texts[1])


# ---- Booster accessors (module 3)
def test_feature_importance(pair):
    _, bj, bt = pair
    np.testing.assert_array_equal(bt.feature_importance("split"),
                                  bj.feature_importance("split"))
    np.testing.assert_allclose(bt.feature_importance("gain"),
                               bj.feature_importance("gain"), rtol=1e-5)
    assert bt.feature_name() == bj.feature_name()
    assert bt.num_feature() == bj.num_feature()
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration()
    assert bt.current_iteration() == bj.current_iteration() == ROUNDS


def _valid_scores(b):
    g = b._gbdt
    return np.asarray(g.get_score(g.valids[0]))


@pytest.mark.parametrize("n_back", [1, 3])
def test_rollback_one_iter(pair, n_back):
    task = pair[0]
    bj, bt = _train(lgb_j, task), _train(lgb_t, task)
    for _ in range(n_back):
        bj.rollback_one_iter()
        assert bt.rollback_one_iter() is bt
    assert bt.current_iteration() == bj.current_iteration() == \
        ROUNDS - n_back
    assert bt.num_trees() == bj.num_trees()
    assert len(bt._gbdt.device_trees) == bt.num_trees()
    np.testing.assert_allclose(_valid_scores(bt), _valid_scores(bj),
                               atol=1e-6)
    np.testing.assert_allclose(bt._gbdt.get_score(bt._gbdt.train),
                               bj._gbdt.get_score(bj._gbdt.train), atol=1e-6)
    # against a model trained n_back iterations fewer, on the eager loop
    fewer = _train(lgb_t, task, ROUNDS - n_back, callbacks=[_eager])
    np.testing.assert_allclose(_valid_scores(bt), _valid_scores(fewer),
                               atol=1e-6)


def test_rollback_then_train_again():
    """Rolling every iteration back restores the initial scores, and the
    next iteration boosts from the average again: it adds the initial
    score to the score sets and stores it in its trees. (The trees
    themselves may differ: the subtraction leaves ulps in the scores, and
    the stochastic rounding of the int16 levels turns ulps into other
    levels.)"""
    bt = _train(lgb_t, "binary", 2, callbacks=[_eager])
    init = list(bt._gbdt._init_scores)
    assert abs(init[0]) > 0.01
    bt.rollback_one_iter()
    bt.rollback_one_iter()
    assert bt.num_trees() == 0 and bt.current_iteration() == 0
    np.testing.assert_allclose(_valid_scores(bt), 0.0, atol=1e-6)
    bt.update()
    ref = _train(lgb_t, "binary", 1, callbacks=[_eager])
    assert bt._gbdt._init_scores == init
    np.testing.assert_allclose(_valid_scores(bt).mean(),
                               _valid_scores(ref).mean(), atol=0.05)
    np.testing.assert_allclose(bt.predict(_data("binary")[2], raw_score=True),
                               _valid_scores(bt)[0], atol=1e-5)


def test_refit_matches_jax(pair):
    task, bj, bt = pair
    X, y, Xv, yv = _data(task, seed=23)
    before = bt.model_to_string()
    rj = bj.refit(Xv, yv, decay_rate=0.3)
    rt = bt.refit(Xv, yv, decay_rate=0.3)
    assert bt.model_to_string() == before  # the source is unchanged
    for tj, tt in zip(rj._gbdt.models, rt._gbdt.models):
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, atol=1e-6)
    np.testing.assert_allclose(rt.predict(Xv, raw_score=True),
                               rj.predict(Xv, raw_score=True), atol=1e-5)
    # the device trees carry the refitted values
    for t, a in zip(rt._gbdt.models, rt._gbdt.device_trees):
        np.testing.assert_allclose(a.leaf_value[: t.num_leaves].numpy(),
                                   t.leaf_value, rtol=1e-6, atol=1e-7)


def test_refit_of_loaded_model_on_cpu():
    bt = _train(lgb_t, "binary")
    X, y, Xv, yv = _data("binary", seed=23)
    loaded = lgb_t.Booster(params=CPU, model_str=bt.model_to_string())
    a = loaded.refit(Xv, yv).predict(Xv, raw_score=True)
    np.testing.assert_allclose(a, bt.refit(Xv, yv).predict(
        Xv, raw_score=True), atol=1e-9)


def test_leaf_output(pair):
    task, bj, bt = pair
    _, _, Xv, _ = _data(task)
    bj = lgb_j.Booster(model_str=bj.model_to_string())
    bt2 = _train(lgb_t, task)
    for b in (bj, bt2):
        v = b.get_leaf_output(1, 2)
        b.set_leaf_output(1, 2, v + 0.75)
        assert b.get_leaf_output(1, 2) == pytest.approx(v + 0.75)
    assert float(bt2._gbdt.device_trees[1].leaf_value[2]) == \
        pytest.approx(bt2.get_leaf_output(1, 2), rel=1e-6)
    ref = _train(lgb_t, task)
    diff = bt2.predict(Xv, raw_score=True) - ref.predict(Xv, raw_score=True)
    leaf = ref.predict(Xv, pred_leaf=True)[:, 1] == 2
    k = 1 % ref.num_model_per_iteration()
    d = diff if diff.ndim == 1 else diff[:, k]
    np.testing.assert_allclose(d[leaf], 0.75, atol=1e-9)
    np.testing.assert_allclose(d[~leaf], 0.0, atol=1e-12)


def test_bounds(pair):
    task, bj, bt = pair
    assert bt.lower_bound() == pytest.approx(bj.lower_bound(), abs=1e-5)
    assert bt.upper_bound() == pytest.approx(bj.upper_bound(), abs=1e-5)
    raw = bt.predict(_data(task)[2], raw_score=True)
    assert bt.lower_bound() <= raw.min() and raw.max() <= bt.upper_bound()


def test_shuffle_models_same_order_as_jax(pair):
    task, bj, bt = pair
    _, _, Xv, _ = _data(task)
    mj = lgb_j.Booster(model_str=bj.model_to_string())
    mt = _train(lgb_t, task)
    before = mt.predict(Xv, raw_score=True)
    for b in (mj, mt):
        np.random.seed(4)
        b.shuffle_models(1, 5)
    np.testing.assert_allclose(mt.predict(Xv, raw_score=True), before,
                               atol=1e-6)
    orders = [[float(t.leaf_value[0]) for t in b._gbdt.models]
              for b in (mj, mt)]
    np.testing.assert_allclose(orders[1], orders[0], rtol=1e-5, atol=1e-7)
    assert len(mt._gbdt.device_trees) == len(mt._gbdt.models)


def test_trees_to_dataframe(pair):
    task, bj, bt = pair
    same = bj.model_to_string()
    pd.testing.assert_frame_equal(
        lgb_t.Booster(model_str=same).trees_to_dataframe(),
        lgb_j.Booster(model_str=same).trees_to_dataframe())
    ft, fj = bt.trees_to_dataframe(), bj.trees_to_dataframe()
    # a split's gain is a difference of sums of squares: its f32 rounding
    # is relative to the largest gains, not to its own size
    gj = fj.pop("split_gain").to_numpy(dtype=float)
    gt = ft.pop("split_gain").to_numpy(dtype=float)
    np.testing.assert_allclose(gt, gj, rtol=1e-5,
                               atol=1e-5 * np.nanmax(np.abs(gj)))
    pd.testing.assert_frame_equal(ft, fj, check_exact=False, rtol=1e-5,
                                  atol=1e-7)


def test_split_value_histogram(pair):
    task, bj, _ = pair
    text = bj.model_to_string()
    mj, mt = (lgb.Booster(model_str=text) for lgb in (lgb_j, lgb_t))
    for feature in (0, "Column_3"):
        hj, ej = mj.get_split_value_histogram(feature)
        ht, et = mt.get_split_value_histogram(feature)
        np.testing.assert_array_equal(ht, hj)
        np.testing.assert_array_equal(et, ej)
    pd.testing.assert_frame_equal(
        mt.get_split_value_histogram(1, bins=4, xgboost_style=True),
        mj.get_split_value_histogram(1, bins=4, xgboost_style=True))


def test_model_from_string_and_names(pair):
    task, bj, bt = pair
    _, _, Xv, _ = _data(task)
    b = lgb_t.Booster(model_str=bt.model_to_string())
    assert b.model_from_string(bj.model_to_string()) is b
    np.testing.assert_allclose(b.predict(Xv), bj.predict(Xv), atol=1e-12)
    assert b.feature_name() == bj.feature_name()
    assert b.num_feature() == bj.num_feature()
    assert bt.set_train_data_name("tr2") is bt
    assert bt._train_data_name == "tr2"
    with pytest.raises(NotImplementedError, match="eval_train/eval_valid"):
        bt.eval(None, "x")
    free = _train(lgb_t, task)
    assert free.free_dataset() is free and free.train_set is None
    np.testing.assert_allclose(free.predict(Xv), bt.predict(Xv))


def test_save_model_importance_type(tmp_path):
    bt = _train(lgb_t, "binary")
    path = tmp_path / "m.txt"
    bt.save_model(path, importance_type="gain")
    assert path.read_text() == bt.model_to_string(importance_type="gain")


# ---- the public surface (satellite): every public name of the JAX
# package's top level, Dataset, Booster and sklearn estimators is in the
# port or in lightgbm_tpu_torch.NOT_PORTED, whose names raise
def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def _surface():
    names = [n for n in lgb_j.__all__]
    names += [f"Dataset.{n}" for n in _public(lgb_j.Dataset)]
    names += [f"Booster.{n}" for n in _public(lgb_j.Booster)]
    for cls in skl_j.__all__:
        names.append(f"sklearn.{cls}")
        names += [f"sklearn.{cls}.{n}" for n in
                  _public(getattr(skl_j, cls))]
    return sorted(set(names))


def _lookup(root, dotted):
    obj = root
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("name", _surface())
def test_public_name_is_ported_or_refused(name):
    root = skl_t if name.startswith("sklearn.") else lgb_t
    dotted = name.split(".", 1)[1] if name.startswith("sklearn.") else name
    obj = _lookup(root, dotted)  # AttributeError would fail the test
    item = lgb_t.NOT_PORTED.get(name)
    if item is None:
        return
    owner = lgb_t.Booster.__new__(lgb_t.Booster) if "." in name else None
    fn = getattr(owner, dotted.split(".")[1]) if owner is not None else obj
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        fn(*([None] * min(1, len(inspect.signature(fn).parameters)))
           if callable(fn) else ())


def test_not_ported_names_are_public_names_of_the_jax_package():
    surface = set(_surface())
    assert set(lgb_t.NOT_PORTED) <= surface


def test_refusals_name_their_item(tmp_path):
    """Nothing refuses any more: A.10's Sequence, two_round and
    from_sequences construct since the data plane was ported, and A.8's
    set_network joins a process group (here one rank through a file
    store, which a Booster with num_machines = 2 then keeps) and
    free_network leaves it."""
    X, y, *_ = _data("binary")

    class Rows(lgb_t.Sequence):
        def __len__(self):
            return len(X)

        def __getitem__(self, idx):
            return X[idx]

    seq = lgb_t.Dataset(Rows(), label=y, params=CPU).construct()
    ref = lgb_t.Dataset(X, label=y, params=CPU).construct()
    np.testing.assert_array_equal(seq._binned.bins, ref._binned.bins)
    path = tmp_path / "t.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    two = lgb_t.Dataset(str(path), params={**CPU, "two_round": True})
    np.testing.assert_array_equal(two.construct()._binned.bins,
                                  ref._binned.bins)
    import torch.distributed as dist

    lgb_t.set_network("127.0.0.1:12400", num_machines=1, backend="gloo",
                      init_method=f"file://{tmp_path / 'store'}")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        bst = lgb_t.Booster({**CPU, "num_machines": 2},
                            lgb_t.Dataset(X, label=y, params=CPU))
        assert bst._gbdt.tree_learner_resolved == "serial"
    finally:
        lgb_t.Booster(model_str=bst.model_to_string()).free_network()
    assert not dist.is_initialized()
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import BinnedDataset

    fs = BinnedDataset.from_sequences([Rows()], Config({}), label=y)
    np.testing.assert_array_equal(fs.bins, ref._binned.bins)
    assert lgb_t.NOT_PORTED == {}


def test_booster_has_no_attribute_error_on_jax_names():
    """Every public Booster / Dataset method of the JAX package resolves on
    the port's classes (the refused ones raise when called)."""
    for cls_j, cls_t in ((lgb_j.Booster, lgb_t.Booster),
                         (lgb_j.Dataset, lgb_t.Dataset)):
        missing = _public(cls_j) - _public(cls_t)
        assert not missing, missing
    assert torch.get_num_threads() == 1
