"""Categorical splits: the port against the JAX package on the same seeded
inputs.

- The batched best_split against the JAX package's best_split on random
  (3, F, B) histograms with categorical features (one-vs-rest only, and
  with the sorted-subset scan), NaN bins and a small max_cat_threshold:
  the chosen record and its category set exactly, gains within rtol
  1e-6; the scan also against the literal transcription of the
  reference's sorted-subset loop in tests/test_categorical.py.
- The plain categorical round (histogram.round_partition_plain with a
  category mask) against the JAX package's non-fused round math
  (rounds.py:784-816), transcribed here in jnp.
- End to end, `train` on categorical data (one-vs-rest only,
  sorted-subset, NaN in the categorical columns, EFB beside them) on the
  default int16 path: tree sections of the model text equal, raw
  predictions within 1e-5, the same validation metrics; the spec flags
  (cat_subset, has_cat) as the JAX package resolves them.
- Model text round trip, the converter on a JAX-grown categorical model,
  Tree.from_arrays' category bitsets, and training quality on a label
  made from a random subset of categories.

The other growth paths (quantized, bf16x2, exact, exact + rounds) and
objectives are in tests/test_torch_categorical_paths.py.
"""

import jax.extend  # noqa: F401  (see tests/test_torch_rounds.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.learner.grower import make_split_params as params_j
from lightgbm_tpu.learner.split import best_split as best_j
from lightgbm_tpu.tree import Tree as TreeJ
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.convert import (booster_from_model_string,
                                        tree_arrays_from_numpy)
from lightgbm_tpu_torch.learner import histogram as ht
from lightgbm_tpu_torch.learner.grower import make_split_params as params_t
from lightgbm_tpu_torch.learner.split import best_split as best_t
from lightgbm_tpu_torch.tree import Tree as TreeT
from lightgbm_tpu_torch.tree import traverse_tree_bins as traverse_t
from test_categorical import _oracle_cat_subset
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}

# ------------------------------------------------------------ split search
F, B, N = 6, 24, 900


def _leaf(seed, cards):
    """One leaf's (3, F, B) histogram from integer rows: features with a
    card in `cards` (feature -> categories) are categorical, the others
    numerical; about half the features get a NaN bin (the last one)."""
    rs = np.random.RandomState(seed)
    num_bins = rs.randint(6, B + 1, F).astype(np.int32)
    is_cat = np.zeros(F, bool)
    for f, k in cards.items():
        num_bins[f] = k
        is_cat[f] = True
    nan_bin = np.where(rs.rand(F) < 0.5, num_bins - 1, -1).astype(np.int32)
    # skewed bin frequencies so some categories fall under cat_smooth
    bins = np.stack([np.minimum(rs.geometric(2.5 / nb, N) - 1, nb - 1)
                     for nb in num_bins])
    gq = rs.randint(-128, 129, N) + 40 * (bins[0] % 3)
    hq = rs.randint(1, 257, N)
    scale = np.array([1e-2, 1e-3, 1.0], np.float32)
    hist = np.zeros((3, F, B), np.float32)
    for f in range(F):
        for c, v in enumerate((gq, hq, np.ones(N))):
            hist[c, f] = np.bincount(bins[f], weights=v, minlength=B)
    hist *= scale[:, None, None]
    sums = np.array([gq.sum(), hq.sum(), N], np.float32) * scale
    return hist, sums, num_bins, nan_bin, is_cat


SPLIT_PARAMS = {
    "default": {"min_data_in_leaf": 5, "min_data_per_group": 20},
    "regularized": {"min_data_in_leaf": 5, "lambda_l1": 0.3,
                    "lambda_l2": 1.5, "cat_l2": 3.0, "cat_smooth": 4.0,
                    "min_data_per_group": 10},
    # few subset prefixes: the min_data_per_group loop runs 2 steps
    "max_cat_threshold_2": {"min_data_in_leaf": 5, "max_cat_threshold": 2,
                            "min_data_per_group": 15},
    "path_smooth": {"min_data_in_leaf": 3, "path_smooth": 2.0,
                    "min_data_per_group": 30, "max_cat_to_onehot": 8},
}
CARDS = {"onehot": {0: 3, 4: 4}, "subset": {0: 18, 2: 4, 4: 24}}


def _search_both(seed, cards, pname, cat_subset):
    hist, sums, num_bins, nan_bin, is_cat = _leaf(seed, cards)
    mono = np.zeros(F, np.int32)
    cfg = SPLIT_PARAMS[pname]
    po = np.float32(0.21)
    rj = best_j(jnp.asarray(hist), sums[0], sums[1], sums[2],
                jnp.asarray(num_bins), jnp.asarray(nan_bin),
                jnp.asarray(mono), jnp.asarray(is_cat),
                params_j(ConfigJ(cfg)), jnp.ones(F, bool),
                cat_subset=cat_subset, parent_output=po)
    rt = best_t(torch.from_numpy(hist)[None],
                *[torch.from_numpy(sums[i:i + 1]) for i in range(3)],
                torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
                torch.from_numpy(mono), params_t(ConfigT(cfg)),
                torch.ones(F, dtype=torch.bool),
                parent_output=torch.tensor([po]),
                is_cat=torch.from_numpy(is_cat), cat_subset=cat_subset)
    return rj, rt


def _assert_same_record(rj, rt):
    for f in ("feature", "bin", "default_left", "is_cat"):
        assert int(getattr(rt, f)[0]) == int(getattr(rj, f)), f
    np.testing.assert_array_equal(rt.cat_mask[0].numpy(),
                                  np.asarray(rj.cat_mask))
    np.testing.assert_allclose(float(rt.gain[0]), float(rj.gain), rtol=1e-6)
    for f in ("left_g", "left_h", "left_c", "right_g", "right_h", "right_c"):
        np.testing.assert_allclose(float(getattr(rt, f)[0]),
                                   float(getattr(rj, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("pname", list(SPLIT_PARAMS))
@pytest.mark.parametrize("cat_subset", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_split_matches_jax(pname, cat_subset, seed):
    rj, rt = _search_both(seed, CARDS["subset"], pname, cat_subset)
    _assert_same_record(rj, rt)


@pytest.mark.parametrize("seed", range(6))
def test_categorical_split_chosen_and_matches_jax(seed):
    """With the numerical features masked out, the winner is categorical:
    one-vs-rest on the narrow features, a subset on the wide ones."""
    hist, sums, num_bins, nan_bin, is_cat = _leaf(seed, CARDS["subset"])
    cfg = params_j(ConfigJ(SPLIT_PARAMS["default"]))
    fm = is_cat.copy()
    rj = best_j(jnp.asarray(hist), sums[0], sums[1], sums[2],
                jnp.asarray(num_bins), jnp.asarray(nan_bin),
                jnp.zeros(F, jnp.int32), jnp.asarray(is_cat), cfg,
                jnp.asarray(fm), cat_subset=True)
    rt = best_t(torch.from_numpy(hist)[None],
                *[torch.from_numpy(sums[i:i + 1]) for i in range(3)],
                torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
                torch.zeros(F, dtype=torch.int32),
                params_t(ConfigT(SPLIT_PARAMS["default"])),
                torch.from_numpy(fm), is_cat=torch.from_numpy(is_cat),
                cat_subset=True)
    assert bool(rt.is_cat[0]) and float(rt.gain[0]) > 0
    _assert_same_record(rj, rt)


def test_batched_leaves_match_one_by_one():
    """A batch of leaves gives each leaf the record the JAX package finds
    for it alone."""
    leaves = [_leaf(s, CARDS["subset"]) for s in range(4)]
    hist = torch.from_numpy(np.stack([lf[0] for lf in leaves]))
    sums = np.stack([lf[1] for lf in leaves])
    num_bins, nan_bin, is_cat = leaves[0][2], leaves[0][3], leaves[0][4]
    cfg = SPLIT_PARAMS["default"]
    rt = best_t(hist, *[torch.from_numpy(sums[:, i].copy())
                        for i in range(3)],
                torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
                torch.zeros(F, dtype=torch.int32), params_t(ConfigT(cfg)),
                torch.ones(F, dtype=torch.bool),
                is_cat=torch.from_numpy(is_cat), cat_subset=True)
    for i, lf in enumerate(leaves):
        rj = best_j(jnp.asarray(lf[0]), *lf[1], jnp.asarray(num_bins),
                    jnp.asarray(nan_bin), jnp.zeros(F, jnp.int32),
                    jnp.asarray(is_cat), params_j(ConfigJ(cfg)),
                    jnp.ones(F, bool), cat_subset=True)
        assert int(rt.feature[i]) == int(rj.feature)
        assert bool(rt.is_cat[i]) == bool(rj.is_cat)
        np.testing.assert_array_equal(rt.cat_mask[i].numpy(),
                                      np.asarray(rj.cat_mask))
        np.testing.assert_allclose(float(rt.gain[i]), float(rj.gain),
                                   rtol=1e-6)


def test_numerical_search_leaves_categorical_fields_out():
    """Without is_cat (a dataset with no categorical feature) the search
    tries only the numerical directions: its records carry no is_cat or
    cat_mask, and the rest equals the search with an all-False is_cat."""
    hist, sums, num_bins, nan_bin, _ = _leaf(3, {})
    args = (torch.from_numpy(hist)[None],
            *[torch.from_numpy(sums[i:i + 1]) for i in range(3)],
            torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
            torch.zeros(F, dtype=torch.int32),
            params_t(ConfigT(SPLIT_PARAMS["default"])))
    bare = best_t(*args)
    full = best_t(*args, is_cat=torch.zeros(F, dtype=torch.bool))
    assert bare.is_cat is None and bare.cat_mask is None
    assert not bool(full.is_cat[0]) and not bool(full.cat_mask.any())
    for name in bare._fields:
        if name not in ("is_cat", "cat_mask"):
            assert torch.equal(getattr(bare, name), getattr(full, name))


def test_numerical_dataset_resolves_has_cat_false():
    """has_cat is off unless the dataset has a categorical feature: the
    spec's default, and what training on numerical columns resolves."""
    from lightgbm_tpu_torch.learner.grower import GrowerSpec

    assert GrowerSpec._field_defaults["has_cat"] is False
    rs = np.random.RandomState(5)
    X = rs.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "device_type": "cpu",
         "verbosity": -1}
    bst = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 2)
    assert not bst._gbdt.spec.has_cat and not bst._gbdt.spec.cat_subset


@pytest.mark.parametrize("max_cat_threshold", [2, 5, 32])
def test_cat_subset_matches_reference_oracle(max_cat_threshold):
    """One categorical feature: the port's sorted-subset winner is the
    reference loop's (tests/test_categorical.py's transcription), also
    when max_cat_threshold truncates the min_data_per_group loop."""
    rs = np.random.RandomState(max_cat_threshold)
    Bk = 32
    g = rs.randn(Bk) * 5
    h = 1.0 + rs.rand(Bk) * 50
    c = np.round(h)
    pd = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=1.0,
              min_sum_hessian_in_leaf=0.0, cat_smooth=10.0, cat_l2=10.0,
              max_cat_threshold=max_cat_threshold, max_cat_to_onehot=4,
              min_data_per_group=25.0)
    cfg = {k: v for k, v in pd.items()}
    hist = torch.tensor(np.stack([g, h, c])[None, :, None, :],
                        dtype=torch.float32)
    sums = [torch.tensor([float(np.float32(v.sum()))]) for v in (g, h, c)]
    rt = best_t(hist, *sums, torch.tensor([Bk], dtype=torch.int32),
                torch.tensor([-1], dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32), params_t(ConfigT(cfg)),
                is_cat=torch.ones(1, dtype=torch.bool), cat_subset=True)
    oracle_gain, oracle_set = _oracle_cat_subset(g, h, c, pd)
    parent = g.sum() ** 2 / (h.sum() + 1e-15)
    assert float(rt.gain[0]) > 0
    np.testing.assert_allclose(float(rt.gain[0]), oracle_gain - parent,
                               rtol=2e-4, atol=1e-3)
    assert sorted(np.flatnonzero(rt.cat_mask[0].numpy()).tolist()) \
        == oracle_set


# ------------------------------------------------------ the plain round
def _jax_nonfused_go_left(bins, pleaf, prm, cat_mask, B_):
    """rounds.py:784-816 of the JAX package, the non-fused round on a
    device without the fused kernel: the per-row parameters by a packed
    matmul, the category hit by a bin one-hot contraction."""
    S = prm.shape[0]
    G = bins.shape[0]
    sel_leaf = jnp.asarray(prm[:, 0])
    live = (sel_leaf >= 0).astype(jnp.float32)
    pack = jnp.stack([jnp.asarray(prm[:, 1], jnp.float32),
                      jnp.asarray(prm[:, 2], jnp.float32),
                      jnp.asarray(prm[:, 3], jnp.float32),
                      jnp.asarray(prm[:, 10], jnp.float32),
                      jnp.asarray(prm[:, 4], jnp.float32),
                      jnp.ones(S, jnp.float32)], axis=1) * live[:, None]
    memb = jnp.asarray(pleaf)[:, None] == sel_leaf[None, :]
    vals = lax.dot_general(memb.astype(jnp.float32), pack,
                           (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.float32,
                           precision=lax.Precision.HIGHEST)
    in_split = vals[:, 5] > 0.5
    col_row = vals[:, 0].astype(jnp.int32)
    bin_row = vals[:, 1].astype(jnp.int32)
    dl_row = vals[:, 2] > 0.5
    cat_row = vals[:, 3] > 0.5
    nan_row = vals[:, 4].astype(jnp.int32)
    col_sel = col_row[None, :] == jnp.arange(G, dtype=jnp.int32)[:, None]
    fbins = jnp.sum(jnp.where(col_sel, jnp.asarray(bins), 0), axis=0)
    ob = fbins[:, None] == jnp.arange(B_, dtype=jnp.int32)[None, :]
    cm_sel = jnp.asarray(cat_mask).astype(jnp.bfloat16) * live[:, None]
    hits = lax.dot_general(ob.astype(jnp.bfloat16), cm_sel,
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.float32)
    cat_hit = jnp.sum(hits * memb, axis=1) > 0.5
    go_left = jnp.where(cat_row, cat_hit,
                        (fbins <= bin_row)
                        | (dl_row & (fbins == nan_row) & (nan_row >= 0)))
    return np.asarray(in_split), np.asarray(go_left)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_partition_matches_jax_nonfused(seed):
    """Half the slots categorical with random sets; the other half
    numerical with NaN default-left; two slots unused."""
    rs = np.random.RandomState(seed)
    G_, N_, S, L, B_ = 5, 700, 8, 20, 16
    bins = rs.randint(0, B_, (G_, N_)).astype(np.int32)
    pleaf = rs.randint(0, L + 1, N_).astype(np.int32)
    prm = np.zeros((S, 16), np.int32)
    prm[:, 0] = rs.permutation(L)[:S]
    prm[:, 1] = rs.randint(0, G_, S)
    prm[:, 2] = rs.randint(0, B_ - 2, S)
    prm[:, 3] = rs.randint(0, 2, S)
    prm[:, 4] = np.where(rs.rand(S) < 0.5, B_ - 1, -1)
    prm[:, 5] = rs.randint(0, 2, S)
    prm[:, 6] = L + 1 + np.arange(S)
    prm[:, 8] = -1
    prm[::2, 10] = 1
    prm[-2:, 0] = -1
    cat_mask = rs.rand(S, B_) < 0.4
    in_j, gl_j = _jax_nonfused_go_left(bins, pleaf, prm, cat_mask, B_)
    pl_new, hslot = ht.round_partition_plain(
        torch.from_numpy(bins), torch.from_numpy(pleaf),
        torch.from_numpy(prm), S, torch.from_numpy(cat_mask))
    slot = np.argmax(pleaf[:, None] == prm[None, :, 0], axis=1)
    want = np.where(in_j & ~gl_j, prm[slot, 6], pleaf)
    np.testing.assert_array_equal(pl_new.numpy(), want)
    small = gl_j == (prm[slot, 5] != 0)
    np.testing.assert_array_equal(hslot.numpy(),
                                  np.where(in_j & small, slot, S))
    assert (in_j & (prm[slot, 10] != 0)).any()


# ------------------------------------------------------------ end to end
def _cat_data(kind, task="binary", n=800, nv=200, seed=5):
    """Two categorical columns (0, 1) beside numerical ones, a label from
    per-category effects plus a smooth numerical term and logistic noise
    (no pure leaves, so no split is decided by rounding noise):
    - onehot: 3 and 4 categories, every categorical one-vs-rest;
    - subset: 18 and 11 categories, the sorted-subset scan;
    - nan: as subset, with NaN in 10% of each categorical column;
    - efb: as subset, plus six sparse numerical columns (one nonzero per
      row among them) that EFB bundles beside the categoricals;
    - dropped: 40 categories binned at max_bin=16, so the rarest ones
      share a fallback bin (binning.py _categorical)."""
    rs = np.random.RandomState(seed)
    m = n + nv
    cards = {"onehot": (3, 4), "dropped": (40, 5)}.get(kind, (18, 11))
    z = np.zeros(m)
    cols = []
    for k in cards:
        p = 1.0 / np.arange(1, k + 1)
        c = rs.choice(k, m, p=p / p.sum())
        z += 1.2 * rs.randn(k)[c]
        cols.append(c.astype(float))
    x = rs.randn(m, 2)
    z += 0.8 * x[:, 0] - 0.4 * np.abs(x[:, 1])
    X = np.column_stack(cols + [x])
    if kind == "nan":
        for j in (0, 1):
            X[rs.rand(m) < 0.1, j] = np.nan
    if kind == "efb":
        sp = np.zeros((m, 6))
        sp[np.arange(m), rs.randint(0, 6, m)] = rs.rand(m) * 5 + 1
        sp[rs.rand(m) < 0.5] = 0.0
        X = np.column_stack([X, sp])
        z += 0.3 * sp[:, 0]
    if task == "binary":
        y = (z + rs.logistic(size=m) > 0).astype(float)
    elif task == "regression":
        y = z + 0.5 * rs.randn(m)
    else:
        y = np.digitize(z + 0.5 * rs.randn(m),
                        np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


TASK_PARAMS = {
    "binary": {"objective": "binary", "metric": "auc"},
    "regression": {"objective": "regression", "metric": "l2"},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "metric": "multi_logloss"},
}
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "min_data_per_group": 20,
        "learning_rate": 0.2}
KIND_PARAMS = {"dropped": {"max_bin": 16}}
_STRUCT = ("num_leaves", "num_cat", "split_feature", "threshold",
           "decision_type", "left_child", "right_child", "leaf_count",
           "internal_count", "cat_boundaries", "cat_threshold")


def _trees(text):
    trees, cur = [], None
    for line in text.split("end of trees")[0].splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    return trees


def train_both(kind, task="binary", pins=PINS, rounds=4, extra=None):
    """The same data and params through both packages; categorical
    columns 0 and 1 by the constructor's categorical_feature."""
    X, y, Xv, yv = _cat_data(kind, task)
    params = {**BASE, **TASK_PARAMS[task], **KIND_PARAMS.get(kind, {}),
              **(extra or {}), **pins}
    ev_j, ev_t = {}, {}
    dj = lgb_j.Dataset(X, label=y, categorical_feature=[0, 1],
                       params=params)
    bj = lgb_j.train(params, dj, rounds,
                     valid_sets=[lgb_j.Dataset(Xv, label=yv, reference=dj)],
                     valid_names=["v"],
                     callbacks=[lgb_j.record_evaluation(ev_j)])
    pt = {**params, "device_type": "cpu"}
    dt = lgb_t.Dataset(X, label=y, categorical_feature=[0, 1], params=pt)
    bt = lgb_t.train(pt, dt, rounds,
                     valid_sets=[lgb_t.Dataset(Xv, label=yv, reference=dt)],
                     valid_names=["v"], evals_result=ev_t)
    return bj, bt, Xv, ev_j, ev_t


def assert_same_models(bj, bt, Xv, ev_j, ev_t):
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    for a, b in zip(tj, tt):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k
        np.testing.assert_allclose(np.array(b["leaf_value"].split(), float),
                                   np.array(a["leaf_value"].split(), float),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)
    for metric, vals in ev_j["v"].items():
        np.testing.assert_allclose(ev_t["v"][metric], vals, rtol=1e-4,
                                   atol=1e-6, err_msg=metric)
    assert any(int(t["num_cat"]) > 0 for t in tt)


@pytest.fixture(scope="module", params=["onehot", "subset", "nan", "efb"])
def int16_run(request):
    return (request.param, *train_both(request.param))


def test_int16_models_match_jax(int16_run):
    _, bj, bt, Xv, ev_j, ev_t = int16_run
    assert_same_models(bj, bt, Xv, ev_j, ev_t)


def test_spec_resolves_like_jax(int16_run):
    kind, bj, bt, *_ = int16_run
    sj, st = bj._gbdt.spec, bt._gbdt.spec
    assert st.has_cat and sj.has_cat
    assert st.cat_subset == sj.cat_subset == (kind != "onehot")
    assert bt._gbdt.hist_dtype == "int16"
    efb = bt._gbdt.train_set.bundle_layout is not None
    assert efb == (kind == "efb")
    assert efb == (bj._gbdt.train_set.bundle_layout is not None)


def test_subset_model_has_multi_category_sets(int16_run):
    """Sorted-subset splits send several categories left: a bitset word
    with more than one bit."""
    kind, _, bt, *_ = int16_run
    words = [int(w) for t in _trees(bt.model_to_string())
             if int(t["num_cat"]) > 0 for w in t["cat_threshold"].split()]
    multi = any(bin(w).count("1") > 1 for w in words)
    assert multi == (kind != "onehot")


def test_dropped_categories_route_as_jax():
    """Categories past the max_bin cut share a fallback bin: the device
    traversal (validation scores) routes them as that bin's category,
    the host predictor tests the raw value against the bitset. The port
    does what the JAX package does on both sides (ROADMAP C)."""
    bj, bt, Xv, ev_j, ev_t = train_both("dropped")
    assert_same_models(bj, bt, Xv, ev_j, ev_t)
    m = bt._gbdt.train_set.mappers[0]
    dropped = ~np.isin(Xv[:, 0], np.asarray(m.categories, float))
    assert dropped.any()
    host = bt.predict(Xv, raw_score=True)
    card = bt._gbdt.valids[0].score[0, :len(Xv)].numpy().astype(np.float64)
    np.testing.assert_allclose(host[~dropped], card[~dropped], atol=1e-5)
    card_j = np.asarray(bj._gbdt.valids[0].score)[0, :len(Xv)]
    np.testing.assert_allclose(card, card_j, atol=1e-5)


# ------------------------------------------------------------ model text
@pytest.fixture(scope="module")
def subset_run():
    return train_both("subset", rounds=3)


def test_model_text_round_trip(subset_run, tmp_path):
    _, bt, Xv, *_ = subset_run
    path = tmp_path / "model.txt"
    bt.save_model(path)
    loaded = lgb_t.Booster(model_file=path)
    assert loaded.model_to_string().split("end of trees")[0] \
        == bt.model_to_string().split("end of trees")[0]
    np.testing.assert_array_equal(loaded.predict(Xv), bt.predict(Xv))


def test_port_loads_jax_categorical_model(subset_run):
    bj, _, Xv, *_ = subset_run
    b = booster_from_model_string(bj.model_to_string())
    np.testing.assert_allclose(b.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-9)


def test_converted_tree_bitsets_and_traversal(subset_run):
    """A JAX-grown categorical tree through tree_arrays_from_numpy: the
    port's Tree.from_arrays writes the JAX package's category bitsets,
    and its binned traversal lands every row where the JAX one does."""
    from lightgbm_tpu.tree import traverse_tree_bins as traverse_j

    bj, bt, *_ = subset_run
    assert bj._gbdt.models  # materialized: device_trees holds (arrays, _)
    arrays = bj._gbdt.device_trees[0][0]
    dsj, dst = bj._gbdt.train_set, bt._gbdt.train_set
    ta = tree_arrays_from_numpy({k: np.asarray(v)
                                 for k, v in arrays._asdict().items()})
    assert bool(ta.node_cat.any())
    tj = TreeJ.from_arrays(arrays, dsj, 1.0)
    tt = TreeT.from_arrays(ta, dst, 1.0)
    assert tt.num_cat == tj.num_cat > 0
    np.testing.assert_array_equal(tt.cat_boundaries, tj.cat_boundaries)
    np.testing.assert_array_equal(tt.cat_threshold, tj.cat_threshold)
    np.testing.assert_array_equal(tt.threshold, tj.threshold)
    dj, dt = dsj.device_arrays(), dst.device_arrays("cpu")
    leaf_j = np.asarray(traverse_j(arrays, dj["bins"], dj["nan_bin"],
                                   dj["bundle"]))
    leaf_t = traverse_t(ta, dt["bins"], dt["nan_bin"], dt["bundle"],
                        has_cat=True)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)


def test_set_categorical_feature_and_names():
    """Categorical columns by name or by set_categorical_feature bin as
    by index; a `categorical_feature` key in params is not read, as in
    the JAX package (ROADMAP C)."""
    X, y, *_ = _cat_data("subset")
    names = ["a", "b", "c", "d"]
    p = {"device_type": "cpu", "verbosity": -1}
    by_name = lgb_t.Dataset(X, label=y, feature_name=names,
                            categorical_feature=["a", "b"], params=p)
    by_set = lgb_t.Dataset(X, label=y, params=p).set_categorical_feature(
        [0, 1])
    by_param = lgb_t.Dataset(X, label=y,
                             params={**p, "categorical_feature": "0,1"})
    kinds = [[m.bin_type.name for m in d.construct()._binned.mappers]
             for d in (by_name, by_set, by_param)]
    assert kinds[0] == kinds[1] == ["CATEGORICAL"] * 2 + ["NUMERICAL"] * 2
    assert kinds[2] == ["NUMERICAL"] * 4
    ref = lgb_j.Dataset(X, label=y, params={"categorical_feature": "0,1",
                                            "verbosity": -1}).construct()
    assert [m.bin_type.name for m in ref._binned.mappers] == kinds[2]
    with pytest.raises(lgb_t.basic.LightGBMError):
        by_set.set_categorical_feature([1])


def _auc(y, s):
    order = np.argsort(s, kind="stable")
    r = np.empty(len(s))
    r[order] = np.arange(1, len(s) + 1)
    pos = y > 0.5
    return (r[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) / (
        pos.sum() * (~pos).sum())


def test_categorical_beats_codes_as_numbers():
    """A label made from a random subset of 24 categories: categorical
    splits find it in a few small trees, thresholds on the codes cannot."""
    rs = np.random.RandomState(7)
    n = 1000
    cats = rs.randint(0, 24, n)
    good = rs.choice(24, 12, replace=False)
    y = (np.isin(cats, good) + 0.3 * rs.randn(n) > 0.5).astype(float)
    X = np.column_stack([cats.astype(float), rs.randn(n)])
    p = {"objective": "binary", "num_leaves": 4, "learning_rate": 0.5,
         "min_data_per_group": 10, "device_type": "cpu", "verbosity": -1}
    aucs = {}
    for name, cf in (("categorical", [0]), ("numbers", "auto")):
        ds = lgb_t.Dataset(X[:800], label=y[:800], categorical_feature=cf,
                           params=p)
        bst = lgb_t.train(p, ds, 3)
        aucs[name] = _auc(y[800:], bst.predict(X[800:]))
    assert aucs["categorical"] > 0.9
    assert aucs["categorical"] > aucs["numbers"] + 0.03, aucs
