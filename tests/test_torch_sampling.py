"""Row and feature sampling: lightgbm_tpu_torch against lightgbm_tpu on the
same seeded inputs, with JAX on the CPU.

- rng.permutation against jax.random.permutation, bit for bit (n = 1700
  takes jax's two sort rounds);
- the bagging masks (plain, pos / neg, bagging_freq windows, k = 0, ties
  at the threshold), the GOSS masks and amplified g / h before and after
  its warm-up, and the per-tree feature masks, bit for bit;
- trees grown under bagging, GOSS and feature_fraction on the int16,
  use_quantized_grad, exact and bf16x2 paths, on an EFB dataset with
  feature_fraction and on a categorical dataset with bagging: equal tree
  structure in the model text, leaf values within rtol 1e-5, raw
  predictions within 1e-5. A split's default direction may differ where
  it is a tie: no training row that reaches the node lacks the split
  feature's value, so both directions route the same rows (ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu import sample_strategy as ss_j
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu_torch import rng
from lightgbm_tpu_torch import sample_strategy as ss_t
from lightgbm_tpu_torch.config import Config as ConfigT
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

SEEDS = [0, 17, 2 ** 31 - 1]
PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
LEAF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 7, 28, 100, 1700])
def test_permutation_bits(n, seed):
    kj = jax.random.fold_in(jax.random.key(seed), 3)
    kt = rng.fold_in(rng.key(seed), 3)
    np.testing.assert_array_equal(rng.permutation(kt, n).numpy(),
                                  np.asarray(jax.random.permutation(kj, n)))


def _valid(n, pad, seed=3):
    """n real rows (a few invalid) then `pad` padding rows, f32."""
    rs = np.random.RandomState(seed)
    v = np.ones(n + pad, np.float32)
    v[n:] = 0.0
    v[:n][rs.rand(n) < 0.03] = 0.0
    return v


@pytest.mark.parametrize("case", ["random", "ties", "k0", "one"])
def test_exact_fraction_mask_bits(case):
    """The threshold is the k-th smallest eligible draw; every row at or
    below it is taken, so tied draws can put more than k rows in the
    bag."""
    rs = np.random.RandomState(5)
    n = 60
    u = rs.rand(n).astype(np.float32)
    elig = rs.rand(n) < 0.8
    frac = {"random": 0.37, "ties": 0.5, "k0": 0.001, "one": 1.0}[case]
    if case == "ties":
        # the threshold value repeated on eligible and ineligible rows
        k = int(np.round(np.float32(elig.sum()) * np.float32(frac)))
        thr = np.sort(u[elig])[k - 1]
        u[rs.choice(n, 6, replace=False)] = thr
    mj = np.asarray(ss_j._exact_fraction_mask(jnp.asarray(u),
                                              jnp.asarray(elig), frac))
    mt = ss_t._exact_fraction_mask(torch.from_numpy(u),
                                   torch.from_numpy(elig), frac).numpy()
    np.testing.assert_array_equal(mt, mj)
    k = int(np.round(np.float32(elig.sum()) * np.float32(frac)))
    if case == "ties":
        assert mt.sum() > k
    if case == "k0":
        assert k == 0 and not mt.any()


BAGGING = {
    "plain": {"bagging_fraction": 0.6, "bagging_freq": 1},
    "pos_neg": {"pos_bagging_fraction": 0.3, "neg_bagging_fraction": 0.9,
                "bagging_freq": 1},
    "freq3": {"bagging_fraction": 0.5, "bagging_freq": 3,
              "bagging_seed": 11},
    "k0": {"bagging_fraction": 0.0005, "bagging_freq": 2},
    # without query groups both packages warn and bag rows
    "by_query": {"bagging_fraction": 0.6, "bagging_freq": 1,
                 "bagging_by_query": True},
}


@pytest.mark.parametrize("case", list(BAGGING))
def test_bagging_masks_bits(case):
    """Per iteration, the port's mask (one draw kept per window) equals
    the JAX package's (a fresh draw keyed on the window every time)."""
    params = BAGGING[case]
    valid = _valid(900, 124)
    rs = np.random.RandomState(8)
    label = (rs.rand(valid.size) < 0.3).astype(np.float32)
    g = rs.randn(valid.size).astype(np.float32)
    sj = ss_j.create_sample_strategy(ConfigJ(params), 900)
    st = ss_t.create_sample_strategy(ConfigT(params))
    vt, lt, gt = (torch.from_numpy(a) for a in (valid, label, g))
    masks = []
    for it in range(7):
        mj, gj, _ = sj.sample(it, jnp.asarray(g), jnp.asarray(g),
                              jnp.asarray(valid), jnp.asarray(label))
        mt, g2, _ = st.sample(it, gt, gt, vt, lt)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert g2 is gt  # bagging leaves the gradients alone
        masks.append(mt.numpy())
    freq = params["bagging_freq"]
    for it in range(7):
        same = np.array_equal(masks[it], masks[(it // freq) * freq])
        assert same
    if case == "k0":
        assert not any(m.any() for m in masks)
    elif case == "pos_neg":
        m = masks[0] > 0
        pos, neg = (valid > 0) & (label > 0), (valid > 0) & (label <= 0)
        assert m[pos].sum() == np.round(np.float32(pos.sum()) * np.float32(0.3))
        assert m[neg].sum() >= np.round(np.float32(neg.sum())
                                        * np.float32(0.9))
    else:
        assert masks[0].sum() >= np.round(
            np.float32(valid.sum()) * np.float32(params["bagging_fraction"]))


def test_bag_cache_redraws_on_new_fraction():
    """A reset_parameter inside a window draws the bag the JAX package
    draws with the new fraction."""
    params = {"bagging_fraction": 0.6, "bagging_freq": 4}
    valid = _valid(500, 12)
    cj, ct = ConfigJ(params), ConfigT(params)
    sj = ss_j.create_sample_strategy(cj, 500)
    st = ss_t.create_sample_strategy(ct)
    vt = torch.from_numpy(valid)
    st.sample(1, vt, vt, vt, None)
    for c in (cj, ct):
        c.update({"bagging_fraction": 0.3})
    mj = sj.sample(2, jnp.asarray(valid), jnp.asarray(valid),
                   jnp.asarray(valid), None)[0]
    np.testing.assert_array_equal(st.sample(2, vt, vt, vt, None)[0].numpy(),
                                  np.asarray(mj))


@pytest.mark.parametrize("it", [0, 2, 3, 5])
def test_goss_bits(it):
    """lr 0.5: no sampling before iteration int(1 / 0.5) + 1 = 3; then the
    mask, g * mult and h * mult bit for bit. |g * h| repeats on a third of
    the rows, so ties at the threshold are common."""
    params = {"data_sample_strategy": "goss", "learning_rate": 0.5,
              "top_rate": 0.2, "other_rate": 0.1}
    valid = _valid(1000, 24)
    rs = np.random.RandomState(it + 1)
    g = rs.randn(valid.size).astype(np.float32)
    h = (rs.rand(valid.size) * 0.25 + 0.01).astype(np.float32)
    rep = rs.rand(valid.size) < 0.33
    g[rep], h[rep] = np.float32(0.5), np.float32(0.2)
    sj = ss_j.create_sample_strategy(ConfigJ(params), 1000)
    st = ss_t.create_sample_strategy(ConfigT(params))
    outj = sj.sample(it, jnp.asarray(g), jnp.asarray(h), jnp.asarray(valid),
                     None)
    outt = st.sample(it, torch.from_numpy(g), torch.from_numpy(h),
                     torch.from_numpy(valid), None)
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = outt[0].numpy()
    if it < 3:
        np.testing.assert_array_equal(mask, valid)
    else:
        assert 0 < mask.sum() < 0.5 * valid.sum()
        amp = np.float32(0.8) / np.float32(0.1)
        assert np.isin(outt[1].numpy()[mask > 0] / g[mask > 0],
                       [1.0, amp]).all()


@pytest.fixture(scope="module")
def boosters_ff():
    """A booster of each package on the same 10-feature data with
    feature_fraction 0.35 and 3 classes (untrained: the draws only)."""
    X, y, _, _ = _data("multiclass", n=300, f=10)
    p = {"objective": "multiclass", "num_class": 3, "feature_fraction": 0.35,
         "feature_fraction_seed": 9, "verbosity": -1}
    bj = lgb_j.Booster(p, lgb_j.Dataset(X, label=y))
    bt = lgb_t.Booster({**p, "device_type": "cpu"},
                       lgb_t.Dataset(X, label=y, params={"device_type": "cpu"}))
    return bj, bt


@pytest.mark.parametrize("it", [0, 1, 7, 40])
def test_feature_masks_bits(boosters_ff, it):
    bj, bt = boosters_ff
    for k in range(3):
        mj = np.asarray(bj._gbdt._sample_features(it=it, k=k))
        mt = bt._gbdt._sample_features(it, k).numpy()
        np.testing.assert_array_equal(mt, mj)
        assert mt.sum() == int(np.ceil(0.35 * 10))


def _reaching(tree, X, node):
    """Training rows whose walk through `tree` passes `node`."""
    rows = []
    for r in range(X.shape[0]):
        n = 0
        while n >= 0 and n != node:
            n = tree.left_child[n] if tree.go_left(n, X[r]) \
                else tree.right_child[n]
        if n == node:
            rows.append(r)
    return np.asarray(rows, int)


def _split(t, n):
    return (int(t.split_feature[n]), float(t.threshold[n]),
            int(t.decision_type[n]))


def assert_same_sampled_models(bj, bt, X, Xv, allow_near_tie=False):
    """Equal trees: per node the same split, counts and children, leaf
    values within rtol 1e-5 (atol 1e-5), raw predictions within 1e-5.

    Two ties are held as functions of the rows. A node's split may differ
    in its default direction and threshold when it sends every training
    row that reaches it the same way (no such row misses the feature and
    no bin between the thresholds holds one): gains equal up to rounding,
    the same rows either side, so the trees go on alike. With
    allow_near_tie, a node whose splits part those rows differently is a
    near tie when the two packages' gains agree within 1e-6 relative; the
    models then differ from that node on, and the function returns
    (tree, node) there. Without a tie it returns None."""
    mj, mt = bj._gbdt.models, bt._gbdt.models
    assert len(mj) == len(mt) > 0
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert a.num_leaves == b.num_leaves, i
        for n in range(b.num_leaves - 1):
            if _split(a, n) == _split(b, n):
                continue
            rows = _reaching(b, X, n)
            ga = [a.go_left(n, X[r]) for r in rows]
            gb = [b.go_left(n, X[r]) for r in rows]
            if ga == gb and a.split_feature[n] == b.split_feature[n]:
                continue
            gj = float(np.asarray(bj._gbdt.device_trees[i][0].node_gain)[n])
            gt = float(bt._gbdt.device_trees[i].node_gain[n])
            assert allow_near_tie and abs(gj - gt) <= 1e-6 * abs(gt), \
                (i, n, _split(a, n), _split(b, n), gj, gt)
            return i, n
        for k in ("left_child", "right_child", "internal_count",
                  "leaf_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, **LEAF_TOL)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)
    return None


PATHS = {
    "int16": PINS,
    "quant": {**PINS, "use_quantized_grad": True},
    "exact": {"tpu_growth_mode": "exact", "verbosity": -1},
    "bf16x2": {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2",
               "verbosity": -1},
}
SAMPLERS = {
    "bagging": {"bagging_fraction": 0.6, "bagging_freq": 2},
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.5},
    "feature_fraction": {"feature_fraction": 0.5},
}


def _train_both(params, X, y, rounds, dataset_kw=None):
    kw = dataset_kw or {}
    bj = lgb_j.train(params, lgb_j.Dataset(X, label=y, **kw), rounds)
    pt = {**params, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt, **kw), rounds)
    return bj, bt


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("path", list(PATHS))
def test_sampled_trees_match(path, sampler):
    X, y, Xv, _ = _data("binary")
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         **SAMPLERS[sampler], **PATHS[path]}
    bj, bt = _train_both(p, X, y, 6)
    assert assert_same_sampled_models(bj, bt, X, Xv) is None


def _efb_data(n=700, f=9, seed=4):
    """Seven sparse columns (one nonzero per row, EFB bundles them) beside
    two dense ones."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n, f))
    owner = rs.randint(0, f - 2, n)
    X[np.arange(n), owner] = rs.rand(n) * 10 + 1
    X[:, f - 2:] = rs.randn(n, 2)
    y = (X[:, 0] + X[:, 3] - X[:, 5] + X[:, 7] + 0.5 * rs.randn(n) > 1.0
         ).astype(float)
    return X, y


@pytest.mark.parametrize("num_leaves", [7, 15])
def test_efb_feature_fraction_trees_match(num_leaves):
    """feature_fraction on an EFB dataset: the mask is over features, the
    split search over the bundles' decoded features. At 15 leaves tree 0's
    sixth split is a near tie (ROADMAP C): feature 8 against a bundled
    feature, the packages' gains 1e-6 relative apart, and they take
    different sides of it; everything before it is equal."""
    X, y = _efb_data()
    p = {"objective": "binary", "num_leaves": num_leaves,
         "min_data_in_leaf": 5, "max_bin": 63, "feature_fraction": 0.6,
         **PINS}
    bj, bt = _train_both(p, X, y, 6)
    assert bt._gbdt.train_set.bundle_layout is not None
    tie = assert_same_sampled_models(bj, bt, X, X[:200],
                                     allow_near_tie=num_leaves == 15)
    assert tie == (None if num_leaves == 7 else (0, 5))


def test_categorical_bagging_trees_match():
    from test_torch_categorical import _cat_data

    X, y, Xv, _ = _cat_data("subset")
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "bagging_fraction": 0.7, "bagging_freq": 1, **PINS}
    bj, bt = _train_both(p, X, y, 5, {"categorical_feature": [0, 1]})
    assert bt._gbdt.spec.cat_subset
    assert_same_sampled_models(bj, bt, X, Xv)
