"""The port's exact path (tpu_growth_mode=exact) against the JAX package's
on the same seeded inputs, with JAX on the CPU (its XLA fallbacks):

- histogram and hist_slots, the plain versions of the hist and
  hist_slots kernels, against lightgbm_tpu.learner.histogram (rtol 1e-5:
  the port sums f32 values exactly in int64 fixed point, the fallback in
  f32 blocks);
- grow_tree_permuted, sequential and with its round phase
  (tpu_growth_rounds), on NaN and EFB fixtures: tree arrays equal, the
  row -> leaf vector equal, leaf values and gains within rtol 1e-5;
- lightgbm_tpu_torch.train against lightgbm_tpu.train: equal tree
  structure in the model text, leaf values within rtol 1e-5, raw
  predictions within 1e-5.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.dataset import BinnedDataset as BinnedJ
from lightgbm_tpu.learner import GrowerSpec as SpecJ
from lightgbm_tpu.learner import grow_tree as grow_j
from lightgbm_tpu.learner import make_split_params as params_j
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.dataset import BinnedDataset as BinnedT
from lightgbm_tpu_torch.learner import histogram as ht
from lightgbm_tpu_torch.learner.grower import GrowerSpec as SpecT
from lightgbm_tpu_torch.learner.grower import grow_tree as grow_t
from lightgbm_tpu_torch.learner.grower import make_split_params as params_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

# the JAX package's learner/__init__ exports a function named histogram
hj = importlib.import_module("lightgbm_tpu.learner.histogram")


def _channels(n, seed):
    """f32 gradient, hessian and in-bag count of n rows (10% out of bag)."""
    rs = np.random.RandomState(seed)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    g = rs.randn(n).astype(np.float32) * cnt
    h = (rs.rand(n) * 0.25 + 0.01).astype(np.float32) * cnt
    return g, h, cnt


def _gh_both(g, h, cnt):
    gh8 = hj.build_gh8(jnp.asarray(g), jnp.asarray(h), jnp.asarray(cnt))
    gh3 = ht.build_gh3(torch.from_numpy(g), torch.from_numpy(h),
                       torch.from_numpy(cnt))
    return gh8, gh3


@pytest.mark.parametrize("begin,count", [(0, None), (0, 517), (300, 211),
                                         (999, 1)])
def test_histogram_matches_jax(begin, count):
    G, N, B = 5, 1000, 32
    rs = np.random.RandomState(3)
    bins = rs.randint(0, B, (G, N)).astype(np.int32)
    gh8, gh3 = _gh_both(*_channels(N, 4))
    end = N if count is None else begin + count
    ref = np.asarray(hj.histogram(jnp.asarray(bins[:, begin:end]),
                                  gh8[:, begin:end], B))
    out = ht.histogram(torch.from_numpy(bins), gh3, B, begin=begin,
                       count=count)
    assert out.shape == (3, G, B) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    # device-scalar bounds with a host cap give the same bits
    if count is not None:
        again = ht.histogram(torch.from_numpy(bins), gh3, B,
                             begin=torch.tensor(begin),
                             count=torch.tensor(count), cap=count)
        assert torch.equal(again, out)


def test_hist_slots_matches_jax():
    """Disjoint segments in no particular order, an empty slot, rows
    outside every segment."""
    G, N, B, S = 4, 1000, 16, 6
    rs = np.random.RandomState(5)
    bins = rs.randint(0, B, (G, N)).astype(np.int32)
    gh8, gh3 = _gh_both(*_channels(N, 6))
    begins = np.array([700, 0, 0, 120, 400, 990], np.int32)
    counts = np.array([250, 100, 0, 280, 3, 10], np.int32)
    ref = np.asarray(hj.hist_slots(jnp.asarray(bins), gh8,
                                   jnp.asarray(begins), jnp.asarray(counts),
                                   B, S))
    out = ht.hist_slots(torch.from_numpy(bins), gh3,
                        torch.from_numpy(begins), torch.from_numpy(counts),
                        B, S)
    assert out.shape == (S, 3, G, B)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert not out[2].any()


def test_fixed_point_is_exact_and_order_free():
    """The fixed-point sums equal the f64 sums rounded to f32, and a
    permutation of the rows changes no bit."""
    G, N, B = 3, 4096, 8
    rs = np.random.RandomState(9)
    bins = torch.from_numpy(rs.randint(0, B, (G, N)).astype(np.int32))
    g = rs.randn(N).astype(np.float32) * 10.0 ** rs.randint(-6, 3, N)
    gh3 = ht.build_gh3(torch.from_numpy(g), torch.rand(N), torch.ones(N))
    out = ht.histogram(bins, gh3, B)
    ref = torch.zeros((3, G, B), dtype=torch.float64)
    for c in range(3):
        for j in range(G):
            ref[c, j].index_add_(0, bins[j].long(), gh3[c].double())
    np.testing.assert_allclose(out.numpy(), ref.float().numpy(), rtol=2e-7,
                               atol=1e-12)
    perm = torch.from_numpy(rs.permutation(N))
    assert torch.equal(ht.histogram(bins[:, perm], gh3[:, perm], B), out)


def _dense(n=1000, f=8, seed=11):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    X[rs.rand(n, f) < 0.08] = np.nan  # NaN bins: default-left splits
    return X


def _sparse(n=1000, f=9, seed=4):
    rs = np.random.RandomState(seed)
    X = np.zeros((n, f))
    owner = rs.randint(0, f - 2, n)
    X[np.arange(n), owner] = rs.rand(n) * 10 + 1
    X[:, f - 2:] = rs.randn(n, 2)
    return X


GROW = {
    "dense": (_dense, dict(num_leaves=31), {"max_bin": 63}),
    "dense_rounds": (_dense, dict(num_leaves=31, rounds=True),
                     {"max_bin": 63}),
    "depth_mono_rounds": (_dense, dict(num_leaves=31, max_depth=4,
                                       rounds=True),
                          {"max_bin": 63,
                           "monotone_constraints": [1, -1, 0, 0, 0, 0, 0,
                                                    0]}),
    "efb": (_sparse, dict(num_leaves=15), {"max_bin": 63}),
    "efb_rounds": (_sparse, dict(num_leaves=15, rounds=True),
                   {"max_bin": 63}),
}


def _logistic_grads(X, seed):
    """Binary-logloss gradients of a half-fitted model on a noisy linear
    target: leaf sums do not cancel to rounding noise, as pure random
    gradients would make them (leaf values then differ between any two
    f32 summation orders by more than 1e-5 relative)."""
    rs = np.random.RandomState(seed)
    z = np.nan_to_num(X) @ rs.randn(X.shape[1])
    y = (z + 0.5 * rs.randn(len(z)) > 0).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-(0.5 * z + 0.3 * rs.randn(len(z)))))
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


def grow_both(make, tree_kw, ds_params, rounds_slots=0, seed=5):
    """One tree from each package on the same binned data and f32
    gradients. rounds_slots > 0 runs the rounds grower (f32 mode)."""
    X = make()
    params = {"min_data_in_leaf": 10, **ds_params}
    dsj = BinnedJ.from_numpy(X, ConfigJ(params))
    dst = BinnedT.from_numpy(X, ConfigT(params))
    L = tree_kw["num_leaves"]
    depth = tree_kw.get("max_depth", -1)
    rounds = tree_kw.get("rounds", False)
    npad, n = dsj.num_rows_padded(), dsj.num_data
    # every row carries a gradient: a row with zero gradient but a count
    # of one makes both directions of a NaN split tie exactly, and ulps
    # decide (ROADMAP C)
    g, h = _logistic_grads(X, seed)
    gp, hp = np.zeros(npad, np.float32), np.zeros(npad, np.float32)
    gp[:n], hp[:n] = g, h
    F = dsj.num_used_features
    efb = dsj.bundle_layout is not None
    has_mono = "monotone_constraints" in ds_params
    dj = dsj.device_arrays()
    spec_j = SpecJ(num_leaves=L, num_bins=dsj.max_num_bin, max_depth=depth,
                   rounds_slots=rounds_slots, rounds=rounds, has_cat=False,
                   efb=efb, col_bins=dsj.col_bins)
    tj, rlj = grow_j(dj["bins"], dj["nan_bin"], dj["num_bins"], dj["mono"],
                     dj["is_cat"], jnp.asarray(gp), jnp.asarray(hp),
                     dj["valid"], jnp.ones(F, bool),
                     params_j(ConfigJ(params)), spec_j, valid=dj["valid"],
                     bundle=dj["bundle"])
    dt = dst.device_arrays("cpu")
    spec_t = SpecT(num_leaves=L, num_bins=dst.max_num_bin, max_depth=depth,
                   rounds_slots=rounds_slots, efb=efb, col_bins=dst.col_bins,
                   quant_levels=0, has_mono=has_mono, quant=False,
                   rounds=rounds)
    tt, rlt = grow_t(dt["bins"], dt["nan_bin"], dt["num_bins"], dt["mono"],
                     dt["is_cat"], torch.from_numpy(gp), torch.from_numpy(hp),
                     dt["valid"], torch.ones(F, dtype=torch.bool),
                     params_t(ConfigT(params)), spec_t, valid=dt["valid"],
                     bundle=dt["bundle"])
    return tj, rlj, tt, rlt


# f32 paths: every larger child is its parent minus its sibling in f32,
# so a child's sums carry an absolute error of a few ulps of its
# ancestors' sums, whichever order the histograms were added in. Values
# near zero (small deep leaves, weak gains) then differ between the
# packages by more than rtol 1e-5 allows, while both stay within 1e-5 of
# the f64 value (test_permuted_leaf_values_near_exact_sums; ROADMAP C):
# rtol 1e-5 with an absolute 1e-5 on the f32 scale of the root sums.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def assert_same_tree(tj, rlj, tt, rlt):
    n = int(tj.num_nodes)
    assert n > 0 and int(tt.num_nodes) == n
    for f in ("node_feature", "node_bin", "node_default_left", "node_left",
              "node_right"):
        np.testing.assert_array_equal(getattr(tt, f).numpy()[:n],
                                      np.asarray(getattr(tj, f))[:n], f)
    np.testing.assert_array_equal(tt.leaf_depth.numpy()[: n + 1],
                                  np.asarray(tj.leaf_depth)[: n + 1])
    for f in ("leaf_value", "leaf_weight", "leaf_count", "node_value",
              "node_weight", "node_count"):
        m = n + 1 if f.startswith("leaf") else n
        np.testing.assert_allclose(getattr(tt, f).numpy()[:m],
                                   np.asarray(getattr(tj, f))[:m],
                                   err_msg=f, **F32_TOL)
    np.testing.assert_allclose(tt.node_gain.numpy()[:n],
                               np.asarray(tj.node_gain)[:n], **F32_TOL)
    np.testing.assert_array_equal(rlt.numpy(), np.asarray(rlj))


@functools.lru_cache(maxsize=None)
def grown_case(case):
    make, tree_kw, ds_params = GROW[case]
    return grow_both(make, tree_kw, ds_params)


@pytest.fixture(scope="module", params=list(GROW))
def grown(request):
    return request.param, grown_case(request.param)


def test_permuted_tree_matches_jax(grown):
    case, (tj, rlj, tt, rlt) = grown
    assert_same_tree(tj, rlj, tt, rlt)
    if case.startswith("depth"):
        assert int(tt.leaf_depth.max()) <= 4


def test_permuted_rows_land_in_their_leaves(grown):
    """Every valid row has a leaf of the tree, padding rows have -1, and
    the per-leaf row counts are the leaf counts (no bagging here)."""
    _, (_, _, tt, rlt) = grown
    n_leaves = int(tt.num_nodes) + 1
    rl = rlt.numpy()
    valid = rl >= 0
    assert rl[valid].max() < n_leaves
    counts = np.bincount(rl[valid], minlength=n_leaves)
    np.testing.assert_array_equal(counts, tt.leaf_count.numpy()[:n_leaves])


@pytest.mark.parametrize("case", [c for c in GROW if "mono" not in c])
def test_permuted_leaf_values_near_exact_sums(case):
    """Both packages' leaf values lie within 1e-5 of -G / H over each
    leaf's rows summed in f64 (no regularization or monotone clamp in
    these cases): the f32 error that parent subtraction leaves in both,
    which F32_TOL's absolute term covers (ROADMAP C)."""
    tj, _, tt, rlt = grown_case(case)
    g, h = _logistic_grads(GROW[case][0](), 5)
    n_leaves = int(tt.num_nodes) + 1
    rl = rlt.numpy()[: len(g)]
    G = np.bincount(rl, weights=g.astype(np.float64), minlength=n_leaves)
    H = np.bincount(rl, weights=h.astype(np.float64), minlength=n_leaves)
    exact = -G / (H + 1e-15)
    for t in (tt.leaf_value.numpy(), np.asarray(tj.leaf_value)):
        np.testing.assert_allclose(t[:n_leaves], exact, rtol=0, atol=1e-5)


TRAIN = {
    "exact": {"tpu_growth_mode": "exact"},
    "exact_rounds": {"tpu_growth_mode": "exact", "tpu_growth_rounds": True},
}
_STRUCT = ("num_leaves", "split_feature", "threshold", "decision_type",
           "left_child", "right_child", "leaf_count", "internal_count")


def model_trees(text):
    trees, cur = [], None
    for line in text.split("end of trees")[0].splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    return trees


def train_both(pins, n=800, f=6, rounds=6, seed=7):
    rs = np.random.RandomState(seed)
    X = rs.randn(n + 200, f)
    X[rs.rand(n + 200, f) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(f)
    y = (z + 0.3 * rs.randn(n + 200) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbosity": -1, **pins}
    bj = lgb_j.train(p, lgb_j.Dataset(X[:n], label=y[:n]), rounds)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X[:n], label=y[:n], params=pt),
                     rounds)
    return bj, bt, X[n:]


@pytest.fixture(scope="module", params=list(TRAIN))
def trained(request):
    return (request.param,) + train_both(TRAIN[request.param])


def assert_same_models(bj, bt, Xv):
    tj, tt = model_trees(bj.model_to_string()), \
        model_trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    for a, b in zip(tj, tt):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k
        np.testing.assert_allclose(
            np.array(b["leaf_value"].split(), float),
            np.array(a["leaf_value"].split(), float), **F32_TOL)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)


def test_train_matches_jax(trained):
    case, bj, bt, Xv = trained
    gb = bt._gbdt
    assert gb.hist_dtype == "bf16x2" and gb.spec.rounds_slots == 0
    assert gb.spec.rounds == (case == "exact_rounds")
    assert_same_models(bj, bt, Xv)


def test_exact_ignores_int_request():
    """Off the rounds path the channels are f32, as the JAX package has
    it: an explicit int16 request trains the same trees as `auto`."""
    rs = np.random.RandomState(2)
    X = rs.randn(400, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(400) > 0).astype(float)
    preds = {}
    for dtype in ("auto", "int16"):
        p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
             "tpu_growth_mode": "exact", "tpu_hist_dtype": dtype,
             "device_type": "cpu"}
        b = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 3)
        assert b._gbdt.hist_dtype == "bf16x2"
        preds[dtype] = b.predict(X, raw_score=True)
    np.testing.assert_array_equal(preds["int16"], preds["auto"])


def test_multiclass_exact_differs_only_at_noise_gains():
    """Multiclass first-iteration gradients take two values per class at
    one hessian, so some leaves have splits whose gain is rounding noise
    in exact arithmetic; the packages may pick different ones (ROADMAP
    C). Where a tree first differs, both splits have a noise gain, and
    raw predictions agree within 1e-6."""
    rs = np.random.RandomState(3)
    X = rs.randn(900, 5)
    X[rs.rand(900, 5) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(5)
    y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 20,
         "min_data_in_leaf": 8, "max_depth": 5, "verbosity": -1,
         "tpu_growth_mode": "exact"}
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), 2)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt), 2)
    keys = ("split_feature", "threshold", "decision_type")
    for a, b in zip(model_trees(bj.model_to_string()),
                    model_trees(bt.model_to_string())):
        cols = [list(zip(*[t[k].split() for k in keys])) if "split_feature"
                in t else [] for t in (a, b)]
        diff = [i for i, (u, v) in enumerate(zip(*cols)) if u != v]
        if diff:
            i = diff[0]
            gains = [float(t["split_gain"].split()[i]) for t in (a, b)]
            assert max(gains) < 1e-5, gains
            break
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-6)
