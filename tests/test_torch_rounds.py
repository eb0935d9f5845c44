"""The port's rounds grower against the JAX package's grow_tree_rounds on
the same binned data and the same integer gradient levels: tree arrays
(features, bins, default directions, children) equal, the row -> leaf
vector equal, leaf values within rtol 1e-5. Fixtures follow
tests/test_rounds.py, at <= 1k rows."""

# imported for its side effect: lightgbm_tpu/analysis/jaxpr_audit reads
# jax.extend as an attribute of jax, which exists only once something
# has imported it. xdist workers import every test module while they
# collect, so this keeps the JAX package's contract tests from depending
# on which worker they land on (ROADMAP C, "Order-dependent under xdist")
import jax.extend  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.dataset import BinnedDataset as BinnedJ
from lightgbm_tpu.learner import GrowerSpec as SpecJ
from lightgbm_tpu.learner import grow_tree as grow_j
from lightgbm_tpu.learner import make_split_params as params_j
from lightgbm_tpu.tree import traverse_tree_bins as traverse_j
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.convert import tree_arrays_from_numpy
from lightgbm_tpu_torch.dataset import BinnedDataset as BinnedT
from lightgbm_tpu_torch.learner.grower import GrowerSpec as SpecT
from lightgbm_tpu_torch.learner.grower import grow_tree as grow_t
from lightgbm_tpu_torch.learner.grower import make_split_params as params_t
from lightgbm_tpu_torch.tree import traverse_tree_bins as traverse_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


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


def _twins(n=1000, f=4, seed=2):
    """Two halves identical except for feature 0 (with mirrored gradients,
    _levels): after the root split on feature 0, both children's best
    gains tie when a round selects its leaves (lower leaf id first)."""
    rs = np.random.RandomState(seed)
    half = rs.randn(n // 2, f)
    half[:, 0] = 0.0
    other = half.copy()
    other[:, 0] = 1.0
    return np.concatenate([half, other])


CASES = {
    "dense_31": (_dense, dict(num_leaves=31), 48, {"max_bin": 63}),
    "dense_small_slots": (_dense, dict(num_leaves=40), 4, {"max_bin": 31}),
    "dense_depth": (_dense, dict(num_leaves=31, max_depth=3), 48,
                    {"max_bin": 63}),
    "efb": (_sparse, dict(num_leaves=15), 48, {"max_bin": 63}),
    "tied_leaves": (_twins, dict(num_leaves=4), 48, {"max_bin": 15}),
}


def _levels(n_pad, n, seed, twins=False):
    rs = np.random.RandomState(seed)
    if twins:
        # mirrored halves: the second half's gradient levels are the
        # first's negated, so feature 0 is the root split and both
        # children's best gains are exactly equal (gains square G)
        base = rs.randint(-40, 121, n // 2)
        g = np.concatenate([base, -base])
        h = np.tile(rs.randint(1, 257, n // 2), 2)
    else:
        g = rs.randint(-128, 129, n)
        h = rs.randint(0, 257, n)
    gq = np.zeros(n_pad, np.float32)
    hq = np.zeros(n_pad, np.float32)
    gq[:n], hq[:n] = g, h
    scale = np.array([0.0123, 0.00377], np.float32)
    return gq, hq, scale


def _grow_both(case):
    make, tree_kw, slots, ds_params = CASES[case]
    X = make()
    params = {"min_data_in_leaf": 10, **ds_params}
    dsj = BinnedJ.from_numpy(X, ConfigJ(params))
    dst = BinnedT.from_numpy(X, ConfigT(params))
    L = tree_kw["num_leaves"]
    depth = tree_kw.get("max_depth", -1)
    gq, hq, scale = _levels(dsj.num_rows_padded(), dsj.num_data, 5,
                            twins=case == "tied_leaves")
    F = dsj.num_used_features
    efb = dsj.bundle_layout is not None
    dj = dsj.device_arrays()
    spec_j = SpecJ(num_leaves=L, num_bins=dsj.max_num_bin, max_depth=depth,
                   rounds_slots=min(slots, L), quant=True, quant_levels=256,
                   has_cat=False, efb=efb, col_bins=dsj.col_bins)
    tj, rlj = grow_j(dj["bins"], dj["nan_bin"], dj["num_bins"], dj["mono"],
                     dj["is_cat"], jnp.asarray(gq), jnp.asarray(hq),
                     dj["valid"], jnp.ones(F, bool),
                     params_j(ConfigJ(params)), spec_j, valid=dj["valid"],
                     bundle=dj["bundle"], gh_scale=jnp.asarray(scale))
    dt = dst.device_arrays("cpu")
    spec_t = SpecT(num_leaves=L, num_bins=dst.max_num_bin, max_depth=depth,
                   rounds_slots=min(slots, L), efb=efb,
                   col_bins=dst.col_bins)
    tt, rlt = grow_t(dt["bins"], dt["nan_bin"], dt["num_bins"], dt["mono"],
                     dt["is_cat"], torch.from_numpy(gq), torch.from_numpy(hq),
                     dt["valid"], torch.ones(F, dtype=torch.bool),
                     params_t(ConfigT(params)), spec_t, valid=dt["valid"],
                     bundle=dt["bundle"], gh_scale=torch.from_numpy(scale))
    return tj, rlj, tt, rlt, dsj, dst


@pytest.mark.parametrize("case", list(CASES))
def test_tree_matches_jax(case):
    tj, rlj, tt, rlt, dsj, _ = _grow_both(case)
    n = int(tj.num_nodes)
    assert n > 0 and int(tt.num_nodes) == n
    for f in ("node_feature", "node_bin", "node_default_left", "node_left",
              "node_right"):
        np.testing.assert_array_equal(getattr(tt, f).numpy()[:n],
                                      np.asarray(getattr(tj, f))[:n], f)
    np.testing.assert_array_equal(tt.leaf_depth.numpy()[: n + 1],
                                  np.asarray(tj.leaf_depth)[: n + 1])
    for f in ("leaf_value", "leaf_weight", "leaf_count"):
        np.testing.assert_allclose(getattr(tt, f).numpy()[: n + 1],
                                   np.asarray(getattr(tj, f))[: n + 1],
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tt.node_gain.numpy()[:n],
                               np.asarray(tj.node_gain)[:n], rtol=1e-5)
    np.testing.assert_array_equal(rlt.numpy(), np.asarray(rlj))
    if case == "tied_leaves":
        # the root's children (leaves 0 and 1) have equal best gains and
        # the round after the root has room for one split: the lower leaf
        # id goes first, so node 1 splits leaf 0
        left, gain = tt.node_left.numpy(), tt.node_gain.numpy()
        assert left[0] == 1 and left[1] == ~0
        j = int(np.flatnonzero(left[:n] == ~1)[0])
        assert j > 1 and gain[j] == gain[1]


@pytest.mark.parametrize("case", ["dense_31", "efb"])
def test_converted_tree_traverses_like_jax(case):
    """tree_arrays_from_numpy carries a JAX-grown tree into the port;
    both traversals of the binned matrix land every row on one leaf."""
    tj, _, _, _, dsj, dst = _grow_both(case)
    dj = dsj.device_arrays()
    dt = dst.device_arrays("cpu")
    leaf_j = np.asarray(traverse_j(tj, dj["bins"], dj["nan_bin"],
                                   dj["bundle"]))
    tt = tree_arrays_from_numpy({k: np.asarray(v)
                                 for k, v in tj._asdict().items()})
    leaf_t = traverse_t(tt, dt["bins"], dt["nan_bin"], dt["bundle"])
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
