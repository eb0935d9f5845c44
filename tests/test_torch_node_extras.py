"""The per-node split extras and forced splits: lightgbm_tpu_torch against
lightgbm_tpu on the same seeded inputs, with JAX on the CPU.

- grower.make_node_candidates, the JAX package's against the port's
  batch, over several salts: the feature_fraction_bynode masks, the
  interaction-group masks and extra_trees' thresholds bit for bit, the
  CEGB penalties within 1 ulp;
- trees on the rounds grower (int16) for extra_trees,
  feature_fraction_bynode, split + lazy CEGB, coupled CEGB (eager, with
  its reason), interaction_constraints and a forced plan, and on the
  exact grower for all four extras together and for the forced plan:
  the same splits, counts and children, leaf values within rtol 1e-5.
  A node may differ only where the two packages' gains tie (f32
  rounding of exactly equal candidates): every training row reaching it
  then goes the same way (ROADMAP C); predictions on the training rows
  stay within 1e-5. Every root-to-leaf path of a constrained tree uses
  features of one group, and every tree starts with the forced plan;
- fused == eager bit for bit on the CPU with the graph's bounded loops
  for each fused-eligible extra and the forced plan, and the fused step
  reads nothing back from the device with all of them on;
- the set-up's refusals and fall-backs: coupled CEGB's eager-loop
  reason, a CEGB list of the wrong length, an unreadable forced plan,
  monotone intermediate with extras (basic, warned) and without
  (intermediate), tpu_growth_rounds with extras (round phase off).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.learner import grower as grower_j
from lightgbm_tpu.learner import split as split_j
from lightgbm_tpu_torch import boosting, rng
from lightgbm_tpu_torch.learner import device_loop
from lightgbm_tpu_torch.learner import grower as grower_t
from lightgbm_tpu_torch.learner.split import SplitParams, best_split
from test_torch_fused import _NoReadBack
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
EXACT = {"tpu_growth_mode": "exact", "verbosity": -1}
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5}
LAZY = [0.01, 0.02, 0.0, 0.05, 0.01, 0.0]
GROUPS = "[0,1,2],[3,4,5]"
FORCED = {"feature": 0, "threshold": 0.1,
          "left": {"feature": 1, "threshold": -0.2},
          "right": {"feature": 2, "threshold": 0.3,
                    "left": {"feature": 3, "threshold": 0.0}}}
ROUNDS = 4


def _per_iteration(env):
    """Keeps the JAX package on its per-iteration loop."""


_per_iteration.before_iteration = True


@pytest.fixture(scope="module")
def forced_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "forced.json"
    path.write_text(json.dumps(FORCED))
    return str(path)


# ---------------------------------------------------------------- draws
@pytest.mark.parametrize("seed", [6, 123])
def test_node_candidates_bits(seed):
    """One batch of the port's node candidates against the JAX package's
    make_node_candidates at each salt (root 0, a round's children 2 i + 1
    and 2 i + 2, large ids)."""
    rs = np.random.RandomState(seed)
    F, NG = 9, 3
    num_bins = rs.randint(2, 40, F).astype(np.int32)
    nan_bin = np.where(rs.rand(F) < 0.4, num_bins - 1, -1).astype(np.int32)
    feat_mask = rs.rand(F) < 0.8
    gm = rs.rand(NG, F) < 0.5
    coupled = rs.rand(F).astype(np.float32)
    lazy = rs.rand(F).astype(np.float32)
    used = rs.rand(F) < 0.3
    salts = np.array([0, 1, 2, 7, 8, 511, 2 ** 20 + 3])
    n = salts.size
    groups = rs.rand(n, NG) < 0.7
    path_used = rs.rand(n, F) < 0.3
    count = rs.randint(1, 500, n).astype(np.float32)
    frac, pen_split, tradeoff = 0.45, 0.03, 1.7
    spec_kw = dict(num_leaves=15, num_bins=40, max_depth=-1,
                   extra_trees=True, ff_bynode=True, cegb=True, n_groups=NG)

    class C:  # the Config fields make_split_params reads
        lambda_l1, lambda_l2, min_data_in_leaf = 0.0, 0.0, 20
        min_sum_hessian_in_leaf, min_gain_to_split = 1e-3, 0.0
        max_delta_step, path_smooth, cat_smooth, cat_l2 = 0.0, 0.0, 10., 10.
        max_cat_threshold, max_cat_to_onehot, min_data_per_group = 32, 4, 100
        cegb_tradeoff, cegb_penalty_split = tradeoff, pen_split
        feature_fraction_bynode = frac

    key_j = jax.random.fold_in(jax.random.key(seed), 5)
    nc_j = grower_j.make_node_candidates(
        grower_j.GrowerSpec(**spec_kw), grower_j.make_split_params(C),
        jnp.asarray(feat_mask), jnp.asarray(num_bins), jnp.asarray(nan_bin),
        key_j, jnp.asarray(gm),
        grower_j.CegbInfo(jnp.asarray(coupled), jnp.asarray(lazy),
                          jnp.asarray(used)), F)
    fm_j, rb_j, pen_j = jax.vmap(nc_j, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(salts, jnp.int32), jnp.asarray(groups),
        jnp.asarray(path_used), jnp.asarray(count), jnp.asarray(used))
    t = torch.from_numpy
    nc_t = grower_t.make_node_candidates(
        grower_t.GrowerSpec(rounds_slots=0, **spec_kw),
        grower_t.make_split_params(C), t(feat_mask), t(num_bins),
        t(nan_bin), rng.fold_in(rng.key(seed), 5), t(gm),
        grower_t.CegbInfo(t(coupled), t(lazy), t(used)))
    fm_t, rb_t, pen_t = nc_t(t(salts), t(groups), t(path_used), t(count),
                             t(used))
    np.testing.assert_array_equal(fm_t.numpy(), np.asarray(fm_j))
    np.testing.assert_array_equal(rb_t.numpy(), np.asarray(rb_j))
    np.testing.assert_array_max_ulp(pen_t.numpy(), np.asarray(pen_j), 1)
    # the masks do sample: each node keeps ceil(frac * valid) features
    valid = (feat_mask[None] & (gm[None] & groups[:, :, None]).any(1))
    np.testing.assert_array_equal(
        fm_t.numpy().sum(1),
        np.maximum(np.ceil(np.float32(frac) * valid.sum(1)), 1)
        * (valid.sum(1) > 0))


def test_split_search_takes_penalty_and_rand_bin():
    """best_split with a per-leaf penalty and random threshold equals the
    JAX package's search leaf by leaf."""
    rs = np.random.RandomState(3)
    Bt, F, B = 4, 5, 12
    hist = rs.rand(Bt, 3, F, B).astype(np.float32)
    hist[:, 0] -= 0.5
    hist[:, 2] = np.round(hist[:, 2] * 20)
    sums = hist.sum(axis=3)[:, :, 0]
    num_bins = np.full(F, B, np.int32)
    nan_bin = np.where(np.arange(F) % 2 == 0, B - 1, -1).astype(np.int32)
    mono = np.zeros(F, np.int32)
    pen = rs.rand(Bt, F).astype(np.float32) * 0.1
    rb = rs.randint(0, B - 2, (Bt, F)).astype(np.int32)
    fm = rs.rand(Bt, F) < 0.8
    p = dict(lambda_l1=0.0, lambda_l2=0.1, min_data_in_leaf=1.0,
             min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
             max_delta_step=0.0, path_smooth=0.0, cat_smooth=10.0,
             cat_l2=10.0, max_cat_threshold=32, max_cat_to_onehot=4,
             min_data_per_group=100.0)
    t = torch.from_numpy
    rec_t = best_split(
        t(hist), t(sums[:, 0]), t(sums[:, 1]), t(sums[:, 2]), t(num_bins),
        t(nan_bin), t(mono), SplitParams(**p), t(fm), penalty=t(pen),
        rand_bin=t(rb))
    pj = split_j.SplitParams(**{k: jnp.float32(v) for k, v in p.items()},
                             cegb_tradeoff=jnp.float32(1.0),
                             cegb_penalty_split=jnp.float32(0.0),
                             feature_fraction_bynode=jnp.float32(1.0))
    rj = jax.jit(jax.vmap(
        lambda h, sg, sh, sc, m, pe, r: split_j.best_split(
            h, sg, sh, sc, jnp.asarray(num_bins), jnp.asarray(nan_bin),
            jnp.asarray(mono), jnp.zeros(F, bool), pj, m, penalty=pe,
            rand_bin=r)))(jnp.asarray(hist), sums[:, 0], sums[:, 1],
                          sums[:, 2], jnp.asarray(fm), jnp.asarray(pen),
                          jnp.asarray(rb))
    for f in ("feature", "bin", "default_left"):
        np.testing.assert_array_equal(getattr(rec_t, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    np.testing.assert_allclose(rec_t.gain.numpy(), np.asarray(rj.gain),
                               rtol=1e-6)


# ---------------------------------------------------------------- trees
def _cases(forced_file):
    return {
        "extra_trees": {**PINS, "extra_trees": True},
        "bynode": {**PINS, "feature_fraction_bynode": 0.5},
        "cegb": {**PINS, "cegb_penalty_split": 0.01,
                 "cegb_penalty_feature_lazy": LAZY},
        "cegb_coupled": {**PINS, "cegb_penalty_split": 0.01,
                         "cegb_penalty_feature_coupled":
                             [5.0, 1.0, 0.0, 3.0, 1.0, 0.0]},
        "interaction": {**PINS, "interaction_constraints": GROUPS},
        "forced": {**PINS, "forcedsplits_filename": forced_file},
        "exact_all": {**EXACT, "extra_trees": True,
                      "feature_fraction_bynode": 0.6,
                      "cegb_penalty_split": 0.01,
                      "cegb_penalty_feature_lazy": LAZY,
                      "interaction_constraints": GROUPS},
        "exact_forced": {**EXACT, "forcedsplits_filename": forced_file},
    }


CASES = ["extra_trees", "bynode", "cegb", "cegb_coupled", "interaction",
         "forced", "exact_all", "exact_forced"]


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


def assert_same_trees(bj, bt, X):
    """Per node the same split, counts and children, leaf values within
    rtol 1e-5 (atol 1e-5), raw predictions on the training rows within
    1e-5. A node whose split differs is a tie of equal gains when every
    training row reaching it goes the same way in both trees (the gains
    are then equal in exact arithmetic: the same rows each side).
    Returns the number of such tie nodes."""
    mj, mt = bj._gbdt.models, bt._gbdt.models
    assert len(mj) == len(mt) > 0
    ties = 0
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert a.num_leaves == b.num_leaves, i
        for n in range(b.num_leaves - 1):
            sa = (int(a.split_feature[n]), float(a.threshold[n]),
                  int(a.decision_type[n]))
            sb = (int(b.split_feature[n]), float(b.threshold[n]),
                  int(b.decision_type[n]))
            if sa == sb:
                continue
            rows = _reaching(b, X, n)
            assert sa[0] == sb[0], (i, n, sa, sb)
            assert [a.go_left(n, X[r]) for r in rows] == \
                [b.go_left(n, X[r]) for r in rows], (i, n, sa, sb)
            ties += 1
        for k in ("left_child", "right_child", "internal_count",
                  "leaf_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5, err_msg=f"tree {i}")
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
    return ties


def _paths(tree):
    """The split features on each root-to-leaf path."""
    out, stack = [], [(0, frozenset())]
    while stack:
        n, feats = stack.pop()
        if n < 0:
            out.append(feats)
            continue
        f = feats | {int(tree.split_feature[n])}
        stack += [(tree.left_child[n], f), (tree.right_child[n], f)]
    return out


@pytest.fixture(scope="module")
def trained(forced_file):
    cache = {}

    def get(case):
        if case not in cache:
            X, y, _Xv, _yv = _data("binary")
            p = {**BASE, **_cases(forced_file)[case]}
            bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), ROUNDS,
                             callbacks=[_per_iteration])
            pt = {**p, "device_type": "cpu"}
            bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt),
                             ROUNDS)
            cache[case] = (bj, bt, X)
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES)
def test_trees_match_jax(trained, case):
    bj, bt, X = trained(case)
    ties = assert_same_trees(bj, bt, X)
    # one tie on this fixture (ROADMAP C): on the exact path under the
    # forced plan, tree 3's node 10 has two thresholds with no training
    # row between them in its leaf, whose f32 gains differ in the last
    # ulp the other way round in each package
    assert ties == (1 if case == "exact_forced" else 0), ties
    gb = bt._gbdt
    if case.startswith("exact"):
        assert gb.spec.rounds_slots == 0
    reason = gb.fused_ineligible_reason()
    if case == "cegb_coupled":
        assert reason == ("coupled CEGB penalties track model-wide "
                          "feature use")
    elif not case.startswith("exact"):
        assert reason is None and gb._fused is not None


@pytest.mark.parametrize("case", ["interaction", "exact_all"])
def test_interaction_constraint_holds_on_every_path(trained, case):
    _bj, bt, _X = trained(case)
    groups = [{0, 1, 2}, {3, 4, 5}]
    n_paths = 0
    for tree in bt._gbdt.models:
        for feats in _paths(tree):
            n_paths += 1
            assert any(feats <= g for g in groups), feats
    assert n_paths > 2 * ROUNDS


@pytest.mark.parametrize("case", ["forced", "exact_forced"])
def test_forced_plan_leads_every_tree(trained, case):
    """The first four splits of every tree are the plan's, BFS order,
    with its thresholds mapped to bin bounds."""
    _bj, bt, _X = trained(case)
    for tree in bt._gbdt.models:
        assert list(tree.split_feature[:4]) == [0, 1, 2, 3]
        assert tree.left_child[0] == 1 and tree.right_child[0] == 2
        assert tree.left_child[2] == 3
        for n, thr in ((0, 0.1), (1, -0.2), (2, 0.3), (3, 0.0)):
            assert abs(tree.threshold[n] - thr) < 0.1


# -------------------------------------------------------- fused == eager
@pytest.fixture
def bounded(monkeypatch):
    monkeypatch.setattr(boosting._FusedProgram, "cpu_loop",
                        device_loop.BOUNDED)


def _train_port(params, fused, rounds=3, n=300, num_leaves=15):
    X, y, Xv, yv = _data("binary", n=n)
    p = {**BASE, **params, "metric": "auc", "device_type": "cpu",
         "num_leaves": num_leaves}
    ds = lgb_t.Dataset(X, label=y, params=p)
    cbs = [] if fused else [_per_iteration]
    return lgb_t.train(p, ds, rounds, valid_sets=[
        lgb_t.Dataset(Xv, label=yv, reference=ds)], callbacks=cbs)


FUSED = ["extra_trees", "bynode", "cegb", "interaction", "forced"]


@pytest.mark.parametrize("case", FUSED + ["all"])
def test_fused_equals_eager_bitwise(bounded, forced_file, case):
    cases = _cases(forced_file)
    params = ({k: v for c in FUSED for k, v in cases[c].items()}
              if case == "all" else cases[case])
    be = _train_port(params, fused=False)
    bf = _train_port(params, fused=True)
    assert bf._gbdt._fused is not None and be._gbdt._fused is None
    assert be.model_to_string() == bf.model_to_string()
    ge, gf = be._gbdt, bf._gbdt
    for a, b in zip([ge.train] + ge.valids, [gf.train] + gf.valids):
        assert torch.equal(a.score, b.score)


def test_fused_step_reads_nothing_back(bounded, forced_file, monkeypatch):
    """The fused step with every fused-eligible extra and the forced plan
    on: no host read, no cross-device copy."""
    step = boosting._FusedProgram.step
    calls = []

    def guarded(self, loop):
        calls.append(loop.mode)
        with _NoReadBack():
            step(self, loop)

    monkeypatch.setattr(boosting._FusedProgram, "step", guarded)
    cases = _cases(forced_file)
    _train_port({k: v for c in FUSED for k, v in cases[c].items()},
                fused=True, rounds=2, num_leaves=7)
    assert calls and set(calls) == {device_loop.BOUNDED}


# ------------------------------------------------- set-up and refusals
def _tiny(extra):
    X, y, _Xv, _yv = _data("binary", n=200)
    p = {**BASE, **PINS, "device_type": "cpu", **extra}
    return lgb_t.Booster(p, lgb_t.Dataset(X, label=y, params=p))


def test_cegb_list_of_wrong_length_is_fatal():
    with pytest.raises(lgb_t.LightGBMError, match="one entry per feature"):
        _tiny({"cegb_penalty_feature_lazy": [1.0, 2.0]})


def test_unreadable_forced_plan_warns_and_trains(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    gb = _tiny({"forcedsplits_filename": str(bad)})._gbdt
    assert gb._forced is None and gb.spec.n_forced == 0
    gb = _tiny({"forcedsplits_filename": str(tmp_path / "none.json")})._gbdt
    assert gb._forced is None


def test_monotone_intermediate_falls_back_with_extras():
    mono = {"monotone_constraints": [1, 0, 0, 0, 0, 0],
            "monotone_constraints_method": "intermediate"}
    gb = _tiny({**mono, "extra_trees": True})._gbdt
    assert gb.spec.extra_trees and gb.spec.has_mono
    assert gb.spec.mono_mode == 0
    gb = _tiny(mono)._gbdt  # without an extra: intermediate
    assert gb.spec.mono_mode == 1 and not gb.spec.extra_trees


def test_growth_rounds_phase_off_with_extras(forced_file):
    p = {"tpu_growth_mode": "exact", "tpu_growth_rounds": True}
    assert _tiny(p)._gbdt.spec.rounds
    assert not _tiny({**p, "feature_fraction_bynode": 0.5})._gbdt.spec.rounds
    assert not _tiny({**p, "forcedsplits_filename": forced_file}
                     )._gbdt.spec.rounds
