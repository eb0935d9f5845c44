"""Monotone constraints under the intermediate and advanced methods:
lightgbm_tpu_torch against lightgbm_tpu on the same seeded inputs, JAX on
the CPU, both pinned to the rounds grower and int16 levels (or to the
exact grower), the JAX side on its per-iteration loop.

- trees equal to the JAX package's on binary, regression and multiclass
  (test_torch_train._data, 5% NaNs in every column, so advanced keeps
  every leaf's full bin ranges there) and, for advanced, on the same rows
  with the NaNs of columns 0-3 filled (ranges that narrow): the same
  splits, counts and children, leaf values within rtol 1e-5, raw
  predictions on held-out rows within 1e-6 (absolute or relative);
  intermediate on the exact
  grower (a node may differ only where every row reaching it goes the
  same way, test_torch_node_extras.assert_same_trees); advanced on the
  ranged regression rows diverges only at a tie of the f32 rounding
  (assert_first_difference_is_tie);
- the conflict guard defers splits on these fixtures, and advanced grows
  other trees than intermediate where ranges narrow;
- grower.mono_bounds on a hand-made tree;
- fused == eager bit for bit for both methods, and the fused step reads
  nothing back;
- the violation scan of tests/test_constraints_smoothing.py on the port,
  for every method on the rounds grower and intermediate on the exact
  grower;
- the fall-backs, warned in both packages: basic beside the per-node
  extras and a forced plan, intermediate for advanced on the exact
  grower;
- ROADMAP C.2 decided: basic monotone with a forced plan diverges from
  the JAX package only at ties decided by the f32 rounding of the
  leaf-gain terms, on both growers.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch import boosting
from lightgbm_tpu_torch.learner import device_loop
from lightgbm_tpu_torch.learner.grower import mono_bounds
from test_torch_fused import _NoReadBack
from test_torch_node_extras import _per_iteration, assert_same_trees
from test_torch_train import _child_rows, _data, _split_nodes
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
EXACT = {"tpu_growth_mode": "exact", "verbosity": -1}
MONO = [1, -1, 0, 1, 0, -1]
TASKS = {
    "binary": {"objective": "binary", "num_leaves": 15,
               "min_data_in_leaf": 5},
    "regression": {"objective": "regression", "num_leaves": 31,
                   "min_data_in_leaf": 5, "learning_rate": 0.2},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "num_leaves": 7, "min_data_in_leaf": 10},
}
ROUNDS = 6


def _ranged(task):
    """_data(task) with the NaNs of columns 0-3 filled: features without a
    NaN bin, whose bin ranges advanced narrows."""
    X, y, Xv, yv = _data(task)
    rs = np.random.RandomState(3)
    fill = np.isnan(X) & (np.arange(X.shape[1]) < 4)
    X = np.where(fill, rs.randn(*X.shape), X)
    return X, y, Xv, yv


def _params(task, method, pins=PINS, **extra):
    return {**TASKS[task], **pins, "monotone_constraints": MONO,
            "monotone_constraints_method": method, **extra}


def _grad_recorder(monkeypatch):
    """Records what the port's grower gets for each tree, in model order:
    (g, h, bag mask) as f64 values (integer levels times their scales)."""
    seen = []
    grow = boosting.GBDT._grow

    def recording(self, gk, hk, mask, *a, **kw):
        scale = a[4] if len(a) > 4 else kw.get("gh_scale")
        g, h = gk.double(), hk.double()
        if scale is not None:
            g, h = g * scale[0].double(), h * scale[1].double()
        seen.append(tuple(v.numpy() for v in (g, h, mask.double())))
        return grow(self, gk, hk, mask, *a, **kw)

    monkeypatch.setattr(boosting.GBDT, "_grow", recording)
    return seen


def _child_output(tree, c, bias):
    """The output the grower gave child c of a split: a node's value, or
    a leaf's value without the shrinkage and the boost-from-average
    bias of the first iteration's trees."""
    if c >= 0:
        return float(tree.internal_value[c])
    return (float(tree.leaf_value[~c]) - bias) / tree.shrinkage


def assert_first_difference_is_tie(bj, bt, X, grads, clamped=False,
                                   l2=0.0):
    """Trees agree up to the first that differs (leaf values within rtol
    1e-5); there, at the first node k whose split (feature, threshold,
    parent) differs, either both packages' gains agree within 1e-6
    relative (equal leaves taken in the other order), or a package's
    split at k is a zero of exact arithmetic within the f32 rounding of
    the leaf-gain terms: from the in-bag rows the tree sends to its two
    children (read back by the JAX package, pred_leaf) and the port's
    grower inputs (G, H), the f64 gain and the package's own f32 gain
    both lie within 4 eps32 M, M the sum of the magnitudes of the three
    leaf-gain terms (each takes a few f32 roundings), and the f32 gain is
    above 0 (the package split there). The gain is
    sum_c G_c^2 / (H_c + l2) - G^2 / (H + l2); under monotone clamps
    (clamped) each child's term is -(2 G_c o_c + (H_c + l2) o_c^2) at
    the output o_c the tree gave it. Returns (tree, node) of the
    difference, or None."""
    n = X.shape[0]
    K = bt._gbdt.num_class
    init = bt._gbdt._init_scores or [0.0] * K
    eps32 = float(np.finfo(np.float32).eps)
    mj, mt = bj._gbdt.models, bt._gbdt.models
    leaves = {"jax": bj.predict(X, pred_leaf=True).reshape(n, -1),
              "port": lgb_j.Booster(model_str=bt.model_to_string())
              .predict(X, pred_leaf=True).reshape(n, -1)}
    for ti, (a, b) in enumerate(zip(mj, mt)):
        na, nb = _split_nodes(a), _split_nodes(b)
        k = next((i for i, (u, v) in enumerate(zip(na, nb)) if u != v),
                 None)
        if k is None and len(na) == len(nb):
            np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                       rtol=1e-5, atol=1e-7)
            continue
        k = min(len(na), len(nb)) if k is None else k
        assert k > 0, (ti, "the root split differs")
        g, h, m = grads[ti]
        g, h, inbag = g[:n], h[:n], m[:n] > 0
        gains = {name: float(t.split_gain[k])
                 for name, t in (("jax", a), ("port", b))
                 if k < len(t.split_feature)}
        if len(gains) == 2 and abs(gains["jax"] - gains["port"]) <= \
                1e-6 * max(abs(v) for v in gains.values()):
            return ti, k
        zeros = 0
        for name, tree in (("jax", a), ("port", b)):
            if name not in gains:
                continue
            left, right = _child_rows(tree, leaves[name][:, ti], k)
            sums = [(g[r].sum(), h[r].sum() + l2)
                    for r in (left & inbag, right & inbag,
                              (left | right) & inbag)]
            terms = [sg * sg / sh for sg, sh in sums]
            if clamped:
                bias = init[ti] if ti < K else 0.0
                outs = [_child_output(tree, int(c), bias) for c in (
                    tree.left_child[k], tree.right_child[k])]
                terms[:2] = [-(2 * sg * o + sh * o * o)
                             for (sg, sh), o in zip(sums, outs)]
            exact = terms[0] + terms[1] - terms[2]
            noise = 4 * eps32 * sum(abs(v) for v in terms)
            if gains[name] <= noise:
                assert gains[name] > 0 and exact <= noise, \
                    (ti, k, name, gains[name], exact, noise)
                zeros += 1
        assert zeros, (ti, k, gains)
        return ti, k
    return None


# ------------------------------------------------------------ parity
CASES = {
    **{f"{t}_{m}": (t, m, "rounds", _data)
       for t in TASKS for m in ("intermediate", "advanced")},
    "binary_advanced_ranged": ("binary", "advanced", "rounds", _ranged),
    "multiclass_advanced_ranged": ("multiclass", "advanced", "rounds",
                                   _ranged),
    "exact_binary": ("binary", "intermediate", "exact", _data),
    "exact_regression": ("regression", "intermediate", "exact", _data),
}
# nodes on the exact grower whose default direction and threshold differ
# between the packages while every training row reaching them goes the
# same way (assert_same_trees)
EXACT_TIES = {"exact_binary": 2, "exact_regression": 2}


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(case):
        if case not in cache:
            task, method, grower, data = CASES[case]
            X, y, Xv, yv = data(task)
            p = _params(task, method, EXACT if grower == "exact" else PINS)
            bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), ROUNDS,
                             callbacks=[_per_iteration])
            pt = {**p, "device_type": "cpu"}
            bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt),
                             ROUNDS)
            cache[case] = (bj, bt, X, Xv)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_trees_match_jax(trained, case):
    bj, bt, X, Xv = trained(case)
    _task, method, grower, _ = CASES[case]
    assert assert_same_trees(bj, bt, X) == EXACT_TIES.get(case, 0)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), rtol=1e-6,
                               atol=1e-6)
    gb = bt._gbdt
    mode = {"intermediate": 1, "advanced": 2}[method]
    assert gb.spec.mono_mode == mode == bj._gbdt.spec.mono_mode
    if grower == "rounds":
        assert gb.fused_ineligible_reason() is None
        assert int(gb.mono_deferred) > 0  # the conflict guard acted
    else:
        assert gb.spec.rounds_slots == 0 and gb.mono_deferred is None


def test_advanced_ranged_regression_diverges_only_at_ties(monkeypatch):
    """On the ranged regression rows advanced clamps more leaves, and
    their gains, -(2 G o + (H + l2) o^2) at the clamped output o, round
    differently in the two packages: XLA contracts the multiply-adds into
    fused ones. The trees part at a split of exact gain zero."""
    X, y, _Xv, _yv = _ranged("regression")
    p = _params("regression", "advanced")
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), ROUNDS,
                     callbacks=[_per_iteration])
    grads = _grad_recorder(monkeypatch)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt), ROUNDS)
    assert assert_first_difference_is_tie(bj, bt, X, grads,
                                          clamped=True) is not None


def test_advanced_narrows_where_ranges_narrow(trained):
    """Where features have no NaN bin, advanced's pairwise tables leave
    out leaves whose ranges cannot meet and grows other trees than
    intermediate (in both packages); with a NaN bin in every feature
    (the _data rows) it grows intermediate's trees."""
    for data, same in ((_data, True), (_ranged, False)):
        X, y, _Xv, _yv = data("binary")
        texts = []
        for method in ("intermediate", "advanced"):
            p = {**_params("binary", method), "device_type": "cpu"}
            bst = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p),
                              ROUNDS)
            texts.append(bst.model_to_string().split("parameters:")[0]
                         .replace("advanced", "intermediate"))
        assert (texts[0] == texts[1]) == same


def test_mono_bounds_by_hand():
    """A 3-split tree: node 0 on an increasing feature (leaf 0 left,
    leaves 1 and 2 right, node 1 splitting them on a decreasing feature),
    node 2 splitting leaf 0 on an unconstrained feature into leaves 0
    and 3. Leaf outputs 0.1, 0.5, 0.3, -0.2."""
    L = 5
    anc_in = torch.zeros((L, L - 1), dtype=torch.bool)
    anc_left = torch.zeros_like(anc_in)
    for leaf, nodes in ((0, {0: 1, 2: 1}), (3, {0: 1, 2: 0}),
                        (1, {0: 0, 1: 1}), (2, {0: 0, 1: 0})):
        for a, left in nodes.items():
            anc_in[leaf, a] = True
            anc_left[leaf, a] = bool(left)
    out = torch.tensor([0.1, 0.5, 0.3, -0.2, 9.0])
    feat = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    cat = torch.zeros(L - 1, dtype=torch.bool)
    mono = torch.tensor([1, -1, 0], dtype=torch.int32)
    i_new = torch.tensor(3)
    lo, hi = mono_bounds(1, anc_in, anc_left, out, feat, cat, mono, i_new)
    big = 1e29
    # left of node 0: below min(0.5, 0.3); right: above max(0.1, -0.2);
    # leaf 1 (left of decreasing node 1) above 0.3, leaf 2 below 0.5
    np.testing.assert_allclose(hi.numpy()[:4], [0.3, big, 0.5, 0.3])
    np.testing.assert_allclose(lo.numpy()[:4], [-big, 0.3, 0.1, -big])
    # advanced: leaves 0 and 3 hold feature 1 in (-1, 2], leaf 2 in
    # (4, 8]: they never meet off node 0's feature, so through node 0
    # leaves 0 and 3 are bounded by leaf 1 alone and leaf 2 by nothing
    flo = torch.full((L, 3), -1, dtype=torch.int32)
    fhi = torch.full((L, 3), 8, dtype=torch.int32)
    fhi[0, 1] = fhi[3, 1] = 2  # leaves 0, 3: feature 1 in (-1, 2]
    flo[2, 1] = 4  # leaf 2: feature 1 in (4, 8]
    lo2, hi2 = mono_bounds(2, anc_in, anc_left, out, feat, cat, mono, i_new,
                           flo, fhi)
    np.testing.assert_allclose(hi2.numpy()[:4], [0.5, big, 0.5, 0.5])
    np.testing.assert_allclose(lo2.numpy()[:4], [-big, 0.3, -big, -big])
    # a categorical node bounds nothing
    lo3, hi3 = mono_bounds(1, anc_in, anc_left, out, feat,
                           torch.ones(L - 1, dtype=torch.bool), mono, i_new)
    assert (hi3[:4] == big).all() and (lo3[:4] == -big).all()


# -------------------------------------------------------- fused == eager
@pytest.fixture
def bounded(monkeypatch):
    monkeypatch.setattr(boosting._FusedProgram, "cpu_loop",
                        device_loop.BOUNDED)


def _train_port(method, fused, rounds=3, n=300, num_leaves=15):
    X, y, Xv, yv = _ranged("binary")
    X, y = X[:n], y[:n]
    p = {**_params("binary", method), "metric": "auc", "device_type": "cpu",
         "num_leaves": num_leaves}
    ds = lgb_t.Dataset(X, label=y, params=p)
    cbs = [] if fused else [_per_iteration]
    return lgb_t.train(p, ds, rounds, valid_sets=[
        lgb_t.Dataset(Xv, label=yv, reference=ds)], callbacks=cbs)


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_fused_equals_eager_bitwise(bounded, method):
    be = _train_port(method, fused=False)
    bf = _train_port(method, fused=True)
    assert bf._gbdt._fused is not None and be._gbdt._fused is None
    assert be.model_to_string() == bf.model_to_string()
    ge, gf = be._gbdt, bf._gbdt
    for a, b in zip([ge.train] + ge.valids, [gf.train] + gf.valids):
        assert torch.equal(a.score, b.score)
    assert int(ge.mono_deferred) == int(gf.mono_deferred) > 0


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_fused_step_reads_nothing_back(bounded, monkeypatch, method):
    step = boosting._FusedProgram.step
    calls = []

    def guarded(self, loop):
        calls.append(loop.mode)
        with _NoReadBack():
            step(self, loop)

    monkeypatch.setattr(boosting._FusedProgram, "step", guarded)
    _train_port(method, fused=True, rounds=2, num_leaves=7)
    assert calls and set(calls) == {device_loop.BOUNDED}


# ------------------------------------------------------ violation scan
def _check_monotone(bst, X, feat, direction, n_checks=40, n_grid=25):
    """tests/test_constraints_smoothing._check_monotone: predictions
    along a grid of the constrained feature never move against it."""
    rs = np.random.RandomState(1)
    rows = X[rs.choice(len(X), n_checks, replace=False)]
    grid = np.linspace(X[:, feat].min(), X[:, feat].max(), n_grid)
    for r in rows:
        tiled = np.tile(r, (n_grid, 1))
        tiled[:, feat] = grid
        diffs = np.diff(bst.predict(tiled)) * direction
        assert (diffs >= -1e-9).all(), (feat, diffs.min())


@pytest.mark.parametrize("grower, method", [
    ("rounds", "basic"), ("rounds", "intermediate"), ("rounds", "advanced"),
    ("exact", "intermediate")])
@pytest.mark.parametrize("direction", [1, -1])
def test_violation_scan(grower, method, direction):
    """Deep trees on a target that tempts violations (a sine on the
    constrained feature), at 1,000 rows and 8 rounds."""
    rs = np.random.RandomState(5)
    n = 1000
    X = rs.randn(n, 4)
    y = direction * (1.5 * X[:, 0] + 0.8 * np.sin(4 * X[:, 0])) \
        + X[:, 1] + 0.2 * rs.randn(n)
    p = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
         "monotone_constraints": [direction, 0, 0, 0], "learning_rate": 0.2,
         "min_data_in_leaf": 3, "monotone_constraints_method": method,
         "tpu_growth_mode": grower, "device_type": "cpu"}
    bst = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 8)
    assert bst._gbdt.spec.mono_mode == {"basic": 0, "intermediate": 1,
                                        "advanced": 2}[method]
    _check_monotone(bst, X, 0, direction)


# ---------------------------------------------------------- fall-backs
@pytest.fixture(scope="module")
def forced_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mono_forced") / "forced.json"
    path.write_text(json.dumps({"feature": 0, "threshold": 0.1, "left": {
        "feature": 1, "threshold": -0.2}}))
    return str(path)


def _setup(pkg, params, capsys):
    """(GBDT, stderr) of a Booster set up by pkg (no training)."""
    X, y, _Xv, _yv = _data("binary", n=200)
    p = {**params, "verbosity": 0}
    if pkg is lgb_t:
        p["device_type"] = "cpu"
    capsys.readouterr()
    gb = pkg.Booster(p, pkg.Dataset(X, label=y, params=p))._gbdt
    return gb, capsys.readouterr().err


@pytest.mark.parametrize("extra", ["extra_trees", "forced"])
@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_basic_fallback_warns(capsys, forced_file, extra, method):
    more = ({"extra_trees": True} if extra == "extra_trees"
            else {"forcedsplits_filename": forced_file})
    for pkg in (lgb_j, lgb_t):
        gb, err = _setup(pkg, _params("binary", method, **more), capsys)
        assert gb.spec.mono_mode == 0
        assert "falling back to method=basic" in err, pkg.__name__


def test_exact_advanced_becomes_intermediate(capsys):
    for pkg in (lgb_j, lgb_t):
        gb, err = _setup(pkg, _params("binary", "advanced", EXACT), capsys)
        assert gb.spec.mono_mode == 1 and gb.spec.rounds_slots == 0
        assert "using method=intermediate" in err, pkg.__name__


def test_exact_intermediate_turns_the_round_phase_off():
    X, y, _Xv, _yv = _data("binary", n=200)
    p = {**_params("binary", "intermediate", EXACT),
         "tpu_growth_rounds": True, "device_type": "cpu"}
    gb = lgb_t.Booster(p, lgb_t.Dataset(X, label=y, params=p))._gbdt
    assert gb.spec.mono_mode == 1 and not gb.spec.rounds


# ------------------------------------------------- ROADMAP C.2: a tie
@pytest.mark.parametrize("grower", ["rounds", "exact"])
def test_basic_monotone_forced_plan_diverges_only_at_ties(
        monkeypatch, forced_file, grower):
    """ROADMAP C.2's probe: basic monotone on columns 0 (+1) and 2 (-1)
    with a forced plan whose first split is on column 0. The forced
    split ignores the order of its children's outputs, so their bounds
    meet at the midpoint and the leaves below clamp there: the gains
    left late in the tree are zeros of exact arithmetic (children with
    equal g / h ratios: pure leaves, whose rows carry one gradient) or
    within the rounding of their leaf-gain terms, and the packages,
    rounding the clamped gain -(2 G o + (H + l2) o^2) differently (XLA
    contracts it into fused multiply-adds), take different ones. Every
    bound and output before the first differing node is bitwise the JAX
    package's."""
    X, y, _Xv, _yv = _data("binary")
    pins = PINS if grower == "rounds" else EXACT
    p = {**TASKS["binary"], **pins, "monotone_constraints": [1, 0, -1, 0, 0,
                                                            0],
         "forcedsplits_filename": forced_file}
    rounds = 8 if grower == "rounds" else 4
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), rounds,
                     callbacks=[_per_iteration])
    grads = _grad_recorder(monkeypatch)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt), rounds)
    where = assert_first_difference_is_tie(bj, bt, X, grads, clamped=True)
    assert where is not None and where[1] >= 8, where  # past the plan
    a, b = bj._gbdt.models[where[0]], bt._gbdt.models[where[0]]
    k = where[1]
    np.testing.assert_array_equal(b.internal_value[:k], a.internal_value[:k])
