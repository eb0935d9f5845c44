"""End to end: lightgbm_tpu_torch.train (device_type=cpu: the kernels'
plain versions) against lightgbm_tpu.train on tiny binary, regression and
multiclass cases, both pinned to the rounds grower and int16 levels (off
the chip the JAX package's `auto` resolves elsewhere). The tree sections
of the model text have the same structure, leaf values agree within rtol
1e-5, raw predictions within 1e-5, and the port loads the JAX package's
model text and predicts the same."""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.learner.split import SplitParams, leaf_gain
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}


def _data(task, n=800, f=6, seed=7):
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


CASES = {
    "binary": ({"objective": "binary", "num_leaves": 15,
                "min_data_in_leaf": 5, "metric": "auc"}, 6),
    "regression": ({"objective": "regression", "num_leaves": 31,
                    "min_data_in_leaf": 5, "learning_rate": 0.2}, 5),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "min_data_in_leaf": 10}, 4),
}

_STRUCT = ("num_leaves", "split_feature", "threshold", "decision_type",
           "left_child", "right_child", "leaf_count", "internal_count")


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


@pytest.fixture(scope="module", params=list(CASES))
def trained(request):
    task = request.param
    params, rounds = CASES[task]
    X, y, Xv, yv = _data(task)
    pj = {**params, **PINS}
    pt = {**params, **PINS, "device_type": "cpu"}
    ev_j, ev_t = {}, {}
    bj = lgb_j.train(pj, lgb_j.Dataset(X, label=y), rounds,
                     valid_sets=[lgb_j.Dataset(Xv, label=yv)],
                     valid_names=["v"],
                     callbacks=[lgb_j.record_evaluation(ev_j)])
    dt = lgb_t.Dataset(X, label=y, params={"device_type": "cpu"})
    bt = lgb_t.train(pt, dt, rounds,
                     valid_sets=[lgb_t.Dataset(Xv, label=yv, reference=dt)],
                     valid_names=["v"], evals_result=ev_t)
    return task, bj, bt, Xv, ev_j, ev_t


def test_tree_structure_equal(trained):
    _, bj, bt, *_ = trained
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    for a, b in zip(tj, tt):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k


def test_leaf_values_close(trained):
    _, bj, bt, *_ = trained
    for a, b in zip(_trees(bj.model_to_string()),
                    _trees(bt.model_to_string())):
        va = np.array(a["leaf_value"].split(), float)
        vb = np.array(b["leaf_value"].split(), float)
        np.testing.assert_allclose(vb, va, rtol=1e-5, atol=1e-7)


def test_raw_predictions_close(trained):
    _, bj, bt, Xv, *_ = trained
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)


def test_eval_records_close(trained):
    *_, ev_j, ev_t = trained
    for metric, vals in ev_j["v"].items():
        np.testing.assert_allclose(ev_t["v"][metric], vals, rtol=1e-4,
                                   atol=1e-6, err_msg=metric)


def test_port_loads_jax_model_text(trained):
    _, bj, _, Xv, *_ = trained
    b = booster_from_model_string(bj.model_to_string())
    np.testing.assert_allclose(b.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-9)
    np.testing.assert_allclose(b.predict(Xv), bj.predict(Xv), atol=1e-9)


def test_model_text_round_trip(trained, tmp_path):
    _, _, bt, Xv, *_ = trained
    path = tmp_path / "model.txt"
    bt.save_model(path)
    loaded = lgb_t.Booster(model_file=path)
    np.testing.assert_array_equal(loaded.predict(Xv), bt.predict(Xv))


EDGE = {
    "no_split_possible": ({"objective": "binary", "min_data_in_leaf": 200},
                          {}),
    "weighted": ({"objective": "regression", "num_leaves": 7},
                 {"weight": True}),
    "two_leaves": ({"objective": "binary", "num_leaves": 2}, {}),
    "init_score": ({"objective": "binary", "num_leaves": 5},
                   {"init_score": True}),
}


@pytest.mark.parametrize("case", list(EDGE))
def test_edge_cases_match(case):
    """The stop rule (no leaf can split: one constant tree carrying the
    boost-from-average bias), sample weights, the smallest tree and a
    given init_score: same trees and raw predictions as lightgbm_tpu."""
    params, extra = EDGE[case]
    rs = np.random.RandomState(0)
    X = rs.randn(300, 4)
    z = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(300)
    y = z if params["objective"] == "regression" else (z > 0).astype(float)
    kw = {}
    if extra.get("weight"):
        kw["weight"] = rs.rand(300) + 0.5
    if extra.get("init_score"):
        kw["init_score"] = 0.3 * rs.randn(300)
    bj = lgb_j.train({**params, **PINS}, lgb_j.Dataset(X, label=y, **kw), 4)
    pt = {**params, **PINS, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt, **kw), 4)
    assert bt.num_trees() == bj.num_trees()
    for a, b in zip(_trees(bj.model_to_string()),
                    _trees(bt.model_to_string())):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def _split_nodes(tree):
    """(feature, threshold, parent node, side) of each split node, in
    node order: where two trees first differ in what they split."""
    parent = {}
    for i in range(len(tree.split_feature)):
        parent[int(tree.left_child[i])] = (i, 0)
        parent[int(tree.right_child[i])] = (i, 1)
    return [(int(tree.split_feature[i]), float(tree.threshold[i]),
             parent.get(i)) for i in range(len(tree.split_feature))]


def _child_rows(tree, leaf_of_row, node):
    """Row masks of the left and right child of split `node`, from each
    row's leaf (pred_leaf)."""
    def leaves(c):
        out, stack = [], [c]
        while stack:
            c = stack.pop()
            if c < 0:
                out.append(~c)
            else:
                stack += [int(tree.left_child[c]), int(tree.right_child[c])]
        return out
    return (np.isin(leaf_of_row, leaves(int(tree.left_child[node]))),
            np.isin(leaf_of_row, leaves(int(tree.right_child[node]))))


@pytest.mark.parametrize("mds", [0.3, 0.05])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_max_delta_step_diverges_only_at_ties(objective, mds):
    """max_delta_step clamps every leaf output to +-mds. A split whose
    parent and two children all clamp to the same output has gain
    exactly zero, -(2 G o + H o^2) summing to zero over the children,
    and f32 rounding decides whether a package counts it as positive
    and takes it (ROADMAP C). Each of 5 trees is grown by both packages
    from the same init scores (the JAX model's raw scores before that
    tree), so each tree is compared on its own. Where a tree first
    differs (node k in node order), each package's node-k split either
    is such an exact zero, shown from the rows the tree sends there
    (parent and children unclamped outputs -G/H beyond +-mds on one
    side, in f64) and by the port's own leaf_gain on those sums (at
    most the f32 rounding of the leaf-gain terms, eps32 x M, M = 2 mds
    sum|g| + mds^2 sum h), or has the same gain as the other package's
    within 1e-6 relative (two leaves of equal gain taken in the other
    order). A tree with one node more than the other is checked at that
    node alone. Trees that do not differ have the same leaf values."""
    n, f = 800, 6
    rs = np.random.RandomState(7)  # the rows of _data, 200 held out
    X = rs.randn(n + 200, f)
    X[rs.rand(n + 200, f) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(f)
    noise = rs.randn(n + 200)
    X, z, noise = X[:n], z[:n], noise[:n]
    binary = objective == "binary"
    y = (z + 0.3 * noise > 1).astype(float) if binary else z + 0.1 * noise
    p = {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 5,
         "max_delta_step": mds, **PINS}
    pt = {**p, "device_type": "cpu"}
    sp = SplitParams(0.0, 0.0, 5, 1e-3, 0.0, mds, 0.0, 10.0, 10.0, 32, 4,
                     100.0)
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), 5)
    eps32 = float(np.finfo(np.float32).eps)
    for t in range(5):
        if t == 0:
            m = y.mean()
            init = np.full(n, np.log(m / (1 - m)) if binary else m)
        else:
            init = bj.predict(X, raw_score=True, num_iteration=t)
        ba = lgb_j.train(p, lgb_j.Dataset(X, label=y, init_score=init), 1)
        bb = lgb_t.train(pt, lgb_t.Dataset(X, label=y, init_score=init,
                                           params=pt), 1)
        a, b = ba._gbdt.models[0], bb._gbdt.models[0]
        na, nb = _split_nodes(a), _split_nodes(b)
        k = next((i for i, (u, v) in enumerate(zip(na, nb)) if u != v),
                 None)
        if k is None and len(na) == len(nb):
            np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                       rtol=1e-5, atol=1e-7)
            continue
        k = min(len(na), len(nb)) if k is None else k
        assert k > 0, "the root split differs"
        s = init.astype(np.float32).astype(np.float64)
        if binary:
            prob = 1.0 / (1.0 + np.exp(-s))
            g, h = prob - y, prob * (1.0 - prob)
        else:
            g, h = s - y, np.ones(n)
        noise_gain = eps32 * (2 * mds * np.abs(g).sum() + mds ** 2 * h.sum())
        # each row's leaf; the port's tree is read back by the JAX package
        rows = {"jax": (a, ba.predict(X, pred_leaf=True).reshape(n)),
                "port": (b, lgb_j.Booster(model_str=bb.model_to_string())
                         .predict(X, pred_leaf=True).reshape(n))}
        gains = {name: float(tree.split_gain[k])
                 for name, (tree, _) in rows.items()
                 if k < len(tree.split_feature)}
        if len(gains) == 2 and min(gains.values()) > noise_gain:
            ga, gb = gains["jax"], gains["port"]
            assert abs(ga - gb) <= 1e-6 * max(ga, gb), (t, k, ga, gb)
            continue
        for name, gain in gains.items():
            if gain > noise_gain:
                continue  # the other package's node k is the zero split
            tree, leaf = rows[name]
            left, right = _child_rows(tree, leaf, k)
            sums = [(g[m].sum(), h[m].sum())
                    for m in (left, right, left | right)]
            outs = np.array([-sg / sh for sg, sh in sums])
            assert (np.all(outs > mds * 1.01) or np.all(outs < -mds * 1.01)), \
                (t, k, name, gain, outs)
            lg = [leaf_gain(torch.tensor(sg, dtype=torch.float32),
                            torch.tensor(sh, dtype=torch.float32), sp)
                  for sg, sh in sums]
            port_gain = float(lg[0] + lg[1] - lg[2])
            assert abs(port_gain) <= noise_gain, (t, k, name, port_gain)
