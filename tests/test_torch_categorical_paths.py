"""Categorical training on the other growth paths and objectives: the
port against the JAX package on the fixtures of
tests/test_torch_categorical.py (one-vs-rest only, sorted-subset, NaN in
the categorical columns, EFB beside them).

- use_quantized_grad (the int8 channels, rounds grower) and
  tpu_hist_dtype=bf16x2 (f32 channels, rounds grower): the fused round's
  category-set test in its other channel modes;
- tpu_growth_mode=exact, with and without tpu_growth_rounds: the
  permuted grower's categorical partition;
- regression and multiclass on the default int16 path.

Each compares the tree sections of the model text, raw predictions
within 1e-5 and the validation metrics (assert_same_models), except the
two runs in MIRRORED, where the packages take opposite sides of a
mirrored categorical split (ROADMAP C): test_mirrored_categorical_ties
holds those to the same functions of the rows.
"""

import numpy as np
import pytest

from test_torch_categorical import (_cat_data, _trees, assert_same_models,
                                    train_both)
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PATHS = {
    "quant": {"tpu_growth_mode": "rounds", "use_quantized_grad": True,
              "verbosity": -1},
    "bf16x2": {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2",
               "verbosity": -1},
    "exact": {"tpu_growth_mode": "exact", "verbosity": -1},
}
KINDS = ["onehot", "subset", "nan", "efb"]
# runs whose trees hold a split that both packages score equal in exact
# arithmetic from either side: one-vs-rest on a leaf holding two
# categories (the f32 exact path), a sorted-subset prefix and its
# complement (use_quantized_grad with EFB)
MIRRORED = [("exact", "onehot"), ("quant", "efb")]


@pytest.mark.parametrize("path,kind", [
    (p, k) for p in PATHS for k in KINDS if (p, k) not in MIRRORED])
def test_path_models_match_jax(path, kind):
    bj, bt, Xv, ev_j, ev_t = train_both(kind, pins=PATHS[path], rounds=3)
    assert_same_models(bj, bt, Xv, ev_j, ev_t)
    gb = bt._gbdt
    assert gb.spec.has_cat
    if path == "quant":
        assert gb.hist_dtype == "int8" and gb.spec.quant_int8
    elif path == "bf16x2":
        assert gb.hist_dtype == "bf16x2" and not gb.spec.quant
    else:
        assert gb.spec.rounds_slots == 0


@pytest.mark.parametrize("kind", ["subset", "nan"])
def test_exact_rounds_models_match_jax(kind):
    pins = {**PATHS["exact"], "tpu_growth_rounds": True}
    bj, bt, Xv, ev_j, ev_t = train_both(kind, pins=pins, rounds=3)
    assert_same_models(bj, bt, Xv, ev_j, ev_t)
    assert bt._gbdt.spec.rounds


@pytest.mark.parametrize("task", ["regression", "multiclass"])
def test_objective_models_match_jax(task):
    from test_torch_categorical import PINS

    bj, bt, Xv, ev_j, ev_t = train_both("subset", task, pins=PINS, rounds=3)
    assert_same_models(bj, bt, Xv, ev_j, ev_t)


def _cat_sets(tree):
    """Per categorical node (in node order): the set of left category
    values from the tree's bitsets."""
    bounds = [int(v) for v in tree.get("cat_boundaries", "0").split()]
    words = [int(v) for v in tree.get("cat_threshold", "").split()]
    sets = []
    for i in range(len(bounds) - 1):
        ws = words[bounds[i]:bounds[i + 1]]
        sets.append({32 * j + b for j, w in enumerate(ws) for b in range(32)
                     if (w >> b) & 1})
    return sets


@pytest.mark.parametrize("path,kind", MIRRORED)
def test_mirrored_categorical_ties(path, kind):
    """A categorical split and its mirror (the other side called left)
    have the same gain in exact arithmetic; the f32 rounding of the
    histogram sums (fixed point in the port, XLA's order and its
    fused multiply-adds in the JAX package) decides which one each
    package keeps. Every tree is the same function of the rows: same
    split features, gains within rtol 1e-5, node counts, leaf counts up
    to order, and per-row leaf values within 1e-5 on the training and
    validation rows; where the category sets differ they are disjoint
    (one package's left set is on the other's right)."""
    X, _, Xv_, _ = _cat_data(kind)
    bj, bt, Xv, ev_j, ev_t = train_both(kind, pins=PATHS[path], rounds=3)
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    mirrored = 0
    gbj, gbt = bj._gbdt, bt._gbdt
    for i, (a, b, mj, mt) in enumerate(zip(tj, tt, gbj.models, gbt.models)):
        for k in ("num_leaves", "num_cat", "split_feature", "decision_type",
                  "internal_count"):
            assert a[k] == b[k], k
        n = int(a["num_leaves"]) - 1
        np.testing.assert_allclose(
            gbt.device_trees[i].node_gain.numpy()[:n],
            np.asarray(gbj.device_trees[i][0].node_gain)[:n], rtol=1e-5)
        assert sorted(a["leaf_count"].split()) \
            == sorted(b["leaf_count"].split())
        for rows in (X, Xv):
            np.testing.assert_allclose(mt.predict(rows), mj.predict(rows),
                                       atol=1e-5)
        for sa, sb in zip(_cat_sets(a), _cat_sets(b)):
            if sa != sb:
                assert not sa & sb, (sa, sb)
                mirrored += 1
    assert mirrored > 0
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)
    for metric, vals in ev_j["v"].items():
        np.testing.assert_allclose(ev_t["v"][metric], vals, rtol=1e-4,
                                   atol=1e-6, err_msg=metric)
