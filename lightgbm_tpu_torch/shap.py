"""Path-dependent TreeSHAP feature contributions (pred_contrib).

Implements the Lundberg & Lee consistent feature-attribution algorithm
over our host trees, matching the reference semantics
(src/io/tree.cpp:872-1043 Tree::TreeSHAP/ExtendPath/UnwindPath/
UnwoundPathSum/ExpectedValue, surfaced as Booster.predict(pred_contrib=
True)): output has num_features + 1 columns per model, the last column
being the tree-ensemble expected value, and rows sum to the raw score.

The node-weight convention is the reference's: cover fractions come
from training data counts (internal_count / leaf_count).

A copy of lightgbm_tpu/shap.py (host numpy, no torch): the oracle of the
device TreeSHAP in serving/forest.py contrib_apply.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .tree import Tree


def _expected_value(t: Tree) -> float:
    """Cover-weighted mean leaf output (tree.cpp:1035 ExpectedValue)."""
    if t.num_leaves == 1:
        return float(t.leaf_value[0])
    total = float(t.internal_count[0])
    if total <= 0:
        return float(np.mean(t.leaf_value))
    return float(np.dot(t.leaf_count / total, t.leaf_value))


class _Path:
    """The unique-feature path stack of the TreeSHAP recursion."""

    __slots__ = ("feature", "zero", "one", "pweight")

    def __init__(self, capacity: int):
        self.feature = np.zeros(capacity, np.int64)
        self.zero = np.zeros(capacity)
        self.one = np.zeros(capacity)
        self.pweight = np.zeros(capacity)

    def copy_from(self, other: "_Path", base: int, depth: int, off: int) -> None:
        sl = slice(base, base + depth + 1)
        dl = slice(off, off + depth + 1)
        self.feature[dl] = other.feature[sl]
        self.zero[dl] = other.zero[sl]
        self.one[dl] = other.one[sl]
        self.pweight[dl] = other.pweight[sl]


def _extend(p: _Path, base: int, depth: int, zero: float, one: float, feat: int) -> None:
    i = base + depth
    p.feature[i] = feat
    p.zero[i] = zero
    p.one[i] = one
    p.pweight[i] = 1.0 if depth == 0 else 0.0
    d1 = float(depth + 1)
    for j in range(depth - 1, -1, -1):
        p.pweight[base + j + 1] += one * p.pweight[base + j] * (j + 1) / d1
        p.pweight[base + j] = zero * p.pweight[base + j] * (depth - j) / d1


def _unwind(p: _Path, base: int, depth: int, idx: int) -> None:
    one = p.one[base + idx]
    zero = p.zero[base + idx]
    nxt = p.pweight[base + depth]
    d1 = float(depth + 1)
    for j in range(depth - 1, -1, -1):
        if one != 0:
            tmp = p.pweight[base + j]
            p.pweight[base + j] = nxt * d1 / ((j + 1) * one)
            nxt = tmp - p.pweight[base + j] * zero * (depth - j) / d1
        else:
            p.pweight[base + j] = p.pweight[base + j] * d1 / (zero * (depth - j))
    for j in range(idx, depth):
        p.feature[base + j] = p.feature[base + j + 1]
        p.zero[base + j] = p.zero[base + j + 1]
        p.one[base + j] = p.one[base + j + 1]


def _unwound_sum(p: _Path, base: int, depth: int, idx: int) -> float:
    one = p.one[base + idx]
    zero = p.zero[base + idx]
    nxt = p.pweight[base + depth]
    total = 0.0
    d1 = float(depth + 1)
    for j in range(depth - 1, -1, -1):
        if one != 0:
            tmp = nxt * d1 / ((j + 1) * one)
            total += tmp
            nxt = p.pweight[base + j] - tmp * zero * ((depth - j) / d1)
        else:
            total += (p.pweight[base + j] / zero) / ((depth - j) / d1)
    return total


def _tree_shap(
    t: Tree, x: np.ndarray, phi: np.ndarray, node: int, depth: int,
    path: _Path, parent_base: int, parent_zero: float, parent_one: float,
    parent_feat: int,
) -> None:
    # each call owns a fresh path segment starting past the parent's
    base = parent_base + depth
    if depth > 0:
        path.copy_from(path, parent_base, depth - 1, base)
    _extend(path, base, depth, parent_zero, parent_one, parent_feat)

    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, depth + 1):
            w = _unwound_sum(path, base, depth, i)
            phi[path.feature[base + i]] += (
                w * (path.one[base + i] - path.zero[base + i]) * t.leaf_value[leaf]
            )
        return

    hot = int(t.left_child[node]) if t.go_left(node, x) else int(t.right_child[node])
    cold = (
        int(t.right_child[node])
        if hot == int(t.left_child[node])
        else int(t.left_child[node])
    )

    def count(n: int) -> float:
        return float(t.internal_count[n]) if n >= 0 else float(t.leaf_count[~n])

    w = count(node)
    hot_zero = count(hot) / w
    cold_zero = count(cold) / w
    incoming_zero, incoming_one = 1.0, 1.0

    # if the feature was already on the path, undo its previous split
    feat = int(t.split_feature[node])
    path_idx = -1
    for i in range(1, depth + 1):
        if path.feature[base + i] == feat:
            path_idx = i
            break
    if path_idx >= 0:
        incoming_zero = path.zero[base + path_idx]
        incoming_one = path.one[base + path_idx]
        _unwind(path, base, depth, path_idx)
        depth -= 1

    _tree_shap(t, x, phi, hot, depth + 1, path, base,
               hot_zero * incoming_zero, incoming_one, feat)
    _tree_shap(t, x, phi, cold, depth + 1, path, base,
               cold_zero * incoming_zero, 0.0, feat)


def tree_contrib(t: Tree, x: np.ndarray, phi: np.ndarray,
                 path: "_Path" = None, expected: float = None) -> None:
    """Add one tree's SHAP contributions for row x into phi (F+1,).

    path/expected can be precomputed once per tree (see predict_contrib)
    and reused across rows; the recursion fully overwrites the segments
    it reads, so the buffer needs no re-zeroing.
    """
    phi[-1] += _expected_value(t) if expected is None else expected
    if t.num_leaves == 1:
        return
    if path is None:
        maxd = t.max_depth() + 2
        path = _Path((maxd + 2) * (maxd + 3))
    _tree_shap(t, x, phi, 0, 0, path, 0, 1.0, 1.0, -1)


def predict_contrib(
    models: Sequence[Tree],
    X: np.ndarray,
    num_features: int,
    num_class: int = 1,
    start_iteration: int = 0,
    num_iteration: int = -1,
    average_output: bool = False,
) -> np.ndarray:
    """SHAP contributions for every row: (N, num_class*(num_features+1)).

    Mirrors Booster.predict(pred_contrib=True) layout: per class, F
    feature columns then the expected-value bias column.
    """
    X = np.asarray(X, dtype=np.float64)
    N = X.shape[0]
    K = num_class
    n_iters = len(models) // K
    end = n_iters if num_iteration <= 0 else min(n_iters, start_iteration + num_iteration)
    out = np.zeros((N, K, num_features + 1))
    for it in range(start_iteration, end):
        for k in range(K):
            t = models[it * K + k]
            expected = _expected_value(t)
            maxd = t.max_depth() + 2
            path = _Path((maxd + 2) * (maxd + 3))
            for r in range(N):
                tree_contrib(t, X[r], out[r, k], path, expected)
    if average_output and end > start_iteration:
        out /= end - start_iteration
    return out.reshape(N, K * (num_features + 1))
