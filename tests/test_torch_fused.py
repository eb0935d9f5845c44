"""The fused loop of lightgbm_tpu_torch (boosting._FusedProgram, engine's
fused branch) on the CPU, mirroring tests/test_chunk_scan.py.

train() with no fobj, feval or before-iteration callback takes the fused
loop; a no-op before-iteration callback keeps it on the eager loop. The
fused step runs here with bounded loops (DeviceLoop BOUNDED: every round
and traversal level up to its cap, no host read), which is what the CUDA
graph replays on the card, except that the graph skips the idle steps.
Held:
- fused == eager bit for bit (model text and every score set) on
  regression, binary with bagging and feature_fraction, GOSS,
  multiclass, use_quantized_grad, regression_l1 and categorical data,
  and on the CPU's default loop mode too;
- early stopping that fires inside a chunk truncates to the eager loop's
  model and best_iteration; the no-splittable-leaf stop matches;
- a tree that outgrows the round cap (forced small) is grown again on
  the eager loop, counted, and the model keeps its bits;
- port fused against the JAX package's fused loop (its default): the
  same trees, eval records within 1e-6;
- the step reads nothing back: a dispatch mode that refuses
  aten._local_scalar_dense and cross-device copies while it runs, and no
  .item() / .tolist() in the step's code.
"""

import ast
import inspect
import re
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch import boosting, device_metrics, rng, sample_strategy
from lightgbm_tpu_torch.learner import device_loop, permuted, quantize, \
    ranking, renewal, rounds, split
from lightgbm_tpu_torch.tree import traverse_tree_bins
from test_torch_train import _STRUCT, _data, _trees
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}


@pytest.fixture
def bounded(monkeypatch):
    """The fused step with the graph's bounded loops."""
    monkeypatch.setattr(boosting._FusedProgram, "cpu_loop",
                        device_loop.BOUNDED)


def _no_op(env):
    """Keeps train() on the eager loop."""


_no_op.before_iteration = True


def _train(params, data, rounds_, fused, cat=None, **kw):
    X, y, Xv, yv = data
    p = {**PINS, **params, "device_type": "cpu"}
    ds = lgb_t.Dataset(X, label=y, params=p,
                       categorical_feature=cat or "auto")
    vs = lgb_t.Dataset(Xv, label=yv, reference=ds)
    ev = {}
    cbs = [lgb_t.record_evaluation(ev)] + ([] if fused else [_no_op])
    b = lgb_t.train(p, ds, rounds_, valid_sets=[ds, vs],
                    valid_names=["tr", "v"], callbacks=cbs, **kw)
    return b, ev


def _assert_bitwise(be, bf):
    assert be.model_to_string() == bf.model_to_string()
    ge, gf = be._gbdt, bf._gbdt
    for a, b in zip([ge.train] + ge.valids, [gf.train] + gf.valids):
        assert torch.equal(a.score, b.score)


def _assert_records_close(ee, ef, rtol=1e-5):
    assert ee.keys() == ef.keys()
    for d in ee:
        assert ee[d].keys() == ef[d].keys()
        for m in ee[d]:
            np.testing.assert_allclose(ef[d][m], ee[d][m], rtol=rtol,
                                       atol=1e-7, err_msg=f"{d} {m}")


def _cat_data(n=800, nv=200, seed=5):
    rs = np.random.RandomState(seed)
    X = rs.randn(n + nv, 4)
    X[:, 0] = rs.randint(0, 12, n + nv)
    X[:, 1] = rs.randint(0, 3, n + nv)
    z = X[:, 2] + np.isin(X[:, 0], [1, 4, 7, 9]) - 0.5 * (X[:, 1] == 2)
    y = (z + 0.3 * rs.randn(n + nv) > 0.4).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


FUSED_CASES = {
    "regression": ({"objective": "regression", "num_leaves": 15,
                    "min_data_in_leaf": 5, "metric": "l2"}, "regression"),
    "binary_bagging_ff": ({"objective": "binary", "num_leaves": 15,
                           "min_data_in_leaf": 5, "metric": "auc",
                           "bagging_fraction": 0.7, "bagging_freq": 2,
                           "feature_fraction": 0.7}, "binary"),
    "goss": ({"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
              "metric": "binary_logloss", "data_sample_strategy": "goss",
              "learning_rate": 0.3}, "binary"),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "min_data_in_leaf": 10,
                    "metric": ["multi_logloss", "multi_error"]},
                   "multiclass"),
    "quantized": ({"objective": "binary", "num_leaves": 15,
                   "min_data_in_leaf": 5, "metric": "auc",
                   "use_quantized_grad": True,
                   "quant_train_renew_leaf": True}, "binary"),
    "regression_l1": ({"objective": "regression_l1", "num_leaves": 15,
                       "min_data_in_leaf": 5, "metric": "l1"},
                      "regression"),
    "categorical": ({"objective": "binary", "num_leaves": 15,
                     "min_data_in_leaf": 5, "metric": "auc",
                     "max_cat_to_onehot": 4}, "cat"),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_matches_eager_bitwise(bounded, case):
    params, task = FUSED_CASES[case]
    data = _cat_data() if task == "cat" else _data(task)
    cat = [0, 1] if task == "cat" else None
    be, ee = _train(params, data, 6, fused=False, cat=cat)
    bf, ef = _train(params, data, 6, fused=True, cat=cat)
    assert bf._gbdt._fused is not None and be._gbdt._fused is None
    _assert_bitwise(be, bf)
    _assert_records_close(ee, ef)
    assert bf._gbdt.fused_overflow_count == 0
    if task == "cat":
        assert bf._gbdt.spec.cat_subset and any(
            int(t.get("num_cat", 0)) > 0
            for t in _trees(bf.model_to_string()))


def test_fused_default_cpu_loop_matches_eager():
    """The CPU's own loop mode (host reads, no bounded steps)."""
    params, task = FUSED_CASES["binary_bagging_ff"]
    be, _ = _train(params, _data(task), 5, fused=False)
    bf, _ = _train(params, _data(task), 5, fused=True)
    _assert_bitwise(be, bf)


def test_early_stop_mid_chunk_truncates_exactly(bounded):
    """lr 1 on 800 rows: the validation logloss bottoms out after a few
    trees, so early stopping fires long before the 64-iteration chunk
    ends; fused_truncate leaves the eager loop's model."""
    params = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 3,
              "learning_rate": 1.0, "metric": "binary_logloss",
              "early_stopping_round": 2}
    data = _data("binary")
    be, ee = _train(params, data, 20, fused=False)
    bf, ef = _train(params, data, 20, fused=True)
    assert bf.best_iteration == be.best_iteration >= 1
    assert bf.num_trees() == be.num_trees() == be.best_iteration + 2
    assert bf.num_trees() < 20
    assert be.model_to_string() == bf.model_to_string()
    _assert_records_close(ee, ef)


def test_no_splittable_leaf_stop_matches(bounded):
    rs = np.random.RandomState(1)
    X = rs.randn(260, 4)
    y = X[:, 0] + 0.1 * rs.randn(260)
    data = (X[:200], y[:200], X[200:], y[200:])
    params = {"objective": "regression", "num_leaves": 7,
              "min_data_in_leaf": 120}
    be, _ = _train(params, data, 8, fused=False)
    bf, _ = _train(params, data, 8, fused=True)
    assert be.num_trees() == bf.num_trees() == 1  # the kept bias tree
    assert be.model_to_string() == bf.model_to_string()
    assert bf._gbdt._stopped


def test_round_cap_overflow_reruns_on_eager_loop(bounded, monkeypatch):
    """With the cap at 2 rounds every 31-leaf tree outgrows it: each
    iteration is grown again on the eager loop, and counted."""
    monkeypatch.setattr(rounds, "round_cap", lambda L, S: 2)
    params = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5,
              "metric": "auc"}
    data = _data("binary")
    be, ee = _train(params, data, 4, fused=False)
    bf, ef = _train(params, data, 4, fused=True)
    assert bf._gbdt.fused_overflow_count == 4
    _assert_bitwise(be, bf)
    _assert_records_close(ee, ef)


JAX_CASES = {
    "binary": ({"objective": "binary", "num_leaves": 15,
                "min_data_in_leaf": 5, "metric": ["auc", "binary_logloss"]},
               6),
    "regression": ({"objective": "regression", "num_leaves": 15,
                    "min_data_in_leaf": 5, "metric": ["l2", "l1"],
                    "bagging_fraction": 0.8, "bagging_freq": 1}, 5),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "min_data_in_leaf": 10,
                    "metric": "multi_logloss"}, 4),
}


@pytest.mark.parametrize("task", list(JAX_CASES))
def test_fused_matches_jax_fused(bounded, task):
    """Both packages on their default (fused) loops: the same tree
    structure, leaf values within rtol 1e-5, and the device metrics of
    both within 1e-6."""
    params, n = JAX_CASES[task]
    X, y, Xv, yv = _data(task)
    pj = {**params, **PINS}
    ev_j = {}
    dj = lgb_j.Dataset(X, label=y)
    bj = lgb_j.train(pj, dj, n, valid_sets=[lgb_j.Dataset(Xv, label=yv,
                                                          reference=dj)],
                     valid_names=["v"],
                     callbacks=[lgb_j.record_evaluation(ev_j)])
    pt = {**pj, "device_type": "cpu"}
    dt = lgb_t.Dataset(X, label=y, params=pt)
    ev_t = {}
    bt = lgb_t.train(pt, dt, n, valid_sets=[lgb_t.Dataset(Xv, label=yv,
                                                          reference=dt)],
                     valid_names=["v"], evals_result=ev_t)
    assert bt._gbdt._fused is not None
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tj) == len(tt) > 0
    for a, b in zip(tj, tt):
        for k in _STRUCT:
            assert a.get(k) == b.get(k), k
        np.testing.assert_allclose(np.array(b["leaf_value"].split(), float),
                                   np.array(a["leaf_value"].split(), float),
                                   rtol=1e-5, atol=1e-7)
    assert ev_j.keys() == ev_t.keys()
    for m in ev_j["v"]:
        np.testing.assert_allclose(ev_t["v"][m], ev_j["v"][m], rtol=1e-6,
                                   atol=1e-7, err_msg=m)


# host data made a tensor (torch.tensor, x[i] = 3): a copy from the host
# on the card; a boolean mask's nonzero: a read back
_HOST_OPS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.lift_fresh.default,
             torch.ops.aten.nonzero.default)


class _NoReadBack(TorchDispatchMode):
    """Refuses a read of a tensor's value on the host, host data turned
    into a tensor, a boolean mask's nonzero, and a copy between
    devices."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_OPS:
            raise AssertionError(f"host read in the step: {func}")
        if func in (torch.ops.aten.index.Tensor,
                    torch.ops.aten.index_put_.default) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            raise AssertionError(f"boolean mask in the step: {func}")
        if func in (torch.ops.aten._to_copy.default,
                    torch.ops.aten.copy_.default):
            src = args[1] if func is torch.ops.aten.copy_.default else \
                args[0]
            dst = (args[0].device if func is torch.ops.aten.copy_.default
                   else kwargs.get("device") or src.device)
            if isinstance(src, torch.Tensor) and \
                    torch.device(dst) != src.device:
                raise AssertionError(f"copy {src.device} -> {dst}")
        return func(*args, **kwargs)


def test_step_reads_nothing_back(bounded, monkeypatch):
    """Every fused step (gradients, sampling, quantization, the rounds
    and the exact grower, renewal, score updates, traversal, device
    metrics, the ring write) under a mode that refuses host reads and
    cross-device copies, with bagging, GOSS-free quantized levels, the
    l1 refit, the exact grower's round phase and its per-node extras."""
    step = boosting._FusedProgram.step
    calls = []

    def guarded(self, loop):
        calls.append(loop.mode)
        with _NoReadBack():
            step(self, loop)

    monkeypatch.setattr(boosting._FusedProgram, "step", guarded)
    exact = {"tpu_growth_mode": "exact"}
    for params, task in (FUSED_CASES["binary_bagging_ff"],
                         FUSED_CASES["regression_l1"],
                         FUSED_CASES["quantized"],
                         # the exact grower: its split steps on the
                         # segment ladder, its round phase, the extras
                         ({**FUSED_CASES["binary_bagging_ff"][0], **exact},
                          "binary"),
                         ({**FUSED_CASES["regression_l1"][0], **exact,
                           "tpu_growth_rounds": True}, "regression"),
                         ({**FUSED_CASES["regression"][0], **exact,
                           "extra_trees": True,
                           "feature_fraction_bynode": 0.5}, "regression")):
        _train(params, _data(task), 3, fused=True)
    assert calls and set(calls) == {device_loop.BOUNDED}
    # the guard is live: the eager loop reads its predicate
    with pytest.raises(AssertionError, match="host read"):
        with _NoReadBack():
            device_loop.DeviceLoop().cond(torch.ones((), dtype=bool),
                                          lambda: None)


def _source(obj) -> str:
    return textwrap.dedent(inspect.getsource(obj))


STEP_CODE = [
    boosting.GBDT._iteration, boosting.GBDT._gradients,
    boosting.GBDT._sample_features, boosting.GBDT._quantize,
    boosting.GBDT._grow_maybe_quantized, boosting.GBDT._apply_renewal,
    boosting.GBDT._renew_true, boosting._FusedProgram.step,
    boosting._FusedProgram._body, boosting._FusedProgram._pack,
    rounds.grow_tree_rounds, permuted.grow_tree_permuted, permuted._Grower,
    traverse_tree_bins, split, rng,
    sample_strategy, quantize, renewal, device_metrics, ranking,
]


@pytest.mark.parametrize("code", STEP_CODE,
                         ids=lambda c: getattr(c, "__qualname__",
                                               getattr(c, "__name__", "")))
def test_step_code_has_no_host_reads(code):
    """.tolist() and .item() bypass the dispatch guard above: none in
    the step's code (functions, and whole modules the step calls)."""
    src = _source(code)
    ast.parse(src)
    assert not re.search(r"\.(tolist|item)\(", src), code
