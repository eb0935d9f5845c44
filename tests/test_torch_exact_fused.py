"""The fused loop on the exact grower (tpu_growth_mode=exact, with and
without tpu_growth_rounds) on the CPU.

The port's exact grower runs the JAX package's bounded loops: L - 1
split steps, each a no-op once the tree stops, after a round phase of a
bounded number of rounds, with every partition on the segment-capacity
ladder (learner/permuted.py). The fused step runs here with the graph's
bounded loops (DeviceLoop BOUNDED). Held, on binary, multiclass,
categorical, bagging, a forced plan, the per-node extras, monotone
intermediate and regression_l1, each with and without the round phase
(which boosting turns off beside a forced plan, the extras and monotone
intermediate, as the JAX package does):
- fused == eager bit for bit (model text and every score set);
- the trees equal the JAX package's fused exact path (its train() with
  no before-iteration callback), within tests/test_torch_exact.py's
  tolerances; a split that differs must be a tie that sends every
  training row reaching it the same way (ROADMAP C);
- a tree that outgrows the round phase's cap is grown again on the
  eager loop, counted, and the model keeps its bits;
- the eager loop's segment ladder gives the widest window's bits;
- fused_eligible() is True on exact, and every other refusal stands.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch import boosting
from lightgbm_tpu_torch.learner import device_loop, permuted
from test_torch_exact import F32_TOL
from test_torch_fused import _assert_bitwise, _assert_records_close, \
    _cat_data, _no_op
from test_torch_node_extras import FORCED, GROUPS, LAZY, assert_same_trees
from test_torch_train import _data
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

ROUNDS = 6
BIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "metric": "auc"}
MODES = {"exact": {"tpu_growth_mode": "exact", "verbosity": -1},
         "exact_rounds": {"tpu_growth_mode": "exact",
                          "tpu_growth_rounds": True, "verbosity": -1}}
# (params, task, the round phase runs when asked)
CASES = {
    "binary": (BIN, "binary", True),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "min_data_in_leaf": 10,
                    "metric": "multi_logloss"}, "multiclass", True),
    "categorical": ({**BIN, "max_cat_to_onehot": 4}, "cat", True),
    "bagging": ({**BIN, "bagging_fraction": 0.7, "bagging_freq": 2,
                 "feature_fraction": 0.7}, "binary", True),
    "forced": ({**BIN, "forcedsplits_filename": None}, "binary", False),
    "extras": ({**BIN, "extra_trees": True, "feature_fraction_bynode": 0.6,
                "cegb_penalty_split": 0.01,
                "cegb_penalty_feature_lazy": LAZY,
                "interaction_constraints": GROUPS}, "binary", False),
    "mono": ({**BIN, "monotone_constraints": [1, -1, 0, 1, 0, -1],
              "monotone_constraints_method": "intermediate"}, "binary",
             False),
    "l1": ({"objective": "regression_l1", "num_leaves": 15,
            "min_data_in_leaf": 5, "metric": "l1"}, "regression", True),
}
IDS = [f"{c}-{m}" for c in CASES for m in MODES]
# nodes whose threshold or default direction differ from the JAX
# package's while every training row reaching them goes the same way:
# the forced plan's tie (test_torch_node_extras' exact_forced) and
# intermediate's on this fixture (test_torch_monotone's EXACT_TIES)
TIES = {"forced": 1, "mono": 2}


@pytest.fixture(scope="module")
def forced_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "forced.json"
    path.write_text(json.dumps(FORCED))
    return str(path)


@pytest.fixture
def bounded(monkeypatch):
    """The fused step with the graph's bounded loops."""
    monkeypatch.setattr(boosting._FusedProgram, "cpu_loop",
                        device_loop.BOUNDED)


def _case(case, mode, forced_file):
    params, task, _ = CASES[case]
    params = dict(params)
    if "forcedsplits_filename" in params:
        params["forcedsplits_filename"] = forced_file
    data = _cat_data() if task == "cat" else _data(task)
    cat = [0, 1] if task == "cat" else None
    return {**params, **MODES[mode]}, data, cat


def _train(params, data, fused, cat=None, rounds=ROUNDS):
    X, y, Xv, yv = data
    p = {**params, "device_type": "cpu"}
    ds = lgb_t.Dataset(X, label=y, params=p,
                       categorical_feature=cat or "auto")
    vs = lgb_t.Dataset(Xv, label=yv, reference=ds)
    ev = {}
    cbs = [lgb_t.record_evaluation(ev)] + ([] if fused else [_no_op])
    b = lgb_t.train(p, ds, rounds, valid_sets=[ds, vs],
                    valid_names=["tr", "v"], callbacks=cbs)
    return b, ev


_PAIRS = {}


def _pair(case, mode, forced_file):
    """The eager and the fused (BOUNDED) model of a case, trained once."""
    if (case, mode) not in _PAIRS:
        params, data, cat = _case(case, mode, forced_file)
        be, ee = _train(params, data, False, cat)
        loop = boosting._FusedProgram.cpu_loop
        boosting._FusedProgram.cpu_loop = device_loop.BOUNDED
        try:
            bf, ef = _train(params, data, True, cat)
        finally:
            boosting._FusedProgram.cpu_loop = loop
        _PAIRS[(case, mode)] = (be, ee, bf, ef)
    return _PAIRS[(case, mode)]


@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in MODES],
                         ids=IDS)
def test_fused_matches_eager_bitwise(case, mode, forced_file):
    be, ee, bf, ef = _pair(case, mode, forced_file)
    gf = bf._gbdt
    assert gf._fused is not None and be._gbdt._fused is None
    assert gf.spec.rounds_slots == 0
    assert gf.spec.rounds == (mode == "exact_rounds" and CASES[case][2])
    _assert_bitwise(be, bf)
    _assert_records_close(ee, ef)
    assert gf.fused_overflow_count == 0
    f = gf._fused
    assert len(f.rounds) == bf.num_trees()
    assert (max(f.rounds) > 0) == gf.spec.rounds
    if case == "categorical":
        assert any("num_cat" in line and not line.endswith("=0")
                   for line in bf.model_to_string().splitlines())


_JAX = {}


def _jax_model(case, mode, forced_file):
    """The JAX package's fused loop (train() with no before-iteration
    callback) on the same data and parameters. The round phase is off
    in both packages beside a forced plan, the extras and monotone
    intermediate, so those cases share one model."""
    key = (case, mode if CASES[case][2] else "exact")
    if key not in _JAX:
        params, (X, y, _, _), cat = _case(case, mode, forced_file)
        kw = {"categorical_feature": cat} if cat else {}
        _JAX[key] = lgb_j.train(params, lgb_j.Dataset(X, label=y, **kw),
                                ROUNDS)
    return _JAX[key]


@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in MODES],
                         ids=IDS)
def test_trees_match_jax_fused(case, mode, forced_file):
    """The port's fused trees against the JAX package's fused exact path:
    the same splits, counts and children, leaf values within rtol / atol
    1e-5 and raw predictions on the training rows within 1e-5. A split
    that differs is one of the documented ties (TIES, ROADMAP C): the
    same feature, and every training row reaching it goes the same
    way."""
    _, _, bf, _ = _pair(case, mode, forced_file)
    bj = _jax_model(case, mode, forced_file)
    X = _case(case, mode, forced_file)[1][0]
    assert assert_same_trees(bj, bf, X) == TIES.get(case, 0)
    for a, b in zip(bj._gbdt.models, bf._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, **F32_TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_round_cap_overflow_reruns_on_eager_loop(bounded, monkeypatch,
                                                  mode, forced_file):
    """With the round phase's cap at 1 every tree that takes two rounds
    outgrows it: the iteration is grown again on the eager loop, and
    counted. Without the round phase nothing can overflow (the split
    steps are L - 1)."""
    monkeypatch.setattr(permuted, "round_phase_cap", lambda L: 1)
    params, data, _ = _case("binary", mode, forced_file)
    be, ee = _train(params, data, False)
    bf, ef = _train(params, data, True)
    _assert_bitwise(be, bf)
    _assert_records_close(ee, ef)
    n = bf._gbdt.fused_overflow_count
    assert n == (ROUNDS if mode == "exact_rounds" else 0)


def test_ladder_windows_give_the_widest_windows_bits(forced_file):
    """One tree grown with each partition at the smallest capacity that
    holds its segment (the eager loop, as the graph replays it) and at
    the widest (the bounded loop) gives the same bits; the fixture's 800
    rows (2048 padded) reach every capacity below the widest."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import BinnedDataset
    from lightgbm_tpu_torch.learner.grower import GrowerSpec, grow_tree, \
        make_split_params

    X, y, _, _ = _data("binary")
    cfg = Config({"min_data_in_leaf": 3})
    ds = BinnedDataset.from_numpy(X, cfg)
    d = ds.device_arrays("cpu")
    N = d["bins"].shape[1]
    assert permuted.segment_caps(N) == (2048, 1024, 512, 256, 128)
    rs = np.random.RandomState(1)
    g = torch.from_numpy(rs.randn(N).astype(np.float32)) * d["valid"]
    h = torch.full((N,), 0.25) * d["valid"]
    spec = GrowerSpec(num_leaves=63, num_bins=ds.max_num_bin, max_depth=-1,
                      rounds_slots=0,
                      efb=ds.bundle_layout is not None, col_bins=ds.col_bins,
                      quant_levels=0, quant=False)
    seen = []
    part = permuted._Grower.partition

    def spy(self, cap, *a):
        seen.append(cap)
        return part(self, cap, *a)

    outs = []
    for mode in (device_loop.EAGER, device_loop.BOUNDED):
        permuted._Grower.partition = spy
        try:
            outs.append(grow_tree(
                d["bins"], d["nan_bin"], d["num_bins"], d["mono"],
                d["is_cat"], g, h, d["valid"],
                torch.ones(X.shape[1], dtype=torch.bool),
                make_split_params(cfg), spec, valid=d["valid"],
                bundle=d["bundle"], loop=device_loop.DeviceLoop(mode)))
        finally:
            permuted._Grower.partition = part
        if mode == device_loop.EAGER:
            # 800 rows: the root's segment takes 1024, its leaves' the rest
            assert set(seen) == set(permuted.segment_caps(N)[1:])
            seen.clear()
    assert set(seen) == {N} and len(seen) == 62  # every bounded step
    (te, re_), (tb, rb) = outs
    assert int(te.num_nodes) > 40
    for a, b in zip(te, tb):
        assert torch.equal(a, b)
    assert torch.equal(re_, rb)


def test_exact_is_fused_eligible_and_other_refusals_stand():
    X, y, _, _ = _data("binary")

    def reason(extra, **ds_kw):
        p = {**BIN, **MODES["exact"], "device_type": "cpu", **extra}
        ds = lgb_t.Dataset(X, label=y, params=p, **ds_kw)
        return lgb_t.Booster(p, ds)._gbdt.fused_ineligible_reason()

    assert reason({}) is None
    assert reason({"tpu_growth_rounds": True}) is None
    assert "DART" in reason({"boosting": "dart"})
    assert "random forest" in reason({"boosting": "rf",
                                      "bagging_fraction": 0.7,
                                      "bagging_freq": 1})
    assert "linear_tree" in reason({"linear_tree": True})
    assert "coupled" in reason({"cegb_penalty_feature_coupled":
                                [1.0] * X.shape[1]})
    Xr = np.nan_to_num(X)
    yr = np.minimum(np.abs(Xr[:, 0] * 2).astype(int), 3).astype(float)
    pr = {"objective": "lambdarank", "num_leaves": 7, "device_type": "cpu",
          **MODES["exact"]}
    dr = lgb_t.Dataset(Xr, label=yr, group=[100] * 8, params=pr,
                       position=np.tile(np.arange(10), 80))
    assert "position" in lgb_t.Booster(pr, dr)._gbdt.fused_ineligible_reason()
