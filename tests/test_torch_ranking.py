"""Learning to rank in lightgbm_tpu_torch against lightgbm_tpu on the same
seeded numpy inputs, JAX on the CPU (tiny: <= 1k rows, <= 8 trees).

- the query layout, label gains and inverse max DCGs: exact;
- the plain lambdas (learner/ranking.lambdarank_gradients) against the
  JAX package's, norm on and off, truncation 3 and 30, on groups of 7, 3,
  12, 1 and 5 documents with random, equal and tied scores and tied
  labels: within rtol 1e-5, atol 1e-7 (f32 sums in another order);
- RankXENDCG's uniforms bit for bit, its gradients within rtol 1e-5;
- ndcg@k and map@k, host (the same numpy) and device (f32 sorts, f64
  means): the device values within 1e-6 of the JAX package's;
- bagging_by_query's masks bit for bit, and its row-bagging fallbacks;
- lambdarank (norm on and off, weights, positions) and rank_xendcg
  trained on the pinned int16 rounds path: the same trees, raw
  predictions within 1e-5, eval records within 1e-6; the position biases
  within 1e-6; the port's fused loop bit for bit equal to its eager loop;
- the port's model text read back by the JAX package; a missing group or
  groups that do not sum to the rows fail as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu import device_metrics as dm_j
from lightgbm_tpu import sample_strategy as ss_j
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.learner import ranking as rk_j
from lightgbm_tpu.metrics import create_metrics as metrics_j
from lightgbm_tpu_torch import device_metrics as dm_t
from lightgbm_tpu_torch import rng
from lightgbm_tpu_torch import sample_strategy as ss_t
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.learner import ranking as rk_t
from lightgbm_tpu_torch.metrics import create_metrics as metrics_t
from test_torch_callbacks import _per_iteration
from test_torch_fused import _NoReadBack, _assert_bitwise, \
    _assert_records_close, _no_op, bounded  # noqa: F401  (a fixture)
from test_torch_sampling import assert_same_sampled_models
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
GROUP = np.asarray([7, 3, 12, 1, 5])


def test_one_torch_thread_per_worker():
    """The port's tests run with one torch thread (tests/_port_threads)."""
    assert torch.get_num_threads() == 1


def _rank_data(n_q=40, nv_q=12, f=5, seed=3, max_docs=30):
    """Queries of 1..max_docs documents, labels 0-4 skewed toward 0 and
    tied to the first two features, a few missing values."""
    rs = np.random.RandomState(seed)
    g = rs.randint(1, max_docs, n_q)
    gv = rs.randint(1, max_docs, nv_q)
    n, nv = int(g.sum()), int(gv.sum())
    X = rs.randn(n + nv, f)
    X[rs.rand(n + nv, f) < 0.03] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
    y = np.clip(np.floor(z + 0.7 * rs.randn(n + nv)), 0, 4)
    return X[:n], y[:n], g, X[n:], y[n:], gv


def test_query_layout_gains_and_max_dcg_exact():
    npad = 32
    lj, lt = rk_j.build_query_layout(GROUP, npad), \
        rk_t.build_query_layout(GROUP, npad)
    np.testing.assert_array_equal(lt.qdoc, lj.qdoc)
    np.testing.assert_array_equal(lt.qvalid, lj.qvalid)
    assert (lt.num_queries, lt.max_docs, lt.npad) == \
        (lj.num_queries, lj.max_docs, lj.npad)
    assert rk_t.build_query_layout(GROUP, npad) is lt  # cached
    np.testing.assert_array_equal(rk_t.default_label_gain(4),
                                  rk_j.default_label_gain(4))
    rs = np.random.RandomState(0)
    label = rs.randint(0, 4, 28).astype(np.float32)
    gain = rk_j.default_label_gain(3)
    for k in (1, 3, 30):
        np.testing.assert_array_equal(
            rk_t.inverse_max_dcg(label, lt, gain, k),
            rk_j.inverse_max_dcg(label, lj, gain, k))


def _scores(kind, n, rs):
    if kind == "equal":  # iteration 0: every score 0
        return np.zeros(n, np.float32)
    s = rs.randn(n).astype(np.float32)
    if kind == "ties":
        s = np.round(s, 0).astype(np.float32)
    return s


@pytest.mark.parametrize("kind", ["random", "equal", "ties"])
@pytest.mark.parametrize("trunc", [3, 30])
@pytest.mark.parametrize("norm", [True, False])
def test_plain_lambdas_match_jax(norm, trunc, kind):
    rs = np.random.RandomState(1)
    n, npad = int(GROUP.sum()), 32
    label = np.zeros(npad, np.float32)
    label[:n] = rs.randint(0, 3, n)  # 3 levels over 28 rows: label ties
    score = np.zeros(npad, np.float32)
    score[:n] = _scores(kind, n, rs)
    gain = rk_j.default_label_gain(2)
    lj = rk_j.build_query_layout(GROUP, npad)
    lt = rk_t.build_query_layout(GROUP, npad)
    imd = rk_j.inverse_max_dcg(label, lj, gain, trunc)
    gj, hj = rk_j.lambdarank_gradients(
        lj, jnp.asarray(score), jnp.asarray(label), jnp.asarray(
            gain, jnp.float32), jnp.asarray(imd, jnp.float32), 1.0, trunc,
        norm)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    gt, ht = rk_t.lambdarank_gradients(lt, f32(score), f32(label), f32(gain),
                                       f32(imd), 1.0, trunc, norm)
    assert np.abs(np.asarray(gj)).max() > 0
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-7)
    # the dispatcher's plain route adds the weights and the floor
    w = rs.rand(npad).astype(np.float32)
    gp, hp = rk_t.lambdarank(lt, f32(score), f32(label), f32(gain),
                             f32(imd), 1.0, trunc, norm, f32(w))
    np.testing.assert_array_equal(gp.numpy(), (gt * f32(w)).numpy())
    np.testing.assert_array_equal(
        hp.numpy(), np.maximum((ht * f32(w)).numpy(), np.float32(2e-7)))


def test_plain_lambdas_chunks_are_one_function(monkeypatch):
    """Chunks of one query each give the same values as one chunk."""
    rs = np.random.RandomState(2)
    g = rs.randint(1, 40, 25)
    n = int(g.sum())
    npad = n + 7
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    label = f32(np.r_[rs.randint(0, 5, n), np.zeros(7)])
    score = f32(np.r_[rs.randn(n), np.zeros(7)])
    gain = rk_t.default_label_gain(4)
    out = []
    for budget in (1 << 30, 1):
        monkeypatch.setattr(rk_t, "_CHUNK_BYTES", budget)
        lay = rk_t.QueryLayout(g, npad)
        imd = rk_t.inverse_max_dcg(label.numpy(), lay, gain, 30)
        out.append(rk_t.lambdarank_gradients(lay, score, label, f32(gain),
                                             f32(imd), 1.0, 30, True))
        assert len(lay.chunks("cpu", 30)) == (1 if budget > 1 else 25)
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8)


def _objective_pair(params, X, y, g):
    """The JAX package's and the port's objective, initialized on the
    same dataset."""
    bj = lgb_j.Booster({**params, **PINS}, lgb_j.Dataset(X, label=y,
                                                         group=g))
    pt = {**params, **PINS, "device_type": "cpu"}
    bt = lgb_t.Booster(pt, lgb_t.Dataset(X, label=y, group=g, params=pt))
    return bj._gbdt, bt._gbdt


@pytest.mark.parametrize("it", [0, 3])
def test_xendcg_draws_and_gradients(it):
    X, y, g, *_ = _rank_data()
    gbj, gbt = _objective_pair({"objective": "rank_xendcg"}, X, y, g)
    lay = rk_t.build_query_layout(g, gbt.train_set.num_rows_padded())
    seed = gbt.config.objective_seed
    uj = jax.random.uniform(jax.random.fold_in(jax.random.key(seed), it),
                            lay.qvalid.shape)
    ut = rng.uniform(rng.fold_in(rng.key(seed), it), lay.qvalid.shape)
    np.testing.assert_array_equal(ut.numpy().view(np.int32),
                                  np.asarray(uj).view(np.int32))
    rs = np.random.RandomState(it)
    score = rs.randn(gbt.train_set.num_rows_padded()).astype(np.float32)
    gj, hj = gbj.objective.get_gradients(jnp.asarray(score), it)
    gt, ht = gbt.objective.get_gradients(torch.from_numpy(score), it)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metrics_host_and_device(name):
    rs = np.random.RandomState(5)
    g = rs.randint(1, 25, 30)
    n = int(g.sum())
    y = np.clip(rs.randint(-2, 5, n), 0, 4).astype(np.float32)
    score = rs.randn(n)
    score[:60] = np.round(score[:60], 0)  # tied scores
    params = {"objective": "lambdarank", "metric": name,
              "eval_at": [1, 3, 5, 10]}
    mj, mt = metrics_j(ConfigJ(params)), metrics_t(ConfigT(params))
    for m in (mj[0], mt[0]):
        m.init(y, None, g)
    assert mt[0].eval(score) == mj[0].eval(score)
    names, hb = dm_t.supported_names(mt)
    assert names == [f"{name}@{k}" for k in (1, 3, 5, 10)] and all(hb)
    npad = n + 9
    lab = np.zeros(npad, np.float32)
    lab[:n] = y
    valid = (np.arange(npad) < n).astype(np.float32)
    sp = np.zeros((1, npad), np.float32)
    sp[0, :n] = score
    ej = dm_j.DeviceEvalSet(
        ConfigJ(params), names, hb, jnp.asarray(lab), None,
        jnp.asarray(valid), 1, group=g)
    et = dm_t.DeviceEvalSet(ConfigT(params), names, hb,
                            torch.from_numpy(lab), None,
                            torch.from_numpy(valid), 1, g)
    vj, vt = np.asarray(ej(jnp.asarray(sp))), et(torch.from_numpy(sp))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-6)
    host = [v for _n, v, _h in mt[0].eval(score)]
    np.testing.assert_allclose(vt.numpy(), host, rtol=0, atol=1e-6)
    # without groups the metric has no device form
    mt[0].init(y, None, None)
    assert dm_t.supported_names(mt) is None


@pytest.mark.parametrize("it", [0, 1, 4])
def test_bagging_by_query_masks_bitwise(it):
    rs = np.random.RandomState(9)
    g = rs.randint(1, 20, 37)
    n = int(g.sum())
    npad = n + 11
    params = {"bagging_fraction": 0.6, "bagging_freq": 2,
              "bagging_by_query": True, "bagging_seed": 4}
    sj = ss_j.BaggingStrategy(ConfigJ(params), n, group=g)
    st = ss_t.BaggingStrategy(ConfigT(params), g)
    valid = (np.arange(npad) < n).astype(np.float32)
    zeros = np.zeros(npad, np.float32)
    mj = np.asarray(sj.sample(it, jnp.asarray(zeros), jnp.asarray(zeros),
                              jnp.asarray(valid), None)[0])
    z = torch.from_numpy(zeros)
    mt = st.sample(it, z, z, torch.from_numpy(valid), None)[0]
    np.testing.assert_array_equal(mt.numpy(), mj)
    # the device counter draws the same bag
    md = st.sample(torch.tensor(it), z, z, torch.from_numpy(valid), None)[0]
    np.testing.assert_array_equal(md.numpy(), mj)
    # whole queries, exactly round(0.6 * Q) of them
    qb = np.r_[0, np.cumsum(g)]
    per_q = [mj[qb[q]:qb[q + 1]] for q in range(len(g))]
    assert all(p.min() == p.max() for p in per_q)
    assert sum(p[0] for p in per_q) == round(0.6 * len(g))


@pytest.mark.parametrize("extra,msg", [
    ({}, "requires query groups"),
    ({"pos_bagging_fraction": 0.5}, "ignores pos/neg"),
])
def test_bagging_by_query_falls_back_to_rows(capsys, extra, msg):
    params = {"bagging_fraction": 0.6, "bagging_freq": 1,
              "bagging_by_query": True, **extra}
    group = None if not extra else np.asarray([3, 4])
    st = ss_t.BaggingStrategy(ConfigT(params), group)
    assert not st.by_query
    assert msg in capsys.readouterr().err


def _train_pair(params, data, rounds, weighted=False, positions=False):
    """Both packages on the same data; the JAX package on its
    per-iteration loop (host metrics, as the port's eager records), the
    port on its default loop."""
    X, y, g, Xv, yv, gv = data
    rs = np.random.RandomState(11)
    w = rs.rand(len(y)) + 0.5 if weighted else None
    pos = rs.randint(0, 6, len(y)) if positions else None
    out = {}
    for lgb in (lgb_j, lgb_t):
        p = {**params, **PINS}
        if lgb is lgb_t:
            p["device_type"] = "cpu"
        ds = lgb.Dataset(X, label=y, group=g, weight=w, position=pos,
                         params=p if lgb is lgb_t else None)
        vs = lgb.Dataset(Xv, label=yv, group=gv, reference=ds)
        ev = {}
        cbs = [lgb.record_evaluation(ev)]
        if lgb is lgb_j:
            cbs.append(_per_iteration)
        b = lgb.train(p, ds, rounds, valid_sets=[vs], valid_names=["v"],
                      callbacks=cbs)
        out[lgb] = (b, ev)
    return out[lgb_j], out[lgb_t]


TRAIN_CASES = {
    "lambdarank": {"objective": "lambdarank"},
    "lambdarank_no_norm": {"objective": "lambdarank",
                           "lambdarank_norm": False,
                           "lambdarank_truncation_level": 5},
    "lambdarank_weighted": {"objective": "lambdarank", "metric": "map"},
    "rank_xendcg": {"objective": "rank_xendcg"},
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_ranker_trains_as_jax(case):
    params = {**TRAIN_CASES[case], "num_leaves": 7, "min_data_in_leaf": 5,
              "eval_at": [1, 3, 5]}
    data = _rank_data()
    (bj, ej), (bt, et) = _train_pair(params, data, 6,
                                     weighted=case.endswith("weighted"))
    assert bt._gbdt.objective.name == bj._gbdt.objective.name
    assert bt._gbdt._fused is not None  # the default loop is the fused one
    assert assert_same_sampled_models(bj, bt, data[0], data[3]) is None
    assert ej.keys() == et.keys() and len(et["v"]) == 3
    for m in ej["v"]:
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=0,
                                   atol=1e-6, err_msg=m)
    # predict returns the raw score (convert_output is the identity)
    np.testing.assert_array_equal(bt.predict(data[3]),
                                  bt.predict(data[3], raw_score=True))


def test_position_debiasing_as_jax():
    params = {"objective": "lambdarank", "num_leaves": 7,
              "min_data_in_leaf": 5, "eval_at": [3],
              "lambdarank_position_bias_regularization": 0.1}
    data = _rank_data()
    (bj, _ej), (bt, _et) = _train_pair(params, data, 5, positions=True)
    gb = bt._gbdt
    assert gb.objective.has_host_state and gb._fused is None
    assert "position debiasing" in gb.fused_ineligible_reason()
    assert assert_same_sampled_models(bj, bt, data[0], data[3]) is None
    pj = np.asarray(bj._gbdt.objective.position_biases)
    pt = gb.objective.position_biases.numpy()
    assert pt.shape == (6,) and np.abs(pt).max() > 0
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


RANK_FUSED = {
    "lambdarank": {"objective": "lambdarank", "metric": ["ndcg", "map"],
                   "bagging_fraction": 0.7, "bagging_freq": 1,
                   "bagging_by_query": True},
    "rank_xendcg": {"objective": "rank_xendcg"},
}


@pytest.mark.parametrize("case", list(RANK_FUSED))
def test_rank_fused_matches_eager_bitwise(bounded, case):  # noqa: F811
    X, y, g, Xv, yv, gv = _rank_data()
    p = {**PINS, **RANK_FUSED[case], "num_leaves": 7, "min_data_in_leaf": 5,
         "eval_at": [1, 3], "device_type": "cpu"}
    res = []
    for fused in (False, True):
        ds = lgb_t.Dataset(X, label=y, group=g, params=p)
        vs = lgb_t.Dataset(Xv, label=yv, group=gv, reference=ds)
        ev = {}
        cbs = [lgb_t.record_evaluation(ev)] + ([] if fused else [_no_op])
        b = lgb_t.train(p, ds, 5, valid_sets=[ds, vs],
                        valid_names=["tr", "v"], callbacks=cbs)
        assert (b._gbdt._fused is not None) == fused
        res.append((b, ev))
    (be, ee), (bf, ef) = res
    _assert_bitwise(be, bf)
    _assert_records_close(ee, ef)


@pytest.mark.parametrize("case", list(RANK_FUSED))
def test_rank_step_reads_nothing_back(bounded, monkeypatch,  # noqa: F811
                                      case):
    """The ranking step (lambdas or XE-NDCG draws, query bagging, ndcg /
    map on the device) reads nothing back, as a CUDA graph needs."""
    from lightgbm_tpu_torch import boosting

    step = boosting._FusedProgram.step
    calls = []

    def guarded(self, loop):
        calls.append(loop.mode)
        with _NoReadBack():
            step(self, loop)

    monkeypatch.setattr(boosting._FusedProgram, "step", guarded)
    X, y, g, Xv, yv, gv = _rank_data()
    p = {**PINS, **RANK_FUSED[case], "num_leaves": 7, "min_data_in_leaf": 5,
         "eval_at": [1, 3], "device_type": "cpu"}
    ds = lgb_t.Dataset(X, label=y, group=g, params=p)
    # the first iteration builds the plain lambdas' chunk tensors; the
    # card's fused loop runs its first iteration uncaptured too
    b = lgb_t.Booster(p, ds)
    b.add_valid(lgb_t.Dataset(Xv, label=yv, group=gv, reference=ds), "v")
    b._gbdt._gradients(0)
    b._gbdt.fused_start(track_train=False)
    b._gbdt.fused_dispatch(3)
    assert len(b._gbdt.fused_collect()) == 3
    assert calls == ["bounded"] * 3


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_model_text_read_by_jax(objective):
    data = _rank_data()
    params = {"objective": objective, "num_leaves": 7,
              "min_data_in_leaf": 5, **PINS, "device_type": "cpu"}
    X, y, g, Xv = data[:4]
    bt = lgb_t.train(params, lgb_t.Dataset(X, label=y, group=g,
                                           params=params), 4)
    text = bt.model_to_string()
    assert f"objective={objective}\n" in text
    bj = lgb_j.Booster(model_str=text)
    np.testing.assert_allclose(bj.predict(Xv), bt.predict(Xv), atol=1e-6)
    back = lgb_t.Booster(model_str=text)
    np.testing.assert_array_equal(back.predict(Xv), bt.predict(Xv))


@pytest.mark.parametrize("fault", ["missing", "bad_sum"])
@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_group_faults_fail_as_jax(fault, objective):
    X, y, g = _rank_data()[:3]
    grp = None if fault == "missing" else np.r_[g[:-1], g[-1] + 1]
    msgs = []
    for lgb in (lgb_j, lgb_t):
        p = {"objective": objective, **PINS}
        if lgb is lgb_t:
            p["device_type"] = "cpu"
        with pytest.raises(Exception) as ex:
            lgb.train(p, lgb.Dataset(X, label=y, group=grp, params=p), 1)
        msgs.append(str(ex.value))
    assert msgs[0] == msgs[1]
    assert ("requires query group" in msgs[1]) == (fault == "missing")


def test_group_and_position_accessors():
    X, y, g = _rank_data()[:3]
    p = {"device_type": "cpu"}
    ds = lgb_t.Dataset(X, label=y, params=p)
    assert ds.get_group() is None and ds.get_position() is None
    ds.set_group(g).set_position(np.arange(len(y)) % 4)
    np.testing.assert_array_equal(ds.get_group(), g)
    ds.construct()
    np.testing.assert_array_equal(ds._binned.metadata.group, g)
    np.testing.assert_array_equal(ds._binned.metadata.position,
                                  np.arange(len(y)) % 4)
    ds.set_group(None)
    assert ds._binned.metadata.group is None


@pytest.mark.parametrize("max_docs,ok", [(1, True), (908, True),
                                         (4096, True), (11520, True),
                                         (11521, False)])
def test_lambdarank_plan(max_docs, ok):
    """One block a query with the largest query's documents in shared
    memory (20 bytes each beside a 1 KB reduction), the padding rows'
    blocks after the queries; past the card's shared memory a ValueError
    naming the kernel limit, never a silent plain path."""
    from lightgbm_tpu_torch.learner import cuda_rank

    if not ok:
        with pytest.raises(ValueError, match="kernel limit of 11520"):
            cuda_rank.lambdarank_plan(max_docs, 1000, 2048)
        return
    plan = cuda_rank.lambdarank_plan(max_docs, 1000, 2048)
    assert plan["smem"] == 4 * (5 * max_docs + 256)
    assert plan["pad_blocks"] == 5  # 1048 padding rows
