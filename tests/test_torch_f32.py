"""The rounds grower's f32 mode (tpu_hist_dtype=bf16x2, alias float32)
against the JAX package's on the same seeded inputs, JAX on the CPU:

- hist_round's f32 mode (plain version of the kernel) against the JAX
  package's non-fused round histograms (_hist_nat_fallback on the same
  row -> slot vector), rtol 1e-5; root_sums likewise;
- grow_tree_rounds with quant=False: equal tree arrays and row -> leaf,
  values within the f32 tolerance of tests/test_torch_exact.py;
- lightgbm_tpu_torch.train against lightgbm_tpu.train, both pinned to
  tpu_growth_mode=rounds, tpu_hist_dtype=bf16x2.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.learner import histogram as ht
from test_torch_exact import (
    _channels,
    _dense,
    _gh_both,
    _sparse,
    assert_same_models,
    assert_same_tree,
    grow_both,
)
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

hj = importlib.import_module("lightgbm_tpu.learner.histogram")


@pytest.mark.parametrize("efb", [False, True])
def test_hist_round_f32_matches_jax(efb):
    G, N, B, L, S = 6, 1000, 64, 16, 5
    rs = np.random.RandomState(2)
    bins = torch.from_numpy(rs.randint(0, B, (G, N)).astype(np.int32))
    gh8, gh3 = _gh_both(*_channels(N, 3))
    pleaf = torch.from_numpy(rs.randint(0, L + 1, N).astype(np.int32))
    params = torch.zeros((S, 16), dtype=torch.int32)
    params[:, 0] = torch.tensor([1, 5, 9, 12, -1])
    params[:, 1] = torch.tensor([0, 3, 5, 2, 0])
    params[:, 2] = torch.tensor([10, 30, 50, 20, 0])
    params[:, 3] = torch.tensor([1, 0, 1, 0, 0])
    params[:, 4] = torch.tensor([63, -1, 63, -1, -1])
    params[:, 5] = torch.tensor([1, 0, 1, 1, 0])
    params[:, 6] = torch.tensor([17, 18, 19, 20, 21])
    params[:, 8] = -1
    if efb:
        params[1, 7:10] = torch.tensor([8, 2, 20])
    out, pl_new = ht.hist_round(bins, gh3, pleaf, params, S, B, L,
                                quant=False)
    pl_ref, hslot = ht.round_partition_plain(bins, pleaf, params, S)
    assert torch.equal(pl_new, pl_ref)
    ref = np.asarray(hj._hist_nat_fallback(
        jnp.asarray(bins.numpy()), gh8, jnp.asarray(hslot.numpy()), S, B,
        quant=False))
    assert out.shape == (S, 3, G, B) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert not out[4].any()  # the unused slot


def test_root_sums_match_jax():
    gh8, gh3 = _gh_both(*_channels(1000, 8))
    np.testing.assert_allclose(ht.root_sums(gh3).numpy(),
                               np.asarray(hj.root_sums(gh8)), rtol=1e-6)


def test_hist_nat_f32_mode_not_ported():
    """hist_nat's f32 mode is ported now (the percentile refit's
    histograms, tests/test_torch_renewal.py): fixed-point sums, the same
    bits as hist_round's f32 mode on the same rows and slots."""
    G, N, B, S = 4, 1000, 32, 3
    rs = np.random.RandomState(6)
    bins = torch.from_numpy(rs.randint(0, B, (G, N)).astype(np.int32))
    slot = torch.from_numpy(rs.randint(0, S + 1, N).astype(np.int32))
    _, gh3 = _gh_both(*_channels(N, 7))
    out = ht.hist_nat_slots(bins, gh3, slot, S, B, quant=False)
    k = ht.fx_exponents(gh3.abs().amax(dim=1), N)
    acc = ht._slot_hist_int64(bins, ht.fx_quantize(gh3, k), slot, S, B)
    assert torch.equal(out, ht.fx_to_f32(acc, k))


ROUNDS = {
    # the JAX package's default f32 width (25) binds below the budget
    "dense_25": (_dense, dict(num_leaves=31), {"max_bin": 63}, 25),
    "dense_small_slots": (_dense, dict(num_leaves=40), {"max_bin": 31}, 4),
    "efb_depth": (_sparse, dict(num_leaves=15, max_depth=3),
                  {"max_bin": 63}, 25),
}


@pytest.fixture(scope="module", params=list(ROUNDS))
def grown(request):
    make, tree_kw, ds_params, slots = ROUNDS[request.param]
    return grow_both(make, tree_kw, ds_params, rounds_slots=slots)


def test_rounds_f32_tree_matches_jax(grown):
    assert_same_tree(*grown)


TRAIN = {
    "binary": ({"objective": "binary", "num_leaves": 15,
                "min_data_in_leaf": 5}, 6),
    "regression_slots": ({"objective": "regression", "num_leaves": 31,
                          "min_data_in_leaf": 5, "tpu_round_slots": 4,
                          "tpu_hist_dtype": "float32"}, 4),
}


@pytest.fixture(scope="module", params=list(TRAIN))
def trained(request):
    params, rounds = TRAIN[request.param]
    rs = np.random.RandomState(7)
    n, f = 800, 6
    X = rs.randn(n + 200, f)
    X[rs.rand(n + 200, f) < 0.05] = np.nan
    z = np.nan_to_num(X) @ rs.randn(f)
    if params["objective"] == "binary":
        y = (z + 0.3 * rs.randn(n + 200) > 0).astype(float)
    else:
        y = z + 0.1 * rs.randn(n + 200)
    p = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2",
         "verbosity": -1, **params}
    bj = lgb_j.train(p, lgb_j.Dataset(X[:n], label=y[:n]), rounds)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X[:n], label=y[:n], params=pt),
                     rounds)
    return params, bj, bt, X[n:]


def test_train_f32_matches_jax(trained):
    params, bj, bt, Xv = trained
    gb = bt._gbdt
    assert gb.hist_dtype == "bf16x2" and not gb.spec.quant
    assert gb.spec.rounds_slots == min(params.get("tpu_round_slots") or 25,
                                       params["num_leaves"])
    assert_same_models(bj, bt, Xv)
