"""Quantized-gradient training (use_quantized_grad) and the explicit
tpu_hist_dtype=int8 policy: lightgbm_tpu_torch against lightgbm_tpu on
the same seeded inputs, JAX on the CPU (its XLA fallbacks), both pinned
to tpu_growth_mode=rounds (or exact where the case is the exact path):

- hist_nat_slots on int8 channels (plain version of the kernel's int8
  mode) against the JAX package's _hist_nat_fallback: integer sums,
  exact; the int8 and int32 layouts give the same sums;
- lightgbm_tpu_torch.train against lightgbm_tpu.train at 4, 16, 200 and
  300 levels (int8, int8, int16, dequantized), with
  quant_train_renew_leaf on and off, binary, regression and multiclass,
  on the exact path, and with tpu_hist_dtype=int8: equal tree structure
  in the model text, leaf values within rtol 1e-5 / atol 1e-5 (the f32
  tolerance of tests/test_torch_exact.py), raw predictions within 1e-5;
- the resolved policy: the channel layout, 48 round slots, and the
  grower spec's quant / quant_int8 flags.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch import rng
from lightgbm_tpu_torch.learner import histogram as ht
from lightgbm_tpu_torch.learner.quantize import discretize_gradients_int, \
    resolve_hist_dtype
from test_torch_exact import assert_same_models
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

hj = importlib.import_module("lightgbm_tpu.learner.histogram")


def _levels(n, levels, seed):
    """Integer levels as discretize_gradients_int makes them at `levels`
    levels (10% of the rows out of bag)."""
    rs = np.random.RandomState(seed)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    half = levels // 2
    gq = rs.randint(-half, half + 1, n).astype(np.float32) * cnt
    hq = rs.randint(0, levels + 1, n).astype(np.float32) * cnt
    return rs, gq, hq, cnt


@pytest.mark.parametrize("levels", [4, 127])
@pytest.mark.parametrize("num_slots", [1, 5])
def test_hist_nat_int8_matches_jax(levels, num_slots):
    """Integer sums: exact against the JAX fallback, and the same as the
    int32 layout of the same levels."""
    G, N, B = 5, 1000, 32
    rs, gq, hq, cnt = _levels(N, levels, 3)
    bins = rs.randint(0, B, (G, N)).astype(np.int32)
    slot = rs.randint(0, num_slots + 1, N).astype(np.int32)
    gh = ht.build_gh8_quant(torch.from_numpy(gq), torch.from_numpy(hq),
                            torch.from_numpy(cnt), int8_levels=levels)
    assert gh.dtype == torch.int8
    out = ht.hist_nat_slots(torch.from_numpy(bins), gh,
                            torch.from_numpy(slot), num_slots, B,
                            levels=levels)
    gh8 = hj.build_gh8_quant(jnp.asarray(gq), jnp.asarray(hq),
                             jnp.asarray(cnt))
    ref = np.asarray(hj._hist_nat_fallback(
        jnp.asarray(bins), gh8, jnp.asarray(slot), num_slots, B, quant=True))
    np.testing.assert_array_equal(out.numpy(), ref)
    wide = ht.hist_nat_slots(torch.from_numpy(bins), gh.to(torch.int32),
                             torch.from_numpy(slot), num_slots, B)
    assert torch.equal(out, wide)


def test_build_gh8_quant_int8_only_when_levels_fit():
    """Below 127 levels the int8 mode's channels are int8 with no check;
    at 127, where stochastic rounding can lift a hessian level to 128,
    such a tree's channels stay int32; outside the int8 mode, int32."""
    ones = torch.ones(4)
    assert ht.build_gh8_quant(ones, ones * 5, ones,
                              int8_levels=4).dtype == torch.int8
    assert ht.build_gh8_quant(ones, ones * 127, ones,
                              int8_levels=127).dtype == torch.int8
    assert ht.build_gh8_quant(ones, ones * 128, ones,
                              int8_levels=127).dtype == torch.int32
    assert ht.build_gh8_quant(ones, ones, ones).dtype == torch.int32


@pytest.mark.parametrize("levels", [4, 16, 126])
def test_levels_stay_within_one_above_the_count(levels):
    """Stochastic rounding keeps every level within +-(levels + 1), the
    bound build_gh8_quant relies on to skip its check below 127 levels:
    the largest |gradient| and hessian sit exactly on the top level."""
    rs = np.random.RandomState(levels)
    n = 4096
    grad = torch.from_numpy(rs.randn(n).astype(np.float32))
    hess = torch.from_numpy(rs.rand(n).astype(np.float32))
    grad[0], hess[0] = -grad.abs().max() * 1.5, hess.max() * 1.5
    for seed in range(8):
        key = rng.key(seed)
        gq, hq, _ = discretize_gradients_int(grad, hess, key, levels, True)
        assert int(gq.abs().max()) <= levels // 2 + 1
        assert int(hq.max()) <= levels + 1
        gh = ht.build_gh8_quant(gq, hq, torch.ones(n), int8_levels=levels)
        assert torch.equal(gh.to(torch.int32), torch.stack(
            [gq, hq, torch.ones(n)]).to(torch.int32))


@pytest.mark.parametrize("bins,rounds,want", [
    (4, True, ("int8", 0)), (127, True, ("int8", 0)),
    (128, True, ("int16", 0)), (256, True, ("int16", 0)),
    (300, True, ("bf16x2", 0)), (4, False, ("bf16x2", 0)),
])
def test_resolve_quantized_policy(bins, rounds, want):
    """use_quantized_grad: the public levels govern, as the JAX
    package's resolve_hist_dtype (whose third return is a warning)."""
    from lightgbm_tpu.learner.quantize import resolve_hist_dtype as res_j

    assert resolve_hist_dtype("auto", True, bins, rounds) == want
    assert res_j("auto", True, bins, rounds)[:2] == want


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
    return X[:n], y[:n], X[n:]


ROUNDS = {"tpu_growth_mode": "rounds"}
QUANT = {"use_quantized_grad": True}
BINARY = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5}
# case -> (task, params, rounds, (hist_dtype, quant, quant_int8))
CASES = {
    "q4_renew": ("binary", {**BINARY, **ROUNDS, **QUANT,
                            "quant_train_renew_leaf": True}, 5,
                 ("int8", True, True)),
    "q4": ("binary", {**BINARY, **ROUNDS, **QUANT}, 5, ("int8", True, True)),
    "q16_regression": ("regression",
                       {"objective": "regression", "num_leaves": 31,
                        "min_data_in_leaf": 5, "learning_rate": 0.2,
                        **ROUNDS, **QUANT, "num_grad_quant_bins": 16,
                        "quant_train_renew_leaf": True}, 5,
                       ("int8", True, True)),
    "q200": ("binary", {**BINARY, **ROUNDS, **QUANT,
                        "num_grad_quant_bins": 200}, 5,
             ("int16", True, False)),
    "q300_renew": ("binary", {**BINARY, **ROUNDS, **QUANT,
                              "num_grad_quant_bins": 300,
                              "quant_train_renew_leaf": True}, 5,
                   ("bf16x2", False, False)),
    "q4_multiclass": ("multiclass",
                      {"objective": "multiclass", "num_class": 3,
                       "num_leaves": 7, "min_data_in_leaf": 10, **ROUNDS,
                       **QUANT, "quant_train_renew_leaf": True}, 4,
                      ("int8", True, True)),
    "q4_exact": ("binary", {**BINARY, "tpu_growth_mode": "exact", **QUANT,
                            "quant_train_renew_leaf": True}, 4,
                 ("bf16x2", False, False)),
    "int8_policy": ("binary", {**BINARY, **ROUNDS,
                               "tpu_hist_dtype": "int8"}, 5,
                    ("int8", True, True)),
    "int8_policy_regression": ("regression",
                               {"objective": "regression", "num_leaves": 31,
                                "min_data_in_leaf": 5, **ROUNDS,
                                "tpu_hist_dtype": "int8"}, 5,
                               ("int8", True, True)),
}


@pytest.fixture(scope="module", params=list(CASES))
def trained(request):
    task, params, rounds, want = CASES[request.param]
    X, y, Xv = _data(task)
    p = {**params, "verbosity": -1}
    bj = lgb_j.train(p, lgb_j.Dataset(X, label=y), rounds)
    pt = {**p, "device_type": "cpu"}
    bt = lgb_t.train(pt, lgb_t.Dataset(X, label=y, params=pt), rounds)
    return params, want, bj, bt, Xv


def test_quantized_train_matches_jax(trained):
    """Same trees (structure equal, leaf values rtol 1e-5 / atol 1e-5)
    and raw predictions within 1e-5."""
    _, _, bj, bt, Xv = trained
    assert_same_models(bj, bt, Xv)


def test_quantized_policy_resolved(trained):
    """The channel layout and the grower spec: quant under <= 256
    levels on the rounds path, int8 under <= 127, 48 slots under
    use_quantized_grad and the int-packed policy alike (the default
    slot count decides which leaves a round takes)."""
    params, (dtype, quant, int8), bj, bt, _ = trained
    gj, gt = bj._gbdt, bt._gbdt
    assert gt.hist_dtype == gj.hist_dtype == dtype
    assert (gt.spec.quant, gt.spec.quant_int8) == (quant, int8)
    assert (gj.spec.quant, gj.spec.quant_int8) == (quant, int8)
    assert gt.spec.rounds_slots == gj.spec.rounds_slots
    if params["tpu_growth_mode"] == "rounds":
        assert gt.spec.rounds_slots == min(48, params["num_leaves"])
