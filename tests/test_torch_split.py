"""The port's batched best_split against the JAX package's best_split on
random integer-level histograms, with ties planted: feature, bin and
default_left equal, gains within rtol 1e-5 (the reference scan-order
tie-break, split.py:17 / :430)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.learner.grower import make_split_params as params_j
from lightgbm_tpu.learner.split import best_split as best_j
from lightgbm_tpu.learner.split import feature_best_gains as fbg_j
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.learner.grower import make_split_params as params_t
from lightgbm_tpu_torch.learner.split import (best_split as best_t,
                                              cumsum_last,
                                              feature_best_gains as fbg_t,
                                              first_argmax)
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

F, B, N = 7, 24, 600
PARAMS = {
    "default": {"min_data_in_leaf": 5},
    "regularized": {"min_data_in_leaf": 3, "lambda_l1": 0.5,
                    "lambda_l2": 2.0, "min_gain_to_split": 0.1},
    "max_delta_step": {"min_data_in_leaf": 3, "max_delta_step": 0.2},
    "path_smooth": {"min_data_in_leaf": 3, "path_smooth": 2.0},
    "min_hessian": {"min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 40.0},
}


def _leaf(seed):
    """One leaf's (3, F, B) histogram from integer levels and scales,
    with planted ties: feature 3 duplicates feature 1 (equal gains, the
    lower feature must win) and feature 5 has empty bins (equal gains
    over a run of thresholds)."""
    rs = np.random.RandomState(seed)
    num_bins = rs.randint(4, B + 1, F).astype(np.int32)
    nan_bin = np.where(rs.rand(F) < 0.5, num_bins - 1, -1).astype(np.int32)
    bins = np.stack([rs.randint(0, nb, N) for nb in num_bins])
    bins[3] = bins[1]
    num_bins[3], nan_bin[3] = num_bins[1], nan_bin[1]
    bins[5] = np.where(bins[5] % 3 == 1, 0, bins[5])
    gq = rs.randint(-128, 129, N)
    hq = rs.randint(0, 257, N)
    scale = np.array([rs.rand() * 1e-2 + 1e-3, rs.rand() * 1e-3 + 1e-4, 1.0],
                     np.float32)
    hist_i = np.zeros((3, F, B), np.int64)
    for f in range(F):
        for c, v in enumerate((gq, hq, np.ones(N, np.int64))):
            hist_i[c, f] = np.bincount(bins[f], weights=v, minlength=B)
    hist = (hist_i.astype(np.float32) * scale[:, None, None])
    sums = np.array([gq.sum(), hq.sum(), N], np.float32) * scale
    return hist, sums, num_bins, nan_bin


@pytest.mark.parametrize("pname", list(PARAMS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_best_split_matches_jax(pname, seed):
    hist, sums, num_bins, nan_bin = _leaf(seed)
    mono = np.zeros(F, np.int32)
    pj = params_j(ConfigJ(PARAMS[pname]))
    pt = params_t(ConfigT(PARAMS[pname]))
    po = np.float32(0.37)
    rj = best_j(jnp.asarray(hist), sums[0], sums[1], sums[2],
                jnp.asarray(num_bins), jnp.asarray(nan_bin),
                jnp.asarray(mono), jnp.zeros(F, bool), pj,
                jnp.ones(F, bool), parent_output=po)
    rt = best_t(torch.from_numpy(hist)[None],
                *[torch.from_numpy(sums[i:i + 1]) for i in range(3)],
                torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
                torch.from_numpy(mono), pt, torch.ones(F, dtype=torch.bool),
                parent_output=torch.tensor([po]))
    assert int(rt.feature[0]) == int(rj.feature)
    assert int(rt.bin[0]) == int(rj.bin)
    assert bool(rt.default_left[0]) == bool(rj.default_left)
    np.testing.assert_allclose(float(rt.gain[0]), float(rj.gain), rtol=1e-5)
    for f in ("left_g", "left_h", "left_c", "right_g", "right_h", "right_c"):
        np.testing.assert_allclose(float(getattr(rt, f)[0]),
                                   float(getattr(rj, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("seed", [0, 5])
def test_feature_best_gains_match_jax(seed):
    hist, sums, num_bins, nan_bin = _leaf(seed)
    pj = params_j(ConfigJ(PARAMS["regularized"]))
    pt = params_t(ConfigT(PARAMS["regularized"]))
    gj = fbg_j(jnp.asarray(hist), sums[0], sums[1], sums[2],
               jnp.asarray(num_bins), jnp.asarray(nan_bin),
               jnp.zeros(F, jnp.int32), jnp.zeros(F, bool), pj,
               jnp.ones(F, bool))
    gt = fbg_t(torch.from_numpy(hist)[None],
               *[torch.from_numpy(sums[i:i + 1]) for i in range(3)],
               torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
               torch.zeros(F, dtype=torch.int32), pt,
               torch.ones(F, dtype=torch.bool))
    assert gt.shape == (1, F)
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj), rtol=1e-5)


def test_batch_equals_one_at_a_time():
    leaves = [_leaf(s) for s in range(4)]
    pt = params_t(ConfigT(PARAMS["default"]))
    # a shared feature layout: take the first leaf's tables for all
    _, _, num_bins, nan_bin = leaves[0]
    hists = torch.stack([torch.from_numpy(h) for h, *_ in leaves])
    sums = torch.stack([torch.from_numpy(s) for _, s, *_ in leaves])
    args = (torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
            torch.zeros(F, dtype=torch.int32), pt)
    batch = best_t(hists, sums[:, 0], sums[:, 1], sums[:, 2], *args)
    for i in range(4):
        one = best_t(hists[i:i + 1], sums[i:i + 1, 0], sums[i:i + 1, 1],
                     sums[i:i + 1, 2], *args)
        for a, b in zip(batch, one):
            if a is None:  # the categorical fields of a numerical search
                assert b is None
                continue
            assert torch.equal(a[i:i + 1], b)


def test_feature_mask_respected():
    hist, sums, num_bins, nan_bin = _leaf(0)
    pt = params_t(ConfigT(PARAMS["default"]))
    fm = torch.zeros(F, dtype=torch.bool)
    fm[4] = True
    rt = best_t(torch.from_numpy(hist)[None],
                *[torch.from_numpy(sums[i:i + 1]) for i in range(3)],
                torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
                torch.zeros(F, dtype=torch.int32), pt, fm)
    assert int(rt.feature[0]) == 4 or float(rt.gain[0]) <= -1e29


@pytest.mark.parametrize("n", [1, 5, 16, 17, 63, 256, 300])
def test_cumsum_matches_xla_order(n):
    """The prefix sum adds in XLA:CPU's order, bit for bit."""
    x = (np.random.RandomState(n).randn(3, 4, n) * 1e3).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(cumsum_last(torch.from_numpy(x)).numpy(),
                                  ref)


def test_first_argmax_matches_jnp():
    """First maximum on ties; the first NaN when there is one."""
    rows = np.array([[1.0, 3.0, 3.0, 2.0], [np.nan, 5.0, np.nan, 1.0],
                     [-1e30, -1e30, -1e30, -1e30], [0.0, 2.0, np.nan, 2.0]],
                    np.float32)
    ref = np.asarray(jnp.argmax(jnp.asarray(rows), axis=1))
    np.testing.assert_array_equal(
        first_argmax(torch.from_numpy(rows), dim=1).numpy(), ref)
