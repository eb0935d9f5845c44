"""Each plain PyTorch version in lightgbm_tpu_torch.learner.histogram
against the JAX package's XLA fallback on the same inputs (the Pallas
kernels do not run off the TPU here), plus the wrappers' device rule.
tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on a card."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner.bundle import BundleInfo as BundleJ
from lightgbm_tpu.learner.bundle import decode_feature_bins
from lightgbm_tpu_torch.learner import cuda_hist
from lightgbm_tpu_torch.learner import histogram as ht
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

# the JAX package's learner/__init__ exports a function named histogram
hj = importlib.import_module("lightgbm_tpu.learner.histogram")
G, N, B = 5, 1000, 32


def _inputs(seed, n=N, g=G, b=B):
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, b, (g, n)).astype(np.int32)
    gq = rs.randint(-128, 129, n).astype(np.float32)
    hq = rs.randint(0, 257, n).astype(np.float32)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)  # out-of-bag rows
    gq *= cnt
    hq *= cnt
    return rs, bins, gq, hq, cnt


def _gh_t(gq, hq, cnt):
    return ht.build_gh8_quant(torch.from_numpy(gq), torch.from_numpy(hq),
                              torch.from_numpy(cnt))


@pytest.mark.parametrize("num_slots", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_hist_nat_slots_exact(num_slots, seed):
    rs, bins, gq, hq, cnt = _inputs(seed)
    slot = rs.randint(0, num_slots + 1, N).astype(np.int32)  # S = trash
    gh8 = hj.build_gh8_quant(jnp.asarray(gq), jnp.asarray(hq),
                             jnp.asarray(cnt))
    ref = np.asarray(hj._hist_nat_fallback(
        jnp.asarray(bins), gh8, jnp.asarray(slot), num_slots, B, quant=True))
    out = ht.hist_nat_slots(torch.from_numpy(bins), _gh_t(gq, hq, cnt),
                            torch.from_numpy(slot), num_slots, B)
    assert out.shape == (num_slots, 3, G, B) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def _bundle(num_feat, rs):
    """A toy EFB table: even features read their own column directly,
    odd features are merged into column f % G with a decode range."""
    bundle_of = np.arange(num_feat, dtype=np.int32) % G
    mfb = np.where(np.arange(num_feat) % 2 == 1, 3, -1).astype(np.int32)
    off_lo = np.where(mfb >= 0, 4, 0).astype(np.int32)
    width = np.where(mfb >= 0, 12, B).astype(np.int32)
    return bundle_of, off_lo, mfb, width


def _jax_round_ref(bins, gh8, pleaf, sel_leaf, feat_s, thr, dl, nan_s,
                   small, new_id, S, L, bundle=None):
    """rounds.py:758-831 (the non-fused round) with its histogram pass:
    per-row split parameters, the row's split-column bin (EFB-decoded
    through the feature id), the go-left test, the new row -> leaf and
    the smaller-child histogram slot."""
    col_s = bundle.bundle_of[feat_s] if bundle is not None else feat_s
    live = sel_leaf < L
    memb = (pleaf[:, None] == sel_leaf[None, :]) & live[None, :]
    in_split = jnp.any(memb, axis=1)
    slot_row = jnp.argmax(memb, axis=1)
    pick = lambda a: jnp.where(in_split, a[slot_row], 0)
    col_row, bin_row = pick(col_s), pick(thr)
    dl_row, nan_row = pick(dl) > 0, pick(nan_s)
    small_row, f_row = pick(small) > 0, pick(feat_s)
    col_sel = col_row[None, :] == jnp.arange(bins.shape[0])[:, None]
    fbins = jnp.sum(jnp.where(col_sel, bins, 0), axis=0)
    if bundle is not None:
        fbins = decode_feature_bins(fbins, f_row, bundle)
    go_left = (fbins <= bin_row) | (dl_row & (fbins == nan_row)
                                    & (nan_row >= 0))
    pleaf_new = jnp.where(in_split & ~go_left, pick(new_id), pleaf)
    hslot = jnp.where(in_split & (go_left == small_row), slot_row, S)
    hist = hj._hist_nat_fallback(bins, gh8, hslot.astype(jnp.int32), S, B,
                                 quant=True)
    return np.asarray(hist), np.asarray(pleaf_new)


@pytest.mark.parametrize("efb", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_hist_round_matches_nonfused_round(efb, seed):
    """Fused round vs the JAX package's non-fused round math: histograms
    exact and the new row -> leaf equal. Covers NaN default-left, the EFB
    decode, unused slots and trash rows (rows outside every split and
    padding rows, whose leaf id is L)."""
    rs, bins, gq, hq, cnt = _inputs(seed)
    L, S, F = 16, 6, 2 * G
    pleaf = rs.randint(0, L + 1, N).astype(np.int32)  # L = padding rows
    sel_leaf = np.array([3, 7, 0, 12, L, L], np.int32)  # 2 unused slots
    feat_s = rs.randint(0, F if efb else G, S).astype(np.int32)
    thr = rs.randint(0, B - 1, S).astype(np.int32)
    dl = np.array([1, 0, 1, 1, 0, 0], np.int32)
    nan_s = np.array([B - 1, B - 1, -1, B - 1, -1, -1], np.int32)
    small = rs.randint(0, 2, S).astype(np.int32)
    new_id = np.arange(S, dtype=np.int32) + 20
    tabs = _bundle(F, rs) if efb else None
    bj = None
    if efb:
        bundle_of, off_lo, mfb, width = tabs
        bj = BundleJ(bundle_of=jnp.asarray(bundle_of),
                     off_lo=jnp.asarray(off_lo), mfb=jnp.asarray(mfb),
                     expand_idx=jnp.zeros((F, B), jnp.int32),
                     width=jnp.asarray(width))
    gh8 = hj.build_gh8_quant(jnp.asarray(gq), jnp.asarray(hq),
                             jnp.asarray(cnt))
    ref_h, ref_p = _jax_round_ref(
        jnp.asarray(bins), gh8, jnp.asarray(pleaf), jnp.asarray(sel_leaf),
        jnp.asarray(feat_s), jnp.asarray(thr), jnp.asarray(dl),
        jnp.asarray(nan_s), jnp.asarray(small), jnp.asarray(new_id), S, L,
        bj)

    params = np.zeros((S, 16), np.int32)
    params[:, 0] = np.where(sel_leaf < L, sel_leaf, -1)
    params[:, 1] = tabs[0][feat_s] if efb else feat_s
    params[:, 2], params[:, 3], params[:, 4] = thr, dl, nan_s
    params[:, 5], params[:, 6] = small, new_id
    params[:, 8] = -1
    if efb:
        params[:, 7] = tabs[1][feat_s]
        params[:, 8] = tabs[2][feat_s]
        params[:, 9] = tabs[3][feat_s]
    out_h, out_p = ht.hist_round(
        torch.from_numpy(bins), _gh_t(gq, hq, cnt), torch.from_numpy(pleaf),
        torch.from_numpy(params), S, B, L)
    assert (out_p.numpy() != pleaf).any()  # rows did move
    np.testing.assert_array_equal(out_h.numpy(), ref_h)
    np.testing.assert_array_equal(out_p.numpy(), ref_p)


@pytest.mark.parametrize("k,L", [(1, 255), (8, 31), (3, 7)])
def test_take_cols_exact(k, L):
    rs = np.random.RandomState(k)
    tab = rs.randn(k, L).astype(np.float32)
    idx = rs.randint(-3, L + 3, 2048).astype(np.int32)  # out of range too
    ref = np.asarray(hj.take_cols(jnp.asarray(tab), jnp.asarray(idx)))
    out = ht.take_cols(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("k,L", [(2, 255), (2, 15), (1, 4)])
def test_seg_sum_close(k, L):
    """f32 sums in another order than XLA's scatter-add: rtol 1e-6."""
    rs = np.random.RandomState(L)
    vals = rs.randn(k, 2048).astype(np.float32)
    idx = rs.randint(-2, L + 2, 2048).astype(np.int32)  # dropped rows too
    ref = np.asarray(hj.seg_sum(jnp.asarray(vals), jnp.asarray(idx), L))
    out = ht.seg_sum(torch.from_numpy(vals), torch.from_numpy(idx), L)
    assert out.shape == (k, L)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_unported_modes_raise():
    """The f32 and int8 modes of hist_nat are ported now: on integer
    levels the f32 mode sums the same values, and int8 channels of the
    same levels give the int32 mode's sums."""
    _, bins, gq, hq, cnt = _inputs(0)
    gh = _gh_t(gq, hq, cnt)
    args = (torch.from_numpy(bins), gh, torch.zeros(N, dtype=torch.int32),
            1, B)
    ref = ht.hist_nat_slots(*args)
    assert torch.equal(ht.hist_nat_slots(*args, quant=False), ref)
    small = ht.build_gh8_quant(torch.from_numpy(gq) // 4,
                               torch.from_numpy(hq) // 4,
                               torch.from_numpy(cnt), int8_levels=64)
    assert small.dtype == torch.int8
    assert torch.equal(ht.hist_nat_slots(args[0], small, *args[2:]),
                       ht.hist_nat_slots(args[0], small.to(torch.int32),
                                         *args[2:]))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: CPU tensors never reach a
    silent fallback inside cuda_hist."""
    _, bins, gq, hq, cnt = _inputs(0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hist.hist_nat(torch.from_numpy(bins), _gh_t(gq, hq, cnt),
                           torch.zeros(N, dtype=torch.int32), 1, B, 256)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hist.hist_nat(torch.from_numpy(bins),
                           _gh_t(gq, hq, cnt).to(torch.int8),
                           torch.zeros(N, dtype=torch.int32), 1, B, 127)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hist.hist_nat_f32(torch.from_numpy(bins), torch.zeros(3, N),
                               torch.zeros(N, dtype=torch.int32), 1, B)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hist.take_small(torch.zeros(1, 4), torch.zeros(8,
                                                            dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hist.seg_sum(torch.zeros(2, 8), torch.zeros(8,
                                                         dtype=torch.int32), 4)


def test_int_range_guard():
    cuda_hist.check_int_range(8_000_000, 256)
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_hist.check_int_range(8_400_000, 256)
