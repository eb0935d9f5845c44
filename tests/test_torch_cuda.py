"""The CUDA kernels against their plain PyTorch versions on a card, and a
small training run on the card against the same run on the CPU.

These tests need a CUDA device; without one they skip (decided inside
the fixture when a test runs, never at import). The file imports neither
jax nor lightgbm_tpu, so it runs on a machine that has only torch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.learner import cuda_hist
from lightgbm_tpu_torch.learner import histogram as ht
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n=8192, g=7, b=64, seed=0):
    rs = np.random.RandomState(seed)
    bins = torch.from_numpy(rs.randint(0, b, (g, n)).astype(np.int32))
    cnt = (rs.rand(n) < 0.9).astype(np.int64)
    gh = torch.from_numpy(np.stack([rs.randint(-128, 129, n) * cnt,
                                    rs.randint(0, 257, n) * cnt,
                                    cnt]).astype(np.int32))
    return rs, bins, gh


@pytest.mark.parametrize("num_slots", [1, 4, 400])
def test_hist_nat_exact(dev, num_slots):
    """400 slots at 64 bins exceed one block's shared memory: the slot
    axis is split across blocks."""
    rs, bins, gh = _inputs()
    slot = torch.from_numpy(rs.randint(0, num_slots + 1, 8192)
                            .astype(np.int32))
    bt, gt, st = bins.to(dev), gh.to(dev), slot.to(dev)
    out = ht.hist_nat_slots(bt, gt, st, num_slots, 64)
    assert torch.equal(out.cpu(), ht.hist_nat_slots_plain(bins, gh, slot,
                                                          num_slots, 64))


@pytest.mark.parametrize("efb", [False, True])
def test_hist_round_exact(dev, efb):
    rs, bins, gh = _inputs()
    L = 16
    pleaf = torch.from_numpy(rs.randint(0, L + 1, 8192).astype(np.int32))
    params = torch.zeros((4, 16), dtype=torch.int32)
    params[:, 0] = torch.tensor([1, 5, 9, -1])
    params[:, 1] = torch.tensor([0, 3, 6, 0])
    params[:, 2] = torch.tensor([10, 30, 50, 0])
    params[:, 3] = torch.tensor([1, 0, 1, 0])
    params[:, 4] = torch.tensor([63, -1, 63, -1])
    params[:, 5] = torch.tensor([1, 0, 1, 0])
    params[:, 6] = torch.tensor([17, 18, 19, 20])
    params[:, 8] = -1
    if efb:
        params[1, 7:10] = torch.tensor([8, 2, 20])
    hk, pk = ht.hist_round(bins.to(dev), gh.to(dev), pleaf.to(dev),
                           params.to(dev), 4, 64, L)
    hp, pp = ht.hist_round_plain(bins, gh, pleaf, params, 4, 64)
    assert torch.equal(hk.cpu(), hp) and torch.equal(pk.cpu(), pp)


@pytest.mark.parametrize("k,L", [(1, 255), (8, 255), (2, 20000)])
def test_take_small_exact(dev, k, L):
    """A table over 48 KB is read from device memory instead of staged."""
    rs = np.random.RandomState(k)
    tab = torch.from_numpy(rs.randn(k, L).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-2, L + 2, 10000).astype(np.int32))
    out = ht.take_cols(tab.to(dev), idx.to(dev))
    assert torch.equal(out.cpu(), ht.take_cols_plain(tab, idx))


def test_seg_sum_reproducible_and_close(dev):
    rs = np.random.RandomState(1)
    vals = torch.from_numpy(rs.randn(2, 100000).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-1, 257, 100000).astype(np.int32))
    v, i = vals.to(dev), idx.to(dev)
    s1, s2 = ht.seg_sum(v, i, 255), ht.seg_sum(v, i, 255)
    assert torch.equal(s1, s2)
    torch.testing.assert_close(s1.cpu(), ht.seg_sum_plain(vals, idx, 255),
                               rtol=1e-5, atol=1e-4)


def test_launch_counts(dev):
    rs, bins, gh = _inputs()
    cuda_hist.reset_launch_counts()
    ht.hist_nat_slots(bins.to(dev), gh.to(dev),
                      torch.zeros(8192, dtype=torch.int32, device=dev), 1, 64)
    assert cuda_hist.LAUNCHES["hist_nat"] == 1


def _f32_inputs(n=8192, g=7, b=64, seed=0):
    rs = np.random.RandomState(seed)
    bins = torch.from_numpy(rs.randint(0, b, (g, n)).astype(np.int32))
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    gh = ht.build_gh3(torch.from_numpy(rs.randn(n).astype(np.float32) * cnt),
                      torch.from_numpy(rs.rand(n).astype(np.float32) * cnt),
                      torch.from_numpy(cnt))
    return rs, bins, gh


@pytest.mark.parametrize("begin,count", [(0, None), (0, 4096), (1000, 3001),
                                         (8191, 1), (5, 0)])
def test_hist_bitwise_equals_plain(dev, begin, count):
    """Fixed-point sums: the kernel gives the plain version's bits, on
    every launch; device bounds with a host cap cover the same rows."""
    _, bins, gh = _f32_inputs()
    bt, gt = bins.to(dev), gh.to(dev)
    ref = ht.histogram_plain(bins, gh, 64, begin, count)
    out = ht.histogram(bt, gt, 64, begin, count)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(ht.histogram(bt, gt, 64, begin, count), out)
    if count is not None:
        cap = max(count, 1) + 17
        dv = ht.histogram(bt, gt, 64, torch.tensor(begin, device=dev),
                          torch.tensor(count, device=dev), cap=cap)
        assert torch.equal(dv.cpu(), ht.histogram_plain(bins, gh, 64, begin,
                                                        count, cap))


@pytest.mark.parametrize("num_slots", [6, 130])
def test_hist_slots_bitwise_equals_plain(dev, num_slots):
    """Disjoint segments in random order with empty slots; 130 slots at
    64 bins spread over many blocks."""
    rs, bins, gh = _f32_inputs()
    cuts = np.sort(rs.choice(np.arange(1, 8192), num_slots, replace=False))
    starts = np.concatenate([[0], cuts[:-1]])
    lens = cuts - starts
    lens[rs.rand(num_slots) < 0.2] = 0
    perm = rs.permutation(num_slots)
    begins = torch.from_numpy(starts[perm].astype(np.int32))
    counts = torch.from_numpy(lens[perm].astype(np.int32))
    ref = ht.hist_slots_plain(bins, gh, begins, counts, 64, num_slots)
    a = ht.hist_slots(bins.to(dev), gh.to(dev), begins.to(dev),
                      counts.to(dev), 64, num_slots)
    b = ht.hist_slots(bins.to(dev), gh.to(dev), begins.to(dev),
                      counts.to(dev), 64, num_slots)
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)


@pytest.mark.parametrize("efb", [False, True])
def test_hist_round_f32_bitwise_equals_plain(dev, efb):
    rs, bins, gh = _f32_inputs()
    L = 16
    pleaf = torch.from_numpy(rs.randint(0, L + 1, 8192).astype(np.int32))
    params = torch.zeros((4, 16), dtype=torch.int32)
    params[:, 0] = torch.tensor([1, 5, 9, -1])
    params[:, 1] = torch.tensor([0, 3, 6, 0])
    params[:, 2] = torch.tensor([10, 30, 50, 0])
    params[:, 3] = torch.tensor([1, 0, 1, 0])
    params[:, 4] = torch.tensor([63, -1, 63, -1])
    params[:, 5] = torch.tensor([1, 0, 1, 0])
    params[:, 6] = torch.tensor([17, 18, 19, 20])
    params[:, 8] = -1
    if efb:
        params[1, 7:10] = torch.tensor([8, 2, 20])
    cuda_hist.reset_launch_counts()
    args = (bins.to(dev), gh.to(dev), pleaf.to(dev), params.to(dev), 4, 64,
            L)
    hk, pk = ht.hist_round(*args, quant=False)
    hk2, _ = ht.hist_round(*args, quant=False)
    hp, pp = ht.hist_round_plain(bins, gh, pleaf, params, 4, 64, quant=False)
    assert torch.equal(hk.cpu(), hp) and torch.equal(pk.cpu(), pp)
    assert torch.equal(hk, hk2)
    assert cuda_hist.LAUNCHES["hist_round_f32"] == 2
    assert cuda_hist.LAUNCHES["hist_round"] == 0


def _int8_inputs(n=8192, g=7, b=64, seed=0):
    """Levels within +-127, as build_gh8_quant's int8 channels."""
    rs = np.random.RandomState(seed)
    bins = torch.from_numpy(rs.randint(0, b, (g, n)).astype(np.int32))
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    gh = ht.build_gh8_quant(
        torch.from_numpy(rs.randint(-63, 64, n).astype(np.float32) * cnt),
        torch.from_numpy(rs.randint(0, 128, n).astype(np.float32) * cnt),
        torch.from_numpy(cnt), int8_levels=127)
    assert gh.dtype == torch.int8
    return rs, bins, gh


@pytest.mark.parametrize("num_slots", [1, 4, 400])
def test_hist_nat_int8_exact(dev, num_slots):
    """The int8 mode: the same integer sums as the plain version (and as
    the int32 mode on the same levels), counted as hist_nat_int8."""
    rs, bins, gh = _int8_inputs()
    slot = torch.from_numpy(rs.randint(0, num_slots + 1, 8192)
                            .astype(np.int32))
    bt, st = bins.to(dev), slot.to(dev)
    cuda_hist.reset_launch_counts()
    out = ht.hist_nat_slots(bt, gh.to(dev), st, num_slots, 64, levels=127)
    ref = ht.hist_nat_slots_plain(bins, gh, slot, num_slots, 64)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(ht.hist_nat_slots(bt, gh.to(torch.int32).to(dev), st,
                                         num_slots, 64), out)
    assert cuda_hist.LAUNCHES["hist_nat_int8"] == 1
    assert cuda_hist.LAUNCHES["hist_nat"] == 1


@pytest.mark.parametrize("efb", [False, True])
def test_hist_round_int8_exact(dev, efb):
    rs, bins, gh = _int8_inputs()
    L = 16
    pleaf = torch.from_numpy(rs.randint(0, L + 1, 8192).astype(np.int32))
    params = torch.zeros((4, 16), dtype=torch.int32)
    params[:, 0] = torch.tensor([1, 5, 9, -1])
    params[:, 1] = torch.tensor([0, 3, 6, 0])
    params[:, 2] = torch.tensor([10, 30, 50, 0])
    params[:, 3] = torch.tensor([1, 0, 1, 0])
    params[:, 4] = torch.tensor([63, -1, 63, -1])
    params[:, 5] = torch.tensor([1, 0, 1, 0])
    params[:, 6] = torch.tensor([17, 18, 19, 20])
    params[:, 8] = -1
    if efb:
        params[1, 7:10] = torch.tensor([8, 2, 20])
    cuda_hist.reset_launch_counts()
    hk, pk = ht.hist_round(bins.to(dev), gh.to(dev), pleaf.to(dev),
                           params.to(dev), 4, 64, L, levels=127)
    hp, pp = ht.hist_round_plain(bins, gh, pleaf, params, 4, 64)
    assert torch.equal(hk.cpu(), hp) and torch.equal(pk.cpu(), pp)
    assert cuda_hist.LAUNCHES["hist_round_int8"] == 1
    assert cuda_hist.LAUNCHES["hist_round"] == 0


@pytest.mark.parametrize("num_slots,G", [(255, 1), (6, 7)])
def test_hist_nat_f32_bitwise_equals_plain(dev, num_slots, G):
    """The f32 mode at the percentile refit's shape (one column, a slot
    per leaf, most rows in the trash slot) and a wider one: the plain
    version's bits on every launch."""
    rs, bins, gh = _f32_inputs(g=G, b=256)
    slot = torch.from_numpy(np.where(rs.rand(8192) < 0.5,
                                     rs.randint(0, num_slots, 8192),
                                     num_slots).astype(np.int32))
    args = (bins.to(dev), gh.to(dev), slot.to(dev), num_slots, 256)
    cuda_hist.reset_launch_counts()
    a = ht.hist_nat_slots(*args, quant=False)
    b = ht.hist_nat_slots(*args, quant=False)
    ref = ht.hist_nat_slots_plain(bins, gh, slot, num_slots, 256,
                                  quant=False)
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)
    assert cuda_hist.LAUNCHES["hist_nat_f32"] == 2


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n", [100_352, 1_001_472, 1_001_473, 5])
def test_take_small_main_path_shapes(dev, k, n):
    """The main path's shapes (the validation traversal at k = 8, the
    score update at k = 1, the refit at k = 2, over 100k and 1M rows), a
    ragged last group of rows, an idx view one element off (not 16-byte
    aligned) and indices outside [0, L): the plain version's bits, one
    launch a call."""
    rs = np.random.RandomState(k * 131 + n % 997)
    L = 255
    tab = torch.from_numpy(rs.randn(k, L).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-3, L + 3, n + 1).astype(np.int32))
    t, i = tab.to(dev), idx.to(dev)
    for cut in (i[:n], i[1:]):
        cuda_hist.reset_launch_counts()
        out = ht.take_cols(t, cut)
        assert cuda_hist.LAUNCHES["take_small"] == 1
        assert torch.equal(out.cpu(), ht.take_cols_plain(tab, cut.cpu()))


@pytest.mark.parametrize("k,L", [(8, 4096), (3, 255), (5, 9000)])
def test_take_small_wide_tables(dev, k, L):
    """A table past the 48 KB staged in shared memory (8 x 4096, 5 x
    9000) is read through the read-only cache; k = 3 takes the kernel's
    any-k path. Ragged rows, out-of-range indices."""
    rs = np.random.RandomState(L)
    tab = torch.from_numpy(rs.randn(k, L).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-2, L + 2, 30_001).astype(np.int32))
    out = ht.take_cols(tab.to(dev), idx.to(dev))
    assert torch.equal(out.cpu(), ht.take_cols_plain(tab, idx))


def _refit_inputs(n, num_slots, G, hot, seed=0):
    """A refit pass's arguments: f32 weights in the gradient channel, a
    zero hessian channel, the in-bracket flag as the count; rows outside
    every bracket in the trash slot. hot: the in-bracket rows of a few
    leaves fall in 3 bins (a late pass)."""
    rs = np.random.RandomState(seed)
    inb = rs.rand(n) < (0.05 if hot else 0.5)
    if hot:
        s = rs.randint(0, 4, n)
        b = rs.randint(17, 20, (G, n))
    else:
        s = rs.randint(0, num_slots, n)
        b = rs.randint(0, 256, (G, n))
    w = rs.rand(n).astype(np.float32) * inb
    gh = torch.from_numpy(np.stack([w, np.zeros(n, np.float32),
                                    inb.astype(np.float32)]))
    slot = torch.from_numpy(np.where(inb, s, num_slots).astype(np.int32))
    return torch.from_numpy(b.astype(np.int32)), gh, slot


@pytest.mark.parametrize("case,n,num_slots,G", [
    ("refit", 100_352, 255, 1),
    ("hot", 100_352, 256, 1),
    ("ragged", 100_353, 255, 2),
    ("root", 100_352, 1, 7),
    ("narrow", 20_001, 20, 3),
    ("default_leaves", 100_352, 31, 1)])
def test_hist_nat_f32_routes_bitwise(dev, case, n, num_slots, G):
    """hist_nat's f32 mode at the refit's slot counts (255, 256 and
    LightGBM's default 31) and off them: the plain version's bits, the
    same bits on a second launch, one launch a call. "hot" puts the
    in-bracket rows of 4 leaves in 3 bins; "ragged" has N % 4 != 0
    (scalar loads)."""
    bins, gh, slot = _refit_inputs(n, num_slots, G, case == "hot")
    args = (bins.to(dev), gh.to(dev), slot.to(dev), num_slots, 256)
    cuda_hist.reset_launch_counts()
    a = cuda_hist.hist_nat_f32(*args)
    b = cuda_hist.hist_nat_f32(*args)
    assert cuda_hist.LAUNCHES["hist_nat_f32"] == 2
    ref = ht.hist_nat_slots_plain(bins, gh, slot, num_slots, 256,
                                  quant=False)
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)


@pytest.mark.parametrize("params,want", [
    ({"objective": "binary", "use_quantized_grad": True,
      "quant_train_renew_leaf": True},
     {"hist_nat_int8", "hist_round_int8", "seg_sum"}),
    # at 127 levels a hessian level can reach 128: the grower picks int32
    # channels without reading the levels back (the same integer sums)
    ({"objective": "binary", "tpu_hist_dtype": "int8"},
     {"hist_nat", "hist_round", "seg_sum"}),
    ({"objective": "regression_l1"}, {"hist_nat_f32", "hist_round"}),
    ({"objective": "quantile", "alpha": 0.3}, {"hist_nat_f32"}),
], ids=["quantized", "int8", "l1", "quantile"])
def test_train_quant_and_renewal_card_matches_cpu(dev, params, want):
    rs = np.random.RandomState(3)
    X = rs.randn(3000, 6)
    z = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(3000)
    y = (z > 0).astype(float) if params["objective"] == "binary" else z
    preds = {}
    for d in ("cuda", "cpu"):
        p = {"num_leaves": 31, "verbosity": -1, "device_type": d, **params}
        cuda_hist.reset_launch_counts()
        bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 4)
        preds[d] = bst.predict(X, raw_score=True)
        if d == "cuda":
            used = {k for k, v in cuda_hist.LAUNCHES.items() if v}
            assert want <= used, used
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], atol=1e-4)


@pytest.mark.parametrize("pins", [
    {"tpu_growth_mode": "exact"},
    {"tpu_growth_mode": "exact", "tpu_growth_rounds": True},
    {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2"},
], ids=["exact", "exact_rounds", "rounds_f32"])
def test_train_f32_paths_card_matches_cpu(dev, pins):
    rs = np.random.RandomState(3)
    X = rs.randn(3000, 6)
    X[rs.rand(3000, 6) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * X[:, 1] + 0.3 * rs.randn(3000)
         > 0).astype(float)
    preds = {}
    for d in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
             "device_type": d, **pins}
        cuda_hist.reset_launch_counts()
        bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 4)
        preds[d] = bst.predict(X, raw_score=True)
        if d == "cuda":
            used = {k for k, v in cuda_hist.LAUNCHES.items() if v}
            want = {"hist"} | ({"hist_slots"} if "tpu_growth_rounds" in pins
                               else set()) | (
                {"hist_round_f32"} if pins["tpu_growth_mode"] == "rounds"
                else set())
            assert want <= used, used
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], atol=1e-5)


def test_train_card_matches_cpu(dev):
    rs = np.random.RandomState(3)
    X = rs.randn(3000, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(3000) > 0).astype(float)
    preds = {}
    for d in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
             "device_type": d}
        bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), 4)
        preds[d] = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], atol=1e-4)


def _cat_round_inputs(mode, efb, seed=0):
    """A round of 6 slots over 64 bins, slots 0, 2 and 4 categorical
    with random category sets (slot 4 decodes an EFB column when efb);
    slot 5 unused."""
    if mode == "f32":
        rs, bins, gh = _f32_inputs(seed=seed)
    elif mode == "int8":
        rs, bins, gh = _int8_inputs(seed=seed)
    else:
        rs, bins, gh = _inputs(seed=seed)
    L, S = 16, 6
    pleaf = torch.from_numpy(rs.randint(0, L + 1, 8192).astype(np.int32))
    params = torch.zeros((S, 16), dtype=torch.int32)
    params[:, 0] = torch.tensor([1, 5, 9, 12, 3, -1])
    params[:, 1] = torch.tensor([0, 3, 6, 2, 4, 0])
    params[:, 2] = torch.tensor([10, 30, 50, 20, 40, 0])
    params[:, 3] = torch.tensor([1, 0, 1, 0, 1, 0])
    params[:, 4] = torch.tensor([63, -1, 63, -1, 63, -1])
    params[:, 5] = torch.tensor([1, 0, 1, 0, 0, 0])
    params[:, 6] = torch.tensor([17, 18, 19, 20, 21, 22])
    params[:, 8] = -1
    params[[0, 2, 4], 10] = 1
    if efb:
        params[4, 7:10] = torch.tensor([8, 2, 20])
    cat_mask = torch.from_numpy(rs.rand(S, 64) < 0.5)
    return bins, gh, pleaf, params, cat_mask, L, S


@pytest.mark.parametrize("efb", [False, True])
@pytest.mark.parametrize("mode", ["int16", "int8", "f32"])
def test_hist_round_categorical_exact(dev, mode, efb):
    """The categorical variant of every channel mode: the plain
    version's histograms and row -> leaf bit for bit, on two launches,
    counted as hist_round_cat beside the mode's own count."""
    bins, gh, pleaf, params, cat_mask, L, S = _cat_round_inputs(mode, efb)
    quant = mode != "f32"
    kw = {"quant": quant, "levels": 127 if mode == "int8" else 256}
    args = (bins.to(dev), gh.to(dev), pleaf.to(dev), params.to(dev), S, 64,
            L)
    cuda_hist.reset_launch_counts()
    hk, pk = ht.hist_round(*args, cat_mask=cat_mask.to(dev), **kw)
    hk2, pk2 = ht.hist_round(*args, cat_mask=cat_mask.to(dev), **kw)
    hp, pp = ht.hist_round_plain(bins, gh, pleaf, params, S, 64,
                                 quant=quant, cat_mask=cat_mask)
    assert torch.equal(hk.cpu(), hp) and torch.equal(pk.cpu(), pp)
    assert torch.equal(hk, hk2) and torch.equal(pk, pk2)
    name = {"int16": "hist_round", "int8": "hist_round_int8",
            "f32": "hist_round_f32"}[mode]
    assert cuda_hist.LAUNCHES[name] == 2
    assert cuda_hist.LAUNCHES["hist_round_cat"] == 2
    # the sets matter: the numerical decision moves some rows
    _, pn = ht.hist_round_plain(bins, gh, pleaf, params, S, 64, quant=quant)
    assert not torch.equal(pn, pp)


@pytest.mark.parametrize("pins", [
    {}, {"use_quantized_grad": True},
    {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2"},
    {"tpu_growth_mode": "exact"},
], ids=["int16", "quantized", "rounds_f32", "exact"])
def test_train_categorical_card_matches_cpu(dev, pins):
    rs = np.random.RandomState(5)
    n = 4000
    c0 = rs.randint(0, 30, n)
    c1 = rs.randint(0, 3, n)
    X = np.column_stack([c0, c1, rs.randn(n, 3)]).astype(float)
    X[rs.rand(n) < 0.05, 0] = np.nan
    z = rs.randn(30)[c0] + rs.randn(3)[c1] + 0.5 * X[:, 2]
    y = (z + rs.logistic(size=n) > 0).astype(float)
    preds = {}
    for d in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
             "min_data_per_group": 20, "device_type": d, **pins}
        cuda_hist.reset_launch_counts()
        bst = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=[0, 1],
                                       params=p), 4)
        preds[d] = bst.predict(X, raw_score=True)
        if d == "cuda" and pins.get("tpu_growth_mode") != "exact":
            assert cuda_hist.LAUNCHES["hist_round_cat"] > 0
        assert any(line.startswith("num_cat=") and line != "num_cat=0"
                   for line in bst.model_to_string().splitlines())
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], atol=1e-4)


# ---- seg_sum: one order-free fixed-point pass


def _seg_inputs(k, L, n, seed=0):
    """(k, n) f32 values and leaf ids, 10% of them out of range (-1 and
    L, both dropped)."""
    rs = np.random.RandomState(seed)
    vals = rs.randn(k, n).astype(np.float32)
    idx = rs.randint(0, L, n)
    out = rs.rand(n) < 0.1
    idx[out] = np.where(rs.rand(int(out.sum())) < 0.5, -1, L)
    return torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int32))


def _check_seg_sum(dev, vals, idx, L):
    """Bitwise across two launches (2 launch counts); within 2^-23 of
    the float64 sum plus n x 2^-38 (the fixed point's quantum at these
    maxima); within rtol 1e-5 of the plain version's f32 index_add_ plus
    an atol of 2^-20 x the leaf's sum of |v| (the f32 sequential sum's
    own rounding)."""
    v, i = vals.to(dev), idx.to(dev)
    cuda_hist.reset_launch_counts()
    a, b = ht.seg_sum(v, i, L), ht.seg_sum(v, i, L)
    assert cuda_hist.LAUNCHES["seg_sum"] == 2
    assert torch.equal(a, b)
    ok = (idx >= 0) & (idx < L)
    key = torch.where(ok, idx, L).long()
    ref = torch.zeros((vals.shape[0], L + 1), dtype=torch.float64)
    ref.index_add_(1, key, vals.double())
    mag = torch.zeros_like(ref).index_add_(1, key, vals.double().abs())
    ref, mag = ref[:, :L], mag[:, :L]
    a64 = a.cpu().double()
    n = vals.shape[1]
    assert bool(((a64 - ref).abs() <= ref.abs() * 2.0 ** -23
                 + n * 2.0 ** -38).all())
    plain = ht.seg_sum_plain(vals, idx, L).double()
    assert bool(((a64 - plain).abs() <= 1e-5 * plain.abs()
                 + mag * 2.0 ** -20).all())
    return a64, ref, mag


@pytest.mark.parametrize("n", [2048, 1_001_472])
@pytest.mark.parametrize("L", [31, 255])
@pytest.mark.parametrize("k", [1, 2])
def test_seg_sum_main_path_shapes(dev, k, L, n):
    """The renewal (k = 2) and the refit's totals (k = 1) at 255 and 31
    leaves, over 2048 rows and over the 1M rows of the main path."""
    vals, idx = _seg_inputs(k, L, n, seed=k * L)
    _check_seg_sum(dev, vals, idx, L)


def test_seg_sum_every_row_in_one_leaf(dev):
    """The hot spot: 1M rows add into one leaf's cells."""
    vals, _ = _seg_inputs(2, 255, 1_001_472)
    idx = torch.full((1_001_472,), 7, dtype=torch.int32)
    a64, ref, _ = _check_seg_sum(dev, vals, idx, 255)
    assert bool((a64[:, :7] == 0).all() and (a64[:, 8:] == 0).all())


def test_seg_sum_values_across_24_binades(dev):
    """Values of either sign from 2^-20 to 2^4: the sums stay within
    2^-20 of the leaf's sum of |v| of the float64 sum."""
    rs = np.random.RandomState(3)
    n, L = 200_001, 31
    vals = (np.sign(rs.randn(2, n)) * 2.0 ** rs.uniform(-20, 4, (2, n))
            ).astype(np.float32)
    idx = rs.randint(-1, L + 1, n).astype(np.int32)
    a64, ref, mag = _check_seg_sum(dev, torch.from_numpy(vals),
                                   torch.from_numpy(idx), L)
    assert bool(((a64 - ref).abs() <= mag * 2.0 ** -20).all())


# ---- hist_round: partition, then a histogram over the kept rows


def _round_case(mode, case, seed=0, oob=0.2):
    """One round's arguments. "first": 8 slots, one used, the root (every
    row) split near its median bin, so about half the rows are kept (the
    slot spans many work items and flushes with atomics). "s48": 48
    slots over 255 leaves, 2 unused, one whose leaf holds no row, one
    whose leaf holds a single row, the rest many; every eighth slot
    decodes an EFB bundle column. "ragged": 3 slots over 5001 rows (a
    partial partition block). A share `oob` of the rows (20% unless
    asked) have zero count (and zero gradient and hessian, as every
    caller masks them). mode "cat" is the int16 mode with every other
    slot categorical."""
    rs = np.random.RandomState(seed)
    n, S, L, G, B = {"first": (200_000, 8, 16, 7, 64),
                     "s48": (200_000, 48, 255, 7, 64),
                     "ragged": (5001, 3, 16, 3, 64)}[case]
    bins = rs.randint(0, B, (G, n)).astype(np.int32)
    cnt = (rs.rand(n) < 1.0 - oob).astype(np.float32)
    if mode == "f32":
        gh = ht.build_gh3(torch.from_numpy(rs.randn(n).astype(np.float32)
                                           * cnt),
                          torch.from_numpy(rs.rand(n).astype(np.float32)
                                           * cnt), torch.from_numpy(cnt))
    else:
        levels = 127 if mode == "int8" else 256
        gh = ht.build_gh8_quant(
            torch.from_numpy(rs.randint(-levels // 2, levels // 2, n)
                             .astype(np.float32) * cnt),
            torch.from_numpy(rs.randint(0, levels, n).astype(np.float32)
                             * cnt), torch.from_numpy(cnt),
            int8_levels=127 if mode == "int8" else 0)
    params = np.zeros((S, 16), np.int32)
    params[:, 1] = rs.randint(0, G, S)
    params[:, 2] = rs.randint(0, B, S)
    params[:, 3] = rs.randint(0, 2, S)
    params[:, 4] = np.where(rs.rand(S) < 0.5, B - 1, -1)
    params[:, 5] = rs.randint(0, 2, S)
    params[:, 6] = L + 1 + np.arange(S)
    params[:, 8] = -1
    if case == "first":
        pleaf = np.zeros(n, np.int32)
        params[:, 0] = -1
        params[0, 0], params[0, 2] = 0, B // 2 - 1
    else:
        pleaf = rs.randint(0, min(L, 200), n).astype(np.int32)
        params[:, 0] = rs.permutation(min(L, 200))[:S]
        if case == "s48":
            params[-2:, 0] = -1  # unused slots
            params[0, 0] = 230  # a leaf with no row
            params[1, 0] = 231  # a leaf with one row
            pleaf[17] = 231
            efb = np.arange(S) % 8 == 3
            params[efb, 7], params[efb, 8], params[efb, 9] = 8, 2, 40
            params[:, 6] = 240 + np.arange(S) % 15
    cat_mask = None
    if mode == "cat":
        params[0::2, 10] = 1
        cat_mask = torch.from_numpy(rs.rand(S, B) < 0.5)
    return (torch.from_numpy(bins), gh, torch.from_numpy(pleaf),
            torch.from_numpy(params), cat_mask, S, B, L)


@pytest.mark.parametrize("case", ["first", "s48", "ragged"])
@pytest.mark.parametrize("mode", ["int16", "int8", "f32", "cat"])
def test_hist_round_kept_rows_bitwise(dev, mode, case):
    """Every mode on a first round (one slot across many work items, the
    atomic flush), a 48-slot round (slots of 0, 1 and many kept rows,
    unused slots, EFB columns) and a ragged one: the histograms and the
    row -> leaf are the plain version's bits on two launches, one
    launch count a call, and the rows each slot's histogram read are
    exactly its smaller child's rows of non-zero count."""
    bins, gh, pleaf, params, cat_mask, S, B, L = _round_case(mode, case)
    quant = mode != "f32"
    kw = dict(quant=quant, levels=127 if mode == "int8" else 256,
              cat_mask=None if cat_mask is None else cat_mask.to(dev))
    args = (bins.to(dev), gh.to(dev), pleaf.to(dev), params.to(dev), S, B,
            L)
    cuda_hist.reset_launch_counts()
    hk, pk = ht.hist_round(*args, **kw)
    kept = cuda_hist._ROUND_SCRATCH[(0, cuda_hist._stream(args[0].device))]
    rows_of = kept["work"][4:4 + S].cpu()  # the layout in hist_round.cu
    hk2, pk2 = ht.hist_round(*args, **kw)
    hp, pp = ht.hist_round_plain(bins, gh, pleaf, params, S, B, quant=quant,
                                 cat_mask=cat_mask)
    assert torch.equal(hk.cpu(), hp) and torch.equal(pk.cpu(), pp)
    assert torch.equal(hk, hk2) and torch.equal(pk, pk2)
    name = {"int16": "hist_round", "cat": "hist_round",
            "int8": "hist_round_int8", "f32": "hist_round_f32"}[mode]
    assert cuda_hist.LAUNCHES[name] == 2
    assert cuda_hist.LAUNCHES["hist_round_cat"] == (2 if mode == "cat"
                                                    else 0)
    _, hslot = ht.round_partition_plain(bins, pleaf, params, S, cat_mask)
    keep = (hslot < S) & (gh[2] != 0)
    want = torch.bincount(hslot[keep].long(), minlength=S)[:S]
    assert torch.equal(rows_of.long(), want)
    if case == "s48":
        assert want[0] == 0 and want[1] <= 1 and want[-2:].sum() == 0
    if case == "first":
        assert int(want[0]) > cuda_hist.ROUND_CHUNK * 8


def _seg_state(dev):
    """The (state, acc) scratch of hist / hist_slots on the current
    stream: zero between calls."""
    bufs = cuda_hist._SEG_SCRATCH[(dev.index or 0, cuda_hist._stream(dev))]
    return bufs["state"], bufs["acc"]


def _seg_items(dev):
    """The work list of the last call: per slot, its items' (first row,
    end row) in order (the layout in csrc/hist.cu seg_bufs); every item
    record names its slot's item count."""
    w = cuda_hist._SEG_SCRATCH[(dev.index or 0, cuda_hist._stream(dev))][
        "work"].cpu()
    n = int(w[0])
    recs = w[4:4 + 4 * n].reshape(n, 4).tolist()
    items = {}
    for r0, r1, s, _ in recs:
        items.setdefault(s, []).append((r0, r1))
    assert all(len(items[s]) == nit for _, _, s, nit in recs)
    return items


def _check_items(items, s, begin, count, plan):
    """Slot s of `count` rows from `begin` has seg_items(count) items of
    at most its rows per item, tiling [begin, begin + count) in order."""
    n, per = cuda_hist.seg_items(count, plan)
    got = items[s]
    assert len(got) == n
    assert got[0][0] == begin and got[-1][1] == begin + count
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(0 <= r1 - r0 <= per for r0, r1 in got)


def _hist_inputs(n, g=7, b=64, seed=0, counts="mask"):
    """f32 channels as build_gh3 makes them: gradient and hessian
    masked by the in-bag count (counts "mask": 0 / 1; "weights": other
    values, whose fixed point fills all three limbs of a cell)."""
    rs = np.random.RandomState(seed)
    bins = torch.from_numpy(rs.randint(0, b, (g, n)).astype(np.int32))
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    if counts == "weights":
        cnt = cnt * rs.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    gh = ht.build_gh3(torch.from_numpy(rs.randn(n).astype(np.float32) * cnt),
                      torch.from_numpy(rs.rand(n).astype(np.float32) * cnt),
                      torch.from_numpy(cnt))
    return bins, gh


@pytest.mark.parametrize("n", [200_000, 200_003])
@pytest.mark.parametrize("seg", ["empty", "one", "2047", "2048", "2049",
                                 "half", "root"])
def test_hist_segments_bitwise(dev, seg, n):
    """Segments of 0 (device bounds, cap 5), 1, 2047, 2048 and 2049 rows,
    N/2 rows and the root, on N % 4 == 0 (16-byte loads) and N % 4 != 0:
    the plain version's bits on two launches, 2 launches counted for 2
    calls, the scratch left zeroed, and the work list the planner's
    (seg_items)."""
    bins, gh = _hist_inputs(n, seed=n % 7)
    begin, count = {"empty": (1001, 0), "one": (77, 1),
                    "2047": (4093, 2047), "2048": (12, 2048),
                    "2049": (n - 2049, 2049), "half": (n // 4, n // 2),
                    "root": (0, n)}[seg]
    bt, gt = bins.to(dev), gh.to(dev)
    cap = 5 if seg == "empty" else count
    args = ((torch.tensor(begin, device=dev), torch.tensor(0, device=dev))
            if seg == "empty" else (begin, count))
    cuda_hist.reset_launch_counts()
    a = ht.histogram(bt, gt, 64, *args, cap=cap)
    b = ht.histogram(bt, gt, 64, *args, cap=cap)
    ref = ht.histogram_plain(bins, gh, 64, begin, count, cap)
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)
    assert cuda_hist.LAUNCHES["hist"] == 2
    _check_items(_seg_items(dev), 0, 0 if seg == "empty" else begin,
                 count, cuda_hist.hist_plan(7, n, cap, 64))
    state, acc = _seg_state(dev)
    assert not state.any() and not acc.any()


@pytest.mark.parametrize("kind", ["host", "int32", "int64", "cap"])
def test_hist_bound_kinds(dev, kind):
    """begin and count as host ints, as 0-dim int32 and int64 tensors on
    the card (the grower's), and a cap above the count (the scale's n is
    the cap): the plain version's bits with the same cap."""
    n = 100_000
    bins, gh = _hist_inputs(n, seed=3)
    begin, count = 31_337, 20_001
    cap = count + 5000 if kind == "cap" else count
    bt, gt = bins.to(dev), gh.to(dev)
    if kind == "host":
        args = (begin, count)
    else:
        dt = torch.int32 if kind == "int32" else torch.int64
        args = (torch.tensor(begin, dtype=dt, device=dev),
                torch.tensor(count, dtype=dt, device=dev))
    a = ht.histogram(bt, gt, 64, *args, cap=cap)
    b = ht.histogram(bt, gt, 64, *args, cap=cap)
    ref = ht.histogram_plain(bins, gh, 64, begin, count, cap)
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)


def _slot_segments(n, S, case, rs):
    """(begins, counts) of S disjoint segments of [0, n) in random slot
    order: "mixed" with empty and one-row slots and one slot spanning
    several items; "grouped" 128 slots tiling half the rows, as a round
    of the exact grower's round phase."""
    if case == "grouped":
        cuts = np.sort(rs.choice(np.arange(1, n // 2), S - 1, replace=False))
        starts = np.concatenate([[0], cuts]) + n // 4
        lens = np.diff(np.concatenate([starts, [n // 4 + n // 2]]))
    else:
        lens = np.zeros(S, np.int64)
        lens[0] = 5 * cuda_hist.SEG_CHUNK + 17  # several items
        lens[1] = lens[2] = 1  # one-row slots
        lens[3:S // 2] = rs.randint(2, 3000, S // 2 - 3)
        # the rest empty
        gaps = rs.randint(0, 50, S)
        starts = np.cumsum(np.concatenate([[0], (lens + gaps)[:-1]]))
        assert starts[-1] + lens[-1] <= n
    perm = rs.permutation(S)
    return (torch.from_numpy(starts[perm].astype(np.int32)),
            torch.from_numpy(lens[perm].astype(np.int32)))


@pytest.mark.parametrize("case,S", [("mixed", 40), ("grouped", 128)])
def test_hist_slots_segments_bitwise(dev, case, S):
    """Empty slots, one-row slots, a slot of several work items (the
    accumulator and its last item's conversion), and 128 slots tiling
    half of a leaf-grouped matrix: the plain version's bits on two
    launches, the work list the planner's, the scratch left zeroed."""
    n = 200_000
    rs = np.random.RandomState(S)
    bins, gh = _hist_inputs(n, seed=S)
    begins, counts = _slot_segments(n, S, case, rs)
    args = (bins.to(dev), gh.to(dev), begins.to(dev), counts.to(dev), 64, S)
    cuda_hist.reset_launch_counts()
    a = ht.hist_slots(*args)
    items = _seg_items(dev)
    b = ht.hist_slots(*args)
    assert cuda_hist.LAUNCHES["hist_slots"] == 2
    ref = ht.hist_slots_plain(bins, gh, begins, counts, 64, S)
    assert torch.equal(a, b) and torch.equal(a.cpu(), ref)
    plan = cuda_hist.hist_slots_plan(7, n, S, 64)
    for s in range(S):
        _check_items(items, s, int(begins[s]) if counts[s] else 0,
                     int(counts[s]), plan)
    if case == "mixed":
        assert max(len(v) for v in items.values()) > 1
    state, acc = _seg_state(dev)
    assert not state.any() and not acc.any()


def test_seg_calls_in_a_row_keep_the_scratch_zeroed(dev):
    """Calls of different shapes one after another on one stream, hist
    and hist_slots mixed, with no reset between them: each the plain
    version's bits, and the scratch zero after all of them."""
    rs = np.random.RandomState(11)
    for i, (n, g, b) in enumerate([(150_000, 7, 64), (9000, 3, 256),
                                   (150_001, 28, 16), (4096, 1, 2),
                                   (150_000, 7, 64)]):
        bins, gh = _hist_inputs(n, g, b, seed=i)
        bt, gt = bins.to(dev), gh.to(dev)
        begin = int(rs.randint(0, n // 2))
        count = int(rs.randint(0, n - begin))
        out = ht.histogram(bt, gt, b, torch.tensor(begin, device=dev),
                           torch.tensor(count, device=dev), cap=count + 3)
        assert torch.equal(out.cpu(), ht.histogram_plain(
            bins, gh, b, begin, count, count + 3))
        S = 1 + i * 31
        begins, counts = _slot_segments(n, S, "grouped", rs) if S > 1 \
            else (torch.tensor([0], dtype=torch.int32),
                  torch.tensor([n], dtype=torch.int32))
        out = ht.hist_slots(bt, gt, begins.to(dev), counts.to(dev), b, S)
        assert torch.equal(out.cpu(), ht.hist_slots_plain(
            bins, gh, begins, counts, b, S))
    state, acc = _seg_state(dev)
    assert not state.any() and not acc.any()


@pytest.mark.parametrize("counts", ["mask", "weights"])
def test_hist_count_values(dev, counts):
    """Counts of 0 and 1 (build_gh3's in-bag mask) and other count values
    (weights): the plain version's bits for hist and hist_slots."""
    n = 100_000
    bins, gh = _hist_inputs(n, seed=5, counts=counts)
    bt, gt = bins.to(dev), gh.to(dev)
    out = ht.histogram(bt, gt, 64, 1000, 60_000)
    assert torch.equal(out.cpu(), ht.histogram_plain(bins, gh, 64, 1000,
                                                     60_000))
    begins = torch.tensor([0, 30_000, 90_000], dtype=torch.int32)
    cnts = torch.tensor([20_000, 50_000, 7], dtype=torch.int32)
    out = ht.hist_slots(bt, gt, begins.to(dev), cnts.to(dev), 64, 3)
    assert torch.equal(out.cpu(), ht.hist_slots_plain(bins, gh, begins,
                                                      cnts, 64, 3))


@pytest.mark.parametrize("n", [65_536 * 64 + 4, 65_536 * 80])
def test_hist_items_of_at_most_65536_rows(dev, n):
    """Past SEG_SLOT_ITEMS x 65536 rows a slot takes more items, so no
    item's 32-bit limbs sum more than 65536 rows: the root of 4.2M and
    5.2M rows of one bin (every row in one cell) against the plain
    version."""
    bins = torch.zeros((1, n), dtype=torch.int32)
    cnt = torch.ones(n)
    gh = ht.build_gh3(torch.full((n,), -0.75), torch.full((n,), 0.25), cnt)
    plan = cuda_hist.hist_plan(1, n, n, 4)
    items, per = cuda_hist.seg_items(n, plan)
    assert per <= cuda_hist.SEG_ITEM_ROWS < -(-n // cuda_hist.SEG_SLOT_ITEMS)
    out = ht.histogram(bins.to(dev), gh.to(dev), 4)
    assert len(_seg_items(dev)[0]) == items
    assert torch.equal(out.cpu(), ht.histogram_plain(bins, gh, 4))


# ---- hist_nat's integer modes (csrc/hist_nat.cu "integer modes")


def _nat_inputs(n, g, b, S, mode, seed=0):
    """Bins in [-2, b + 2) (some outside [0, b), which match no cell),
    slots in [0, S] (S the trash slot), and int32 levels (gradient
    +-128, hessian 0..256, in-bag count) or int8 levels within +-127."""
    rs = np.random.RandomState(seed)
    bins = torch.from_numpy(rs.randint(-2, b + 2, (g, n)).astype(np.int32))
    slot = torch.from_numpy(rs.randint(0, S + 1, n).astype(np.int32))
    cnt = (rs.rand(n) < 0.9).astype(np.int64)
    if mode == "int8":
        gh = ht.build_gh8_quant(
            torch.from_numpy((rs.randint(-63, 64, n) * cnt).astype(np.float32)),
            torch.from_numpy((rs.randint(0, 128, n) * cnt).astype(np.float32)),
            torch.from_numpy(cnt.astype(np.float32)), int8_levels=127)
        assert gh.dtype == torch.int8
    else:
        gh = torch.from_numpy(np.stack([rs.randint(-128, 129, n) * cnt,
                                        rs.randint(0, 257, n) * cnt,
                                        cnt]).astype(np.int32))
    return bins, gh, slot


def _offset(t):
    """A contiguous copy of t on its device whose data starts 4 bytes (or
    1 byte) past a 16-byte boundary: the scalar loads' path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("layout", ["aligned", "ragged", "offset"])
@pytest.mark.parametrize("S", [1, 4, 48, 400])
@pytest.mark.parametrize("mode", ["int32", "int8"])
def test_hist_nat_int_modes_bitwise(dev, mode, S, layout):
    """int32 (the int16 mode) and int8 levels at 1, 4, 48 and 400 slots
    (at 64 bins 400 slots are many slot chunks), with bins outside [0,
    Bc) and rows in the trash slot: the staged path (aligned, N % 16 ==
    0, one slot chunk), N not a multiple of 4 and a view 4 bytes off
    alignment (each lane loads its own rows); two calls give the plain
    version's bits,
    counted as two launches of the mode's kernel."""
    n = 100_003 if layout == "ragged" else 100_000
    bins, gh, slot = _nat_inputs(n, 7, 64, S, mode, seed=S)
    args = [bins.to(dev), gh.to(dev), slot.to(dev)]
    if layout == "offset":
        args = [_offset(x) for x in args]
    plan = cuda_hist.hist_nat_plan(7, n, S, 64, cuda_hist._sm_count(dev),
                                   all(x.data_ptr() % 16 == 0 for x in args),
                                   mode == "int8")
    # the staged path where the rows are aligned and the staged tile holds
    # every slot (at 64 bins up to 2); otherwise each lane loads its own
    assert plan["vec"] == (layout == "aligned" and S <= 2)
    cuda_hist.reset_launch_counts()
    lv = 127 if mode == "int8" else 256
    a = ht.hist_nat_slots(*args, S, 64, levels=lv)
    b = ht.hist_nat_slots(*args, S, 64, levels=lv)
    ref = ht.hist_nat_slots_plain(bins, gh, slot, S, 64)
    assert torch.equal(a.cpu(), ref) and torch.equal(a, b)
    name = "hist_nat_int8" if mode == "int8" else "hist_nat"
    assert cuda_hist.LAUNCHES[name] == 2
    assert sum(cuda_hist.LAUNCHES.values()) == 2


@pytest.mark.parametrize("mode", ["int32", "int8"])
def test_hist_nat_root_shape_bitwise(dev, mode):
    """The training path's root: 1,001,472 rows, 28 columns, 256 bins,
    every row in the one slot but the padding's zero rows; the rows cut
    into one split per block, combined across blocks."""
    n = 1_001_472
    bins, gh, _ = _nat_inputs(n, 28, 255, 1, mode, seed=7)
    bins = bins.clamp(0, 254)
    gh[:, -1472:] = 0
    slot = torch.zeros(n, dtype=torch.int32)
    plan = cuda_hist.hist_nat_plan(28, n, 1, 256, cuda_hist._sm_count(dev),
                                   int8=mode == "int8")
    assert plan["R"] > 1 and plan["vec"]
    bt, gt, st = bins.to(dev), gh.to(dev), slot.to(dev)
    lv = 127 if mode == "int8" else 256
    a = ht.hist_nat_slots(bt, gt, st, 1, 256, levels=lv)
    b = ht.hist_nat_slots(bt, gt, st, 1, 256, levels=lv)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), ht.hist_nat_slots_plain(bins, gh, slot, 1,
                                                        256))


@pytest.mark.parametrize("g,b,S", [(40, 64, 3), (7, 1000, 3), (7, 5000, 2),
                                   (1, 256, 255), (3, 2, 1), (64, 256, 1)])
def test_hist_nat_tile_shapes_bitwise(dev, g, b, S):
    """Tiles of other shapes: more columns than a warp (two column
    groups), 1000 and 5000 bins (fewer positions a cell, columns sharing
    them through the atomics; at 5000 the direct path, the stages not
    fitting beside the tile), one column (32 replicas a warp, the
    refit's shape), 2 bins; both modes, the plain version's bits."""
    for mode in ("int32", "int8"):
        bins, gh, slot = _nat_inputs(50_000, g, b, S, mode, seed=g + b)
        out = ht.hist_nat_slots(bins.to(dev), gh.to(dev), slot.to(dev), S,
                                b, levels=127 if mode == "int8" else 256)
        assert torch.equal(out.cpu(), ht.hist_nat_slots_plain(bins, gh,
                                                              slot, S, b))


def test_hist_nat_calls_in_a_row(dev):
    """Calls of different shapes and modes one after another on one
    stream, sharing the partial tiles' scratch: each the plain version's
    bits."""
    for i, (n, g, b, S, mode) in enumerate([
            (150_000, 7, 64, 1, "int32"), (9000, 28, 256, 4, "int8"),
            (150_001, 40, 16, 48, "int32"), (4096, 1, 2, 1, "int8"),
            (1_001_472, 28, 256, 1, "int8"), (150_000, 7, 64, 1, "int32")]):
        bins, gh, slot = _nat_inputs(n, g, b, S, mode, seed=i)
        out = ht.hist_nat_slots(bins.to(dev), gh.to(dev), slot.to(dev), S,
                                b, levels=127 if mode == "int8" else 256)
        assert torch.equal(out.cpu(), ht.hist_nat_slots_plain(bins, gh,
                                                              slot, S, b))


def test_hist_nat_no_rows(dev):
    """A call without rows gives zeros of the output's shape."""
    bins = torch.zeros((7, 0), dtype=torch.int32, device=dev)
    gh = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    slot = torch.zeros(0, dtype=torch.int32, device=dev)
    out = ht.hist_nat_slots(bins, gh, slot, 4, 64)
    assert out.shape == (4, 3, 7, 64) and not out.any()


OOB = [0.0, 0.2, 0.7, 1.0]


def _bagged_round(mode, oob):
    """The s48 round with a share `oob` of its valid rows out of the bag
    (zero count, zero gradient and hessian), as bagging and GOSS leave
    them; slot 2's leaf holds rows, none of them in the bag, so its
    smaller child keeps no row."""
    bins, gh, pleaf, params, cat_mask, S, B, L = _round_case(mode, "s48",
                                                             oob=oob)
    gh[:, pleaf == params[2, 0]] = 0
    return bins, gh, pleaf, params, cat_mask, S, B, L


def _check_bagged_round(dev, mode, oob):
    bins, gh, pleaf, params, cat_mask, S, B, L = _bagged_round(mode, oob)
    quant = mode != "f32"
    kw = dict(quant=quant, levels=127 if mode == "int8" else 256,
              cat_mask=None if cat_mask is None else cat_mask.to(dev))
    args = (bins.to(dev), gh.to(dev), pleaf.to(dev), params.to(dev), S, B,
            L)
    hk, pk = ht.hist_round(*args, **kw)
    rows_of = cuda_hist._ROUND_SCRATCH[
        (0, cuda_hist._stream(args[0].device))]["work"][4:4 + S].cpu()
    hk2, pk2 = ht.hist_round(*args, **kw)
    hp, pp = ht.hist_round_plain(bins, gh, pleaf, params, S, B, quant=quant,
                                 cat_mask=cat_mask)
    assert torch.equal(hk.cpu(), hp) and torch.equal(hk, hk2)
    # every valid row of a split leaf gets its new leaf, in the bag or not
    assert torch.equal(pk.cpu(), pp) and torch.equal(pk, pk2)
    _, hslot = ht.round_partition_plain(bins, pleaf, params, S, cat_mask)
    keep = (hslot < S) & (gh[2] != 0)
    want = torch.bincount(hslot[keep].long(), minlength=S)[:S]
    assert torch.equal(rows_of.long(), want)
    assert want[2] == 0 and (pleaf == params[2, 0]).any()
    assert not hk[2].any()
    if oob == 1.0:
        assert not hk.any()
    moved = pk.cpu() != pleaf
    assert (moved & (gh[2] == 0)).any()


@pytest.mark.parametrize("oob", OOB)
@pytest.mark.parametrize("mode", ["int16", "int8", "f32", "cat"])
def test_hist_round_out_of_bag_rows_bitwise(dev, mode, oob):
    """A sampled round (bagging, GOSS): valid rows with zero count at 0%,
    20%, 70% and 100% out of the bag. The histograms are the plain
    version's bits on two launches, the kept-row lists count only in-bag
    rows of the smaller children, a slot whose smaller child keeps no row
    gives zeros, and out-of-bag rows of split leaves still move to their
    new leaf."""
    _check_bagged_round(dev, mode, oob)


def _check_bagged_nat(dev, mode, oob, S, n=100_000, g=28, b=256):
    rs = np.random.RandomState(int(oob * 10) + S)
    bins = torch.from_numpy(rs.randint(0, b, (g, n)).astype(np.int32))
    slot = torch.from_numpy(rs.randint(0, S + 1, n).astype(np.int32))
    cnt = (rs.rand(n) < 1.0 - oob).astype(np.float32)
    if mode == "f32":  # the refit's channels: weights * mask
        w = rs.rand(n).astype(np.float32) * cnt
        gh = torch.from_numpy(np.stack([w, w, cnt]))
    else:
        lv = 127 if mode == "int8" else 256
        gh = ht.build_gh8_quant(
            torch.from_numpy(rs.randint(-lv // 2, lv // 2, n)
                             .astype(np.float32) * cnt),
            torch.from_numpy(rs.randint(0, lv, n).astype(np.float32) * cnt),
            torch.from_numpy(cnt), int8_levels=127 if mode == "int8" else 0)
    kw = (dict(quant=False) if mode == "f32"
          else dict(levels=127 if mode == "int8" else 256))
    args = (bins.to(dev), gh.to(dev), slot.to(dev), S, b)
    a = ht.hist_nat_slots(*args, **kw)
    a2 = ht.hist_nat_slots(*args, **kw)
    ref = ht.hist_nat_slots_plain(bins, gh, slot, S, b,
                                  quant=mode != "f32")
    assert torch.equal(a.cpu(), ref) and torch.equal(a, a2)
    assert (not a.any()) == (oob == 1.0)


@pytest.mark.parametrize("S", [1, 48])
@pytest.mark.parametrize("oob", OOB)
@pytest.mark.parametrize("mode", ["int32", "int8", "f32"])
def test_hist_nat_out_of_bag_rows_bitwise(dev, mode, oob, S):
    """hist_nat on sampled channels: the bagged root (S = 1) and 48 slots
    in the integer modes, and the refit's f32 mode on w * mask, at 0%,
    20%, 70% and 100% of the rows out of the bag: the plain version's bits
    on two launches."""
    _check_bagged_nat(dev, mode, oob, S)


def test_sampled_calls_in_a_row(dev):
    """hist_round and hist_nat on sampled inputs one after another on one
    stream, the bag emptying and filling again: each call the plain
    version's bits (the scratch every hist_round call leaves zeroed)."""
    for oob in (0.2, 1.0, 0.0, 0.7, 1.0, 0.2):
        for mode in ("int16", "f32"):
            _check_bagged_round(dev, mode, oob)
        _check_bagged_nat(dev, "int32", oob, 1, n=50_000)


def _eager(env):
    """Keeps train() on the eager loop."""


_eager.before_iteration = True


@pytest.mark.parametrize("extra", [
    {}, {"bagging_fraction": 0.8, "bagging_freq": 1, "feature_fraction": 0.8},
    {"objective": "regression_l1", "metric": "l1"},
], ids=["int16", "bagging", "l1"])
def test_fused_graph_matches_eager_bitwise(dev, extra):
    """The fused loop on the card: the first iteration warms up, the step
    is captured as one CUDA graph (IF nodes over its rounds and
    traversal levels) and replayed; model text, the validation scores
    and the eval records equal the eager loop's (records within 1e-5:
    the eager loop evaluates on the host)."""
    rs = np.random.RandomState(5)
    X = rs.randn(22000, 10).astype(np.float32)
    z = X @ rs.randn(10) + 0.3 * rs.randn(22000)
    y = z if extra.get("objective") else (z > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 63, "metric": "auc",
         "verbosity": -1, **extra}
    out = {}
    for fused in (True, False):
        ds = lgb.Dataset(X[:20000], label=y[:20000], params=p)
        vs = lgb.Dataset(X[20000:], label=y[20000:], reference=ds)
        ev = {}
        bst = lgb.train(p, ds, 6, valid_sets=[vs], valid_names=["v"],
                        callbacks=[lgb.record_evaluation(ev)]
                        + ([] if fused else [_eager]))
        out[fused] = (bst, ev)
    (bf, ef), (be, ee) = out[True], out[False]
    fp = bf._gbdt._fused
    assert fp is not None and fp.graph.captured and fp.graph.replays == 5
    assert bf._gbdt.fused_overflow_count == 0
    assert bf.model_to_string() == be.model_to_string()
    assert torch.equal(bf._gbdt.valids[0].score, be._gbdt.valids[0].score)
    m = list(ee["v"])[0]
    np.testing.assert_allclose(ef["v"][m], ee["v"][m], rtol=1e-5, atol=1e-7)


# ---- lambdarank (csrc/lambdarank.cu) against ranking.lambdarank_plain on
# the card: max |kernel - plain| <= RANK_TOL * max |plain| for g and h. The
# two differ only in the order of their f32 sums (a document's <= cnt pair
# terms, sequential in the kernel, a tree in torch): ~sqrt(cnt) x 2^-24
# relative, 4e-6 at 4,096 documents; RANK_TOL leaves ~10x room.
RANK_TOL = 5e-5


def _rank_inputs(group, dev, scores="random", labels=5, seed=0, pad=37):
    from lightgbm_tpu_torch.learner import ranking

    rs = np.random.RandomState(seed)
    group = np.asarray(group)
    n = int(group.sum())
    npad = n + pad
    lab = np.zeros(npad, np.float32)
    lab[:n] = np.minimum(rs.geometric(0.45, n) - 1, labels - 1)
    if scores == "equal":
        sc = np.zeros(npad, np.float32)
    else:
        sc = rs.randn(npad).astype(np.float32)
        if scores == "ties":
            sc = np.round(sc * 2) / 2
    w = (rs.rand(npad) + 0.5).astype(np.float32)
    lay = ranking.QueryLayout(group, npad)
    gain = ranking.default_label_gain(labels - 1)
    imd = ranking.inverse_max_dcg(lab, lay, gain, 30)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return lay, t(sc), t(lab), t(gain), t(imd), t(w)


def _rank_close(k, p):
    scale = float(p.abs().max())
    err = float((k - p).abs().max())
    assert err <= RANK_TOL * max(scale, 1e-30), (err, scale)


RANK_GROUPS = {
    "one_doc_queries": [1] * 50 + [3, 1, 2],
    "mixed": [7, 3, 12, 1, 5, 120, 64, 2],
    "q908": [908, 5, 120],
    "q4096": [4096, 17],
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("scores", ["random", "equal", "ties"])
@pytest.mark.parametrize("groups", list(RANK_GROUPS))
def test_lambdarank_kernel_matches_plain(dev, groups, scores, norm,
                                         weighted):
    from lightgbm_tpu_torch.learner import cuda_rank, ranking

    lay, sc, lab, gain, imd, w = _rank_inputs(RANK_GROUPS[groups], dev,
                                              scores)
    w = w if weighted else None
    before = cuda_hist.LAUNCHES["lambdarank"]
    gk, hk = ranking.lambdarank(lay, sc, lab, gain, imd, 1.0, 30, norm, w)
    assert cuda_hist.LAUNCHES["lambdarank"] == before + 1
    gp, hp = ranking.lambdarank_plain(lay, sc, lab, gain, imd, 1.0, 30,
                                      norm, w)
    _rank_close(gk, gp)
    _rank_close(hk, hp)
    assert bool((hk >= np.float32(2e-7)).all())
    # the padding rows: g 0, h the floor
    assert bool((gk[lay.num_docs:] == 0).all())
    # a query of one document, or of equal labels, has no pair
    if groups == "one_doc_queries":
        assert bool((gk[:50] == 0).all())
    g2, h2 = cuda_rank.lambdarank(lay, sc, lab, gain, imd, 1.0, 30, norm, w,
                                  hess_floor=False)
    assert torch.equal(g2, gk)
    _rank_close(h2, ranking.lambdarank_plain(lay, sc, lab, gain, imd, 1.0,
                                             30, norm, w, False)[1])


def test_lambdarank_kernel_equal_labels(dev):
    from lightgbm_tpu_torch.learner import ranking

    lay, sc, lab, gain, imd, w = _rank_inputs([9, 40, 3], dev)
    lab = 2.0 * (torch.arange(lab.shape[0], device=dev)
                 < lay.num_docs).to(torch.float32)
    gk, hk = ranking.lambdarank(lay, sc, lab, gain, imd, 1.0, 30, True)
    assert bool((gk == 0).all())
    assert bool((hk == np.float32(2e-7)).all())


def test_lambdarank_kernel_bitwise_across_calls(dev):
    from lightgbm_tpu_torch.learner import ranking

    lay, sc, lab, gain, imd, w = _rank_inputs(
        [908, 120, 4096, 1, 30] * 3, dev, "ties")
    a = ranking.lambdarank(lay, sc, lab, gain, imd, 1.0, 30, True, w)
    b = ranking.lambdarank(lay, sc, lab, gain, imd, 1.0, 30, True, w)
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def test_lambdarank_kernel_refuses_past_shared_memory(dev):
    from lightgbm_tpu_torch.learner import cuda_rank, ranking

    limit = (cuda_hist._MAX_SMEM - cuda_hist._SMEM_STATIC) // 4
    limit = (limit - cuda_rank.RANK_THREADS) // 5
    lay, sc, lab, gain, imd, w = _rank_inputs([limit + 1, 3], dev)
    before = cuda_hist.LAUNCHES["lambdarank"]
    with pytest.raises(ValueError, match="kernel limit"):
        ranking.lambdarank(lay, sc, lab, gain, imd, 1.0, 30, True)
    assert cuda_hist.LAUNCHES["lambdarank"] == before


# ---- serving: the tensorized forest on the card
def _serve_model(cat: bool = True):
    """A 12-tree binary model trained on the CPU (a categorical column
    and NaN missing values), and rows with unseen / negative
    categories."""
    rs = np.random.RandomState(11)
    X = rs.randn(1500, 6)
    X[:, 2] = rs.randint(0, 9, 1500)
    X[rs.rand(1500) < 0.05, 4] = np.nan
    y = (np.nan_to_num(X[:, 0]) + (X[:, 2] % 2) > 0.4).astype(float)
    p = {"objective": "binary", "num_leaves": 23, "verbosity": -1,
         "device_type": "cpu", "min_data_in_leaf": 5}
    ds = lgb.Dataset(X, label=y, params=p,
                     categorical_feature=[2] if cat else "auto")
    bst = lgb.train(p, ds, 12)
    Xq = rs.randn(3000, 6)
    Xq[:, 2] = rs.randint(-2, 14, 3000)
    Xq[rs.rand(3000) < 0.05, 4] = np.nan
    return bst, Xq


def test_forest_card_matches_cpu(dev):
    """The forest's gathers (take_small), decisions, leaf gather and
    fixed-order class sums give the CPU's bits; leaves exactly."""
    from lightgbm_tpu_torch.serving import TensorForest

    bst, Xq = _serve_model()
    fc = TensorForest.from_booster(bst, device=dev)
    fh = TensorForest.from_booster(bst, device="cpu")
    assert fc.meta["has_cat"]
    before = cuda_hist.LAUNCHES["take_small"]
    raw = fc.predict_raw(Xq, 1, 8)
    assert cuda_hist.LAUNCHES["take_small"] - before == fc.levels
    np.testing.assert_array_equal(raw, fh.predict_raw(Xq, 1, 8))
    np.testing.assert_array_equal(fc.predict_leaf(Xq), fh.predict_leaf(Xq))
    np.testing.assert_allclose(raw, bst._gbdt.predict_raw(Xq, 1, 8),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        bst.predict(Xq, device="cuda", pred_leaf=True),
        bst.predict(Xq, pred_leaf=True))
    np.testing.assert_allclose(fc.predict_contrib(Xq[:200]),
                               fh.predict_contrib(Xq[:200]),
                               rtol=1e-5, atol=1e-5)


def test_take_small_k9_unstaged_bitwise(dev):
    """The forest's gather: k = 9 (the generic path) on a table of 500
    trees x 254 nodes, far past the 48 KB shared-memory stage, indices
    in and out of range."""
    rs = np.random.RandomState(9)
    L = 500 * 254
    tab = torch.from_numpy(rs.randn(9, L).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-3, L + 3, 409_600).astype(np.int32))
    out = ht.take_cols(tab.to(dev), idx.to(dev))
    assert torch.equal(out.cpu(), ht.take_cols_plain(tab, idx))
    assert torch.equal(ht.take_cols(tab.to(dev), idx.to(dev)), out)


def _node_rows(rs, L):
    """An (L, 16) node-major table: k = 9 fields (with -0.0, NaN and
    infinities), junk in the padding columns."""
    tab = np.full((L, 16), 7.5, np.float32)
    tab[:, :9] = rs.randn(L, 9)
    tab[:4, 0] = [-0.0, np.nan, np.inf, -np.inf]
    return torch.from_numpy(tab)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def test_take_rows_serving_shape_bitwise(dev):
    """The forest's gather at the serving shape: 500 trees x 254 nodes,
    one level of a 4096-row rung (2,048,000 lanes), indices in and out
    of range; bitwise the plain version's and across launches, one
    launch a call."""
    rs = np.random.RandomState(16)
    L = 500 * 254
    tab = _node_rows(rs, L)
    idx = torch.from_numpy(rs.randint(-3, L + 3, 4096 * 500)
                           .astype(np.int32))
    td, xd = tab.to(dev), idx.to(dev)
    before = cuda_hist.LAUNCHES["take_small"]
    out = ht.take_rows(td, xd, 9)
    assert cuda_hist.LAUNCHES["take_small"] - before == 1
    assert out.shape == (9, idx.shape[0]) and out.is_cuda
    assert _same_bits(out.cpu(), ht.take_rows_plain(tab, idx, 9))
    assert _same_bits(ht.take_rows(td, xd, 9), out)


@pytest.mark.parametrize("n", [1, 3, 5, 1027, 4099, 100_001])
@pytest.mark.parametrize("k", [1, 9, 16])
@pytest.mark.parametrize("idx_offset", [0, 1, 3])
def test_take_rows_ragged_and_misaligned(dev, n, k, idx_offset):
    """Ragged N (output rows j * N off 16 bytes), idx views 4 and 12
    bytes off alignment (the scalar loads), k below and at the record
    width; a small table (past no stage: take_rows has none)."""
    rs = np.random.RandomState(n + k)
    L = 700
    tab = _node_rows(rs, L)
    full = torch.from_numpy(rs.randint(-2, L + 2, n + idx_offset)
                            .astype(np.int32))
    xd = full.to(dev)[idx_offset:]
    assert (xd.data_ptr() % 16 == 0) == (idx_offset == 0)
    out = ht.take_rows(tab.to(dev), xd, k)
    assert _same_bits(out.cpu(), ht.take_rows_plain(tab, full[idx_offset:],
                                                    k))


def test_take_rows_refuses_a_misaligned_table(dev):
    """A table 4 bytes off 16-byte alignment raises, and nothing is
    launched or counted."""
    tab = torch.zeros(64 * 16 + 1, device=dev)[1:].view(64, 16)
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    before = cuda_hist.LAUNCHES["take_small"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ht.take_rows(tab, idx, 9)
    with pytest.raises(ValueError, match="record of 10"):
        ht.take_rows(torch.zeros((64, 10), device=dev), idx, 9)
    assert cuda_hist.LAUNCHES["take_small"] == before


def test_fleet_card_scores_a_paged_tenant_as_its_own_forest(dev):
    """Three tenants (cuts of one model) through a fleet that holds two
    on the card: every answer, including a tenant paged back in after
    an eviction, is the bits of the tenant's own TensorForest on the
    card; the stack holds node records (PACK_WIDTH floats a node)."""
    from lightgbm_tpu_torch.serving import ModelFleet, TensorForest
    from lightgbm_tpu_torch.serving.forest import PACK_WIDTH

    bst, Xq = _serve_model()
    texts = {f"cut{i}": bst.model_to_string(num_iteration=c)
             for i, c in enumerate((9, 10, 12))}
    own = {n: TensorForest.from_booster(lgb.Booster(model_str=t),
                                        device=dev)
           for n, t in texts.items()}
    fleet = ModelFleet(buckets=(16, 64), capacity=2, slots_per_family=2,
                       device=dev)
    try:
        for n, t in texts.items():
            fleet.load(n, t)
        for n in ("cut0", "cut1", "cut2", "cut0", "cut2"):
            got = fleet.predict(n, Xq[:40], raw_score=True)
            np.testing.assert_array_equal(
                np.asarray(got).reshape(-1),
                own[n].predict_raw(Xq[:40])[0])
        fs = fleet.fleet_stats()
        assert fs["pages_in"] > len(texts) and fs["evictions"] > 0
        st, = fleet._stacks[fleet._names["cut0"]["versions"][0].family]
        assert st.tables["pack"].shape[1] == PACK_WIDTH
        assert st.tables["pack"].is_contiguous()
    finally:
        fleet.close()


def test_dispatcher_one_capture_per_bucket(dev):
    """100 mixed-size requests (empty, one row, past the top rung): one
    CUDA graph per rung, each answer the unbucketed forest's bits, and
    warm-up leaves nothing to capture later."""
    from lightgbm_tpu_torch.serving import BucketDispatcher, TensorForest

    bst, Xq = _serve_model()
    f = TensorForest.from_booster(bst, device=dev)
    tw = torch.ones(f.num_trees, device=dev)
    score, leaf = f.apply(torch.from_numpy(Xq.astype(np.float32)).to(dev),
                          tw)
    score = score.cpu().numpy().T.astype(np.float64)
    leaf = leaf.cpu().numpy().astype(np.int64)
    buckets = (16, 64, 256)
    disp = BucketDispatcher(f, buckets=buckets)
    rs = np.random.RandomState(4)
    sizes = [int(s) for s in rs.randint(1, 300, 94)] + [0, 1, 256, 257,
                                                        549, 0]
    for n in sizes:
        lo = int(rs.randint(0, len(Xq) - n + 1))
        np.testing.assert_array_equal(disp.score_raw(Xq[lo:lo + n]),
                                      score[:, lo:lo + n])
        np.testing.assert_array_equal(disp.predict_leaf(Xq[lo:lo + n]),
                                      leaf[lo:lo + n])
    assert disp.captures == len(buckets) == len(disp.programs)
    assert all(n > 0 for n in disp.graph_nodes().values())
    warm = BucketDispatcher(f, buckets=buckets)
    warm.warmup(num_features=6)
    assert warm.captures == len(buckets)
    for n in sizes[:30]:
        np.testing.assert_array_equal(warm.score_raw(Xq[:n], 2, 5),
                                      disp.score_raw(Xq[:n], 2, 5))
    assert warm.captures == len(buckets)


def test_graph_dies_during_another_capture(dev):
    """A graph dropped in one thread while another thread captures (a
    client's collection, or an unload, while a serving worker captures):
    its memory pool is parked until no capture is under way, and the
    process goes on (torch's allocator aborts when a pool is emptied
    during a capture); the capture that was under way replays right."""
    import threading

    from lightgbm_tpu_torch.learner import device_loop
    from lightgbm_tpu_torch.learner.device_loop import CudaGraph

    x = torch.ones(1 << 20, device=dev)
    old = CudaGraph(dev)
    old.capture(lambda _loop: x.mul(2.0))  # its output lives in old.pool
    inside, release = threading.Event(), threading.Event()
    new, out = CudaGraph(dev), []

    def body(_loop):
        out.append(x.add(1.0))
        inside.set()
        release.wait(30)

    t = threading.Thread(target=new.capture, args=(body,))
    t.start()
    assert inside.wait(30)
    del old  # dies here, while `new` captures in the other thread
    parked = len(device_loop._parked_pools)
    release.set()
    t.join(60)
    assert not t.is_alive() and new.captured
    assert parked == 1 and not device_loop._parked_pools
    new.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(out[0], torch.full_like(x, 2.0))


def test_replicas_capture_at_first_use_under_load(dev):
    """Two replicas with no warm-up behind the MicroBatcher, fed by 8
    threads: each replica captures its rungs from its own worker thread
    while the other scores, and every answer is the CPU forest's bits."""
    import threading

    from lightgbm_tpu_torch.serving import ModelRegistry, TensorForest

    bst, Xq = _serve_model()
    want = TensorForest.from_booster(bst, device="cpu").predict_raw(Xq)[0]
    reg = ModelRegistry(replicas=2, buckets=(16, 64, 256))
    reg.load("m", bst)
    mb = reg.batcher("m")
    got = {}

    def client(c):
        futs = [(i, mb.submit(Xq[i:i + 1 + i % 5]))
                for i in range(c, 1500, 8)]
        for i, f in futs:
            got[i] = f.result(timeout=60)[:, 0]

    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    for i, v in got.items():
        np.testing.assert_array_equal(v, want[i:i + 1 + i % 5])
    mv = reg._entry("m")
    assert all(d.captures <= 3 for d in mv.replicas)
    assert sum(d.captures for d in mv.replicas) > 0
    reg.unload("m")


# ---- the Python API on the card: cv, subset, rollback, sparse and file
# inputs
def _api_data(n=2000, f=8, seed=11):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f).astype(np.float32)
    y = (X @ rs.randn(f) + 0.5 * rs.randn(n) > 0).astype(float)
    return X, y


API_PARAMS = {"objective": "binary", "num_leaves": 31, "metric": "auc",
              "min_data_in_leaf": 5, "verbosity": -1}


def test_cv_fused_equals_eager_on_the_card(dev):
    """Every fold's CUDA graph against the eager per-fold loop: the same
    model text and validation scores bit for bit, results within 1e-5 (the
    fused loop's device metrics against the host's)."""
    X, y = _api_data()
    out = {}
    for fused in (True, False):
        ds = lgb.Dataset(X, label=y, free_raw_data=False)
        out[fused] = lgb.cv(API_PARAMS, ds, 4, nfold=3,
                            return_cvbooster=True,
                            callbacks=[] if fused else [_eager])
    bf, be = (out[f]["cvbooster"].boosters for f in (True, False))
    assert any(b.train_set.num_data() % 16 for b in bf)
    for a, b in zip(bf, be):
        fp = a._gbdt._fused
        assert fp is not None and fp.graph.captured
        assert a.model_to_string() == b.model_to_string()
        assert torch.equal(a._gbdt.valids[0].score, b._gbdt.valids[0].score)
    np.testing.assert_allclose(out[True]["valid auc-mean"],
                               out[False]["valid auc-mean"], rtol=1e-5)


def test_subset_of_2003_rows_trains_as_the_cpu(dev):
    X, y = _api_data(n=3000)
    idx = np.arange(2003)
    preds = []
    for device in ("cuda", "cpu"):
        p = {**API_PARAMS, "device_type": device}
        ds = lgb.Dataset(X, label=y, params=p).construct()
        bst = lgb.train(p, ds.subset(idx), 5)
        preds.append(bst.predict(X[2003:], raw_score=True))
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-4)


def test_rollback_one_iter_on_the_card(dev):
    X, y = _api_data()
    ds = lgb.Dataset(X[:1500], label=y[:1500])
    vs = lgb.Dataset(X[1500:], label=y[1500:], reference=ds)
    bst = lgb.train(API_PARAMS, ds, 5, valid_sets=[vs])
    ref = lgb.train(API_PARAMS, ds, 4, valid_sets=[vs],
                    callbacks=[_eager])
    bst.rollback_one_iter()
    assert bst.current_iteration() == 4 and bst.num_trees() == 4
    assert len(bst._gbdt.device_trees) == 4
    np.testing.assert_allclose(bst._gbdt.valids[0].score.cpu().numpy(),
                               ref._gbdt.valids[0].score.cpu().numpy(),
                               atol=1e-6)


def test_csr_and_csv_inputs_train_on_the_card(dev, tmp_path):
    import scipy.sparse as sparse

    X, y = _api_data()
    X[np.abs(X) < 0.8] = 0.0
    dense = lgb.train(API_PARAMS, lgb.Dataset(X, label=y), 4)
    csr = lgb.train(API_PARAMS, lgb.Dataset(sparse.csr_matrix(X), label=y), 4)
    path = tmp_path / "d.csv"
    np.savetxt(path, np.column_stack([y, X.astype(np.float64)]),
               delimiter=",", fmt="%.17g")
    csv = lgb.train(API_PARAMS, lgb.Dataset(str(path)), 4)
    assert csv.model_to_string() == dense.model_to_string()
    np.testing.assert_allclose(csr.predict(X), dense.predict(X), atol=1e-5)
    assert csr._gbdt.device.type == "cuda"


# ---- DART, RF, the per-node extras and forced splits on the card
MODE_EXTRA_CASES = {
    "dart": {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.2},
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
           "feature_fraction": 0.8},
    "extras": {"extra_trees": True, "feature_fraction_bynode": 0.5,
               "interaction_constraints": "[0,1,2,3,4],[5,6,7,8,9]",
               "cegb_penalty_split": 1e-4,
               "cegb_penalty_feature_lazy": [2e-4] * 10},
    "coupled": {"cegb_penalty_feature_coupled": [0.5] * 10},
    "forced": {"forcedsplits_filename": None},
    "exact_extras": {"tpu_growth_mode": "exact", "extra_trees": True,
                     "feature_fraction_bynode": 0.5,
                     "interaction_constraints": "[0,1,2,3,4],[5,6,7,8,9]"},
}
FORCED_PLAN = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": 0.0},
               "right": {"feature": 2, "threshold": 0.0}}


def _mode_extra_params(case, tmp_path):
    extra = dict(MODE_EXTRA_CASES[case])
    if "forcedsplits_filename" in extra:
        import json

        path = tmp_path / "forced.json"
        path.write_text(json.dumps(FORCED_PLAN))
        extra["forcedsplits_filename"] = str(path)
    return {"objective": "binary", "num_leaves": 31, "verbosity": -1,
            **extra}


@pytest.mark.parametrize("case", list(MODE_EXTRA_CASES))
def test_boosting_modes_and_extras_card_match_cpu(dev, case, tmp_path):
    """5 iterations on 6,000 rows on the card and on the CPU: raw
    predictions within 1e-4."""
    rs = np.random.RandomState(9)
    X = rs.randn(7000, 10).astype(np.float32)
    y = (X @ rs.randn(10) + 0.3 * rs.randn(7000) > 0).astype(float)
    preds = []
    for device in ("cuda", "cpu"):
        p = {**_mode_extra_params(case, tmp_path), "device_type": device}
        bst = lgb.train(p, lgb.Dataset(X[:6000], label=y[:6000], params=p),
                        5)
        preds.append(bst.predict(X[6000:], raw_score=True))
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-4)


@pytest.mark.parametrize("case", ["extras", "forced"])
def test_extras_fused_graph_matches_eager_bitwise(dev, case, tmp_path):
    """The per-node extras and a forced plan inside the captured CUDA
    graph: model text and validation scores equal the eager loop's."""
    rs = np.random.RandomState(5)
    X = rs.randn(22000, 10).astype(np.float32)
    y = (X @ rs.randn(10) + 0.3 * rs.randn(22000) > 0).astype(float)
    p = {**_mode_extra_params(case, tmp_path), "metric": "auc"}
    out = {}
    for fused in (True, False):
        ds = lgb.Dataset(X[:20000], label=y[:20000], params=p)
        vs = lgb.Dataset(X[20000:], label=y[20000:], reference=ds)
        out[fused] = lgb.train(p, ds, 5, valid_sets=[vs],
                               callbacks=[] if fused else [_eager])
    bf, be = out[True], out[False]
    fp = bf._gbdt._fused
    assert fp is not None and fp.graph.captured and fp.graph.replays == 4
    assert bf.model_to_string() == be.model_to_string()
    assert torch.equal(bf._gbdt.valids[0].score, be._gbdt.valids[0].score)


# ---- monotone intermediate / advanced and linear trees on the card
MONO_LINEAR_CASES = {
    "intermediate": {"monotone_constraints": [1, -1, 0, 1, 0, -1, 0, 0, 0,
                                              0],
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": [1, -1, 0, 1, 0, -1, 0, 0, 0, 0],
                 "monotone_constraints_method": "advanced"},
    "exact_intermediate": {"tpu_growth_mode": "exact",
                           "monotone_constraints": [1, -1, 0, 1, 0, -1, 0,
                                                    0, 0, 0],
                           "monotone_constraints_method": "intermediate"},
    "linear": {"linear_tree": True, "linear_lambda": 0.1},
}


@pytest.mark.parametrize("case", list(MONO_LINEAR_CASES))
def test_mono_and_linear_card_match_cpu(dev, case):
    """5 iterations on 6,000 rows on the card and on the CPU: raw
    predictions within 1e-4; linear trees' device predict within 1e-5 of
    the host walker's."""
    rs = np.random.RandomState(9)
    X = rs.randn(7000, 10).astype(np.float32)
    y = (X @ rs.randn(10) + 0.3 * rs.randn(7000) > 0).astype(float)
    preds = []
    for device in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
             **MONO_LINEAR_CASES[case], "device_type": device}
        bst = lgb.train(p, lgb.Dataset(X[:6000], label=y[:6000], params=p),
                        5)
        preds.append(bst.predict(X[6000:], raw_score=True))
        if device == "cuda" and case == "linear":
            np.testing.assert_allclose(
                bst.predict(X[6000:], raw_score=True, device="cuda"),
                preds[0], atol=1e-5)
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-4)


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_mono_fused_graph_matches_eager_bitwise(dev, method):
    """The conflict guard, the bounds' tables and the re-search inside the
    captured CUDA graph: model text, validation scores and the deferred
    count equal the eager loop's."""
    rs = np.random.RandomState(5)
    X = rs.randn(22000, 10).astype(np.float32)
    y = (X @ rs.randn(10) + 0.3 * rs.randn(22000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 63, "verbosity": -1,
         "metric": "auc", **MONO_LINEAR_CASES[method]}
    out = {}
    for fused in (True, False):
        ds = lgb.Dataset(X[:20000], label=y[:20000], params=p)
        vs = lgb.Dataset(X[20000:], label=y[20000:], reference=ds)
        out[fused] = lgb.train(p, ds, 5, valid_sets=[vs],
                               callbacks=[] if fused else [_eager])
    bf, be = out[True], out[False]
    fp = bf._gbdt._fused
    assert fp is not None and fp.graph.captured and fp.graph.replays == 4
    assert bf._gbdt.fused_overflow_count == 0
    assert bf.model_to_string() == be.model_to_string()
    assert torch.equal(bf._gbdt.valids[0].score, be._gbdt.valids[0].score)
    assert int(be._gbdt.mono_deferred) > 0


# ---- the exact grower's fused loop: its split steps (each partition on
# the segment-capacity ladder, IF nodes on the device's segment size),
# its round phase and monotone intermediate inside the captured graph
EXACT_CASES = {
    "exact": {"tpu_growth_mode": "exact"},
    "exact_rounds": {"tpu_growth_mode": "exact", "tpu_growth_rounds": True},
    "exact_mono": {"tpu_growth_mode": "exact",
                   "monotone_constraints": [1, -1, 0, 1, 0, 0, 0, 0, 0, 0],
                   "monotone_constraints_method": "intermediate"},
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_exact_fused_graph_matches_eager_bitwise(dev, case, monkeypatch):
    """The exact grower in one CUDA graph an iteration: the graph holds
    hist (and hist_slots with the round phase), the capture allocates no
    kernel scratch (the warm-up iteration sized it), and its model text
    and validation scores equal the eager loop's."""
    from lightgbm_tpu_torch.learner import device_loop

    capture = device_loop.CudaGraph.capture
    scratch = []

    def ptrs():
        return {k: {n: t.data_ptr() for n, t in b.items()}
                for k, b in cuda_hist._SEG_SCRATCH.items()}

    def watched(self, fn):
        before = ptrs()
        capture(self, fn)
        scratch.append((before, ptrs()))

    monkeypatch.setattr(device_loop.CudaGraph, "capture", watched)
    rs = np.random.RandomState(5)
    X = rs.randn(22000, 10).astype(np.float32)
    y = (X @ rs.randn(10) + 0.3 * rs.randn(22000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 63, "verbosity": -1,
         "metric": "auc", **EXACT_CASES[case]}
    out = {}
    for fused in (True, False):
        ds = lgb.Dataset(X[:20000], label=y[:20000], params=p)
        vs = lgb.Dataset(X[20000:], label=y[20000:], reference=ds)
        out[fused] = lgb.train(p, ds, 5, valid_sets=[vs],
                               callbacks=[] if fused else [_eager])
    bf, be = out[True], out[False]
    fp = bf._gbdt._fused
    assert fp is not None and fp.graph.captured and fp.graph.replays == 4
    assert bf._gbdt.fused_overflow_count == 0
    assert fp.captured_launches.get("hist", 0) > 0
    assert (fp.captured_launches.get("hist_slots", 0) > 0) == \
        (case == "exact_rounds")
    (before, after), = scratch
    assert before and before == after
    assert bf.model_to_string() == be.model_to_string()
    assert torch.equal(bf._gbdt.valids[0].score, be._gbdt.valids[0].score)


def test_fleet_card_matches_cpu(dev):
    """Five tenants in two shape families paged through a fleet of three
    slots on the card and on the CPU: the same scores (within 1e-5; the
    same bits), the same leaves, one CUDA graph a family stack and rung
    however many page-ins, and a tenant moved to another slot scores the
    same bits."""
    from lightgbm_tpu_torch.serving import ModelFleet

    bst, Xq = _serve_model()
    texts = {"cat": bst.model_to_string()}
    for i, cut in enumerate((3, 5, 9, 12)):
        texts[f"cut{i}"] = bst.model_to_string(num_iteration=cut)
    buckets = (16, 64)
    fleets = {d: ModelFleet(buckets=buckets, capacity=3,
                            slots_per_family=4, device=d)
              for d in (dev, "cpu")}
    for f in fleets.values():
        for name, text in texts.items():
            f.load(name, text)
    Xr = Xq[:50]
    try:
        first = {}
        for sweep in range(3):
            for name in texts:
                n = 10 if sweep == 1 else 50
                got = fleets[dev].predict(name, Xr[:n], raw_score=True)
                want = fleets["cpu"].predict(name, Xr[:n], raw_score=True)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                np.testing.assert_array_equal(got, want)
                if sweep != 1:
                    first.setdefault(name, got)
                    np.testing.assert_array_equal(got, first[name])
        fs = fleets[dev].fleet_stats()
        assert fs["pages_in"] > len(texts) and fs["evictions"] > 0
        fams = len(fs["families"])
        assert fams >= 2 and fs["stacks"] == fams
        assert fleets[dev].captures() == fams * len(buckets)
        np.testing.assert_array_equal(
            fleets[dev].predict("cat", Xr, pred_leaf=True),
            fleets["cpu"].predict("cat", Xr, pred_leaf=True))
    finally:
        for f in fleets.values():
            f.close()


# ---- the recovery layer on the card (ROADMAP A.7, A.11 first half)
def _resume_data():
    rs = np.random.RandomState(11)
    X = rs.randn(3000, 8)
    y = ((X @ rs.randn(8) + 0.3 * rs.randn(3000)) > 0).astype(float)
    return X[:2500], y[:2500], X[2500:], y[2500:]


def _eager_cb(env):
    """Keeps train() on the eager loop."""


_eager_cb.before_iteration = True


def _card_train(d, monkeypatch, plan=None, fused=True, **extra):
    from lightgbm_tpu_torch.resilience import faultinject

    monkeypatch.chdir(d)
    if plan:
        monkeypatch.setenv(faultinject.ENV_VAR, plan)
    else:
        monkeypatch.delenv(faultinject.ENV_VAR, raising=False)
    X, y, Xv, yv = _resume_data()
    p = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5,
         "bagging_fraction": 0.7, "bagging_freq": 1, "snapshot_freq": 5,
         "resume": "auto", "output_model": "model.txt",
         "metric": "binary_logloss", "verbosity": -1, **extra}
    ds = lgb.Dataset(X, label=y, params=p)
    vs = lgb.Dataset(Xv, label=yv, reference=ds)
    return lgb.train(p, ds, 10, valid_sets=[vs], valid_names=["v"],
                     callbacks=[] if fused else [_eager_cb])


@pytest.mark.parametrize("loop", ["fused", "eager"])
def test_resume_bitwise_on_card(dev, tmp_path, monkeypatch, loop):
    """A crash at round 7 (checkpoint at 5), then resume=auto: the model
    text is bit for bit an uninterrupted run's, on the card."""
    from lightgbm_tpu_torch.resilience.errors import InjectedFault

    fused = loop == "fused"
    for d in ("crashed", "clean"):
        (tmp_path / d).mkdir()
    with pytest.raises(InjectedFault):
        _card_train(tmp_path / "crashed", monkeypatch, "round:7:raise",
                    fused)
    resumed = _card_train(tmp_path / "crashed", monkeypatch, fused=fused)
    whole = _card_train(tmp_path / "clean", monkeypatch, fused=fused)
    assert (resumed._gbdt._fused is not None) == fused
    assert resumed.model_to_string() == whole.model_to_string()


def test_fused_records_equal_eager_on_card(dev, tmp_path, monkeypatch):
    """The gh norms the captured step writes after its evaluations are the
    eager loop's bits; so is every other recorded value but the timings
    and the evaluations (device f32 metrics against host metrics)."""
    from lightgbm_tpu_torch.obs.recorder import read_stream

    recs = {}
    for loop in ("fused", "eager"):
        (tmp_path / loop).mkdir()
        _card_train(tmp_path / loop, monkeypatch, fused=loop == "fused",
                    snapshot_freq=-1, resume="off", record_file="r.jsonl")
        recs[loop] = read_stream(str(tmp_path / loop / "r.jsonl"))
    timing = {"t_unix", "phases", "chunk_phases", "trees_per_sec"}
    assert len(recs["fused"]) == len(recs["eager"]) == 10
    for a, b in zip(recs["fused"], recs["eager"]):
        assert set(a) - {"chunk_phases"} == set(b)
        for k in set(a) - timing - {"evals"}:
            assert a[k] == b[k], k
        for k in a["evals"]:
            assert abs(a["evals"][k] - b["evals"][k]) <= 1e-6


def test_device_put_fault_answered_by_host_fallback(dev):
    """A registry on the card with host_fallback: a faulted device call is
    answered by the host walker within 1e-5 of the card's answer and
    counted; a registry without it raises the fault."""
    from lightgbm_tpu_torch.obs.metrics import default_registry
    from lightgbm_tpu_torch.resilience import faultinject
    from lightgbm_tpu_torch.resilience.errors import InjectedFault
    from lightgbm_tpu_torch.serving import ModelRegistry

    bst, Xq = _serve_model()
    text = bst.model_to_string()
    reg = ModelRegistry(buckets=(16, 64), warmup=True, host_fallback=True)
    reg.load("m", text)
    want = reg.predict("m", Xq[:40], raw_score=True)
    before = sum(default_registry().snapshot().get(
        "lgbmtpu_serve_host_fallback_total", {}).values())
    try:
        faultinject.arm("device_put:1:raise")
        got = reg.predict("m", Xq[:40], raw_score=True)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        after = sum(default_registry().snapshot()[
            "lgbmtpu_serve_host_fallback_total"].values())
        assert after == before + 1
        plain = ModelRegistry(buckets=(16, 64))
        plain.load("m", text)
        faultinject.arm("device_put:1:raise")
        with pytest.raises(InjectedFault):
            plain.predict("m", Xq[:3])
    finally:
        faultinject.disarm()


def test_replay_error_propagates_despite_host_fallback(dev, monkeypatch):
    """A CUDA error from a graph's replay is never answered on the host:
    with host_fallback=True it propagates, the fallback counter stays,
    and the registry keeps the error (/readyz: not ready)."""
    from lightgbm_tpu_torch.learner.device_loop import CudaGraph
    from lightgbm_tpu_torch.obs.metrics import default_registry
    from lightgbm_tpu_torch.serving import ModelRegistry
    from lightgbm_tpu_torch.serving.server import readiness

    bst, Xq = _serve_model()
    reg = ModelRegistry(buckets=(16, 64), warmup=True, host_fallback=True)
    reg.load("m", bst.model_to_string())
    reg.predict("m", Xq[:40], raw_score=True)
    count = lambda: sum(default_registry().snapshot().get(
        "lgbmtpu_serve_host_fallback_total", {}).values())
    before = count()

    def replay(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(CudaGraph, "replay", replay)
    with pytest.raises(RuntimeError, match="illegal memory"):
        reg.predict("m", Xq[:40], raw_score=True)
    assert count() == before
    assert "illegal memory" in reg.device_faults()["m:v1"]
    assert readiness(reg)["reason"] == "device fault"


def test_native_library_loaded(dev):
    from lightgbm_tpu_torch import native

    assert native.get_lib() is not None, native.BUILD_ERROR
    assert native.library_path().exists()


# ---- the online loop and the gateway on the card (ROADMAP A.11, second
# half)
def _loop_rows(seed, n):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 4)
    return X, (X[:, 0] + X[:, 1] > 0).astype(np.float64)


def test_loop_promotion_on_card_under_scoring(dev, tmp_path):
    """A cycle on the card (the refit on the fused loop, the gate's
    margins and metrics on the card) while two threads score through
    the card registry: every answer v0's or v1's within 1e-5, none torn;
    v0 a bit-exact prefix; a restart after a raise at loop_refit serves
    the promoted bits; a replayed refit writes the same candidate text."""
    import threading

    from lightgbm_tpu_torch import online
    from lightgbm_tpu_torch.resilience import faultinject
    from lightgbm_tpu_torch.resilience.errors import InjectedFault
    from lightgbm_tpu_torch.serving import ModelRegistry

    core = {"objective": "binary", "metric": "auc", "num_leaves": 7,
            "min_data_in_leaf": 5, "learning_rate": 0.2, "verbosity": -1,
            "seed": 7}
    X, y = _loop_rows(5, 300)
    v0 = lgb.train({**core, "device_type": "cpu"},
                   lgb.Dataset(X, label=y, params={"device_type": "cpu"}), 6)
    params = {**core, "loop_dir": str(tmp_path / "loop"),
              "loop_min_rows": 64, "loop_rounds": 4}
    hold = _loop_rows(9, 200)
    loop = online.OnlineLoop(params, hold, initial_model=v0)
    reg = ModelRegistry(buckets=(16, 64), warmup=True)
    loop.attach(reg)
    Xb, yb = _loop_rows(43, 160)
    loop.spool.append(Xb.tolist(), yb.tolist())
    probe = hold[0][:16]
    stop, seen, errs = threading.Event(), [], []

    def scorer():
        try:
            while not stop.is_set():
                seen.append(np.asarray(reg.predict("default", probe,
                                                   raw_score=True)))
        except Exception as e:  # noqa: BLE001 — shown below
            errs.append(e)

    ths = [threading.Thread(target=scorer) for _ in range(2)]
    for t in ths:
        t.start()
    try:
        assert loop.cycle() == "promoted"
    finally:
        stop.set()
        for t in ths:
            t.join(timeout=60)
    assert not errs and seen
    assert loop.last_cycle["refit_capture_s"] is not None
    v1 = lgb.Booster(model_file=loop.state["model_path"])
    p0, p1 = (b.predict(probe, raw_score=True) for b in (v0, v1))
    torn = [p for p in seen if not (np.abs(p - p0).max() < 1e-5
                                    or np.abs(p - p1).max() < 1e-5)]
    assert not torn
    np.testing.assert_array_equal(
        v1.predict(hold[0], raw_score=True, num_iteration=6),
        v0.predict(hold[0], raw_score=True))
    served = reg.predict("default", probe, raw_score=True)
    # a raise at the next refit, then a restart on the same directory
    Xc, yc = _loop_rows(44, 160)
    loop.spool.append(Xc.tolist(), yc.tolist())
    plan = "loop_refit:1:raise"
    faultinject.configure(plan)
    try:
        crash = online.OnlineLoop(dict(params, fault_plan=plan), hold)
        with pytest.raises(InjectedFault):
            crash.cycle()
    finally:
        faultinject.disarm()
    re = online.OnlineLoop(params, hold)
    reg2 = ModelRegistry(buckets=(16, 64), warmup=True)
    re.attach(reg2)
    assert re.state["version"] == 1
    np.testing.assert_array_equal(reg2.predict("default", probe,
                                               raw_score=True), served)
    again = online.OnlineLoop(params, hold)
    twice = []
    for lp in (re, again):
        batches, _ = lp.spool.read_from(lp.state["ingest_offset"])
        Xr, yr, wr = online.stack_batches(batches)
        init = lp._margins(lp._incumbent, Xr)
        twice.append(lp._splice(lp._train_delta(Xr, yr, wr, init)))
    assert twice[0] == twice[1]
    assert re.cycle() in ("promoted", "rejected")


def test_gateway_over_card_backends(dev):
    """Two serve_http backends on card registries behind the gateway:
    every answer within 1e-5 of the host walker, no failure under a
    gw_backend_5xx fault, and /metrics merging both backends."""
    import json
    import threading
    import urllib.request

    from lightgbm_tpu_torch.resilience import faultinject
    from lightgbm_tpu_torch.serving import (Gateway, ModelRegistry,
                                            gateway_http, serve_http)

    bst, Xq = _serve_model(cat=False)
    servers = []
    for _ in range(2):
        reg = ModelRegistry(buckets=(16, 64), warmup=True)
        reg.load("default", bst.model_to_string())
        h = serve_http(reg, 0, block=False)
        threading.Thread(target=h.serve_forever, daemon=True).start()
        servers.append(h)
    gw = Gateway([f"http://127.0.0.1:{h.server_address[1]}"
                  for h in servers], retries=2, backoff_base_s=0.01,
                 hedge_budget=0.0, health_interval_s=60.0)
    gw.start(wait_ready_s=30.0)
    front = gateway_http(gw, 0, block=False)
    threading.Thread(target=front.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{front.server_address[1]}"

    def score(i):
        req = urllib.request.Request(
            url + "/v1/score", data=json.dumps(
                {"rows": np.nan_to_num(Xq[i:i + 1]).tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            return json.loads(r.read())["pred"][0]

    try:
        ref = bst.predict(np.nan_to_num(Xq[:30]))
        got = [score(i) for i in range(15)]
        faultinject.arm("gw_backend_5xx:2:raise;gw_backend_5xx:5:raise")
        got += [score(i) for i in range(15, 30)]
        faultinject.disarm()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        assert "lgbmtpu_gateway_retries_total" in text
        assert "lgbmtpu_serve_protocol_requests_total" in text
    finally:
        faultinject.disarm()
        gw.stop()
        for h in [front] + servers:
            h.shutdown()
            h.server_close()


@pytest.mark.parametrize("max_bin", [255, 1000])
def test_streamed_assembly_on_card(dev, tmp_path, monkeypatch, max_bin):
    """The data plane's device assembly at depth 1 over ten chunks: the
    card's bin matrix is the in-RAM set's bit for bit (uint8 and uint16
    stored bins), the training stream waited on the copy stream, the
    stored bytes crossed PCIe from pinned slots, and no torch call ran on
    the reader thread. Two fused trees on each set give the same model."""
    import threading

    from lightgbm_tpu_torch.data import last_stats, reset_stats
    from lightgbm_tpu_torch.data import streaming

    rs = np.random.RandomState(3)
    X = rs.randn(20000, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rs.randn(20000) > 0).astype(float)
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
            "max_bin": max_bin}
    p = {**base, "data_source": "chunked", "data_chunk_rows": 2048,
         "data_spool_dir": str(tmp_path / "spool")}
    ds = lgb.Dataset(X, label=y, params=p).construct()
    ref = lgb.Dataset(X, label=y, params=base).construct()
    monkeypatch.setattr(streaming, "prefetch_depth", lambda *a: 1)
    waits, seen = [], set()
    real_wait = torch.cuda.Stream.wait_stream

    def wait_stream(self, other):
        waits.append((self, other))
        return real_wait(self, other)

    def prof(frame, event, arg):
        if threading.current_thread().name != "chunk-prefetch":
            return
        mods = [frame.f_globals.get("__name__", "")]
        if event == "c_call":
            mods += [getattr(arg, "__module__", None) or "",
                     type(getattr(arg, "__self__", None)).__module__]
        seen.update(m for m in mods if m.split(".")[0] == "torch")

    monkeypatch.setattr(torch.cuda.Stream, "wait_stream", wait_stream)
    reset_stats()
    threading.setprofile(prof)
    try:
        bins = ds._binned.device_arrays(dev)["bins"]
    finally:
        threading.setprofile(None)
    asm = last_stats()["assemble"]
    assert asm["chunks"] == 10 and asm["prefetch_depth"] == 1
    itemsize = 1 if max_bin <= 256 else 2
    assert asm["h2d_bytes"] == 6 * 20000 * itemsize
    assert asm["pinned_mb"] > 0 and asm["h2d_seconds"] > 0
    assert not seen, seen
    default = torch.cuda.current_stream(dev)
    assert any(s == default and o != default for s, o in waits), waits
    assert bins.dtype == torch.int32 and bins.device.type == "cuda"
    assert torch.equal(bins, ref._binned.device_arrays(dev)["bins"])
    bc = lgb.train(p, ds, 2)  # on the matrix just assembled
    br = lgb.train(base, ref, 2)
    strip = lambda t: [ln for ln in t.splitlines()
                       if not ln.startswith(("[data_source",
                                             "[data_chunk_rows",
                                             "[data_spool_dir"))]
    assert strip(bc.model_to_string()) == strip(br.model_to_string())


# ------------------------------------------- distributed learners (A.8)
@pytest.mark.parametrize("rows", [5000, 70001])
def test_fx_partials_of_hist_and_seg_sum(dev, rows):
    """The sharded mode of hist, hist_slots and seg_sum (csrc/hist.cu,
    csrc/seg_sum.cu: given channel maxima and n, the int64 sums): equal
    to the plain fixed point at the same scale, and at a call's own
    maxima and n, converted back, the ordinary call's f32 bits."""
    rs = np.random.RandomState(rows)
    G, B = 5, 64
    bins = torch.from_numpy(rs.randint(0, B, (G, rows)).astype(np.int32))
    gh = torch.from_numpy(np.stack([rs.randn(rows), rs.rand(rows),
                                    (rs.rand(rows) < 0.8) * 1.0])
                          .astype(np.float32))
    bd, gd = bins.to(dev), gh.to(dev)
    absmax = gh.abs().amax(dim=1) * 3  # another rank's larger maxima
    n_sc = 2 * rows
    got = ht.histogram(bd, gd, B, fx=(absmax.to(dev), n_sc))
    want = ht.histogram_plain(bins, gh, B, fx=(absmax, n_sc))
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    seg = ht.histogram(bd, gd, B, begin=torch.tensor(7, device=dev),
                       count=torch.tensor(rows // 3, device=dev),
                       cap=rows, fx=(absmax.to(dev), n_sc))
    assert torch.equal(seg.cpu(), ht.histogram_plain(
        bins, gh, B, begin=7, count=rows // 3, fx=(absmax, n_sc)))
    own = gh.abs().amax(dim=1)
    acc = ht.histogram(bd, gd, B, fx=(own.to(dev), rows))
    assert torch.equal(ht.fx_to_f32(acc.cpu(), ht.fx_exponents(own, rows)),
                       ht.histogram(bd, gd, B).cpu())
    begins = torch.tensor([0, rows // 2], dtype=torch.int32)
    counts = torch.tensor([rows // 4, rows // 3], dtype=torch.int32)
    sl = ht.hist_slots(bd, gd, begins.to(dev), counts.to(dev), B, 2,
                       fx=(absmax.to(dev), n_sc))
    assert torch.equal(sl.cpu(), ht.hist_slots_plain(
        bins, gh, begins, counts, B, 2, fx=(absmax, n_sc)))
    idx = torch.from_numpy(rs.randint(-1, 40, rows).astype(np.int32))
    vals = gh[:2].contiguous()
    acc = cuda_hist.seg_sum(vals.to(dev), idx.to(dev), 37,
                            (absmax[:2].to(dev), n_sc))
    k = ht.fx_exponents(absmax[:2], n_sc)
    q = torch.round(vals.double() * torch.ldexp(
        torch.ones(2, dtype=torch.float64), k.double())[:, None]).long()
    ok = (idx >= 0) & (idx < 37)
    ref = torch.zeros((2, 38), dtype=torch.int64).index_add_(
        1, torch.where(ok, idx, 37).long(), torch.where(ok[None], q, 0))
    assert torch.equal(acc.cpu(), ref[:, :37])


@pytest.mark.parametrize("case", ["binary", "exact", "feature"])
def test_distributed_ranks_bitwise_on_card(dev, case, tmp_path):
    """Two gloo ranks sharing the card (NCCL takes one rank a GPU): the
    int16 rounds path (reduce-scatter), the exact grower (fixed-point
    partials of the hist kernels) and feature-parallel give the card's
    serial trees bit for bit."""
    from _torch_dist_worker import make_problem, spawn_ranks, trees_text

    base = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2}
    params = {"binary": base,
              "exact": {**base, "tpu_growth_mode": "exact"},
              "feature": {**base, "enable_bundle": False}}[case]
    learner = "feature" if case == "feature" else "data"
    problem = ["binary", 6000, 7, 3]
    outs = spawn_ranks(tmp_path, 2, [{
        "name": case, "problem": problem, "params": params,
        "learner": learner, "rounds": 3, "device": "cuda"}])[case]
    X, y, _ = make_problem(*problem)
    p = {**params, "device_type": "cuda", "verbosity": -1}
    if case == "feature":
        p["tpu_growth_mode"] = "exact"

    def eager(env):
        pass

    eager.before_iteration = True
    serial = lgb.train(p, lgb.Dataset(X, label=y, params=p), 3,
                       callbacks=[eager])
    for o in outs:
        assert o["resolved"] == learner
        assert o["trees"] == trees_text(serial.model_to_string())
        assert o["stats"]["staged_bytes"] > 0  # gloo stages the card's
