"""The port's streamed text loading (two_round=true, parsers.py) against
the JAX package's, with JAX on the CPU.

Its sample is drawn by reservoir (Algorithm R) over the rows as they
stream, so it differs from the whole-file loader's by design: parity is
with the JAX package's load_text_file_two_round, on files both readers
accept (each chunk goes through np.loadtxt, as in the JAX package). Held:
pass 1's row count, sample and metadata columns; the mappers, bins,
metadata, sidecars (.weight / .query / .init) and header names of the
constructed Dataset; the LibSVM fallback's warning; the trees trained on
it; the fallbacks that keep the whole-file loader (a reference= set, a
constructor categorical_feature) and the over-budget warning on an
in-RAM text load.

Both sides pin tpu_growth_mode=rounds and tpu_hist_dtype=int16 (the
port's defaults; ROADMAP "Reference-side pins").
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu.log as log_j
import lightgbm_tpu.parsers as parsers_j
import lightgbm_tpu_torch as lgb_t
import lightgbm_tpu_torch.parsers as parsers_t
from lightgbm_tpu_torch import log as log_t
from lightgbm_tpu_torch.config import Config
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
CPU = {"device_type": "cpu"}


def _write(path, n=3000, f=5, seed=0, header=False, extra=None):
    """A CSV of label + f features (+ the `extra` columns), %.6f."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    X[:, 1] = np.round(X[:, 1] * 2)  # a few distinct values
    y = (X @ rs.randn(f) > 0).astype(np.float64)
    cols = [y] + [X[:, j] for j in range(f)] + list(extra or [])
    with open(path, "w") as fh:
        if header:
            names = ["y"] + [f"f{j}" for j in range(f)] + \
                [f"x{j}" for j in range(len(extra or []))]
            fh.write(",".join(names) + "\n")
        np.savetxt(fh, np.column_stack(cols), delimiter=",", fmt="%.6f")
    return X, y


def _same_binned(bt, bj):
    assert len(bt.mappers) == len(bj.mappers)
    for mt, mj in zip(bt.mappers, bj.mappers):
        np.testing.assert_array_equal(mt.upper_bounds, mj.upper_bounds)
        assert (mt.num_bin, mt.most_freq_bin, mt.default_bin,
                mt.missing_type.value, mt.bin_type.value,
                tuple(mt.categories), mt.is_trivial) == \
            (mj.num_bin, mj.most_freq_bin, mj.default_bin,
             mj.missing_type.value, mj.bin_type.value,
             tuple(mj.categories), mj.is_trivial)
    np.testing.assert_array_equal(bt.used_features, bj.used_features)
    np.testing.assert_array_equal(bt.bins, bj.bins)
    assert bt.bins.dtype == bj.bins.dtype
    assert bt.feature_names == bj.feature_names
    assert bt.num_rows_padded() == bj.num_rows_padded()
    for f in ("label", "weight", "group", "init_score", "position"):
        a, b = getattr(bj.metadata, f), getattr(bt.metadata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b, np.float64),
                                          np.asarray(a, np.float64))


@pytest.mark.parametrize("n_sample,chunk_rows", [(400, 256), (5000, 700),
                                                 (3000, 3000)])
def test_scan_text_file_equals_jax(tmp_path, n_sample, chunk_rows):
    """Pass 1: the same reservoir over the same RandomState draws."""
    path = tmp_path / "d.csv"
    _write(path, extra=[np.arange(3000) % 4, np.repeat(np.arange(60), 50)])
    args = (path, ",", 0, n_sample, 17, [1, 2, 3, 4, 5], [0, 6, 7])
    tot_t, smp_t, meta_t = parsers_t.scan_text_file(*args,
                                                    chunk_rows=chunk_rows)
    tot_j, smp_j, meta_j = parsers_j.scan_text_file(*args,
                                                    chunk_rows=chunk_rows)
    assert tot_t == tot_j == 3000
    assert smp_t.shape == (min(n_sample, 3000), 5)
    np.testing.assert_array_equal(smp_t, smp_j)
    for a, b in zip(meta_t, meta_j):
        np.testing.assert_array_equal(a, b)
    # chunks: every line once, in order, as one np.loadtxt parse
    whole = np.loadtxt(path, delimiter=",")
    got = np.concatenate(list(parsers_t.iter_text_chunks(path, ",", 0, 700)))
    np.testing.assert_array_equal(got, whole)


CASES = {
    # name: (writer kwargs, Dataset params, sidecars)
    "plain": ({}, {}, ()),
    "reservoir": ({}, {"bin_construct_sample_cnt": 500}, ()),
    "header_columns": (
        {"header": True, "extra": [np.arange(3000) % 3 + 0.5,
                                   np.repeat(np.arange(100), 30)]},
        {"header": True, "label_column": "name:y",
         "weight_column": "name:x0", "group_column": "name:x1",
         "ignore_column": "name:f4", "categorical_feature": "name:f1"},
        ()),
    "sidecars": ({}, {"bin_construct_sample_cnt": 800},
                 ("weight", "query", "init")),
}


def _case(tmp_path, name):
    wkw, params, sidecars = CASES[name]
    path = tmp_path / f"{name}.csv"
    X, y = _write(path, **wkw)
    rs = np.random.RandomState(5)
    if "weight" in sidecars:
        np.savetxt(str(path) + ".weight", 0.5 + rs.rand(3000), fmt="%.5f")
    if "query" in sidecars:
        np.savetxt(str(path) + ".query", np.full(100, 30), fmt="%d")
    if "init" in sidecars:
        np.savetxt(str(path) + ".init", rs.randn(3000) * 0.1, fmt="%.6f")
    return path, params, X, y


@pytest.mark.parametrize("name", list(CASES))
def test_two_round_dataset_equals_jax(tmp_path, name):
    path, params, _X, _y = _case(tmp_path, name)
    pt = {**params, **CPU, "two_round": True, "verbosity": -1}
    pj = {**params, "two_round": True, "verbosity": -1}
    dt = lgb_t.Dataset(str(path), params=pt).construct()
    dj = lgb_j.Dataset(str(path), params=pj).construct()
    _same_binned(dt._binned, dj._binned)
    bt = dt._binned
    if name == "header_columns":
        assert bt.feature_names == ["f0", "f1", "f2", "f3"]
        assert bt.mappers[1].bin_type.value == 1  # categorical
        assert bt.metadata.group is not None and len(bt.metadata.group) == 100
        assert bt.metadata.weight is not None
    if name == "sidecars":
        assert bt.metadata.weight is not None
        assert bt.metadata.init_score is not None
        np.testing.assert_array_equal(bt.metadata.group, np.full(100, 30))
    if name in ("plain", "sidecars"):
        assert dt.get_label() is None  # the label lives in the binned set
        np.testing.assert_array_equal(bt.metadata.label,
                                      np.loadtxt(path, delimiter=",")[:, 0])


def test_two_round_sample_differs_from_whole_file_by_design(tmp_path):
    """Below the sample count the reservoir is the file, so the bins are
    the whole-file loader's; above it they are the JAX package's streamed
    ones, not the whole-file loader's."""
    path = tmp_path / "d.csv"
    _write(path)
    full = lgb_t.Dataset(str(path), params=CPU).construct()
    two = lgb_t.Dataset(str(path), params={**CPU, "two_round": True})
    np.testing.assert_array_equal(two.construct()._binned.bins,
                                  full._binned.bins)
    p = {"bin_construct_sample_cnt": 300, "verbosity": -1}
    whole = lgb_t.Dataset(str(path), params={**p, **CPU}).construct()
    streamed = lgb_t.Dataset(str(path), params={**p, **CPU,
                                                "two_round": True})
    streamed.construct()
    assert any(not np.array_equal(a.upper_bounds, b.upper_bounds)
               for a, b in zip(whole._binned.mappers,
                               streamed._binned.mappers))


def test_two_round_trains_as_jax(tmp_path):
    path, params, X, _y = _case(tmp_path, "reservoir")
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "two_round": True, **params, **PINS}
    bt = lgb_t.train({**p, **CPU}, lgb_t.Dataset(str(path),
                                                 params={**p, **CPU}), 4)
    bj = lgb_j.train(p, lgb_j.Dataset(str(path), params=p), 4)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_two_round_libsvm_warns_and_falls_back(tmp_path, monkeypatch):
    path = tmp_path / "d.svm"
    rs = np.random.RandomState(3)
    with open(path, "w") as f:
        for i in range(400):
            feats = " ".join(f"{j}:{rs.randn():.6f}" for j in range(4)
                             if rs.rand() < 0.8)
            f.write(f"{i % 2} {feats}\n")
    warn_t, warn_j = [], []
    monkeypatch.setattr(log_t, "warning", warn_t.append)
    monkeypatch.setattr(log_j, "warning", warn_j.append)
    assert parsers_t.load_text_file_two_round(
        str(path), Config({})) is None
    dt = lgb_t.Dataset(str(path), params={**CPU, "two_round": True})
    dj = lgb_j.Dataset(str(path), params={"two_round": True})
    dt.construct()
    dj.construct()
    assert any("LibSVM falls back" in m for m in warn_t)
    assert [m for m in warn_t if "LibSVM" in m][0] == \
        [m for m in warn_j if "LibSVM" in m][0]
    ref = lgb_t.Dataset(str(path), params=CPU).construct()
    np.testing.assert_array_equal(dt._binned.bins, ref._binned.bins)
    np.testing.assert_array_equal(dt._binned.bins, dj._binned.bins)


def test_two_round_keeps_whole_file_loader_where_it_must(tmp_path,
                                                         monkeypatch):
    """A reference= set bins with its training set's mappers, and a
    constructor categorical_feature needs the parsed names: both take
    the whole-file loader, warned."""
    ptr, pv = tmp_path / "tr.csv", tmp_path / "va.csv"
    _write(ptr, n=2000, seed=0)
    _write(pv, n=500, seed=5)
    warned = []
    monkeypatch.setattr(log_t, "warning", warned.append)
    p = {**CPU, "two_round": True, "bin_construct_sample_cnt": 300}
    tr = lgb_t.Dataset(str(ptr), params=p).construct()
    va = lgb_t.Dataset(str(pv), params=p, reference=tr).construct()
    va_plain = lgb_t.Dataset(str(pv), params=CPU, reference=tr).construct()
    np.testing.assert_array_equal(va._binned.bins, va_plain._binned.bins)
    for a, b in zip(va._binned.mappers, tr._binned.mappers):
        np.testing.assert_array_equal(a.upper_bounds, b.upper_bounds)
    cat = lgb_t.Dataset(str(ptr), params=p, categorical_feature=[1])
    cat.construct()
    whole = lgb_t.Dataset(str(ptr), params={**CPU,
                                            "bin_construct_sample_cnt": 300},
                          categorical_feature=[1]).construct()
    np.testing.assert_array_equal(cat._binned.bins, whole._binned.bins)
    # va, va_plain (a validation set takes its reference's two_round) and
    # cat
    assert sum("two_round streaming skipped" in m for m in warned) == 3


def test_no_auto_stream_over_budget_warns(tmp_path, monkeypatch):
    """Streaming needs two_round=true: a text file over ram_budget_mb
    keeps the whole-file loader and warns through the budget path."""
    import os

    path = tmp_path / "d.csv"
    _write(path, n=1000)
    real = os.path.getsize
    monkeypatch.setattr(os.path, "getsize", lambda q: (
        (2 << 30) if str(q) == str(path) else real(q)))
    streamed, warned = [], []
    real_stream = parsers_t.load_text_file_two_round
    monkeypatch.setattr(parsers_t, "load_text_file_two_round",
                        lambda *a, **k: streamed.append(1)
                        or real_stream(*a, **k))
    monkeypatch.setattr(log_t, "warning", warned.append)
    lgb_t.Dataset(str(path), params=CPU).construct()
    assert not streamed
    assert any("over the 1024 MB host RAM budget" in m and "two_round" in m
               for m in warned)
    lgb_t.Dataset(str(path), params={**CPU, "ram_budget_mb": 4096}) \
        .construct()
    assert sum("host RAM budget" in m for m in warned) == 1
    lgb_t.Dataset(str(path), params={**CPU, "two_round": True}).construct()
    assert streamed
