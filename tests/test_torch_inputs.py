"""The port's inputs against the JAX package's on the same seeded data
(JAX on the CPU): pandas DataFrame / Series and pyarrow Table /
RecordBatch / Array / ChunkedArray (nulls as NaN, column names as feature
names); scipy CSR and CSC through BinnedDataset.from_csr (bin boundaries,
EFB layout and bin matrix exact, and never densified: the matrix's
toarray raises); CSV / TSV / LibSVM files with header, label / weight /
group / ignore columns and the .weight / .query / .group / .init
sidecars; binary caches written by either package and read by the
other; add_features_from; and the refused inputs with their ROADMAP
items. Bin matrices and metadata are compared exactly, trained models by
their trees (structure equal, leaf values within rtol 1e-5)."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.dataset import BinnedDataset as BinnedJ
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.dataset import BinnedDataset as BinnedT
from test_torch_api import _same_trees
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          **PINS}


def _dense(n=500, f=5, seed=2):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    X[rs.rand(n, f) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * rs.randn(n) > 0).astype(float)
    return X, y


def _sparse(n=900, f=24, density=0.06, seed=0):
    """Sparse columns (EFB bundles most of them) and a label."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n, f))
    for j in range(f):
        m = rs.rand(n) < density
        X[m, j] = rs.randn(int(m.sum())) + (j % 3)
    y = ((X[:, :8].sum(axis=1) + 0.3 * rs.randn(n)) > 0).astype(float)
    return X, y


def _assert_same_binned(bt, bj):
    assert len(bt.mappers) == len(bj.mappers)
    for mt, mj in zip(bt.mappers, bj.mappers):
        np.testing.assert_array_equal(mt.upper_bounds, mj.upper_bounds)
        assert (mt.num_bin, mt.most_freq_bin, mt.default_bin,
                mt.missing_type, mt.bin_type, mt.is_trivial) == \
            (mj.num_bin, mj.most_freq_bin, mj.default_bin, mj.missing_type,
             mj.bin_type, mj.is_trivial)
    np.testing.assert_array_equal(bt.used_features, bj.used_features)
    np.testing.assert_array_equal(bt.bins, bj.bins)
    assert bt.bins.dtype == bj.bins.dtype
    assert (bt.bundle_layout is None) == (bj.bundle_layout is None)
    if bj.bundle_layout is not None:
        lt, lj = bt.bundle_layout, bj.bundle_layout
        assert lt.groups == lj.groups and lt.col_bins == lj.col_bins
        for f in ("bundle_of", "off_lo", "mfb"):
            np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))
        np.testing.assert_array_equal(bt.bundle_expand, bj.bundle_expand)
    assert bt.feature_names == bj.feature_names
    assert bt.num_rows_padded() == bj.num_rows_padded()
    for f in ("label", "weight", "group", "init_score", "position"):
        a, b = getattr(bj.metadata, f), getattr(bt.metadata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b, np.float64),
                                          np.asarray(a, np.float64))


def _both(make, **ds_kw):
    """(JAX Dataset, port Dataset), both constructed, from make(lgb)."""
    out = []
    for lgb in (lgb_j, lgb_t):
        data, kw = make(lgb)
        params = {**kw.pop("params", {}), **(CPU if lgb is lgb_t else {})}
        ds = lgb.Dataset(data, params=params, free_raw_data=False,
                         **kw, **ds_kw)
        out.append(ds.construct())
    return out


def _models(dj, dt, rounds=3):
    tj = lgb_j.train(PARAMS, dj, rounds).model_to_string()
    tt = lgb_t.train({**PARAMS, **CPU}, dt, rounds).model_to_string()
    _same_trees(tj, tt)
    return tt


# ---- pandas and Arrow
def test_pandas_frame_and_series():
    X, y = _dense()
    cols = [f"feat_{i}" for i in range(X.shape[1])]
    frame = pd.DataFrame(X, columns=cols)
    dj, dt = _both(lambda lgb: (frame, {"label": pd.Series(y),
                                        "weight": pd.Series(y + 1.0)}))
    _assert_same_binned(dt._binned, dj._binned)
    assert dt.get_feature_name() == cols
    _models(dj, dt)
    dj, dt = _both(lambda lgb: (pd.Series(X[:, 0]), {"label": y}))
    _assert_same_binned(dt._binned, dj._binned)
    b = lgb_t.train({**PARAMS, **CPU}, dt, 2)
    np.testing.assert_allclose(b.predict(pd.Series(X[:, 0])),
                               b.predict(X[:, :1]))


@pytest.mark.parametrize("kind", ["table", "record_batch"])
def test_arrow_table_with_nulls(kind):
    X, y = _dense()
    rs = np.random.RandomState(4)
    cols = {}
    for i in range(X.shape[1]):
        v = X[:, i].copy()
        mask = rs.rand(len(v)) < 0.1
        cols[f"c{i}"] = pa.array(np.where(np.isnan(v), 0.0, v), mask=mask)
    cols["flag"] = pa.array((X[:, 0] > 0).tolist(),
                            mask=rs.rand(len(y)) < 0.2)
    cols["count"] = pa.array(rs.randint(0, 9, len(y)), type=pa.int32())
    table = pa.table(cols)
    data = table if kind == "table" else table.to_batches()[0]
    dj, dt = _both(lambda lgb: (data, {"label": pa.array(y)}))
    _assert_same_binned(dt._binned, dj._binned)
    assert dt.get_feature_name() == list(cols)
    arr, _ = lgb_t.basic._to_2d_numpy(table)
    assert np.isnan(arr[:, 0]).sum() == int(cols["c0"].null_count)
    tt = _models(dj, dt)
    b = lgb_t.Booster(model_str=tt)
    np.testing.assert_allclose(b.predict(data), b.predict(arr))


def test_arrow_arrays_and_metadata():
    X, y = _dense()
    chunked = pa.chunked_array([X[:200, 1], X[200:, 1]])
    dj, dt = _both(lambda lgb: (chunked, {
        "label": pa.table({"y": y}),
        "weight": pa.chunked_array([np.ones(250), np.full(250, 2.0)]),
        "init_score": pa.array(np.zeros(len(y)))}))
    _assert_same_binned(dt._binned, dj._binned)
    with pytest.raises(ValueError, match="1-column"):
        lgb_t.Dataset(X, label=pa.table({"a": y, "b": y}))


# ---- scipy sparse
@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("bundle", [True, False])
def test_sparse_matches_jax_from_csr(fmt, bundle):
    X, y = _sparse()
    m = getattr(sp, f"{fmt}_matrix")(X)
    params = {"enable_bundle": bundle}
    bj = BinnedJ.from_csr(m, ConfigJ(params), label=y)
    bt = BinnedT.from_csr(m, ConfigT(params), label=y)
    if bundle:
        assert bt.bundle_layout is not None
    _assert_same_binned(bt, bj)


def test_sparse_sampled_mappers_and_reference():
    X, y = _sparse(n=1500)
    Xv, yv = _sparse(n=300, seed=1)
    params = {"bin_construct_sample_cnt": 600}
    out = {}
    for lgb in (lgb_j, lgb_t):
        p = {**params, **(CPU if lgb is lgb_t else {})}
        ds = lgb.Dataset(sp.csr_matrix(X), label=y, params=p,
                         free_raw_data=False).construct()
        vs = lgb.Dataset(sp.csr_matrix(Xv), label=yv, reference=ds,
                         params=p).construct()
        out[lgb] = (ds, vs)
    for i in range(2):
        _assert_same_binned(out[lgb_t][i]._binned, out[lgb_j][i]._binned)


class _NoDense(sp.csr_matrix):
    """A CSR matrix that refuses to become dense."""

    def toarray(self, *a, **k):
        raise AssertionError("the sparse input was densified")

    todense = toarray


def test_sparse_never_densifies():
    X, y = _sparse()
    m = _NoDense(X)
    ds = lgb_t.Dataset(m, label=y, params=CPU, free_raw_data=False)
    ds.construct()
    assert ds._binned.bundle_layout is not None
    assert ds.num_data() == X.shape[0] and ds.num_feature() == X.shape[1]
    sub = ds.subset(np.arange(0, 900, 3)).construct()
    assert sub.num_data() == 300
    raw = lgb_t.Dataset(m, label=y, params=CPU, free_raw_data=False)
    raw_sub = raw.subset(np.arange(100)).construct()
    assert raw_sub.num_data() == 100


def test_sparse_trains_as_jax_and_predicts_in_chunks(monkeypatch):
    X, y = _sparse()
    m = sp.csr_matrix(X)
    dj, dt = _both(lambda lgb: (m, {"label": y}))
    tt = _models(dj, dt, rounds=4)
    b = lgb_t.Booster(model_str=tt)
    monkeypatch.setattr(lgb_t.basic, "_SPARSE_ROWS", 128)
    np.testing.assert_allclose(b.predict(m), b.predict(X), atol=1e-12)
    np.testing.assert_array_equal(b.predict(m, pred_leaf=True),
                                  b.predict(X, pred_leaf=True))


def test_sparse_with_categoricals_takes_the_dense_path():
    X, y = _sparse()
    X[:, 3] = np.random.RandomState(0).randint(0, 4, len(y))
    dj, dt = _both(lambda lgb: (sp.csr_matrix(X), {
        "label": y, "categorical_feature": [3]}))
    _assert_same_binned(dt._binned, dj._binned)


# ---- text files
def _write(path, rows, delim=",", header=None):
    with open(path, "w") as f:
        if header is not None:
            f.write(delim.join(header) + "\n")
        np.savetxt(f, rows, delimiter=delim, fmt="%.17g")


@pytest.mark.parametrize("fmt", ["csv", "tsv"])
def test_delimited_file_matches_numpy(tmp_path, fmt):
    X, y = _dense()
    delim = "," if fmt == "csv" else "\t"
    names = ["target"] + [f"f{i}" for i in range(X.shape[1])]
    path = tmp_path / f"train.{fmt}"
    _write(path, np.column_stack([y, X]), delim, names)
    params = {"header": True}
    dj, dt = _both(lambda lgb: (str(path), {"params": params}))
    _assert_same_binned(dt._binned, dj._binned)
    assert dt.get_feature_name() == names[1:]
    npy = lgb_t.Dataset(X, label=y, feature_name=names[1:],
                        params={**params, **CPU}).construct()
    _assert_same_binned(dt._binned, npy._binned)
    a = lgb_t.train({**PARAMS, **CPU}, dt, 3).model_to_string()
    b = lgb_t.train({**PARAMS, **CPU}, npy, 3).model_to_string()
    assert a == b
    _models(dj, dt)


def test_columns_and_sidecars(tmp_path):
    X, y = _dense(n=300)
    rs = np.random.RandomState(6)
    w = rs.uniform(0.5, 2.0, len(y))
    qid = np.repeat(np.arange(30), 10)
    junk = rs.randn(len(y))
    rows = np.column_stack([X[:, :2], y, w, qid, junk, X[:, 2:]])
    path = tmp_path / "d.csv"
    header = ["a", "b", "lab", "wt", "q", "junk", "c", "d", "e"]
    _write(path, rows, ",", header)
    with open(str(path) + ".init", "w") as f:
        f.write("\n".join(f"{v:.17g}" for v in rs.randn(len(y)) * 0.1))
    params = {"header": True, "label_column": "name:lab",
              "weight_column": 3, "group_column": "name:q",
              "ignore_column": "name:junk", "categorical_feature": "name:d"}
    dj, dt = _both(lambda lgb: (str(path), {"params": params}))
    _assert_same_binned(dt._binned, dj._binned)
    assert dt.get_feature_name() == ["a", "b", "c", "d", "e"]
    assert list(dt.get_group()) == [10] * 30
    np.testing.assert_array_equal(dt.get_weight(), w)
    assert dt.get_init_score() is not None
    assert dt.categorical_feature == [3]
    # the sidecars of a file without those columns
    plain = tmp_path / "p.tsv"
    _write(plain, np.column_stack([y, X]), "\t")
    with open(str(plain) + ".weight", "w") as f:
        f.write("\n".join(f"{v:.17g}" for v in w))
    with open(str(plain) + ".query", "w") as f:
        f.write("\n".join(["100", "200"]))
    dj, dt = _both(lambda lgb: (str(plain), {}))
    _assert_same_binned(dt._binned, dj._binned)
    assert list(dt.get_group()) == [100, 200]
    gpath = tmp_path / "g.csv"
    _write(gpath, np.column_stack([y, X]), ",")
    with open(str(gpath) + ".group", "w") as f:
        f.write("150\n150\n")
    assert list(lgb_t.Dataset(str(gpath), params=CPU).construct()
                .get_group()) == [150, 150]


def test_weight_sidecar_gives_the_model_of_weight(tmp_path):
    X, y = _dense()
    w = np.random.RandomState(3).uniform(0.2, 3.0, len(y))
    path = tmp_path / "w.csv"
    _write(path, np.column_stack([y, X]), ",")
    with open(str(path) + ".weight", "w") as f:
        f.write("\n".join(f"{v:.17g}" for v in w))
    a = lgb_t.train({**PARAMS, **CPU},
                    lgb_t.Dataset(str(path), params=CPU), 3)
    b = lgb_t.train({**PARAMS, **CPU},
                    lgb_t.Dataset(X, label=y, weight=w, params=CPU), 3)
    assert a.model_to_string() == b.model_to_string()


@pytest.mark.parametrize("base", [0, 1])
def test_libsvm_matches_jax(tmp_path, base):
    X, y = _dense(n=300)
    X = np.nan_to_num(X)
    X[np.abs(X) < 0.5] = 0.0
    path = tmp_path / "d.svm"
    with open(path, "w") as f:
        for lab, row in zip(y, X):
            toks = [f"{j + base}:{v:.17g}" for j, v in enumerate(row) if v]
            f.write(" ".join([f"{lab:g}"] + toks) + "\n")
    dj, dt = _both(lambda lgb: (str(path), {}))
    _assert_same_binned(dt._binned, dj._binned)
    from lightgbm_tpu.parsers import _parse_libsvm as parse_j
    from lightgbm_tpu_torch.parsers import _parse_libsvm as parse_t

    lj, Xj = parse_j(path)
    lt, Xt = parse_t(path)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(Xt, Xj)
    if base == 0:
        np.testing.assert_array_equal(Xt[:, :X.shape[1]], X)


def test_format_detection_matches_jax():
    from lightgbm_tpu.parsers import detect_format as det_j
    from lightgbm_tpu_torch.parsers import detect_format as det_t

    for lines in (["1 0:1.5 3:2"], ["1,2,3"], ["1\t2\t3"], ["5"],
                  ["a,b\tc"], ["0 qid:1 1:0.5"]):
        assert det_t(lines) == det_j(lines)


# ---- binary caches, both ways
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_cache_across_packages(tmp_path, writer):
    X, y = _dense()
    w = np.linspace(1, 2, len(y))
    path = str(tmp_path / "train.bin")
    lgb_w = lgb_j if writer == "jax" else lgb_t
    src = lgb_w.Dataset(X, label=y, weight=w, init_score=np.zeros(len(y)),
                        params=CPU if lgb_w is lgb_t else None).construct()
    src.save_binary(path)
    dj, dt = _both(lambda lgb: (path, {}))
    _assert_same_binned(dt._binned, dj._binned)
    _assert_same_binned(dt._binned, src._binned)
    from lightgbm_tpu_torch.parsers import is_binary_file

    assert is_binary_file(path) and not is_binary_file(str(tmp_path))


def test_binary_cache_keeps_the_bundle_layout(tmp_path):
    X, y = _sparse()
    path = str(tmp_path / "sparse.bin")
    ds = lgb_t.Dataset(sp.csr_matrix(X), label=y, params=CPU).construct()
    ds.save_binary(path)
    back = lgb_t.Dataset(path, params=CPU).construct()
    _assert_same_binned(back._binned, ds._binned)
    a = lgb_t.train({**PARAMS, **CPU}, ds, 3).model_to_string()
    b = lgb_t.train({**PARAMS, **CPU}, back, 3).model_to_string()
    assert a == b
    jpath = str(tmp_path / "jax_sparse.bin")
    lgb_j.Dataset(sp.csr_matrix(X), label=y).construct().save_binary(jpath)
    with pytest.raises(lgb_t.LightGBMError, match="bundle layout"):
        lgb_t.Dataset(jpath, params=CPU).construct()


# ---- add_features_from
def test_add_features_from_matches_jax():
    X, y = _dense()
    out = []
    for lgb in (lgb_j, lgb_t):
        p = CPU if lgb is lgb_t else None
        a = lgb.Dataset(X[:, :3], label=y, free_raw_data=False, params=p,
                        feature_name=["a0", "a1", "a2"],
                        categorical_feature=["a2"])
        b = lgb.Dataset(np.round(X[:, 3:] * 2), free_raw_data=False,
                        params=p, feature_name=["b0", "b1"],
                        categorical_feature=["b1", 0])
        assert a.add_features_from(b) is a
        out.append(a)
    dj, dt = out
    assert dt.categorical_feature == dj.categorical_feature == \
        ["a2", "b1", 3]
    assert dt.feature_name == dj.feature_name
    dj.construct()
    dt.construct()
    _assert_same_binned(dt._binned, dj._binned)
    short = lgb_t.Dataset(X[:10], free_raw_data=False, params=CPU)
    with pytest.raises(lgb_t.LightGBMError):
        dt.add_features_from(short)
    freed = lgb_t.Dataset(X, params=CPU)
    freed.construct()
    with pytest.raises(lgb_t.LightGBMError, match="raw data"):
        dt.add_features_from(freed)


# ---- the former refusals
def test_refused_inputs_name_their_item(tmp_path):
    """two_round, Sequence and data_source=chunked were refused until the
    data plane (A.10) was ported; each constructs and trains now, as the
    JAX package's does; A.8's tree_learner=data, refused until the
    distributed learners were ported, trains too."""
    X, y = _dense()
    path = tmp_path / "t.csv"
    _write(path, np.column_stack([y, X]))
    dt = lgb_t.Dataset(str(path), params={**CPU, "two_round": True})
    dj = lgb_j.Dataset(str(path), params={"two_round": True})
    dt.construct()
    dj.construct()
    _assert_same_binned(dt._binned, dj._binned)

    class Rows(lgb_t.Sequence):
        batch_size = 128

        def __len__(self):
            return len(X)

        def __getitem__(self, idx):
            return X[idx]

    seq = lgb_t.Dataset(Rows(), label=y, params=CPU).construct()
    np.testing.assert_array_equal(
        seq._binned.bins,
        lgb_t.Dataset(X, label=y, params=CPU).construct()._binned.bins)
    p = {**PARAMS, **CPU}
    pc = {**p, "data_source": "chunked"}
    dc = lgb_t.Dataset(X, label=y, params=pc)
    chunked = lgb_t.train(pc, dc, 2)
    assert type(dc._binned).__name__ == "StreamedBinnedDataset"
    np.testing.assert_array_equal(
        chunked.predict(X),
        lgb_t.train(p, lgb_t.Dataset(X, label=y, params=CPU), 2).predict(X))
    # tree_learner=data is ported (A.8): on one process it trains
    # serially
    np.testing.assert_array_equal(
        lgb_t.train({**p, "tree_learner": "data"},
                    lgb_t.Dataset(X, label=y, params=CPU), 1).predict(X),
        lgb_t.train(p, lgb_t.Dataset(X, label=y, params=CPU), 1).predict(X))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_groups_sparse_matches_jax(seed):
    """The port counts conflicts on bitsets, the JAX package on sorted row
    lists: the same groups."""
    from lightgbm_tpu.bundling import find_groups_sparse as groups_j
    from lightgbm_tpu_torch.bundling import find_groups_sparse as groups_t

    rs = np.random.RandomState(seed)
    n = 30000
    nd_rows, bins = [], []
    for f in range(40):
        if f % 13 == 5:
            nd_rows.append(None)
        else:
            density = rs.choice([0.001, 0.01, 0.05, 0.3])
            nd_rows.append(np.flatnonzero(rs.rand(n) < density))
        bins.append(int(rs.randint(2, 40)))
    for cap in (64, 256):
        assert groups_t(nd_rows, bins, n, cap) == groups_j(nd_rows, bins, n,
                                                          cap)
