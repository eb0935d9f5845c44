"""The port's native host library (lightgbm_tpu_torch/native) against the
JAX package's native library and the port's own Python paths, on the
same seeded inputs.

- it builds from the port's own fastparse.cpp into build/, and
  get_lib() says it is loaded;
- CSV / TSV (header, CRLF) / LibSVM parses equal the JAX package's
  native parses bit for bit and the port's numpy path within rtol 1e-15
  (tests/test_native_parse.py's tolerance; they are in fact equal); a
  malformed file falls back to the numpy path, which raises;
- greedy_find_bin and values_to_bins give the Python loop's bounds and
  bins bit for bit (and the JAX package's bounds), at every size (the
  library runs whenever it is loaded);
- predict_packed's walk equals the port's numpy host walk bit for bit
  (categorical splits, NaN, multiclass, a tree range), and a model
  trained from a file is bit for bit the model trained without the
  library.
"""

import numpy as np
import pytest

import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu import native as native_j
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch import binning as binning_t
from lightgbm_tpu_torch.parsers import load_text_file
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


def _matrix(n=400, f=6, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f) * 10.0 ** rs.randint(-3, 4, f)
    X[rs.rand(n, f) < 0.05] = np.nan
    return np.column_stack([rs.randint(0, 2, n), X])


def test_library_builds_into_build_dir():
    lib = native.get_lib()
    assert lib is not None, native.BUILD_ERROR
    path = native.library_path()
    assert path.exists() and "build" in path.parts
    assert path.parent.name == native.source_hash()
    assert native._SRC.parent.name == "native"
    assert "lightgbm_tpu_torch" in native._SRC.parts


@pytest.mark.parametrize("fmt", ["csv", "tsv_crlf_header", "libsvm"])
def test_parse_matches_jax_native_and_python(tmp_path, monkeypatch, fmt):
    rows = _matrix()
    path = tmp_path / f"d.{fmt}"
    header = fmt == "tsv_crlf_header"
    if fmt == "libsvm":
        np.savetxt(path, np.nan_to_num(rows), fmt="%.17g " + " ".join(
            f"{j}:%.17g" for j in range(rows.shape[1] - 1)))
    else:
        delim = "," if fmt == "csv" else "\t"
        with open(path, "w", newline="") as fh:
            if header:
                fh.write(delim.join(f"c{i}" for i in range(rows.shape[1]))
                         + "\r\n")
            np.savetxt(fh, rows, delimiter=delim, fmt="%.17g",
                       newline="\r\n" if header else "\n")
    got = load_text_file(str(path), header=header)
    if fmt == "libsvm":
        lab_j, X_j = native_j.parse_libsvm(str(path))
        lab_t, X_t = native.parse_libsvm(str(path))
        np.testing.assert_array_equal(X_t, X_j)
        np.testing.assert_array_equal(lab_t, lab_j)
    else:
        delim = "," if fmt == "csv" else "\t"
        M_j = native_j.parse_delim(str(path), delim, int(header))
        M_t = native.parse_delim(str(path), delim, int(header))
        np.testing.assert_array_equal(M_t, M_j)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = load_text_file(str(path), header=header)
    for key in ("X", "label"):
        np.testing.assert_allclose(got[key], plain[key], rtol=1e-15)
        np.testing.assert_array_equal(got[key], plain[key])
    assert got["feature_names"] == plain["feature_names"]


def test_malformed_file_falls_back_and_raises(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,2,3\n4,x,6\n")
    assert native.parse_delim(str(path), ",", 0) is None
    with pytest.raises(ValueError):
        load_text_file(str(path))


@pytest.mark.parametrize("n_distinct,max_bin", [(600, 255), (5000, 63),
                                                (20000, 255), (40, 255),
                                                (300, 15), (3, 2)])
def test_greedy_find_bin_bit_exact(monkeypatch, n_distinct, max_bin):
    from lightgbm_tpu.binning import greedy_find_bin as gfb_j

    rs = np.random.RandomState(n_distinct)
    distinct = np.unique(rs.randn(n_distinct) * 100)
    counts = rs.randint(1, 50, len(distinct)).astype(np.int64)
    total = int(counts.sum())
    got = binning_t.greedy_find_bin(distinct, counts, max_bin, total, 3)
    jax = gfb_j(distinct, counts, max_bin, total, 3)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = binning_t.greedy_find_bin(distinct, counts, max_bin, total, 3)
    assert got == plain == jax


@pytest.mark.parametrize("missing", ["nan", "zero", "none"])
def test_values_to_bins_bit_exact(monkeypatch, missing):
    rs = np.random.RandomState(11)
    v = rs.randn(40_000)
    v[rs.rand(40_000) < 0.1] = np.nan
    if missing == "zero":
        v[rs.rand(40_000) < 0.1] = 0.0
    elif missing == "none":
        v = np.nan_to_num(v)
    mp = binning_t.BinMapper.from_sample(
        v[:5000], 40_000, max_bin=63, min_data_in_bin=3,
        zero_as_missing=missing == "zero")
    got = mp.values_to_bins(v)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(got, mp.values_to_bins(v))


@pytest.mark.parametrize("n", [1, 7, 300])
def test_values_to_bins_few_values(monkeypatch, n):
    """The library bins a handful of values too (it runs whenever it is
    loaded), bit for bit as the Python path."""
    rs = np.random.RandomState(n)
    v = rs.randn(n)
    v[rs.rand(n) < 0.2] = np.nan
    mp = binning_t.BinMapper.from_sample(rs.randn(500), 500, max_bin=15,
                                         min_data_in_bin=3)
    got = mp.values_to_bins(v)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(got, mp.values_to_bins(v))


def _trained(objective="binary", num_class=1, rounds=6):
    rs = np.random.RandomState(5)
    X = rs.randn(900, 6)
    X[:, 2] = rs.randint(0, 12, 900)
    X[rs.rand(900, 6) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) + (np.nan_to_num(X[:, 2]) % 3 == 0)
    y = (z > 0.5).astype(float) if num_class == 1 else \
        np.digitize(z, [0.0, 1.0]).astype(float)
    p = {"objective": objective, "num_leaves": 15, "num_class": num_class,
         "device_type": "cpu", "verbosity": -1, "min_data_in_leaf": 5}
    ds = lgb_t.Dataset(X, label=y, params=p, categorical_feature=[2])
    return lgb_t.train(p, ds, rounds), X


@pytest.mark.parametrize("objective,num_class,start,num", [
    ("binary", 1, 0, -1), ("binary", 1, 2, 3), ("multiclass", 3, 0, -1),
    ("multiclass", 3, 1, 2)])
def test_predict_packed_equals_host_walk(monkeypatch, objective, num_class,
                                         start, num):
    bst, X = _trained(objective, num_class)
    assert any(t.num_cat > 0 for t in bst._gbdt.models)
    Xn = np.asfortranarray(X)  # a non-contiguous layout is copied
    got = bst.predict(Xn, raw_score=True, start_iteration=start,
                      num_iteration=num)
    pm = native.PackedModel(bst._gbdt.models)
    assert native.predict_packed(pm, X[:, :2], np.arange(3)) is None
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = bst.predict(Xn, raw_score=True, start_iteration=start,
                        num_iteration=num)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("rows", [1, 3, 256])
def test_native_walk_on_few_rows(monkeypatch, rows):
    """A request of a few rows takes the native walk (whenever the
    library is loaded), bit for bit the numpy walk."""
    bst, X = _trained("multiclass", 3)
    calls = []
    real = native.predict_packed
    monkeypatch.setattr(native, "predict_packed",
                        lambda *a: calls.append(1) or real(*a))
    got = bst.predict(X[:rows], raw_score=True)
    assert len(calls) == 3  # one walk a class
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(got, bst.predict(X[:rows],
                                                   raw_score=True))


def test_model_from_file_unchanged(tmp_path, monkeypatch):
    rows = _matrix(n=900, seed=9)
    path = tmp_path / "train.csv"
    np.savetxt(path, rows, delimiter=",", fmt="%.17g")
    p = {"objective": "binary", "num_leaves": 15, "device_type": "cpu",
         "verbosity": -1}

    def model():
        return lgb_t.train(p, lgb_t.Dataset(str(path), params=p),
                           4).model_to_string()

    with_native = model()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert model() == with_native
