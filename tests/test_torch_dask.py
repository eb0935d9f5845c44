"""The port's Dask estimators (lightgbm_tpu_torch.dask) against the JAX
package's, with the JAX test's .compute() stand-in (dask is not
installed), and _spool_partitions' store read by both packages."""

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu import dask as dask_j
from lightgbm_tpu_torch import dask as dask_t
from _port_threads import one_torch_thread

one_torch_thread()

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
PRED = dict(rtol=1e-5, atol=1e-5)


class _FakeCollection:
    """Stand-in for dask.array: a numpy array behind .compute()."""

    def __init__(self, arr):
        self._arr = arr
        self.computed = 0

    def compute(self):
        self.computed += 1
        return self._arr


class _FakePartitioned(_FakeCollection):
    """A partition-aware stand-in: .to_delayed() gives row blocks, each
    behind its own .compute()."""

    def __init__(self, arr, parts):
        super().__init__(arr)
        self.parts = parts

    def to_delayed(self):
        blocks = np.array_split(self._arr, self.parts)
        return np.array([[_FakeCollection(b)] for b in blocks],
                        dtype=object)


@pytest.fixture(scope="module")
def xy():
    rs = np.random.RandomState(3)
    X = rs.randn(300, 5)
    y = (X[:, 0] - X[:, 1] > 0).astype(float)
    return X, y


@pytest.mark.parametrize("name", ["DaskLGBMClassifier", "DaskLGBMRegressor",
                                  "DaskLGBMRanker"])
def test_estimators_match_jax(name, xy):
    """Each estimator materializes the stand-ins (once each) and scores
    as the JAX package's estimator of the same name."""
    X, y = xy
    kw = dict(n_estimators=5, num_leaves=7, min_child_samples=5)
    fit_kw = {}
    if name == "DaskLGBMRanker":
        y = (y * 3).astype(int)
        fit_kw = {"group": _FakeCollection(np.array([100, 100, 100]))}
    et = getattr(lgb_t, name)(device_type="cpu", client="c", **kw, **PINS)
    ej = getattr(lgb_j, name)(client="c", **kw, **PINS)
    dx, dy = _FakeCollection(X), _FakeCollection(y)
    et.fit(dx, dy, **fit_kw)
    assert dx.computed == 1 and dy.computed == 1
    ej.fit(_FakeCollection(X), _FakeCollection(y), **dict(fit_kw))
    assert et.client_ == ej.client_ == "c"
    np.testing.assert_allclose(et.predict(_FakeCollection(X)),
                               ej.predict(_FakeCollection(X)), **PRED)
    if name == "DaskLGBMClassifier":
        np.testing.assert_allclose(et.predict_proba(_FakeCollection(X)),
                                   ej.predict_proba(X), **PRED)


def test_eval_set_is_materialized(xy):
    X, y = xy
    et = lgb_t.DaskLGBMRegressor(n_estimators=3, num_leaves=7,
                                 device_type="cpu", **PINS)
    vx, vy = _FakeCollection(X[:50]), _FakeCollection(y[:50])
    et.fit(X, y, eval_set=[(vx, vy)])
    assert vx.computed == 1 and vy.computed == 1
    assert len(et.evals_result_["valid_0"]["l2"]) == 3


def test_spool_partitions_store_opens_in_both_packages(xy, tmp_path):
    """_spool_partitions writes the data plane's chunk store one
    partition at a time; the port's and the JAX package's readers see
    the same rows, and the port's chunked Dataset bins them as the
    in-RAM one."""
    X, y = xy
    params = {"data_source": "chunked", "data_chunk_rows": 2048,
              "data_spool_dir": str(tmp_path / "spool")}
    sp = dask_t._spool_partitions(_FakePartitioned(X, 3), params)
    assert sp.shape == X.shape
    from lightgbm_tpu.data.store import ChunkStore as store_j
    from lightgbm_tpu_torch.data.store import ChunkStore as store_t

    root = sp.store.root
    def rows(store):
        chunks = list(store.open(root).iter_chunks())
        return np.concatenate([a["cols"].T for _i, _r0, a in chunks])

    rows_t, rows_j = rows(store_t), rows(store_j)
    np.testing.assert_array_equal(rows_t, X)
    np.testing.assert_array_equal(rows_j, X)
    assert dask_t._spool_partitions(X, params) is None  # plain numpy
    assert dask_j._spool_partitions(X, params) is None
