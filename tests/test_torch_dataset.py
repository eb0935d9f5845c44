"""The port's binning, padded device bin matrix and EFB layout equal the
JAX package's on the same inputs (exact), and convert.py rebuilds the
JAX package's binned state in the port."""

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as ConfigJ
from lightgbm_tpu.dataset import BinnedDataset as BinnedJ
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as ConfigT
from lightgbm_tpu_torch.dataset import BinnedDataset as BinnedT
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)


def _dense(seed=3, n=900, f=6):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    X[:, 1] = np.round(X[:, 1] * 2)  # few distinct values
    X[rs.rand(n) < 0.1, 2] = np.nan  # a NaN bin
    X[:, 3] = 0.0  # trivial feature, dropped
    X[:, 4] = rs.exponential(size=n) * 1e3
    return X


def _sparse(seed=4, n=1000, f=10):
    """Mostly-zero, mutually exclusive columns: EFB bundles them."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n, f))
    owner = rs.randint(0, f - 2, n)
    X[np.arange(n), owner] = rs.rand(n) * 10 + 1
    X[:, f - 2:] = rs.randn(n, 2)  # two dense columns
    return X


def _both(X, params):
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    dj = BinnedJ.from_numpy(X, ConfigJ(params), label=y)
    dt = BinnedT.from_numpy(X, ConfigT(params), label=y)
    return dj, dt


def _mapper_fields(m):
    return (m.bin_type.value, m.missing_type.value, m.num_bin,
            m.most_freq_bin, m.default_bin, m.is_trivial, m.min_value,
            m.max_value, m.nan_bin)


@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_bin_mappers_equal(max_bin):
    dj, dt = _both(_dense(), {"max_bin": max_bin, "min_data_in_bin": 3})
    assert len(dj.mappers) == len(dt.mappers)
    for mj, mt in zip(dj.mappers, dt.mappers):
        assert _mapper_fields(mj) == _mapper_fields(mt)
        np.testing.assert_array_equal(mj.upper_bounds, mt.upper_bounds)
    np.testing.assert_array_equal(dj.used_features, dt.used_features)
    assert dj.max_num_bin == dt.max_num_bin


@pytest.mark.parametrize("max_bin", [63, 255])
def test_padded_bin_matrix_equal(max_bin):
    dj, dt = _both(_dense(), {"max_bin": max_bin})
    aj = dj.device_arrays()
    at = dt.device_arrays("cpu")
    assert dt.num_rows_padded() == dj.num_rows_padded() == 2048
    for k in ("bins", "valid", "nan_bin", "num_bins", "mono", "is_cat"):
        assert at[k].dtype == {"bins": torch.int32, "valid": torch.float32,
                               "nan_bin": torch.int32,
                               "num_bins": torch.int32, "mono": torch.int32,
                               "is_cat": torch.bool}[k]
        np.testing.assert_array_equal(at[k].numpy(), np.asarray(aj[k]), k)
    assert at["bundle"] is None and aj["bundle"] is None


def test_efb_layout_equal():
    dj, dt = _both(_sparse(), {"max_bin": 63})
    lj, lt = dj.bundle_layout, dt.bundle_layout
    assert lj is not None and lt is not None
    assert lj.groups == lt.groups and lj.col_bins == lt.col_bins
    for f in ("bundle_of", "off_lo", "mfb"):
        np.testing.assert_array_equal(getattr(lj, f), getattr(lt, f))
    np.testing.assert_array_equal(dj.bundle_expand, dt.bundle_expand)
    assert dj.col_bins == dt.col_bins
    np.testing.assert_array_equal(dj.bins, dt.bins)
    bj = dj.device_arrays()["bundle"]
    bt = dt.device_arrays("cpu")["bundle"]
    for f in bj._fields:
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)), f)


def test_reference_dataset_reuses_mappers():
    X = _dense()
    dj, dt = _both(X, {"max_bin": 63})
    Xv = _dense(seed=9, n=300)
    vj = BinnedJ.from_numpy(Xv, ConfigJ({}), reference=dj)
    vt = BinnedT.from_numpy(Xv, ConfigT({}), reference=dt)
    np.testing.assert_array_equal(vj.bins, vt.bins)


@pytest.mark.parametrize("fixture", ["dense", "sparse"])
def test_convert_binned_state(fixture):
    """binned_dataset_from_numpy rebuilds the JAX package's binned state
    (mappers, matrix, EFB layout) into an equal port dataset."""
    X = _dense() if fixture == "dense" else _sparse()
    dj, dt = _both(X, {"max_bin": 63})
    lay = dj.bundle_layout
    state = {
        "bins": dj.bins, "used_features": dj.used_features,
        "num_data": dj.num_data, "max_num_bin": dj.max_num_bin,
        "row_block": dj.row_block, "feature_names": dj.feature_names,
        "label": dj.metadata.label,
        "mappers": [dict(
            upper_bounds=m.upper_bounds, bin_type=m.bin_type.value,
            missing_type=m.missing_type.value, categories=m.categories,
            num_bin=m.num_bin, is_trivial=m.is_trivial,
            min_value=m.min_value, max_value=m.max_value,
            most_freq_bin=m.most_freq_bin, default_bin=m.default_bin,
        ) for m in dj.mappers],
        "bundle_layout": None if lay is None else lay._asdict(),
        "bundle_expand": dj.bundle_expand,
    }
    dc = convert.binned_dataset_from_numpy(state)
    ac, at = dc.device_arrays("cpu"), dt.device_arrays("cpu")
    for k in ("bins", "valid", "nan_bin", "num_bins"):
        assert torch.equal(ac[k], at[k]), k
    assert dc.feature_infos() == dt.feature_infos()
    if lay is not None:
        for f in at["bundle"]._fields:
            assert torch.equal(getattr(ac["bundle"], f),
                               getattr(at["bundle"], f)), f
