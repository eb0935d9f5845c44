"""lightgbm_tpu_torch.rng reproduces jax.random's threefry2x32 draws bit
for bit: key, fold_in, split and float32 uniform (jax's default
jax_threefry_partitionable=True)."""

import jax
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import rng
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

SEEDS = [0, 1, 17, 2 ** 31 - 1, -3]


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_bits(seed):
    np.testing.assert_array_equal(rng.key(seed).numpy(),
                                  _data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 5, 123457, 2 ** 32 - 1])
def test_fold_in_bits(seed, data):
    kj = jax.random.fold_in(jax.random.key(seed), data)
    kt = rng.fold_in(rng.key(seed), data)
    np.testing.assert_array_equal(kt.numpy(), _data(kj))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_bits(seed, num):
    kj = jax.random.split(jax.random.fold_in(jax.random.key(seed), 9), num)
    kt = rng.split(rng.fold_in(rng.key(seed), 9), num)
    np.testing.assert_array_equal(kt.numpy(), _data(kj))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (2048,), (4097,), (3, 5)])
def test_uniform_bits(seed, shape):
    """Odd and even element counts: jax pads odd counts for the unsplit
    generator but not for the partitionable one this mirrors."""
    kj = jax.random.split(jax.random.fold_in(jax.random.key(seed), 4))
    kt = rng.split(rng.fold_in(rng.key(seed), 4))
    uj = np.asarray(jax.random.uniform(kj[1], shape))
    ut = rng.uniform(kt[1], shape).numpy()
    assert ut.dtype == np.float32 and ut.shape == uj.shape
    np.testing.assert_array_equal(ut.view(np.int32), uj.view(np.int32))


def test_stochastic_rounding_levels_match():
    """The main path's draw: discretize_gradients_int on both packages
    gives the same integer levels and scales, bit for bit."""
    from lightgbm_tpu.learner.quantize import discretize_gradients_int as dj
    from lightgbm_tpu_torch.learner.quantize import \
        discretize_gradients_int as dt

    rs = np.random.RandomState(5)
    g = rs.randn(3001).astype(np.float32)
    h = rs.rand(3001).astype(np.float32)
    key_j = jax.random.fold_in(jax.random.key(1), 7)
    key_t = rng.fold_in(rng.key(1), 7)
    gq_j, hq_j, s_j = dj(jax.numpy.asarray(g), jax.numpy.asarray(h), key_j,
                         256, True)
    gq_t, hq_t, s_t = dt(torch.from_numpy(g), torch.from_numpy(h), key_t,
                         256, True)
    np.testing.assert_array_equal(gq_t.numpy(), np.asarray(gq_j))
    np.testing.assert_array_equal(hq_t.numpy(), np.asarray(hq_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
