"""The port's collective layer (lightgbm_tpu_torch.parallel.comm) on two
gloo ranks: reduce_scatter's padding to a multiple of the ranks, the
int16 / int8 -> int32 wire widening, all_reduce's sum and max, uneven
host rows, and the wire counter against the bytes each call sent."""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.learner.histogram import rs_wire_dtype
from lightgbm_tpu_torch.parallel.comm import wire_dtype
from _port_threads import one_torch_thread
from _torch_dist_worker import spawn_ranks

one_torch_thread()


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("comm"), 2,
                       [{"name": "comm", "kind": "comm"}])["comm"]


def test_reduce_scatter_pads_and_widens(outs):
    """(3, 5, 2) int16 tiled on dimension 1 over 2 ranks: 5 columns pad
    to 6, each rank keeps 3 of the summed columns, as int32."""
    x0 = np.arange(30).reshape(3, 5, 2)
    total = np.concatenate([x0 + x0 + 1, np.zeros((3, 1, 2), int)], axis=1)
    for r, o in enumerate(outs):
        assert o["rs_dtype"] == "torch.int32"
        np.testing.assert_array_equal(np.asarray(o["rs"]),
                                      total[:, 3 * r:3 * r + 3])


def test_all_reduce_all_gather_and_rows(outs):
    for r, o in enumerate(outs):
        assert o["ar"] == [1.5 + 2.5, -1.0]
        assert o["max"] == [1, 10]
        assert o["ag"] == [[0, 0], [1, 2]] and o["ag_dtype"] == "torch.int32"
        assert o["rows"] == [10.0 * 0 + v for v in range(2)] + \
            [10.0 + v for v in range(3)]


def test_wire_counter_counts_the_bytes_sent(outs):
    """Each call's payload after widening and padding: the
    reduce-scatter's (6 x 3 x 2) int32, the f64 and int64 pairs, the int8
    pair as int32, and gather_rows' two gathers (its lengths, then its
    rows as bytes widened to int32)."""
    want = {"reduce_scatter": 6 * 3 * 2 * 4, "all_reduce_sum": 16,
            "all_reduce_max": 16,
            "all_gather": 2 * 4 + 8 + 3 * 4 * 4}
    for o in outs:
        st = o["stats"]
        assert st["bytes"] == want
        assert st["total_bytes"] == sum(want.values())
        assert st["staged_bytes"] == 0  # host tensors: nothing staged


def test_wire_dtype_policy():
    """The JAX package's int16 wire crosses as int32 (neither gloo nor
    NCCL reduces int16); wider types cross as they are."""
    assert rs_wire_dtype(100, 2, 4) == "int16"
    assert wire_dtype(torch.int16) == torch.int32
    assert wire_dtype(torch.int8) == torch.int32
    assert wire_dtype(torch.bool) == torch.int32
    assert wire_dtype(torch.int32) == torch.int32
    assert wire_dtype(torch.float32) == torch.float32
