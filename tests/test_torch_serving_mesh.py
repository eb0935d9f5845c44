"""Serving's mesh= (serving.TensorForest, ModelRegistry) on two gloo
ranks of the CPU: each rank scores its block of every request's rows
and the blocks are all-gathered in row order, so both ranks answer
every row as a single process does, bit for bit."""

import numpy as np
import pytest

import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu_torch.serving import ModelRegistry, TensorForest
from _port_threads import one_torch_thread
from _torch_dist_worker import make_problem, spawn_ranks

one_torch_thread()

PROBLEM = ["multiclass", 203, 5, 6]  # rows not a multiple of the ranks


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    X, y, _ = make_problem(*PROBLEM)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
         "device_type": "cpu", "verbosity": -1}
    text = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p),
                       4).model_to_string()
    path = tmp / "model.txt"
    path.write_text(text)
    outs = spawn_ranks(tmp, 2, [{"name": "serve", "kind": "serve",
                                 "model_file": str(path),
                                 "problem": PROBLEM}])["serve"]
    return outs, text, X


def test_forest_mesh_equals_single_process(served):
    outs, text, X = served
    forest = TensorForest.from_booster(lgb_t.Booster(model_str=text),
                                       device="cpu")
    raw, leaf = forest.predict_raw(X), forest.predict_leaf(X)
    contrib = forest.predict_contrib(X[:7])
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o["raw"]), raw)
        np.testing.assert_array_equal(np.asarray(o["leaf"]), leaf)
        np.testing.assert_array_equal(np.asarray(o["contrib"]), contrib)


def test_registry_mesh_equals_predict(served):
    """The registry over the mesh answers as Booster.predict does, its
    rungs aligned to multiples of the two ranks."""
    outs, text, X = served
    want = lgb_t.Booster(model_str=text).predict(X)
    reg = ModelRegistry(device="cpu", buckets=(16, 64))
    reg.load("m", text)
    single = np.asarray(reg.predict("m", X))
    np.testing.assert_allclose(single, want, rtol=1e-5, atol=1e-6)
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o["registry"]), single)
        assert o["buckets"] == [16, 64]
