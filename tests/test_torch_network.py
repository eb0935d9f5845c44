"""set_network and run_distributed (lightgbm_tpu_torch.parallel.
multihost) on two gloo ranks of the CPU, each joining from a two-address
machines list on localhost (its rank from its listen port): both ranks
hold the same model, and its trees are the serial run's."""

import os
import socket

import numpy as np
import pytest

import lightgbm_tpu_torch as lgb_t
from _port_threads import one_torch_thread
from _torch_dist_worker import make_problem, spawn_ranks, trees_text

one_torch_thread()

PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2}
PROBLEM = ["binary", 600, 6, 3]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("net")
    cases = [
        {"name": "set_network", "kind": "set_network", "ports": _free_ports(2),
         "problem": PROBLEM, "params": PARAMS, "rounds": 4},
        {"name": "run_distributed", "kind": "set_network",
         "via": "run_distributed", "ports": _free_ports(2),
         "problem": PROBLEM, "params": PARAMS, "rounds": 4,
         "obs_dir": str(tmp / "obs")},
    ]
    return spawn_ranks(tmp, 2, cases, store=False), tmp


def _serial_trees():
    X, y, _ = make_problem(*PROBLEM)
    p = {**PARAMS, "device_type": "cpu", "verbosity": -1}
    return trees_text(lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p),
                                  4).model_to_string())


@pytest.mark.parametrize("name", ["set_network", "run_distributed"])
def test_ranks_hold_identical_models(name, runs):
    outs, _ = runs
    a, b = outs[name]
    assert a["model"] == b["model"]
    assert [a["rank"], b["rank"]] == [0, 1]
    assert a["trees"] == _serial_trees()
    np.testing.assert_array_equal(a["pred"], b["pred"])


def test_run_distributed_fleet_files(runs):
    """run_distributed's heartbeats and metric snapshots: rank 0 merged
    both ranks' files and reports both alive."""
    outs, tmp = runs
    health = outs["run_distributed"][0]["health"]
    assert health["healthy"] and sorted(health["alive"]) == [0, 1]
    assert outs["run_distributed"][1]["health"] is None
    files = sorted(os.listdir(tmp / "obs"))
    assert "metrics_rank00000.json" in files
    assert "metrics_rank00001.json" in files
