"""Rank process of the port's distributed tests (spawned by
tests/test_torch_distributed.py and its neighbours).

    python tests/_torch_dist_worker.py RANK WORLD INIT_FILE CASES_JSON OUT_DIR

Each rank joins a gloo process group through a file store (INIT_FILE,
under the test's tmp_path: no TCP port to collide between test
workers), runs every case of CASES_JSON in order and writes
OUT_DIR/<case>.<rank>.json. Under tree_learner=data / voting a rank
holds a contiguous block of the rows (query-aligned for rankers) and
bins it on the gathered sample (parallel.multihost.bin_reference);
under feature every rank holds every row. The test process trains the
serial run on the same problem (make_problem) and compares.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_problem(kind: str, n: int, f: int, seed: int):
    """(X, y, group or None) of a seeded problem: binary, regression,
    multiclass (3 classes) or lambdarank (queries of 20 rows)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    w = rs.randn(f)
    z = X @ w + 0.3 * rs.randn(n)
    group = None
    if kind == "binary":
        y = (z > 0).astype(np.float64)
    elif kind == "regression":
        y = z
    elif kind == "multiclass":
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float64)
    elif kind == "lambdarank":
        y = np.clip(np.round(z - z.min()), 0, 4)
        group = np.full(n // 20, 20)
    else:
        raise ValueError(kind)
    return X, y, group


def blocks(n: int, world: int, group=None):
    """Contiguous row blocks [lo, hi) a rank; with query groups the
    blocks end on query boundaries."""
    if group is None:
        edges = [n * r // world for r in range(world + 1)]
    else:
        qe = np.concatenate([[0], np.cumsum(group)])
        nq = len(group)
        edges = [int(qe[nq * r // world]) for r in range(world + 1)]
    return [(edges[r], edges[r + 1]) for r in range(world)]


def trees_text(model: str) -> str:
    """The trees of a model text (Tree=0 .. end of trees), without the
    header and parameters that name the learner."""
    i = model.index("Tree=0") if "Tree=0" in model else 0
    j = model.index("end of trees")
    return model[i:j]


def run_train(case: dict, rank: int, world: int) -> dict:
    import torch.distributed as dist

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import multihost

    X, y, group = make_problem(*case["problem"])
    p = {**case["params"], "device_type": case.get("device", "cpu"),
         "verbosity": -1, "tree_learner": case["learner"]}
    if case["learner"] == "feature":
        ds = lgb.Dataset(X, label=y, group=group, params=p)
        ref = ds
    else:
        lo, hi = blocks(len(X), world, group)[rank]
        ref = multihost.bin_reference(X[lo:hi], p)
        g = None
        if group is not None:
            qe = np.concatenate([[0], np.cumsum(group)])
            g = group[(qe[:-1] >= lo) & (qe[:-1] < hi)]
        ds = lgb.Dataset(X[lo:hi], label=y[lo:hi], group=g, reference=ref,
                         params=p)
    kw = {}
    ev = {}
    if case.get("valid"):
        Xv, yv, gv = make_problem(*case["valid"])
        kw = dict(valid_sets=[lgb.Dataset(Xv, label=yv, group=gv,
                                          reference=ref)],
                  valid_names=["v"], evals_result=ev)
    bst = lgb.train(p, ds, case["rounds"], **kw)
    gb = bst._gbdt
    mesh = gb._mesh
    from lightgbm_tpu_torch.obs.manifest import build_manifest

    man = build_manifest(booster=bst)
    out = {
        "fused_reason": gb.fused_ineligible_reason(),
        "manifest_wire": man["collectives"]["runtime_wire_bytes_estimate"],
        "manifest_learner": man["model"]["tree_learner"],
        "trees": trees_text(bst.model_to_string()),
        "pred": bst.predict(X).tolist(),
        "resolved": gb.tree_learner_resolved,
        "elected": gb.voting_elected_cols,
        "wire_est": (gb._dp.wire_bytes_per_tree(int(gb.dev["bins"].shape[0]))
                     if case["learner"] != "feature" and gb._dp else 0),
        "stats": None if mesh is None else mesh.stats.as_dict(),
        "evals": ev,
        "world": dist.get_world_size(),
    }
    return out


def run_set_network(case: dict, rank: int, world: int) -> dict:
    """set_network from a machines list on localhost (no file store):
    rank from the listen port; then run_distributed's training."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import multihost

    ports = case["ports"]
    machines = ",".join(f"127.0.0.1:{q}" for q in ports)
    if case.get("via") == "run_distributed":
        X, y, _ = make_problem(*case["problem"])
        lo, hi = blocks(len(X), world)[rank]
        bst = multihost.run_distributed(
            {**case["params"], "device_type": "cpu", "verbosity": -1},
            X[lo:hi], y[lo:hi], machines=machines,
            local_listen_port=ports[rank], num_boost_round=case["rounds"],
            obs_snapshot_dir=case.get("obs_dir"))
    else:
        lgb.set_network(machines, local_listen_port=ports[rank],
                        num_machines=world, backend="gloo")
        X, y, _ = make_problem(*case["problem"])
        lo, hi = blocks(len(X), world)[rank]
        p = {**case["params"], "device_type": "cpu", "verbosity": -1,
             "tree_learner": "data"}
        ref = multihost.bin_reference(X[lo:hi], p)
        bst = lgb.train(p, lgb.Dataset(X[lo:hi], label=y[lo:hi],
                                       reference=ref, params=p),
                        case["rounds"])
    return {"model": bst.model_to_string(),
            "trees": trees_text(bst.model_to_string()),
            "pred": bst.predict(X).tolist(),
            "rank": getattr(bst, "_distributed_rank", rank),
            "health": getattr(bst, "_fleet_health", None)}


def run_serve(case: dict, rank: int, world: int) -> dict:
    """Serving's mesh=: each rank scores its block of rows and the
    blocks are all-gathered in row order."""
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.parallel.multihost import world_mesh
    from lightgbm_tpu_torch.serving import ModelRegistry, TensorForest

    with open(case["model_file"]) as f:
        text = f.read()
    X, _, _ = make_problem(*case["problem"])
    dev = case.get("device", "cpu")
    mesh = world_mesh()
    forest = TensorForest.from_booster(Booster(model_str=text), device=dev,
                                       mesh=mesh)
    reg = ModelRegistry(device=dev, mesh=mesh, buckets=(16, 64))
    reg.load("m", text)
    return {"raw": forest.predict_raw(X).tolist(),
            "leaf": forest.predict_leaf(X).tolist(),
            "contrib": forest.predict_contrib(X[:7]).tolist(),
            "registry": np.asarray(reg.predict("m", X)).tolist(),
            "buckets": list(reg._entry("m").dispatcher.buckets)}


def run_comm(case: dict, rank: int, world: int) -> dict:
    """comm.Mesh's collectives on known inputs: the padding of
    reduce_scatter, the int16 -> int32 widening and the wire counter."""
    import torch

    from lightgbm_tpu_torch.parallel.comm import Mesh

    m = Mesh(None, "data", torch.device("cpu"))
    out = {}
    x = (torch.arange(3 * 5 * 2, dtype=torch.int16).reshape(3, 5, 2)
         + rank)
    rs = m.reduce_scatter(x, dim=1)
    out["rs"] = rs.tolist()
    out["rs_dtype"] = str(rs.dtype)
    ar = m.all_reduce(torch.tensor([rank + 1.5, -rank], dtype=torch.float64))
    out["ar"] = ar.tolist()
    mx = m.all_reduce(torch.tensor([rank, 10 - rank], dtype=torch.int64),
                      "max")
    out["max"] = mx.tolist()
    ag = m.all_gather(torch.tensor([rank, rank * 2], dtype=torch.int8))
    out["ag"] = ag.tolist()
    out["ag_dtype"] = str(ag.dtype)
    rows = m.gather_rows(np.arange(rank + 2, dtype=np.float32) + 10 * rank)
    out["rows"] = rows.tolist()
    out["stats"] = m.stats.as_dict()
    return out


def spawn_ranks(tmp, world: int, cases: list, timeout: float = 600,
                store: bool = True) -> dict:
    """Run `cases` on `world` rank processes (this file as a script), a
    file store under tmp unless store is False (the cases then join by
    themselves); -> {case name: [each rank's output]}. A rank that fails
    or outlives the timeout fails the caller, with its log."""
    import subprocess

    tmp = os.fspath(tmp)
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir, exist_ok=True)
    cj = os.path.join(tmp, "cases.json")
    with open(cj, "w") as f:
        json.dump(cases, f)
    init = os.path.join(tmp, "store") if store else "-"
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        # each rank logs to a file: a full pipe would stall a rank in the
        # middle of a collective
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r),
                 str(world), init, cj, out_dir], stdout=lf,
                stderr=subprocess.STDOUT, cwd=REPO))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r]) as lf:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     + lf.read()[-4000:])
    res = {}
    for c in cases:
        res[c["name"]] = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{c['name']}.{r}.json")) as f:
                res[c["name"]].append(json.load(f))
    return res


RUNNERS = {"train": run_train, "set_network": run_set_network,
           "serve": run_serve, "comm": run_comm}


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, cases_json, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel import multihost

    with open(cases_json) as f:
        cases = json.load(f)
    if init_file != "-":
        multihost.init_distributed(init_method=f"file://{init_file}",
                                   num_machines=world, machine_rank=rank,
                                   backend="gloo")
    for case in cases:
        out = RUNNERS[case.get("kind", "train")](case, rank, world)
        with open(os.path.join(out_dir, f"{case['name']}.{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        if dist.is_initialized() and case.get("kind") == "set_network":
            dist.destroy_process_group()
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
