"""Time the serving forest on one card: its level gather from the
node-major table against the old (9, L) gather, or with --host the
host's side of serving.

    python3 -m lightgbm_tpu_torch.tools.serve_gather [--trees 500] [--host]
    (repository root; needs a CUDA device)

Trains bench.py's Higgs-like model (1M rows x 28 features, RandomState
17, 255 leaves, max_bin 255, lr 0.1, min_data_in_leaf 20) to --trees
trees on the card.

Without --host it scores 4,096 of the rows (one rung of the dispatcher)
two ways, each the same bits:
- `new`: the forest as it serves (serving/forest.py: take_rows from the
  (T * max_nodes, 16) node-major table);
- `old`: the gather before the node-major table, take_small on the
  (9, T * max_nodes) table (its generic k path, unstaged).
One JSON line a measure: each rung-4096 dispatcher graph's device ms a
replay, in turns (new, old, old, new) and twice; then each level's
gather (the recorded take_rows calls of one apply) in turns with the
old one and index_select on the (9, L) table, with the level's distinct
nodes; then the levels summed. Device time: CUDA events around 30 calls
enqueued while the card spins (torch.cuda._sleep), so the card runs them
back to back.

With --host it times, through calls the package had before the
node-major table (so that this file, copied into an older tree, times
that tree the same way), the wall-clock median of 7 after a warm call:
- `build_ms`: TensorForest.from_booster (pack, upload);
- `predict_rows_per_s`: Booster.predict(device="cuda") of 100,000 rows;
- `paged_ms` / `resident_ms`: a 16-row fleet request that pages its
  tenant in (two tenants of one family, the forest and its first 300
  iterations, taking turns in a fleet of one slot) / one whose tenant
  is resident;
- `contrib_ms`: TensorForest.predict_contrib of 64 rows over a 50-tree,
  31-leaf model.
"""

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

from .hist_tiling import device_ms, higgs_like

RUNG = 4096
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}


def in_turns(torch, fns: dict) -> dict:
    """Device ms a call of each named fn, timed in order and in reverse;
    the mean of the two turns, and the turns."""
    order = list(fns) + list(fns)[::-1]
    got = {n: [] for n in fns}
    for n in order:
        got[n].append(device_ms(torch, fns[n]))
    return {n: {"device_ms": sum(v) / 2, "turns": v} for n, v in got.items()}


def old_forest(fo, hist, forest):
    """A copy of `forest` whose apply gathers with take_small from the
    (9, L) table, as serving did before the node-major table."""
    tab9 = forest.tables["pack"][:, :fo.PACK_FIELDS].T.contiguous()
    tables = dict(forest.tables, pack=tab9.T)  # (L, 9) view of (9, L)
    old = copy.copy(forest)

    def apply(X, tree_w):
        take_rows = hist.take_rows
        hist.take_rows = lambda tab, idx, k: hist.take_cols(tab.T, idx)
        try:
            return fo.forest_apply(tables, X, tree_w,
                                   has_cat=forest.meta["has_cat"],
                                   levels=forest.levels)
        finally:
            hist.take_rows = take_rows

    old.apply = apply
    return old, tab9


def gather(torch, np, lgb, bst, X) -> None:
    """The replay and level-gather lines (module docstring)."""
    from ..learner import cuda_hist as ch
    from ..learner import histogram as hist
    from ..serving import forest as fo

    forests = {"new": fo.TensorForest.from_booster(bst)}
    forests["old"], tab9 = old_forest(fo, hist, forests["new"])
    x = torch.from_numpy(np.ascontiguousarray(X[:RUNG])).cuda()
    tw = torch.ones(bst.num_trees(), device="cuda")
    outs = {n: f.apply(x, tw) for n, f in forests.items()}
    same = all(torch.equal(outs[n][i], outs["new"][i])
               for n in outs for i in (0, 1))
    replays, nodes = {}, {}
    for n, f in forests.items():
        disp = lgb.serving.BucketDispatcher(f, buckets=(RUNG,),
                                            name=f"serve_gather_{n}")
        disp.warmup(num_features=X.shape[1])
        (_, prog), = disp._programs.items()
        replays[n], nodes[n] = prog.graph.replay, prog.graph.nodes
    print(json.dumps({"trees": bst.num_trees(), "rows": RUNG,
                      "levels": forests["new"].levels, "same_bits": same,
                      "graph_nodes": nodes}), flush=True)
    for _ in range(2):
        print(json.dumps({"replay_rung": in_turns(torch, replays)}),
              flush=True)
    calls = []
    take_rows = ch.take_rows

    def recording(tab, idx, k):
        calls.append((idx.clone(), k))
        return take_rows(tab, idx, k)

    ch.take_rows = recording
    try:
        forests["new"].apply(x, tw)
    finally:
        ch.take_rows = take_rows
    summed = {}
    tab = forests["new"].tables["pack"]
    for level, (idx, k) in enumerate(calls):
        safe = idx.clamp(0, tab9.shape[1] - 1).long()
        t = in_turns(torch, {
            "new": lambda: hist.take_rows(tab, idx, k),
            "old": lambda: hist.take_cols(tab9, idx),
            "index_select": lambda: torch.index_select(tab9, 1, safe)})
        row = {n: v["device_ms"] for n, v in t.items()}
        for n, v in row.items():
            summed[n] = summed.get(n, 0.0) + v
        print(json.dumps({"level": level, "lanes": int(idx.shape[0]),
                          "distinct_nodes": int(torch.unique(idx).numel()),
                          **row}), flush=True)
    print(json.dumps({"levels_summed": summed}), flush=True)


def wall_ms(torch, fn, reps: int = 7) -> float:
    """Median wall-clock ms of fn() and the card's finish, after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        got.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(got)


def host(torch, np, lgb, bst, X, y) -> None:
    """The --host line (module docstring)."""
    from ..serving import ModelFleet, TensorForest

    rows = X[:100_000]
    out = {"trees": bst.num_trees(),
           "build_ms": wall_ms(torch, lambda: TensorForest.from_booster(bst)),
           "predict_rows_per_s": rows.shape[0] / wall_ms(
               torch, lambda: bst.predict(rows, device="cuda",
                                          raw_score=True)) * 1e3}
    fleet = ModelFleet(buckets=(16,), capacity=1, slots_per_family=1)
    try:
        fleet.load("all", bst.model_to_string())
        fleet.load("cut", bst.model_to_string(num_iteration=300))
        q = X[:16]
        turn = iter(["all", "cut"] * 8)
        out["paged_ms"] = wall_ms(torch, lambda: fleet.predict(
            next(turn), q, raw_score=True))
        out["resident_ms"] = wall_ms(torch, lambda: fleet.predict(
            "all", q, raw_score=True))
        out["pages_in"] = fleet.fleet_stats()["pages_in"]
    finally:
        fleet.close()
    small = lgb.train(dict(PARAMS, num_leaves=31), lgb.Dataset(
        X[:100_000], label=y[:100_000]), 50)
    forest = TensorForest.from_booster(small)
    out["contrib_ms"] = wall_ms(torch, lambda: forest.predict_contrib(
        X[:64]))
    print(json.dumps({"host": out}), flush=True)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=500)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("torch sees no CUDA device\n")
        return 2
    import lightgbm_tpu_torch as lgb

    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}), flush=True)
    X, y = higgs_like(1_000_000)
    bst = lgb.train(PARAMS, lgb.Dataset(X, label=y), args.trees)
    if args.host:
        host(torch, np, lgb, bst, X, y)
    else:
        gather(torch, np, lgb, bst, X)
    return 0


if __name__ == "__main__":
    sys.exit(main())
