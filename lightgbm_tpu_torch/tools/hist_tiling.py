"""Time the port's histogram kernels over their tiling choices on one card.

    python3 -m lightgbm_tpu_torch.tools.hist_tiling [seg | seg1 | nat | nat1]
    (repository root; `seg` runs the first part alone, `seg1` only its
    planner's pick; `nat` the hist_nat part alone, `nat1` only its pick)

hist and hist_slots (the first part, `seg`): one tree of the exact
grower at the main path's shapes (1M rows of bench.py's Higgs-like
features, 28 columns, 255 leaves; train_exact, then train_exact_rounds)
records every hist call (begin, count, cap) and every hist_slots call (begins,
counts), and each sweep point replays them all on the tree's final
leaf-grouped matrix: the summed device time of a tree's calls, so the
sizes weigh as often as a tree asks for them. Sweep points: (rows per
item at least, items per slot at most, columns per block) of
learner/cuda_hist SEG_CHUNK, SEG_SLOT_ITEMS, SEG_COLS, one JSON line
each, with single hist calls at 1,001,472, 500,736, 65,536, 8192 and
1024 rows and an empty one (device bounds, count 0, cap 1024: the fixed
cost of the two launches) beside the replay; `chunk: null` is the
planner's pick. A summary line ranks the points by the replays' sum.

hist_round (the partition + compacted-row histogram design): for rounds
of the rounds grower's ladder at the main path's shapes (1,001,472 rows,
28 columns, 256 bins, random valid split params) — a first round (8
slots, one used: the root, split at its median bin, so about half the
rows are kept), and 8, 32 and 48 used slots over random leaves — its
device time per call in the int16, int8 and f32 modes for each triple
(kept rows per work item at least, work items per slot at most, columns
per histogram block) of the sweep (learner/cuda_hist ROUND_CHUNK,
ROUND_SLOT_ITEMS, ROUND_COLS), one JSON line per round and triple.
`chunk: null` is the triple cuda_hist.hist_round_plan picks.

hist_nat's integer modes (`nat`; `nat1` times the planner's pick
alone): at the root's shape (1,001,472 rows, 28 columns, 256 bins, S =
1, every row in the slot), on int32 levels (the int16 mode) and on int8
levels of use_quantized_grad's 4 levels, the device time per call of
each point (threads a block, tile bytes, rows a stage, stages:
learner/cuda_hist NAT_THREADS, NAT_TILE_BYTES, NAT_CHUNK, NAT_STAGES;
one block a SM), each output bitwise against the
plain version; `point: null` is the planner's pick. A summary line
ranks the points by the sum of the two modes' times at S = 1; beside it
the pick on inputs 4 bytes off alignment (`direct`: each lane loads its
own rows, no stages) and the pick's fixed cost (`fixed`: its root
items of 512 rows each). Then, as checks, the pick at S = 8, 32 and
48 (random slots, the trash slot among them), and per slot width the
int8 mode against int32 channels of the same 4-level values
(`same_4_levels`: int8, int32, int32, int8, for hist_round and
hist_nat), which isolates the channel width from the values. Then its
f32 mode at the percentile refit's shape (one column, 255 or 31 leaf
slots + trash, 256 bins), once with every row in a slot (a first refit
pass) and once with 1 row in 64 (a later pass).

Device time: CUDA events around 30 calls enqueued while the card spins
(torch.cuda._sleep), so the card runs them back to back. Needs a CUDA
device.
"""

import contextlib
import json
import statistics
import sys

N_ROWS, G, BC, L = 1_001_472, 28, 256, 255
# (kept rows per item at least, items per slot at most, columns per block)
ROUND_SWEEP = tuple((c, n, g) for c in (512, 1024, 2048)
                    for n in (32, 64, 128) for g in (2, 4, 8))
# hist / hist_slots: (rows per item, items per slot, columns per block)
SEG_SWEEP = tuple((c, n, g) for c in (512, 1024, 2048, 4096, 8192)
                  for n in (32, 64, 128, 256) for g in (1, 2, 4, 7, 14))
SEG_SIZES = (1_001_472, 500_736, 65_536, 8192, 1024)
# hist_nat's integer modes: (threads a block, tile bytes, rows a stage,
# stages)
NAT_SWEEP = (tuple((t, 48 * 1024, c, 2) for t in (1024, 768, 512)
                   for c in (896, 1024, 1152))
             + ((1024, 200 * 1024, 512, 2), (768, 200 * 1024, 256, 4)))


def cuda_ms(torch, fn, reps: int = 10, warm: int = 3) -> float:
    """Median milliseconds of fn() over CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 30, spin: int = 1 << 26) -> float:
    """Device milliseconds per call: events around `calls` calls enqueued
    behind a spin of the card; raises if the host fell behind it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    ahead = not start.query()
    end.synchronize()
    if not ahead:
        raise RuntimeError("the host did not enqueue the calls ahead")
    return start.elapsed_time(end) / calls


def round_params(torch, gen, S, used, dev):
    params = torch.zeros((S, 16), dtype=torch.int32)
    params[:, 0] = -1
    params[:used, 0] = torch.randperm(L, generator=gen)[:used].to(torch.int32)
    params[:, 1] = torch.randint(0, G, (S,), generator=gen)
    params[:, 2] = torch.randint(0, BC - 6, (S,), generator=gen)
    params[:, 5] = torch.randint(0, 2, (S,), generator=gen)
    params[:, 6] = 300 + torch.arange(S)
    params[:, 8] = -1
    return params.to(dev)


# the Higgs-like workload's parameters (bench.py:396-406) on the exact
# grower
EXACT_PARAMS = {"objective": "binary", "num_leaves": L, "max_bin": 255,
                "learning_rate": 0.1, "min_data_in_leaf": 20,
                "verbosity": -1, "tpu_growth_mode": "exact"}


def higgs_like(rows: int, feats: int = 28):
    """bench.py:386-395: RandomState(17) features and the binary label."""
    import numpy as np

    rs = np.random.RandomState(17)
    X = rs.randn(rows, feats).astype(np.float32)
    w = rs.randn(feats)
    logits = (X[:, : feats // 2] @ w[: feats // 2]
              + np.sin(X[:, feats // 2]) * 2.0)
    return X, (logits + rs.randn(rows) > 0).astype(np.float32)


@contextlib.contextmanager
def recording_seg_calls(store):
    """While active, keep every hist call of the exact grower
    (store["hist"]: (begin, count, cap), device bounds cloned at call
    time) and every hist_slots call (store["slots"]: (begins, counts, S),
    cloned), and the matrix, channels and bins of the latest call
    (store["bins"], ["gh"], ["Bc"]): once a tree is grown, its final
    leaf-grouped matrix. The grower moves rows only within their leaf's
    segment, so each recorded segment holds the same rows there."""
    import torch

    from ..learner import permuted

    orig_h, orig_s = permuted.histogram, permuted.hist_slots

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def hist(bins, gh, Bc, begin=0, count=None, cap=None):
        store.setdefault("hist", []).append((clone(begin), clone(count), cap))
        store.update(bins=bins, gh=gh, Bc=Bc)
        return orig_h(bins, gh, Bc, begin, count, cap)

    def slots(bins, gh, begins, counts, Bc, S):
        store.setdefault("slots", []).append((begins.clone(), counts.clone(),
                                              S))
        store.update(bins=bins, gh=gh, Bc=Bc)
        return orig_s(bins, gh, begins, counts, Bc, S)

    permuted.histogram, permuted.hist_slots = hist, slots
    try:
        yield
    finally:
        permuted.histogram, permuted.hist_slots = orig_h, orig_s


def replay_hist(store, fn=None):
    """Every recorded hist call on the final matrix, in order, through
    histogram.histogram (or fn with its arguments); the outputs."""
    from ..learner import histogram as h

    fn = fn or h.histogram
    bins, gh, Bc = store["bins"], store["gh"], store["Bc"]
    return [fn(bins, gh, Bc, b, c, cap) for b, c, cap in store["hist"]]


def replay_slots(store, fn=None):
    """Every recorded hist_slots call on the final matrix, in order."""
    from ..learner import histogram as h

    fn = fn or h.hist_slots
    bins, gh, Bc = store["bins"], store["gh"], store["Bc"]
    return [fn(bins, gh, be, co, Bc, S) for be, co, S in store["slots"]]


def segment_rows(store):
    """The rows of each recorded hist call (count, capped at cap), read
    back to the host."""
    n = store["bins"].shape[1]
    out = []
    for b, c, cap in store["hist"]:
        c = n - int(b) if c is None else int(c)
        out.append(c if cap is None else min(c, int(cap)))
    return out


SIZE_BINS = (0, 1024, 8192, 65_536, 524_288)


def size_histogram(rows):
    """Calls per segment size class, [lo, next lo) rows."""
    hist = {}
    for lo, hi in zip(SIZE_BINS, SIZE_BINS[1:] + (None,)):
        key = f"{lo}+" if hi is None else f"{lo}-{hi - 1}"
        hist[key] = sum(1 for r in rows if r >= lo and (hi is None or r < hi))
    return hist


def exact_trees(torch, lgb):
    """One tree of train_exact and one of train_exact_rounds on the
    Higgs-like workload, each with its hist and hist_slots calls recorded
    (recording_seg_calls)."""
    X, y = higgs_like(1_000_000)
    ds = lgb.Dataset(X, label=y, free_raw_data=False)
    ds.construct()
    trees = {}
    for name, extra in (("train_exact", {}),
                        ("train_exact_rounds", {"tpu_growth_rounds": True})):
        bst = lgb.Booster(dict(EXACT_PARAMS, **extra), ds)
        store = {}
        with recording_seg_calls(store):
            bst.update()
        torch.cuda.synchronize()
        trees[name] = store
    return trees


def seg_part(torch, ch, h, smi, sweep=True) -> None:
    import lightgbm_tpu_torch as lgb

    trees = exact_trees(torch, lgb)
    ex, rd = trees["train_exact"], trees["train_exact_rounds"]
    rows = segment_rows(ex)
    print(json.dumps({
        "device": smi, "tree": "train_exact", "hist_calls": len(rows),
        "rows": sum(rows), "sizes": size_histogram(rows),
        "slots_tree": "train_exact_rounds",
        "hist_slots_calls": len(rd["slots"]),
        "hist_calls_rounds_tree": len(rd["hist"])}), flush=True)
    bins, gh, Bc = ex["bins"], ex["gh"], ex["Bc"]
    default = (ch.SEG_CHUNK, ch.SEG_SLOT_ITEMS, ch.SEG_COLS)
    zero = torch.zeros((), dtype=torch.int64, device=bins.device)
    results = []
    try:
        for trio in (None,) + (SEG_SWEEP if sweep else ()):
            ch.SEG_CHUNK, ch.SEG_SLOT_ITEMS, ch.SEG_COLS = trio or default
            t = dict(
                empty_ms=device_ms(torch, lambda: h.histogram(
                    bins, gh, Bc, zero, zero, 1024)),
                hist_tree_ms=device_ms(torch, lambda: replay_hist(ex),
                                       calls=1, spin=1 << 29),
                hist_slots_tree_ms=device_ms(
                    torch, lambda: replay_slots(rd), calls=3, spin=1 << 27),
                sizes_ms={n: device_ms(torch, lambda: h.histogram(
                    bins, gh, Bc, 0, n)) for n in SEG_SIZES})
            row = {"device": smi, "chunk": trio and trio[0],
                   "slot_items": trio and trio[1], "cols": trio and trio[2],
                   **t}
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        ch.SEG_CHUNK, ch.SEG_SLOT_ITEMS, ch.SEG_COLS = default
    key = lambda r: r["hist_tree_ms"] + r["hist_slots_tree_ms"]
    ranked = sorted(results, key=key)
    print(json.dumps({
        "device": smi, "summary": "hist_tree_ms + hist_slots_tree_ms",
        "default": results[0], "default_rank": ranked.index(results[0]) + 1,
        "points": len(results), "best": ranked[:5]}), flush=True)


NAT_KNOBS = ("NAT_THREADS", "NAT_TILE_BYTES", "NAT_CHUNK", "NAT_STAGES")


def nat_part(torch, ch, h, smi, bins, gh, gh8, sweep=True) -> None:
    """hist_nat's integer modes over NAT_SWEEP at the root's shape, each
    output bitwise against the plain version, ranked by the two modes'
    summed device time; then the pick at S = 8, 32, 48."""
    dev = bins.device
    N = bins.shape[1]
    slot0 = torch.zeros(N, dtype=torch.int32, device=dev)
    default = tuple(getattr(ch, k) for k in NAT_KNOBS)
    refs = {m: h.hist_nat_slots_plain(bins, g, slot0, 1, BC)
            for m, g in (("int16", gh), ("int8", gh8))}
    results = []
    try:
        for point in (None,) + (NAT_SWEEP if sweep else ()):
            for k, v in zip(NAT_KNOBS, point or default):
                setattr(ch, k, v)
            t = {}
            for m, g, lv in (("int16", gh, 256), ("int8", gh8, 4)):
                run = lambda: h.hist_nat_slots(bins, g, slot0, 1, BC,
                                               levels=lv)
                if not torch.equal(run(), refs[m]):
                    raise AssertionError(f"hist_nat {m} at {point} "
                                         "disagrees with its plain version")
                t[f"hist_nat_{m}_ms"] = device_ms(torch, run)
            plan = ch.hist_nat_plan(G, N, 1, BC, ch._sm_count(dev))
            row = {"device": smi, "slots": 1, "point": point,
                   **{k: plan[k] for k in ("grid", "R", "P", "n_cg", "smem")},
                   **t}
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        for k, v in zip(NAT_KNOBS, default):
            setattr(ch, k, v)
    def offset(x):  # a copy 4 bytes (int8: 1 byte) off alignment
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    ob, o16, o8, os_ = offset(bins), offset(gh), offset(gh8), offset(slot0)
    direct = {f"hist_nat_{m}_ms": device_ms(torch, lambda: h.hist_nat_slots(
        ob, g, os_, 1, BC, levels=lv))
        for m, g, lv in (("int16", o16, 256), ("int8", o8, 4))}
    del ob, o16, o8, os_
    # the fixed cost of a call: the pick's items at the root (every block
    # one item) over 512 rows each
    n_small = 512 * ch.hist_nat_plan(G, N, 1, BC, ch._sm_count(dev))["R"]
    min_rows = ch.NAT_MIN_ITEM_ROWS
    ch.NAT_MIN_ITEM_ROWS = 512
    sb, ss = bins[:, :n_small].contiguous(), slot0[:n_small]
    try:
        fixed = {f"hist_nat_{m}_ms": device_ms(
            torch, lambda: h.hist_nat_slots(sb, g, ss, 1, BC, levels=lv))
            for m, g, lv in (("int16", gh[:, :n_small].contiguous(), 256),
                             ("int8", gh8[:, :n_small].contiguous(), 4))}
    finally:
        ch.NAT_MIN_ITEM_ROWS = min_rows
    print(json.dumps({"device": smi, "slots": 1, "direct": direct,
                      "fixed": dict(fixed, rows=n_small)}), flush=True)
    key = lambda r: r["hist_nat_int16_ms"] + r["hist_nat_int8_ms"]
    ranked = sorted(results, key=key)
    print(json.dumps({
        "device": smi, "summary": "hist_nat_int16_ms + hist_nat_int8_ms, S=1",
        "default": results[0], "default_rank": ranked.index(results[0]) + 1,
        "points": len(results), "best": ranked[:5]}), flush=True)
    gen = torch.Generator().manual_seed(3)
    for S in (8, 32, 48):
        slot = torch.randint(0, S + 1, (N,), generator=gen,
                             dtype=torch.int32).to(dev)
        t = {}
        for m, g, lv in (("int16", gh, 256), ("int8", gh8, 4)):
            run = lambda: h.hist_nat_slots(bins, g, slot, S, BC, levels=lv)
            if not torch.equal(run(), h.hist_nat_slots_plain(bins, g, slot,
                                                             S, BC)):
                raise AssertionError(f"hist_nat {m} S={S} disagrees")
            t[f"hist_nat_{m}_ms"] = device_ms(torch, run)
        print(json.dumps({"device": smi, "slots": S, "point": None, **t}),
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch sees no CUDA device\n")
        return 2
    from ..learner import cuda_hist as ch
    from ..learner import histogram as h

    dev = torch.device("cuda")
    N = N_ROWS
    gen = torch.Generator().manual_seed(1)
    bins = torch.randint(0, BC - 1, (G, N), generator=gen,
                         dtype=torch.int32).to(dev)
    gh = torch.stack([torch.randint(-128, 129, (N,), generator=gen),
                      torch.randint(0, 257, (N,), generator=gen),
                      torch.ones(N, dtype=torch.int64)]).to(torch.int32)
    gh = gh.to(dev)
    gh8 = torch.stack([torch.randint(-2, 3, (N,), generator=gen),
                       torch.randint(0, 5, (N,), generator=gen),
                       torch.ones(N, dtype=torch.int64)]).to(torch.int8)
    gh8 = gh8.to(dev)
    ghf = torch.stack([torch.randn(N, generator=gen),
                       torch.rand(N, generator=gen) * 0.25,
                       torch.ones(N)]).to(dev)
    pleaf = torch.randint(0, L + 1, (N,), generator=gen,
                          dtype=torch.int32).to(dev)
    smi = torch.cuda.get_device_name(0)
    if sys.argv[1:] in (["nat"], ["nat1"]):
        nat_part(torch, ch, h, smi, bins, gh, gh8, sys.argv[1:] == ["nat"])
        return 0
    seg_part(torch, ch, h, smi, sweep=sys.argv[1:] != ["seg1"])
    if sys.argv[1:] in (["seg"], ["seg1"]):
        return 0
    default_round = (ch.ROUND_CHUNK, ch.ROUND_SLOT_ITEMS, ch.ROUND_COLS)

    def tiling(chunks):
        def f(G_, N_, S_, Bc_, device):
            Sc, Gc, rows = default_tiling(G_, N_, S_, Bc_, device)
            return Sc, Gc, (rows if chunks is None else -(-N_ // chunks))
        return f

    try:
        # ---- hist_round over (chunk, columns)
        for name, S, used in (("first", 8, 1), ("s8", 8, 8),
                              ("s32", 32, 32), ("s48", 48, 48)):
            params = round_params(torch, gen, S, used, dev)
            pl = pleaf
            if name == "first":  # the root, split at its median bin
                pl = torch.full_like(pleaf, int(params[0, 0]))
                params[0, 2] = BC // 2 - 1
            _, hslot = h.round_partition_plain(bins, pl, params, S)
            kept = int((hslot < S).sum())
            for trio in (None,) + ROUND_SWEEP:
                (ch.ROUND_CHUNK, ch.ROUND_SLOT_ITEMS,
                 ch.ROUND_COLS) = trio or default_round
                t = {f"hist_round_{m}_ms": device_ms(torch, lambda: h.hist_round(
                        bins, g, pl, params, S, BC, L, quant=m != "f32",
                        levels=4 if m == "int8" else 256))
                     for m, g in (("int16", gh), ("int8", gh8), ("f32", ghf))}
                print(json.dumps({"device": smi, "round": name, "slots": S,
                                  "used": used, "kept_rows": kept,
                                  "chunk": trio and trio[0],
                                  "slot_items": trio and trio[1],
                                  "cols": trio and trio[2], **t}),
                      flush=True)
        ch.ROUND_CHUNK, ch.ROUND_SLOT_ITEMS, ch.ROUND_COLS = default_round
        # ---- hist_nat's integer modes over their sizes
        nat_part(torch, ch, h, smi, bins, gh, gh8)
        for S in (1, 8, 32, 48):
            slot = (torch.zeros(N, dtype=torch.int32, device=dev) if S == 1
                    else torch.randint(0, S + 1, (N,), generator=gen,
                                       dtype=torch.int32).to(dev))
            # the channel width alone: the same 4-level values as int8
            # and as int32 channels, timed int8, int32, int32, int8
            params = round_params(torch, gen, S, S, dev)
            gh8w = gh8.to(torch.int32)
            same = {"int8": [], "int32": []}
            for name in ("int8", "int32", "int32", "int8"):
                g_ = gh8 if name == "int8" else gh8w
                same[name].append((
                    device_ms(torch, lambda: h.hist_round(
                        bins, g_, pleaf, params, S, BC, L, levels=4)),
                    device_ms(torch, lambda: h.hist_nat_slots(
                        bins, g_, slot, S, BC, levels=4))))
            print(json.dumps({
                "device": smi, "slots": S,
                "same_4_levels": {
                    f"hist_{k}_{w}_ms": [t[i] for t in same[w]]
                    for i, k in enumerate(("round_device", "nat_device"))
                    for w in ("int8", "int32")}}), flush=True)
        # hist_nat's f32 mode at the percentile refit's shape
        rbins = torch.randint(0, BC, (1, N), generator=gen,
                              dtype=torch.int32).to(dev)
        w = torch.rand(N, generator=gen).to(dev)
        for S, share in ((L, 1), (L, 64), (31, 1), (31, 64)):
            inb = (torch.arange(N, device=dev) % share) == 0
            rgh = torch.stack([torch.where(inb, w, 0.0), torch.zeros_like(w),
                               inb.to(torch.float32)])
            rslot = torch.where(
                inb, torch.randint(0, S, (N,), generator=gen,
                                   dtype=torch.int32).to(dev), S)
            t = cuda_ms(torch, lambda: ch.hist_nat_f32(
                rbins, rgh, rslot, S, BC))
            print(json.dumps({"device": smi, "refit_rows_share":
                              f"1/{share}", "slots": S,
                              "hist_nat_f32_ms": t}), flush=True)
    finally:
        ch.ROUND_CHUNK, ch.ROUND_SLOT_ITEMS, ch.ROUND_COLS = default_round
    return 0


if __name__ == "__main__":
    sys.exit(main())
