"""Natural-order round-batched leaf-wise growth on one device.

The port of lightgbm_tpu/learner/rounds.py (grow_tree_rounds, the
single production grower of the JAX package) for axis_name=None, with
integer gradient levels (spec.quant: the default int16 path, and
use_quantized_grad, whose levels within +-127 ride the kernels' int8
mode, spec.quant_int8) or f32 gradients (tpu_hist_dtype=bf16x2). Rows
never move: the partition is a per-row leaf-id vector. Each round
- picks the top-k positive-gain leaves (k bounded by the remaining leaf
  budget, the kernel width of the S-ladder, and, on small data, half the
  remaining budget — rounds.py:415-459);
- runs ONE fused pass (histogram.hist_round: the hist_round kernel on
  the card) that partitions those leaves' rows and builds the smaller
  children's histograms;
- gets each larger child by parent subtraction, and searches the best
  split of all new children in one batched call.

The JAX loop is a lax.while_loop. Here a round's shapes do not depend
on the data: it works on W slots, the first n_split of them live (n_split
a device scalar), and the unused ones write to dump rows past the tree
(node L - 1, leaf L), as the JAX package's `.at[...].set(mode="drop")`
drops them; a round whose n_split is 0 changes nothing. The eager loop
reads n_split on the host each round (its one read a round) and runs a
round at W = n_split; a bounded loop (learner/device_loop.py: the fused
loop's CUDA graph, an IF node a round) runs round_cap rounds at W = S
and reads nothing. Every slot's and child's numbers are the same at
either width. lax.top_k's lower-index-first tie order comes from a
stable descending sort; taken slots are exactly slots 0..n_split-1 of
the gain-sorted leaves.

Categorical splits ride the same loop: the split records and node
tables carry is_cat and the (B,) left category set, and with
spec.has_cat the fused pass takes the round's per-slot sets (params
column 10 flags a categorical slot; hist_round's categorical mode).

The per-node extras (extra_trees, feature_fraction_bynode, CEGB,
interaction constraints; grower.make_node_candidates) draw each new
child's candidates in one batch over the round's 2W children, salts
2 * node + 1 (left) and + 2 (right), as the JAX package vmaps them
(rounds.py:898-930): a fixed number of device operations a round. The
round state carries each leaf's legal constraint groups and the
features on its path, and the tree's used features. A forced-split
plan (rounds.py:442-505) splits one prescribed leaf a round while
i < n: its record replaces the leaf's best one and its selection gain
is raised to BIG, so the round takes it first; an entry that would
leave a child empty falls back to the best-gain split.

Monotone constraints ride all three methods. Basic costs nothing beyond
the interval tensors. Intermediate and advanced (spec.mono_mode 1 / 2,
rounds.py:98-121, :527-556, :966-1104) carry the ancestry of every leaf
((L, L-1) bools: which nodes are above it, and on which side) and, under
advanced, every leaf's per-feature bin range. A round first defers any
candidate on the other side of a live monotone ancestor from a
higher-gain candidate of the same round (their bounds were computed
from each other's outputs before the round); node ids stay consecutive
across the holes. After the fused pass it extends the ancestry, takes
every leaf's bounds from grower.mono_bounds, and searches every live
leaf's best split again under them over the histogram pool, in one
batch. Neither composes with the per-node extras or a forced plan
(boosting falls back to basic with a warning).

A data axis (spec.axis_name, a parallel.comm.Mesh: rows sharded over
ranks, rounds.py:225-389 and :640-720 of the JAX package) reduces the
root sums and every histogram over the ranks; everything downstream is
computed from the reduced sums, so every rank takes the same splits and
partitions its own rows. The smaller child is chosen on the global counts
of the split records. With integer levels the histograms cross the wire
as integers (int32: neither gloo nor NCCL reduces the JAX package's int16,
histogram.rs_wire_dtype), exact in any order, so N ranks give the serial
trees bit for bit; f32 channels cross as f32 sums. Three reductions:
- a plain all-reduce of the (S, 3, G, Bc) smaller-child histograms;
- use_rs (quantized, no EFB / categoricals / extras / monotone
  refinement / voting / forced plan, rs_exact_ok): a reduce-scatter with
  per-rank feature ownership. Each rank keeps the (Gn = ceil(G / n))
  columns it owns, in its histogram pool too, searches them, and the
  global winner is an all-gather argmax whose ties go to the lowest
  rank (the lowest feature, as one device's search picks);
- voting (spec.voting_k): each round every rank proposes its top-k
  columns by local gain over the round's smaller children, votes and
  summed gains elect 2k columns (forced-plan columns pinned), and only
  those cross the wire. hist_valid tracks which stored columns hold
  global sums; a child searches only those.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .bundle import BundleInfo, expand_hist
from .grower import (
    CegbInfo,
    ForcedSplits,
    GrowerSpec,
    TreeArrays,
    empty_tree,
    forced_record,
    make_node_candidates,
    mono_bounds,
    monotone_child_intervals,
    select_global_rec,
    split_leaf_outputs,
)
from .device_loop import DeviceLoop
from .histogram import INT8_MAX, build_gh3, build_gh8_quant, \
    hist_nat_slots, hist_round, histogram, int_wire, root_sums, \
    root_sums_quant, rs_exact_ok, rs_wire_dtype
from .split import BIG, NEG_INF, SplitParams, SplitRecord, best_split, \
    cumsum_last, feature_best_gains, leaf_output, map_record

_TAIL_EXACT_ROWS = 32 * 8192  # rounds.py:436


def _put(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """dst[idx] = val in place along the first axis (index_put_, which is
    several times faster than index_copy_ on the CPU). Unused slots
    write the dump rows, whose duplicate writes are never read."""
    dst.index_put_((idx,), val)


def round_cap(num_leaves: int, slots: int) -> int:
    """The rounds a tree may take in a bounded loop (DeviceLoop BOUNDED /
    CAPTURE; the eager loop runs up to L - 1). Each round splits up to S
    leaves, and once half the budget is used it splits at most the
    leaves that the previous round made, so a tree that keeps finding
    splits needs about ceil((L - 1) / S) + log2(L) rounds; twice that
    plus 8 leaves room for rounds that split few leaves (the main path's
    255-leaf trees take ~10 of the cap's 36). A tree still growing at
    the cap sets the loop's overflow flag and is grown again on the
    eager loop (boosting.fused_collect)."""
    L, S = int(num_leaves), max(int(slots), 1)
    return max(1, min(L - 1, 2 * (-(-(L - 1) // S)
                                  + (L - 1).bit_length()) + 8))


def tree_round_cap(spec: GrowerSpec) -> int:
    """round_cap of a spec: a forced plan's phase takes one round a split
    on top of the rest. Under monotone intermediate / advanced the
    conflict guard can put off all but one split of a round (a 255-leaf
    Higgs-like tree takes 42-60 rounds on the card), so the cap is the
    most rounds any tree can take, L - 1; a replay skips the rounds a
    tree does not need."""
    L = spec.num_leaves
    if spec.mono_mode:
        return max(L - 1, 1)
    return min(max(L - 1, 1), round_cap(L, spec.rounds_slots or 1)
               + spec.n_forced)


def grow_tree_rounds(
    bins_fm: torch.Tensor,  # (G, N) int32, natural row order
    nan_bin: torch.Tensor,  # (F,) int32
    num_bins: torch.Tensor,  # (F,) int32
    mono: torch.Tensor,  # (F,) int32
    is_cat: torch.Tensor,  # (F,) bool
    grad: torch.Tensor,  # (N,) f32 INTEGER levels (spec.quant) or values
    hess: torch.Tensor,  # (N,) f32 INTEGER levels (spec.quant) or values
    mask: torch.Tensor,  # (N,) f32 validity * bagging
    feat_mask: torch.Tensor,  # (F,) bool
    params: SplitParams,
    spec: GrowerSpec,
    valid: Optional[torch.Tensor] = None,
    bundle: Optional[BundleInfo] = None,
    gh_scale: Optional[torch.Tensor] = None,  # (2,) [g_scale, h_scale]
    loop: Optional[DeviceLoop] = None,
    rng_key: Optional[torch.Tensor] = None,  # the tree's node key
    group_mat: Optional[torch.Tensor] = None,  # (NG, F) bool
    cegb: Optional[CegbInfo] = None,
    forced: Optional[ForcedSplits] = None,
    deferred: Optional[torch.Tensor] = None,  # 0-dim int64 counter
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree -> (tree arrays, natural-order row -> leaf, -1 on
    rows with valid == 0). gh_scale carries the level scales when
    spec.quant and must be None otherwise. loop: how the round loop runs
    (device_loop; EAGER when None, up to L - 1 rounds; a bounded loop
    runs tree_round_cap(spec)); the tree's (rounds taken, still growing)
    are appended to loop.trees as device tensors. rng_key, group_mat,
    cegb and forced: the per-node extras and forced plan of
    grower.grow_tree; deferred: grower.grow_tree's guard counter."""
    if spec.quant != (gh_scale is not None):
        raise ValueError("gh_scale is required with spec.quant (integer "
                         "levels) and refused without it")
    loop = loop or DeviceLoop()
    L = spec.num_leaves
    B = spec.num_bins
    G, N = bins_fm.shape
    dev = bins_fm.device
    S = min(spec.rounds_slots, max(L - 1, 1))
    Bc = spec.col_bins if (spec.efb and spec.col_bins) else B
    tail_exact = N <= _TAIL_EXACT_ROWS
    levels = spec.quant_levels
    has_mono = spec.has_mono
    # a dataset without categorical features skips their search
    cat_arg = is_cat if spec.has_cat else None
    F = num_bins.shape[0]
    per_node = spec.per_node
    n_forced = spec.n_forced
    mono_mode = spec.mono_mode
    if mono_mode and (per_node or n_forced):
        # rounds.py:186-198: the re-search takes the plain feature mask
        raise ValueError(
            "monotone intermediate/advanced excludes per-node extras / "
            "forced splits (boosting downgrades the combination to "
            "method=basic)")

    def exp_hist(h, g_, h_, c_):
        return expand_hist(h, g_, h_, c_, bundle) if spec.efb else h

    # ---- the data axis (rounds.py:225-313): which reduction, which wire
    ax = spec.axis_name
    n_ax = ax.size if ax is not None else 1
    use_voting = bool(spec.voting_k) and ax is not None
    use_rs = bool(
        ax is not None and spec.quant and not spec.efb and not spec.has_cat
        and not spec.cat_subset and not mono_mode and not per_node
        and not spec.voting_k and not n_forced
        and rs_exact_ok(N, n_ax, levels))
    wire = (rs_wire_dtype(N, n_ax, levels) if (ax is not None and spec.quant)
            else None)
    Gn = G
    nb_t, nan_t, mono_t, fm_t = num_bins, nan_bin, mono, feat_mask
    if use_rs:
        Gn = -(-G // n_ax)  # columns a rank owns, the axis padded to n Gn
        lo_f = ax.rank * Gn

        def my_block(t, fill):
            """This rank's (Gn,) slice of a feature table padded to n Gn
            (padding: no bins, so no candidate)."""
            pad = torch.full((n_ax * Gn - G,) + tuple(t.shape[1:]), fill,
                             dtype=t.dtype, device=dev)
            return torch.cat([t, pad])[lo_f:lo_f + Gn]

        nb_t, nan_t = my_block(num_bins, 0), my_block(nan_bin, -1)
        mono_t, fm_t = my_block(mono, 0), my_block(feat_mask, False)

    def reduce_hist(h):
        """(..., G, Bc) local sums -> global: the owned block under
        use_rs, else every column (integers on the integer wire)."""
        if use_rs:
            return ax.reduce_scatter(int_wire(h, wire), dim=-2).to(
                torch.float32)
        if ax is None:
            return h
        return ax.all_reduce(int_wire(h, wire)).to(torch.float32)

    if spec.quant:
        # (3, N) int8 in the int8 mode (spec.quant_int8 below 127 levels),
        # else int32: at 127 levels a hessian level can reach 128, and
        # int32 channels give the same integer sums without reading the
        # levels back to choose
        gh = build_gh8_quant(grad * mask, hess * mask, mask,
                             int8_levels=levels if (
                                 spec.quant_int8 and levels < INT8_MAX)
                             else 0)
        scale3 = torch.stack([gh_scale[0], gh_scale[1],
                              torch.ones((), dtype=torch.float32,
                                         device=dev)])
        root = root_sums_quant(gh, ax) * scale3  # (3,)
        hist0 = hist_nat_slots(bins_fm, gh,
                               torch.zeros(N, dtype=torch.int32, device=dev),
                               1, Bc, levels=levels)[0]
        hist0 = reduce_hist(hist0) * scale3[:, None, None]
    else:
        gh = build_gh3(grad * mask, hess * mask, mask)  # (3, N) f32
        root = root_sums(gh, ax)
        hist0 = reduce_hist(histogram(bins_fm, gh, Bc))
    root_out = leaf_output(root[0], root[1], params)
    big = torch.full((1,), BIG, dtype=torch.float32, device=dev)
    fm0, rb0, pen0 = feat_mask, None, None
    if per_node:
        # per-leaf constraint groups and path features (one row past the
        # tree's, as below), the tree's used features; the root's draws
        # take salt 0
        node_candidates = make_node_candidates(
            spec, params, feat_mask, num_bins, nan_bin, rng_key, group_mat,
            cegb)
        leaf_groups = torch.ones((L + 1, max(1, spec.n_groups)),
                                 dtype=torch.bool, device=dev)
        path_used = torch.zeros((L + 1, F), dtype=torch.bool, device=dev)
        feat_used = (cegb.used.clone() if spec.cegb else
                     torch.zeros(F, dtype=torch.bool, device=dev))
        fm0, rb0, pen0 = node_candidates(
            torch.zeros(1, dtype=torch.int64, device=dev), leaf_groups[:1],
            path_used[:1], root[2:3], feat_used)
    rec0 = best_split(
        exp_hist(hist0[None], root[0:1], root[1:2], root[2:3]),
        root[0:1], root[1:2], root[2:3], nb_t, nan_t, mono_t, params,
        fm_t if use_rs else fm0, parent_output=root_out[None],
        cmin=-big if has_mono else None, cmax=big if has_mono else None,
        has_mono=has_mono, is_cat=cat_arg, cat_subset=spec.cat_subset,
        penalty=pen0, rand_bin=rb0,
    )
    if use_rs:
        rec0 = select_global_rec(rec0, ax, lo_f)

    # The working arrays carry one row past the tree's: node L - 1 and
    # leaf L take the writes of unused slots (a round splits n_split of
    # its S slots, known only on the device) and are never read for a
    # used slot; the tree returned is a view without them.
    # the histogram pool: the owned column block under use_rs
    hist = torch.zeros((L + 1, 3, Gn, Bc), dtype=torch.float32, device=dev)
    hist[0] = hist0
    if use_voting:
        # hist_valid[leaf, f]: the stored column holds global sums (the
        # root's all do)
        hist_valid = torch.ones((L + 1, F), dtype=torch.bool, device=dev)
        kG = min(spec.voting_k, G)
        k2 = min(2 * spec.voting_k, G)
    zf = lambda: torch.zeros(L + 1, dtype=torch.float32, device=dev)
    zi = lambda: torch.zeros(L + 1, dtype=torch.int32, device=dev)
    best = SplitRecord(
        gain=torch.full((L + 1,), NEG_INF, dtype=torch.float32, device=dev),
        feature=zi(), bin=zi(),
        default_left=torch.zeros(L + 1, dtype=torch.bool, device=dev),
        is_cat=(torch.zeros(L + 1, dtype=torch.bool, device=dev)
                if spec.has_cat else None),
        cat_mask=(torch.zeros((L + 1, B), dtype=torch.bool, device=dev)
                  if spec.has_cat else None),
        left_g=zf(), left_h=zf(), left_c=zf(),
        right_g=zf(), right_h=zf(), right_c=zf(),
    )
    map_record(lambda b, r: b[:1].copy_(r[:1]), best, rec0)
    t = empty_tree(L + 1, B, dev)
    t.leaf_value[0] = root_out
    t.leaf_weight[0] = root[1]
    t.leaf_count[0] = root[2]
    valid_f = (torch.ones(N, dtype=torch.float32, device=dev)
               if valid is None else valid)
    pleaf = torch.where(valid_f > 0, 0, L).to(torch.int32)
    leaf_g, leaf_h, leaf_c = zf(), zf(), zf()
    leaf_g[0], leaf_h[0], leaf_c[0] = root[0], root[1], root[2]
    leaf_parent = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
    leaf_min = torch.full((L + 1,), -BIG, dtype=torch.float32, device=dev)
    leaf_max = torch.full((L + 1,), BIG, dtype=torch.float32, device=dev)
    if mono_mode:
        # ancestry of each leaf (row L the dump's): anc_in[x, a] node a
        # is above leaf x, anc_left[x, a] on its left side
        anc_in = torch.zeros((L + 1, L - 1), dtype=torch.bool, device=dev)
        anc_left = torch.zeros_like(anc_in)
        iota_n = torch.arange(L - 1, device=dev)
    if mono_mode == 2:
        # each leaf's bin range (lo, hi] per feature
        leaf_flo = torch.full((L + 1, F), -1, dtype=torch.int32, device=dev)
        leaf_fhi = torch.full((L + 1, F), B, dtype=torch.int32, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)  # splits so far
    n_rounds = torch.zeros((), dtype=torch.int32, device=dev)
    unused_row = torch.zeros(16, dtype=torch.int32, device=dev)
    unused_row[:1].fill_(-1)
    if not spec.efb:
        unused_row[8:9].fill_(-1)

    forced_now = []  # this round's forced_step, until the round runs

    def forced_step():
        """Plan entry min(i, n - 1) on its leaf's histogram: (leaf,
        feature, bin, whether it applies now with both children
        non-empty, the left and parent (g, h, count) sums); the JAX
        package's forced block of round_step and _forced_valid. Computed
        once a round: the loop's predicate, the split count and the
        round read the same state."""
        if not forced_now:
            forced_now.append(_forced_step())
        return forced_now[0]

    def _forced_step():
        # (1,) index tensors throughout: a 0-dim tensor index would be
        # read back to the host
        fi = torch.clamp_max(i, n_forced - 1).reshape(1)
        fl, ff, fb = (a.index_select(0, fi).long()
                      for a in (forced.leaf, forced.feature, forced.bin))
        pg, ph, pc = (a.index_select(0, fl) for a in (leaf_g, leaf_h, leaf_c))
        fh = exp_hist(hist.index_select(0, fl), pg, ph, pc)[0]  # (3, F, B)
        left = cumsum_last(fh.index_select(1, ff)[:, 0])
        flg, flh, flc = left.index_select(1, fb)[:, 0]
        fpg, fph, fpn = pg[0], ph[0], pc[0]
        use = (i < n_forced) & (flc > 0) & (fpn - flc > 0)
        return fl[0], ff[0], fb[0], use, (flg, flh, flc, fpg, fph, fpn)

    def growing():
        keep = best.gain[:L].max() > 0.0
        if n_forced:
            # a forced step that can split keeps the tree growing
            keep = keep | forced_step()[3]
        return (i < L - 1) & keep

    def split_count():
        """Leaves this round splits: the JAX package's min(budget, width,
        n_cand), where its width ladder picks the smallest width >=
        n_cand, so the number is min(budget, S, n_cand) at any width; 0
        exactly when the tree has stopped (then a round over S static
        slots changes nothing: every write goes to the dump rows). In a
        forced phase one leaf: the plan's when its entry applies, else
        the best one when any gain is positive."""
        n_pos = (best.gain[:L] > 0.0).sum()
        budget0 = (L - 1) - i
        n_cand = torch.minimum(budget0, n_pos)
        if tail_exact:
            n_cand = torch.minimum(n_cand,
                                   torch.clamp_min((budget0 + 1) // 2, 1))
        if n_forced:
            use = forced_step()[3]
            n_cand = torch.where(i < n_forced,
                                 (use | (n_pos > 0)).to(n_cand.dtype),
                                 n_cand)
        return torch.clamp(torch.minimum(n_cand, budget0), 0, S)

    def vote_reduce(sh, act):
        """The per-round election (rounds.py:640-720, GlobalVoting of
        parallel_tree_learner.h:152): every rank's top-k columns by local
        gain over the round's live smaller children, votes and summed
        gains over the axis elect 2k (ties to the lower column, as
        lax.top_k), the forced plan's columns pinned; only the elected
        columns are reduced. -> (the slots' histograms, global at the
        elected columns and zero elsewhere, the (F,) elected mask)."""
        local = sh * scale3[:, None, None] if spec.quant else sh
        lsum = local[:, :, 0, :].sum(dim=-1)  # (W, 3) slot totals
        lg_s = feature_best_gains(
            exp_hist(local, lsum[:, 0], lsum[:, 1], lsum[:, 2]),
            lsum[:, 0], lsum[:, 1], lsum[:, 2], num_bins, nan_bin, mono,
            params, feat_mask, is_cat=cat_arg, cat_subset=spec.cat_subset)
        lg_s = torch.where(act[:, None], lg_s,
                           torch.full_like(lg_s, NEG_INF))
        fgain = lg_s.amax(dim=0)  # (F,)
        if spec.efb:
            col_gain = torch.full((G,), NEG_INF, dtype=torch.float32,
                                  device=dev).scatter_reduce(
                0, bundle.bundle_of.long(), fgain, "amax")
        else:
            col_gain = fgain
        topi = torch.sort(col_gain, descending=True, stable=True).indices[:kG]
        in_topk = torch.zeros(G, dtype=torch.bool, device=dev)
        in_topk[topi] = True
        votes = ax.all_reduce(in_topk.to(torch.float32))
        score = ax.all_reduce(torch.where(
            in_topk, torch.clamp_min(col_gain, 0.0),
            torch.zeros_like(col_gain)))
        eidx = torch.sort(votes * 1e12 + score, descending=True,
                          stable=True).indices[:k2]
        if n_forced:
            fcols = (bundle.bundle_of[forced.feature.long()] if spec.efb
                     else forced.feature).long()
            eidx = torch.cat([eidx, fcols])
        elected = torch.zeros(G, dtype=torch.bool, device=dev)
        elected[eidx] = True
        comp = ax.all_reduce(int_wire(sh[:, :, eidx, :], wire)).to(
            torch.float32)
        out = torch.zeros_like(sh)
        out[:, :, eidx, :] = comp
        el = elected[bundle.bundle_of.long()] if spec.efb else elected
        return out, el

    def one_round(W: int):
        """One round over W slots: S in a bounded loop, the host-read
        split count on the eager loop (each slot's and child's numbers
        are the same at any width)."""
        n_split = split_count()
        slot = torch.arange(W, device=dev)
        act = slot < n_split
        dump_node = torch.full((W,), L - 1, dtype=torch.int64, device=dev)
        dump_leaf = torch.full((W,), L, dtype=torch.int64, device=dev)

        # ---- select: top-k by gain, lower leaf index first on ties; a
        # forced entry that applies goes first
        gain_sel = best.gain[:L]
        if n_forced:
            fl, ff, fb, use_f, sums = forced_step()
            at_fl = use_f & (torch.arange(L, device=dev) == fl)
            gain_sel = torch.where(at_fl, torch.full_like(gain_sel, BIG),
                                   gain_sel)
        order = torch.sort(gain_sel, descending=True,
                           stable=True).indices[:W]
        rank = slot
        if mono_mode:
            # the same-round conflict guard (rounds.py:527-548): a
            # candidate that shares a live monotone ancestor with a
            # higher-gain candidate, on the other side of it, waits for
            # the next round; node ids stay consecutive over the holes
            node_m = ((mono[t.node_feature[:L - 1].long()] != 0)
                      & ~t.node_cat[:L - 1] & (iota_n < i))
            a_in, a_lf = anc_in[order], anc_left[order]  # (W, L-1)
            conf = (a_in[:, None] & a_in[None] & (a_lf[:, None] ^ a_lf[None])
                    & node_m).any(dim=2)  # (W, W)
            earlier = slot[None, :] < slot[:, None]
            take = act & ~(conf & earlier & act[None, :]).any(dim=1)
            if deferred is not None:
                deferred.add_((act & ~take).sum())
            act = take
            rank = torch.cumsum(act.to(torch.int64), dim=0) - 1
        tl = torch.where(act, order, dump_leaf)  # taken leaves
        node_ids = torch.where(act, i + rank, dump_node)
        new_ids = torch.where(act, i + rank + 1, dump_leaf)
        rec = map_record(lambda f: f[tl], best)
        if n_forced:
            rec = forced_record(rec, use_f & (tl == fl), ff, fb, sums,
                                 params)

        # ---- outputs / monotone intervals of the taken splits
        pmin, pmax = leaf_min[tl], leaf_max[tl]
        parent_out = t.leaf_value[tl]
        lo, ro = split_leaf_outputs(
            rec, params, parent_out,
            pmin if has_mono else None, pmax if has_mono else None,
            num_bins, spec.cat_subset)
        if has_mono and not mono_mode:
            lmin, lmax, rmin, rmax = monotone_child_intervals(
                rec.feature, rec.is_cat, mono, lo, ro, pmin, pmax)
        depth_new = t.leaf_depth[tl] + 1

        # ---- tree bookkeeping (Tree::Split, batched)
        p = leaf_parent[tl]
        has_p = (p >= 0) & act
        pc = p.clamp_min(0)
        p_is_left = t.node_left[pc] == ~tl.to(torch.int32)
        nid32 = node_ids.to(torch.int32)
        _put(t.node_left, torch.where(has_p & p_is_left, pc, dump_node),
             nid32)
        _put(t.node_right, torch.where(has_p & ~p_is_left, pc, dump_node),
             nid32)
        _put(t.node_left, node_ids, ~tl.to(torch.int32))
        _put(t.node_right, node_ids, ~new_ids.to(torch.int32))
        _put(t.node_feature, node_ids, rec.feature)
        _put(t.node_bin, node_ids, rec.bin)
        _put(t.node_gain, node_ids, rec.gain)
        _put(t.node_default_left, node_ids, rec.default_left)
        if spec.has_cat:
            _put(t.node_cat, node_ids, rec.is_cat)
            _put(t.node_cat_mask, node_ids, rec.cat_mask)
        _put(t.node_value, node_ids, parent_out)
        _put(t.node_weight, node_ids, leaf_h[tl])
        _put(t.node_count, node_ids, leaf_c[tl])
        for arr, left, right in ((t.leaf_value, lo, ro),
                                 (t.leaf_weight, rec.left_h, rec.right_h),
                                 (t.leaf_count, rec.left_c, rec.right_c),
                                 (t.leaf_depth, depth_new, depth_new)):
            _put(arr, tl, left)
            _put(arr, new_ids, right)

        # ---- the fused pass: partition + smaller-child histograms
        left_smaller = rec.left_c <= rec.right_c  # (S,)
        feat = rec.feature.long()
        col = bundle.bundle_of[feat] if spec.efb else rec.feature
        cols = [tl, col, rec.bin, rec.default_left, nan_bin[feat],
                left_smaller, new_ids]
        if spec.efb:
            cols += [bundle.off_lo[feat], bundle.mfb[feat],
                     bundle.width[feat]]
        else:
            cols += [rec.bin] * 3  # replaced by the unused row's values
        if spec.has_cat:
            cols.append(rec.is_cat)
        params16 = torch.zeros((W, 16), dtype=torch.int32, device=dev)
        params16[:, :len(cols)] = torch.stack(
            [c_.to(torch.int32) for c_ in cols], dim=1)
        # an unused slot: leaf -1, everything else 0 (column 8, the EFB
        # most-frequent bin, -1 without EFB on every slot)
        params16.copy_(torch.where(act[:, None], params16, unused_row))
        if not spec.efb:
            params16[:, 7:10] = unused_row[7:10]
        cat_mask = None
        if spec.has_cat:
            # (S, Bc): the kernel's bin space is the bundle width
            cat_mask = torch.zeros((W, Bc), dtype=torch.bool, device=dev)
            cat_mask[:, :B] = rec.cat_mask & act[:, None]
        slot_hists, pleaf_new = hist_round(bins_fm, gh, pleaf, params16, W,
                                           Bc, L, quant=spec.quant,
                                           cat_mask=cat_mask, levels=levels)
        pleaf.copy_(pleaf_new)
        el = None
        if use_voting:
            slot_hists, el = vote_reduce(slot_hists, act)
        else:
            slot_hists = reduce_hist(slot_hists)
        parent_s = hist[tl]
        if spec.quant:
            sums = slot_hists  # exact integer sums
            small = sums * scale3[:, None, None]
            # ---- larger child by parent subtraction. parent - sums *
            # scale with ONE rounding: XLA contracts the JAX package's
            # multiply-subtract into a fused multiply-add, and the
            # integer sums times an f32 scale are exact in f64
            large = (parent_s.double() - sums.double()
                     * scale3.double()[:, None, None]).float()
        else:
            small = slot_hists
            large = parent_s - small
        ls = left_smaller[:, None, None, None]
        left_s = torch.where(ls, small, large)
        right_s = torch.where(ls, large, small)
        _put(hist, tl, left_s)
        _put(hist, new_ids, right_s)
        ch_valid = None
        if use_voting:
            # the smaller child is global at the elected columns; the
            # larger one's subtraction also needs the parent's column
            # global (rounds.py:845-863)
            v_small = el[None, :].expand(W, F)
            v_large = v_small & hist_valid[tl]
            ls_v = left_smaller[:, None]
            v_left = torch.where(ls_v, v_small, v_large)
            v_right = torch.where(ls_v, v_large, v_small)
            _put(hist_valid, tl, v_left)
            _put(hist_valid, new_ids, v_right)
            ch_valid = torch.cat([v_left, v_right])
        for arr, left, right in ((leaf_g, rec.left_g, rec.right_g),
                                 (leaf_h, rec.left_h, rec.right_h),
                                 (leaf_c, rec.left_c, rec.right_c)):
            _put(arr, tl, left)
            _put(arr, new_ids, right)

        if mono_mode:
            mono_round(tl, new_ids, node_ids, act, rec)
            return
        # ---- best splits of the 2 W new children, one batch
        ch_g = torch.cat([rec.left_g, rec.right_g])
        ch_h = torch.cat([rec.left_h, rec.right_h])
        ch_c = torch.cat([rec.left_c, rec.right_c])
        ch_po = torch.cat([lo, ro])
        if has_mono:
            ch_mn, ch_mx = torch.cat([lmin, rmin]), torch.cat([lmax, rmax])
        else:
            ch_mn = ch_mx = None
        ch_fm, ch_rb, ch_pen = feat_mask, None, None
        if per_node:
            # the 2 W children's candidates in one batch: groups still
            # legal and path features from the parent plus its split
            # feature; the tree's used features first take the round's
            f_oh = (torch.arange(F, device=dev)[None, :]
                    == rec.feature.long()[:, None])  # (W, F)
            ch_grp = leaf_groups[tl]
            if spec.n_groups:
                ch_grp = ch_grp & group_mat[:, rec.feature.long()].T
            ch_pu = path_used[tl] | f_oh
            feat_used.logical_or_((f_oh & act[:, None]).any(dim=0))
            node = i + slot
            ch_fm, ch_rb, ch_pen = node_candidates(
                torch.cat([2 * node + 1, 2 * node + 2]),
                torch.cat([ch_grp, ch_grp]), torch.cat([ch_pu, ch_pu]), ch_c,
                feat_used)
            for arr, v in ((leaf_groups, ch_grp), (path_used, ch_pu)):
                _put(arr, tl, v)
                _put(arr, new_ids, v)
        if use_rs:
            ch_fm = fm_t
        if ch_valid is not None:
            ch_fm = (ch_fm if ch_fm.dim() == 2 else ch_fm[None]) & ch_valid
        ch_rec = best_split(
            exp_hist(torch.cat([left_s, right_s]), ch_g, ch_h, ch_c),
            ch_g, ch_h, ch_c, nb_t, nan_t, mono_t, params, ch_fm,
            parent_output=ch_po, cmin=ch_mn, cmax=ch_mx, has_mono=has_mono,
            is_cat=cat_arg, cat_subset=spec.cat_subset,
            penalty=ch_pen, rand_bin=ch_rb,
        )
        if use_rs:
            ch_rec = select_global_rec(ch_rec, ax, lo_f)
        depth_ok = (torch.ones_like(depth_new, dtype=torch.bool)
                    if spec.max_depth <= 0 else depth_new < spec.max_depth)
        ch_gain = torch.where(torch.cat([depth_ok, depth_ok]), ch_rec.gain,
                              torch.full_like(ch_rec.gain, NEG_INF))
        ch_leaf = torch.cat([tl, new_ids])
        map_record(lambda b, v: _put(b, ch_leaf, v), best,
                   ch_rec._replace(gain=ch_gain))
        if has_mono:
            for arr, left, right in ((leaf_min, lmin, rmin),
                                     (leaf_max, lmax, rmax)):
                _put(arr, tl, left)
                _put(arr, new_ids, right)
        end_round(tl, new_ids, node_ids, n_split)

    def end_round(tl, new_ids, node_ids, n_taken):
        _put(leaf_parent, tl, node_ids)
        _put(leaf_parent, new_ids, node_ids)
        i.add_(n_taken)
        forced_now.clear()  # the state moved on
        n_rounds.add_((n_taken > 0).to(torch.int32))

    def mono_round(tl, new_ids, node_ids, act, rec):
        """The end of an intermediate / advanced round (rounds.py
        :966-1104): the ancestry and (advanced) the bin ranges take the
        round's splits, every leaf's bounds are computed again
        (grower.mono_bounds), and every live leaf's best split is searched
        again under them in one batch. A round that splits nothing
        computes the same bounds and splits again."""
        oh = (iota_n[None, :] == node_ids[:, None]) & act[:, None]
        row_in, row_lf = anc_in[tl], anc_left[tl]  # before the round
        _put(anc_in, tl, row_in | oh)  # the left child keeps the id
        _put(anc_left, tl, row_lf | oh)
        _put(anc_in, new_ids, row_in | oh)
        _put(anc_left, new_ids, row_lf)
        flo = fhi = None
        if mono_mode == 2:
            # a numerical split narrows its feature's range in both
            # children; categorical splits and features with a NaN bin
            # keep the full range
            feat = rec.feature.long()
            refine = act & (nan_bin[feat] < 0)
            if rec.is_cat is not None:
                refine = refine & ~rec.is_cat
            f_oh = ((torch.arange(F, device=dev)[None, :] == feat[:, None])
                    & refine[:, None])
            lo_p, hi_p = leaf_flo[tl], leaf_fhi[tl]
            b_ = rec.bin[:, None]
            _put(leaf_fhi, tl, torch.where(f_oh, torch.minimum(hi_p, b_),
                                           hi_p))
            _put(leaf_flo, new_ids, torch.where(
                f_oh, torch.maximum(lo_p, b_), lo_p))
            _put(leaf_fhi, new_ids, hi_p)
            flo, fhi = leaf_flo[:L], leaf_fhi[:L]
        n_taken = act.sum()
        i_new = i + n_taken
        nmin, nmax = mono_bounds(mono_mode, anc_in[:L], anc_left[:L],
                                 t.leaf_value[:L], t.node_feature[:L - 1],
                                 t.node_cat[:L - 1], mono, i_new, flo, fhi)
        lg, lh, lc = leaf_g[:L], leaf_h[:L], leaf_c[:L]
        rec_all = best_split(
            exp_hist(hist[:L], lg, lh, lc), lg, lh, lc, num_bins, nan_bin,
            mono, params, feat_mask, parent_output=t.leaf_value[:L],
            cmin=nmin, cmax=nmax, has_mono=True, is_cat=cat_arg,
            cat_subset=spec.cat_subset)
        live = torch.arange(L, device=dev) <= i_new
        if spec.max_depth > 0:
            live = live & (t.leaf_depth[:L] < spec.max_depth)
        rec_all = rec_all._replace(gain=torch.where(
            live, rec_all.gain, torch.full_like(rec_all.gain, NEG_INF)))
        map_record(lambda b, v: b[:L].copy_(v), best, rec_all)
        leaf_min[:L].copy_(nmin)
        leaf_max[:L].copy_(nmax)
        end_round(tl, new_ids, node_ids, n_taken)

    if loop.bounded:
        loop.run(tree_round_cap(spec), growing, lambda: one_round(S))
    else:
        for _ in range(L - 1):  # one host read a round
            n = int(split_count())
            if n == 0:
                break
            one_round(n)
    loop.trees.append((n_rounds, growing()))

    node = slice(0, L - 1)
    leaf = slice(0, L)
    t = TreeArrays(
        num_nodes=i.to(torch.int32),
        **{f: getattr(t, f)[node] for f in TreeArrays._fields
           if f.startswith("node_")},
        **{f: getattr(t, f)[leaf] for f in TreeArrays._fields
           if f.startswith("leaf_")},
    )
    row_leaf = pleaf
    if valid is not None:
        row_leaf = torch.where(valid > 0, row_leaf,
                               torch.full_like(row_leaf, -1))
    return t, row_leaf

