"""Leaf-wise tree growth over a physically permuted bin matrix: the
sequential grower behind tpu_growth_mode=exact, with its batched round
phase (tpu_growth_rounds).

The port of lightgbm_tpu/learner/permuted.py (grow_tree_permuted) for
one device. The bin matrix, the f32 channels and a row-origin vector are
kept reordered so that every leaf owns one contiguous segment
[begin, begin + count) (the reference's data_partition.hpp). A split
then costs O(segment):
- a stable partition of the parent segment: left rows in their order,
  then right rows, placed by an exclusive prefix sum of the go-left
  flags (no sort, no nonzero: nothing waits for the host);
- the smaller child's histogram over its segment (histogram.histogram:
  the hist kernel on the card, which reads the segment's bounds from
  device memory), the larger child by parent subtraction;
- the best splits of both children in one batched search.

The JAX grower's capacity ladder (segment_caps, lax.switch) exists for
XLA's static shapes; eager PyTorch slices the exact segment instead.
The loop is a Python loop with ONE host read per split: the next leaf
to split, whether its gain is positive, and its segment bounds. The
tree's links (node children, leaf parents, depths) live on the host,
since they depend only on those ints.

The round phase (spec.rounds) splits every positive-gain leaf at once
while the leaf budget allows it (the budget guard of permuted.py:521):
one multi-leaf stable partition of all N rows through two exclusive
prefix sums, and one hist_slots call for all smaller children
(S = num_leaves // 2 + 1 slots). One host read per round: the
positive-gain mask. The sequential splits then finish the tree.

A row of a categorical split goes left iff its bin is in the split's
category set (cat_mask), in both phases (permuted.py _go_left, :367-372);
the histogram kernels do not depend on the split type.

The per-node extras (grower.make_node_candidates) draw the candidates
of a split's two children in one batch, salts 2 i + 1 and 2 i + 2 at
split i (permuted.py:813-840), and a forced-split plan (:559-622) takes
the first n splits at their prescribed leaves while an entry leaves both
children non-empty; each rides the split's one host read. Neither
combines with the round phase (permuted.py:212-213, as in the JAX
package).

Monotone intermediate (spec.mono_mode 1, permuted.py:841-918) keeps
every leaf's ancestry ((L, L-1) bools on the device) and, after each
split, takes every leaf's bounds from grower.mono_bounds and searches
every live leaf's best split again under them in one batch: device
work inside the split, no read beyond the split's one. It excludes the
round phase, the per-node extras and a forced plan, as in the JAX
package (boosting falls back or turns the round phase off); advanced
becomes intermediate on this grower (boosting, with a warning).

Not ported, refused upstream: voting and any mesh axis (ROADMAP queue
A). Monotone basic, NaN default-left, max_depth, EFB bundles and
categorical splits are kept.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .bundle import BundleInfo, decode_feature_bins, expand_hist
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
    split_leaf_outputs,
)
from .histogram import build_gh3, hist_slots, histogram, root_sums
from .split import BIG, NEG_INF, SplitParams, SplitRecord, best_split, \
    cumsum_last, first_argmax, leaf_output, map_record


def _excl_prefix(x: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N + 1,) int64 exclusive prefix sums."""
    cs = torch.cumsum(x.to(torch.int64), dim=0)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=x.device), cs])


class _Grower:
    """State of one tree: device tensors for everything the split search
    reads, host lists for the tree's links."""

    def __init__(self, bins_fm, nan_bin, num_bins, mono, is_cat, grad, hess,
                 mask, feat_mask, params: SplitParams, spec: GrowerSpec,
                 valid, bundle: Optional[BundleInfo], rng_key=None,
                 group_mat=None, cegb: Optional[CegbInfo] = None,
                 forced: Optional[ForcedSplits] = None):
        L, B = spec.num_leaves, spec.num_bins
        G, N = bins_fm.shape
        dev = bins_fm.device
        self.L, self.N, self.dev = L, N, dev
        self.Bc = spec.col_bins if (spec.efb and spec.col_bins) else B
        self.spec, self.params = spec, params
        self.nan_bin, self.num_bins, self.mono = nan_bin, num_bins, mono
        # a dataset without categorical features skips their search
        self.is_cat = is_cat if spec.has_cat else None
        self.feat_mask, self.bundle = feat_mask, bundle
        self.has_mono = spec.has_mono

        gh = build_gh3(grad * mask, hess * mask, mask)  # (3, N) f32
        root = root_sums(gh)
        hist0 = histogram(bins_fm, gh, self.Bc)
        root_out = leaf_output(root[0], root[1], params)
        big = torch.full((1,), BIG, dtype=torch.float32, device=dev)
        # the forced plan on the host (the split loop indexes it there)
        self.forced = (None if forced is None else list(zip(
            forced.leaf.tolist(), forced.feature.tolist(),
            forced.bin.tolist())))
        self.group_mat = group_mat
        fm0, rb0, pen0 = feat_mask, None, None
        if spec.per_node:
            F = num_bins.shape[0]
            self.node_candidates = make_node_candidates(
                spec, params, feat_mask, num_bins, nan_bin, rng_key,
                group_mat, cegb)
            self.leaf_groups = torch.ones((L, max(1, spec.n_groups)),
                                          dtype=torch.bool, device=dev)
            self.path_used = torch.zeros((L, F), dtype=torch.bool,
                                         device=dev)
            self.feat_used = (cegb.used.clone() if spec.cegb else
                              torch.zeros(F, dtype=torch.bool, device=dev))
            fm0, rb0, pen0 = self.node_candidates(
                torch.zeros(1, dtype=torch.int64, device=dev),
                self.leaf_groups[:1], self.path_used[:1], root[2:3],
                self.feat_used)
        rec0 = best_split(
            self.exp_hist(hist0[None], root[0:1], root[1:2], root[2:3]),
            root[0:1], root[1:2], root[2:3], num_bins, nan_bin, mono, params,
            fm0, parent_output=root_out[None],
            cmin=-big if self.has_mono else None,
            cmax=big if self.has_mono else None, has_mono=self.has_mono,
            is_cat=self.is_cat, cat_subset=spec.cat_subset,
            penalty=pen0, rand_bin=rb0,
        )

        self.pbins = bins_fm.clone()  # leaf-grouped along the row axis
        self.pgh = gh
        self.pperm = torch.arange(N, dtype=torch.int64, device=dev)
        self.valid_f = (torch.ones(N, dtype=torch.float32, device=dev)
                        if valid is None else valid)
        self.seg_begin = torch.full((L,), N, dtype=torch.int64, device=dev)
        self.seg_begin[0] = 0
        self.seg_count = torch.zeros(L, dtype=torch.int64, device=dev)
        self.seg_count[0] = (self.valid_f > 0).sum()
        self.hist = torch.zeros((L, 3, G, self.Bc), dtype=torch.float32,
                                device=dev)
        self.hist[0] = hist0
        zf = lambda: torch.zeros(L, dtype=torch.float32, device=dev)
        zi = lambda: torch.zeros(L, dtype=torch.int32, device=dev)
        self.best = SplitRecord(
            gain=torch.full((L,), NEG_INF, dtype=torch.float32, device=dev),
            feature=zi(), bin=zi(),
            default_left=torch.zeros(L, dtype=torch.bool, device=dev),
            is_cat=(torch.zeros(L, dtype=torch.bool, device=dev)
                    if spec.has_cat else None),
            cat_mask=(torch.zeros((L, B), dtype=torch.bool, device=dev)
                      if spec.has_cat else None),
            left_g=zf(), left_h=zf(), left_c=zf(),
            right_g=zf(), right_h=zf(), right_c=zf(),
        )
        for f, r in zip(self.best, rec0):
            if f is not None:
                f[0] = r[0]
        self.leaf_g, self.leaf_h, self.leaf_c = zf(), zf(), zf()
        self.leaf_g[0], self.leaf_h[0], self.leaf_c[0] = root
        self.leaf_min = torch.full((L,), -BIG, dtype=torch.float32,
                                   device=dev)
        self.leaf_max = torch.full((L,), BIG, dtype=torch.float32, device=dev)
        if spec.mono_mode:
            # ancestry: anc_in[x, a] node a is above leaf x, anc_left[x, a]
            # on its left side
            self.anc_in = torch.zeros((L, L - 1), dtype=torch.bool,
                                      device=dev)
            self.anc_left = torch.zeros_like(self.anc_in)
        self.t = empty_tree(L, B, dev)
        self.t.leaf_value[0] = root_out
        self.t.leaf_weight[0] = root[1]
        self.t.leaf_count[0] = root[2]
        # host side: links and depths
        self.i = 0
        self.node_left = np.zeros(max(L - 1, 1), np.int32)
        self.node_right = np.zeros(max(L - 1, 1), np.int32)
        self.leaf_parent = [-1] * L
        self.leaf_depth = [0] * L

    def exp_hist(self, h, g_, h_, c_):
        """Bundle-space histograms -> per-feature for the split search."""
        if self.spec.efb:
            return expand_hist(h, g_, h_, c_, self.bundle)
        return h

    def link(self, l: int, node: int, new: int) -> None:
        """Tree::Split on the host links: node `node` takes leaf l's
        place under its parent, with children ~l and ~new."""
        p = self.leaf_parent[l]
        if p >= 0:
            if self.node_left[p] == ~l:
                self.node_left[p] = node
            else:
                self.node_right[p] = node
        self.node_left[node] = ~l
        self.node_right[node] = ~new

    def children_best(self, left_h, right_h, rec: SplitRecord, lo, ro,
                      cmn, cmx, depths: List[int],
                      extras=(None, None, None)) -> SplitRecord:
        """Best splits of the left children then the right children, in
        one batched search; a child at max_depth gets gain NEG_INF.
        extras: the children's (feat_mask, rand_bin, penalty) under the
        per-node extras."""
        ch_g = torch.cat([rec.left_g, rec.right_g])
        ch_h = torch.cat([rec.left_h, rec.right_h])
        ch_c = torch.cat([rec.left_c, rec.right_c])
        fm, rb, pen = extras
        ch = best_split(
            self.exp_hist(torch.cat([left_h, right_h]), ch_g, ch_h, ch_c),
            ch_g, ch_h, ch_c, self.num_bins, self.nan_bin, self.mono,
            self.params, self.feat_mask if fm is None else fm,
            parent_output=torch.cat([lo, ro]),
            cmin=cmn, cmax=cmx, has_mono=self.has_mono, is_cat=self.is_cat,
            cat_subset=self.spec.cat_subset, penalty=pen, rand_bin=rb,
        )
        md = self.spec.max_depth
        ok = [md <= 0 or d < md for d in depths]
        if all(ok):
            return ch
        if not any(ok):
            return ch._replace(gain=torch.full_like(ch.gain, NEG_INF))
        okt = torch.tensor(ok + ok, dtype=torch.bool, device=self.dev)
        return ch._replace(gain=torch.where(
            okt, ch.gain, torch.full_like(ch.gain, NEG_INF)))

    def outputs(self, rec: SplitRecord, leaves):
        """Child outputs and monotone intervals of splits of `leaves`."""
        pmin, pmax = self.leaf_min[leaves], self.leaf_max[leaves]
        lo, ro = split_leaf_outputs(
            rec, self.params, self.t.leaf_value[leaves],
            pmin if self.has_mono else None, pmax if self.has_mono else None,
            self.num_bins, self.spec.cat_subset)
        if self.has_mono and not self.spec.mono_mode:
            lmin, lmax, rmin, rmax = monotone_child_intervals(
                rec.feature, rec.is_cat, self.mono, lo, ro, pmin, pmax)
            return lo, ro, (lmin, lmax, rmin, rmax)
        return lo, ro, None

    def record(self, leaves, news, node_ids, rec, lo, ro, iv, ch):
        """Write the splits of `leaves` (children `leaves` and `news`, at
        nodes `node_ids`) into the tree, the leaf tables and the best-split
        records. leaves / news / node_ids index the (L,) tables: slices
        or index tensors."""
        t = self.t
        t.node_feature[node_ids] = rec.feature
        t.node_bin[node_ids] = rec.bin
        t.node_gain[node_ids] = rec.gain
        t.node_default_left[node_ids] = rec.default_left
        if self.is_cat is not None:
            t.node_cat[node_ids] = rec.is_cat
            t.node_cat_mask[node_ids] = rec.cat_mask
        t.node_value[node_ids] = t.leaf_value[leaves]
        t.node_weight[node_ids] = self.leaf_h[leaves]
        t.node_count[node_ids] = self.leaf_c[leaves]
        t.leaf_value[leaves], t.leaf_value[news] = lo, ro
        t.leaf_weight[leaves], t.leaf_weight[news] = rec.left_h, rec.right_h
        t.leaf_count[leaves], t.leaf_count[news] = rec.left_c, rec.right_c
        self.leaf_g[leaves], self.leaf_g[news] = rec.left_g, rec.right_g
        self.leaf_h[leaves], self.leaf_h[news] = rec.left_h, rec.right_h
        self.leaf_c[leaves], self.leaf_c[news] = rec.left_c, rec.right_c
        if iv is not None:
            lmin, lmax, rmin, rmax = iv
            self.leaf_min[leaves], self.leaf_min[news] = lmin, rmin
            self.leaf_max[leaves], self.leaf_max[news] = lmax, rmax
        if ch is None:  # monotone intermediate: searched again after
            return
        n = rec.gain.shape[0]
        for f, v in zip(self.best, ch):
            if f is not None:
                f[leaves], f[news] = v[:n], v[n:]

    # ------------------------------------------------------------ round
    def round_phase(self, pleaf: torch.Tensor) -> None:
        """Split every positive-gain leaf per round while the leaf budget
        holds (permuted.py _round_body / _round_cond)."""
        L, N, dev = self.L, self.N, self.dev
        S = L // 2 + 1
        best = self.best
        while True:
            mask_h = (best.gain > 0.0).tolist()  # the round's host read
            taken = [l for l in range(L) if mask_h[l]]
            n = len(taken)
            if n == 0 or self.i + 1 + n > L:
                return
            i = self.i
            tl = torch.tensor(taken, dtype=torch.int64, device=dev)
            news = slice(i + 1, i + 1 + n)
            rec = map_record(lambda f: f[tl], best)
            lo, ro, iv = self.outputs(rec, tl)
            for r, l in enumerate(taken):
                self.link(l, i + r, i + 1 + r)

            # ---- per-row decision for all split leaves at once
            mask = best.gain > 0.0
            pl_c = pleaf.clamp_max(L - 1).long()
            f_row = best.feature[pl_c].long()
            col = self.bundle.bundle_of[f_row].long() if self.spec.efb \
                else f_row
            fb = self.pbins.gather(0, col[None, :])[0]
            if self.spec.efb:
                fb = decode_feature_bins(fb, f_row, self.bundle)
            fnan = self.nan_bin[f_row]
            go_left = (fb <= best.bin[pl_c]) | (
                best.default_left[pl_c] & (fb == fnan) & (fnan >= 0))
            if self.is_cat is not None:
                B = best.cat_mask.shape[1]
                cat_hit = best.cat_mask.reshape(-1)[
                    pl_c * B + fb.clamp(0, B - 1).long()]
                go_left = torch.where(best.is_cat[pl_c], cat_hit, go_left)
            in_split = mask[pl_c] & (pleaf < L)
            new_of = torch.zeros(L, dtype=torch.int32, device=dev)
            new_of[tl] = torch.arange(i + 1, i + 1 + n, dtype=torch.int32,
                                      device=dev)
            pleaf_new = torch.where(in_split & ~go_left, new_of[pl_c], pleaf)

            # ---- stable multi-leaf partition: destination = segment
            # start + rank among the row's child, by two prefix sums
            gl_in = in_split & go_left
            gr_in = in_split & ~go_left
            P_l = _excl_prefix(gl_in)
            P_r = _excl_prefix(gr_in)
            beg = self.seg_begin
            endp = torch.clamp_max(beg + self.seg_count, N)
            n_l = P_l[endp] - P_l[beg.clamp_max(N)]
            n_l = torch.where(mask, n_l, 0)
            pos = torch.arange(N, dtype=torch.int64, device=dev)
            b_row = beg[pl_c].clamp_max(N)
            dst_l = b_row + (P_l[:-1] - P_l[b_row])
            dst_r = b_row + n_l[pl_c] + (P_r[:-1] - P_r[b_row])
            dst = torch.where(gl_in, dst_l, torch.where(gr_in, dst_r, pos))
            inv = torch.empty_like(pos).scatter_(0, dst, pos)
            self.pbins = self.pbins.index_select(1, inv)
            self.pgh = self.pgh.index_select(1, inv)
            self.pperm = self.pperm[inv]
            pleaf = pleaf_new[inv]
            n_r = torch.where(mask, self.seg_count - n_l, 0)
            left_smaller = n_l <= n_r  # (L,)
            sm_begin = torch.where(left_smaller, beg, beg + n_l)[tl]
            sm_count = torch.where(left_smaller, n_l, n_r)[tl]
            self.seg_begin[news] = (beg + n_l)[tl]
            self.seg_count[news] = n_r[tl]
            self.seg_count[tl] = n_l[tl]

            # ---- all smaller children in one pass, larger by subtraction
            slot_begin = torch.zeros(S, dtype=torch.int32, device=dev)
            slot_count = torch.zeros(S, dtype=torch.int32, device=dev)
            slot_begin[:n] = sm_begin.to(torch.int32)
            slot_count[:n] = sm_count.to(torch.int32)
            small = hist_slots(self.pbins, self.pgh, slot_begin, slot_count,
                               self.Bc, S)[:n]
            large = self.hist[tl] - small
            ls = left_smaller[tl][:, None, None, None]
            left_h = torch.where(ls, small, large)
            right_h = torch.where(ls, large, small)
            self.hist[tl] = left_h
            self.hist[news] = right_h

            depths = [self.leaf_depth[l] + 1 for l in taken]
            if iv is not None:
                cmn, cmx = torch.cat([iv[0], iv[2]]), torch.cat([iv[1], iv[3]])
            else:
                cmn = cmx = None
            ch = self.children_best(left_h, right_h, rec, lo, ro, cmn, cmx,
                                    depths)
            self.record(tl, news, slice(i, i + n), rec, lo, ro, iv, ch)
            for r, (l, d) in enumerate(zip(taken, depths)):
                self.leaf_parent[l] = self.leaf_parent[i + 1 + r] = i + r
                self.leaf_depth[l] = self.leaf_depth[i + 1 + r] = d
            self.i = i + n

    # ------------------------------------------------------- sequential
    def next_split(self):
        """The split's host read: (leaf, gain > 0, segment begin, count,
        the forced record when the plan's entry i applies, else None)."""
        am = first_argmax(self.best.gain).reshape(1)
        keep = self.best.gain.max() > 0.0
        rec_f = None
        if self.forced is not None and self.i < len(self.forced):
            fl, ff, fb = self.forced[self.i]
            fh = self.exp_hist(self.hist[fl:fl + 1], self.leaf_g[fl:fl + 1],
                               self.leaf_h[fl:fl + 1],
                               self.leaf_c[fl:fl + 1])[0]
            flg, flh, flc = cumsum_last(fh[:, ff])[:, fb]
            fpg, fph, fpn = self.leaf_g[fl], self.leaf_h[fl], \
                self.leaf_c[fl]
            use = ((flc > 0) & (fpn - flc > 0)).reshape(1)
            am = torch.where(use, fl, am)
            keep = keep | use[0]
            rec_f = (use, ff, fb, (flg, flh, flc, fpg, fph, fpn))
        head = torch.cat([am, keep.to(torch.int64).reshape(1),
                          self.seg_begin[am], self.seg_count[am]]
                         + ([rec_f[0].to(torch.int64)] if rec_f else []))
        vals = head.tolist()
        l, keep, b, c = (int(v) for v in vals[:4])
        if rec_f is None or not vals[4]:
            return l, bool(keep), b, c, None
        use, ff, fb, sums = rec_f
        rec = map_record(lambda f: f[l:l + 1].clone(), self.best)
        return l, bool(keep), b, c, forced_record(
            rec, use, torch.tensor(ff, device=self.dev),
            torch.tensor(fb, device=self.dev), sums, self.params)

    def split_one(self, l: int, b: int, c: int,
                  rec: Optional[SplitRecord] = None) -> None:
        """Split leaf l, whose rows are [b, b + c) (permuted.py body), by
        its best split or by `rec` (a forced one)."""
        i, new = self.i, self.i + 1
        dev = self.dev
        if rec is None:
            rec = map_record(lambda f: f[l:l + 1].clone(), self.best)
        lo, ro, iv = self.outputs(rec, slice(l, l + 1))
        self.link(l, i, new)
        depth = self.leaf_depth[l] + 1

        # ---- stable partition of [b, b + c): left rows, then right rows
        feat = rec.feature.long()  # (1,)
        col = self.bundle.bundle_of[feat].long() if self.spec.efb else feat
        seg = self.pbins[:, b:b + c]
        fb = seg.index_select(0, col)[0]
        if self.spec.efb:
            fb = decode_feature_bins(fb, feat, self.bundle)
        fnan = self.nan_bin[feat]
        gl = (fb <= rec.bin) | (rec.default_left & (fb == fnan) & (fnan >= 0))
        if self.is_cat is not None:
            B = rec.cat_mask.shape[1]
            gl = torch.where(rec.is_cat,
                             rec.cat_mask[0, fb.clamp(0, B - 1).long()], gl)
        gli = gl.to(torch.int64)
        lrank = torch.cumsum(gli, dim=0) - gli
        n_l = gli.sum()
        idx = torch.arange(c, dtype=torch.int64, device=dev)
        dst = torch.where(gl, lrank, n_l + idx - lrank)
        self.pbins[:, b:b + c] = torch.empty_like(seg).index_copy_(1, dst,
                                                                   seg)
        sgh = self.pgh[:, b:b + c]
        self.pgh[:, b:b + c] = torch.empty_like(sgh).index_copy_(1, dst, sgh)
        sp = self.pperm[b:b + c]
        self.pperm[b:b + c] = torch.empty_like(sp).index_copy_(0, dst, sp)
        n_r = c - n_l
        left_smaller = n_l <= n_r
        self.seg_begin[new] = b + n_l
        self.seg_count[l] = n_l
        self.seg_count[new] = n_r

        # ---- smaller child over its segment (<= c // 2 rows)
        small = histogram(self.pbins, self.pgh, self.Bc,
                          begin=torch.where(left_smaller, b, b + n_l),
                          count=torch.where(left_smaller, n_l, n_r),
                          cap=c // 2)
        large = self.hist[l] - small
        left_h = torch.where(left_smaller, small, large)
        right_h = torch.where(left_smaller, large, small)
        self.hist[l] = left_h
        self.hist[new] = right_h

        if iv is not None:
            cmn, cmx = torch.cat([iv[0], iv[2]]), torch.cat([iv[1], iv[3]])
        else:
            cmn = cmx = None
        extras = (None, None, None)
        if self.spec.per_node:
            # the two children's candidates: groups still legal and path
            # features from the parent plus its split feature
            F = self.path_used.shape[1]
            f_oh = torch.arange(F, device=dev)[None, :] == feat[:, None]
            grp = self.leaf_groups[l:l + 1]
            if self.spec.n_groups:
                grp = grp & self.group_mat[:, feat].T
            pu = self.path_used[l:l + 1] | f_oh
            self.feat_used = self.feat_used | f_oh[0]
            extras = self.node_candidates(
                torch.tensor([2 * i + 1, 2 * i + 2], dtype=torch.int64,
                             device=dev),
                torch.cat([grp, grp]), torch.cat([pu, pu]),
                torch.cat([rec.left_c, rec.right_c]), self.feat_used)
            for arr, v in ((self.leaf_groups, grp), (self.path_used, pu)):
                arr[l] = v[0]
                arr[new] = v[0]
        ch = None
        if not self.spec.mono_mode:
            ch = self.children_best(left_h[None], right_h[None], rec, lo, ro,
                                    cmn, cmx, [depth], extras)
        self.record(slice(l, l + 1), slice(new, new + 1), slice(i, i + 1),
                    rec, lo, ro, iv, ch)
        self.leaf_parent[l] = self.leaf_parent[new] = i
        self.leaf_depth[l] = self.leaf_depth[new] = depth
        self.i = new
        if self.spec.mono_mode:
            self.mono_split(l, i, new)

    def mono_split(self, l: int, i: int, new: int) -> None:
        """After split i of leaf l (children l and new), monotone
        intermediate (permuted.py:866-918): the ancestry takes the split,
        every leaf's bounds are computed again (grower.mono_bounds), and
        every live leaf's best split is searched again under them."""
        L, dev = self.L, self.dev
        self.anc_in[new] = self.anc_in[l]
        self.anc_left[new] = self.anc_left[l]
        self.anc_in[l, i] = self.anc_in[new, i] = True
        self.anc_left[l, i] = True
        t = self.t
        i_new = torch.full((), new, dtype=torch.int64, device=dev)
        nmin, nmax = mono_bounds(1, self.anc_in, self.anc_left,
                                 t.leaf_value, t.node_feature, t.node_cat,
                                 self.mono, i_new)
        rec = best_split(
            self.exp_hist(self.hist, self.leaf_g, self.leaf_h, self.leaf_c),
            self.leaf_g, self.leaf_h, self.leaf_c, self.num_bins,
            self.nan_bin, self.mono, self.params, self.feat_mask,
            parent_output=t.leaf_value, cmin=nmin, cmax=nmax, has_mono=True,
            is_cat=self.is_cat, cat_subset=self.spec.cat_subset)
        live = [x <= new and (self.spec.max_depth <= 0
                              or self.leaf_depth[x] < self.spec.max_depth)
                for x in range(L)]
        live = torch.tensor(live, dtype=torch.bool, device=dev)
        rec = rec._replace(gain=torch.where(
            live, rec.gain, torch.full_like(rec.gain, NEG_INF)))
        for f, v in zip(self.best, rec):
            if f is not None:
                f.copy_(v)
        self.leaf_min.copy_(nmin)
        self.leaf_max.copy_(nmax)

    # ----------------------------------------------------------- result
    def finish(self, valid) -> Tuple[TreeArrays, torch.Tensor]:
        """Tree arrays and the natural-order row -> leaf (permuted.py
        :952-968): position p belongs to the last leaf whose segment
        begins at or before p; empty and unused leaves sort last."""
        L, N, dev = self.L, self.N, self.dev
        eff = torch.where(self.seg_count > 0, self.seg_begin, N)
        order = torch.argsort(eff, stable=True)
        pos = torch.arange(N, dtype=torch.int64, device=dev)
        j = torch.searchsorted(eff[order].contiguous(), pos, right=True) - 1
        leaf_of_pos = order[j.clamp(0, L - 1)].to(torch.int32)
        row_leaf = torch.empty(N, dtype=torch.int32, device=dev)
        row_leaf[self.pperm] = leaf_of_pos
        if valid is not None:
            row_leaf = torch.where(valid > 0, row_leaf,
                                   torch.full_like(row_leaf, -1))
        t = self.t._replace(
            num_nodes=torch.tensor(self.i, dtype=torch.int32, device=dev),
            node_left=torch.from_numpy(self.node_left[:L - 1]).to(dev),
            node_right=torch.from_numpy(self.node_right[:L - 1]).to(dev),
            leaf_depth=torch.tensor(self.leaf_depth, dtype=torch.int32,
                                    device=dev),
        )
        return t, row_leaf


def grow_tree_permuted(
    bins_fm: torch.Tensor,  # (G, N) int32
    nan_bin: torch.Tensor,  # (F,) int32
    num_bins: torch.Tensor,  # (F,) int32
    mono: torch.Tensor,  # (F,) int32
    is_cat: torch.Tensor,  # (F,) bool
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    mask: torch.Tensor,  # (N,) f32 validity * bagging
    feat_mask: torch.Tensor,  # (F,) bool
    params: SplitParams,
    spec: GrowerSpec,
    valid: Optional[torch.Tensor] = None,
    bundle: Optional[BundleInfo] = None,
    rng_key: Optional[torch.Tensor] = None,
    group_mat: Optional[torch.Tensor] = None,
    cegb: Optional[CegbInfo] = None,
    forced: Optional[ForcedSplits] = None,
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree -> (tree arrays, natural-order row -> leaf, -1 on
    rows with valid == 0). rng_key, group_mat, cegb and forced: the
    per-node extras and forced plan of grower.grow_tree."""
    if spec.rounds and (spec.per_node or spec.n_forced):
        raise ValueError("tpu_growth_rounds excludes per-node extras")
    if spec.mono_mode and (spec.per_node or spec.n_forced or spec.rounds):
        # permuted.py:214-220: the re-search takes the plain feature mask
        raise ValueError(
            "monotone intermediate/advanced excludes per-node extras / "
            "forced splits / rounds")
    if spec.mono_mode == 2:
        raise ValueError("monotone advanced rides the rounds grower only "
                         "(boosting runs intermediate on the exact grower)")
    g = _Grower(bins_fm, nan_bin, num_bins, mono, is_cat, grad, hess, mask,
                feat_mask, params, spec, valid, bundle, rng_key, group_mat,
                cegb, forced)
    L = spec.num_leaves
    if spec.rounds and L > 2:
        g.round_phase(torch.where(g.valid_f > 0, 0, L).to(torch.int32))
    while g.i < L - 1:
        l, keep, b, c, rec = g.next_split()
        if not keep:
            break
        g.split_one(l, b, c, rec)
    return g.finish(valid)
