"""Learning to rank: the query layout, LambdaRank's lambdas, NDCG and MAP.

The port of lightgbm_tpu/learner/ranking.py (reference
rank_objective.hpp:137-271 LambdarankNDCG, rank_metric.hpp and
map_metric.hpp). Queries are contiguous runs of rows (the Dataset's
`group` sizes). The layout keeps them both as query offsets and as the
JAX package's padded (Q, M) matrix of row indices (M the largest
query's documents): the metrics, RankXENDCG and the plain lambdas work
on padded rows of that matrix and sort along the document axis; the
card's lambdarank kernel (csrc/lambdarank.cu) reads the offsets and
needs no padding.

The plain lambdas are the JAX package's pair tensors of one chunk of
queries at a time: queries sorted by size, each chunk padded only to its
own largest query and its first `truncation_level` ranks (pairs start
below the truncation level, so no pair is left out), under a memory
bound. That is the same function as the JAX package's (Q, M, M) tensor
over lax.map steps, and it lets a whole MSLR-shaped set (10,000 queries,
a tail to ~900 documents) run on the card for comparison with the
kernel. The chunks' index tensors are built once per layout and device,
so a call moves nothing from the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import log

_NEG = -1e30  # the score of a padding cell: it sorts last
_CHUNK_BYTES = 1 << 30  # the plain lambdas' pair tensors, per chunk
_PAIR_TENSORS = 12  # f32 (C, T, M) tensors alive at once in a chunk


class QueryLayout:
    """Static per-dataset query structure (host-built): `qdoc` (Q, M)
    int32 flat row index, npad in padding cells; `qvalid` (Q, M) bool;
    `offsets` (Q + 1,) int64 query starts; and the device tensors built
    from them, once per device."""

    def __init__(self, group: np.ndarray, npad: int):
        group = np.asarray(group, dtype=np.int64)
        qb = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
        Q = len(group)
        M = int(group.max()) if Q else 1
        qdoc = np.full((Q, M), npad, dtype=np.int32)
        qvalid = np.arange(M)[None, :] < group[:, None]
        qdoc[qvalid] = np.arange(qb[-1], dtype=np.int32)
        self.group = group
        self.offsets = qb
        self.qdoc = qdoc
        self.qvalid = qvalid
        self.num_queries = Q
        self.max_docs = M
        self.npad = int(npad)
        self.num_docs = int(qb[-1])
        self._dev: Dict[tuple, dict] = {}

    def device(self, device) -> dict:
        """The padded layout on `device`: qdoc clipped to a row (int64),
        qvalid, cell (the flat (Q, M) cell of each real row, int64),
        offsets (int32) and disc (the M rank discounts)."""
        device = torch.device(device)
        key = ("layout", str(device))
        d = self._dev.get(key)
        if d is None:
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            cell = np.flatnonzero(self.qvalid.ravel())
            d = self._dev[key] = {
                "qdoc": t(np.clip(self.qdoc, 0, self.npad - 1).astype(
                    np.int64)),
                "qvalid": t(self.qvalid),
                "cell": t(cell.astype(np.int64)),
                "offsets": t(self.offsets.astype(np.int32)),
                "disc": discounts(self.max_docs, device),
            }
        return d

    def chunks(self, device, trunc: int) -> List[dict]:
        """The plain lambdas' chunks on `device`: queries sorted by size
        (stable), each chunk of C queries padded to its largest, M_c,
        with C x min(trunc, M_c) x M_c x _PAIR_TENSORS f32 cells under
        _CHUNK_BYTES (one query at least). Per chunk: qdoc / qvalid
        (C, M_c), its queries' indices, and `rows` / `cells`: each real
        row and its flat (C, M_c) cell."""
        device = torch.device(device)
        key = ("chunks", str(device), int(trunc))
        out = self._dev.get(key)
        if out is not None:
            return out
        order = np.argsort(self.group, kind="stable")
        out = []
        i = 0
        Q = self.num_queries
        while i < Q:
            j = i + 1
            while j < Q:
                Mc = int(self.group[order[j]])
                cells = (j + 1 - i) * min(trunc, Mc) * Mc * _PAIR_TENSORS * 4
                if cells > _CHUNK_BYTES:
                    break
                j += 1
            qi = order[i:j]
            Mc = max(1, int(self.group[qi].max()))
            qd = self.qdoc[qi, :Mc]
            qv = self.qvalid[qi, :Mc]
            cells = np.flatnonzero(qv.ravel())
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            out.append({
                "qdoc": t(np.clip(qd, 0, self.npad - 1).astype(np.int64)),
                "qvalid": t(qv), "queries": t(qi.astype(np.int64)),
                "rows": t(qd.ravel()[cells].astype(np.int64)),
                "cells": t(cells.astype(np.int64)), "M": Mc,
            })
            i = j
        self._dev[key] = out
        return out


_layout_cache: dict = {}


def build_query_layout(group: np.ndarray, npad: int) -> QueryLayout:
    """Cached: the objective and every ranking metric of a dataset share
    one layout (and its device tensors)."""
    group = np.asarray(group, dtype=np.int64)
    key = (group.tobytes(), npad)
    hit = _layout_cache.get(key)
    if hit is not None:
        return hit
    out = QueryLayout(group, npad)
    if len(_layout_cache) > 64:
        _layout_cache.clear()
    _layout_cache[key] = out
    if out.max_docs > 4096:
        log.warning(
            f"a query with {out.max_docs} documents makes the pairwise "
            f"lambda work {out.max_docs}x{out.max_docs}; expect high memory "
            "use and time; consider splitting giant queries (the reference "
            "hits the same O(cnt^2) pair loop cost)")
    return out


def default_label_gain(max_label: int) -> np.ndarray:
    """DCGCalculator::DefaultLabelGain: 2^i - 1."""
    return np.asarray([(1 << i) - 1 for i in range(max_label + 1)],
                      np.float64)


def check_label_range(label: np.ndarray, num_gains: int) -> None:
    """DCGCalculator::CheckLabel: every label must index label_gain."""
    mx = int(np.asarray(label).max()) if len(label) else 0
    if mx >= num_gains:
        log.fatal(f"label {mx} exceeds label_gain size {num_gains}; set "
                  "label_gain to cover all relevance levels")


def label_gains(config, label: np.ndarray) -> np.ndarray:
    """The gain of each relevance label, f64: config.label_gain, or
    2^i - 1 up to the largest label; every label must index it."""
    gains = list(config.label_gain) or list(
        default_label_gain(int(np.asarray(label).max())))
    check_label_range(label, len(gains))
    return np.asarray(gains, dtype=np.float64)


def inverse_max_dcg(label: np.ndarray, layout: QueryLayout,
                    label_gain: np.ndarray, k: int) -> np.ndarray:
    """1 / MaxDCG@k per query (0 when MaxDCG == 0); host, once per init."""
    out = np.zeros(layout.num_queries)
    lab = np.where(layout.qvalid,
                   label[np.clip(layout.qdoc, 0, len(label) - 1)], -1)
    for q in range(layout.num_queries):
        lq = lab[q][layout.qvalid[q]].astype(int)
        srt = np.sort(lq)[::-1][:k]
        dcg = np.sum(label_gain[srt] / np.log2(np.arange(len(srt)) + 2.0))
        out[q] = 1.0 / dcg if dcg > 0 else 0.0
    return out


def discounts(n: int, device) -> torch.Tensor:
    """1 / log2(rank + 2) for ranks 0..n-1, f32: the table both the plain
    lambdas and the kernel read."""
    return 1.0 / torch.log2(torch.arange(n, dtype=torch.float32,
                                         device=device) + 2.0)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _gain_of(label_gain: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(lab.to(torch.int32), 0, label_gain.shape[0] - 1)
    return label_gain[idx.long()]


def _chunk_lambdas(ss, sl, sv, gain, im, disc, sigmoid: float, trunc: int,
                   norm: bool):
    """(g, h) in sorted order for one chunk, from its sorted scores ss,
    labels sl, validity sv and gains (C, M), inverse max DCGs im (C,):
    the JAX package's one_chunk over its first T = min(trunc, M) ranks as
    the pairs' higher members."""
    C, M = ss.shape
    T = min(int(trunc), M)
    dev = ss.device
    i_rank = torch.arange(T, device=dev)[None, :, None]
    j_rank = torch.arange(M, device=dev)[None, None, :]
    si, sj = ss[:, :T, None], ss[:, None, :]
    li, lj = sl[:, :T, None], sl[:, None, :]
    pair = ((i_rank < j_rank) & sv[:, :T, None] & sv[:, None, :]
            & (li != lj))
    i_high = li > lj
    ds = torch.where(i_high, si - sj, sj - si)
    dcg_gap = torch.abs(gain[:, :T, None] - gain[:, None, :])
    pdisc = torch.abs(disc[None, :T, None] - disc[None, None, :M])
    dndcg = dcg_gap * pdisc * im[:, None, None]
    if norm:
        best = ss[:, 0]
        n_valid = sv.sum(dim=1)
        worst = ss.gather(1, torch.clamp_min(n_valid - 1, 0)[:, None])[:, 0]
        dndcg = torch.where((best != worst)[:, None, None],
                            dndcg / (_f32(0.01) + torch.abs(ds)), dndcg)
    p = 1.0 / (1.0 + torch.exp(_f32(sigmoid) * ds))
    lam = _f32(-sigmoid) * dndcg * p
    hess = _f32(sigmoid * sigmoid) * dndcg * p * (1.0 - p)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lam = torch.where(pair, lam, zero)
    hess = torch.where(pair, hess, zero)
    # pair (i, j) adds +lam to its higher-labelled member and -lam to the
    # other; P[i, j] is signed for row i, and the column sum flips sign
    P = torch.where(i_high, lam, -lam)
    pad = (0, M - T)
    g = torch.nn.functional.pad(P.sum(dim=2), pad) - P.sum(dim=1)
    h = torch.nn.functional.pad(hess.sum(dim=2), pad) + hess.sum(dim=1)
    if norm:
        sum_lambdas = -2.0 * lam.sum(dim=(1, 2))
        pos = sum_lambdas > 0
        scale = torch.where(
            pos, torch.log2(1.0 + sum_lambdas)
            / torch.where(pos, sum_lambdas, torch.ones_like(sum_lambdas)),
            torch.ones_like(sum_lambdas))
        g = g * scale[:, None]
        h = h * scale[:, None]
    return g, h


def lambdarank_gradients(layout: QueryLayout, score: torch.Tensor,
                         label: torch.Tensor, label_gain: torch.Tensor,
                         inv_max_dcg: torch.Tensor, sigmoid: float,
                         truncation_level: int, norm: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad, hess) on the flat padded row axis, plain torch (the JAX
    package's lambdarank_gradients, GetGradientsForOneQuery at
    rank_objective.hpp:182-271 with the norm path's (0.01 + |ds|)
    regularization and log2(1 + sum) / sum rescale); padding rows 0."""
    dev = score.device
    npad = layout.npad
    g = torch.zeros(npad, dtype=torch.float32, device=dev)
    h = torch.zeros(npad, dtype=torch.float32, device=dev)
    disc = layout.device(dev)["disc"]
    for c in layout.chunks(dev, truncation_level):
        qd, qv = c["qdoc"], c["qvalid"]
        s = torch.where(qv, score[qd], _NEG)
        lb = torch.where(qv, label[qd], 0.0)
        order = torch.argsort(-s, dim=1, stable=True)
        ss = s.gather(1, order)
        sl = lb.gather(1, order)
        sv = qv.gather(1, order)
        gi, hi = _chunk_lambdas(ss, sl, sv, _gain_of(label_gain, sl),
                                inv_max_dcg[c["queries"]], disc, sigmoid,
                                truncation_level, norm)
        # back to document order within the query, then to the rows
        gd = torch.empty_like(gi).scatter_(1, order, gi).reshape(-1)
        hd = torch.empty_like(hi).scatter_(1, order, hi).reshape(-1)
        g.index_copy_(0, c["rows"], gd[c["cells"]])
        h.index_copy_(0, c["rows"], hd[c["cells"]])
    return g, h


def lambdarank_plain(layout, score, label, label_gain, inv_max_dcg,
                     sigmoid, truncation_level, norm,
                     weight: Optional[torch.Tensor] = None,
                     hess_floor: bool = True):
    """The lambdas, times the document weights (RankingObjective::
    GetGradients, rank_objective.hpp:84-90), the hessian floored at
    2e-7 (the JAX package's guard for queries of equal labels) when
    hess_floor: what the kernel returns, in plain torch."""
    g, h = lambdarank_gradients(layout, score, label, label_gain,
                                inv_max_dcg, sigmoid, truncation_level, norm)
    if weight is not None:
        g = g * weight
        h = h * weight
    if hess_floor:
        h = torch.clamp_min(h, _f32(2e-7))
    return g, h


def lambdarank(layout, score, label, label_gain, inv_max_dcg, sigmoid,
               truncation_level, norm, weight=None, hess_floor=True):
    """lambdarank_plain's function: the card's kernel on a CUDA score
    (learner/cuda_rank.py), the plain torch version on a CPU one."""
    if score.is_cuda:
        from . import cuda_rank

        return cuda_rank.lambdarank(layout, score, label, label_gain,
                                    inv_max_dcg, sigmoid, truncation_level,
                                    norm, weight, hess_floor)
    return lambdarank_plain(layout, score, label, label_gain, inv_max_dcg,
                            sigmoid, truncation_level, norm, weight,
                            hess_floor)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """A mean over the queries accumulated in f64, rounded to f32 once."""
    return (torch.sum(x, dtype=torch.float64) / max(x.shape[0], 1)).to(
        torch.float32)


def ndcg_at(layout: QueryLayout, score: torch.Tensor, label: torch.Tensor,
            label_gain: torch.Tensor, ks: List[int]) -> torch.Tensor:
    """NDCG@k for each k, (len(ks),) f32: the mean over queries, queries
    with zero ideal DCG counting 1.0 (the host NDCGMetric's semantics)."""
    d = layout.device(score.device)
    qd, qv = d["qdoc"], d["qvalid"]
    M = layout.max_docs
    s = torch.where(qv, score[qd], _NEG)
    lb = torch.where(qv, label[qd], -1.0)
    order = torch.argsort(-s, dim=1, stable=True)
    sl = lb.gather(1, order)
    sv = qv.gather(1, order)
    ideal = -torch.sort(-lb, dim=1).values  # labels descending
    disc = d["disc"][None, :]
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    rank = torch.arange(M, device=score.device)[None, :]
    out = []
    for k in ks:
        kmask = rank < k
        dcg = torch.where(kmask & sv, _gain_of(label_gain, sl) * disc,
                          zero).sum(dim=1)
        idcg = torch.where(kmask & (ideal >= 0),
                           _gain_of(label_gain, ideal) * disc, zero).sum(dim=1)
        pos = idcg > 0
        nd = torch.where(pos, dcg / torch.where(pos, idcg,
                                                torch.ones_like(idcg)),
                         torch.ones_like(idcg))
        out.append(_mean(nd))
    return torch.stack(out)


def map_at(layout: QueryLayout, score: torch.Tensor, label: torch.Tensor,
           ks: List[int]) -> torch.Tensor:
    """MAP@k for each k (map_metric.hpp CalMapAtK): relevance is label >
    0.5; AP@k sums hits(j) / (j + 1) over the relevant ranks j < k over
    min(positives, k); queries without positives count 1.0."""
    d = layout.device(score.device)
    qd, qv = d["qdoc"], d["qvalid"]
    M = layout.max_docs
    s = torch.where(qv, score[qd], _NEG)
    lb = torch.where(qv, label[qd], 0.0)
    order = torch.argsort(-s, dim=1, stable=True)
    rel = (lb.gather(1, order) > 0.5) & qv.gather(1, order)
    relf = rel.to(torch.float32)
    hits = torch.cumsum(relf, dim=1)
    pos_idx = torch.arange(M, dtype=torch.float32, device=score.device)[None]
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    prec = torch.where(rel, hits / (pos_idx + 1.0), zero)
    npos = relf.sum(dim=1)
    rank = torch.arange(M, device=score.device)[None, :]
    out = []
    for k in ks:
        sum_ap = torch.where(rank < k, prec, zero).sum(dim=1)
        denom = torch.clamp_max(npos, float(k))
        ap = torch.where(npos > 0, sum_ap / torch.clamp_min(denom, 1.0),
                         torch.ones_like(npos))
        out.append(_mean(ap))
    return torch.stack(out)
