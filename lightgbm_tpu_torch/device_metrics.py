"""Metric evaluation on the training device, for the fused loop.

The port of lightgbm_tpu/device_metrics.py. The eager loop evaluates
its metrics on the host from scores read back every iteration
(metrics.py); the fused loop's CUDA graph reads nothing back, so each
metric is a function of the padded (K, Npad) score tensor computed on
the device in f32, as the JAX package computes it (its sums over the
rows accumulate in f64, _sum), and the graph writes
one row of metric values per iteration beside the trees. The host reads
a chunk's rows at once (boosting.fused_collect).

Semantics mirror metrics.py (reference src/metric/*.hpp): weighted
means over the valid (non-padding) rows, the metric's transform of the
raw score, and the exact tie-handled AUC through one device sort. The
ranking metrics ndcg@k and map@k (one value per eval_at entry) sort the
scores along the documents of the dataset's padded (Q, M) query layout
(learner/ranking.py); without query groups supported_names returns None
for them, as for every metric with no device form, so such a run stays
on the eager loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .config import Config

_EPS = 1e-15


def _f32(v: float) -> float:
    return float(np.float32(v))


def _sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over the rows accumulated in f64, rounded to f32 once (the
    JAX package sums in f32; over the 100k-row validation sets of the
    main path f32 partial sums drift by more than the 1e-5 the fused
    loop's records are held to against the host metrics)."""
    return torch.sum(x, dtype=torch.float64).to(torch.float32)


def _wmean(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _sum(vals * w) / _sum(w)


def _sigmoid(x: torch.Tensor, s: float) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-_f32(s) * x))


def _make_pointwise(name: str, cfg: Config, label: torch.Tensor,
                    w: torch.Tensor) -> Optional[Callable]:
    """fn(score (Npad,)) -> 0-dim f32 for a pointwise metric, or None."""
    if name == "l2":
        return lambda s: _wmean((s - label) ** 2, w)
    if name == "rmse":
        return lambda s: torch.sqrt(_wmean((s - label) ** 2, w))
    if name == "l1":
        return lambda s: _wmean(torch.abs(s - label), w)
    if name == "r2":
        def _r2(s):
            ybar = _wmean(label, w)
            ss_res = _sum(w * (label - s) ** 2)
            ss_tot = _sum(w * (label - ybar) ** 2)
            return torch.where(ss_tot > 0, 1.0 - ss_res / ss_tot,
                               torch.zeros_like(ss_tot))
        return _r2
    if name == "quantile":
        a = _f32(cfg.alpha)
        return lambda s: _wmean(torch.where(label - s >= 0, a * (label - s),
                                            (a - 1.0) * (label - s)), w)
    if name == "huber":
        a = _f32(cfg.alpha)

        def _h(s):
            d = torch.abs(s - label)
            return _wmean(torch.where(d <= a, 0.5 * d * d,
                                      a * (d - 0.5 * a)), w)
        return _h
    if name == "fair":
        c = _f32(cfg.fair_c)

        def _f(s):
            x = torch.abs(s - label)
            return _wmean(c * x - c * c * torch.log1p(x / c), w)
        return _f
    if name == "poisson":
        # the score is the raw (log) margin: prediction exp(score)
        return lambda s: _wmean(torch.exp(s) - label * s, w)
    if name == "mape":
        return lambda s: _wmean(torch.abs(
            (label - s) / torch.clamp_min(torch.abs(label), 1.0)), w)
    if name == "gamma":
        def _g(s):
            p = torch.exp(s)
            lg = torch.where(label > 0, torch.log(torch.clamp_min(label, _EPS)),
                             torch.zeros_like(label))
            return _wmean(label / p + s - 1.0 - lg, w)
        return _g
    if name == "gamma_deviance":
        def _gd(s):
            r = label / torch.clamp_min(torch.exp(s), _EPS)
            return 2.0 * _wmean(r - torch.log(torch.clamp_min(r, _EPS)) - 1.0,
                                w)
        return _gd
    if name == "tweedie":
        rho = _f32(cfg.tweedie_variance_power)

        def _t(s):
            a = label * torch.exp((1.0 - rho) * s) / (1.0 - rho)
            b = torch.exp((2.0 - rho) * s) / (2.0 - rho)
            return _wmean(-a + b, w)
        return _t
    if name in ("binary_logloss", "cross_entropy"):
        sg = cfg.sigmoid if name == "binary_logloss" else 1.0

        def _bl(s):
            p = torch.clamp(_sigmoid(s, sg), _EPS, 1.0 - _EPS)
            return _wmean(-(label * torch.log(p)
                            + (1.0 - label) * torch.log(1.0 - p)), w)
        return _bl
    if name == "binary_error":
        sg = cfg.sigmoid
        return lambda s: _wmean(
            ((_sigmoid(s, sg) > 0.5) != (label > 0.5)).to(torch.float32), w)
    return None


def _make_auc(label: torch.Tensor, w: torch.Tensor) -> Callable:
    """Exact weighted AUC with ties (AUCMetric, binary_metric.hpp): sort
    by score, then each positive adds its weight times the negative
    weight strictly below it plus half of its tie group's."""
    posw = w * (label > 0)
    negw = w * (label <= 0)

    def _auc(s):
        # padding rows have w == 0, so where they sort does not matter
        sk, order = torch.sort(s, stable=True)
        # prefix sums and the total in f64: weights' prefixes pass 2^24
        pw, nw = posw[order].double(), negw[order].double()
        cn = torch.cumsum(nw, 0)  # inclusive negative-weight prefix
        cp = torch.cumsum(pw, 0)
        diff = sk[1:] != sk[:-1]
        one = torch.ones(1, dtype=torch.bool, device=s.device)
        start = torch.cat([one, diff])
        end = torch.cat([diff, one])
        # forward-fill each tie group's exclusive prefix (non-decreasing,
        # so a running max over the group starts fills it)
        gstart_cn = torch.cummax(torch.where(start, cn - nw, -1.0), 0).values
        gend_cn = torch.flip(torch.cummin(torch.flip(
            torch.where(end, cn, float("inf")), (0,)), 0).values, (0,))
        gn = gend_cn - gstart_cn
        auc_sum = torch.sum(pw * (gstart_cn + 0.5 * gn))
        tot_p, tot_n = cp[-1], cn[-1]
        ok = (tot_p > 0) & (tot_n > 0)
        return torch.where(ok, auc_sum / torch.clamp_min(tot_p * tot_n, 1e-30),
                           torch.ones_like(auc_sum)).to(torch.float32)

    return _auc


def _make_multiclass(name: str, cfg: Config, label: torch.Tensor,
                     w: torch.Tensor) -> Optional[Callable]:
    """fn(score (K, Npad)) -> 0-dim f32, or None."""
    lab = label.to(torch.int64)[None, :]
    if name == "multi_logloss":
        def _ml(score):
            lse = torch.logsumexp(score, dim=0)
            return _wmean(lse - torch.gather(score, 0, lab)[0], w)
        return _ml
    if name == "multi_error":
        k_top = cfg.multi_error_top_k

        def _me(score):
            if k_top <= 1:
                pred = torch.argmax(score, dim=0)
                return _wmean((pred != lab[0]).to(torch.float32), w)
            true_s = torch.gather(score, 0, lab)[0]
            rank = torch.sum(score > true_s[None, :], dim=0)
            return _wmean((rank >= k_top).to(torch.float32), w)
        return _me
    return None


def _make_rank(base: str, k: int, cfg: Config, label: torch.Tensor,
               group: np.ndarray) -> Callable:
    """ndcg@k or map@k over the dataset's query layout (shared with the
    objective and the other k through build_query_layout's cache)."""
    from .learner.ranking import (build_query_layout, label_gains, map_at,
                                  ndcg_at)

    layout = build_query_layout(np.asarray(group), int(label.shape[0]))
    layout.device(label.device)
    if base == "map":
        return lambda s: map_at(layout, s, label, [k])[0]
    gains = label_gains(cfg, label.cpu().numpy())
    gain = torch.from_numpy(gains.astype(np.float32)).to(label.device)
    return lambda s: ndcg_at(layout, s, label, gain, [k])[0]


class DeviceEvalSet:
    """The metrics of one dataset as one fn(score (K, Npad)) -> (m,) f32,
    the JAX package's DeviceEvalSet."""

    def __init__(self, cfg: Config, metric_names: List[str],
                 higher_better: List[bool], label: torch.Tensor,
                 weight: Optional[torch.Tensor], valid: torch.Tensor,
                 num_class: int, group: Optional[np.ndarray] = None):
        self.names = metric_names
        self.higher_better = higher_better
        label = label.to(torch.float32)
        w = valid if weight is None else weight.to(torch.float32) * valid
        fns = []
        for nm in metric_names:
            base = nm.split("@")[0]
            if base in ("ndcg", "map"):
                fns.append((_make_rank(base, int(nm.split("@")[1]), cfg,
                                       label, group), False))
                continue
            if num_class > 1 and base in ("multi_logloss", "multi_error"):
                f, multi = _make_multiclass(base, cfg, label, w), True
            elif base == "auc":
                f, multi = _make_auc(label, w), False
            else:
                f, multi = _make_pointwise(base, cfg, label, w), False
            if f is None:
                raise NotImplementedError(f"metric {nm} has no device form")
            fns.append((f, multi))
        self._fns = fns

    def __call__(self, score: torch.Tensor) -> torch.Tensor:
        vals = [f(score) if multi else f(score[0]) for f, multi in self._fns]
        if not vals:
            return torch.zeros(0, dtype=torch.float32, device=score.device)
        return torch.stack(vals).to(torch.float32)


_DEVICE_NAMES = frozenset({
    "l2", "rmse", "l1", "r2", "quantile", "huber", "fair", "poisson",
    "mape", "gamma", "gamma_deviance", "tweedie", "binary_logloss",
    "binary_error", "cross_entropy", "auc", "multi_logloss", "multi_error",
})


def supported_names(metric_objs) -> Optional[Tuple[List[str], List[bool]]]:
    """Host Metric objects -> (display names, higher_better) when every
    one has a device form, else None (the JAX package's supported_names).
    ndcg and map need the dataset's query groups and expand to one name
    per eval_at entry, as the host metric's eval() tuples do."""
    names, hb = [], []
    for m in metric_objs:
        if m.name in ("ndcg", "map"):
            if getattr(m, "group", None) is None:
                return None
            for k in list(m.config.eval_at) or [1, 2, 3, 4, 5]:
                names.append(f"{m.name}@{k}")
                hb.append(True)
            continue
        if m.name not in _DEVICE_NAMES:
            return None
        display = m.name
        if m.name == "multi_error":
            k = getattr(m.config, "multi_error_top_k", 1)
            if k > 1:
                display = f"multi_error@{k}"  # the host metric's name
        names.append(display)
        hb.append(m.higher_better)
    return names, hb
