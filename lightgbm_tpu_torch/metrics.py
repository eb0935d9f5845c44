"""Evaluation metrics (reference src/metric/*.hpp + factory metric.cpp:21).

A copy of the host metrics of lightgbm_tpu/metrics.py that the eager
training loop calls (boosting.eval_set): the regression family (l2,
rmse, r2, l1, quantile, huber, fair, poisson, mape, gamma,
gamma_deviance, tweedie), binary_logloss, binary_error, auc,
average_precision, multi_logloss, multi_error, auc_mu, cross_entropy,
cross_entropy_lambda, kullback_leibler, and the ranking metrics ndcg@k
and map@k over the query groups (one value per eval_at entry).
Host-side numpy over (label, raw score) on unpadded arrays; each metric
reports (name, value, higher_better) with the reference names.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import log
from .config import Config


class Metric:
    name = ""
    higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray], group: Optional[np.ndarray]) -> None:
        self.label = label
        self.weight = weight
        self.group = group

    def eval(self, score: np.ndarray) -> List[Tuple[str, float, bool]]:
        """score is the RAW margin (num_class, N) or (N,); metric applies
        its own transform as the reference metrics do."""
        raise NotImplementedError

    def _avg(self, values: np.ndarray) -> float:
        if self.weight is None:
            return float(np.mean(values))
        return float(np.sum(values * self.weight) / np.sum(self.weight))


def _sigmoid(x: np.ndarray, s: float = 1.0) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-s * x))


class _PointwiseMetric(Metric):
    def point(self, label: np.ndarray, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, score: np.ndarray) -> np.ndarray:
        return score

    def eval(self, score):
        return [(self.name, self._avg(self.point(self.label, self.transform(score))), self.higher_better)]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point(self, y, s):
        return (y - s) ** 2


class RMSEMetric(_PointwiseMetric):
    name = "rmse"

    def eval(self, score):
        mse = self._avg((self.label - score) ** 2)
        return [(self.name, float(np.sqrt(mse)), False)]


class R2Metric(Metric):
    """Coefficient of determination (the one member of the reference
    metric.cpp:21 regression family previously missing here):
    R^2 = 1 - sum(w * (y - s)^2) / sum(w * (y - ybar_w)^2) with the
    weighted label mean ybar_w; constant labels yield 0 like the
    degenerate-denominator convention in sklearn."""

    name = "r2"
    higher_better = True

    def eval(self, score):
        y = self.label.astype(np.float64)
        w = (
            self.weight.astype(np.float64)
            if self.weight is not None
            else np.ones_like(y)
        )
        ybar = np.sum(w * y) / np.sum(w)
        ss_res = np.sum(w * (y - score) ** 2)
        ss_tot = np.sum(w * (y - ybar) ** 2)
        val = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
        return [(self.name, float(val), True)]


class L1Metric(_PointwiseMetric):
    name = "l1"

    def point(self, y, s):
        return np.abs(y - s)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def point(self, y, s):
        a = self.config.alpha
        d = y - s
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def point(self, y, s):
        a = self.config.alpha
        d = np.abs(s - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def point(self, y, s):
        c = self.config.fair_c
        x = np.abs(s - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def transform(self, score):
        return np.exp(score)

    def point(self, y, s):
        eps = 1e-10
        return s - y * np.log(np.maximum(s, eps))


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def point(self, y, s):
        return np.abs((y - s) / np.maximum(1.0, np.abs(y)))


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def transform(self, score):
        return np.exp(score)

    def point(self, y, s):
        psi = y / s - np.log(np.maximum(y / np.maximum(s, 1e-10), 1e-10)) - 1.0
        return psi


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def transform(self, score):
        return np.exp(score)

    def point(self, y, s):
        eps = 1e-10
        return 2.0 * (np.log(np.maximum(s, eps) / np.maximum(y, eps)) + y / np.maximum(s, eps) - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def transform(self, score):
        return np.exp(score)

    def point(self, y, s):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        s = np.maximum(s, eps)
        return -y * np.power(s, 1.0 - rho) / (1.0 - rho) + np.power(s, 2.0 - rho) / (2.0 - rho)


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def transform(self, score):
        return _sigmoid(score, self.config.sigmoid)

    def point(self, y, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def transform(self, score):
        return _sigmoid(score, self.config.sigmoid)

    def point(self, y, p):
        return ((p > 0.5) != (y > 0.5)).astype(np.float64)


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, score):
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(score, kind="mergesort")
        # the weights in f64: with f32 labels NumPy 2 keeps the running
        # sums below in f32, 1.5e-5 off at 100k rows
        ys, ws, ss = y[order], w[order].astype(np.float64), score[order]
        # sum of positive-weight ranks with tie handling
        pos_w = np.sum(ws * (ys > 0))
        neg_w = np.sum(ws * (ys <= 0))
        if pos_w <= 0 or neg_w <= 0:
            return [(self.name, 1.0, True)]
        # accumulate over tie groups
        boundaries = np.nonzero(np.diff(ss))[0] + 1
        groups = np.split(np.arange(len(ss)), boundaries)
        auc_sum = 0.0
        cum_neg = 0.0
        for gidx in groups:
            gp = np.sum(ws[gidx] * (ys[gidx] > 0))
            gn = np.sum(ws[gidx] * (ys[gidx] <= 0))
            auc_sum += gp * (cum_neg + gn * 0.5)
            cum_neg += gn
        return [(self.name, float(auc_sum / (pos_w * neg_w)), True)]


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    higher_better = True

    def eval(self, score):
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-score, kind="mergesort")
        ys, ws = y[order], w[order]
        tp = np.cumsum(ys * ws)
        total = np.cumsum(ws)
        prec = tp / total
        pos = np.sum(ys * ws)
        if pos <= 0:
            return [(self.name, 1.0, True)]
        ap = float(np.sum(prec * ys * ws) / pos)
        return [(self.name, ap, True)]


class AucMuMetric(Metric):
    """Multi-class AUC-mu (src/metric/multiclass_metric.hpp:183,
    Kleiman & Page 2019): for each class pair (i, j) rank the pair's
    rows by the separating direction v = w_i - w_j projected onto the
    prediction vectors, compute the pairwise AUC with the reference's
    kEpsilon tie handling, and average over pairs."""

    name = "auc_mu"
    higher_better = True

    def eval(self, score):
        K = self.config.num_class
        y = self.label.astype(np.int64)
        N = len(y)
        w = self.weight
        # weights matrix (config.cpp:225 GetAucMuWeights)
        amw = list(self.config.auc_mu_weights)
        if amw:
            W = np.asarray(amw, np.float64).reshape(K, K)
            np.fill_diagonal(W, 0.0)
        else:
            W = np.ones((K, K)) - np.eye(K)
        S = np.asarray(score, np.float64).reshape(K, N)
        eps = 1e-15  # reference kEpsilon
        total = 0.0
        for i in range(K):
            for j in range(i + 1, K):
                sel = (y == i) | (y == j)
                if not np.any(y[sel] == i) or not np.any(y[sel] == j):
                    continue
                v = W[i] - W[j]
                t1 = v[i] - v[j]
                d = t1 * (v @ S[:, sel])
                lab = y[sel]
                ws = w[sel] if w is not None else np.ones(sel.sum())
                # ascending distance; exact ties put class j first
                order = np.lexsort((-lab, d))
                d, lab, ws = d[order], lab[order], ws[order]
                s_ij = num_j = num_cur_j = 0.0
                last_j = 0.0
                for k in range(len(d)):
                    tie = abs(d[k] - last_j) < eps
                    if lab[k] == i:
                        s_ij += ws[k] * (
                            num_j - 0.5 * num_cur_j if tie else num_j
                        )
                    else:
                        num_j += ws[k]
                        if tie:
                            num_cur_j += ws[k]
                        else:
                            last_j = d[k]
                            num_cur_j = ws[k]
                wi = np.sum(ws[lab == i])
                wj = np.sum(ws[lab == j])
                total += (s_ij / wi) / wj
        val = 2.0 * total / K / (K - 1)
        return [(self.name, float(val), True)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score):
        # score (K, N) raw -> softmax
        e = np.exp(score - np.max(score, axis=0, keepdims=True))
        p = e / np.sum(e, axis=0, keepdims=True)
        idx = self.label.astype(int)
        eps = 1e-15
        ll = -np.log(np.clip(p[idx, np.arange(p.shape[1])], eps, 1.0))
        return [(self.name, self._avg(ll), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score):
        k = self.config.multi_error_top_k
        idx = self.label.astype(int)
        true_score = score[idx, np.arange(score.shape[1])]
        rank = np.sum(score > true_score[None, :], axis=0)
        err = (rank >= k).astype(np.float64)
        return [(self.name + (f"@{k}" if k > 1 else ""), self._avg(err), False)]


class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def transform(self, score):
        return _sigmoid(score)

    def point(self, y, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class CrossEntropyLambdaMetric(Metric):
    """reference xentropy_metric.hpp:165 CrossEntropyLambdaMetric
    (alias xentlambda): weights enter the loss itself (intensity
    weighting via hhat), and the average is over num_data, NOT the
    weight sum."""

    name = "cross_entropy_lambda"

    def eval(self, score):
        eps = 1e-12
        hhat = np.log1p(np.exp(score))  # xentlambda ConvertOutput
        w = self.weight if self.weight is not None else 1.0
        p = np.clip(1.0 - np.exp(-w * hhat), eps, 1.0 - eps)
        y = self.label
        loss = -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))
        return [(self.name, float(np.mean(loss)), False)]


class KullbackLeiblerMetric(_PointwiseMetric):
    """reference xentropy_metric.hpp:249 KullbackLeiblerDivergence:
    cross-entropy plus the (weight-averaged, score-independent) label
    entropy offset — KL(y || p) = CE(y, p) - H(y)."""

    name = "kullback_leibler"

    def transform(self, score):
        return _sigmoid(score)

    def point(self, y, p):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))

    def eval(self, score):
        y = self.label.astype(np.float64)
        yent = np.zeros_like(y)
        m = y > 0
        yent[m] += y[m] * np.log(y[m])
        q = 1.0 - y
        mq = q > 0
        yent[mq] += q[mq] * np.log(q[mq])
        offset = self._avg(yent)
        ce = self._avg(self.point(y, self.transform(score)))
        return [(self.name, float(offset + ce), False)]


class NDCGMetric(Metric):
    name = "ndcg"
    higher_better = True

    def eval(self, score):
        if self.group is None:
            log.fatal("ndcg metric requires query information")
        qb = np.concatenate([[0], np.cumsum(self.group)]).astype(int)
        ks = list(self.config.eval_at) or [1, 2, 3, 4, 5]
        gains_cfg = list(self.config.label_gain)
        max_label = int(self.label.max())
        if not gains_cfg:
            gains_cfg = [(1 << i) - 1 for i in range(max_label + 1)]
        lg = np.asarray(gains_cfg, dtype=np.float64)
        results = {k: [] for k in ks}
        for q in range(len(qb) - 1):
            lab = self.label[qb[q]: qb[q + 1]].astype(int)
            sc = score[qb[q]: qb[q + 1]]
            order = np.argsort(-sc, kind="stable")
            ideal = np.sort(lab)[::-1]
            for k in ks:
                kk = min(k, len(lab))
                disc = 1.0 / np.log2(np.arange(kk) + 2.0)
                dcg = np.sum(lg[lab[order[:kk]]] * disc)
                idcg = np.sum(lg[ideal[:kk]] * disc)
                results[k].append(dcg / idcg if idcg > 0 else 1.0)
        return [(f"ndcg@{k}", float(np.mean(results[k])), True) for k in ks]


class MapMetric(Metric):
    name = "map"
    higher_better = True

    def eval(self, score):
        if self.group is None:
            log.fatal("map metric requires query information")
        qb = np.concatenate([[0], np.cumsum(self.group)]).astype(int)
        ks = list(self.config.eval_at) or [1, 2, 3, 4, 5]
        results = {k: [] for k in ks}
        for q in range(len(qb) - 1):
            # reference map_metric.hpp CalMapAtK: relevance is
            # label > 0.5, the normalizer is min(TOTAL positives in the
            # query, k) — not positives within the top k — and queries
            # with no positives count as 1.0
            lab = (self.label[qb[q]: qb[q + 1]] > 0.5).astype(np.float64)
            sc = score[qb[q]: qb[q + 1]]
            order = np.argsort(-sc, kind="stable")
            rel = lab[order]
            npos = float(np.sum(rel))
            for k in ks:
                kk = min(k, len(rel))
                hits = np.cumsum(rel[:kk])
                if npos > 0:
                    ap = (np.sum(hits / np.arange(1, kk + 1) * rel[:kk])
                          / min(npos, kk))
                else:
                    ap = 1.0
                results[k].append(ap)
        return [(f"map@{k}", float(np.mean(results[k])), True) for k in ks]


_METRICS: Dict[str, type] = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric, "l2_root": RMSEMetric,
    "r2": R2Metric, "r_squared": R2Metric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerMetric,
    "kldiv": KullbackLeiblerMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric, "rank_xendcg": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
}

# metric implied by each objective when metric param is empty (metric.cpp)
_DEFAULT_METRIC = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "quantile": "quantile", "mape": "mape",
    "gamma": "gamma", "tweedie": "tweedie", "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
}


def create_metrics(config: Config) -> List[Metric]:
    names = [m for m in config.metric if m not in ("", "none", "null", "na", "custom")]
    if not names:
        default = _DEFAULT_METRIC.get(config.objective)
        names = [default] if default else []
    out = []
    for n in names:
        key = n.strip().lower()
        if key in ("none", "null", "na", "custom", ""):
            continue
        if key not in _METRICS:
            log.warning(f"Unknown metric {n}, ignored")
            continue
        out.append(_METRICS[key](config))
    return out
