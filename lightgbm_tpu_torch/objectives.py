"""Objective functions: per-row gradients and hessians on the device.

The port of lightgbm_tpu/objectives.py for the regression family
(RegressionL2 :127 and RegressionL1, Huber, Fair, Poisson, Quantile,
MAPE, Gamma, Tweedie :152-280), Binary :282, MulticlassSoftmax :334,
MulticlassOVA :363, CrossEntropy :394, CrossEntropyLambda :417 and the
ranking objectives LambdaRank :470 and RankXENDCG :605, with the same
math and factory names. Scores and labels are padded row
vectors on the training device; padding rows produce gradients the
grower masks out through the validity channel. Host statistics
(boost_from_score) run in numpy on the same float32 label array as the
JAX package, so the initial scores agree bit for bit. L1, Huber,
Quantile and MAPE renew their leaves by weighted percentile
(is_renew_tree_output; learner/renewal.py). LambdaRank's lambdas are the
card's lambdarank kernel (learner/ranking.py, csrc/lambdarank.cu);
RankXENDCG is torch ops over the padded query layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import log, rng
from .config import Config
from .dataset import BinnedDataset


class ObjectiveFunction:
    """Base objective (reference objective_function.h:19)."""

    name = "custom"
    num_class = 1
    # get_gradients takes the iteration (rank_xendcg redraws its
    # perturbation each iteration); the loops pass it
    needs_iter = False
    # state carried from one iteration's gradients to the next on the
    # host side of the loop (lambdarank's position biases): the fused
    # loop does not apply
    has_host_state = False
    # objectives that refit leaf outputs with residual percentiles
    # (objective_function.h:55 IsRenewTreeOutput)
    is_renew_tree_output = False

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        # a data-parallel run's mesh (parallel.comm.Mesh), set before
        # init: the host statistics (boost_from_score, is_unbalance's
        # class counts, MAPE's weights) then read every rank's rows
        self.stats_mesh = None

    def _global_rows(self, a: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """Every rank's rows of a host per-row array under stats_mesh (in
        rank order), else the array itself."""
        if a is None or self.stats_mesh is None:
            return a
        return self.stats_mesh.gather_rows(np.asarray(a))

    def init(self, dataset: BinnedDataset, device) -> None:
        meta = dataset.metadata
        if meta.label is None:
            log.fatal(f"objective {self.name} requires labels")
        self.check_label(meta.label)
        self._host_label = self._global_rows(
            dataset.padded(meta.label)[: dataset.num_data])
        self._host_weight = self._global_rows(
            dataset.padded(meta.weight)[: dataset.num_data]
            if meta.weight is not None else None)
        self.label = torch.from_numpy(dataset.padded(meta.label)).to(device)
        self.weight = (
            torch.from_numpy(dataset.padded(meta.weight)).to(device)
            if meta.weight is not None else None
        )

    def check_label(self, label: np.ndarray) -> None:
        pass

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Raw score -> prediction space (sigmoid / exp / softmax)."""
        return score

    def _w(self, g, h):
        if self.weight is not None:
            return g * self.weight, h * self.weight
        return g, h


class RegressionL2(ObjectiveFunction):
    """reference regression_objective.hpp RegressionL2loss."""

    name = "regression"

    def init(self, dataset, device) -> None:
        super().init(dataset, device)
        if self.config.reg_sqrt:
            lab = self.label
            self.label = torch.sign(lab) * torch.sqrt(torch.abs(lab))
            # host statistics read the transformed labels too
            h = self._host_label
            self._host_label = np.sign(h) * np.sqrt(np.abs(h))

    def get_gradients(self, score):
        return self._w(score - self.label, torch.ones_like(score))

    def boost_from_score(self, class_id: int) -> float:
        return float(np.average(self._host_label, weights=self._host_weight))

    def convert_output(self, score):
        if self.config.reg_sqrt:
            return np.sign(score) * score * score
        return score


def _f32(v: float) -> float:
    """A config value rounded to f32, as the JAX package's traced
    jnp.float32 constants."""
    return float(np.float32(v))


class RegressionL1(RegressionL2):
    name = "regression_l1"
    is_renew_tree_output = True

    def get_gradients(self, score):
        return self._w(torch.sign(score - self.label), torch.ones_like(score))

    def boost_from_score(self, class_id: int) -> float:
        w = self._host_weight
        if w is None:
            return float(np.percentile(self._host_label, 50))
        return _weighted_percentile(self._host_label, w, 0.5)

    def renew_percentile(self) -> float:
        return 0.5


class Huber(RegressionL2):
    name = "huber"
    is_renew_tree_output = True

    def get_gradients(self, score):
        d = score - self.label
        a = _f32(self.config.alpha)
        g = torch.where(torch.abs(d) <= a, d, torch.sign(d) * a)
        return self._w(g, torch.ones_like(score))

    def renew_percentile(self) -> float:
        return 0.5


class Fair(RegressionL2):
    name = "fair"

    def get_gradients(self, score):
        d = score - self.label
        c = _f32(self.config.fair_c)
        t = torch.abs(d) + c
        return self._w(c * d / t, _f32(c * c) / (t * t))

    def boost_from_score(self, class_id: int) -> float:
        return 0.0


class Poisson(RegressionL2):
    name = "poisson"

    def check_label(self, label):
        if np.any(label < 0):
            log.fatal(f"[{self.name}]: at least one target label is "
                      "negative")

    def get_gradients(self, score):
        mds = _f32(self.config.poisson_max_delta_step)
        return self._w(torch.exp(score) - self.label, torch.exp(score + mds))

    def boost_from_score(self, class_id: int) -> float:
        avg = np.average(self._host_label, weights=self._host_weight)
        return float(np.log(max(avg, 1e-20)))

    def convert_output(self, score):
        return np.exp(score)


class Quantile(RegressionL2):
    name = "quantile"
    is_renew_tree_output = True

    def get_gradients(self, score):
        a = np.float32(self.config.alpha)
        g = torch.where(score > self.label, float(np.float32(1.0) - a),
                        float(-a)).to(score.dtype)
        return self._w(g, torch.ones_like(score))

    def boost_from_score(self, class_id: int) -> float:
        w = self._host_weight
        if w is None:
            return float(np.percentile(self._host_label,
                                       self.config.alpha * 100))
        return _weighted_percentile(self._host_label, w, self.config.alpha)

    def renew_percentile(self) -> float:
        return float(self.config.alpha)


class MAPE(RegressionL2):
    name = "mape"
    is_renew_tree_output = True

    def init(self, dataset, device):
        super().init(dataset, device)
        lab = self.label.cpu().numpy()
        lw = 1.0 / np.maximum(np.float32(1.0), np.abs(lab))
        if self.weight is not None:
            lw = lw * self.weight.cpu().numpy()
        lw = lw.astype(np.float32)
        self._host_label_weight = self._global_rows(lw[: dataset.num_data])
        self._label_weight = torch.from_numpy(lw).to(device)

    def get_gradients(self, score):
        g = torch.sign(score - self.label) * self._label_weight
        return g, self._label_weight

    def boost_from_score(self, class_id: int) -> float:
        return _weighted_percentile(self._host_label,
                                    self._host_label_weight, 0.5)

    def renew_percentile(self) -> float:
        return 0.5


class Gamma(Poisson):
    name = "gamma"

    def get_gradients(self, score):
        e = self.label * torch.exp(-score)
        return self._w(1.0 - e, e)


class Tweedie(Poisson):
    name = "tweedie"

    def get_gradients(self, score):
        rho = _f32(self.config.tweedie_variance_power)
        e1 = torch.exp(_f32(1.0 - rho) * score)
        e2 = torch.exp(_f32(2.0 - rho) * score)
        g = -self.label * e1 + e2
        h = -self.label * _f32(1.0 - rho) * e1 + _f32(2.0 - rho) * e2
        return self._w(g, h)


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         alpha: float) -> float:
    """The first value whose cumulative weight reaches alpha * total
    (objectives._weighted_percentile)."""
    order = np.argsort(values)
    v, w = values[order], weights[order]
    cw = np.cumsum(w)
    idx = int(np.searchsorted(cw, alpha * cw[-1]))
    return float(v[min(idx, len(v) - 1)])


class Binary(ObjectiveFunction):
    """reference binary_objective.hpp: sigmoid scaling, is_unbalance /
    scale_pos_weight label weighting."""

    name = "binary"

    def check_label(self, label):
        u = np.unique(label)
        if not np.all(np.isin(u, [0, 1])):
            log.fatal("[binary]: labels must be 0 or 1")

    def init(self, dataset, device):
        super().init(dataset, device)
        lab = self._host_label
        cnt_pos = float(np.sum(lab == 1))
        cnt_neg = float(np.sum(lab == 0))
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self._pos_w, self._neg_w = 1.0, cnt_pos / cnt_neg
            else:
                self._pos_w, self._neg_w = cnt_neg / cnt_pos, 1.0
        else:
            self._pos_w = float(self.config.scale_pos_weight)
            self._neg_w = 1.0

    def get_gradients(self, score):
        sig = float(np.float32(self.config.sigmoid))
        y = self.label
        p = torch.sigmoid(sig * score)
        lw = torch.where(y > 0, self._pos_w, self._neg_w).to(score.dtype)
        g = (p - y) * sig * lw
        h = p * (1.0 - p) * sig * sig * lw
        return self._w(g, h)

    def boost_from_score(self, class_id: int) -> float:
        lab = self._host_label
        w = self._host_weight if self._host_weight is not None \
            else np.ones_like(lab)
        lw = np.where(lab > 0, self._pos_w, self._neg_w) * w
        pavg = float(np.sum(lab * lw) / max(np.sum(lw), 1e-20))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.config.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * score))


class MulticlassSoftmax(ObjectiveFunction):
    """reference multiclass_objective.hpp MulticlassSoftmax."""

    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class

    def check_label(self, label):
        if np.any(label < 0) or np.any(label >= self.num_class):
            log.fatal("[multiclass]: label must be in [0, num_class)")

    def get_gradients(self, score):
        # score (K, N); jax.nn.softmax's formula
        e = torch.exp(score - score.max(dim=0, keepdim=True).values)
        p = e / e.sum(dim=0, keepdim=True)
        y = torch.nn.functional.one_hot(
            self.label.to(torch.int64), self.num_class).T.to(score.dtype)
        g = p - y
        h = 2.0 * p * (1.0 - p)  # reference factor 2
        if self.weight is not None:
            g = g * self.weight[None, :]
            h = h * self.weight[None, :]
        return g, h

    def convert_output(self, score):
        e = np.exp(score - np.max(score, axis=0, keepdims=True))
        return e / np.sum(e, axis=0, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K independent sigmoid binaries (multiclass_objective.hpp)."""

    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class

    def get_gradients(self, score):
        sig = float(np.float32(self.config.sigmoid))
        y = torch.nn.functional.one_hot(
            self.label.to(torch.int64), self.num_class).T.to(score.dtype)
        p = torch.sigmoid(sig * score)
        g = (p - y) * sig
        h = p * (1.0 - p) * sig * sig
        if self.weight is not None:
            g = g * self.weight[None, :]
            h = h * self.weight[None, :]
        return g, h

    def boost_from_score(self, class_id: int) -> float:
        p = float(np.mean(self._host_label == class_id))
        p = min(max(p, 1e-15), 1.0 - 1e-15)
        return float(np.log(p / (1.0 - p)) / self.config.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.config.sigmoid * score))


class CrossEntropy(ObjectiveFunction):
    """reference xentropy_objective.hpp: labels in [0, 1]."""

    name = "cross_entropy"

    def check_label(self, label):
        if np.any(label < 0) or np.any(label > 1):
            log.fatal("[cross_entropy]: labels must be in [0, 1]")

    def get_gradients(self, score):
        p = torch.sigmoid(score)
        return self._w(p - self.label, p * (1.0 - p))

    def boost_from_score(self, class_id: int) -> float:
        pavg = float(np.average(self._host_label, weights=self._host_weight))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-score))


class CrossEntropyLambda(ObjectiveFunction):
    """reference xentropy_objective.hpp:185 CrossEntropyLambda (alias
    xentlambda): weighted cross-entropy through the normalized exponential
    parameterization; with unit weights it is plain cross-entropy. The
    weighted gradients use the JAX package's stable f32 forms (softplus
    and sigmoid in place of raw exp, scores clamped to +-30)."""

    name = "cross_entropy_lambda"

    def check_label(self, label):
        if np.any(label < 0) or np.any(label > 1):
            log.fatal("[cross_entropy_lambda]: labels must be in [0, 1]")

    def init(self, dataset, device):
        super().init(dataset, device)
        if self._host_weight is not None and self._host_weight.min() <= 0:
            log.fatal("[cross_entropy_lambda]: at least one weight is "
                      "non-positive")

    def get_gradients(self, score):
        if self.weight is None:
            z = torch.sigmoid(score)
            return z - self.label, z * (1.0 - z)
        w, y = self.weight, self.label
        sc = torch.clamp(score, -30.0, 30.0)
        epf = torch.exp(sc)
        hhat = torch.logaddexp(sc, torch.zeros_like(sc))  # softplus
        z = 1.0 - torch.exp(-w * hhat)
        g = (1.0 - y / torch.clamp_min(z, 1e-15)) * w * torch.sigmoid(sc)
        c = 1.0 / torch.clamp_min(1.0 - z, 1e-15)
        a = w * torch.sigmoid(sc) * torch.sigmoid(-sc)
        d2 = torch.clamp_min(c - 1.0, 1e-15)
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        return g, a * (1.0 + y * b)

    def boost_from_score(self, class_id: int) -> float:
        havg = float(np.average(self._host_label, weights=self._host_weight))
        return float(np.log(max(np.expm1(havg), 1e-15)))

    def convert_output(self, score):
        # the normalized exponential parameter lambda, not a probability
        return np.logaddexp(0.0, score)


# ---------------------------------------------------------------- ranking
def _query_group(name: str, dataset) -> np.ndarray:
    group = dataset.metadata.group
    if group is None:
        log.fatal(f"{name} requires query group information")
    return group


class LambdaRank(ObjectiveFunction):
    """reference rank_objective.hpp LambdarankNDCG: per query, the
    documents sorted by score and pairwise delta-NDCG weighted sigmoid
    lambdas, with the truncation level, the norm, label_gain and the
    document weights; the hessian floored at 2e-7 (queries of equal
    labels give none). With positions, the position-bias factors
    (rank_objective.hpp:55-98,302) shift the scores before the lambdas
    and take a Newton step from the lambdas each iteration: host-side
    state across iterations, so such a run keeps to the eager loop
    (has_host_state), as in the JAX package."""

    name = "lambdarank"

    def init(self, dataset, device):
        from .learner.ranking import (build_query_layout, inverse_max_dcg,
                                      label_gains)

        super().init(dataset, device)
        group = _query_group(self.name, dataset)
        label = dataset.metadata.label
        npad = dataset.num_rows_padded()
        self._layout = build_query_layout(group, npad)
        self._layout.device(device)
        gains = label_gains(self.config, label)
        self._trunc = int(self.config.lambdarank_truncation_level)
        self._norm = bool(self.config.lambdarank_norm)
        self._sigmoid = float(self.config.sigmoid)
        if self._sigmoid <= 0:
            log.fatal(f"Sigmoid param {self._sigmoid} should be greater "
                      "than zero")
        imd = inverse_max_dcg(label, self._layout, gains, self._trunc)
        t = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(device)
        self._gain_dev = t(gains)
        self._imd_dev = t(imd)
        self._pos_biases = None
        pos = dataset.metadata.position
        if pos is not None:
            pos = np.asarray(pos, np.int64)
            self._num_pos = int(pos.max()) + 1
            posp = np.zeros(npad, np.int32)
            posp[: len(pos)] = pos
            self._positions = torch.from_numpy(posp).to(device)
            self._valid_rows = t(np.arange(npad) < len(pos))
            self._pos_reg = _f32(
                self.config.lambdarank_position_bias_regularization)
            self._pos_lr = _f32(self.config.learning_rate)
            self._pos_biases = torch.zeros(self._num_pos,
                                           dtype=torch.float32,
                                           device=device)
            self.has_host_state = True

    def _lambdas(self, score, hess_floor):
        from .learner.ranking import lambdarank

        return lambdarank(self._layout, score, self.label, self._gain_dev,
                          self._imd_dev, self._sigmoid, self._trunc,
                          self._norm, self.weight, hess_floor)

    def get_gradients(self, score):
        if self._pos_biases is None:
            return self._lambdas(score, True)
        from .learner.histogram import seg_sum

        b = self._pos_biases
        g, h = self._lambdas(score + b[self._positions.long()], False)
        # UpdatePositionBiasFactors: a Newton step on the utility's
        # derivatives in each position's bias factor (seg_sum: the same
        # bits on every run on the card)
        v = self._valid_rows
        d1, d2, cnt = seg_sum(torch.stack([-g * v, -h * v, v]),
                              self._positions, self._num_pos)
        reg = self._pos_reg
        d1 = d1 - b * reg * cnt
        d2 = d2 - reg * cnt
        self._pos_biases = b + self._pos_lr * d1 / (torch.abs(d2)
                                                     + _f32(0.001))
        return g, torch.clamp_min(h, _f32(2e-7))

    @property
    def position_biases(self):
        """The learned per-position bias factors (None without positions)."""
        return self._pos_biases


class RankXENDCG(ObjectiveFunction):
    """reference rank_objective.hpp RankXENDCG: per-query softmax scores
    against a perturbed 2^label ground truth, with the three-term gradient
    series of the XE-NDCG loss. Its uniforms are the JAX package's bits:
    rng.uniform over the padded (Q, M) layout keyed fold_in(key(
    objective_seed), it), `it` the loop's iteration (the device counter
    on the fused loop)."""

    name = "rank_xendcg"
    needs_iter = True

    def check_label(self, label):
        if np.any(label < 0):
            log.fatal("[rank_xendcg]: relevance labels must be non-negative")

    def init(self, dataset, device):
        from .learner.ranking import build_query_layout

        super().init(dataset, device)
        group = _query_group(self.name, dataset)
        self._layout = build_query_layout(group, dataset.num_rows_padded())
        d = self._layout.device(device)
        self._multi = d["qvalid"].sum(dim=1, keepdim=True) > 1
        self._key = rng.key(self.config.objective_seed, device)

    def get_gradients(self, score, it=0):
        lay = self._layout
        d = lay.device(score.device)
        qd, qv = d["qdoc"], d["qvalid"]
        eps = _f32(1e-15)
        zero = torch.zeros((), dtype=torch.float32, device=score.device)
        s = torch.where(qv, score[qd], -1e30)
        lb = torch.where(qv, self.label[qd], zero)
        # jax.nn.softmax's formula, per query
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        rho = e / e.sum(dim=1, keepdim=True)
        u = rng.uniform(rng.fold_in(self._key, it), qv.shape)
        phi = torch.where(qv, torch.exp2(torch.floor(lb)) - u, zero)
        inv_den = 1.0 / torch.clamp_min(phi.sum(dim=1, keepdim=True), eps)
        t1 = -phi * inv_den + rho
        one_m = torch.clamp_min(1.0 - rho, eps)
        p2 = t1 / one_m
        sum1 = torch.where(qv, p2, zero).sum(dim=1, keepdim=True)
        t2 = rho * (sum1 - p2)
        p3 = t2 / one_m
        sum2 = torch.where(qv, p3, zero).sum(dim=1, keepdim=True)
        lam = t1 + t2 + rho * (sum2 - p3)
        hess = rho * (1.0 - rho)
        ok = qv & self._multi
        lam = torch.where(ok, lam, zero).reshape(-1)[d["cell"]]
        hess = torch.where(ok, hess, zero).reshape(-1)[d["cell"]]
        pad = lay.npad - lay.num_docs
        g = torch.nn.functional.pad(lam, (0, pad))
        h = torch.nn.functional.pad(hess, (0, pad))
        g, h = self._w(g, h)
        return g, torch.clamp_min(h, _f32(2e-7))


_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": Binary,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdaRank,
    "rank_xendcg": RankXENDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference objective_function.cpp:22)."""
    name = config.objective
    if name == "none":
        return None
    if name not in _OBJECTIVES:
        log.fatal(f"Unknown objective type name: {name}")
    return _OBJECTIVES[name](config)
