"""Row sampling strategies: bagging and GOSS.

The port of lightgbm_tpu/sample_strategy.py (reference
include/LightGBM/sample_strategy.h:23, src/boosting/bagging.hpp,
src/boosting/goss.hpp). A sample is a per-row {0, 1} mask on the
training device that multiplies the gradient channels: rows outside the
bag add nothing to the histograms or the counts, while the partition
still routes them, so their scores stay correct. The draws are the JAX
package's, bit for bit (rng.py): bagging keys on the bagging window of
the global iteration, GOSS on the iteration. The iteration is a host int
(the eager loop) or a 0-dim device tensor (the fused loop, whose CUDA
graph reads nothing back); both give the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import log, rng
from .config import Config


class SampleStrategy:
    """Produces (mask, grad, hess) per iteration."""

    def __init__(self, config: Config):
        self.config = config

    def sample(self, iter_num: int, grad: torch.Tensor, hess: torch.Tensor,
               valid: torch.Tensor, label: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (mask, grad, hess); grad / hess may be rescaled (GOSS)."""
        return valid, grad, hess


def _f32(v: float) -> float:
    """v rounded to f32, as the JAX package's traced params are."""
    return float(np.float32(v))


def _exact_fraction_mask(u: torch.Tensor, eligible: torch.Tensor,
                         frac: float) -> torch.Tensor:
    """The rows whose uniform draw is at most the k-th smallest among the
    eligible rows, k = round(frac * #eligible) (half to even, in f32),
    none when k is 0. Rows that tie with the threshold are all taken, so
    the bag can hold more than k rows, as in the JAX package."""
    n_elig = eligible.sum().to(torch.float32)
    k = torch.round(n_elig * _f32(frac)).to(torch.int64)
    ue = torch.where(eligible, u, torch.full_like(u, float("inf")))
    sorted_u = torch.sort(ue).values
    thr = sorted_u.gather(0, torch.clamp_min(k - 1, 0).reshape(1))
    return eligible & (u <= thr) & (k > 0)


class BaggingStrategy(SampleStrategy):
    """bagging_fraction / bagging_freq (and pos / neg fractions) with exact
    bag sizes, the mask drawn anew every bagging_freq iterations
    (bagging.hpp:30). The mask is a function of the window alone; one
    window's mask is kept and reused while the window and the draw's
    parameters last. Whether
    bagging runs is settled at construction; the fractions, frequency and
    seed are read from the live config, as in the JAX package.
    bagging_by_query draws exactly round(fraction * Q) whole queries with
    the row bag's key (one uniform a query); it ignores the pos / neg
    fractions and, without query groups, bags rows, each with the JAX
    package's warning."""

    def __init__(self, config: Config, group: Optional[np.ndarray] = None,
                 device="cpu"):
        super().__init__(config)
        c = config
        self.use_pos_neg = (c.pos_bagging_fraction < 1.0
                            or c.neg_bagging_fraction < 1.0)
        self.enabled = c.bagging_freq > 0 and (c.bagging_fraction < 1.0
                                               or self.use_pos_neg)
        self._cache: Optional[Tuple[tuple, torch.Tensor]] = None
        self.by_query = bool(c.bagging_by_query)
        self._row_query: Optional[torch.Tensor] = None
        if self.by_query and self.use_pos_neg:
            log.warning("bagging_by_query ignores pos/neg_bagging_fraction; "
                        "using row-level pos/neg bagging instead")
            self.by_query = False
        if self.by_query:
            if group is None:
                log.warning("bagging_by_query requires query groups; using "
                            "row-level bagging")
                self.by_query = False
            else:
                g = np.asarray(group, dtype=np.int64)
                self._num_queries = len(g)
                self._row_query = torch.from_numpy(
                    np.repeat(np.arange(len(g), dtype=np.int64), g)).to(
                        device)

    def window_mask(self, window: Union[int, torch.Tensor],
                    valid: torch.Tensor,
                    label: Optional[torch.Tensor]) -> torch.Tensor:
        """The bag of one window as bool rows (a fresh draw)."""
        c = self.config
        key = rng.fold_in(rng.key(c.bagging_seed, valid.device), window)
        if self.by_query:
            # exactly round(frac * Q) whole queries (bagging.hpp
            # bagging_by_query)
            rq = self._row_query
            uq = rng.uniform(key, (self._num_queries,))
            qsel = _exact_fraction_mask(
                uq, torch.ones_like(uq, dtype=torch.bool),
                c.bagging_fraction)
            pad = torch.zeros(valid.shape[0] - rq.shape[0], dtype=torch.bool,
                              device=valid.device)
            return torch.cat([qsel[rq], pad])
        u = rng.uniform(key, valid.shape)
        elig = valid > 0
        if self.use_pos_neg and label is not None:
            pos = _exact_fraction_mask(u, elig & (label > 0),
                                       c.pos_bagging_fraction)
            neg = _exact_fraction_mask(u, elig & (label <= 0),
                                       c.neg_bagging_fraction)
            return pos | neg
        return _exact_fraction_mask(u, elig, c.bagging_fraction)

    def sample(self, iter_num, grad, hess, valid, label):
        c = self.config
        if not self.enabled:
            return valid, grad, hess
        if isinstance(iter_num, torch.Tensor):
            # the fused loop: the window from the device counter, the bag
            # drawn anew every iteration (the draw is a function of the
            # window, so this is the cached bag, bit for bit)
            window = torch.div(iter_num, c.bagging_freq,
                               rounding_mode="floor") * c.bagging_freq
            bag = self.window_mask(window, valid, label)
            return bag.to(torch.float32) * valid, grad, hess
        window = (int(iter_num) // c.bagging_freq) * c.bagging_freq
        # everything the draw reads, so a reset_parameter redraws
        draw = (window, c.bagging_seed, c.bagging_fraction,
                c.pos_bagging_fraction, c.neg_bagging_fraction)
        if self._cache is None or self._cache[0] != draw:
            self._cache = (draw, self.window_mask(window, valid, label))
        return self._cache[1].to(torch.float32) * valid, grad, hess


class GOSSStrategy(SampleStrategy):
    """Gradient one-side sampling (goss.hpp): keep the rows whose |g * h|
    exceeds the top_n-th largest, sample other_rate of the rest and
    amplify their grad / hess by (1 - top_rate) / other_rate. No sampling
    while iter < int(1 / learning_rate) + 1, the JAX package's rule."""

    def sample(self, iter_num, grad, hess, valid, label):
        c = self.config
        warm_up = int(1.0 / c.learning_rate) + 1
        device_it = isinstance(iter_num, torch.Tensor)
        if not device_it and int(iter_num) < warm_up:
            return valid, grad, hess
        w = torch.abs(grad * hess) * valid
        n_valid = valid.sum()
        top_n = torch.clamp_min((n_valid * _f32(c.top_rate)).to(torch.int64),
                                1)
        sorted_w = torch.sort(w, descending=True).values
        thr = sorted_w.gather(
            0, torch.clamp_max(top_n, w.shape[0] - 1).reshape(1))
        top = w > thr
        rest = (~top) & (valid > 0)
        key = rng.fold_in(rng.key(c.bagging_seed * 7919, w.device), iter_num)
        p_rest = c.other_rate / max(1e-12, 1.0 - c.top_rate)
        sampled = rest & (rng.uniform(key, w.shape) < _f32(p_rest))
        amp = (1.0 - c.top_rate) / max(c.other_rate, 1e-12)
        mult = top.to(torch.float32) + sampled.to(torch.float32) * _f32(amp)
        mask = (top | sampled).to(torch.float32) * valid
        if device_it:
            # the warm-up decided on the device: the unsampled rows
            # before it, as the host branch above returns them
            warm = iter_num < warm_up
            return (torch.where(warm, valid, mask),
                    torch.where(warm, grad, grad * mult),
                    torch.where(warm, hess, hess * mult))
        return mask, grad * mult, hess * mult


def create_sample_strategy(config: Config,
                           group: Optional[np.ndarray] = None,
                           device="cpu") -> SampleStrategy:
    """Factory (reference sample_strategy.cpp:15); `group`, the training
    set's query sizes, for bagging_by_query."""
    if config.data_sample_strategy == "goss":
        return GOSSStrategy(config)
    return BaggingStrategy(config, group, device)
