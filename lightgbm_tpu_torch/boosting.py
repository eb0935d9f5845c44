"""GBDT boosting, the eager training loop (reference src/boosting/gbdt.cpp).

The port of the JAX package's GBDT eager loop (lightgbm_tpu/boosting.py
_train_one_iter_fast :1212-1278). Each iteration:

  gradients (device, objective; or the caller's, for a custom fobj) ->
  per class: the row sample (sample_strategy: bagging's mask, GOSS's
  mask and amplified g / h) and the feature_fraction mask ->
  _grow_maybe_quantized: on
  the default int16 path and under use_quantized_grad, integer levels
  with stochastic rounding (_quantize, keyed on fold_in(data_random_seed,
  it * K + k) like the JAX package) -> rounds grower (int16 or int8
  channels; above 256 public levels and on the exact path the dequantized
  levels as f32 gradients) -> leaf renewal from the true gradients
  (always on the int16 default, with quant_train_renew_leaf under
  use_quantized_grad); on the f32 paths (tpu_hist_dtype=bf16x2,
  tpu_growth_mode=exact): the f32 gradients straight to the rounds or the
  permuted grower -> the renewing objectives' percentile leaf refit
  (learner/renewal.py) -> score updates: train through the row -> leaf
  vector (take_small kernel), validation sets through the binned tree
  traversal -> host Tree, materialized lazily in batches.

Every draw keys on the global iteration (iter_, which counts an
init_model's loaded iterations), so continued training draws what an
uninterrupted run would.

Boost-from-average follows gbdt.cpp:327-445: the initial score is added
to every score set before the first iteration and folded into the first
tree's stored leaf values, so saved models are self-contained.

The JAX package's fused chunk-scan step (_build_fused, fused_dispatch)
is not ported: its output is bit-identical to this eager loop. DART, RF,
per-node sampling and the other options the main path does not run raise
NotImplementedError (ROADMAP queue A).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import log, rng
from .config import Config, resolve_device
from .dataset import BinnedDataset
from .learner.grower import (
    GrowerSpec,
    TreeArrays,
    add_score,
    grow_tree,
    make_split_params,
)
from .metrics import Metric, create_metrics
from .objectives import ObjectiveFunction, create_objective
from .sample_strategy import create_sample_strategy
from .tree import Tree, traverse_tree_bins


@dataclass
class _ScoreSet:
    dataset: BinnedDataset
    score: Any  # (K, Npad) f32 on the training device
    name: str
    metrics: List[Metric] = field(default_factory=list)
    dev: Any = None  # the dataset's device arrays


def _not_ported(what: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue A)")


def check_supported(config: Config, train_set: BinnedDataset) -> None:
    """Refuse every option the port does not implement yet, loudly."""
    c = config
    if c.boosting != "gbdt":
        _not_ported(f"boosting={c.boosting}")
    if c.feature_fraction_bynode < 1.0 or c.extra_trees:
        _not_ported("per-node extras (feature_fraction_bynode, extra_trees)")
    if (c.cegb_penalty_split > 0.0 or c.cegb_penalty_feature_coupled
            or c.cegb_penalty_feature_lazy):
        _not_ported("CEGB penalties")
    if c.interaction_constraints:
        _not_ported("interaction_constraints")
    if c.forcedsplits_filename:
        _not_ported("forced splits")
    if c.linear_tree:
        _not_ported("linear_tree")
    if c.tree_learner not in ("serial",):
        _not_ported(f"tree_learner={c.tree_learner} (distributed learners)")
    if c.tpu_debug_check_split:
        _not_ported("tpu_debug_check_split")
    mono = train_set.monotone_constraints
    if (mono is not None and np.any(mono != 0)
            and c.monotone_constraints_method in ("intermediate",
                                                  "advanced")):
        _not_ported(f"monotone_constraints_method="
                    f"{c.monotone_constraints_method}")


def tree_arrays_to_host(a: TreeArrays) -> TreeArrays:
    return TreeArrays(*[x.detach().cpu().numpy() for x in a])


class GBDT:
    """Boosting state and the training loop (reference gbdt.h:37)."""

    def __init__(self, config: Config, train_set: Optional[BinnedDataset]):
        self.config = config
        self.train_set = train_set
        self.num_class = config.num_model_per_iteration
        self.shrinkage_rate = config.learning_rate
        self.average_output = False
        self._models: List[Tree] = []  # iteration-major (models_[it*K + k])
        self.device_trees: List[TreeArrays] = []
        self.iter_ = 0
        self._init_iters = 0  # iterations adopted from an init_model
        self.valids: List[_ScoreSet] = []
        self._pending: List[TreeArrays] = []
        self._pending_meta: List[Tuple[int, float, float]] = []
        self._stopped = False
        self._check_every = 64
        self.objective: Optional[ObjectiveFunction] = None
        if train_set is None:
            return  # prediction-only booster (model loaded from text)

        from .config import warn_unimplemented
        from .learner.quantize import resolve_hist_dtype

        warn_unimplemented(config)
        check_supported(config, train_set)
        self.device = torch.device(resolve_device(config))
        self.objective = create_objective(config)
        # growth strategy (boosting.py:604-689 of the JAX package): `auto`
        # is the rounds grower on every device here; `exact` the
        # sequential permuted grower, with its round phase on request
        use_rounds = config.tpu_growth_mode != "exact"
        self.hist_dtype, self._hist_levels = resolve_hist_dtype(
            config.tpu_hist_dtype, config.use_quantized_grad,
            config.num_grad_quant_bins, use_rounds,
        )
        self._int_packed = self._hist_levels > 0
        # leaf renewal bypasses the grower's monotone clamp and path
        # smoothing, so those configurations keep the grower's outputs
        mono = train_set.monotone_constraints
        has_mono = bool(mono is not None and np.any(mono != 0))
        self._true_renew_ok = not (config.path_smooth > 0 or has_mono)
        self._quant_renew_ok = True
        if (config.use_quantized_grad and config.quant_train_renew_leaf
                and not self._true_renew_ok):
            self._quant_renew_ok = False
            log.warning(
                "quant_train_renew_leaf is disabled: true-gradient leaf "
                "renewal would bypass monotone constraints / path_smooth"
            )
        # public quantized levels (use_quantized_grad) or the internal
        # int-packed policy's; levels <= 256 ride integer channels on
        # the rounds grower, <= 127 its int8 mode
        qgrad = config.use_quantized_grad
        levels = config.num_grad_quant_bins if qgrad else self._hist_levels
        if self.objective is not None:
            self.objective.init(train_set, self.device)
        self.strategy = create_sample_strategy(config)
        # the raw labels: pos / neg bagging's classes, the percentile
        # refit's residuals
        label = train_set.metadata.label
        self._label_dev = (None if label is None else torch.from_numpy(
            train_set.padded(label)).to(self.device))
        self.dev = train_set.device_arrays(self.device)
        from .binning import BinType

        cats = [m for m in train_set.used_mappers()
                if m.bin_type == BinType.CATEGORICAL]
        self.spec = GrowerSpec(
            num_leaves=config.num_leaves,
            num_bins=train_set.max_num_bin,
            max_depth=config.max_depth,
            # slot defaults as the JAX package's: 48 on the integer
            # path and under use_quantized_grad, 25 on the f32 path; they
            # decide which leaves a round takes when the leaf budget binds
            rounds_slots=(min(config.tpu_round_slots
                              or (48 if (qgrad or self._int_packed)
                                  else 25),
                              config.num_leaves) if use_rounds else 0),
            efb=train_set.bundle_layout is not None,
            col_bins=train_set.col_bins,
            quant_levels=levels,
            has_mono=has_mono,
            quant=use_rounds and ((qgrad and levels <= 256)
                                  or self._int_packed),
            quant_int8=use_rounds and levels <= 127 and (
                qgrad or self._int_packed),
            rounds=config.tpu_growth_rounds and not use_rounds,
            # sorted-subset search when a categorical is wider than
            # max_cat_to_onehot (boosting.py:448-452 of the JAX package)
            cat_subset=any(m.num_bin > config.max_cat_to_onehot
                           for m in cats),
            has_cat=bool(cats),
        )
        self.params = make_split_params(config)
        self.train = self._score_set(train_set, "training", self.dev)

    # ------------------------------------------------------------------
    def _score_set(self, ds: BinnedDataset, name: str, dev) -> _ScoreSet:
        npad = ds.num_rows_padded()
        score = np.zeros((self.num_class, npad), dtype=np.float32)
        init = ds.metadata.init_score
        if init is not None:
            init = np.asarray(init, dtype=np.float32)
            if init.size == ds.num_data * self.num_class:
                score[:, : ds.num_data] = init.reshape(self.num_class,
                                                       ds.num_data)
            else:
                score[:, : ds.num_data] = init[None, :]
        ss = _ScoreSet(ds, torch.from_numpy(score).to(self.device), name,
                       create_metrics(self.config), dev)
        meta = ds.metadata
        for m in ss.metrics:
            m.init(meta.label, meta.weight, meta.group)
        return ss

    def add_valid(self, valid_set: BinnedDataset, name: str) -> None:
        self.valids.append(self._score_set(
            valid_set, name, valid_set.device_arrays(self.device)))

    @property
    def has_init_score(self) -> bool:
        return self.train_set.metadata.init_score is not None

    @property
    def models(self) -> List[Tree]:
        self._materialize()
        return self._models

    @models.setter
    def models(self, value: List[Tree]) -> None:
        self._pending = []
        self._pending_meta = []
        self._models = value

    # ------------------------------------------------------------------
    def _quantize(self, gk, hk, it: int, k: int):
        """Integer levels + scales for one tree (boosting._quantize): the
        public num_grad_quant_bins under use_quantized_grad, else the
        internal int-packed policy's levels."""
        from .learner.quantize import discretize_gradients_int

        c = self.config
        key = rng.fold_in(rng.key(c.data_random_seed, gk.device),
                          it * self.num_class + k)
        return discretize_gradients_int(gk, hk, key,
                                        self._hist_levels
                                        or c.num_grad_quant_bins,
                                        c.stochastic_rounding)

    def _renew_true(self, arrays, row_leaf, gk, hk, mask):
        """Leaf outputs from the TRUE per-leaf gradient sums."""
        from .learner.quantize import renew_leaf_with_true_gradients

        return arrays._replace(
            leaf_value=renew_leaf_with_true_gradients(
                arrays.leaf_value, row_leaf, gk, hk, mask, self.params,
                self.spec.num_leaves,
            )
        )

    def _grow_maybe_quantized(self, gk, hk, mask, feat_mask, valid, it, k):
        """One tree (boosting._grow_maybe_quantized /
        _grow_int_packed). The internal int-packed policy grows on integer
        levels and always renews from the true gradients (unless monotone
        constraints or path smoothing forbid it). use_quantized_grad grows
        on the integer levels when the rounds grower takes them (<= 256
        levels), else on the dequantized levels as f32 gradients, and
        renews only with quant_train_renew_leaf. Otherwise the f32
        gradients go to the grower as they are."""
        c = self.config
        if not c.use_quantized_grad:
            if self._int_packed:
                gq, hq, scale = self._quantize(gk, hk, it, k)
                arrays, row_leaf = self._grow(gq, hq, mask, feat_mask,
                                              valid, gh_scale=scale)
                if self._true_renew_ok:
                    arrays = self._renew_true(arrays, row_leaf, gk, hk, mask)
                return arrays, row_leaf
            return self._grow(gk, hk, mask, feat_mask, valid)
        gq, hq, scale = self._quantize(gk, hk, it, k)
        if self.spec.quant:
            arrays, row_leaf = self._grow(gq, hq, mask, feat_mask, valid,
                                          gh_scale=scale)
        else:
            arrays, row_leaf = self._grow(gq * scale[0], hq * scale[1], mask,
                                          feat_mask, valid)
        if c.quant_train_renew_leaf and self._quant_renew_ok:
            arrays = self._renew_true(arrays, row_leaf, gk, hk, mask)
        return arrays, row_leaf

    def _grow(self, gk, hk, mask, feat_mask, valid, gh_scale=None):
        """Grow one tree on f32 gradients, or on integer levels with
        their scales (boosting._grow)."""
        d = self.dev
        return grow_tree(
            d["bins"], d["nan_bin"], d["num_bins"], d["mono"], d["is_cat"],
            gk, hk, mask, feat_mask, self.params, self.spec, valid=valid,
            bundle=d["bundle"], gh_scale=gh_scale,
        )

    def _renewal_setup(self):
        """(alpha, weights) for the percentile leaf refit, or (None, None)
        when the objective does not renew (boosting._renewal_setup). MAPE
        renews with its label-derived weights
        (regression_objective.hpp:641)."""
        o = self.objective
        if o is None or not o.is_renew_tree_output:
            return None, None
        w = getattr(o, "_label_weight", None)
        if w is None:
            w = o.weight
        if w is None:
            w = torch.ones(self.train_set.num_rows_padded(),
                           dtype=torch.float32, device=self.device)
        return float(o.renew_percentile()), w

    def _apply_renewal(self, arrays, row_leaf, score_k, mask, alpha, w):
        """The percentile leaf refit on the residuals label - score, the
        score taken before this tree's update (boosting._apply_renewal)."""
        from .learner.renewal import renew_leaf_values

        resid = self._label_dev - score_k
        return arrays._replace(
            leaf_value=renew_leaf_values(
                arrays.leaf_value, row_leaf, resid, w * mask, alpha,
                self.spec.num_leaves,
            )
        )

    def _traverse(self, arrays: TreeArrays, dev) -> torch.Tensor:
        return traverse_tree_bins(arrays, dev["bins"], dev["nan_bin"],
                                  dev["bundle"], has_cat=self.spec.has_cat)

    # ------------------------------------------------------------------
    def _materialize(self) -> None:
        """Copy pending device trees to the host in one batch and convert
        them to host Trees; detect the reference's stop condition (an
        iteration where no class tree could split, gbdt.cpp:429-452)
        after the fact and drop that iteration and everything behind it."""
        if not self._pending:
            return
        host = [tree_arrays_to_host(a) for a in self._pending]
        meta = self._pending_meta
        self._pending = []
        self._pending_meta = []
        K = self.num_class
        base = len(self._models)
        for i0 in range(0, len(host), K):
            group = host[i0: i0 + K]
            if all(int(a.num_nodes) == 0 for a in group):
                if base + i0 == 0:
                    for a, (k, bias, shrink) in zip(group, meta[i0: i0 + K]):
                        if (abs(bias) < 1e-15 and self.objective is not None
                                and not self.config.boost_from_average
                                and not self.has_init_score):
                            bias = self.objective.boost_from_score(k)
                            if abs(bias) > 1e-15:
                                self.train.score[k] += bias
                                for vs in self.valids:
                                    vs.score[k] += bias
                        t = Tree(num_leaves=1, shrinkage=1.0)
                        t.leaf_value = np.array([bias], np.float64)
                        self._models.append(t)
                    i0 += K
                # roll back the scores of later iterations that did split
                for j in range(i0, len(host)):
                    if int(host[j].num_nodes) == 0:
                        continue
                    arrays = self.device_trees[base + j]
                    k = meta[j][0]
                    for ss in [self.train] + self.valids:
                        leaf = self._traverse(arrays, ss.dev)
                        ss.score[k] -= arrays.leaf_value[leaf.long()]
                log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                del self.device_trees[len(self._models):]
                self.iter_ = len(self._models) // K
                self._stopped = True
                return
            for a, (k, bias, shrink) in zip(group, meta[i0: i0 + K]):
                if int(a.num_nodes) > 0:
                    # stored leaf values already carry shrinkage + bias
                    tree = Tree.from_arrays(a, self.train_set, 1.0)
                    tree.shrinkage = shrink
                else:
                    tree = Tree(num_leaves=1, shrinkage=1.0)
                    tree.leaf_value = np.array([bias], np.float64)
                self._models.append(tree)

    def _sample_features(self, it: int, k: int) -> torch.Tensor:
        """Per-tree feature_fraction mask (ColSampler, col_sampler.hpp:20):
        the first ceil(frac * F) of jax.random.permutation(fold_in(
        key(feature_fraction_seed), it * K + k), F), as the JAX package
        draws it. The F-element permutation is drawn on the CPU, and the F
        booleans copied to the training device."""
        F = self.train_set.num_used_features
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return torch.ones(F, dtype=torch.bool, device=self.device)
        n = max(1, int(np.ceil(frac * F)))
        key = rng.fold_in(rng.key(self.config.feature_fraction_seed),
                          it * self.num_class + k)
        return (rng.permutation(key, F) < n).to(self.device)

    def _prepare_gradients(self, grad, hess):
        """Boost-from-average on the first iteration (gbdt.cpp:327), then
        the objective's gradients at the current score; or the caller's
        grad / hess (a custom fobj: K * num_data values, class-major, as
        the JAX package's _prepare_gradients takes them), padded.
        Returns (grad (K, Npad), hess (K, Npad), init_scores)."""
        K = self.num_class
        init_scores = [0.0] * K
        if grad is not None and hess is not None:
            n = self.train_set.num_data
            npad = self.train_set.num_rows_padded()
            out = []
            for v in (grad, hess):
                v = np.asarray(v, dtype=np.float32).reshape(K, n)
                p = torch.zeros((K, npad), dtype=torch.float32)
                p[:, :n] = torch.from_numpy(v)
                out.append(p.to(self.device))
            return out[0], out[1], init_scores
        if self.objective is None:
            log.fatal("custom objective requires explicit grad/hess")
        if (not self._models and not self._pending
                and self.config.boost_from_average
                and not self.has_init_score):
            for k in range(K):
                init = self.objective.boost_from_score(k)
                if abs(init) > 1e-15:
                    init_scores[k] = init
                    self.train.score[k] += init
                    for vs in self.valids:
                        vs.score[k] += init
                    log.info(f"Start training from score {init:f}")
        score = self.train.score if K > 1 else self.train.score[0]
        g, h = self.objective.get_gradients(score)
        return (g.reshape(K, -1).to(torch.float32),
                h.reshape(K, -1).to(torch.float32), init_scores)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; True when training should stop (no
        splittable leaf), as GBDT::TrainOneIter (gbdt.cpp:352). grad /
        hess: a custom objective's gradients (_prepare_gradients)."""
        if self._stopped:
            return True
        K = self.num_class
        grad, hess, init_scores = self._prepare_gradients(grad, hess)
        valid = self.dev["valid"]
        renew_alpha, renew_w = self._renewal_setup()
        for k in range(K):
            mask, gk, hk = self.strategy.sample(self.iter_, grad[k], hess[k],
                                                valid, self._label_dev)
            feat_mask = self._sample_features(self.iter_, k)
            arrays, row_leaf = self._grow_maybe_quantized(
                gk, hk, mask, feat_mask, valid, self.iter_, k)
            ok = (arrays.num_nodes > 0).to(torch.float32)
            if renew_alpha is not None:
                arrays = self._apply_renewal(arrays, row_leaf,
                                             self.train.score[k], mask,
                                             renew_alpha, renew_w)
            lv = arrays.leaf_value * (self.shrinkage_rate * ok)
            self.train.score[k] = add_score(self.train.score[k], row_leaf,
                                            lv, 1.0)
            for vs in self.valids:
                leaf = self._traverse(arrays, vs.dev)
                vs.score[k] = add_score(vs.score[k], leaf, lv, 1.0)
            if abs(init_scores[k]) > 1e-15:
                # AddBias (gbdt.cpp:424-426): only the stored tree
                # carries the boost-from-average bias
                lv = lv + init_scores[k] * ok
            arrays = arrays._replace(leaf_value=lv)
            self.device_trees.append(arrays)
            self._pending.append(arrays)
            self._pending_meta.append((k, init_scores[k],
                                       self.shrinkage_rate))
        self.iter_ += 1
        if self.iter_ % self._check_every == 0:
            self._materialize()
            return self._stopped
        return False

    # ------------------------------------------------------------------
    def eval_set(self, ss: _ScoreSet) -> List[Tuple[str, str, float, bool]]:
        score = self.get_score(ss)
        s = score if self.num_class > 1 else score[0]
        out = []
        for m in ss.metrics:
            for name, val, hb in m.eval(s):
                out.append((ss.name, name, val, hb))
        return out

    def get_score(self, ss: _ScoreSet) -> np.ndarray:
        """A score set's (K, N) raw scores on the host, float64."""
        n = ss.dataset.num_data
        return ss.score[:, :n].cpu().numpy().astype(np.float64)

    def eval_train(self):
        return self.eval_set(self.train)

    def eval_valid(self):
        out = []
        for vs in self.valids:
            out.extend(self.eval_set(vs))
        return out

    def num_trees(self) -> int:
        return len(self.models)

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        """Raw margins over host trees (gbdt_prediction.cpp), numpy walk."""
        X = np.asarray(X, dtype=np.float64)
        K = self.num_class
        n_iters = len(self.models) // K
        end = n_iters if num_iteration <= 0 else min(
            n_iters, start_iteration + num_iteration)
        out = np.zeros((K, X.shape[0]))
        for it in range(start_iteration, end):
            for k in range(K):
                out[k] += self.models[it * K + k].predict(X)
        if self.average_output and end > start_iteration:
            out /= end - start_iteration
        return out

    def predict(self, X, start_iteration=0, num_iteration=-1,
                raw_score=False):
        raw = self.predict_raw(X, start_iteration, num_iteration)
        if not raw_score:
            if self.objective is None:
                self.objective = create_objective(self.config)
            if self.objective is not None:
                raw = self.objective.convert_output(raw)
        if self.num_class == 1:
            return raw[0]
        return raw.T  # (N, K)
