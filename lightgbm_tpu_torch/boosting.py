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

The fused loop (fused_start / fused_dispatch / fused_collect /
fused_truncate, the JAX package's names; engine.train takes it by
default) runs the same iteration body (_iteration) as a CUDA graph of
one whole iteration: K trees, the score updates, the validation
traversals and the device metrics (device_metrics.py), with the sticky
`stopped` and `overflow` carries, replayed with no host read in between
(_FusedProgram). Its loops are bounded and skip their idle steps inside
the graph (learner/device_loop.py), so its trees and scores are the
eager loop's bit for bit. Both growers ride it: the rounds grower's
rounds, and the exact grower's L - 1 split steps (each partition on the
segment-capacity ladder) after its round phase.

The per-node extras (extra_trees, feature_fraction_bynode, the CEGB
penalties, interaction_constraints) and forced splits
(forcedsplits_filename) are set up here as the JAX package sets them up
(boosting.py:458-567): the (groups, used features) matrix, the CEGB
tables, the forced plan read from its JSON file, and the node key
fold_in(key(extra_seed), it * K + k) of each tree; the growers apply
them. They run on both loops, but coupled CEGB, whose used features
carry across trees, stays on the eager loop. DART and RF (the
subclasses at the end, create_boosting) run on the eager loop only, as
in the JAX package: DART drops and rescales past trees every
iteration, RF averages every score set.

Monotone intermediate and advanced resolve as in the JAX package
(_mono_mode) and ride both loops on the rounds grower; intermediate also
rides the exact grower. linear_tree keeps the eager loop: after each
tree the leaves' ridge models are fitted on the host in f64
(_fit_linear), and their per-row outputs, not the leaves' constants, go
into the scores. tpu_debug_check_split (LightGBM's CheckSplit) keeps
the eager loop and recounts every new tree's leaves from the row -> leaf
partition (_check_split).

The distributed learners (tree_learner=data / voting / feature, the JAX
package's boosting.py:377-440, :727-823) run when torch.distributed has
more than one rank (parallel/): one rank trains serially, as the JAX
package does on one device. Under data / voting each rank passes its
own rows; every per-row statistic that decides a tree is taken over
every rank's rows, so N ranks grow the trees one device holding all the
rows grows: boost-from-average and is_unbalance's counts (the
objectives' host statistics), the quantization scale (the max |g|, |h|
over every rank) and its stochastic-rounding draws (each rank's slice
of the global row stream), bagging and GOSS masks (drawn over the
gathered rows, _GlobalRowsSampler), the true-gradient renewal and the
percentile refit (reduced), and the training metrics (gathered). The
collectives run on the eager loop (gloo cannot be captured).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import log, rng
from .config import Config, resolve_device
from .dataset import BinnedDataset
from .learner import cuda_hist
from .learner.device_loop import BOUNDED, EAGER, CudaGraph, DeviceLoop
from .learner.grower import (
    CegbInfo,
    ForcedSplits,
    GrowerSpec,
    TreeArrays,
    add_score,
    grow_tree,
    make_split_params,
)
from .learner.permuted import round_phase_cap
from .learner.rounds import tree_round_cap
from .timer import global_timer as _gt
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


# the timer span of one fused iteration's dispatch (its host cost: a
# graph replay's enqueue, or on the CPU the step itself); the flight
# recorder reads one a round
FUSED_ROUND_PHASE = "round: fused step"


def check_supported(config: Config) -> None:
    """Refuse an unknown boosting type. Every key the JAX package's
    engine.train acts on acts here too (a tree_learner other than data,
    voting and feature trains serially, as in the JAX package)."""
    c = config
    if c.boosting not in ("gbdt", "dart", "rf"):
        log.fatal(f"Unknown boosting type {c.boosting}")


def _load_forced_splits(path: str, ds: BinnedDataset,
                        device) -> Optional[ForcedSplits]:
    """A forcedsplits JSON file -> its BFS plan (the JAX package's
    _load_forced_splits, boosting.py:226; ForceSplits,
    serial_tree_learner.cpp:627): each node {feature, threshold, left?,
    right?}; a threshold maps to a bin through the feature's mapper; the
    left child keeps its parent's leaf id and the right child takes
    i + 1 (Tree::Split numbering). A bad file, or a plan with no usable
    split, warns and returns None."""
    import json
    from collections import deque

    from .binning import BinType

    try:
        with open(path) as f:
            root = json.load(f)
    except (OSError, ValueError) as e:
        log.warning(f"cannot read forcedsplits_filename {path}: {e}")
        return None
    used_pos = {int(f): i for i, f in enumerate(ds.used_features)}
    leaves, feats, bins_ = [], [], []
    q = deque([(root, 0)])
    i = 0
    while q:
        node, leaf = q.popleft()
        if not isinstance(node, dict) or "feature" not in node:
            continue
        f_orig = int(node["feature"])
        if f_orig not in used_pos:
            log.warning(f"forced split on unused/trivial feature {f_orig}; "
                        "skipping this branch")
            continue
        m = ds.mappers[f_orig]
        if m.bin_type == BinType.CATEGORICAL:
            log.warning("forced splits on categorical features are not "
                        f"supported; skipping feature {f_orig}")
            continue
        thr = float(node.get("threshold", 0.0))
        b = int(np.searchsorted(m.upper_bounds, thr, side="left"))
        b = min(b, max(m.num_bin - 2, 0))
        leaves.append(leaf)
        feats.append(used_pos[f_orig])
        bins_.append(b)
        new_leaf = i + 1  # the right child's leaf id
        if isinstance(node.get("left"), dict):
            q.append((node["left"], leaf))
        if isinstance(node.get("right"), dict):
            q.append((node["right"], new_leaf))
        i += 1
    if not leaves:
        return None
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return ForcedSplits(leaf=t(leaves), feature=t(feats), bin=t(bins_),
                        n=len(leaves))


def tree_arrays_to_host(a: TreeArrays) -> TreeArrays:
    return TreeArrays(*[x.detach().cpu().numpy() for x in a])


class _GlobalRowsSampler:
    """A row sampler over every rank's rows (data-parallel bagging and
    GOSS): each sample gathers the ranks' per-row vectors into the row
    stream one device holding every row sees (each rank's real rows in
    rank order, padded as that device pads), draws there with the inner
    sampler, and keeps this rank's slice. Draws key on the global row
    index, so the masks are one device's."""

    def __init__(self, inner, mesh, counts: List[int], npad_global: int):
        self.inner = inner
        self.mesh = mesh
        self.counts = counts
        self.offset = sum(counts[:mesh.rank])
        self.npad_global = npad_global

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        g = self.mesh.all_gather(x)  # (ranks, local padded rows)
        parts = [g[r, :c] for r, c in enumerate(self.counts)]
        tot = sum(self.counts)
        if self.npad_global > tot:
            parts.append(torch.zeros(self.npad_global - tot, dtype=g.dtype,
                                     device=g.device))
        return torch.cat(parts).to(x.dtype)

    def to_local(self, x: torch.Tensor, own_tail: torch.Tensor
                 ) -> torch.Tensor:
        """This rank's real rows of a global vector, then its own padding
        rows' values (own_tail: the rank's input past its real rows)."""
        n = self.counts[self.mesh.rank]
        return torch.cat([x[self.offset:self.offset + n],
                          own_tail[n:].to(x.dtype)])

    def sample(self, it, grad, hess, valid, label):
        G = self.to_global
        mask, g, h = self.inner.sample(it, G(grad), G(hess), G(valid),
                                       None if label is None else G(label))
        # padding rows keep their own values (a padding row's gradient
        # enters the quantization scale): the mask's tail is valid's, 0
        return (self.to_local(mask, valid), self.to_local(g, grad),
                self.to_local(h, hess))


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
        # boost-from-average scores, added to the score sets once
        # (_boost_from_average); None until then
        self._init_scores: Optional[List[float]] = None
        self._fused: Optional[_FusedProgram] = None
        self.fused_overflow_count = 0  # iterations re-run on the eager loop
        # the flight recorder (engine.train's record_file / anomaly_policy):
        # while it is set the eager loop reads each round's gradient norms
        # back (_last_gh_norm); the fused step writes them after its eval
        # values, and fused_collect leaves them in _last_gh_rows
        self.recorder = None
        self._last_gh_norm: Optional[Tuple[float, float]] = None
        self._last_gh_rows: List[Tuple[float, float]] = []
        self.objective: Optional[ObjectiveFunction] = None
        # why this configuration stays on the eager loop, if it must
        self._force_sync_reason: Optional[str] = None
        self.mono_deferred: Optional[torch.Tensor] = None
        # linear_tree: each new tree's leaf fits (constants, features,
        # coefficients) by model index, until _materialize takes them
        self._linear_fits: Dict[int, tuple] = {}
        # the distributed learner (_setup_parallel); serial until then
        self._mesh = self._dp = self._parallel_mode = None
        self._row_offset = self._axis_rows = 0
        self.tree_learner_resolved = "serial"
        self.voting_elected_cols = self.voting_wire_bytes_est = None
        if train_set is None:
            return  # prediction-only booster (model loaded from text)

        from .config import warn_unimplemented
        from .learner.quantize import resolve_hist_dtype

        warn_unimplemented(config)
        check_supported(config)
        self.device = torch.device(resolve_device(config))
        self.objective = create_objective(config)
        self._setup_parallel(config, train_set)
        # growth strategy (boosting.py:604-689 of the JAX package): `auto`
        # is the rounds grower on every device here; `exact` the
        # sequential permuted grower, with its round phase on request;
        # tree_learner=feature rides the exact grower
        use_rounds = config.tpu_growth_mode != "exact"
        if self._parallel_mode == "feature" and use_rounds:
            if config.tpu_growth_mode == "rounds":
                log.warning("tpu_growth_mode=rounds is incompatible with "
                            "tree_learner=feature; falling back to exact "
                            "sequential growth")
            use_rounds = False
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
        data_par = self._parallel_mode == "data"
        if self.objective is not None:
            if data_par:
                self.objective.stats_mesh = self._mesh
            self.objective.init(train_set, self.device)
        group = train_set.metadata.group
        if data_par and group is not None:
            group = self._mesh.gather_rows(np.asarray(group))
        self.strategy = create_sample_strategy(config, group, self.device)
        if data_par and type(self.strategy).__name__ != "SampleStrategy":
            self.strategy = _GlobalRowsSampler(
                self.strategy, self._mesh, self._row_counts,
                self._axis_rows)
        # the raw labels: pos / neg bagging's classes, the percentile
        # refit's residuals
        label = train_set.metadata.label
        self._label_dev = (None if label is None else torch.from_numpy(
            train_set.padded(label)).to(self.device))
        self.dev = train_set.device_arrays(self.device)
        from .binning import BinType

        cats = [m for m in train_set.used_mappers()
                if m.bin_type == BinType.CATEGORICAL]
        n_groups, n_forced = self._setup_node_extras(config, train_set)
        if config.tpu_debug_check_split:
            # the check reads every tree's partition back
            self._force_sync_reason = ("tpu_debug_check_split reads back "
                                       "per iteration")
        # linear_tree: each tree's leaf ridge fits run on the host in f64
        # (boosting.py:531-539 of the JAX package; LightGBM solves them
        # on the CPU too, linear_tree_learner.cpp:344)
        if config.linear_tree:
            if self._mesh is not None:
                log.fatal("linear_tree fits each leaf on one rank's rows; "
                          "it does not compose with a distributed tree "
                          "learner")
            self._force_sync_reason = "linear_tree leaf fits run on host"
            if train_set.raw_data is None:
                log.fatal("linear_tree requires raw feature values; "
                          "construct the Dataset with linear_tree in its "
                          "params")
        use_extra = config.extra_trees
        use_bynode = config.feature_fraction_bynode < 1.0
        extras = bool(use_extra or use_bynode or self._cegb_info is not None
                      or n_groups)
        mono_mode = self._mono_mode(config, has_mono, extras, n_forced,
                                    use_rounds)
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
            mono_mode=mono_mode,
            quant=use_rounds and ((qgrad and levels <= 256)
                                  or self._int_packed),
            quant_int8=use_rounds and levels <= 127 and (
                qgrad or self._int_packed),
            # the permuted grower's round phase excludes the extras,
            # forced splits and monotone intermediate (permuted.py:212-220)
            rounds=(config.tpu_growth_rounds and not use_rounds
                    and not n_forced and not extras and not mono_mode),
            # sorted-subset search when a categorical is wider than
            # max_cat_to_onehot (boosting.py:448-452 of the JAX package)
            cat_subset=any(m.num_bin > config.max_cat_to_onehot
                           for m in cats),
            has_cat=bool(cats),
            extra_trees=use_extra,
            ff_bynode=use_bynode,
            cegb=self._cegb_info is not None,
            n_groups=n_groups,
            n_forced=n_forced,
        )
        self._setup_parallel_grower(config, use_rounds, n_forced)
        self.params = make_split_params(config)
        # splits the intermediate / advanced conflict guard put off to a
        # later round, summed over every tree grown (device counter)
        self.mono_deferred = (torch.zeros((), dtype=torch.int64,
                                          device=self.device)
                              if mono_mode and use_rounds else None)
        self.train = self._score_set(train_set, "training", self.dev)
        # passes of a traversal in a bounded loop: at least the depth of
        # any tree the rounds grower can return there (a round deepens a
        # tree by one level at most)
        L = config.num_leaves
        self._max_levels = min(
            L - 1, tree_round_cap(self.spec),
            config.max_depth if config.max_depth > 0 and not n_forced
            else L - 1)

    def _setup_parallel(self, config: Config, train_set: BinnedDataset
                        ) -> None:
        """Tree learner selection (the JAX package's boosting.py:377-440,
        reference tree_learner.cpp:17-59): data / voting shard rows over
        a mesh of the torch.distributed ranks, feature its features. One
        rank (no process group, or a group of one) trains serially.
        Under data each rank pads its rows to the cluster-wide maximum,
        and learns where its rows sit in the global row stream."""
        tl = config.tree_learner
        if tl not in ("data", "voting", "feature"):
            return
        from .parallel.comm import make_mesh

        mesh = make_mesh("feature" if tl == "feature" else "data",
                         self.device)
        if mesh is None:
            return
        if mesh.backend == "nccl" and self.device.type != "cuda":
            log.fatal("an NCCL process group reduces CUDA tensors: train "
                      "on the card, or join the group with gloo")
        if tl == "feature":
            if train_set.bundle_layout is not None:
                log.warning("tree_learner=feature requires EFB off (feature "
                            "== column); falling back to serial growth. "
                            "Set enable_bundle=false.")
                return
            self._mesh, self._parallel_mode = mesh, "feature"
            log.info(f"tree_learner=feature: "
                     f"{len(train_set.used_features)} features sharded over "
                     f"{mesh.size} ranks ({mesh.backend}; "
                     "feature_parallel_tree_learner.cpp semantics)")
            return
        if tl == "voting":
            log.info(f"tree_learner=voting: top-{config.top_k} local-gain "
                     "vote elects columns per round (per split on the exact "
                     "grower); only elected columns are reduced "
                     "(voting_parallel_tree_learner.cpp semantics)")
        self._mesh, self._parallel_mode = mesh, "data"
        hd = mesh._host_dev()
        sizes = mesh.all_gather(torch.tensor(
            [train_set.num_data, train_set.num_rows_padded()],
            dtype=torch.int64, device=hd)).cpu().numpy()
        # pre-partitioned ranks hold uneven blocks: pad every rank to the
        # largest (row_block multiples, so their max is one too)
        train_set.ensure_min_padded_rows(int(sizes[:, 1].max()))
        self._row_counts = [int(c) for c in sizes[:, 0]]
        self._row_offset = sum(self._row_counts[:mesh.rank])
        b = train_set.row_block
        self._axis_rows = -(-sum(self._row_counts) // b) * b

    def _setup_parallel_grower(self, config: Config, use_rounds: bool,
                               n_forced: int) -> None:
        """The distributed grower around self.spec, the eager loop for
        its collectives, and the provenance the flight recorder and the
        run manifest read (tree_learner_resolved, voting_elected_cols,
        voting_wire_bytes_est; the JAX package's boosting.py:727-823)."""
        from .parallel.data_parallel import DataParallelGrower
        from .parallel.feature_parallel import FeatureParallelGrower

        if self._parallel_mode == "feature" and (self.spec.per_node
                                                 or self.spec.n_forced):
            log.warning("tree_learner=feature takes no per-node extras or "
                        "forced splits; falling back to serial growth")
            self._mesh = self._parallel_mode = None
        use_voting = (config.tree_learner == "voting"
                      and self._parallel_mode == "data")
        if use_voting and n_forced and not use_rounds:
            log.warning(
                "tree_learner=voting with forcedsplits_filename composes "
                "on the rounds grower (tpu_growth_mode=rounds pins the "
                "forced columns into every election); the sequential "
                "exact path runs with the election disabled")
            use_voting = False
        if self._parallel_mode == "data":
            self._dp = DataParallelGrower(
                self._mesh, self.spec._replace(
                    voting_k=config.top_k if use_voting else 0),
                self._axis_rows)
            self.spec = self._dp.spec
        elif self._parallel_mode == "feature":
            self._dp = FeatureParallelGrower(self._mesh, self.spec)
            self.spec = self._dp.spec
        if self._mesh is not None:
            self._force_sync_reason = (
                "distributed runs synchronize per iteration (their "
                "collectives run on the eager loop)")
        g_dev = int(self.dev["bins"].shape[0])
        self.tree_learner_resolved = (
            "voting" if use_voting else self._parallel_mode or "serial")
        self.voting_elected_cols = (
            min(2 * config.top_k + n_forced, g_dev) if use_voting else None)
        self.voting_wire_bytes_est = (
            self._dp.wire_bytes_per_tree(g_dev) if use_voting else None)

    def _record_collective_wire(self, n_trees: int) -> None:
        """Runtime collective wire accounting: the estimated histogram
        payload of n_trees trees the data-parallel grower grew (host
        side, once a dispatched iteration)."""
        if self._parallel_mode != "data":
            return
        from .obs.metrics import record_collective_wire

        record_collective_wire(
            "data_parallel_grow",
            self._dp.wire_bytes_per_tree(int(self.dev["bins"].shape[0]))
            * n_trees)

    def _axis_absmax(self, g: torch.Tensor, h: torch.Tensor
                     ) -> torch.Tensor:
        """(2,) max |g|, |h| over every rank's rows, as one device holding
        them all takes it: its padding rows count only when it pads (its
        padding rows' gradients are every rank's padding rows')."""
        n = self.train_set.num_data
        z = torch.zeros((), dtype=torch.float32, device=g.device)

        def amax(x):
            return x.abs().max() if x.numel() else z

        m = self._mesh.all_reduce(torch.stack(
            [amax(g[:n]), amax(h[:n]), amax(g[n:]), amax(h[n:])]), "max")
        if self._axis_rows > sum(self._row_counts):
            return torch.maximum(m[:2], m[2:])
        return m[:2]

    @staticmethod
    def _mono_mode(config: Config, has_mono: bool, extras: bool,
                   n_forced: int, use_rounds: bool) -> int:
        """monotone_constraints_method as the JAX package resolves it
        (boosting.py:568-632): 1 intermediate, 2 advanced, else 0 basic;
        beside the per-node extras, a forced plan, voting or
        tree_learner=feature both fall back to basic, and off the rounds
        grower advanced becomes intermediate, each with its warning."""
        mode = 0
        if has_mono:
            mode = {"intermediate": 1, "advanced": 2}.get(
                config.monotone_constraints_method, 0)
        if mode and (extras or n_forced
                     or config.tree_learner in ("voting", "feature")):
            log.warning(
                "monotone_constraints_method=intermediate/advanced is "
                "incompatible with per-node extras / forced splits / "
                "voting / tree_learner=feature; falling back to "
                "method=basic")
            mode = 0
        if mode == 2 and not use_rounds:
            log.warning(
                "monotone_constraints_method=advanced rides the rounds "
                "grower only (tpu_growth_mode=rounds); using "
                "method=intermediate on the sequential path")
            mode = 1
        return mode

    def _setup_node_extras(self, config: Config, train_set: BinnedDataset):
        """The per-node extras' and forced splits' tables (the JAX
        package's GBDT.__init__, boosting.py:458-567): the (groups, used
        features) interaction matrix, the CEGB penalties over the used
        features (a list of the wrong length is fatal), the forced plan,
        and the node key of extra_trees / feature_fraction_bynode.
        Returns (groups, forced splits)."""
        from .config import parse_interaction_constraints

        used = [int(f) for f in train_set.used_features]
        groups = parse_interaction_constraints(
            config.interaction_constraints, len(train_set.mappers))
        self._group_mat = None
        if groups:
            pos = {f: i for i, f in enumerate(used)}
            gm = np.zeros((len(groups), len(used)), bool)
            for gi, gr in enumerate(groups):
                for f in gr:
                    if f in pos:
                        gm[gi, pos[f]] = True
            self._group_mat = torch.from_numpy(gm).to(self.device)
        self._cegb_info = None
        if (config.cegb_penalty_split > 0.0
                or len(config.cegb_penalty_feature_coupled) > 0
                or len(config.cegb_penalty_feature_lazy) > 0):
            def pen(t):
                if not t:
                    return torch.zeros(len(used), dtype=torch.float32,
                                       device=self.device)
                if len(t) != len(train_set.mappers):
                    log.fatal("cegb_penalty_feature_* must have one entry "
                              "per feature")
                return torch.tensor([t[f] for f in used],
                                    dtype=torch.float32, device=self.device)

            self._cegb_info = CegbInfo(
                coupled=pen(config.cegb_penalty_feature_coupled),
                lazy=pen(config.cegb_penalty_feature_lazy),
                used=torch.zeros(len(used), dtype=torch.bool,
                                 device=self.device))
            if len(config.cegb_penalty_feature_coupled) > 0:
                # charged once per feature model-wide
                # (is_feature_used_in_split_): each tree marks its
                # features, between trees
                self._force_sync_reason = (
                    "coupled CEGB penalties track model-wide feature use")
        self._forced = None
        if config.forcedsplits_filename:
            self._forced = _load_forced_splits(config.forcedsplits_filename,
                                               train_set, self.device)
        self._node_key = (rng.key(config.extra_seed, self.device)
                          if (config.extra_trees
                              or config.feature_fraction_bynode < 1.0)
                          else None)
        return (len(groups),
                0 if self._forced is None else self._forced.n)

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
        label, weight, group = meta.label, meta.weight, meta.group
        if ds is self.train_set and self._parallel_mode == "data":
            # the training metrics read every rank's rows (eval_set)
            label, weight, group = (
                None if a is None else self._mesh.gather_rows(np.asarray(a))
                for a in (label, weight, group))
        for m in ss.metrics:
            m.init(label, weight, group)
        return ss

    def add_valid(self, valid_set: BinnedDataset, name: str) -> None:
        if self.config.linear_tree and valid_set.raw_data is None:
            log.fatal(f"linear_tree requires raw feature values of the "
                      f"validation set {name}; construct it with "
                      "reference= to the training set")
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
    def _quantize(self, gk, hk, it, k: int):
        """Integer levels + scales for one tree (boosting._quantize): the
        public num_grad_quant_bins under use_quantized_grad, else the
        internal int-packed policy's levels."""
        from .learner.quantize import discretize_gradients_int

        c = self.config
        key = rng.fold_in(rng.key(c.data_random_seed, gk.device),
                          it * self.num_class + k)
        data_par = self._parallel_mode == "data"
        return discretize_gradients_int(
            gk, hk, key, self._hist_levels or c.num_grad_quant_bins,
            c.stochastic_rounding,
            absmax=self._axis_absmax(gk, hk) if data_par else None,
            offset=self._row_offset)

    def _renew_true(self, arrays, row_leaf, gk, hk, mask):
        """Leaf outputs from the TRUE per-leaf gradient sums."""
        from .learner.quantize import renew_leaf_with_true_gradients

        return arrays._replace(
            leaf_value=renew_leaf_with_true_gradients(
                arrays.leaf_value, row_leaf, gk, hk, mask, self.params,
                self.spec.num_leaves, **self._axis_kw())
        )

    def _axis_kw(self) -> dict:
        """A data-parallel run's reductions over every rank's rows (the
        mesh and one device's padded rows), else nothing."""
        if self._parallel_mode != "data":
            return {}
        return {"axis": self._mesh, "n_rows": self._axis_rows}

    def _grow_maybe_quantized(self, gk, hk, mask, feat_mask, valid, it, k,
                              loop=None):
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
                                              valid, it, k, scale, loop)
                if self._true_renew_ok:
                    arrays = self._renew_true(arrays, row_leaf, gk, hk, mask)
                return arrays, row_leaf
            return self._grow(gk, hk, mask, feat_mask, valid, it, k, None,
                              loop)
        gq, hq, scale = self._quantize(gk, hk, it, k)
        if self.spec.quant:
            arrays, row_leaf = self._grow(gq, hq, mask, feat_mask, valid,
                                          it, k, scale, loop)
        else:
            arrays, row_leaf = self._grow(gq * scale[0], hq * scale[1], mask,
                                          feat_mask, valid, it, k, None,
                                          loop)
        if c.quant_train_renew_leaf and self._quant_renew_ok:
            arrays = self._renew_true(arrays, row_leaf, gk, hk, mask)
        return arrays, row_leaf

    def _grow(self, gk, hk, mask, feat_mask, valid, it, k, gh_scale=None,
              loop=None):
        """Grow one tree on f32 gradients, or on integer levels with
        their scales (boosting._grow), with the per-node extras' node key
        fold_in(key(extra_seed), it * K + k) (`it` a host int or the
        fused loop's device counter)."""
        d = self.dev
        rng_key = None
        if self._node_key is not None:
            rng_key = rng.fold_in(self._node_key, it * self.num_class + k)
        return grow_tree(
            d["bins"], d["nan_bin"], d["num_bins"], d["mono"], d["is_cat"],
            gk, hk, mask, feat_mask, self.params, self.spec, valid=valid,
            bundle=d["bundle"], gh_scale=gh_scale, loop=loop,
            rng_key=rng_key, group_mat=self._group_mat,
            cegb=self._cegb_info, forced=self._forced,
            deferred=self.mono_deferred,
        )

    def _mark_used(self, arrays: TreeArrays) -> None:
        """Coupled CEGB: the tree's split features count as used for the
        trees after it (the JAX package's sync loop, boosting.py:1312)."""
        info = self._cegb_info
        if info is None or not len(self.config.cegb_penalty_feature_coupled):
            return
        F = info.used.shape[0]
        live = (torch.arange(arrays.node_feature.shape[0],
                             device=info.used.device) < arrays.num_nodes)
        hit = (arrays.node_feature.long()[:, None]
               == torch.arange(F, device=info.used.device)[None, :])
        info.used.logical_or_((hit & live[:, None]).any(dim=0))

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
                self.spec.num_leaves, **self._axis_kw())
        )

    def _on_device(self, arrays: TreeArrays) -> TreeArrays:
        """A tree's arrays on the training device (the fused loop keeps
        its trees' arrays on the host)."""
        if arrays.num_nodes.device == self.device:
            return arrays
        return TreeArrays(*[x.to(self.device) for x in arrays])

    def _traverse(self, arrays: TreeArrays, dev, loop=None) -> torch.Tensor:
        arrays = self._on_device(arrays)
        return traverse_tree_bins(arrays, dev["bins"], dev["nan_bin"],
                                  dev["bundle"], has_cat=self.spec.has_cat,
                                  loop=loop, max_levels=self._max_levels)

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
                    arrays = self._on_device(self.device_trees[base + j])
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
            for j, (a, (k, bias, shrink)) in enumerate(
                    zip(group, meta[i0: i0 + K])):
                if int(a.num_nodes) > 0:
                    # stored leaf values already carry shrinkage + bias
                    tree = Tree.from_arrays(a, self.train_set, 1.0)
                    tree.shrinkage = shrink
                    fit = self._linear_fits.pop(base + i0 + j, None)
                    if fit is not None:
                        tree.is_linear = True
                        (tree.leaf_value, tree.leaf_const,
                         tree.leaf_features, tree.leaf_coeff) = fit
                else:
                    tree = Tree(num_leaves=1, shrinkage=1.0)
                    tree.leaf_value = np.array([bias], np.float64)
                self._models.append(tree)

    def _sample_features(self, it, k: int) -> torch.Tensor:
        """Per-tree feature_fraction mask (ColSampler, col_sampler.hpp:20):
        the first ceil(frac * F) of jax.random.permutation(fold_in(
        key(feature_fraction_seed), it * K + k), F), as the JAX package
        draws it, on the training device (`it` a host int or the fused
        loop's device counter)."""
        F = self.train_set.num_used_features
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return torch.ones(F, dtype=torch.bool, device=self.device)
        n = max(1, int(np.ceil(frac * F)))
        key = rng.fold_in(rng.key(self.config.feature_fraction_seed,
                                  self.device), it * self.num_class + k)
        return rng.permutation(key, F) < n

    def _boost_from_average(self) -> List[float]:
        """BoostFromAverage (gbdt.cpp:327): before the first iteration,
        each class's initial score is added to every score set, once;
        later calls return the same numbers without adding them again
        (an iteration the fused loop re-runs on the eager loop)."""
        if self._init_scores is not None:
            return self._init_scores
        K = self.num_class
        init_scores = [0.0] * K
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
        self._init_scores = init_scores
        return init_scores

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
        if not self._models and not self._pending:
            init_scores = self._boost_from_average()
        g, h = self._gradients(self.iter_)
        return g, h, init_scores

    def _gradients(self, it):
        """The objective's (K, Npad) f32 gradients at the current score;
        an objective that needs_iter (rank_xendcg's draws) gets the
        iteration `it`, a host int or the fused loop's device counter
        (boosting._obj_grads of the JAX package)."""
        K = self.num_class
        score = self.train.score if K > 1 else self.train.score[0]
        if self.objective.needs_iter:
            g, h = self.objective.get_gradients(score, it)
        else:
            g, h = self.objective.get_gradients(score)
        return (g.reshape(K, -1).to(torch.float32),
                h.reshape(K, -1).to(torch.float32))

    def _iteration(self, it, grad, hess, init_scores, loop,
                   first=None, active=None):
        """The body of one boosting iteration, shared by the eager loop
        (it a host int, the EAGER DeviceLoop) and the fused program (it
        the device counter, a bounded or captured loop): per class the
        row sample, the feature mask, the tree, the percentile refit;
        then, once every tree is grown, the score updates (class k's
        renewal reads only class k's score, so deferring them changes no
        bit). first / active: the fused program's device bools, whether
        this is iteration 0 (the stored trees carry the boost-from-average
        bias) and whether the iteration runs at all; with them, a tree
        still growing at a bounded loop's cap fails the iteration, and a
        failed or inactive iteration leaves the scores alone. Returns
        (the stored tree arrays, done: whether they count, a device bool;
        None on the eager loop)."""
        K = self.num_class
        valid = self.dev["valid"]
        renew_alpha, renew_w = self._renewal_setup()
        grown = []
        for k in range(K):
            mask, gk, hk = self.strategy.sample(it, grad[k], hess[k],
                                                valid, self._label_dev)
            feat_mask = self._sample_features(it, k)
            arrays, row_leaf = self._grow_maybe_quantized(
                gk, hk, mask, feat_mask, valid, it, k, loop)
            if self.config.tpu_debug_check_split and active is None:
                self._check_split(arrays, row_leaf, hk, mask)
            self._mark_used(arrays)
            if renew_alpha is not None:
                arrays = self._apply_renewal(arrays, row_leaf,
                                             self.train.score[k], mask,
                                             renew_alpha, renew_w)
            grown.append((arrays, row_leaf, (gk, hk, mask)))
        done = act = None
        if active is not None:
            # the trees count unless one outgrew a bounded loop's cap
            done = active & ~torch.stack(
                [ovf for _r, ovf in loop.trees[-K:]]).any()
            act = done.to(torch.float32)
        trees = []
        for k, (arrays, row_leaf, sample) in enumerate(grown):
            ok = (arrays.num_nodes > 0).to(torch.float32)
            if act is not None:
                ok = ok * act
            lv = arrays.leaf_value * (self.shrinkage_rate * ok)
            if (self.config.linear_tree and done is None
                    and int(arrays.num_nodes) > 0):
                # the leaves' linear models score the rows (eager only)
                self._fit_linear(k, arrays, row_leaf, *sample, init_scores[k])
            else:
                for ss, leaf in [(self.train, row_leaf)] + [
                        (vs, self._traverse(arrays, vs.dev, loop))
                        for vs in self.valids]:
                    new_score = add_score(ss.score[k], leaf, lv, 1.0)
                    ss.score[k] = (new_score if done is None else
                                   torch.where(done, new_score, ss.score[k]))
            if abs(init_scores[k]) > 1e-15:
                # AddBias (gbdt.cpp:424-426): only the stored tree
                # carries the boost-from-average bias
                biased = lv + init_scores[k] * ok
                lv = biased if first is None else torch.where(
                    first, biased, lv)
            trees.append(arrays._replace(leaf_value=lv))
        return trees, done

    def _check_split(self, arrays: TreeArrays, row_leaf, hk, mask) -> None:
        """tpu_debug_check_split (the JAX package's _check_split;
        LightGBM's CheckSplit, serial_tree_learner.h:174): the per-leaf
        counts and hessian sums recounted from the partition (row ->
        leaf) must match the tree's histogram-derived ones, else
        log.fatal at the iteration where they parted. Eager loop only;
        one copy of the partition off the card a tree."""
        n_nodes = int(arrays.num_nodes)
        if n_nodes <= 0:
            return
        L = self.spec.num_leaves
        rl = row_leaf.cpu().numpy()
        m = mask.cpu().numpy()
        if self._parallel_mode == "data":
            # the tree's counts are global: recount every rank's rows
            n = self.train_set.num_data
            rl = self._mesh.gather_rows(rl[:n])
            m = self._mesh.gather_rows(m[:n])
            hk = torch.from_numpy(self._mesh.gather_rows(
                hk.cpu().numpy()[:n]))
        ok = (rl >= 0) & (m > 0)
        cnt = np.bincount(rl[ok], minlength=L).astype(np.float64)
        hsum = None
        if not self.config.use_quantized_grad:
            # quantized growth sums discretized hessians: only the
            # counts compare with the raw ones
            hw = (hk.cpu().numpy() * m).astype(np.float64)
            hsum = np.bincount(rl[ok], weights=hw[ok], minlength=L)
        t_cnt = arrays.leaf_count.cpu().numpy().astype(np.float64)
        t_h = arrays.leaf_weight.cpu().numpy().astype(np.float64)
        nl = n_nodes + 1
        if not np.allclose(cnt[:nl], t_cnt[:nl], atol=0.5):
            bad = int(np.argmax(np.abs(cnt[:nl] - t_cnt[:nl])))
            log.fatal(
                f"CheckSplit: leaf {bad} partition count {cnt[bad]} != "
                f"histogram-derived count {t_cnt[bad]} "
                f"(iteration {self.iter_})"
            )
        if hsum is not None and not np.allclose(
            hsum[:nl], t_h[:nl], rtol=1e-3, atol=1e-3
        ):
            bad = int(np.argmax(np.abs(hsum[:nl] - t_h[:nl])))
            log.fatal(
                f"CheckSplit: leaf {bad} partition hessian sum "
                f"{hsum[bad]} != histogram-derived {t_h[bad]} "
                f"(iteration {self.iter_})"
            )

    def _fit_linear(self, k: int, arrays: TreeArrays, row_leaf, gk, hk, mask,
                    bias: float) -> None:
        """linear_tree (the JAX package's sync loop, boosting.py
        :1330-1381): a ridge model per leaf of the new tree from its
        row -> leaf map, the sampled true gradients and the bag mask
        (Tree.fit_linear_leaves, f64 on the host; one copy off the card),
        whose per-row outputs go into the train score and, through each
        validation row's leaf (the binned traversal), its raw values into
        every validation score. The host tree's leaf values are the
        grower's times the shrinkage in f64, as the JAX package's sync
        loop makes them; the fit keeps until _materialize puts it on the
        host tree, with the boost-from-average bias on the values and the
        constants."""
        from .binning import BinType

        ds = self.train_set
        n = ds.num_data
        host = torch.stack([row_leaf[:n].view(torch.float32), gk[:n],
                            hk[:n], mask[:n]]).cpu()
        rl = host[0].view(torch.int32).numpy()
        g, h, m = (host[j].numpy() for j in (1, 2, 3))
        tree = Tree.from_arrays(tree_arrays_to_host(arrays), ds,
                                self.shrinkage_rate)
        cat_set = {int(f) for f in ds.used_features
                   if ds.mappers[int(f)].bin_type == BinType.CATEGORICAL}
        tree.fit_linear_leaves(rl, g, h, ds.raw_data, cat_set,
                               self.config.linear_lambda,
                               self.shrinkage_rate, row_mask=m > 0)
        for ss, leaf in [(self.train, rl)] + [
                (vs, self._traverse(arrays, vs.dev)[:vs.dataset.num_data]
                 .cpu().numpy()) for vs in self.valids]:
            out = np.zeros(ss.dataset.num_rows_padded(), np.float32)
            out[:ss.dataset.num_data] = tree.linear_leaf_outputs(
                ss.dataset.raw_data, leaf)
            ss.score[k] += torch.from_numpy(out).to(self.device)
        self._linear_fits[len(self.device_trees) + k] = (
            tree.leaf_value + bias, tree.leaf_const + bias,
            tree.leaf_features, tree.leaf_coeff)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; True when training should stop (no
        splittable leaf), as GBDT::TrainOneIter (gbdt.cpp:352). grad /
        hess: a custom objective's gradients (_prepare_gradients)."""
        if self._stopped:
            return True
        grad, hess, init_scores = self._prepare_gradients(grad, hess)
        if self.recorder is not None:
            self._last_gh_norm = _host_floats(
                gh_norms(grad, hess, self.train_set.num_data))
        trees, _ = self._iteration(self.iter_, grad, hess, init_scores,
                                   DeviceLoop(EAGER))
        self._record_collective_wire(len(trees))
        for k, arrays in enumerate(trees):
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
    # The fused loop (the JAX package's fused_start / fused_dispatch /
    # fused_collect / fused_truncate, boosting.py:1431-1936). The JAX
    # package dispatches n iterations as lax.scan chunks from a fixed
    # ladder of lengths (DEFAULT_CHUNK_LADDER, _pick_chunk) to bound its
    # XLA compiles; a CUDA graph of one iteration is captured once and
    # replayed n times, so nothing here needs a ladder.
    def fused_eligible(self) -> bool:
        return self.fused_ineligible_reason() is None

    def fused_ineligible_reason(self) -> Optional[str]:
        """None when the fused loop applies, else why not (engine.train
        logs it)."""
        from .device_metrics import supported_names

        if self._force_sync_reason is not None:
            return self._force_sync_reason
        if self.objective is None:
            return "no built-in objective (custom fobj)"
        if self.objective.has_host_state:
            return (f"objective {self.objective.name} keeps cross-iteration "
                    "host state (e.g. position debiasing)")
        for ss in [self.train] + self.valids:
            if supported_names(ss.metrics) is None:
                return (f"metric(s) {[m.name for m in ss.metrics]} have no "
                        "device implementation")
        return None

    def fused_start(self, track_train: bool) -> None:
        """Boost-from-average, then the fused program over the score
        sets' buffers (captured at the first dispatch on the card)."""
        if not self._models and not self._pending:
            self._boost_from_average()
        elif self._init_scores is None:
            self._init_scores = [0.0] * self.num_class
        self._fused = _FusedProgram(self, track_train)

    def fused_dispatch(self, n: int) -> None:
        """n fused iterations, enqueued with no host read in between."""
        if n > 0 and not self._stopped:
            with _gt.scope("fused dispatch"):
                self._fused.dispatch(n)

    def fused_collect(self) -> List[List[Tuple[str, str, float, bool]]]:
        """The chunk boundary: one readback of the dispatched iterations'
        trees and eval rows, the host trees (_materialize, which also
        finds the no-splittable-leaf stop), and per kept iteration its
        evaluation tuples. An iteration whose tree outgrew the round cap
        is grown again on the eager loop and counted
        (fused_overflow_count); the dispatch's later iterations did
        nothing, and the caller dispatches them again."""
        f = self._fused
        with _gt.scope("fused collect (readback)"):
            done, overflow, rows = f.collect()
        n_before = len(self._models) // self.num_class
        K = self.num_class
        for r in range(done):
            it = f.it0 + r
            for k, arrays in enumerate(rows[r][0]):
                self.device_trees.append(arrays)
                self._pending.append(arrays)
                self._pending_meta.append(
                    (k, self._init_scores[k] if it == 0 else 0.0,
                     self.shrinkage_rate))
        evals = [row[1] for row in rows[:done]]
        self.iter_ = f.it0 + done
        gh_rows = []
        if f.want_gh:  # the step's last two values are the gh norms
            gh_rows = [tuple(e[-2:]) for e in evals]
            evals = [e[:-2] for e in evals]
        if overflow:
            self.fused_overflow_count += 1
            log.warning(f"iteration {self.iter_}: a tree outgrew the fused "
                        f"loop's {f.round_cap} rounds; grown again on the "
                        "eager loop")
            grad, hess = self._gradients(self.iter_)
            init = (self._init_scores if self.iter_ == 0
                    else [0.0] * K)
            trees, _ = self._iteration(self.iter_, grad, hess, init,
                                       DeviceLoop(EAGER))
            for k, arrays in enumerate(trees):
                self.device_trees.append(arrays)
                self._pending.append(arrays)
                self._pending_meta.append((k, init[k],
                                           self.shrinkage_rate))
            self.iter_ += 1
            evals.append(f.eval_now())
            if f.want_gh:
                gh_rows.append(_host_floats(
                    gh_norms(grad, hess, self.train_set.num_data)))
            f.resume(self.iter_)
        self._materialize()
        produced = len(self._models) // K - n_before
        self._last_gh_rows = gh_rows[:produced]
        return [f.records(e) for e in evals[:produced]]

    def fused_truncate(self, n_iters: int) -> None:
        """Drop the models beyond n_iters iterations (early stopping fired
        inside a chunk) and roll their contributions out of the scores,
        as the JAX package does."""
        K = self.num_class
        self._materialize()
        for mi in range(n_iters * K, len(self.device_trees)):
            arrays = self._on_device(self.device_trees[mi])
            k = mi % K
            if self._models[mi].num_leaves > 1:
                for ss in [self.train] + self.valids:
                    leaf = self._traverse(arrays, ss.dev)
                    ss.score[k] -= arrays.leaf_value[leaf.long()]
        del self._models[n_iters * K:]
        del self.device_trees[n_iters * K:]
        self.iter_ = min(self.iter_, n_iters)
        if self._fused is not None:
            self._fused.resume(self.iter_)

    # ------------------------------------------------------------------
    def eval_set(self, ss: _ScoreSet) -> List[Tuple[str, str, float, bool]]:
        score = self.get_score(ss)
        if ss is self.train and self._parallel_mode == "data":
            # every rank's rows: the same metric, and the same early
            # stopping decision, on every rank
            score = self._mesh.gather_rows(score.T).T
        s = score if self.num_class > 1 else score[0]
        out = []
        for m in ss.metrics:
            for name, val, hb in m.eval(s):
                out.append((ss.name, name, val, hb))
        return out

    def padding_scores(self) -> Optional[List[float]]:
        """The training score of the padding rows, one value a class
        (no tree adds to a padding row: it keeps boost-from-average's
        score, or an init model's traversal); None without padding. It is
        training state a checkpoint carries: the gradient quantization's
        scale is the largest |gradient| over every row, padding included,
        and Booster._continue_from's traversal gives padding rows other
        scores than the run that wrote the checkpoint held."""
        n = self.train_set.num_data
        if self.train.score.shape[1] == n:
            return None
        return [float(v) for v in self.train.score[:, n].cpu()]

    def restore_padding_scores(self, values: List[float]) -> None:
        """Give the padding rows a checkpoint's padding_scores()."""
        n = self.train_set.num_data
        for k, v in enumerate(values):
            self.train.score[k, n:].fill_(float(v))

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

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:462): pop the last iteration's
        K trees (host and device, in step; a fused run's pending trees are
        materialized first) and subtract them from every score set through
        the binned traversal; a stump's constant (the boost-from-score
        bias) is subtracted as it was added."""
        if self.iter_ <= 0:
            return
        models = self.models
        for k in reversed(range(self.num_class)):
            tree = models.pop()
            arrays = self._on_device(self.device_trees.pop())
            for ss in [self.train] + self.valids:
                if tree.num_leaves > 1:
                    leaf = self._traverse(arrays, ss.dev)
                    ss.score[k] -= arrays.leaf_value[leaf.long()]
                elif abs(float(tree.leaf_value[0])) > 1e-15:
                    ss.score[k] -= float(tree.leaf_value[0])
        self.iter_ -= 1
        if not models:
            # the first iteration again: boost-from-average adds its
            # scores anew (the popped trees carried them)
            self._init_scores = None

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Split counts or summed gains per feature over every tree."""
        nf = self.train_set.num_total_features if self.train_set else (
            max((int(np.max(t.split_feature)) for t in self.models
                 if len(t.split_feature)), default=-1) + 1)
        imp = np.zeros(nf)
        for t in self.models:
            if importance_type == "gain":
                imp += t.feature_importance_gain(nf)
            else:
                imp += t.feature_importance_split(nf)
        return imp

    def refit(self, X: np.ndarray, label: np.ndarray, weight=None,
              group=None) -> None:
        """Refit the leaf outputs of the existing trees on new rows
        (gbdt.cpp:266 RefitTree, FitByExistingTree), as the JAX package
        does: each row's leaf in every tree from the host walker; per
        iteration the objective's gradients at the score refitted so far
        (on this booster's device); per leaf the float64 sums of g and h,
        the L1 soft threshold and the max_delta_step clip, times the
        tree's shrinkage, blended with refit_decay_rate into the old
        output. The device trees take the new leaf values."""
        from .dataset import Metadata

        X = np.asarray(X, dtype=np.float64)
        N, K, c = X.shape[0], self.num_class, self.config
        decay, lam = c.refit_decay_rate, c.lambda_l2
        leaf_pred = self.predict_leaf_index(X)  # (N, models)

        class _Rows:
            """The new rows as the objective reads a dataset, unpadded."""
            metadata = Metadata(
                label=np.asarray(label, np.float32),
                weight=(None if weight is None
                        else np.asarray(weight, np.float32)),
                group=None if group is None else np.asarray(group, np.int32))
            num_data = N

            @staticmethod
            def padded(arr, fill: float = 0.0, dtype=np.float32):
                return np.asarray(arr, dtype)

            @staticmethod
            def num_rows_padded():
                return N

        device = torch.device(resolve_device(c))
        obj = create_objective(c)
        if obj is None:
            log.fatal("Cannot refit without an objective function")
        obj.init(_Rows(), device)
        score = np.zeros((K, N), np.float64)
        for it in range(len(self.models) // K):
            s = torch.from_numpy((score if K > 1 else score[0])
                                 .astype(np.float32)).to(device)
            gs, hs = (obj.get_gradients(s, it) if obj.needs_iter
                      else obj.get_gradients(s))
            gs = gs.cpu().numpy().astype(np.float64).reshape(K, N)
            hs = hs.cpu().numpy().astype(np.float64).reshape(K, N)
            for k in range(K):
                t = self.models[it * K + k]
                leaves = leaf_pred[:, it * K + k]
                sum_g = np.bincount(leaves, weights=gs[k],
                                    minlength=t.num_leaves)
                sum_h = np.bincount(leaves, weights=hs[k],
                                    minlength=t.num_leaves)
                tg = np.sign(sum_g) * np.maximum(np.abs(sum_g) - c.lambda_l1,
                                                 0.0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    new_out = np.where(sum_h + lam > 1e-15,
                                       -tg / (sum_h + lam), 0.0)
                if c.max_delta_step > 0.0:
                    new_out = np.clip(new_out, -c.max_delta_step,
                                      c.max_delta_step)
                new_out = new_out * t.shrinkage
                # cover statistics stay as trained (FitByExistingTree)
                t.leaf_value = decay * t.leaf_value + (1.0 - decay) * new_out
                score[k] += t.leaf_value[leaves]
        for mi, arrays in enumerate(self.device_trees[:len(self.models)]):
            lv = np.zeros(tuple(arrays.leaf_value.shape), np.float32)
            n = min(len(lv), len(self.models[mi].leaf_value))
            lv[:n] = self.models[mi].leaf_value[:n]
            self.device_trees[mi] = arrays._replace(
                leaf_value=torch.from_numpy(lv).to(arrays.leaf_value.device))

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1,
                    early_stop: Optional[Tuple[int, float]] = None
                    ) -> np.ndarray:
        """Raw margins over host trees (gbdt_prediction.cpp), numpy walk.
        early_stop = (freq, margin) stops a row's accumulation once, at a
        multiple of freq iterations, its margin (2 |score| with one
        class, top1 - top2 with several) exceeds margin
        (prediction_early_stop.cpp; the JAX package's predict_raw).
        Without early stopping and linear trees, the native library's
        threaded walk gives the same sums (each row's leaves added in
        tree order in float64) whenever it is loaded."""
        X = np.asarray(X, dtype=np.float64)
        K = self.num_class
        n_iters = len(self.models) // K
        end = n_iters if num_iteration <= 0 else min(
            n_iters, start_iteration + num_iteration)
        out = np.zeros((K, X.shape[0]))
        if (early_stop is None
                and not any(t.is_linear for t in self.models)
                and self._predict_native(X, start_iteration, end, out)):
            if self.average_output and end > start_iteration:
                out /= end - start_iteration
            return out
        active = np.ones(X.shape[0], bool)
        Xa = X  # resliced only when rows stop
        for it in range(start_iteration, end):
            for k in range(K):
                out[k][active] += self.models[it * K + k].predict(Xa)
            if early_stop is None:
                continue
            freq, margin_thr = early_stop
            if (it - start_iteration + 1) % max(freq, 1) == 0:
                if K >= 2:
                    part = np.partition(out[:, active], K - 2, axis=0)
                    margin = part[K - 1] - part[K - 2]
                else:
                    margin = 2.0 * np.abs(out[0][active])
                idx = np.flatnonzero(active)
                active[idx[~(margin <= margin_thr)]] = False
                if not active.any():
                    break
                Xa = X[active]
        if self.average_output and end > start_iteration:
            out /= end - start_iteration
        return out

    def _predict_native(self, X: np.ndarray, start: int, end: int,
                        out: np.ndarray) -> bool:
        """Fill out (K, N) with the native walk; False (out untouched)
        when the library is not loaded or X is too narrow. The trees are
        packed at every call: refit, set_leaf_output and rollback change
        them in place."""
        from . import native

        if native.get_lib() is None:
            return False
        pm = native.PackedModel(self.models)
        X = np.ascontiguousarray(X)
        K = self.num_class
        for k in range(K):
            r = native.predict_packed(
                pm, X, (np.arange(start, end) * K + k).astype(np.int32))
            if r is None:  # X too narrow: so at k = 0, out untouched
                return False
            out[k] = r
        return True

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw (K, N) margins -> the objective's prediction space; a
        loaded model builds its objective from the model text's config
        on first use (objective none converts nothing)."""
        if self.objective is None:
            self.objective = create_objective(self.config)
        if self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def predict(self, X, start_iteration=0, num_iteration=-1,
                raw_score=False, early_stop=None):
        raw = self.predict_raw(X, start_iteration, num_iteration,
                               early_stop)
        if not raw_score:
            raw = self.convert_output(raw)
        if self.num_class == 1:
            return raw[0]
        return raw.T  # (N, K)

    def predict_leaf_index(self, X, start_iteration=0, num_iteration=-1):
        """(N, used trees) leaf index of each row in each tree."""
        X = np.asarray(X, dtype=np.float64)
        K = self.num_class
        n_iters = len(self.models) // K
        end = n_iters if num_iteration <= 0 else min(
            n_iters, start_iteration + num_iteration)
        cols = [self.models[it * K + k].predict_leaf(X)
                for it in range(start_iteration, end) for k in range(K)]
        return (np.stack(cols, axis=1) if cols
                else np.zeros((X.shape[0], 0), np.int64))

    def predict_contrib(self, X, start_iteration=0, num_iteration=-1):
        """SHAP feature contributions (tree.h:140 PredictContrib), host
        TreeSHAP (shap.py): (N, K * (F + 1))."""
        from .shap import predict_contrib

        X = np.asarray(X, dtype=np.float64)
        nf = self.train_set.num_total_features if self.train_set else len(
            getattr(self, "feature_names", []) or [])
        if nf == 0:
            nf = max((int(np.max(t.split_feature)) for t in self.models
                      if len(t.split_feature)), default=-1) + 1
            nf = max(nf, X.shape[1])
        return predict_contrib(self.models, X, nf, self.num_class,
                               start_iteration, num_iteration,
                               self.average_output)


def gh_norms(grad: torch.Tensor, hess: torch.Tensor, n: int
             ) -> torch.Tensor:
    """(2,) f32 [sqrt(sum g^2), sqrt(sum h^2)] over a round's (K, n)
    gradients of the real rows (a padded row's score, and so its
    gradient, differs after a resume), the flight recorder's gh norms:
    the same reductions on the same shapes on both loops, so the fused
    step's values are the eager loop's bits."""
    g, h = grad[:, :n], hess[:, :n]
    return torch.stack([torch.sqrt(torch.sum(g * g)),
                        torch.sqrt(torch.sum(h * h))])


def _host_floats(x: torch.Tensor) -> Tuple[float, ...]:
    return tuple(float(v) for v in x.cpu().tolist())


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor as flat int32 words: f32 by its bits, the rest by value."""
    x = x.reshape(-1)
    return x.view(torch.int32) if x.dtype == torch.float32 else \
        x.to(torch.int32)


class _FusedProgram:
    """One boosting iteration as a CUDA graph (boosting._FusedProgram of
    the JAX package): K trees, the score updates, the validation
    traversals and the device metrics, with the sticky `stopped` (an
    iteration grew K stumps) and `overflow` (a tree outgrew the round
    cap) carries; either flag makes every later iteration do nothing.
    The device counter `it` advances on each iteration whose trees count,
    and keys every draw. Each iteration writes its K trees' arrays,
    per-tree rounds and overflow flag, and its eval row, as one flat
    int32 row into ring[it - base], `base` being the chunk's first
    iteration; fused_collect reads a chunk's rows and the carries in one
    copy. The score sets' tensors are the graph's static buffers, updated
    in place by both loops.

    On the card the first dispatched iteration runs uncaptured with
    bounded loops on the graph's stream (it builds and warms up the
    kernels, their scratch and the ring; its results are the graph's),
    then the step is captured and every later iteration is one replay.
    On the CPU every iteration runs the step directly, with the loops of
    `cpu_loop` (EAGER: a host read there costs no sync; the tests set
    BOUNDED to run what the graph runs)."""

    cpu_loop = EAGER

    def __init__(self, gb: "GBDT", track_train: bool):
        from .device_metrics import DeviceEvalSet, supported_names

        self.gb = gb
        dev = gb.device
        self.K = gb.num_class
        self.rows = gb._check_every  # the most iterations of a dispatch
        # the rounds grower's round cap, or the exact grower's round-phase
        # cap (its sequential phase is L - 1 steps and cannot overflow)
        spec = gb.spec
        self.round_cap = (tree_round_cap(spec) if spec.rounds_slots else
                          round_phase_cap(spec.num_leaves) if spec.rounds
                          else 0)
        self.eval_sets = []
        for ss in ([gb.train] if track_train else []) + gb.valids:
            names, hb = supported_names(ss.metrics)
            meta = ss.dataset.metadata
            pad = lambda v: torch.from_numpy(np.ascontiguousarray(
                ss.dataset.padded(v), dtype=np.float32)).to(dev)
            self.eval_sets.append((ss, names, hb, DeviceEvalSet(
                gb.config, names, hb, pad(meta.label),
                None if meta.weight is None else pad(meta.weight),
                ss.dev["valid"], self.K, meta.group)))
        self.it = torch.full((), gb.iter_, dtype=torch.int64, device=dev)
        self.base = self.it.clone()
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)
        self.init = list(gb._init_scores)
        self.fields = [f for f in TreeArrays._fields
                       if gb.spec.has_cat or f not in ("node_cat",
                                                        "node_cat_mask")]
        self.layout: Optional[list] = None  # (field, shape, dtype) per tree
        self.ring: Optional[torch.Tensor] = None
        self.graph = CudaGraph(dev) if dev.type == "cuda" else None
        self.it0 = gb.iter_
        self.n = 0
        self.rounds: List[int] = []  # rounds of each kept tree
        self.captured_launches: Dict[str, int] = {}
        # the flight recorder's gh norms ride the eval row's tail; with
        # neither record_file nor anomaly_policy set the step (and the
        # captured graph) is the one without them
        c = gb.config
        self.want_gh = bool(c.record_file or c.anomaly_policy != "off")

    # ---- the step
    def step(self, loop: DeviceLoop) -> None:
        active = ~(self.stopped | self.overflow)
        loop.cond(active, lambda: self._body(loop, active))

    def _body(self, loop: DeviceLoop, active: torch.Tensor) -> None:
        gb = self.gb
        grad, hess = gb._gradients(self.it)
        first = self.it == 0
        trees, done = gb._iteration(self.it, grad, hess, self.init, loop,
                                    first=first, active=active)
        grew = torch.stack([a.num_nodes > 0 for a in trees]).any()
        evals = [es(ss.score) for ss, _n, _h, es in self.eval_sets]
        if self.want_gh:
            evals.append(gh_norms(grad, hess, gb.train_set.num_data))
        row = self._pack(trees, loop.trees[-self.K:], evals)
        slot = (self.it - self.base).clamp(0, self.rows - 1)
        self.ring.index_put_((slot.reshape(1),), row[None])
        self.stopped.logical_or_(done & ~grew)
        self.overflow.logical_or_(active & ~done)
        self.it.add_(done.to(torch.int64))

    def _pack(self, trees, stats, evals) -> torch.Tensor:
        if self.layout is None:
            self.layout = [(f, tuple(getattr(trees[0], f).shape),
                            getattr(trees[0], f).dtype) for f in self.fields]
        parts = []
        for arrays, (n_rounds, ovf) in zip(trees, stats):
            parts += [_bits(getattr(arrays, f)) for f in self.fields]
            parts += [_bits(n_rounds), _bits(ovf)]
        parts += [_bits(e) for e in evals]
        row = torch.cat(parts)
        if self.ring is None:
            self.ring = torch.zeros((self.rows, row.numel()),
                                    dtype=torch.int32, device=row.device)
        return row

    def _unpack(self, row: np.ndarray):
        """One ring row -> (K TreeArrays on the host, eval values,
        rounds)."""
        gb = self.gb
        L, B = gb.spec.num_leaves, gb.spec.num_bins
        j = 0
        trees, rounds = [], []
        for _k in range(self.K):
            vals = {}
            for f, shape, dtype in self.layout:
                n = int(np.prod(shape, dtype=np.int64))
                w = row[j: j + n]
                j += n
                if dtype == torch.float32:
                    v = w.view(np.float32)
                elif dtype == torch.bool:
                    v = w.astype(bool)
                else:
                    v = w.astype(np.int32)
                vals[f] = torch.from_numpy(v.reshape(shape).copy())
            vals.setdefault("node_cat", torch.zeros(L - 1, dtype=torch.bool))
            vals.setdefault("node_cat_mask",
                            torch.zeros((L - 1, B), dtype=torch.bool))
            trees.append(TreeArrays(**vals))
            rounds.append(int(row[j]))
            j += 2
        evals = row[j:].view(np.float32).astype(np.float64).tolist()
        return trees, evals, rounds

    # ---- the host side
    def dispatch(self, n: int) -> None:
        if n > self.rows:
            raise ValueError(f"{n} iterations exceed the ring's {self.rows}")
        self.it0, self.n = self.gb.iter_, n
        self.base.fill_(self.it0)
        for _ in range(n):
            with _gt.scope(FUSED_ROUND_PHASE):
                self._dispatch_one()

    def _dispatch_one(self) -> None:
        if self.graph is None:
            self.step(DeviceLoop(self.cpu_loop))
        elif self.graph.captured:
            self.graph.replay()
        else:
            g = self.graph
            cur = torch.cuda.current_stream(g.device)
            g.stream.wait_stream(cur)
            with torch.cuda.stream(g.stream):
                self.step(DeviceLoop(BOUNDED))
            cur.wait_stream(g.stream)
            before = dict(cuda_hist.LAUNCHES)
            g.capture(self.step)
            # the kernels the graph holds (a replay launches them
            # without passing through their wrappers)
            self.captured_launches = {
                k: v - before[k] for k, v in cuda_hist.LAUNCHES.items()
                if v > before[k]}

    def collect(self):
        """(iterations done, whether the next one overflowed, per done
        iteration (trees, eval values)) from one copy to the host."""
        status = torch.stack([self.it, self.stopped.to(torch.int64),
                              self.overflow.to(torch.int64)]).to(torch.int32)
        n = self.n if self.ring is not None else 0
        flat = torch.cat([status, self.ring[:n].reshape(-1)]
                         if n else [status]).cpu().numpy()
        it, overflow = int(flat[0]), bool(flat[2])
        done = it - self.it0
        ring = flat[3:].reshape(n, -1) if n else None
        rows = []
        for r in range(done):
            trees, evals, rounds = self._unpack(ring[r])
            rows.append((trees, evals))
            self.rounds += rounds
        return done, overflow, rows

    def eval_now(self) -> List[float]:
        """The eval row of the current scores (after an iteration re-run
        on the eager loop)."""
        vals = [es(ss.score) for ss, _n, _h, es in self.eval_sets]
        if not vals:
            return []
        return torch.cat(vals).cpu().numpy().astype(np.float64).tolist()

    def resume(self, it: int) -> None:
        """Continue from iteration `it` (after a re-run or a truncation)."""
        self.it.fill_(it)
        self.overflow.fill_(False)

    def records(self, evals: List[float]) -> List[Tuple[str, str, float,
                                                        bool]]:
        out, j = [], 0
        for ss, names, hb, _es in self.eval_sets:
            for name, h in zip(names, hb):
                out.append((ss.name, name, float(evals[j]), h))
                j += 1
        return out


class DART(GBDT):
    """DART: dropouts meet multiple additive regression trees
    (dart.hpp:23; the JAX package's DART, boosting.py:2432). Before each
    iteration a random set of past iterations is dropped: their trees
    leave the train score, so the gradients (a custom fobj's too) see the
    reduced ensemble; the new trees are grown with shrinkage lr / (1 + k)
    (lr / (lr + k) under xgboost_dart_mode); then the dropped trees are
    scaled by k / (k + 1) (k / (k + lr)) for good, with every score set
    moved to match. Each drop and rescale is a traversal of the binned
    rows and a take_small score update on the card. Eager loop only."""

    def __init__(self, config: Config, train_set: Optional[BinnedDataset]):
        super().__init__(config, train_set)
        self._force_sync_reason = ("DART dropout mutates past trees every "
                                   "iteration")
        self._tree_weight: List[float] = []  # per-iteration weights
        self._sum_weight = 0.0
        self._pending_drops: Optional[List[int]] = None

    def _tree_score_delta(self, ss: _ScoreSet, arrays: TreeArrays, k: int,
                          scale: float) -> None:
        """score[k] += scale * tree over the score set's binned rows."""
        leaf = self._traverse(arrays, ss.dev)
        ss.score[k] = add_score(ss.score[k], leaf,
                                self._on_device(arrays).leaf_value, scale)

    def _select_drops(self) -> List[int]:
        """The iterations this one drops: a pure function of (drop_seed,
        iteration) through numpy's RandomState, as the JAX package draws
        them; skip_drop skips the dropout, the first iteration drops
        nothing; weighted by each tree's weight unless uniform_drop, at
        most max_drop (> 0)."""
        c = self.config
        r = np.random.RandomState(
            (int(c.drop_seed) * 2654435761 + self.iter_) % (2 ** 32))
        if r.rand() < c.skip_drop or self.iter_ == 0:
            return []
        drops: List[int] = []
        if not c.uniform_drop:
            inv_avg = len(self._tree_weight) / max(self._sum_weight, 1e-300)
            rate = c.drop_rate
            if c.max_drop > 0:
                rate = min(rate, c.max_drop * inv_avg
                           / max(self._sum_weight, 1e-300))
            for i in range(self.iter_):
                if r.rand() < rate * self._tree_weight[i] * inv_avg:
                    drops.append(i)
                    if len(drops) >= c.max_drop > 0:
                        break
        else:
            rate = c.drop_rate
            if c.max_drop > 0:
                rate = min(rate, c.max_drop / max(1, self.iter_))
            for i in range(self.iter_):
                if r.rand() < rate:
                    drops.append(i)
                    if len(drops) >= c.max_drop > 0:
                        break
        return drops

    def _dropped_trees(self, drops: List[int]):
        """(model index, class) of each split tree of the dropped
        iterations."""
        K = self.num_class
        models = self.models
        return [(i * K + k, k) for i in drops for k in range(K)
                if models[i * K + k].num_leaves > 1]

    def before_gradients(self) -> None:
        """Take the dropped trees out of the train score and set this
        iteration's shrinkage (dart.hpp:80 GetTrainingScore drops lazily,
        so a custom objective also sees the dropped ensemble); once per
        iteration."""
        if self._pending_drops is not None:
            return
        c = self.config
        drops = self._select_drops()
        k_drop = float(len(drops))
        for mi, k in self._dropped_trees(drops):
            self._tree_score_delta(self.train, self.device_trees[mi], k, -1.0)
        if not c.xgboost_dart_mode:
            self.shrinkage_rate = c.learning_rate / (1.0 + k_drop)
        else:
            self.shrinkage_rate = (c.learning_rate if not drops
                                   else c.learning_rate
                                   / (c.learning_rate + k_drop))
        self._pending_drops = drops

    def train_one_iter(self, grad=None, hess=None) -> bool:
        c = self.config
        self.before_gradients()
        drops = self._pending_drops or []
        self._pending_drops = None
        k_drop = float(len(drops))
        stop = super().train_one_iter(grad, hess)
        self._materialize()  # the stop check, every iteration
        if stop or self._stopped:
            # put the dropped trees back: the train score again sums the
            # stored ensemble
            for mi, k in self._dropped_trees(drops):
                self._tree_score_delta(self.train, self.device_trees[mi], k,
                                       1.0)
            return True
        if drops:
            # Normalize (dart.hpp): each dropped tree keeps `factor` of
            # its weight; the train score lacks it, the valid scores
            # still hold all of it
            if not c.xgboost_dart_mode:
                factor = k_drop / (k_drop + 1.0)
                valid_delta = -1.0 / (k_drop + 1.0)
            else:
                factor = k_drop / (k_drop + c.learning_rate)
                valid_delta = -c.learning_rate / (k_drop + c.learning_rate)
            models = self.models
            for mi, k in self._dropped_trees(drops):
                arrays = self._on_device(self.device_trees[mi])
                for vs in self.valids:
                    self._tree_score_delta(vs, arrays, k, valid_delta)
                self._tree_score_delta(self.train, arrays, k, factor)
                self.device_trees[mi] = arrays._replace(
                    leaf_value=arrays.leaf_value * factor)
                models[mi].leaf_value = models[mi].leaf_value * factor
                models[mi].shrinkage *= factor
            if not c.uniform_drop:
                for i in drops:
                    self._sum_weight -= self._tree_weight[i] / (
                        k_drop + (1.0 if not c.xgboost_dart_mode
                                  else c.learning_rate))
                    self._tree_weight[i] *= factor
        if not c.uniform_drop:
            self._tree_weight.append(self.shrinkage_rate)
            self._sum_weight += self.shrinkage_rate
        return False


class RF(GBDT):
    """Random forest (rf.hpp:25; the JAX package's RF, boosting.py:2579):
    the gradients are computed once, from the constant initial score;
    each tree is grown on its bag / feature sample with shrinkage 1,
    carries the initial score itself (AddBias), and every score set holds
    the running average (score * m + tree) / (m + 1) of the m + 1 trees
    so far; prediction averages the trees (average_output). The
    renewing objectives refit each tree's leaves on label - init (the
    percentile refit, hist_nat's f32 mode on the card). Eager loop
    only."""

    def __init__(self, config: Config, train_set: Optional[BinnedDataset]):
        c = config
        if train_set is not None and c.data_sample_strategy == "bagging":
            bag_ok = c.bagging_freq > 0 and 0.0 < c.bagging_fraction < 1.0
            feat_ok = 0.0 < c.feature_fraction < 1.0
            if not (bag_ok or feat_ok):
                log.fatal("RF mode requires bagging (bagging_freq>0, "
                          "bagging_fraction in (0,1)) or feature_fraction "
                          "in (0,1)")
        super().__init__(config, train_set)
        self._force_sync_reason = ("random forest averages scores per "
                                   "iteration")
        self.average_output = True
        self.shrinkage_rate = 1.0
        if train_set is None:
            return
        if self.objective is None:
            log.fatal("RF mode does not support custom objective functions")
        K = self.num_class
        self._rf_init_scores = [
            (self.objective.boost_from_score(k) if c.boost_from_average
             else 0.0) for k in range(K)]
        const = torch.tensor(self._rf_init_scores, dtype=torch.float32,
                             device=self.device)[:, None].expand(
            K, train_set.num_rows_padded()).contiguous()
        score = const if K > 1 else const[0]
        g, h = (self.objective.get_gradients(score, 0)
                if self.objective.needs_iter
                else self.objective.get_gradients(score))
        self._rf_grad = g.reshape(K, -1).to(torch.float32)
        self._rf_hess = h.reshape(K, -1).to(torch.float32)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        from .learner.renewal import renew_leaf_values

        if grad is not None or hess is not None:
            log.fatal("RF mode does not support custom objective functions")
        K = self.num_class
        m = float(self.iter_)  # trees already averaged into the scores
        valid = self.dev["valid"]
        renew_alpha, renew_w = self._renewal_setup()
        models = self.models
        for k in range(K):
            mask, gk, hk = self.strategy.sample(
                self.iter_, self._rf_grad[k], self._rf_hess[k], valid,
                self._label_dev)
            feat_mask = self._sample_features(self.iter_, k)
            arrays, row_leaf = self._grow_maybe_quantized(
                gk, hk, mask, feat_mask, valid, self.iter_, k,
                DeviceLoop(EAGER))
            self._mark_used(arrays)
            init_k = self._rf_init_scores[k]
            if int(arrays.num_nodes) > 0:
                if renew_alpha is not None:
                    arrays = arrays._replace(leaf_value=renew_leaf_values(
                        arrays.leaf_value, row_leaf,
                        self._label_dev - init_k, renew_w * mask,
                        renew_alpha, self.spec.num_leaves))
                tree = Tree.from_arrays(tree_arrays_to_host(arrays),
                                        self.train_set, 1.0)
                tree.leaf_value = tree.leaf_value + init_k
                arrays = arrays._replace(leaf_value=arrays.leaf_value + init_k)
            else:
                tree = Tree(num_leaves=1, shrinkage=1.0)
                tree.leaf_value = np.array([init_k], np.float64)
                lv = arrays.leaf_value.clone()
                lv[:1].fill_(init_k)
                arrays = arrays._replace(leaf_value=lv)
            for ss, leaf in [(self.train, row_leaf)] + [
                    (vs, self._traverse(arrays, vs.dev))
                    for vs in self.valids]:
                sc = add_score(ss.score[k] * m, leaf, arrays.leaf_value, 1.0)
                ss.score[k] = sc / (m + 1.0)
            models.append(tree)
            self.device_trees.append(arrays)
        self.iter_ += 1
        return False

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees out of the running averages."""
        if self.iter_ <= 0:
            return
        m = float(self.iter_)
        models = self.models
        for k in reversed(range(self.num_class)):
            models.pop()
            arrays = self._on_device(self.device_trees.pop())
            for ss in [self.train] + self.valids:
                leaf = self._traverse(arrays, ss.dev)
                sc = ss.score[k] * m - arrays.leaf_value[leaf.long()]
                ss.score[k] = sc / (m - 1.0) if m > 1 else sc * 0
        self.iter_ -= 1


def create_boosting(config: Config,
                    train_set: Optional[BinnedDataset]) -> GBDT:
    """The boosting factory (boosting.cpp:40; the JAX package's
    create_boosting)."""
    b = config.boosting
    if b == "gbdt":
        return GBDT(config, train_set)
    if b == "dart":
        return DART(config, train_set)
    if b == "rf":
        return RF(config, train_set)
    log.fatal(f"Unknown boosting type {b}")


def splice_continued(base: GBDT, delta: GBDT) -> GBDT:
    """Graft a continuation's trees onto the model it warm-started from
    (the JAX package's splice_continued, boosting.py:2698).

    The online loop's init_score handoff: the candidate v(n+1) is
    trained as a fresh booster over the microbatch with ``init_score`` =
    v(n)'s raw margins, so the delta trees hold only the residual on top
    of v(n). Raw scores add, so ``base.models + delta.models`` scores
    v(n+1), with no replay of every earlier tree a cycle. Mutates and
    returns ``base``."""
    if base.num_class != delta.num_class:
        raise ValueError(
            f"cannot splice: num_tree_per_iteration mismatch "
            f"({base.num_class} vs {delta.num_class})"
        )
    if base.average_output or delta.average_output:
        raise ValueError(
            "cannot splice averaged (rf) models: predictions divide by "
            "iteration count, so tree lists do not compose by append"
        )
    combined = list(base.models) + list(delta.models)
    if len(combined) % base.num_class:
        raise ValueError(
            f"cannot splice: {len(combined)} trees is not a whole number "
            f"of {base.num_class}-tree iterations"
        )
    base.models = combined  # the setter also drops pending device trees
    base.iter_ = len(combined) // base.num_class
    return base
