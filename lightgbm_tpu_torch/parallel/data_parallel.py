"""Data-parallel tree growth: rows sharded over ranks, histograms reduced.

The port of lightgbm_tpu/parallel/data_parallel.py. Reference algorithm
(src/treelearner/data_parallel_tree_learner.cpp):
  BeforeTrain: allreduce root (count, sum_grad, sum_hess)      (:169-221)
  FindBestSplits: local hists for all features -> ReduceScatter (:286)
  best split on aggregated hists -> allreduce-max split         (:443)
  Split: identical on all ranks using global counts             (:453)

Each rank holds a contiguous block of rows (pre_partition semantics:
each process passes its own rows), padded to the cluster-wide maximum so
every rank's per-row arrays have one shape. The grower (rounds.py or
permuted.py with spec.axis_name set) reduces the root sums and every
histogram over the mesh and computes everything downstream redundantly
and identically on every rank. Under tree_learner=voting the per-round
election (rounds.py vote_reduce) cuts the payload to the elected 2k
columns.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import log
from ..learner.grower import GrowerSpec, TreeArrays, grow_tree
from .comm import Mesh, make_mesh  # noqa: F401  (re-exported)


class DataParallelGrower:
    """grow_tree with rows sharded over a Mesh (the JAX package's
    shard_map over a 1-D "data" mesh). axis_rows: the rows one device
    holding every rank's rows pads to (the f32 histograms' fixed-point
    scale)."""

    def __init__(self, mesh: Mesh, spec: GrowerSpec, axis_rows: int = 0):
        self.mesh = mesh
        n = mesh.size
        self.spec = spec._replace(axis_name=mesh, axis_size=n,
                                  axis_rows=int(axis_rows))
        self._wire_est: dict = {}
        s = self.spec
        if (n > 1 and s.quant and not s.efb and not s.has_cat
                and not s.cat_subset and not s.mono_mode
                and not s.voting_k and not s.n_forced and not s.per_node):
            log.info(
                f"data-parallel histogram wire: int32 reduce-scatter "
                f"with per-rank feature ownership ({n} ranks, "
                f"{mesh.backend}) while the worst-case integer sums stay "
                f"exact (histogram.rs_exact_ok), else an all-reduce")

    def __call__(self, bins, nan_bin, num_bins, mono, is_cat, grad, hess,
                 mask, feat_mask, params, valid, **kw
                 ) -> Tuple[TreeArrays, torch.Tensor]:
        return grow_tree(bins, nan_bin, num_bins, mono, is_cat, grad, hess,
                         mask, feat_mask, params, self.spec, valid=valid,
                         **kw)

    def wire_bytes_per_tree(self, num_features: int) -> int:
        """Host-side estimate of the collective payload per grown tree,
        the JAX package's formula: one (3, cols, B) histogram reduce per
        split in 4-byte lanes (an int16 wire rides int32 here, which the
        4-byte lanes already count), cols the elected 2k (+ forced)
        columns under voting. Memoized per num_features; 0 on one rank."""
        if self.spec.axis_size <= 1:
            return 0
        F = int(num_features)
        est = self._wire_est.get(F)
        if est is None:
            s = self.spec
            cols = F
            if s.voting_k:
                cols = min(2 * int(s.voting_k) + int(s.n_forced), F)
            est = 3 * cols * int(s.num_bins) * 4 * int(s.num_leaves)
            self._wire_est[F] = est
        return est

    def shard_inputs(self, dev: dict) -> dict:
        """The dataset's device arrays as the grower takes them: each
        rank's rows are already its shard (nothing to move)."""
        return dict(dev)
