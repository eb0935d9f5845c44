"""Feature-parallel tree learner over a Mesh.

The reference's feature-parallel design
(src/treelearner/feature_parallel_tree_learner.cpp): every rank holds
ALL rows and every bin, features are partitioned across ranks, each
rank builds and scans only its own features' histograms, and the
global best split is an allreduce-max (SyncUpGlobalBestSplit) — no
histogram traffic, one small split record per leaf.

The JAX package runs it on its flat grower; the port never ported that
grower and rides the exact (permuted) grower instead, with
spec.feature_axis set (permuted.py): each rank's histograms cover its
block of ceil(G / n) columns, the winner records are all-gathered and
the max taken with one device's tie order (lowest feature), and every
rank partitions its rows the same way. The tree equals the serial exact
tree (ROADMAP C records the grower difference). EFB sends the learner
back to serial with a warning, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..learner.grower import GrowerSpec, TreeArrays, grow_tree
from .comm import Mesh


class FeatureParallelGrower:
    """The exact grower with its features sharded over a Mesh."""

    def __init__(self, mesh: Mesh, spec: GrowerSpec):
        self.mesh = mesh
        self.n_dev = mesh.size
        self.spec = spec._replace(feature_axis=mesh, axis_name=None,
                                  rounds_slots=0, quant=False)

    def padded_features(self, f: int) -> int:
        d = self.n_dev
        return ((f + d - 1) // d) * d

    def shard_inputs(self, dev: dict) -> dict:
        """Every rank keeps every row and bin (the reference's design):
        nothing to move."""
        return dict(dev)

    def __call__(self, bins, nan_bin, num_bins, mono, is_cat, grad, hess,
                 mask, feat_mask, params, valid, **kw
                 ) -> Tuple[TreeArrays, torch.Tensor]:
        return grow_tree(bins, nan_bin, num_bins, mono, is_cat, grad, hess,
                         mask, feat_mask, params, self.spec, valid=valid,
                         **kw)
