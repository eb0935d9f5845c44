"""Distributed training over torch.distributed: the port of
lightgbm_tpu/parallel/ (ROADMAP A.8).

The JAX package shards rows (or features) over the devices of a
jax.sharding.Mesh inside one program, and its growers call lax.psum over
the mesh axis. Here each rank is one process with one device, a
comm.Mesh stands for the axis, and the growers call its collectives:
NCCL on the card, gloo on the CPU (the reference's socket / MPI layer,
src/network/). Every rank computes the same splits from the reduced
histograms and partitions its own rows, so the trees stay in lockstep
with no split broadcast (data_parallel_tree_learner.cpp).

- data_parallel: tree_learner=data / voting (rows sharded);
- feature_parallel: tree_learner=feature (every rank holds every row,
  searches its own feature block);
- multihost: the cluster's set-up from the reference's network params,
  distributed binning, run_distributed;
- comm: the Mesh and its collectives.
"""

from .comm import Mesh, make_mesh, world_size
from .data_parallel import DataParallelGrower
from .feature_parallel import FeatureParallelGrower

__all__ = ["DataParallelGrower", "FeatureParallelGrower", "Mesh",
           "make_mesh", "world_size"]
