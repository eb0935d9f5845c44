"""Inference and serving on the card.

The port of lightgbm_tpu/serving:

- ``forest``: the tensorized predictor, the trained forest as dense
  (trees, nodes) device tables traversed for all rows x trees, one
  take_small gather a level (csrc/take_small.cu on the card), and the
  device TreeSHAP;
- ``dispatch``: the bucket-batched dispatcher (one CUDA graph per rung
  of the shape ladder) and the thread-safe microbatch queue;
- ``registry``: load / hot-swap / version Boosters (text or JSON model)
  behind one scoring entry point, with N dispatcher replicas a version;
- ``fleet``: the multi-tenant ModelFleet, shape families of models in
  stacked device tables with LRU paging, one CUDA graph a family stack
  and rung (ForestStack);
- ``server``: the JSON-lines loop and the HTTP front end (/v1/<op>,
  /v1/fleet, /healthz, /readyz, /metrics);
- ``gateway``: the resilient front end over many serving processes
  (readiness-gated pool, least-outstanding balancing, full-jitter
  retries, hedged requests, circuit breakers, deadline propagation,
  drain, the merged /metrics).

A row-sharded forest (``mesh=``, a parallel.comm.Mesh) scores each
rank's block of rows and all-gathers the blocks (forest.TensorForest).
"""

from .dispatch import DEFAULT_BUCKETS, BucketDispatcher, MicroBatcher
from .fleet import ForestStack, ModelFleet
from .forest import TensorForest
from .gateway import (
    BackendPool,
    CircuitBreaker,
    Gateway,
    HedgePolicy,
    RollingLatency,
    gateway_http,
)
from .registry import ModelRegistry
from .server import ScoringServer, readiness, serve_http

__all__ = [
    "TensorForest",
    "BucketDispatcher",
    "MicroBatcher",
    "DEFAULT_BUCKETS",
    "ModelRegistry",
    "ModelFleet",
    "ForestStack",
    "ScoringServer",
    "serve_http",
    "readiness",
    "Gateway",
    "gateway_http",
    "CircuitBreaker",
    "HedgePolicy",
    "RollingLatency",
    "BackendPool",
]
