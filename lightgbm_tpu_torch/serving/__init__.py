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
  /v1/fleet, /healthz, /readyz, /metrics).

Not ported: the gateway and the online loop (ROADMAP A.11, second
half), and a row-sharded forest (A.8).
Importing one of the gateway's names raises NotImplementedError.
"""

from .dispatch import DEFAULT_BUCKETS, BucketDispatcher, MicroBatcher
from .fleet import ForestStack, ModelFleet
from .forest import TensorForest
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
]

# the JAX package's serving names not ported yet, each with the
# ROADMAP item that ports it
NOT_PORTED = {n: "A.11, second half (the gateway)" for n in (
    "Gateway", "gateway_http", "CircuitBreaker", "HedgePolicy",
    "RollingLatency", "BackendPool")}


def __getattr__(name):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"serving.{name} is not ported yet (ROADMAP {NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
