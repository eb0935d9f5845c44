"""The online train-and-serve loop (the port of lightgbm_tpu/online).

The registry serves v(n) on the card while microbatches stream in
through the serving ``ingest`` op; each cycle refits a warm-started
candidate on the fused loop, judges it on a holdout shard with the
device metrics, and promotes, rejects or reverts it, crash-consistently
(``cli.py task=loop``).
"""

from .gate import decide, make_holdout_evaluator
from .ingest import IngestSpool, spool_path, stack_batches
from .loop import OnlineLoop
from .state import (
    fresh_state,
    load_state,
    model_path,
    save_state,
    state_path,
)

__all__ = [
    "OnlineLoop",
    "IngestSpool",
    "spool_path",
    "stack_batches",
    "decide",
    "make_holdout_evaluator",
    "fresh_state",
    "load_state",
    "save_state",
    "state_path",
    "model_path",
]
