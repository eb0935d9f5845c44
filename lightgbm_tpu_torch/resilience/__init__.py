"""Fault tolerance for training and serving (the port of
lightgbm_tpu/resilience/):

- ``checkpoint`` — crash-consistent (tmp + fsync + os.replace) training
  checkpoints behind ``snapshot_freq``, read by engine.train's
  ``resume=auto`` / ``resume_from=``; the resumed model is bit for bit
  an uninterrupted run's. Same schema as the JAX package's.
- ``faultinject`` — deterministic fault plans (raise / kill / delay at
  named host-side sites); a None check when disarmed.
- ``errors`` — the typed failure vocabulary the serving degradation
  paths raise and the HTTP transport maps to status codes.

Not ported: ``backoff`` and ``heartbeat``, whose only users are the
gateway, the online loop and the multihost trainer (ROADMAP A.11,
second half, and A.8).
"""

from .checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from .errors import (
    CheckpointError,
    DeadlineExceeded,
    InjectedFault,
    QueueOverflow,
    ResilienceError,
    ShutdownError,
)
from .faultinject import FaultPlan, arm, configure, disarm, fault_point

__all__ = [
    "CheckpointError",
    "DeadlineExceeded",
    "FaultPlan",
    "InjectedFault",
    "QueueOverflow",
    "ResilienceError",
    "ShutdownError",
    "arm",
    "configure",
    "disarm",
    "fault_point",
    "load_checkpoint",
    "save_checkpoint",
]
