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
- ``backoff`` + ``heartbeat`` — the one retry-with-backoff helper (the
  gateway's retries, the metrics scrape) and per-worker heartbeat files
  with a health report (the online loop's liveness on /readyz).
"""

from .backoff import backoff_delay, delays, full_jitter_delay, retry_call
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
from .heartbeat import HeartbeatWriter, health_report, read_heartbeats

__all__ = [
    "CheckpointError",
    "DeadlineExceeded",
    "FaultPlan",
    "HeartbeatWriter",
    "InjectedFault",
    "QueueOverflow",
    "ResilienceError",
    "ShutdownError",
    "arm",
    "backoff_delay",
    "configure",
    "delays",
    "disarm",
    "fault_point",
    "full_jitter_delay",
    "health_report",
    "load_checkpoint",
    "read_heartbeats",
    "retry_call",
    "save_checkpoint",
]
