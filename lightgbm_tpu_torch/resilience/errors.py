"""Typed failure vocabulary for the resilience layer.

A copy of lightgbm_tpu/resilience/errors.py.

One exception family shared by training recovery and the serving
degradation paths, so callers can catch by CONTRACT instead of string-
matching messages:

- ``CheckpointError`` — a checkpoint file is unreadable/corrupt (never
  raised for a merely *absent* file under ``resume=auto``);
- ``DeadlineExceeded`` — a queued scoring request outlived its
  deadline before a worker picked it up (also a ``TimeoutError``, so
  generic timeout handling catches it);
- ``QueueOverflow`` — admission control: the microbatch queue is at
  its row cap and the request was fast-failed instead of queued;
  carries ``retry_after_s`` for the HTTP 503 ``Retry-After`` header;
- ``ShutdownError`` — the owning component is closing/closed; pending
  futures are failed with this instead of hanging forever;
- ``InjectedFault`` — raised only by resilience/faultinject.py; typed
  separately so chaos tests can assert the fault they planted (and so
  the HTTP transport can map it to a 500 distinct from bad requests).

Pure stdlib; importable from anywhere in the package without cycles.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for the resilience layer's typed failures."""


class CheckpointError(ResilienceError):
    """Checkpoint file exists but cannot be read back (torn/corrupt)."""


class DeadlineExceeded(ResilienceError, TimeoutError):
    """A queued request's deadline passed before it was scored."""


class QueueOverflow(ResilienceError):
    """Admission control fast-fail: the queue is at its row cap."""

    def __init__(self, msg: str, retry_after_s: int = 1):
        super().__init__(msg)
        self.retry_after_s = int(retry_after_s)


class ShutdownError(ResilienceError):
    """The component is shutting down; the request was not processed."""


class InjectedFault(ResilienceError):
    """Deterministic fault planted by resilience/faultinject.py."""
