"""Capped-exponential retry / backoff: the package's one copy.

The port of lightgbm_tpu/resilience/backoff.py, the same schedule. Its
users are the gateway's retries (full jitter), the metrics scrape of
obs/aggregate.pull_snapshot and, once ported, the multi-host cluster
join: a transient connect failure must not condemn a whole run on its
first strike. Pure stdlib, no package-relative import.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple, Type


def backoff_delay(attempt: int, base_s: float = 0.5,
                  cap_s: float = 120.0) -> float:
    """Delay before retry number ``attempt`` (1-based): base * 2^(n-1),
    capped. attempt=1 -> base, attempt=2 -> 2*base, ..."""
    if attempt < 1:
        raise ValueError(f"attempt is 1-based, got {attempt}")
    return min(float(base_s) * (2.0 ** (attempt - 1)), float(cap_s))


def full_jitter_delay(attempt: int, base_s: float = 0.5,
                      cap_s: float = 120.0,
                      rand: Optional[Callable[[], float]] = None) -> float:
    """"Full jitter" on the same capped-exponential schedule: uniform in
    [0, backoff_delay(attempt)], so N clients that failed together do not
    retry together (the gateway's retry policy; tests pass a seeded
    ``rand``)."""
    if rand is None:
        import random

        rand = random.random
    return rand() * backoff_delay(attempt, base_s, cap_s)


def retry_call(
    fn: Callable,
    *,
    retries: int = 3,
    base_s: float = 0.5,
    cap_s: float = 120.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    retriable: Optional[Callable[[BaseException], bool]] = None,
    describe: str = "operation",
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()``; on a retriable failure sleep the capped-exponential
    delay and try again, up to ``retries`` more attempts.

    A failure is retried when it is an instance of ``retry_on`` and (when
    given) ``retriable(exc)`` is True: pull_snapshot retries a transient
    URLError but not an HTTP 4xx, which would fail the same way forever.
    The last failure propagates unchanged. ``on_retry`` observes each
    scheduled retry (attempt number, delay, exception)."""
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — a retry loop
            if attempt > retries or (retriable is not None
                                     and not retriable(e)):
                raise
            delay = backoff_delay(attempt, base_s, cap_s)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)


def delays(retries: int, base_s: float = 0.5,
           cap_s: float = 120.0) -> Sequence[float]:
    """The whole schedule as a list: retries=3, base_s=10 ->
    [10.0, 20.0, 40.0]."""
    return [backoff_delay(a, base_s, cap_s) for a in range(1, retries + 1)]
