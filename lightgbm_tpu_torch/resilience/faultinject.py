"""Deterministic fault injection: a config/env-driven fault plan.

The port of lightgbm_tpu/resilience/faultinject.py, the same grammar.
Chaos testing needs faults that happen at an EXACT, reproducible point
— "the trainer died at round 7", "the first device put failed", "one
serving request stalled 200 ms" — not whenever a signal happens to
land. A fault plan is a string of clauses

    <site>:<trigger>:<action>[:<param>]   joined by ';'

    round:7:kill            SIGKILL the process at boosting round 7
    round:5:raise           raise InjectedFault at round 5
    device_put:1:raise      fail the 1st serving device call
    serve_request:2:delay:0.25   stall the 2nd serving request 250 ms
    serve_request:3:raise   500 the 3rd serving request

armed through the ``fault_plan=`` config/CLI param or the
``LGBMTPU_FAULT_PLAN`` env var (``configure()``), or programmatically
(``arm()`` / ``disarm()`` — tests). Sites are host-side seams the
production code already passes through:

- ``round``       — engine.train, once per boosting round on both loops
                    (on the fused loop as the chunk's records are
                    replayed, before the round's snapshot); ``trigger``
                    is the ABSOLUTE round index;
- ``device_put``  — serving/dispatch.py, before each bucketed device
                    call; ``trigger`` is the 1-based Nth hit;
- ``serve_request`` — serving/server.py, per protocol request;
                    ``trigger`` is the 1-based Nth hit;
- ``fleet_page``  — serving/fleet.py, before each page-in's table
                    write; ``trigger`` is the 1-based Nth hit;
- ``loop_ingest`` / ``loop_refit`` / ``loop_eval`` / ``loop_promote``
                  — online/loop.py, once per verdict cycle at each
                    phase's edge; ``trigger`` is the ABSOLUTE cycle;
- ``gw_connect`` / ``gw_slow_backend`` / ``gw_backend_5xx`` — the
                    gateway's backend attempt (before the socket opens,
                    before the response read, after it);
                    ``gw_drain`` — Gateway.drain; ``trigger`` is the
                    1-based Nth hit.

Actions: ``raise`` (InjectedFault), ``kill`` (SIGKILL — a real
no-cleanup crash for the checkpoint/resume tests), ``delay:<seconds>``
(sleep, then continue). Every clause fires ONCE and disarms itself, so
a plan is a finite, ordered script.

No cost when disarmed: ``fault_point`` is a module-global ``None`` check
on the host, and no call site is inside a captured CUDA graph (a
graph's replay passes through no Python).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from .errors import InjectedFault

ENV_VAR = "LGBMTPU_FAULT_PLAN"
SITES = (
    "round", "device_put", "serve_request", "fleet_page",
    "loop_ingest", "loop_refit", "loop_eval", "loop_promote",
    "gw_connect", "gw_backend_5xx", "gw_slow_backend", "gw_drain",
)
ACTIONS = ("raise", "kill", "delay")


class _Clause:
    __slots__ = ("site", "trigger", "action", "param", "done")

    def __init__(self, site: str, trigger: int, action: str, param: float):
        self.site = site
        self.trigger = trigger
        self.action = action
        self.param = param
        self.done = False

    def __repr__(self) -> str:
        p = f":{self.param:g}" if self.action == "delay" else ""
        return f"{self.site}:{self.trigger}:{self.action}{p}"


class FaultPlan:
    """Parsed plan; thread-safe (serving sites fire from request
    threads). ``visit`` matches one site hit against the clauses and
    executes at most one action."""

    def __init__(self, spec: str):
        self.spec = spec
        self.clauses: List[_Clause] = []
        self._hits = {s: 0 for s in SITES}
        self._lock = threading.Lock()
        for part in spec.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 3:
                raise ValueError(
                    f"fault plan clause {part!r}: need site:trigger:action"
                )
            site, trigger, action = bits[0], bits[1], bits[2]
            if site not in SITES:
                raise ValueError(
                    f"fault plan clause {part!r}: unknown site {site!r} "
                    f"(known: {SITES})"
                )
            if action not in ACTIONS:
                raise ValueError(
                    f"fault plan clause {part!r}: unknown action "
                    f"{action!r} (known: {ACTIONS})"
                )
            param = 0.0
            if action == "delay":
                if len(bits) < 4:
                    raise ValueError(
                        f"fault plan clause {part!r}: delay needs seconds "
                        "(site:trigger:delay:<s>)"
                    )
                param = float(bits[3])
            self.clauses.append(_Clause(site, int(trigger), action, param))

    # ------------------------------------------------------------------
    def visit(self, site: str, index: Optional[int] = None) -> None:
        """One site hit. ``index`` (when given, e.g. the boosting round)
        is matched against the trigger directly; otherwise the site's
        1-based hit counter is."""
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            at = self._hits[site] if index is None else int(index)
            fire = None
            for c in self.clauses:
                if not c.done and c.site == site and c.trigger == at:
                    c.done = True
                    fire = c
                    break
        if fire is None:
            return
        if fire.action == "delay":
            time.sleep(fire.param)
            return
        if fire.action == "kill":
            import signal

            # real crash semantics: no atexit, no finally, no flush —
            # exactly what the crash-consistent checkpoints must survive
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault(f"planned fault {fire!r} fired at {site}[{at}]")


_PLAN: Optional[FaultPlan] = None


def arm(spec: str) -> FaultPlan:
    """Install a plan for this process (replaces any previous one)."""
    global _PLAN
    plan = FaultPlan(spec)
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def configure(spec: str = "") -> Optional[FaultPlan]:
    """Entry-point hook (engine.train / cli task=serve): arm from the
    config param, else the env var, else disarm — each run's plan is
    exactly what ITS config says, never a leftover."""
    spec = (spec or "").strip() or os.environ.get(ENV_VAR, "").strip()
    if spec:
        return arm(spec)
    disarm()
    return None


def fault_point(site: str, index: Optional[int] = None) -> None:
    """Host-side fault seam. Disarmed (the default) this is one global
    load + None check; it is never called while a CUDA graph captures."""
    plan = _PLAN
    if plan is None:
        return
    plan.visit(site, index)
