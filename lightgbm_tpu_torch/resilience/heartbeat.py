"""Per-worker heartbeat files and a health report over them.

The port of lightgbm_tpu/resilience/heartbeat.py, the same file format.
A worker runs a ``HeartbeatWriter``: a daemon thread that atomically
rewrites ``heartbeat_rank<NNNNN>.json`` (tmp + os.replace, as the
checkpoints) every ``interval_s`` with ``{rank, pid, seq, t_unix,
final}``. Any process calls ``health_report(dir, expected=N)`` to
classify every expected rank as alive / stale (its file older than
``stale_after_s``) / missing (it never wrote). The online loop beats
while it runs, so a wedged refit shows as stale on the serving
endpoint's /readyz. Plain host file I/O: it keeps working when the card
or its collectives are what broke.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
from typing import Any, Dict, Optional


def heartbeat_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"heartbeat_rank{rank:05d}.json")


class HeartbeatWriter:
    """Background heartbeat of one worker; start() / stop().

    The writer thread owns all mutable state but the stop Event, so
    nothing needs a lock; stop() writes one final beat, so a clean
    shutdown is told apart from a crash that left a recent file."""

    def __init__(self, out_dir: str, rank: int, interval_s: float = 5.0):
        self.out_dir = out_dir
        self.rank = int(rank)
        self.interval_s = float(interval_s)
        self.path = heartbeat_path(out_dir, rank)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0

    def _write(self, final: bool = False) -> None:
        beat = {
            "rank": self.rank,
            "pid": os.getpid(),
            "seq": self._seq,
            "t_unix": time.time(),
            "final": bool(final),
        }
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(beat, f)
        os.replace(tmp, self.path)
        self._seq += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._write()
            except OSError:
                # a full or vanished directory must not kill the worker:
                # the missing beat is the signal the report shows
                pass

    def start(self) -> "HeartbeatWriter":
        os.makedirs(self.out_dir, exist_ok=True)
        self._write()  # beat 0 lands before the work starts
        self._thread = threading.Thread(
            target=self._run, name=f"lgb-heartbeat-r{self.rank}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5)
            self._thread = None
        try:
            self._write(final=True)
        except OSError:
            pass


def read_heartbeats(out_dir: str) -> Dict[int, Dict[str, Any]]:
    """rank -> last beat, skipping torn or foreign files (the directory
    may be shared)."""
    out: Dict[int, Dict[str, Any]] = {}
    for p in glob.glob(os.path.join(out_dir, "heartbeat_rank*.json")):
        m = re.search(r"heartbeat_rank(\d+)\.json$", p)
        if not m:
            continue
        try:
            with open(p) as f:
                out[int(m.group(1))] = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            continue
    return out


def health_report(
    out_dir: str,
    expected: int,
    stale_after_s: float = 30.0,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Classify every expected rank: ``alive`` (a fresh beat or a clean
    final one), ``stale`` (its last beat older than stale_after_s:
    wedged or dead), ``missing`` (it never wrote)."""
    now = time.time() if now is None else float(now)
    beats = read_heartbeats(out_dir)
    alive, stale, missing = [], [], []
    ages: Dict[str, float] = {}
    for rank in range(int(expected)):
        beat = beats.get(rank)
        if beat is None:
            missing.append(rank)
            continue
        age = now - float(beat.get("t_unix", 0.0))
        ages[str(rank)] = round(age, 3)
        if beat.get("final") or age <= stale_after_s:
            alive.append(rank)
        else:
            stale.append(rank)
    return {
        "expected": int(expected),
        "alive": alive,
        "stale": stale,
        "missing": missing,
        "ages_s": ages,
        "stale_after_s": float(stale_after_s),
        "healthy": not stale and not missing,
    }
