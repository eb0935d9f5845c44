"""Durable state of the online train-and-serve loop.

The port of lightgbm_tpu/online/state.py, the same file schema. One JSON
file a loop directory holds what a restart needs to come back
consistent: the promoted version and where its model text lives, how
far into the ingest spool the loop has consumed, and the verdict
counters. It is written with the checkpoints' tmp + fsync +
``os.replace`` (resilience/checkpoint.py), so a SIGKILL at any point
leaves the previous state or the next one, never a torn file: the last
persisted promotion is the model that serves.

Ordering (online/loop.py): a candidate's model text is made durable at
its versioned path before any state refers to it, and the ingest offset
advances only in the same atomic write that records the cycle's
verdict. A crash before that write replays the cycle from the spool; a
crash after it serves the verdict's outcome.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from ..resilience.checkpoint import atomic_write_json
from ..resilience.errors import CheckpointError

SCHEMA = "lightgbm-tpu/online-loop/v1"

OUTCOMES = ("promoted", "rejected", "rolled_back")


def state_path(loop_dir: str) -> str:
    return os.path.join(loop_dir, "loop_state.json")


def model_path(loop_dir: str, version: int) -> str:
    return os.path.join(loop_dir, f"model_v{int(version)}.txt")


def fresh_state() -> Dict[str, Any]:
    return {
        "schema": SCHEMA,
        "version": 0,          # last promoted version number
        "model_path": "",      # its durable model text
        "ingest_offset": 0,    # spool bytes consumed through the last verdict
        "cycle": 0,            # verdict-carrying cycles completed
        "incumbent_metrics": None,  # holdout metrics of the promoted model
        "counts": {k: 0 for k in OUTCOMES},
        "last_outcome": None,
    }


def save_state(path: str, state: Dict[str, Any]) -> str:
    """Publish the loop state atomically (tmp + fsync + os.replace)."""
    return atomic_write_json(path, state)


def atomic_write_text(path: str, text: str) -> str:
    """A model text under the state file's contract: a version path
    holds a whole model or does not exist."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_state(path: str) -> Dict[str, Any]:
    """Read the loop state back; CheckpointError on a torn or foreign
    file (an absent file is the caller's "start fresh")."""
    try:
        with open(path) as f:
            state = json.load(f)
    except OSError as e:
        raise CheckpointError(f"cannot read loop state {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"loop state {path} is corrupt (torn write outside the "
            f"atomic protocol?): {e}"
        ) from e
    if state.get("schema") != SCHEMA:
        raise CheckpointError(
            f"loop state {path} has schema {state.get('schema')!r}, "
            f"expected {SCHEMA!r}"
        )
    for key in ("version", "model_path", "ingest_offset", "counts"):
        if key not in state:
            raise CheckpointError(f"loop state {path} is missing {key!r}")
    return state
