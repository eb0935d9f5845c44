"""Crash-consistent training checkpoints.

The port of lightgbm_tpu/resilience/checkpoint.py, the same file format
(schema ``lightgbm-tpu/checkpoint/v1``): a checkpoint written by either
package loads in the other. ``snapshot_freq`` writes model dumps
(engine.py `_snapshot`, mirroring reference gbdt.cpp:258-262); this
module extends that cadence into a SINGLE rolling checkpoint file
carrying everything engine.train needs to restart at the last good
round and reproduce the uninterrupted run bit for bit:

- the model text (repr() float round-trip — exact), including any
  init_model trees;
- ``engine_round``: how many NEW boosting rounds this train() call had
  completed when the checkpoint was cut;
- the eval history (one row per round), replayed into fresh
  early-stopping/record callbacks on resume so stateful callbacks see
  the identical sequence the uninterrupted run saw;
- the flight-record byte offset, so a resumed run truncates the JSONL
  stream back to the checkpoint and appends — no duplicated or torn
  round records;
- a config fingerprint (warn-only on mismatch: anomaly rollback
  legitimately resumes with a shrunken learning_rate);
- the port's one extra key, ``train_padding_score``: the training
  score of the padding rows, one value a class (GBDT.padding_scores).
  The gradient quantization's scale reads every row's gradient, padding
  included, and the traversal that rebuilds the scores on resume gives
  padding rows other scores than the run that wrote the checkpoint
  held; without the key the first resumed trees' split gains and
  internal values differ in the last digits. The JAX package's loader
  ignores the key, and a JAX checkpoint, without it, resumes as the
  JAX package resumes.

Atomicity: serialize to ``<path>.tmp`` in the same directory, flush +
fsync, then ``os.replace`` — a reader sees the old checkpoint or the
new one, never a torn file. A SIGKILL between any two instructions
loses at most the rounds since the last checkpoint. The training-side
RNG needs no state here: every sampling decision (bagging, GOSS,
feature_fraction, quantization) is keyed on the ABSOLUTE iteration via
``rng.fold_in`` (sample_strategy.py), so adopting the model at round r
continues the identical stream.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .errors import CheckpointError

SCHEMA = "lightgbm-tpu/checkpoint/v1"


def atomic_write_json(path: str, state: Dict[str, Any]) -> str:
    """The crash-consistency primitive every durable state file in the
    package shares: serialize to ``<path>.tmp`` in the same directory,
    flush + fsync, then ``os.replace``. A reader sees the old file or
    the new one, never a torn write (the abandoned ``.tmp`` of a crash
    mid-write is ignored by every loader)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def default_path(output_model: str) -> str:
    """The rolling checkpoint path for a run: ``<output_model>.ckpt``."""
    return f"{output_model}.ckpt"


def config_fingerprint(params: Dict[str, Any]) -> str:
    """Stable digest of the caller's params (resume/rollback keys and
    learning_rate excluded — rollback shrinks it on purpose). Warn-only
    on mismatch, but it catches the silent killer: resuming a run under
    a different objective or tree shape."""
    skip = {
        "resume", "resume_from", "checkpoint_file", "learning_rate",
        "anomaly_policy", "anomaly_rollback_lr_decay",
        "anomaly_rollback_max", "fault_plan",
    }
    items = sorted(
        (str(k), str(v)) for k, v in params.items()
        if str(k) not in skip
    )
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def save_checkpoint(
    path: str,
    model_str: str,
    *,
    engine_round: int,
    total_iters: int,
    eval_history: Sequence[Sequence[Tuple]] = (),
    record_offset: Optional[int] = None,
    fingerprint: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomically publish one checkpoint (tmp + fsync + os.replace)."""
    state: Dict[str, Any] = {
        "schema": SCHEMA,
        "engine_round": int(engine_round),
        "total_iters": int(total_iters),
        "fingerprint": fingerprint,
        # tuples -> lists is fine: the replay consumer indexes by
        # position, and json round-trips value types exactly
        "eval_history": [
            [list(t) for t in row] for row in eval_history
        ],
        "model": model_str,
    }
    if record_offset is not None:
        state["record_offset"] = int(record_offset)
    if extra:
        state.update(extra)
    return atomic_write_json(path, state)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint back; raises CheckpointError on a torn or
    alien file (absent files are the CALLER's decision — resume=auto
    treats them as 'start fresh', resume_from= as an error)."""
    try:
        with open(path) as f:
            state = json.load(f)
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"checkpoint {path} is corrupt (torn write outside the "
            f"atomic protocol?): {e}"
        ) from e
    if state.get("schema") != SCHEMA:
        raise CheckpointError(
            f"checkpoint {path} has schema {state.get('schema')!r}, "
            f"expected {SCHEMA!r}"
        )
    for key in ("engine_round", "total_iters", "model"):
        if key not in state:
            raise CheckpointError(f"checkpoint {path} is missing {key!r}")
    state["eval_history"] = [
        [tuple(t) for t in row] for row in state.get("eval_history", [])
    ]
    return state


def find_resume_checkpoint(
    resume: str, resume_from: str, ckpt_path: str
) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
    """Resolve the (path, state) to resume from, or (None, None) for a
    fresh start. ``resume_from`` (explicit path) must exist and load;
    ``resume=auto`` loads the run's rolling checkpoint when present and
    readable — a corrupt auto checkpoint is surfaced, not skipped
    (silently retraining from scratch hides the data loss)."""
    if resume_from:
        return resume_from, load_checkpoint(resume_from)
    if resume == "auto" and os.path.exists(ckpt_path):
        return ckpt_path, load_checkpoint(ckpt_path)
    return None, None


def truncate_eval_history(
    history: List[List[Tuple]], rounds: int
) -> List[List[Tuple]]:
    """Clamp a history to the first ``rounds`` rounds (a checkpoint
    must never carry evals from rounds after its own cut)."""
    return list(history[: max(int(rounds), 0)])
