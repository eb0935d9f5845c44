"""The durable microbatch spool between the serving transports and the
online loop.

The port of lightgbm_tpu/online/ingest.py, the same line format. The
serving ``ingest`` op (serving/server.py) appends labeled microbatches
here; the refit consumes them from a byte offset the loop checkpoints
(online/state.py). The spool is the loop's write-ahead log: one JSON
line a microbatch, appended with flush + fsync, so a batch the op
acknowledged survives a SIGKILL and is consumed by exactly one verdict
or replayed after a crash (offsets advance only in the loop's atomic
state write).

A torn tail is the reader's to handle: a crash mid-append can leave a
partial last line, and ``read_from`` stops at the last complete line
without moving past the tear.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics

SPOOL_NAME = "ingest.jsonl"


def spool_path(loop_dir: str) -> str:
    return os.path.join(loop_dir, SPOOL_NAME)


class IngestSpool:
    """Append-only JSON-lines microbatch spool; thread-safe (appends run
    on serving request threads, reads on the loop's)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -------------------------------------------------------------- write
    def append(self, rows: List[List[float]], labels: List[float],
               weights: Optional[List[float]] = None) -> Dict[str, Any]:
        """Check and durably append one microbatch; returns ``{"rows": n,
        "offset": end}`` (end: the spool's size after the append)."""
        n = len(rows)
        if n == 0:
            raise ValueError("ingest: empty microbatch")
        if len(labels) != n:
            raise ValueError(
                f"ingest: {n} rows but {len(labels)} labels"
            )
        width = len(rows[0])
        for r in rows:
            if len(r) != width:
                raise ValueError("ingest: ragged rows in microbatch")
        batch: Dict[str, Any] = {
            "rows": [[float(v) for v in r] for r in rows],
            "labels": [float(v) for v in labels],
        }
        if weights is not None:
            if len(weights) != n:
                raise ValueError(
                    f"ingest: {n} rows but {len(weights)} weights"
                )
            batch["weights"] = [float(v) for v in weights]
        line = json.dumps(batch) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())
                end = f.tell()
        obs_metrics.record_ingest(n)
        return {"rows": n, "offset": int(end)}

    # --------------------------------------------------------------- read
    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def read_from(self, offset: int) -> Tuple[List[Dict[str, Any]], int]:
        """Every complete microbatch from byte ``offset`` on, and the
        offset after the last complete line (the next resume point). A
        torn tail is left unconsumed."""
        batches: List[Dict[str, Any]] = []
        end = int(offset)
        try:
            with open(self.path, "rb") as f:
                f.seek(int(offset))
                data = f.read()
        except OSError:
            return batches, end
        pos = 0
        while True:
            nl = data.find(b"\n", pos)
            if nl < 0:
                break  # an incomplete tail: not consumed
            line = data[pos:nl]
            pos = nl + 1
            if not line.strip():
                end = int(offset) + pos
                continue
            try:
                batch = json.loads(line)
            except json.JSONDecodeError:
                # a torn line followed by a newline comes only from
                # writes outside this class: stop rather than skip data
                break
            batches.append(batch)
            end = int(offset) + pos
        return batches, end


def stack_batches(batches: List[Dict[str, Any]]):
    """Spool batches concatenated into (X, y, w) numpy arrays (w None
    when no batch carried weights; batches without mix in as weight-1
    rows)."""
    xs, ys, ws = [], [], []
    any_w = any("weights" in b for b in batches)
    for b in batches:
        xs.append(np.asarray(b["rows"], dtype=np.float64))
        ys.append(np.asarray(b["labels"], dtype=np.float64))
        if any_w:
            ws.append(np.asarray(
                b.get("weights", [1.0] * len(b["labels"])),
                dtype=np.float64))
    X = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    w = np.concatenate(ws, axis=0) if any_w else None
    return X, y, w
