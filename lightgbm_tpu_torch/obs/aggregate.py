"""Metric aggregation over processes, host-side.

The port of lightgbm_tpu/obs/aggregate.py, the same snapshot schema.
Every serving or training process keeps its own metrics registry; this
module merges their views into one, over host transports only: snapshot
files on a shared filesystem, or HTTP pulls of each process's
``/metrics``. It keeps working when the card or its collectives are what
broke.

- ``write_snapshot(path)`` / ``read_snapshot(path)`` — one process's
  registry (samples with their metric kinds);
- ``pull_snapshot(url)`` — scrape a process's Prometheus ``/metrics``
  and parse the text exposition back into the same shape;
- ``merge(snapshots)`` — counter and histogram samples sum across
  processes; gauges sum too, with per-key ``min`` / ``max`` beside them
  (a straggler shows in the spread);
- ``render_merged`` — a merged view as text exposition: the gateway's
  single-pane ``/metrics`` (serving/gateway.py);
- ``merge_recorder_streams`` — per-process flight records zipped by
  round into fleet rows.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request
from typing import Any, Dict, Iterable, List, Optional, Sequence

SCHEMA = "lightgbm-tpu/metrics-snapshot/v1"

# kinds whose samples add across processes; gauges are summed too but
# carry min / max so stragglers stay visible
_SUMMED_KINDS = ("counter", "histogram")


def snapshot_dict(registry=None, process: Optional[int] = None
                  ) -> Dict[str, Any]:
    """One process's registry as a JSON-serializable snapshot (samples
    keyed by their rendered label string, each metric's kind kept).
    ``process`` defaults to the torch.distributed rank when a process
    group is up, else 0."""
    from .metrics import _render_labels, default_registry

    reg = registry if registry is not None else default_registry()
    metrics: Dict[str, Dict[str, Any]] = {}
    for s in reg.samples():
        fam = metrics.setdefault(
            s.name, {"kind": s.kind, "help": s.help, "values": {}}
        )
        fam["values"][_render_labels(s.labels)] = float(s.value)
    if process is None:
        process = 0
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                process = dist.get_rank()
        except Exception:  # noqa: BLE001 — a snapshot needs no process group
            process = 0
    return {"schema": SCHEMA, "process": int(process), "metrics": metrics}


def write_snapshot(path: str, registry=None,
                   process: Optional[int] = None) -> Dict[str, Any]:
    snap = snapshot_dict(registry, process)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return snap


def read_snapshot(path: str) -> Dict[str, Any]:
    with open(path) as f:
        snap = json.load(f)
    if snap.get("schema") != SCHEMA:
        raise ValueError(
            f"{path} is not a metrics snapshot (schema "
            f"{snap.get('schema')!r} != {SCHEMA!r})"
        )
    return snap


# ---------------------------------------------------- prometheus pull
_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$"
)


def parse_prometheus(text: str, process: int = 0) -> Dict[str, Any]:
    """Text exposition (format 0.0.4) -> the snapshot shape above. A
    histogram's component samples (_bucket / _sum / _count) keep their
    full sample name; the family's kind comes from its # TYPE line."""
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    metrics: Dict[str, Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            fam, _, kind = rest.partition(" ")
            kinds[fam] = kind.strip()
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            fam, _, h = rest.partition(" ")
            helps[fam] = h
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in kinds:
                fam = name[: -len(suffix)]
                break
        entry = metrics.setdefault(name, {
            "kind": kinds.get(fam, "untyped"),
            "help": helps.get(fam, ""),
            "values": {},
        })
        entry["values"][labels] = float(value)
    return {"schema": SCHEMA, "process": int(process), "metrics": metrics}


def pull_snapshot(url: str, timeout: float = 10.0,
                  process: int = 0, retries: int = 2) -> Dict[str, Any]:
    """Scrape one process's ``/metrics`` (serving/server.py's route) into
    a snapshot. A transient transport failure (connection refused while
    the server restarts) retries with backoff; an HTTP error status is a
    live server's answer and fails at once."""
    from ..resilience.backoff import retry_call

    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"

    def _pull() -> Dict[str, Any]:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return parse_prometheus(r.read().decode(), process=process)

    return retry_call(
        _pull,
        retries=retries,
        base_s=0.25,
        retry_on=(urllib.error.URLError, OSError),
        retriable=lambda e: not isinstance(e, urllib.error.HTTPError),
        describe=f"scrape {url}",
    )


# --------------------------------------------------------------- merge
def merge(snapshots: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-process snapshots into one view."""
    merged: Dict[str, Dict[str, Any]] = {}
    for snap in snapshots:
        for name, fam in (snap.get("metrics") or {}).items():
            out = merged.setdefault(name, {
                "kind": fam.get("kind", "untyped"),
                "help": fam.get("help", ""),
                "values": {},
                "min": {},
                "max": {},
            })
            for key, v in (fam.get("values") or {}).items():
                v = float(v)
                out["values"][key] = out["values"].get(key, 0.0) + v
                out["min"][key] = min(out["min"].get(key, v), v)
                out["max"][key] = max(out["max"].get(key, v), v)
    for fam in merged.values():
        if fam["kind"] in _SUMMED_KINDS:
            # additive families need no spread
            fam.pop("min")
            fam.pop("max")
    return {
        "schema": SCHEMA + "+merged",
        "processes": len(snapshots),
        "metrics": merged,
    }


def merge_files(paths: Iterable[str]) -> Dict[str, Any]:
    return merge([read_snapshot(p) for p in sorted(paths)])


def render_merged(merged: Dict[str, Any]) -> str:
    """A merged snapshot back to text exposition (format 0.0.4): one
    scrape body for the gateway process and every live backend. Gauge
    min / max spreads are dropped (Prometheus has no spread sample; the
    JSON view keeps them)."""
    lines: List[str] = []
    metrics = merged.get("metrics") or {}
    for name in sorted(metrics):
        fam = metrics[name]
        kind = fam.get("kind", "untyped")
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for key in sorted(fam.get("values") or {}):
            v = fam["values"][key]
            vs = str(int(v)) if float(v).is_integer() else repr(float(v))
            lines.append(f"{name}{key} {vs}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------- recorder streams
def merge_recorder_streams(
    streams: Sequence[List[Dict[str, Any]]]
) -> List[Dict[str, Any]]:
    """Zip per-process flight-record streams by round into fleet rows.
    Lockstep data-parallel training gives every rank the same metric
    values: the row keeps the first stream's evals and names any key on
    which the ranks disagree; throughput sums; per-phase durations keep
    the fleet's max (what a lockstep collective waits on)."""
    by_round: Dict[int, List[Dict[str, Any]]] = {}
    for stream in streams:
        for rec in stream:
            by_round.setdefault(int(rec.get("round", -1)), []).append(rec)
    out: List[Dict[str, Any]] = []
    for rnd in sorted(by_round):
        recs = by_round[rnd]
        row: Dict[str, Any] = {"round": rnd, "processes": len(recs)}
        evals = [r.get("evals") for r in recs if r.get("evals")]
        if evals:
            row["evals"] = dict(evals[0])
            drift = {
                k for e in evals[1:] for k, v in e.items()
                if abs(float(v) - float(evals[0].get(k, v))) > 1e-9
            }
            if drift:
                # lockstep broke: show it, never average it away
                row["evals_disagree"] = sorted(drift)
        tps = [float(r["trees_per_sec"]) for r in recs
               if r.get("trees_per_sec")]
        if tps:
            row["trees_per_sec"] = sum(tps)
        phases: Dict[str, float] = {}
        for r in recs:
            for name, dur in (r.get("phases") or {}).items():
                phases[name] = max(phases.get(name, 0.0), float(dur))
        if phases:
            row["phases_max"] = phases
        out.append(row)
    return out
