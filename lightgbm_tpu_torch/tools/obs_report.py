"""Render merged observability artifacts of the port for humans (the
counterpart of tools/obs_report.py for lightgbm_tpu_torch).

    python3 -m lightgbm_tpu_torch.tools.obs_report [--device cpu]
        [--snapshots GLOB ...] [--url URL ...] [--recorder FILE ...]
        [--manifest FILE]

Merges any combination of
- per-process metrics snapshots (``obs.aggregate.write_snapshot`` files),
- live ``/metrics`` endpoints (HTTP pull: ``task=serve`` backends, a
  ``task=gateway``, a ``task=loop``),
- flight-record JSONL streams (``record_file=`` runs),
- a run manifest (``run_manifest=``),
into one fleet report on stdout, the same text as the JAX package's
tool renders from the same files. Host-side only: it reads through
``lightgbm_tpu_torch.obs.aggregate`` and ``.recorder`` and does no device
work, yet like every entry point of the port it refuses to start
without the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else f"{v:.6g}"


def render_metrics(merged: dict) -> str:
    lines = [f"== fleet metrics ({merged.get('processes', '?')} "
             "process(es)) =="]
    for name in sorted(merged.get("metrics", {})):
        fam = merged["metrics"][name]
        for key in sorted(fam.get("values", {})):
            v = fam["values"][key]
            spread = ""
            mn = fam.get("min", {}).get(key)
            mx = fam.get("max", {}).get(key)
            if mn is not None and mx is not None and mn != mx:
                spread = f"  [min {_fmt(mn)} / max {_fmt(mx)}]"
            lines.append(f"  {name}{key} {_fmt(v)}{spread}")
    return "\n".join(lines)


def render_recorder(rows: list) -> str:
    lines = [f"== flight record ({len(rows)} round(s) merged) =="]
    if not rows:
        return lines[0]
    for label, row in (("first", rows[0]), ("last", rows[-1])):
        ev = ", ".join(
            f"{k}={_fmt(v)}" for k, v in (row.get("evals") or {}).items()
        ) or "(no evals)"
        tps = row.get("trees_per_sec")
        tail = f"  {_fmt(tps)} trees/s" if tps else ""
        lines.append(f"  {label} round {row['round']}: {ev}{tail}")
    disagree = [r["round"] for r in rows if r.get("evals_disagree")]
    if disagree:
        lines.append(
            f"  !! eval disagreement across ranks at rounds {disagree}")
    return "\n".join(lines)


def render_manifest(m: dict) -> str:
    lines = ["== run manifest =="]
    dev = m.get("devices", {})
    lines.append(
        f"  backend {dev.get('backend')} x{dev.get('device_count')} "
        f"({dev.get('process_count', 1)} process(es))")
    fr = m.get("flight_recorder")
    if fr:
        lines.append(
            f"  flight record: {fr.get('rounds')} rounds -> "
            f"{fr.get('path') or '(memory only)'}")
        if fr.get("anomalies"):
            lines.append(f"  anomaly trips: {fr['anomalies']}")
    col = m.get("collectives", {})
    if col:
        lines.append(
            "  runtime wire bytes "
            f"{col.get('runtime_wire_bytes_estimate')} vs static pins "
            f"{col.get('static_budget_wire_bytes')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--snapshots", nargs="*", default=[],
                    help="metrics snapshot files (globs ok)")
    ap.add_argument("--url", action="append", default=[],
                    help="process base URL (or /metrics URL) to pull")
    ap.add_argument("--recorder", nargs="*", default=[],
                    help="flight-record JSONL files to merge by round")
    ap.add_argument("--manifest", default=None,
                    help="run manifest JSON to summarize")
    args = ap.parse_args(argv)

    from . import _procs

    _procs.require_device(args.device)
    from lightgbm_tpu_torch.obs import aggregate
    from lightgbm_tpu_torch.obs import recorder as rec_mod

    shown = False
    paths = [p for pat in args.snapshots for p in sorted(glob.glob(pat))]
    snaps = [aggregate.read_snapshot(p) for p in paths]
    snaps += [aggregate.pull_snapshot(u, process=i)
              for i, u in enumerate(args.url)]
    if snaps:
        print(render_metrics(aggregate.merge(snaps)))
        shown = True
    if args.recorder:
        streams = [rec_mod.read_stream(p) for p in args.recorder]
        print(render_recorder(aggregate.merge_recorder_streams(streams)))
        shown = True
    if args.manifest:
        with open(args.manifest) as f:
            print(render_manifest(json.load(f)))
        shown = True
    if not shown:
        ap.error("nothing to render: pass --snapshots/--url/--recorder/"
                 "--manifest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
