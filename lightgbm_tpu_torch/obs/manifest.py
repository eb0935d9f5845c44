"""Run manifests: one JSON record describing what ran, where, and what
it cost.

The port of lightgbm_tpu/obs/manifest.py, the same schema
(``lightgbm-tpu/run-manifest/v1``) and top-level keys: the resolved
config, the device (the card's name, power limit and memory, or the
CPU), software versions (python, numpy, torch, CUDA), phase-timer
totals, the metrics snapshot, the flight-record summary and the data
plane's last ingestion (``data_plane``: spool, pass1, pass2, assemble).
Two keys read the JAX package's jaxpr analysis, which has no counterpart
here:
``compile`` (its retrace guard's compile counters) and
``collectives.static_budget_wire_bytes`` (its static cost budgets); the
port writes both as ``null``. ``collectives.runtime_wire_bytes_estimate``
sums the ``lgbmtpu_collective_wire_bytes_total`` counter, which the
distributed learners tick a tree (boosting._record_collective_wire).
Written
per run through the ``run_manifest`` / ``profile_dir`` CLI params
(cli.py), or directly via :func:`write_manifest`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Dict, Optional

SCHEMA = "lightgbm-tpu/run-manifest/v1"

# config keys always recorded resolved (beyond the explicit params)
_CORE_KEYS = (
    "task", "objective", "boosting", "num_iterations", "num_leaves",
    "learning_rate", "max_bin", "tree_learner", "num_class",
    "use_quantized_grad", "tpu_growth_mode", "tpu_growth_rounds",
    "tpu_hist_dtype", "device_type",
)


def _power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it (None without
    nvidia-smi)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def _device_info() -> Dict[str, Any]:
    import torch

    if not torch.cuda.is_available():
        return {"backend": "cpu", "device_count": 0, "device_kinds": []}
    props = torch.cuda.get_device_properties(0)
    return {
        "backend": "cuda",
        "device_count": torch.cuda.device_count(),
        "device_kinds": sorted({torch.cuda.get_device_name(i)
                                for i in range(torch.cuda.device_count())}),
        "memory_bytes": int(props.total_memory),
        "power_limit": _power_limit(),
    }


def _versions() -> Dict[str, Any]:
    import numpy as np
    import torch

    return {
        "python": sys.version.split()[0],
        "numpy": np.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def build_manifest(config: Optional[Any] = None,
                   booster: Optional[Any] = None,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Assemble the manifest dict (JSON-serializable). config: a Config
    or a plain params dict; booster: a trained Booster (the model
    section); extra: the caller's payload, under "extra"."""
    from ..timer import global_timer
    from .metrics import default_registry
    from .recorder import last_summary

    cfg_section: Dict[str, Any] = {}
    if config is not None:
        if hasattr(config, "explicit_params"):
            cfg_section["explicit"] = dict(config.explicit_params())
            cfg_section["resolved"] = {k: getattr(config, k)
                                       for k in _CORE_KEYS
                                       if hasattr(config, k)}
        else:
            cfg_section["explicit"] = dict(config)
    snap = default_registry().snapshot()
    runtime_wire = sum(
        snap.get("lgbmtpu_collective_wire_bytes_total", {}).values())
    manifest: Dict[str, Any] = {
        "schema": SCHEMA,
        "created_unix": time.time(),
        "argv": list(sys.argv),
        "config": cfg_section,
        "devices": _device_info(),
        "versions": _versions(),
        "compile": None,
        "phase_timers": {
            name: {"seconds": round(acc, 6), "calls": cnt}
            for name, (acc, cnt) in global_timer.summary().items()
        },
        "metrics": snap,
        "collectives": {
            "runtime_wire_bytes_estimate": int(runtime_wire),
            "static_budget_wire_bytes": None,
        },
    }
    fr = last_summary()
    if fr is not None:
        manifest["flight_recorder"] = fr
    # the last chunked ingestion (spool and binning rates, per-chunk RSS,
    # the assembly's transfer): the flat-memory record of an out-of-core
    # run
    from ..data import last_stats

    dp = last_stats()
    if dp is not None:
        manifest["data_plane"] = dp
    if booster is not None:
        g = getattr(booster, "_gbdt", None)
        manifest["model"] = {
            "num_trees": booster.num_trees(),
            "best_iteration": getattr(booster, "best_iteration", -1),
            "num_class": getattr(g, "num_class", 1),
            "hist_dtype": getattr(g, "hist_dtype", None),
            "tree_learner": getattr(g, "tree_learner_resolved", None),
            "voting_elected_cols": getattr(g, "voting_elected_cols", None),
            "voting_wire_bytes_est": getattr(g, "voting_wire_bytes_est",
                                             None),
        }
    if extra:
        manifest["extra"] = dict(extra)
    return manifest


def write_manifest(path: str, config: Optional[Any] = None,
                   booster: Optional[Any] = None,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Build and write the manifest; returns the dict. Values JSON
    cannot hold are written as strings rather than failing the run."""
    m = build_manifest(config=config, booster=booster, extra=extra)
    with open(path, "w") as f:
        json.dump(m, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    from .. import log

    log.info(f"run manifest written to {path}")
    return m
