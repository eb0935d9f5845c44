"""Out-of-core data plane: the port of lightgbm_tpu/data/ (its
docs/DATA_PLANE.md contract).

A Dataset whose input does not fit in host RAM is spooled to disk and
binned in two passes; only the (G, N) bin matrix ever lands whole, on
the card:

- ``store``      — the disk-backed chunked columnar store: fixed-row
                   chunks of feature columns in a spool directory with
                   an atomically committed manifest, written from numpy
                   arrays, row-block iterators or delimited text. The
                   file format is the JAX package's, so either package
                   opens the other's spool;
- ``streaming``  — two-pass binning over a store (pass 1 draws the
                   in-RAM path's sample, pass 2 spools the packed bins)
                   and :class:`~.streaming.StreamedBinnedDataset`, whose
                   device matrix is assembled chunk by chunk;
- ``prefetch``   — the reader thread and the assembly: each chunk's
                   stored bins (uint8 for <= 256 bins) are copied into
                   pinned host slots, moved over PCIe on a side CUDA
                   stream and widened to int32 on the card.

One memory knob governs the plane: ``ram_budget_mb`` (0 = the 1 GB
default). :func:`ram_budget_bytes` resolves it and
:func:`warn_over_budget` is the single warning path for any component
about to exceed it. The last ingestion's footprint is kept for the run
manifest (``record_stats`` / ``last_stats``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .. import log

# the resolved budget when ram_budget_mb is 0 / unset
DEFAULT_RAM_BUDGET_MB = 1024


def ram_budget_bytes(ram_budget_mb: int) -> int:
    """The configured budget (MB, 0 = default) in bytes."""
    mb = int(ram_budget_mb) if ram_budget_mb else DEFAULT_RAM_BUDGET_MB
    return mb << 20


def warn_over_budget(what: str, nbytes: int, ram_budget_mb: int,
                     hint: str) -> bool:
    """The one memory-budget warning: one format, one knob. Returns
    whether it fired."""
    budget = ram_budget_bytes(ram_budget_mb)
    if nbytes <= budget:
        return False
    log.warning(
        f"{what} is {nbytes / (1 << 20):.0f} MB, over the "
        f"{budget >> 20} MB host RAM budget "
        f"(ram_budget_mb={int(ram_budget_mb) or 0}, 0 = "
        f"{DEFAULT_RAM_BUDGET_MB} MB default); {hint}"
    )
    return True


# the most recent ingestion's footprint, folded into the run manifest as
# manifest["data_plane"] (obs/manifest.py). Under a lock: the reader
# thread and the consumer both report.
_stats_lock = threading.Lock()
_last_stats: Optional[Dict[str, Any]] = None


def record_stats(section: str, payload: Dict[str, Any]) -> None:
    """Set one section (spool / pass1 / pass2 / assemble) of the current
    data-plane record."""
    global _last_stats
    with _stats_lock:
        if _last_stats is None:
            _last_stats = {}
        _last_stats[section] = payload


def last_stats() -> Optional[Dict[str, Any]]:
    """The most recent data-plane record, or None when the chunked plane
    has not run in this process."""
    with _stats_lock:
        return None if _last_stats is None else dict(_last_stats)


def reset_stats() -> None:
    global _last_stats
    with _stats_lock:
        _last_stats = None
