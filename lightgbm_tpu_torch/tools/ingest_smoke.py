"""End-to-end out-of-core ingestion check of the port's data plane (the
counterpart of tools/ingest_smoke.sh for lightgbm_tpu_torch).

    python3 -m lightgbm_tpu_torch.tools.ingest_smoke [--device cpu]
        [--rows 300000] [--work build/ingest_smoke]

Synthetic data whose raw float64 footprint is over ten times a
deliberately small ram_budget_mb (8) is fitted through
data_source=chunked: disk spool, two-pass binning, and the device
matrix assembled chunk by chunk (pinned slots on a copy stream on the
card). Three checks, each an AssertionError when it fails:

1. host RSS stays flat across the assembly (the run manifest's
   ``data_plane.assemble.rss_spread_mb`` at most 64 MB);
2. the fit is the in-RAM fit's: the same model text apart from the four
   data-plane parameter lines, and the same predictions bit for bit;
3. a 50,000-row CSV fits through the chunked text spool without its
   matrix ever being parsed whole.

It trains on the card unless ``--device cpu`` is given, prints one JSON
line of the numbers and then ``ingest smoke: OK``. The spools live under
``--work`` (removed first).
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

DATA_LINES = ("[data_source", "[ram_budget_mb", "[data_chunk_rows",
              "[data_spool_dir")


def _strip(text: str) -> str:
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith(DATA_LINES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=300_000)
    ap.add_argument("--work", default="build/ingest_smoke")
    args = ap.parse_args(argv)

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.data import last_stats, reset_stats
    from lightgbm_tpu_torch.obs.manifest import build_manifest

    work = Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rs = np.random.RandomState(7)
    n, f = args.rows, 12
    X = rs.randn(n, f)
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + rs.randn(n) * 0.1
    raw_mb = X.nbytes / (1 << 20)
    budget_mb = 8
    assert raw_mb > budget_mb, (raw_mb, budget_mb)
    base = dict(objective="regression", num_leaves=31, verbosity=-1,
                seed=3, deterministic=True, device_type=args.device)

    ref = lgb.train(base, lgb.Dataset(X, label=y, params=base), 10)
    reset_stats()
    p = dict(base, data_source="chunked", ram_budget_mb=budget_mb,
             data_spool_dir=str(work / "spool"))
    got = lgb.train(p, lgb.Dataset(X, label=y, params=p), 10)

    # (2) the in-RAM fit, bit for bit
    pr, pg = ref.predict(X[:4096]), got.predict(X[:4096])
    assert np.array_equal(pr, pg), "chunked predictions diverged from in-RAM"
    assert _strip(got.model_to_string()) == _strip(ref.model_to_string()), \
        "chunked model text diverged from in-RAM"

    # (1) flat per-chunk RSS, read back through the run manifest
    dp = build_manifest(config=p)["data_plane"]
    asm = dp["assemble"]
    assert asm["chunks"] >= 4, asm
    spread = asm["rss_spread_mb"]
    assert spread <= 64.0, f"steady-state RSS spread {spread} MB is not flat"
    h2d_s = asm["h2d_seconds"]
    print(json.dumps({
        "device": args.device, "raw_mb": round(raw_mb, 1),
        "ram_budget_mb": budget_mb, "chunks": asm["chunks"],
        "chunk_rows": asm["chunk_rows"],
        "prefetch_depth": asm["prefetch_depth"],
        "peak_rss_mb": asm["peak_rss_mb"], "rss_spread_mb": spread,
        "spool_rows_per_sec": dp["spool"]["rows_per_sec"],
        "bin_rows_per_sec": dp["pass2"]["rows_per_sec"],
        "assemble_seconds": asm["seconds"], "h2d_bytes": asm["h2d_bytes"],
        "h2d_gb_per_s": (asm["h2d_bytes"] / h2d_s / 1e9 if h2d_s else None),
        "pinned_mb": asm["pinned_mb"],
    }), flush=True)

    # (3) the text spool: a CSV fitted chunk by chunk
    csv = work / "train.csv"
    np.savetxt(csv, np.column_stack([y[:50_000], X[:50_000]]),
               delimiter=",", fmt="%.6g")
    reset_stats()
    pt = dict(base, data_source="chunked", ram_budget_mb=budget_mb,
              data_chunk_rows=8192, label_column="0",
              data_spool_dir=str(work / "text_spool"))
    bst = lgb.train(pt, lgb.Dataset(str(csv), params=pt), 3)
    st = last_stats()
    assert st["spool"]["rows"] == 50_000, st["spool"]
    assert bst.predict(X[:16]).shape == (16,)
    print(f"text-file spool ok: {st['spool']['chunks']} chunks", flush=True)
    print("ingest smoke: OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
