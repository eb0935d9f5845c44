"""End-to-end serving check of the port's command line (the counterpart
of tools/serve_smoke.sh for lightgbm_tpu_torch).

    python3 -m lightgbm_tpu_torch.tools.serve_smoke [--device cpu]
        [--work build/serve_smoke]

Every step runs ``python -m lightgbm_tpu_torch`` in a process of its
own, on the card unless ``--device cpu`` is given:

1. ``task=train``: a 10-tree binary model on 800 rows x 5 features;
2. ``task=serve`` over stdio (ping, score, stats, quit): the scores
   within 1e-5 of ``Booster.predict`` on the same model file;
3. ``task=serve`` over HTTP: ``/healthz``, ``/readyz`` (200, a model
   loaded), ``/v1/score``, and ``/metrics`` as text exposition carrying
   ``lgbmtpu_serve_requests_total`` and
   ``lgbmtpu_serve_protocol_requests_total``;
4. ``serve_fleet=true`` with capacity 12 under 100 tenants: every
   tenant scores within 1e-5 cold or resident, resident <= capacity <
   fleet, evictions >= fleet - capacity; a hot-swap to version 2 and a
   rollback to 1; a TreeSHAP contrib whose row sums are within 1e-3 of
   the raw score; ``/metrics`` with per-model series,
   ``lgbmtpu_fleet_page_events_total`` and
   ``lgbmtpu_fleet_resident_models``;
5. ``task=loop`` over HTTP: v0 in ``/healthz``, two labelled
   microbatches through ``/v1/ingest``, one gated promotion to v1 seen
   in ``/healthz`` and on ``/metrics`` (promotion, ingest and version
   series), v1 scoring.

Each check is an AssertionError when it fails; a child that exits early
fails the run with its log's tail. The script prints one JSON line of
its numbers, then ``serve_smoke: OK``. Run it only as a module (``-m``):
it imports the package it checks. Children's logs and files live under
``--work`` (removed first).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
import urllib.request
from pathlib import Path

import numpy as np

from . import _procs

FLEET = 100
CAPACITY = 12
SERVE = {"serve_buckets": "16,64", "verbosity": -1}


def _data(work: Path) -> None:
    rs = np.random.RandomState(0)
    X = rs.randn(800, 5)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    np.savetxt(work / "train.csv", np.column_stack([y, X]), delimiter=",",
               fmt="%.6g")
    np.savetxt(work / "score.csv", X[:64, :], delimiter=",", fmt="%.6g")


def train_step(work: Path, device: str) -> float:
    t0 = time.perf_counter()
    child = _procs.spawn("train", {
        "data": work / "train.csv", "objective": "binary",
        "num_leaves": 15, "num_trees": 10, "verbosity": -1,
        "output_model": work / "model.txt"}, device, work / "train.log")
    if child.wait(600) != 0:
        raise child.exited()
    return time.perf_counter() - t0


def stdio_step(work: Path, device: str) -> dict:
    """task=serve over stdin / stdout against Booster.predict."""
    import lightgbm_tpu_torch as lgb

    rows = np.loadtxt(work / "score.csv", delimiter=",").tolist()
    reqs = "".join(json.dumps(r) + "\n" for r in [
        {"op": "ping"}, {"op": "score", "model": "default", "rows": rows},
        {"op": "stats"}, {"op": "quit"}])
    child = _procs.spawn("serve", {"input_model": work / "model.txt",
                                   **SERVE}, device, work / "stdio.log",
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        out, _ = child.proc.communicate(reqs, timeout=600)
    finally:
        _procs.terminate_all([child])
    if child.proc.returncode != 0:
        raise child.exited()
    resp = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert resp[0]["pong"], resp[0]
    served = np.asarray(resp[1]["pred"])
    assert resp[2]["stats"]["default"]["count"] >= 1, resp[2]
    host = lgb.Booster(model_file=str(work / "model.txt")).predict(
        np.asarray(rows))
    err = float(np.abs(served - host).max())
    assert err < 1e-5, f"serve/host mismatch: {err}"
    return {"rows": len(rows), "max_abs_vs_host": err}


def _metrics(base: str):
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        return r.headers["Content-Type"], r.read().decode()


def http_step(work: Path, device: str, children: list) -> dict:
    """task=serve over HTTP: health, readiness, a score, the exposition."""
    port = _procs.free_port()
    base = f"http://127.0.0.1:{port}"
    child = _procs.spawn("serve", {"input_model": work / "model.txt",
                                   "serve_port": port, **SERVE}, device,
                         work / "http.log", name="serve (http)")
    children.append(child)
    ready_s = _procs.wait_ready(base, child, path="/healthz")
    st, body = _procs.get(base, "/readyz")
    ready = json.loads(body)
    assert st == 200 and ready["ok"], ready
    assert ready["models"] >= 1, ready
    st, out = _procs.post(base, "score",
                          {"rows": [[0.0] * 5, [1.0] * 5]})
    assert st == 200 and out["ok"], out
    ctype, text = _metrics(base)
    assert ctype.startswith("text/plain"), ctype
    assert "lgbmtpu_serve_requests_total" in text, text[:500]
    assert "lgbmtpu_serve_protocol_requests_total" in text, text[:500]
    assert "# TYPE" in text
    assert _procs.stop(child) == 0, child.tail()
    return {"healthy_s": ready_s}


def fleet_step(work: Path, device: str, children: list) -> dict:
    """FLEET tenants behind one HTTP fleet of CAPACITY resident models."""
    import lightgbm_tpu_torch as lgb

    port = _procs.free_port()
    base = f"http://127.0.0.1:{port}"
    child = _procs.spawn("serve", {
        "input_model": work / "model.txt", "serve_port": port,
        "serve_fleet": "true", "serve_fleet_capacity": CAPACITY, **SERVE},
        device, work / "fleet.log", name="serve (fleet)")
    children.append(child)
    _procs.wait_ready(base, child, path="/healthz")
    model_str = (work / "model.txt").read_text()
    bst = lgb.Booster(model_str=model_str)
    rows = np.loadtxt(work / "score.csv", delimiter=",")[:16]
    host = bst.predict(rows)

    def post(op, body):
        st, out = _procs.post(base, op, body, timeout=120)
        assert st == 200 and out.get("ok"), (op, st, out)
        return out

    t0 = time.perf_counter()
    for i in range(FLEET):
        out = post("load", {"model": f"tenant{i:03d}",
                            "model_str": model_str, "deadline_ms": 10000})
        assert out["version"] == 1, out
    load_s = time.perf_counter() - t0
    # every tenant scored: only CAPACITY stay resident, so the sweep
    # pages out about FLEET - CAPACITY and every cold hit pages in
    t0 = time.perf_counter()
    worst = 0.0
    for i in range(FLEET):
        out = post("score", {"model": f"tenant{i:03d}",
                             "rows": rows.tolist()})
        err = float(np.abs(np.asarray(out["pred"]) - host).max())
        assert err < 1e-5, f"tenant{i:03d} mismatch: {err}"
        worst = max(worst, err)
    sweep_s = time.perf_counter() - t0
    st, body = _procs.get(base, "/v1/fleet")
    fl = json.loads(body)["fleet"]
    assert fl["models"] >= FLEET, fl  # +1: the command line's tenant
    assert fl["capacity"] == CAPACITY, fl
    assert fl["resident"] <= CAPACITY < FLEET, fl
    assert fl["evictions"] >= FLEET - CAPACITY, fl
    assert fl["pages_in"] >= FLEET, fl
    # a hot-swap of one tenant to a fresh version, and its rollback
    out = post("load", {"model": "tenant000", "model_str": model_str})
    assert out["version"] == 2, out
    post("score", {"model": "tenant000", "rows": rows.tolist()})
    out = post("rollback", {"model": "tenant000"})
    assert out["active"] == 1, out
    # TreeSHAP through the fleet: each row sums to the raw score
    out = post("contrib", {"model": "tenant001", "rows": rows.tolist()})
    contrib = np.asarray(out["pred"])
    assert contrib.shape == (len(rows), rows.shape[1] + 1), contrib.shape
    raw = bst.predict(rows, raw_score=True)
    serr = float(np.abs(contrib.sum(axis=1) - raw).max())
    assert serr < 1e-3, f"contrib row-sum mismatch: {serr}"
    _, text = _metrics(base)
    assert 'model="tenant000"' in text, text[:500]
    assert "lgbmtpu_fleet_page_events_total" in text
    assert "lgbmtpu_fleet_resident_models" in text
    assert _procs.stop(child) == 0, child.tail()
    return {"tenants": FLEET, "capacity": CAPACITY,
            "resident": fl["resident"], "pages_in": fl["pages_in"],
            "evictions": fl["evictions"], "load_s": load_s,
            "score_sweep_s": sweep_s, "max_abs_vs_host": worst,
            "contrib_row_sum_err": serr}


def loop_step(work: Path, device: str, children: list) -> dict:
    """task=loop over HTTP: ingest two microbatches, await v1."""
    rs = np.random.RandomState(17)
    HX = rs.randn(200, 5)
    Hy = (HX[:, 0] + HX[:, 1] > 0).astype(float)
    np.savetxt(work / "holdout.csv", np.column_stack([Hy, HX]),
               delimiter=",", fmt="%.6g")
    port = _procs.free_port()
    base = f"http://127.0.0.1:{port}"
    child = _procs.spawn("loop", {
        "input_model": work / "model.txt",
        "valid_data": work / "holdout.csv", "serve_port": port,
        "objective": "binary", "metric": "auc", "num_leaves": 15,
        "loop_dir": work / "loop", "loop_min_rows": 64, "loop_rounds": 4,
        "loop_gate_margin": 0.02, "loop_poll_s": 0.1, **SERVE},
        device, work / "loop.log", name="loop (http)")
    children.append(child)
    _procs.wait_ready(base, child, path="/healthz")
    st, body = _procs.get(base, "/healthz")
    hz = json.loads(body)
    assert hz["ok"] and hz["health"]["loop"]["version"] == 0, hz
    t0 = time.perf_counter()
    for seed in (61, 62):
        rb = np.random.RandomState(seed)
        X = rb.randn(40, 5)
        y = (X[:, 0] + X[:, 1] > 0).astype(float)
        st, out = _procs.post(base, "ingest", {"rows": X.tolist(),
                                               "labels": y.tolist()})
        assert st == 200 and out["ok"] and out["rows"] == 40, out
    deadline = time.monotonic() + 600
    while True:
        if child.poll() is not None:
            raise child.exited("died before the promotion")
        hz = json.loads(_procs.get(base, "/healthz")[1])
        if hz["health"]["loop"]["version"] >= 1:
            break
        assert time.monotonic() < deadline, "the loop never promoted v1"
        time.sleep(0.2)
    promote_s = time.perf_counter() - t0
    assert hz["health"]["loop"]["counts"]["promoted"] >= 1, hz
    st, out = _procs.post(base, "score", {"rows": HX[:4].tolist()})
    assert st == 200 and out["ok"], out
    _, text = _metrics(base)
    assert 'lgbmtpu_promotion_events_total{outcome="promoted"}' in text, \
        text[:800]
    assert "lgbmtpu_ingest_batches_total" in text
    assert "lgbmtpu_ingest_rows_total" in text
    assert "lgbmtpu_online_version" in text
    return {"promoted_version": hz["health"]["loop"]["version"],
            "cycle": hz["health"]["loop"]["cycle"],
            "ingest_to_promotion_s": promote_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default="build/serve_smoke")
    args = ap.parse_args(argv)
    _procs.require_device(args.device)

    t_all = time.perf_counter()
    work = Path(args.work).resolve()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    line = {"device": args.device, "build": _procs.prebuild(args.device)}
    _data(work)
    children: list = []
    try:
        line["train_s"] = train_step(work, args.device)
        line["stdio"] = stdio_step(work, args.device)
        line["http"] = http_step(work, args.device, children)
        line["fleet"] = fleet_step(work, args.device, children)
        line["loop"] = loop_step(work, args.device, children)
    finally:
        _procs.terminate_all(children)
    line["seconds"] = time.perf_counter() - t_all
    print(json.dumps(line), flush=True)
    print("serve_smoke: OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
