"""The promotion gate: a holdout evaluation on the card and the anomaly
verdict.

The port of lightgbm_tpu/online/gate.py. A candidate v(n+1) is promoted
only if both hold:

- **metric gate** — on the held-out shard, the candidate's first
  configured metric is no worse than the incumbent's (within
  ``loop_gate_margin``, signed by the metric's ``higher_better``); the
  other configured metrics are evaluated and recorded but do not veto;
- **anomaly gate** — no anomaly-sentinel trip during the refit
  (obs/anomaly.py): a poisoned microbatch that spikes the loss or makes
  NaN leaves reverts to v(n) (outcome ``rolled_back``) before any
  metric is compared.

The metrics run on the card through device_metrics.DeviceEvalSet, the
evaluators the fused training loop runs each round, over the raw scores
of the serving TensorForest (Booster.predict(device=...)): the gate's
arithmetic is the training loop's and the registry's, not a host copy.
Ranking metrics (ndcg / map need query groups) cannot gate; configure a
pointwise metric or auc for the loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def make_holdout_evaluator(cfg, label, weight=None, num_class: int = 1,
                           device="cuda"):
    """Resolve the config's metric list against the device metrics and
    build the evaluator.

    Returns ``(names, higher_better, fn)`` with ``fn(score (K, N)) ->
    (m,) f32`` on ``device``: the labels (and weights) go to the device
    once, for the life of the loop."""
    from ..device_metrics import DeviceEvalSet, supported_names
    from ..metrics import create_metrics

    metric_objs = create_metrics(cfg)
    if not metric_objs:
        raise ValueError(
            "online loop: no metric configured and the objective has no "
            "default — set metric= so the promotion gate can judge"
        )
    sup = supported_names(metric_objs)
    if sup is None:
        raise ValueError(
            "online loop: configured metrics "
            f"{[m.name for m in metric_objs]} are not device-evaluable "
            "(ranking metrics need query groups); the promotion gate "
            "requires device metrics"
        )
    names, hb = sup
    dev = torch.device(device)
    n = int(np.asarray(label).shape[0])
    label_dev = torch.from_numpy(
        np.asarray(label, np.float32).copy()).to(dev)
    valid = torch.ones(n, dtype=torch.float32, device=dev)
    w_dev = None
    if weight is not None:
        w_dev = torch.from_numpy(
            np.asarray(weight, np.float32).copy()).to(dev)
    ev = DeviceEvalSet(cfg, list(names), list(hb), label_dev, w_dev,
                       valid, num_class)

    def fn(score_kn) -> torch.Tensor:
        if not isinstance(score_kn, torch.Tensor):
            score_kn = torch.from_numpy(
                np.ascontiguousarray(score_kn, np.float32))
        return ev(score_kn.to(device=dev, dtype=torch.float32))

    return list(names), list(hb), fn


def raw_margins(booster, X: np.ndarray, device="cuda") -> np.ndarray:
    """v's raw scores on X as (K, N) f32, scored on ``device``: on the
    card the serving TensorForest (the registry's arithmetic), on the CPU
    the host walker. The gate's input and the next refit's
    ``init_score``."""
    score = booster.predict(np.asarray(X), raw_score=True,
                            device=str(device))
    score = np.asarray(score, dtype=np.float32)
    if score.ndim == 1:
        return score[None, :]
    return score.T.copy()  # predict gives (N, K); the metrics want (K, N)


def evaluate(fn, score_kn: np.ndarray) -> List[float]:
    """The evaluator over a (K, N) score block, read back as floats."""
    vals = fn(score_kn)
    return [float(v) for v in vals.cpu().numpy()]


def decide(
    cand: List[float],
    incumbent: Optional[List[float]],
    names: List[str],
    higher_better: List[bool],
    margin: float,
    anomaly_trips: Dict[str, int],
) -> Tuple[str, str]:
    """The verdict: ``("promoted"|"rejected"|"rolled_back", reason)``.

    The first metric decides (early stopping's convention); ``margin``
    loosens the comparison in the metric's worse direction. With no
    incumbent baseline (the first promotion after a fresh start) the
    metric gate passes."""
    trips = {k: v for k, v in (anomaly_trips or {}).items() if v}
    if trips:
        return "rolled_back", f"anomaly sentinel tripped during refit: {trips}"
    if incumbent is not None:
        c, i = float(cand[0]), float(incumbent[0])
        ok = c >= i - margin if higher_better[0] else c <= i + margin
        if not ok:
            word = "fell" if higher_better[0] else "rose"
            return "rejected", (
                f"holdout {names[0]} {word}: candidate {c:.6g} vs "
                f"incumbent {i:.6g} (margin {margin:g})"
            )
    return "promoted", f"holdout {names[0]} ok: {float(cand[0]):.6g}"
