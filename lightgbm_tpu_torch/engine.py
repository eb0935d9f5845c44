"""train(): the eager training loop with eval recording.

The port of lightgbm_tpu/engine.py train (reference engine.py:109
lgb.train) for the main path: it builds the Booster, adds the
validation sets, runs num_boost_round iterations of the eager loop,
evaluates every iteration, and records the evaluations in
`evals_result` (the record_evaluation callback's layout:
{dataset: {metric: [values]}}) and the last ones in best_score.
Callbacks, early stopping, init_model, feval, fobj and checkpoint /
resume are not ported yet (ROADMAP queue A) and raise.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from . import log
from .basic import Booster, Dataset
from .config import Config, resolve_alias


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    evals_result: Optional[Dict[str, Dict[str, List[float]]]] = None,
    **unsupported: Any,
) -> Booster:
    """Train a model; evaluations land in `evals_result` when given."""
    live = {k: v for k, v in unsupported.items() if v is not None}
    if live:
        raise NotImplementedError(
            f"train() options {sorted(live)} are not ported yet (ROADMAP "
            "queue A: callbacks, init_model, feval, fobj)")
    params = dict(params)
    for k in list(params):
        if resolve_alias(k) == "num_iterations":
            num_boost_round = int(params.pop(k))
    cfg = Config(params)
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        raise NotImplementedError(
            "early stopping is not ported yet (ROADMAP queue A)")
    booster = Booster(params=params, train_set=train_set)
    valid_sets = valid_sets or []
    valid_names = valid_names or []
    eval_train = False
    for i, vs in enumerate(valid_sets):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:
            eval_train = True
            booster._train_data_name = name
            continue
        booster.add_valid(vs, name)
    evals: List = []
    i = -1
    for i in range(num_boost_round):
        finished = booster.update()
        evals = []
        if eval_train:
            evals.extend(booster.eval_train())
        if booster._gbdt.valids:
            evals.extend(booster.eval_valid())
        if evals and cfg.verbosity >= 1 and (i + 1) % cfg.metric_freq == 0:
            log.info(f"[{i + 1}]\t" + "\t".join(
                f"{d}'s {m}: {v:g}" for d, m, v, _ in evals))
        if evals_result is not None:
            for d, m, v, _ in evals:
                evals_result.setdefault(d, collections.OrderedDict()) \
                    .setdefault(m, []).append(v)
        if finished:
            break
    booster._gbdt._materialize()
    n_iters = booster._gbdt.num_trees() // booster._gbdt.num_class
    if n_iters < i + 1:
        evals = []  # stop detection rolled the last iterations back
    for d, m, v, _ in evals:
        booster.best_score.setdefault(d, collections.OrderedDict())[m] = v
    return booster
