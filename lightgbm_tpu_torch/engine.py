"""train(): the per-iteration training loop with callbacks.

The port of lightgbm_tpu/engine.py train's per-iteration loop (reference
engine.py:109 lgb.train): it builds the Booster, adds the validation
sets, adopts an init_model's trees, then runs num_boost_round iterations,
each: the before-iteration callbacks (reset_parameter), one update (with
a custom fobj's gradients when given), the evaluations (with feval's),
and the after-iteration callbacks in `order` (log_evaluation,
record_evaluation, early_stopping). early_stopping_round in params adds
early_stopping, and verbosity >= 1 adds log_evaluation every metric_freq
rounds unless a callback of that order logs already. `evals_result`
records every evaluation ({dataset: {metric: [values]}}).

With no fobj, no feval and no before-iteration callback, train takes the
fused loop, as the JAX package does (engine.py:437-530): chunks of
_check_every iterations dispatched with no host read in between (CUDA
graph replays on the card, boosting._FusedProgram), one readback a
chunk, the after-iteration callbacks replayed from its eval records,
early stopping truncating the chunk (fused_truncate), and the
no-splittable-leaf stop replayed as the eager loop meets it. The log
says why a run stays on the eager loop. timetag=true prints the phase
timer's summary when train returns. Checkpoint / resume, the flight
recorder and the other keys of ROADMAP A.10 / A.11 raise.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config, resolve_alias
from . import log
from .timer import global_timer as _gt


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    feval: Optional[Callable] = None,
    init_model: Optional[Union[str, Path, Booster]] = None,
    keep_training_booster: bool = False,
    callbacks: Optional[List[Callable]] = None,
    fobj: Optional[Callable] = None,
    evals_result: Optional[Dict[str, Dict[str, List[float]]]] = None,
) -> Booster:
    """Train a model (reference engine.py:109 lgb.train).
    keep_training_booster is accepted as the JAX package accepts it: the
    returned Booster keeps its training state either way."""
    params = dict(params)
    for k in list(params):
        if resolve_alias(k) == "num_iterations":
            num_boost_round = int(params.pop(k))
    cfg = Config(params)
    if cfg.objective == "none" and fobj is None:
        log.warning("Using custom objective requires fobj; objective=none "
                    "trains nothing")
    callbacks = list(callbacks) if callbacks else []
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round, first_metric_only=cfg.first_metric_only,
            min_delta=cfg.early_stopping_min_delta))
    if cfg.verbosity >= 1 and not any(
            getattr(cb, "order", None) == 10
            and not getattr(cb, "before_iteration", False)
            for cb in callbacks):
        callbacks.append(callback_mod.log_evaluation(period=cfg.metric_freq))
    if evals_result is not None:
        callbacks.append(callback_mod.record_evaluation(evals_result))

    booster = Booster(params=params, train_set=train_set)
    valid_sets = valid_sets or []
    valid_names = valid_names or []
    valid_contain_train = False
    for i, vs in enumerate(valid_sets):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:
            valid_contain_train = True
            booster._train_data_name = name
            continue
        booster.add_valid(vs, name)
    if init_model is not None:
        booster._continue_from(init_model if isinstance(init_model, Booster)
                               else Booster(model_file=init_model))

    cb_before = sorted((cb for cb in callbacks
                        if getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    cb_after = sorted((cb for cb in callbacks
                       if not getattr(cb, "before_iteration", False)),
                      key=lambda cb: getattr(cb, "order", 0))
    gb = booster._gbdt
    if fobj is not None:
        why = "custom fobj"
    elif feval is not None:
        why = "custom feval"
    elif cb_before:
        why = "before-iteration callbacks"
    else:
        why = gb.fused_ineligible_reason()
    if why is not None:
        log.info(f"Using the eager training loop ({why}); the fused loop "
                 "replays each iteration as one CUDA graph")
    if cfg.timetag:
        from .timer import enable_timetag

        enable_timetag()
    _gt.device = gb.device
    evals: List = []
    i = -1
    if why is None:
        i, evals = _train_fused(booster, params, num_boost_round, cb_after,
                                valid_contain_train)
    else:
        for i in range(num_boost_round):
            for cb in cb_before:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round, None))
            with _gt.scope("update"):
                finished = booster.update(fobj=fobj)
            evals = []
            with _gt.scope("eval"):
                if valid_contain_train:
                    evals.extend(booster.eval_train(feval))
                if gb.valids:
                    evals.extend(booster.eval_valid(feval))
            try:
                for cb in cb_after:
                    cb(CallbackEnv(booster, params, i, 0, num_boost_round,
                                   evals))
            except EarlyStopException as e:
                booster.best_iteration = e.best_iteration + 1
                evals = e.best_score
                break
            if finished:
                break
    gb._materialize()
    # the stop condition is found only every _check_every iterations: the
    # iterations trained past it were rolled back, so clamp to the trees
    # kept and drop evaluations of scores that no longer stand
    n_iters = gb.num_trees() // gb.num_class
    booster.best_iteration = min(booster.best_iteration, n_iters)
    if n_iters < gb._init_iters + i + 1:
        evals = []
    for d, m, v, _ in evals or []:
        booster.best_score.setdefault(d, collections.OrderedDict())[m] = v
    if cfg.timetag:
        _gt.print_summary()
    return booster


def _train_fused(booster: Booster, params, num_boost_round: int, cb_after,
                 valid_contain_train: bool):
    """The fused loop (module docstring) -> (the last iteration's index,
    its evaluations or the early stop's best ones)."""
    gb = booster._gbdt
    gb.train.name = booster._train_data_name
    gb.fused_start(track_train=valid_contain_train)
    chunk = gb._check_every
    done = 0
    i = -1
    evals: List = []
    stop = False
    while done < num_boost_round and not stop:
        gb.fused_dispatch(min(chunk, num_boost_round - done))
        records = gb.fused_collect()
        for j, ev in enumerate(records):
            i = done + j
            evals = ev
            try:
                for cb in cb_after:
                    cb(CallbackEnv(booster, params, i, 0, num_boost_round,
                                   ev))
            except EarlyStopException as e:
                booster.best_iteration = e.best_iteration + 1
                evals = e.best_score
                # truncate counts every iteration: keep the loaded trees
                gb.fused_truncate(gb._init_iters + i + 1)
                stop = True
                break
        done += max(len(records), 1)
        if gb._stopped:
            # the eager loop runs the callbacks once for the stop
            # iteration (its evaluations equal the previous one's: the
            # stumps were rolled back); so does this loop
            if not stop and done < num_boost_round:
                i = done
                try:
                    for cb in cb_after:
                        cb(CallbackEnv(booster, params, i, 0,
                                       num_boost_round, evals))
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    evals = e.best_score
            break
    return i, evals
