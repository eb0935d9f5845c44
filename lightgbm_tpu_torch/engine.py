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

cv (reference engine.py:627) trains one Booster a fold on
Dataset.subset's row subsets (folds from _make_n_folds, or the caller's
iterable or splitter), aggregates each iteration's per-fold evaluations
into `<data> <metric>-mean` / `-stdv`, and replays the callbacks on them.
Without fobj, feval or before-iteration callbacks every fold takes the
fused loop: each fold's program replays its own CUDA graph (a captured
graph binds its fold's buffers, so the JAX package's one-trace step cache
has no counterpart here: each fold captures once).
"""

from __future__ import annotations

import collections
import copy
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

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


class CVBooster:
    """The per-fold Boosters of a cv run (reference engine.py:356); a
    method called on it is called on every fold's Booster, the results in
    a list."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> "CVBooster":
        self.boosters.append(booster)
        return self

    def __getattr__(self, name: str):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict, seed: int,
                  stratified: bool, shuffle: bool):
    """(train_idx, test_idx) per fold, the JAX package's folds bit for
    bit: stratified per label value or plain, shuffled by
    RandomState(seed), each fold's indices sorted."""
    full_data.construct()
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    if stratified and full_data.label is not None:
        label = np.asarray(full_data.label)
        folds = [[] for _ in range(nfold)]
        for cls in np.unique(label):
            idx = np.nonzero(label == cls)[0]
            if shuffle:
                rng.shuffle(idx)
            for i, chunk in enumerate(np.array_split(idx, nfold)):
                folds[i].extend(chunk.tolist())
        fold_idx = [np.asarray(sorted(f)) for f in folds]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        fold_idx = [np.sort(c) for c in np.array_split(idx, nfold)]
    for i in range(nfold):
        test_idx = fold_idx[i]
        train_idx = np.setdiff1d(np.arange(num_data), test_idx)
        yield train_idx, test_idx


def cv(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    folds=None,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics=None,
    feval=None,
    init_model=None,
    fpreproc=None,
    seed: int = 0,
    callbacks=None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
    fobj: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Cross-validation (reference engine.py:627; the JAX package's
    engine.cv). Ranking objectives are never stratified. init_model (a
    path or a Booster) seeds every fold, as in the reference; the JAX
    package accepts it and drops it (ROADMAP C)."""
    params = copy.deepcopy(params)
    for k in list(params):
        if resolve_alias(k) == "num_iterations":
            num_boost_round = int(params.pop(k))
    if metrics is not None:
        params["metric"] = metrics
    cfg = Config(params)
    if cfg.objective in ("lambdarank", "rank_xendcg") and stratified:
        stratified = False

    if folds is not None:
        if hasattr(folds, "split"):
            fold_iter = list(folds.split(np.zeros(train_set.num_data()),
                                         train_set.label))
        else:
            fold_iter = list(folds)
    else:
        fold_iter = list(_make_n_folds(train_set, nfold, params, seed,
                                       stratified, shuffle))
    if init_model is not None and not isinstance(init_model, Booster):
        init_model = Booster(model_file=init_model)

    cvbooster = CVBooster()
    for train_idx, test_idx in fold_iter:
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, copy.deepcopy(params))
        else:
            fold_params = params
        bst = Booster(params=fold_params, train_set=tr)
        bst.add_valid(te, "valid")
        if init_model is not None:
            bst._continue_from(init_model)
        cvbooster.append(bst)

    callbacks = list(callbacks) if callbacks else []
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round, first_metric_only=cfg.first_metric_only,
            min_delta=cfg.early_stopping_min_delta))
    cb_before = sorted((cb for cb in callbacks
                        if getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    cb_after = sorted((cb for cb in callbacks
                       if not getattr(cb, "before_iteration", False)),
                      key=lambda cb: getattr(cb, "order", 0))
    use_fused = (fobj is None and feval is None and not cb_before
                 and all(b._gbdt.fused_eligible()
                         for b in cvbooster.boosters))
    results: Dict[str, List[float]] = collections.defaultdict(list)

    def cv_iteration(i: int, fold_evals) -> bool:
        """One iteration's per-fold evaluations into `results` and the
        after-iteration callbacks; True when early stopping fired."""
        merged: Dict[Tuple[str, str, bool], List[float]] = \
            collections.OrderedDict()
        for one in fold_evals:
            for dn, mn, v, hb in one:
                merged.setdefault((dn, mn, hb), []).append(v)
        agg = [("cv_agg", f"{dn} {mn}", float(np.mean(vs)), hb,
                float(np.std(vs))) for (dn, mn, hb), vs in merged.items()]
        for (dn, mn, hb), vs in merged.items():
            results[f"{dn} {mn}-mean"].append(float(np.mean(vs)))
            results[f"{dn} {mn}-stdv"].append(float(np.std(vs)))
        try:
            for cb in cb_after:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round,
                               agg))
        except EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for bst in cvbooster.boosters:
                bst.best_iteration = cvbooster.best_iteration
            for k in results:
                results[k] = results[k][: cvbooster.best_iteration]
            return True
        return False

    if use_fused:
        gbs = [b._gbdt for b in cvbooster.boosters]
        if gbs and gbs[0].device.type == "cuda":
            log.info(f"cv: {len(gbs)} folds on the fused loop, each "
                     "capturing its own CUDA graph once")
        for gb in gbs:
            gb.fused_start(track_train=eval_train_metric)
        chunk = gbs[0]._check_every if gbs else 1
        done = 0
        stop = False
        while done < num_boost_round and not stop:
            n = min(chunk, num_boost_round - done)
            for gb in gbs:
                gb.fused_dispatch(n)
            fold_records = [gb.fused_collect() for gb in gbs]
            n_done = min(len(r) for r in fold_records) if fold_records else 0
            for j in range(n_done):
                i = done + j
                if cv_iteration(i, [recs[j] for recs in fold_records]):
                    # keep each fold's trees through the stop iteration;
                    # only the chunk's iterations after it go
                    for gb in gbs:
                        gb.fused_truncate(gb._init_iters + i + 1)
                    stop = True
                    break
            n_recorded = done + n_done
            done += max(n_done, 1)
            if not stop and any(gb._stopped for gb in gbs):
                # a fold met the no-splittable-leaf stop inside the chunk:
                # every fold keeps the iterations that have results
                for gb in gbs:
                    gb.fused_truncate(gb._init_iters + n_recorded)
                break
        for gb in gbs:
            gb._materialize()
    else:
        for i in range(num_boost_round):
            for cb in cb_before:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round,
                               None))
            for bst in cvbooster.boosters:
                bst.update(fobj=fobj)
            fold_evals = []
            for bst in cvbooster.boosters:
                one = bst.eval_valid(feval)
                if eval_train_metric:
                    one = bst.eval_train(feval) + one
                fold_evals.append(one)
            if cv_iteration(i, fold_evals):
                break
    out: Dict[str, Any] = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
