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
timer's summary when train returns.

Recovery and observation, as the JAX package's engine.train
(engine.py:250-309, 347-397, 567-608): ``fault_plan`` arms the
``round`` fault site; ``snapshot_freq`` writes model dumps and the
rolling checkpoint (resilience/checkpoint.py); ``resume=auto`` /
``resume_from`` adopt a checkpoint through Booster._continue_from,
count rounds absolutely and replay its eval history into the callbacks
of order >= 20; ``record_file`` / ``anomaly_policy`` stream one flight
record a round (obs/recorder.py) under the sentinels (obs/anomaly.py),
and ``anomaly_policy=rollback`` retrains from the checkpoint with a
decayed learning rate. ``data_source=chunked`` logs its budget once
here; the data plane itself runs in Dataset.construct (data/).

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
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config, resolve_alias
from . import log
from .obs.anomaly import AnomalyAbort
from .obs.metrics import record_eval_values, record_training_round
from .resilience import checkpoint as ckpt_mod
from .resilience import faultinject
from .resilience.faultinject import fault_point
from .timer import global_timer as _gt


class _ObsHooks:
    """The flight recorder and the anomaly sentinel on train()'s two loops
    (the JAX package's engine._ObsHooks). One record a boosting round:
    its absolute index, the provenance (hist_dtype, tree_learner), the
    phases drained from the timer's span sink, trees/s, the gh norms,
    the evaluations (with their higher-better flags, which the
    loss-spike sentinel reads) and the round's K trees' stats. A record
    is written and flushed before the sentinel sees it, so an abort
    never loses the round that tripped it."""

    def __init__(self, recorder, sentinel):
        self.recorder = recorder
        self.sentinel = sentinel
        self.round_offset = 0  # the checkpoint's round on a resume
        self._gbdt = None
        self._chunk_tps: Optional[float] = None
        self._step_durs: List[float] = []
        self._chunk_phases: Dict[str, float] = {}
        self._gh_rows: List[Tuple[float, float]] = []

    def bind(self, gbdt) -> None:
        self._gbdt = gbdt
        gbdt.recorder = self.recorder  # the eager loop reads gh norms
        self.recorder.attach()

    def _tree_stats(self, i: int):
        """Stats of iteration i's K trees. The eager loop keeps trees on
        the card for up to _check_every iterations; a recorded run
        copies them to the host every round, as the JAX package's sync
        loop does."""
        from .obs.recorder import tree_stats

        gbdt = self._gbdt
        gbdt._materialize()
        K = gbdt.num_class
        base = (gbdt._init_iters + i) * K
        models = gbdt.models
        if len(models) < base + K:
            return None
        return tree_stats(models[base: base + K])

    def _fill_evals(self, rec: Dict[str, Any], evals) -> None:
        if not evals:
            return
        rec["evals"] = {f"{it[0]} {it[1]}": float(it[2]) for it in evals}
        rec["evals_hb"] = {f"{it[0]} {it[1]}": bool(it[3])
                           for it in evals if len(it) > 3}

    def _record(self, i: int) -> Dict[str, Any]:
        return {"round": self.round_offset + i, "t_unix": time.time(),
                "hist_dtype": getattr(self._gbdt, "hist_dtype", None),
                "tree_learner": "serial"}

    def _emit(self, rec: Dict[str, Any], i: int, evals) -> None:
        self._fill_evals(rec, evals)
        ts = self._tree_stats(i)
        if ts is not None:
            rec["trees"] = ts
        self.recorder.record(rec)
        if self.sentinel is not None:
            self.sentinel.check(rec)  # abort / rollback raise AnomalyAbort

    def start_chunk(self, n_records: int, chunk_seconds: float) -> None:
        """A fused chunk was collected: drain the span sink once; one
        ``round: fused step`` span a dispatched iteration, and the
        chunk's own scopes ride its first record."""
        from .boosting import FUSED_ROUND_PHASE

        drained = self.recorder.drain_phases()
        self._step_durs = drained.pop(FUSED_ROUND_PHASE, [])
        self._chunk_phases = {k: round(sum(v), 6)
                              for k, v in drained.items()}
        K = self._gbdt.num_class
        self._chunk_tps = (n_records * K / chunk_seconds
                           if n_records and chunk_seconds > 0 else None)
        self._gh_rows = list(self._gbdt._last_gh_rows)

    def fused_round(self, i: int, j: int, evals) -> None:
        from .boosting import FUSED_ROUND_PHASE

        rec = self._record(i)
        if j < len(self._step_durs):
            rec["phases"] = {FUSED_ROUND_PHASE: round(self._step_durs[j], 6)}
        if j == 0 and self._chunk_phases:
            rec["chunk_phases"] = self._chunk_phases
        if self._chunk_tps is not None:
            rec["trees_per_sec"] = round(self._chunk_tps, 4)
        if j < len(self._gh_rows):
            rec["gnorm"] = round(self._gh_rows[j][0], 6)
            rec["hnorm"] = round(self._gh_rows[j][1], 6)
        self._emit(rec, i, evals)

    def eager_round(self, i: int, evals, iter_seconds: float) -> None:
        rec = self._record(i)
        drained = self.recorder.drain_phases()
        if drained:
            rec["phases"] = {k: round(sum(v), 6) for k, v in drained.items()}
        if iter_seconds > 0:
            rec["trees_per_sec"] = round(
                self._gbdt.num_class / iter_seconds, 4)
        gh = self._gbdt._last_gh_norm
        if gh is not None:
            rec["gnorm"], rec["hnorm"] = round(gh[0], 6), round(gh[1], 6)
        self._emit(rec, i, evals)

    def close(self) -> None:
        """train()'s finally: unhook the booster (a kept booster must not
        go on reading gh norms back), detach the span sink, flush and
        close the stream."""
        if self._gbdt is not None:
            self._gbdt.recorder = None
        self.recorder.close()


def _make_obs_hooks(cfg: Config, resume_bytes: Optional[int] = None
                    ) -> Optional[_ObsHooks]:
    """record_file / anomaly_policy -> hooks; None when both are off (the
    default: nothing is recorded and the fused step is the plain one).
    resume_bytes: the checkpoint's record-stream size, to which a resumed
    run truncates the stream before it appends."""
    if not cfg.record_file and cfg.anomaly_policy == "off":
        return None
    from .obs.anomaly import make_sentinel
    from .obs.recorder import FlightRecorder

    recorder = FlightRecorder(cfg.record_file or None,
                              resume_bytes=resume_bytes)
    return _ObsHooks(recorder, make_sentinel(cfg.anomaly_policy,
                                             recorder=recorder))


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
    params = copy.deepcopy(params)
    for k in list(params):
        if resolve_alias(k) == "num_iterations":
            num_boost_round = int(params.pop(k))
    cfg = Config(params)
    if cfg.objective == "none" and fobj is None:
        log.warning("Using custom objective requires fobj; objective=none "
                    "trains nothing")
    # this run's fault plan (fault_plan, else the env var), or none
    faultinject.configure(cfg.fault_plan)
    # a rollback retry runs train() again with the caller's callbacks,
    # not with the ones appended below (they hold consumed state)
    user_callbacks = list(callbacks) if callbacks else []
    callbacks = list(user_callbacks)
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

    # resume: a checkpoint is adopted as an init_model is; every draw is
    # keyed on the absolute iteration, so the resumed run grows the
    # trees an uninterrupted run grows
    ckpt_path = cfg.checkpoint_file or ckpt_mod.default_path(
        cfg.output_model)
    resume_offset = 0
    resume_rows: List[List[Tuple]] = []
    record_resume_bytes: Optional[int] = None
    resume_padding: Optional[List[float]] = None
    if init_model is None and (cfg.resume == "auto" or cfg.resume_from):
        found, state = ckpt_mod.find_resume_checkpoint(
            cfg.resume, cfg.resume_from, ckpt_path)
        if state is not None:
            fp = ckpt_mod.config_fingerprint(params)
            if state.get("fingerprint") and state["fingerprint"] != fp:
                log.warning(
                    f"Checkpoint {found} was written under a different "
                    f"training config (fingerprint {state['fingerprint']} "
                    f"!= {fp}); resuming anyway — the combined model will "
                    "not bit-match a single uninterrupted run")
            init_model = Booster(model_str=state["model"])
            resume_offset = state["engine_round"]
            resume_rows = ckpt_mod.truncate_eval_history(
                state.get("eval_history", ()), resume_offset)
            record_resume_bytes = state.get("record_offset")
            # absent from a checkpoint of the JAX package
            resume_padding = state.get("train_padding_score")
            log.info(f"Resuming training from checkpoint {found} "
                     f"(round {resume_offset})")

    if cfg.data_source == "chunked":
        # the out-of-core plane (data/): its per-chunk RSS lands in the
        # run manifest's data_plane section
        from .data import DEFAULT_RAM_BUDGET_MB

        log.info("data_source=chunked: host memory bounded by "
                 f"ram_budget_mb={cfg.ram_budget_mb or DEFAULT_RAM_BUDGET_MB}"
                 " MB (per-chunk RSS recorded in the run manifest)")

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
    if resume_padding is not None:
        booster._gbdt.restore_padding_scores(resume_padding)

    cb_before = sorted((cb for cb in callbacks
                        if getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    cb_after = sorted((cb for cb in callbacks
                       if not getattr(cb, "before_iteration", False)),
                      key=lambda cb: getattr(cb, "order", 0))
    gb = booster._gbdt
    # rounds are absolute across a resume: the callbacks, the fault site
    # and the snapshots see resume_offset + i
    total_rounds = num_boost_round
    num_boost_round = max(total_rounds - resume_offset, 0)
    snapshot_freq = cfg.snapshot_freq
    ckpt_fingerprint = (ckpt_mod.config_fingerprint(params)
                        if snapshot_freq > 0 else "")
    # the eval history through the current round rides in the checkpoint,
    # for a resume to replay into the stateful callbacks
    eval_history: List[List[Tuple]] = [list(r) for r in resume_rows]
    obs_hooks = _make_obs_hooks(cfg, record_resume_bytes)

    def snapshot(done_iter: int, evals) -> None:
        """snapshot_freq model dumps (gbdt.cpp:258-262) and the rolling
        checkpoint that resume=auto reads."""
        if snapshot_freq <= 0:
            return
        abs_round = resume_offset + done_iter + 1
        eval_history[abs_round - 1:] = [[tuple(t) for t in (evals or [])]]
        if abs_round % snapshot_freq != 0:
            return
        with _gt.scope("snapshot"):
            total = gb._init_iters + done_iter + 1  # the loaded trees too
            out = f"{cfg.output_model}.snapshot_iter_{abs_round}"
            booster.save_model(out, num_iteration=total)
            log.info(f"Saved snapshot to {out}")
            record_offset = None
            if obs_hooks is not None and obs_hooks.recorder.path:
                # the round's record is flushed before this runs: a
                # resume truncates the stream to exactly here
                try:
                    record_offset = os.path.getsize(obs_hooks.recorder.path)
                except OSError:
                    record_offset = None
            ckpt_mod.save_checkpoint(
                ckpt_path, booster.model_to_string(num_iteration=total),
                engine_round=abs_round, total_iters=total,
                eval_history=eval_history, record_offset=record_offset,
                fingerprint=ckpt_fingerprint,
                extra={"train_padding_score": gb.padding_scores()})

    if obs_hooks is not None:
        obs_hooks.round_offset = resume_offset
        obs_hooks.bind(gb)
    else:
        # a manifest written after this run must not carry an earlier
        # run's flight-record summary
        from .obs.recorder import clear_last_summary

        clear_last_summary()

    evals: List = list(resume_rows[-1]) if resume_rows else []
    if resume_offset > 0 and resume_rows:
        # replay the checkpointed learning curve into the stateful
        # callbacks (order >= 20: record_evaluation, early_stopping);
        # log_evaluation printed those rounds in the crashed run
        try:
            for r, row in enumerate(resume_rows):
                for cb in cb_after:
                    if getattr(cb, "order", 0) >= 20:
                        cb(CallbackEnv(booster, params, r, 0, total_rounds,
                                       list(row)))
        except EarlyStopException as e:
            # the crashed run stopped inside the checkpointed rounds
            booster.best_iteration = e.best_iteration + 1
            evals = e.best_score
            num_boost_round = 0

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
    i = -1
    loop = _Loop(booster, params, cb_after, resume_offset, total_rounds,
                 snapshot, obs_hooks)
    try:
        if why is None:
            i, evals = loop.fused(num_boost_round, valid_contain_train,
                                  snapshot_freq, evals)
        else:
            i, evals = loop.eager(num_boost_round, cb_before, fobj, feval,
                                  valid_contain_train, evals)
    except AnomalyAbort as anomaly:
        # anomaly_policy=rollback: restore the last checkpoint and train
        # again with a decayed learning rate; the budget decrements
        # through the retry's params, and without a checkpoint the
        # policy is abort
        if (cfg.anomaly_policy == "rollback" and snapshot_freq > 0
                and cfg.anomaly_rollback_max > 0
                and os.path.exists(ckpt_path)):
            if obs_hooks is not None:
                # the retry reopens the stream (truncate + append)
                obs_hooks.close()
                obs_hooks = None
            retry = copy.deepcopy(params)
            for k in list(retry):
                if resolve_alias(k) in ("learning_rate", "resume",
                                        "resume_from",
                                        "anomaly_rollback_max"):
                    retry.pop(k)
            retry["learning_rate"] = (cfg.learning_rate
                                      * cfg.anomaly_rollback_lr_decay)
            retry["resume_from"] = ckpt_path
            retry["anomaly_rollback_max"] = cfg.anomaly_rollback_max - 1
            log.warning(
                f"anomaly rollback: {anomaly} — restoring checkpoint "
                f"{ckpt_path} and retraining with learning_rate="
                f"{retry['learning_rate']:g} "
                f"({cfg.anomaly_rollback_max - 1} rollback(s) left)")
            return train(retry, train_set, total_rounds,
                         valid_sets=valid_sets, valid_names=valid_names,
                         feval=feval, init_model=None,
                         keep_training_booster=keep_training_booster,
                         callbacks=user_callbacks, fobj=fobj,
                         evals_result=evals_result)
        raise
    finally:
        # an abort, a callback's error or a kill of the thread leaves a
        # parseable stream and a summary for the manifest
        if obs_hooks is not None:
            obs_hooks.close()
    gb._materialize()
    if obs_hooks is not None and obs_hooks.sentinel is not None:
        booster.anomaly_summary = obs_hooks.sentinel.summary()
    # the stop condition is found only every _check_every iterations: the
    # iterations trained past it were rolled back, so clamp to the trees
    # kept and drop evaluations of scores that no longer stand
    n_iters = gb.num_trees() // gb.num_class
    booster.best_iteration = min(booster.best_iteration, n_iters)
    if n_iters < gb._init_iters + i + 1:
        evals = []
    for d, m, v, *_ in evals or []:
        booster.best_score.setdefault(d, collections.OrderedDict())[m] = v
    if cfg.timetag:
        _gt.print_summary()
    return booster


class _Loop:
    """train()'s two loops over the rounds still to run. Each round, in
    the JAX package's order on both: the fault site (the absolute round),
    the round's evaluations onto /metrics, its flight record, the
    snapshot / checkpoint, then the after-iteration callbacks. The fused
    loop meets them as it replays a collected chunk's records, so a crash
    at round r leaves the checkpoint that the eager loop leaves."""

    def __init__(self, booster: Booster, params, cb_after, offset: int,
                 total: int, snapshot, obs_hooks: Optional[_ObsHooks]):
        self.booster = booster
        self.params = params
        self.cb_after = cb_after
        self.offset = offset
        self.total = total
        self.snapshot = snapshot
        self.obs = obs_hooks

    def _callbacks(self, i: int, evals) -> Optional[List]:
        """The after-iteration callbacks at round i; early stopping's
        best evaluations when it fired, else None."""
        try:
            for cb in self.cb_after:
                cb(CallbackEnv(self.booster, self.params, self.offset + i,
                               0, self.total, evals))
        except EarlyStopException as e:
            self.booster.best_iteration = e.best_iteration + 1
            return e.best_score
        return None

    def eager(self, n_rounds: int, cb_before, fobj, feval,
              valid_contain_train: bool, evals):
        booster, gb = self.booster, self.booster._gbdt
        i = -1
        for i in range(n_rounds):
            fault_point("round", self.offset + i)
            for cb in cb_before:
                cb(CallbackEnv(booster, self.params, self.offset + i, 0,
                               self.total, None))
            t0 = time.perf_counter()
            with _gt.scope("update"):
                finished = booster.update(fobj=fobj)
            record_training_round(1, gb.num_class, time.perf_counter() - t0)
            evals = []
            with _gt.scope("eval"):
                if valid_contain_train:
                    evals.extend(booster.eval_train(feval))
                if gb.valids:
                    evals.extend(booster.eval_valid(feval))
            record_eval_values(evals)
            if self.obs is not None:
                self.obs.eager_round(i, evals, time.perf_counter() - t0)
            self.snapshot(i, evals)
            best = self._callbacks(i, evals)
            if best is not None:
                return i, best
            if finished:
                break
        return i, evals

    def fused(self, n_rounds: int, valid_contain_train: bool,
              snapshot_freq: int, evals):
        """Chunks of _check_every iterations dispatched with no host read
        in between, one readback a chunk. With snapshot_freq a chunk ends
        at each snapshot round, so the checkpoint holds the trees read
        back after that round's replay and no other round reads back."""
        gb = self.booster._gbdt
        gb.train.name = self.booster._train_data_name
        gb.fused_start(track_train=valid_contain_train)
        done = 0
        i = -1
        stop = False
        while done < n_rounds and not stop:
            n = min(gb._check_every, n_rounds - done)
            if snapshot_freq > 0:
                n = min(n, snapshot_freq
                        - (self.offset + done) % snapshot_freq)
            t0 = time.perf_counter()
            gb.fused_dispatch(n)
            records = gb.fused_collect()
            secs = time.perf_counter() - t0
            record_training_round(len(records),
                                  len(records) * gb.num_class, secs)
            if self.obs is not None:
                self.obs.start_chunk(len(records), secs)
            for j, ev in enumerate(records):
                i = done + j
                evals = ev
                fault_point("round", self.offset + i)
                record_eval_values(ev)
                if self.obs is not None:
                    self.obs.fused_round(i, j, ev)
                self.snapshot(i, ev)
                best = self._callbacks(i, ev)
                if best is not None:
                    evals = best
                    # truncate counts every iteration: keep loaded trees
                    gb.fused_truncate(gb._init_iters + i + 1)
                    stop = True
                    break
            done += max(len(records), 1)
            if gb._stopped:
                # the eager loop runs the callbacks once for the stop
                # iteration (its evaluations equal the previous one's:
                # the stumps were rolled back); so does this loop
                if not stop and done < n_rounds:
                    i = done
                    best = self._callbacks(i, evals)
                    if best is not None:
                        evals = best
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
