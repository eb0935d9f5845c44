"""Training callbacks (reference python-package/lightgbm/callback.py).

The port of lightgbm_tpu/callback.py: callables taking a CallbackEnv
namedtuple, with a `before_iteration` attribute and an `order` that
engine.train sorts them by, EarlyStopException flow control, and the
four standard factories (log_evaluation, record_evaluation,
reset_parameter, early_stopping).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from . import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration", "evaluation_result_list"],
)


class EarlyStopException(Exception):
    """Raised to stop training (callback.py:EarlyStopException)."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value: Tuple, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and (env.iteration + 1) % period == 0:
            result = "\t".join(
                [_format_eval_result(x, show_stdv) for x in env.evaluation_result_list]
            )
            log.info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list or []:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _init(env)
        for item in env.evaluation_result_list or []:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result[data_name][eval_name].append(result)

    _callback.order = 20
    return _callback


def reset_parameter(**kwargs: Union[list, Callable]) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to 'num_boost_round'."
                    )
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            if env.model is not None:
                env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(
    stopping_rounds: int,
    first_metric_only: bool = False,
    verbose: bool = True,
    min_delta: Union[float, List[float]] = 0.0,
) -> Callable:
    """Early stopping callback (reference callback.py:454 semantics)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Any] = []
    cmp_op: List[Callable] = []
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is required for evaluation"
            )
        if stopping_rounds <= 0:
            raise ValueError("stopping_rounds should be greater than zero.")
        if verbose:
            log.info(
                f"Training until validation scores don't improve for {stopping_rounds} rounds"
            )
        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len(env.evaluation_result_list) // max(n_metrics, 1)
        deltas = (
            min_delta
            if isinstance(min_delta, list)
            else [min_delta] * n_datasets * n_metrics
        )
        if any(d < 0 for d in deltas):
            raise ValueError("Values for early stopping min_delta must be non-negative.")
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # higher better
                best_score.append(float("-inf"))
                cmp_op.append(lambda curr, best, d=delta: curr > best + d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda curr, best, d=delta: curr < best - d)

    def _final_iteration_check(env: CallbackEnv, eval_name_splitted, i: int) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                best = "\t".join([_format_eval_result(x) for x in best_score_list[i]])
                log.info(f"Did not meet early stopping. Best iteration is:\n[{best_iter[i] + 1}]\t{best}")
                if first_metric_only:
                    log.info(f"Evaluated only: {eval_name_splitted[-1]}")
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _init(env)
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            # reference callback.py:521: train-set metrics never trigger
            # the stop; in cv, the cv_agg entries of the training folds
            # (the validation folds' entries do stop it)
            if (env.evaluation_result_list[i][0] == "cv_agg"
                    and eval_name_splitted[0] in ("train", "training")) or (
                    env.model is not None
                    and hasattr(env.model, "_train_data_name")
                    and env.evaluation_result_list[i][0]
                    == env.model._train_data_name):
                _final_iteration_check(env, eval_name_splitted, i)
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    best = "\t".join([_format_eval_result(x) for x in best_score_list[i]])
                    log.info(f"Early stopping, best iteration is:\n[{best_iter[i] + 1}]\t{best}")
                    if first_metric_only:
                        log.info(f"Evaluated only: {eval_name_splitted[-1]}")
                if env.model is not None:
                    env.model.best_iteration = best_iter[i] + 1
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)

    _callback.order = 30
    return _callback
