"""scikit-learn estimator API (reference python-package/lightgbm/sklearn.py).

The port of lightgbm_tpu/sklearn.py: `LGBMModel` (reference
sklearn.py:486) and the estimators `LGBMRegressor` (:1314),
`LGBMClassifier` (:1424) and `LGBMRanker` (:1679). The constructor's
argument names, fit()'s keywords, the fitted attributes (`booster_`,
`best_iteration_`, `feature_importances_`, `classes_`, ...) and the
sklearn-name -> LightGBM-name map (reg_alpha -> lambda_l1, subsample ->
bagging_fraction, ...) are the reference's; other keyword arguments go
into the parameters as they are (device_type, the tpu_* keys). fit trains
through engine.train, so an estimator runs on the card unless
device_type="cpu" is passed. scikit-learn is required, as in the JAX
package: without it an estimator raises LightGBMError when made.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

try:  # scikit-learn is optional in the reference (compat.py)
    from sklearn.base import BaseEstimator as _LGBMModelBase
    from sklearn.base import ClassifierMixin as _LGBMClassifierBase
    from sklearn.base import RegressorMixin as _LGBMRegressorBase
    from sklearn.preprocessing import LabelEncoder as _LGBMLabelEncoder

    SKLEARN_INSTALLED = True
except ImportError:
    # distinct empty bases, so the classes below still have a consistent
    # method order (object twice among the bases has none) and the
    # package imports; making an estimator raises (LGBMModel.__init__)
    class _LGBMModelBase:
        pass

    class _LGBMClassifierBase:
        pass

    class _LGBMRegressorBase:
        pass

    _LGBMLabelEncoder = None
    SKLEARN_INSTALLED = False

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError
from .engine import train as _train

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style fobj(y_true, y_pred[, weight/group]) to the
    engine's fobj(preds, dataset) (reference sklearn.py:154)."""

    def __init__(self, func: Callable):
        self.func = func
        self._argc = len(inspect.signature(func).parameters)

    def __call__(self, preds: np.ndarray, dataset: Dataset):
        labels = dataset.get_label()
        argc = self._argc
        p = preds.T if preds.ndim == 2 else preds  # (N, K) for multiclass
        if argc == 2:
            grad, hess = self.func(labels, p)
        elif argc == 3:
            grad, hess = self.func(labels, p, dataset.get_weight())
        else:
            grad, hess = self.func(labels, p, dataset.get_weight(), dataset.get_group())
        grad = np.asarray(grad)
        hess = np.asarray(hess)
        if grad.ndim == 2:  # (N, K) -> flat (K*N,) class-major
            grad = grad.T.reshape(-1)
            hess = hess.T.reshape(-1)
        return grad, hess


class _EvalFunctionWrapper:
    """Adapt sklearn-style feval(y_true, y_pred[, weight/group]) to the
    engine's feval(preds, dataset) (reference sklearn.py:241)."""

    def __init__(self, func: Callable):
        self.func = func
        self._argc = len(inspect.signature(func).parameters)

    def __call__(self, preds: np.ndarray, dataset: Dataset):
        labels = dataset.get_label()
        argc = self._argc
        p = preds.T if preds.ndim == 2 else preds
        if argc == 2:
            return self.func(labels, p)
        if argc == 3:
            return self.func(labels, p, dataset.get_weight())
        return self.func(labels, p, dataset.get_weight(), dataset.get_group())


class LGBMModel(_LGBMModelBase):
    """Base sklearn estimator (reference sklearn.py:486)."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective: Optional[Union[str, Callable]] = None,
        class_weight: Optional[Union[Dict, str]] = None,
        min_split_gain: float = 0.0,
        min_child_weight: float = 1e-3,
        min_child_samples: int = 20,
        subsample: float = 1.0,
        subsample_freq: int = 0,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        random_state: Optional[int] = None,
        n_jobs: Optional[int] = None,
        importance_type: str = "split",
        **kwargs: Any,
    ):
        if not SKLEARN_INSTALLED:
            raise LightGBMError(
                "scikit-learn is required for lightgbm_tpu_torch.sklearn")
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.class_weight = class_weight
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_score: Dict = {}
        self._best_iteration: int = -1
        self._objective = objective
        self._other_params: Dict[str, Any] = {}
        self._n_features: int = -1
        self._n_classes: int = -1
        self.set_params(**kwargs)

    # -- sklearn plumbing ------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            self._other_params[key] = value
        return self

    def _more_tags(self):
        return {"allow_nan": True, "X_types": ["2darray", "sparse", "1dlabels"]}

    # -- parameter translation ------------------------------------------
    def _process_params(self, stage: str) -> Dict[str, Any]:
        """sklearn names → LightGBM params (reference sklearn.py:801)."""
        params = self.get_params()
        params.pop("objective", None)
        for alias in ("class_weight", "importance_type", "n_estimators", "n_jobs"):
            params.pop(alias, None)
        if isinstance(self._objective, str) or self._objective is None:
            params["objective"] = self._objective
        else:
            params["objective"] = "none"
        params["num_leaves"] = self.num_leaves
        params["max_depth"] = self.max_depth
        params["learning_rate"] = self.learning_rate
        params["min_gain_to_split"] = params.pop("min_split_gain", self.min_split_gain)
        params["min_sum_hessian_in_leaf"] = params.pop("min_child_weight", self.min_child_weight)
        params["min_data_in_leaf"] = params.pop("min_child_samples", self.min_child_samples)
        params["bagging_fraction"] = params.pop("subsample", self.subsample)
        params["bagging_freq"] = params.pop("subsample_freq", self.subsample_freq)
        params["feature_fraction"] = params.pop("colsample_bytree", self.colsample_bytree)
        params["lambda_l1"] = params.pop("reg_alpha", self.reg_alpha)
        params["lambda_l2"] = params.pop("reg_lambda", self.reg_lambda)
        params["max_bin"] = params.pop("max_bin", 255)
        params.pop("subsample_for_bin", None)
        params.pop("random_state", None)
        if self.random_state is not None:
            seed = self.random_state
            if not isinstance(seed, (int, np.integer)):
                seed = seed.randint(0, 2**31 - 1) if hasattr(seed, "randint") else 0
            params["seed"] = int(seed)
            params["bagging_seed"] = int(seed)
            params["feature_fraction_seed"] = int(seed)
        params["boosting"] = self.boosting_type
        if self._n_classes > 2 and params["objective"] in (None, "multiclass", "multiclassova"):
            params["num_class"] = self._n_classes
        if params.get("verbosity") is None and params.get("verbose") is None:
            params["verbosity"] = -1
        params = {k: v for k, v in params.items() if v is not None}
        return params

    # -- fit -------------------------------------------------------------
    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_names=None,
        eval_sample_weight=None,
        eval_class_weight=None,
        eval_init_score=None,
        eval_group=None,
        eval_metric=None,
        feature_name="auto",
        categorical_feature="auto",
        callbacks=None,
        init_model=None,
    ) -> "LGBMModel":
        params = self._process_params(stage="fit")

        fobj = None
        if callable(self._objective):
            fobj = _ObjectiveFunctionWrapper(self._objective)
        feval_list: List[Callable] = []
        if eval_metric is not None:
            metrics = eval_metric if isinstance(eval_metric, list) else [eval_metric]
            str_metrics = [m for m in metrics if isinstance(m, str)]
            call_metrics = [m for m in metrics if callable(m)]
            if str_metrics:
                # merge with the existing/default metric rather than replace
                # (reference sklearn.py:944 prepends eval metrics)
                original = params.get("metric")
                if original is None:
                    # objective-implied default metric stays evaluated
                    from .metrics import _DEFAULT_METRIC

                    obj = params.get("objective")
                    original = [_DEFAULT_METRIC[obj]] if obj in _DEFAULT_METRIC else []
                elif isinstance(original, str):
                    original = [original]
                merged = list(dict.fromkeys(str_metrics + list(original)))
                params["metric"] = merged
            feval_list = [_EvalFunctionWrapper(m) for m in call_metrics]

        y_arr = np.asarray(y).reshape(-1)
        X_arr = X
        self._n_features = np.shape(X)[1]

        # class_weight → per-row weights (reference uses compute_sample_weight)
        if self.class_weight is not None and sample_weight is None:
            from sklearn.utils.class_weight import compute_sample_weight

            sample_weight = compute_sample_weight(self.class_weight, y_arr)

        train_set = Dataset(
            X_arr,
            label=y_arr,
            weight=sample_weight,
            group=group,
            init_score=init_score,
            feature_name=feature_name,
            categorical_feature=categorical_feature,
            params=params,
            free_raw_data=False,
        )

        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                name = eval_names[i] if eval_names and i < len(eval_names) else f"valid_{i}"
                vy = np.asarray(vy).reshape(-1)
                if hasattr(self, "_le") and self._le is not None:
                    vy = self._le.transform(vy)
                if vx is X and vy.shape == y_arr.shape and np.array_equal(vy, y_arr):
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    if eval_class_weight and i < len(eval_class_weight) and vw is None:
                        from sklearn.utils.class_weight import compute_sample_weight

                        vw = compute_sample_weight(eval_class_weight[i], vy)
                    vg = eval_group[i] if eval_group else None
                    vi = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(
                        Dataset(
                            vx, label=vy, weight=vw, group=vg, init_score=vi,
                            reference=train_set, params=params, free_raw_data=False,
                        )
                    )
                valid_names.append(name)

        evals_result: Dict = {}
        callbacks = list(callbacks) if callbacks else []
        callbacks.append(callback_mod.record_evaluation(evals_result))

        self._Booster = _train(
            params,
            train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets,
            valid_names=valid_names,
            feval=feval_list if feval_list else None,
            init_model=init_model,
            callbacks=callbacks,
            fobj=fobj,
        )
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self.fitted_ = True
        return self

    # -- predict ---------------------------------------------------------
    def predict(
        self,
        X,
        raw_score: bool = False,
        start_iteration: int = 0,
        num_iteration: Optional[int] = None,
        pred_leaf: bool = False,
        pred_contrib: bool = False,
        validate_features: bool = False,
        **kwargs: Any,
    ):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before predict")
        return self._Booster.predict(
            X,
            raw_score=raw_score,
            start_iteration=start_iteration,
            num_iteration=num_iteration,
            pred_leaf=pred_leaf,
            pred_contrib=pred_contrib,
            validate_features=validate_features,
            **kwargs,
        )

    # -- fitted attributes ----------------------------------------------
    @property
    def n_features_(self) -> int:
        if self._n_features < 0:
            raise LightGBMError("No n_features found. Need to call fit beforehand.")
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self.n_features_

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def best_iteration_(self) -> int:
        if self._Booster is None:
            raise LightGBMError("No best_iteration found. Need to call fit with early_stopping callback beforehand.")
        return self._best_iteration

    @property
    def objective_(self):
        return self._objective if self._objective is not None else self._fallback_objective()

    def _fallback_objective(self) -> str:
        return "regression"

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("No feature_importances found. Need to call fit beforehand.")
        return self.booster_.feature_importance(importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        if self._Booster is None:
            raise LightGBMError("No feature_name found. Need to call fit beforehand.")
        return self.booster_.feature_name()

    @property
    def feature_names_in_(self) -> np.ndarray:
        return np.asarray(self.feature_name_)


class LGBMRegressor(_LGBMRegressorBase, LGBMModel):
    """LightGBM regressor (reference sklearn.py:1314)."""

    def _fallback_objective(self) -> str:
        return "regression"

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMRegressor":
        if self._objective is None:
            self._objective = "regression"
        super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight, eval_init_score=eval_init_score,
            eval_metric=eval_metric, feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model,
        )
        return self


class LGBMClassifier(_LGBMClassifierBase, LGBMModel):
    """LightGBM classifier (reference sklearn.py:1424)."""

    def _fallback_objective(self) -> str:
        return "multiclass" if self._n_classes > 2 else "binary"

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_class_weight=None,
            eval_init_score=None, eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None) -> "LGBMClassifier":
        y_arr = np.asarray(y).reshape(-1)
        self._le = _LGBMLabelEncoder().fit(y_arr)
        y_enc = self._le.transform(y_arr)
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        if self._objective is None:
            self._objective = "multiclass" if self._n_classes > 2 else "binary"
        # map eval metric aliases like the reference (sklearn.py:1510-1530)
        alias = {"logloss": "binary_logloss", "error": "binary_error"}
        if self._n_classes > 2:
            alias = {"logloss": "multi_logloss", "error": "multi_error"}
        if isinstance(eval_metric, str):
            eval_metric = alias.get(eval_metric, eval_metric)
        elif isinstance(eval_metric, list):
            eval_metric = [alias.get(m, m) if isinstance(m, str) else m for m in eval_metric]
        super().fit(
            X, y_enc, sample_weight=sample_weight, init_score=init_score,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_class_weight=eval_class_weight,
            eval_init_score=eval_init_score, eval_metric=eval_metric,
            feature_name=feature_name, categorical_feature=categorical_feature,
            callbacks=callbacks, init_model=init_model,
        )
        return self

    def predict(self, X, raw_score=False, start_iteration=0, num_iteration=None,
                pred_leaf=False, pred_contrib=False, validate_features=False, **kwargs):
        result = self.predict_proba(
            X, raw_score, start_iteration, num_iteration, pred_leaf, pred_contrib,
            validate_features, **kwargs,
        )
        if callable(self._objective) or raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 2:
            class_index = np.argmax(result, axis=1)
        else:
            class_index = (result > 0.5).astype(np.int64)
        return self._le.inverse_transform(class_index)

    def predict_proba(self, X, raw_score=False, start_iteration=0, num_iteration=None,
                      pred_leaf=False, pred_contrib=False, validate_features=False, **kwargs):
        result = super().predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features, **kwargs,
        )
        if callable(self._objective) or raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes > 2 or result.ndim == 2:
            return result
        return np.vstack((1.0 - result, result)).transpose()

    @property
    def classes_(self) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("No classes found. Need to call fit beforehand.")
        return self._classes

    @property
    def n_classes_(self) -> int:
        if self._Booster is None:
            raise LightGBMError("No classes found. Need to call fit beforehand.")
        return self._n_classes


class LGBMRanker(LGBMModel):
    """LightGBM ranker (reference sklearn.py:1679)."""

    def _fallback_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        if self._objective is None:
            self._objective = "lambdarank"
        self._other_params["eval_at"] = list(eval_at)
        super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score, group=group,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight, eval_init_score=eval_init_score,
            eval_group=eval_group, eval_metric=eval_metric,
            feature_name=feature_name, categorical_feature=categorical_feature,
            callbacks=callbacks, init_model=init_model,
        )
        return self
