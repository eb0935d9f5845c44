"""Dataset and Booster, the LightGBM Python API surface of the port.

The port of lightgbm_tpu/basic.py for the main path: a Dataset over a
dense matrix (with `reference=` for validation sets binned with the
training set's mappers, the constructor's `categorical_feature`,
indices or names, as the JAX package takes it, and the ranking metadata:
`group` (query sizes, whose sum must be the rows) and `position`, with
their set_ / get_ accessors), and a Booster that trains
(update, with a custom objective's gradients too), continues from a
loaded model (_continue_from), takes new parameters between iterations
(reset_parameter), evaluates with custom metrics (feval), predicts on the
host (with the per-row prediction early stop of classification), and
saves / loads the text model and dumps the JSON one (dump_model).
predict also gives leaf indices (pred_leaf) and host TreeSHAP
contributions (pred_contrib), and scores on the card through the
tensorized forest with device="cuda" (serving/forest.py). Text files,
sparse matrices, Sequences, pandas and Arrow inputs, subsets and refit
are not ported yet (ROADMAP queue A) and raise.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from . import log
from .config import Config, resolve_device
from .dataset import BinnedDataset
from .log import LightGBMError

_EARLY_STOP_KEYS = ("pred_early_stop", "pred_early_stop_freq",
                    "pred_early_stop_margin")


def _to_2d_numpy(data: Any) -> np.ndarray:
    if isinstance(data, (str, Path)) or hasattr(data, "tocsr") \
            or hasattr(data, "to_numpy"):
        raise NotImplementedError(
            "only dense numpy-like matrices are ported yet (files, sparse "
            "and dataframe inputs: ROADMAP queue A)"
        )
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr.astype(np.float64, copy=False)


def _to_1d(v: Any) -> Optional[np.ndarray]:
    return None if v is None else np.asarray(v).ravel()


class Dataset:
    """Dataset wrapper (reference basic.py:1746)."""

    def __init__(
        self,
        data: Any,
        label: Any = None,
        reference: Optional["Dataset"] = None,
        weight: Any = None,
        group: Any = None,
        init_score: Any = None,
        feature_name: Union[str, List[str]] = "auto",
        categorical_feature: Union[str, List[Union[int, str]]] = "auto",
        params: Optional[Dict[str, Any]] = None,
        free_raw_data: bool = True,
        position: Any = None,
    ):
        self.data = data
        self.label = _to_1d(label)
        self.reference = reference
        self.weight = _to_1d(weight)
        self.group = _to_1d(group)
        self.position = _to_1d(position)
        self.init_score = _to_1d(init_score)
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) or {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None

    def _resolve_categorical(self, feature_names: List[str]) -> List[int]:
        """The constructor's categorical_feature as column indices: ints
        as they are, names looked up in feature_names (unknown names
        warned about and dropped). Like the JAX package, a
        `categorical_feature` key in params is not read here."""
        cf = self.categorical_feature
        if cf == "auto" or cf is None:
            return []
        out = []
        for c in cf:
            if isinstance(c, str):
                if c in feature_names:
                    out.append(feature_names.index(c))
                else:
                    log.warning(f"Unknown categorical feature {c}")
            else:
                out.append(int(c))
        return out

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Set categorical features; they bind at construct (reference
        basic.py Dataset.set_categorical_feature)."""
        if self.categorical_feature == categorical_feature:
            return self
        if self._binned is not None:
            raise LightGBMError(
                "Cannot set categorical feature after the Dataset was "
                "constructed; set it at creation"
            )
        self.categorical_feature = categorical_feature
        return self

    def construct(self) -> "Dataset":
        """Bin the matrix (host numpy). Like train, this refuses to run
        when the card is asked for (device_type default) and torch sees
        none: the port never carries on quietly on the CPU."""
        if self._binned is not None:
            return self
        # a validation set takes its reference's parameters (device,
        # row block) unless it sets its own
        base = self.reference.params if self.reference is not None else {}
        cfg = Config({**base, **self.params})
        resolve_device(cfg)
        if self.data is None:
            raise LightGBMError("Cannot construct Dataset: raw data was freed")
        arr = _to_2d_numpy(self.data)
        names = ([str(n) for n in self.feature_name]
                 if isinstance(self.feature_name, list) else None)
        cat = self._resolve_categorical(
            names or [f"Column_{i}" for i in range(arr.shape[1])])
        ref_binned = None
        if self.reference is not None:
            self.reference.construct()
            ref_binned = self.reference._binned
        self._binned = BinnedDataset.from_numpy(
            arr, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, position=self.position,
            feature_names=names,
            categorical_feature=cat, reference=ref_binned,
        )
        if self.free_raw_data:
            self.data = None
        return self

    # the query metadata (the JAX package's basic.py:557-597): set before
    # or after construct; after it, the binned metadata changes too
    def set_group(self, group) -> "Dataset":
        self.group = _to_1d(group)
        if self._binned is not None:
            self._binned.metadata.group = (
                None if group is None else np.asarray(self.group, np.int64))
        return self

    def set_position(self, position) -> "Dataset":
        self.position = _to_1d(position)
        if self._binned is not None:
            self._binned.metadata.position = (
                None if position is None
                else np.asarray(self.position, np.int32))
        return self

    def get_group(self):
        return self.group

    def get_position(self):
        return self.position


class Booster:
    """Booster wrapper (reference basic.py:3543)."""

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        train_set: Optional[Dataset] = None,
        model_file: Optional[Union[str, Path]] = None,
        model_str: Optional[str] = None,
    ):
        self.params = copy.deepcopy(params) or {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            from .boosting import GBDT
            from .config import DATASET_PARAMS, resolve_alias

            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            ds_part = {k: v for k, v in train_set.params.items()
                       if resolve_alias(k) in DATASET_PARAMS}
            self.config = Config({**ds_part, **self.params})
            self._gbdt = GBDT(self.config, train_set._binned)
            self.train_set = train_set
            self._valid_sets: List[Dataset] = []
            self._name_valid_sets: List[str] = []
        elif model_file is not None or model_str is not None:
            from .model_io import load_model_string

            if model_file is not None:
                model_str = Path(model_file).read_text()
            self.config, self._gbdt = load_model_string(model_str)
            self.train_set = None
            self._valid_sets = []
            self._name_valid_sets = []
        else:
            raise TypeError("At least one of train_set, model_file or "
                            "model_str should be not None.")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        if data.reference is not self.train_set:
            data.reference = self.train_set
        data.construct()
        self._gbdt.add_valid(data._binned, name)
        self._valid_sets.append(data)
        self._name_valid_sets.append(name)
        return self

    def _continue_from(self, init_booster: "Booster") -> None:
        """Continued training (reference input_model / python init_model,
        boosting.h:311; the JAX package's Booster._continue_from): adopt
        the loaded model's trees, count their iterations in iter_ (every
        draw keys on the global iteration), and seed every score set with
        their binned-traversal predictions. Call after add_valid."""
        from .tree import tree_to_arrays

        gb = self._gbdt
        src = init_booster._gbdt
        K = gb.num_class
        if src.num_class != K:
            log.fatal(f"init_model has {src.num_class} models per "
                      f"iteration, training config has {K}")
        models = list(src.models)
        gb.models = list(models)
        gb.iter_ = gb._init_iters = len(models) // K
        for mi, t in enumerate(models):
            arrays = tree_to_arrays(t, gb.train_set, gb.device)
            gb.device_trees.append(arrays)
            k = mi % K
            for ss in [gb.train] + gb.valids:
                if t.num_leaves > 1:
                    leaf = gb._traverse(arrays, ss.dev)
                    ss.score[k] += arrays.leaf_value[leaf.long()]
                else:
                    ss.score[k] += float(t.leaf_value[0])

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True if training stopped. fobj(preds,
        train_set) -> (grad, hess) over the raw training scores."""
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Resetting train_set is not supported")
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self._inner_predict_raw(0), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New parameters between iterations: the learning rate and the
        split parameters are derived anew; the sampling strategy and the
        feature sampler read the live config."""
        from .learner.grower import make_split_params

        self.params.update(params)
        self.config.update(params)
        self._gbdt.shrinkage_rate = self.config.learning_rate
        self._gbdt.params = make_split_params(self.config)
        return self

    def _inner_predict_raw(self, data_idx: int) -> np.ndarray:
        """The raw scores of the training set (0) or a validation set."""
        g = self._gbdt
        ss = g.train if data_idx == 0 else g.valids[data_idx - 1]
        score = g.get_score(ss)
        return score if g.num_class > 1 else score[0]

    def eval_train(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        out = [(self._train_data_name, n, v, hb)
               for (_dn, n, v, hb) in self._gbdt.eval_train()]
        if feval is not None:
            out.extend(self._run_feval(feval, 0, self._train_data_name))
        return out

    def eval_valid(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        out = self._gbdt.eval_valid()
        if feval is not None:
            for i, name in enumerate(self._name_valid_sets):
                out.extend(self._run_feval(feval, i + 1, name))
        return out

    def _run_feval(self, feval, data_idx: int, name: str):
        """feval(preds, dataset) -> (name, value, higher_better) or a list
        of them; one callable or a list. preds are the converted scores
        (GetPredictAt -> ConvertOutput, gbdt.cpp:709); objective none
        converts nothing."""
        ds = self.train_set if data_idx == 0 else \
            self._valid_sets[data_idx - 1]
        preds = self._inner_predict_raw(data_idx)
        if self._gbdt.objective is not None:
            preds = self._gbdt.objective.convert_output(preds)
        results = []
        for f in feval if isinstance(feval, (list, tuple)) else [feval]:
            res = f(preds, ds)
            results.extend(res if isinstance(res, list) else [res])
        return [(name, rn, rv, rhb) for rn, rv, rhb in results]

    def predict(self, data: Any, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                validate_features: bool = False,
                device: Optional[str] = None, **kwargs: Any) -> np.ndarray:
        """Predictions of the host walker (device None / "cpu" / "host"),
        or of the tensorized forest on the card (device "cuda", "gpu" or
        "tpu"; it raises when torch sees no card). pred_leaf gives the
        (N, trees) leaf indices, pred_contrib the (N, K * (F + 1)) SHAP
        values of host TreeSHAP, which has no device version behind this
        entry point (a warning says so under device=; the forest's
        device TreeSHAP is serving's contrib op). validate_features is
        accepted and, as in the JAX package on a dense matrix, checks
        nothing: a numpy matrix carries no feature names."""
        other = set(kwargs) - set(_EARLY_STOP_KEYS)
        if other:
            raise NotImplementedError(
                f"prediction options {sorted(other)} are not ported yet "
                "(ROADMAP queue A)")
        arr = _to_2d_numpy(data)
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        g = self._gbdt
        if device not in (None, "", "cpu", "host"):
            from .serving.forest import serve_device

            dev = serve_device(device)  # raises without a card
            if pred_contrib:
                log.warning("pred_contrib has no device implementation; "
                            "using the host SHAP path")
            elif kwargs.get("pred_early_stop",
                            self.params.get("pred_early_stop", False)):
                log.warning("pred_early_stop has no device implementation; "
                            "using the host predictor")
            else:
                from .serving.forest import TensorForest

                forest = TensorForest.from_booster(self, device=dev)
                if pred_leaf:
                    return forest.predict_leaf(arr, start_iteration,
                                               num_iteration)
                raw = forest.predict_raw(arr, start_iteration, num_iteration)
                if not raw_score:
                    raw = g.convert_output(raw)
                return raw[0] if g.num_class == 1 else raw.T
        if pred_leaf:
            return g.predict_leaf_index(arr, start_iteration, num_iteration)
        if pred_contrib:
            if any(t.is_linear for t in g.models):
                log.fatal("pred_contrib (SHAP) is not supported for models "
                          "with linear trees")
            return g.predict_contrib(arr, start_iteration, num_iteration)
        return g.predict(arr, start_iteration, num_iteration,
                         raw_score=raw_score,
                         early_stop=self._early_stop(kwargs))

    def _early_stop(self, kwargs) -> Optional[Tuple[int, float]]:
        """The per-row prediction early stop (prediction_early_stop.cpp)
        as the JAX package's predict reads it: kwargs first, then the
        Booster's params; (freq, margin) for classification, else None
        with a warning."""
        keys = dict(zip(_EARLY_STOP_KEYS, (False, 10, 10.0)))
        get = lambda k: kwargs.get(k, self.params.get(k, keys[k]))
        if not get("pred_early_stop"):
            return None
        if not (self._gbdt.num_class > 1 or getattr(
                self.config, "objective", "") in (
                    "binary", "cross_entropy", "cross_entropy_lambda")):
            log.warning("pred_early_stop only applies to classification; "
                        "ignored")
            return None
        return (int(get("pred_early_stop_freq")),
                float(get("pred_early_stop_margin")))

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .model_io import save_model_string

        ni = num_iteration
        if ni is None:
            ni = self.best_iteration if self.best_iteration > 0 else -1
        return save_model_string(self._gbdt, self.config, ni, start_iteration)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0, importance_type: str = "split",
                   object_hook=None) -> Dict[str, Any]:
        """The JSON model (LGBM_BoosterDumpModel) as a dict; object_hook
        is applied as json.loads applies it, bottom-up over every
        dict."""
        from .model_io import dump_model_dict

        ni = num_iteration
        if ni is None:
            ni = self.best_iteration if self.best_iteration > 0 else -1
        d = dump_model_dict(self._gbdt, self.config, ni, start_iteration,
                            importance_type)
        if object_hook is not None:
            import json

            d = json.loads(json.dumps(d), object_hook=object_hook)
        return d

    @classmethod
    def _from_loaded(cls, config: Config, gbdt) -> "Booster":
        """A prediction-capable Booster around a loaded (config, GBDT),
        as load_model_dict returns them."""
        b = cls.__new__(cls)
        b.params, b.best_iteration, b.best_score = {}, -1, {}
        b._train_data_name = "training"
        b.config, b._gbdt = config, gbdt
        b.train_set, b._valid_sets, b._name_valid_sets = None, [], []
        return b

    def save_model(self, filename: Union[str, Path],
                   num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        Path(filename).write_text(
            self.model_to_string(num_iteration, start_iteration))
        return self
