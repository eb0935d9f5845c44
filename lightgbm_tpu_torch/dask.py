"""Dask-compatible estimators (reference python-package/lightgbm/dask.py:
DaskLGBMClassifier:1159, DaskLGBMRegressor:1421, DaskLGBMRanker:1646).

The port of lightgbm_tpu/dask.py. The reference runs one
socket-connected LightGBM rank inside each Dask worker (`_train`,
dask.py:415). Here, as in the JAX package, the distributed substrate is
the port's own (parallel/: torch.distributed ranks, one device each,
joined by set_network or run_distributed), not a Dask scheduler. The
classes keep the reference's API shape (``client=`` accepted, Dask
collections accepted) and *materialize* the collection for the
estimator they extend.

They work with or without dask installed: any object exposing
``.compute()`` (dask.array / dataframe) is materialized, plain numpy /
pandas passes through. Under data_source=chunked a partition-aware
collection (``.to_delayed()``) is spooled one partition at a time into
the data plane's chunk store (data/store.py) instead.
"""

from __future__ import annotations

from typing import Any, Optional

from .sklearn import LGBMClassifier, LGBMRanker, LGBMRegressor

__all__ = ["DaskLGBMClassifier", "DaskLGBMRegressor", "DaskLGBMRanker"]


def _materialize(obj: Any):
    """Dask collection -> concrete array/frame; anything else unchanged."""
    if obj is None:
        return None
    compute = getattr(obj, "compute", None)
    if callable(compute):
        return compute()
    return obj


def _spool_partitions(X: Any, params: dict):
    """Dask collection -> SpooledData, one partition at a time.

    The out-of-core alternative to `_materialize`'s whole-collection
    gather: each delayed partition is computed and
    appended to a disk-backed chunk store, so host memory holds one
    partition + one buffered chunk instead of the full collection.
    Returns None when X is not partition-aware (plain arrays, or the
    store is off) — callers then keep the legacy single-process
    materialize semantics."""
    to_delayed = getattr(X, "to_delayed", None)
    if not callable(to_delayed):
        return None
    import numpy as np

    from .config import Config
    from .data.store import ChunkStore, SpooledData
    from .data.streaming import _spool_root, resolve_chunk_rows

    cfg = Config({
        k: params[k] for k in
        ("data_source", "ram_budget_mb", "data_chunk_rows",
         "data_spool_dir")
        if params.get(k) is not None
    })
    # dask.array -> (row_chunks, col_chunks) object grid;
    # dask.dataframe -> flat list of partitions
    grid = np.asarray(to_delayed(), dtype=object)
    if grid.ndim == 0:
        grid = grid.reshape(1, 1)
    elif grid.ndim == 1:
        grid = grid.reshape(-1, 1)
    _owned, root = _spool_root(cfg)
    store = None
    for row in grid:
        blocks = [np.asarray(_materialize(b)) for b in row]
        block = (
            blocks[0] if len(blocks) == 1
            else np.concatenate(
                [b.reshape(b.shape[0], -1) for b in blocks], axis=1
            )
        )
        if block.ndim == 1:
            block = block.reshape(-1, 1)
        if store is None:
            store = ChunkStore.create(
                root / "raw", n_features=block.shape[1],
                chunk_rows=resolve_chunk_rows(block.shape[1], cfg),
            )
        store.append_rows(block)
    if store is None:
        return None
    return SpooledData(store.finalize())


class _DaskMixin:
    """client= plumbing shared by the three estimators.

    sklearn's get_params introspects ``__init__`` and rejects varargs,
    so each estimator restates the explicit LGBMModel signature
    (sklearn.py) plus ``client``, as the reference's Dask classes do."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective: Optional[Any] = None,
        class_weight: Optional[Any] = None,
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
        client: Optional[Any] = None,
        **kwargs: Any,
    ):
        self.client = client
        super().__init__(
            boosting_type=boosting_type,
            num_leaves=num_leaves,
            max_depth=max_depth,
            learning_rate=learning_rate,
            n_estimators=n_estimators,
            subsample_for_bin=subsample_for_bin,
            objective=objective,
            class_weight=class_weight,
            min_split_gain=min_split_gain,
            min_child_weight=min_child_weight,
            min_child_samples=min_child_samples,
            subsample=subsample,
            subsample_freq=subsample_freq,
            colsample_bytree=colsample_bytree,
            reg_alpha=reg_alpha,
            reg_lambda=reg_lambda,
            random_state=random_state,
            n_jobs=n_jobs,
            importance_type=importance_type,
            **kwargs,
        )

    @property
    def client_(self) -> Any:
        """The Dask client passed at construction (reference
        dask.py `client_`; informational here: training runs on the
        port's own ranks, see the module docstring)."""
        if self.client is None:
            raise AttributeError("no Dask client was provided")
        return self.client

    def _materialize_fit_args(self, kwargs):
        es = kwargs.get("eval_set")
        if es is not None:
            kwargs["eval_set"] = [
                (_materialize(a), _materialize(b)) for a, b in es
            ]
        for key in ("sample_weight", "init_score", "group"):
            if kwargs.get(key) is not None:
                kwargs[key] = _materialize(kwargs[key])
        for key in ("eval_sample_weight", "eval_init_score", "eval_group"):
            val = kwargs.get(key)
            if val is None:
                continue
            # standard form: one entry per eval set — materialize each;
            # a bare collection is materialized whole
            if isinstance(val, (list, tuple)):
                kwargs[key] = [_materialize(v) for v in val]
            else:
                kwargs[key] = _materialize(val)
        return kwargs

    def fit(self, X, y, **kwargs):  # noqa: D102 - see class docstring
        if self._other_params.get("data_source") == "chunked":
            spooled = _spool_partitions(X, self.get_params())
            if spooled is not None:
                X = spooled
        return super().fit(
            _materialize(X), _materialize(y),
            **self._materialize_fit_args(dict(kwargs)),
        )

    def predict(self, X, *args, **kwargs):  # noqa: D102
        return super().predict(_materialize(X), *args, **kwargs)


class DaskLGBMClassifier(_DaskMixin, LGBMClassifier):
    """Classifier accepting Dask collections (reference dask.py:1159)."""

    def predict_proba(self, X, *args, **kwargs):  # noqa: D102
        return super().predict_proba(_materialize(X), *args, **kwargs)


class DaskLGBMRegressor(_DaskMixin, LGBMRegressor):
    """Regressor accepting Dask collections (reference dask.py:1421)."""


class DaskLGBMRanker(_DaskMixin, LGBMRanker):
    """Ranker accepting Dask collections (reference dask.py:1646)."""
