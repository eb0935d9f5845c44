"""Model registry: load / version / hot-swap Boosters behind one scoring
entry point.

The port of lightgbm_tpu/serving/registry.py. Per model NAME the
registry keeps a monotonically versioned list of (Booster, TensorForest,
BucketDispatcher replicas) and an ACTIVE version pointer:

- ``load`` accepts a text model file, a ``.json`` dump file, a raw model
  string, a dump dict, or a live Booster (text / JSON via model_io.py)
  and builds the device tables and the dispatchers;
- ``swap`` / ``rollback`` move the active pointer atomically (a pointer
  write under the registry lock: in-flight requests on the old version
  finish on the old tables and graphs, which stay alive until
  ``unload``);
- ``predict`` scores on whatever version is active at call time.

``replicas`` > 1 builds that many dispatchers per version over one set
of tables on the one card: each replica has its own CUDA stream and its
own graphs (one per rung), so their calls overlap on the card; direct
predicts round-robin over them and the MicroBatcher runs one worker per
replica.

``host_fallback=True`` rescores a chunk whose host-to-device copy
failed on the host walker (Booster.predict on the host: the native
library's walk for the scores, the numpy walk for the leaf indices),
counted in ``lgbmtpu_serve_host_fallback_total`` (dispatch.py). A
capture, launch or replay error is never answered on the host: it
propagates and ``device_faults()`` keeps it (/readyz: not ready). A load
on the card builds the kernels first, so a kernel that does not build
raises at load, fallback or not.

Deviations from the JAX package: ``host_fallback`` defaults to False
(the JAX package's to True), so a device fault is an error unless the
caller asks for the fallback; ``mesh`` (a parallel.comm.Mesh) shards
every model's rows over its ranks (forest.TensorForest; the ranks serve
the same requests in lockstep).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .. import log
from ..obs.metrics import record_registry_event
from .dispatch import DEFAULT_BUCKETS, BucketDispatcher
from .forest import TensorForest, serve_device


@dataclass
class ModelVersion:
    version: int
    booster: Any
    forest: TensorForest
    dispatcher: BucketDispatcher
    source: str
    loaded_at: float = field(default_factory=time.time)
    batcher: Any = None  # lazy MicroBatcher (predict via_queue=True)
    # replica dispatchers (dispatcher is replicas[0]); direct predicts
    # round-robin over these, via_queue drains through all of them
    replicas: List[BucketDispatcher] = field(default_factory=list)


def _booster_from(source: Any):
    """Anything model-shaped -> Booster (text or JSON via model_io)."""
    from ..basic import Booster

    if isinstance(source, Booster):
        return source, "booster"
    if isinstance(source, dict):
        from ..convert import booster_from_model_dict

        return booster_from_model_dict(source), "json-dict"
    s = str(source)
    # a model STRING always spans many lines; a path never does (so a
    # file named tree_v2.txt is not misread as an inline model)
    if s.lstrip().startswith("tree") and "\n" in s:
        return Booster(model_str=s), "model-string"
    if s.endswith(".json"):
        import json
        from pathlib import Path

        return _booster_from(json.loads(Path(s).read_text()))[0], s
    return Booster(model_file=s), s


def _make_host_fallback(booster, forest):
    """BucketDispatcher.host_fallback: score a chunk with the host walker
    (Booster.predict's default, no card in the loop) in the dispatcher's
    layout: summed raw margins (n, K) (the dispatcher divides an
    average_output model itself) and the (n, T) leaf matrix with the used
    trees in place."""
    K = forest.num_class
    T = forest.num_trees

    def fallback(chunk, start, end):
        n = chunk.shape[0]
        ni = end - start if end > start else -1
        raw = booster.predict(chunk, start_iteration=start,
                              num_iteration=ni, raw_score=True)
        raw = np.asarray(raw, np.float64).reshape(n, K)
        if forest.average_output and end > start:
            raw = raw * (end - start)
        leaf = booster.predict(chunk, start_iteration=start,
                               num_iteration=ni, pred_leaf=True)
        leaf_full = np.zeros((n, T), np.int64)
        leaf_full[:, start * K: end * K] = np.asarray(
            leaf, np.int64).reshape(n, -1)
        return raw, leaf_full

    return fallback


def build_kernels(device) -> None:
    """Build and load the CUDA kernels now when serving on the card, so a
    build failure raises at load and never reaches the host fallback."""
    if device.type == "cuda":
        from ..learner import cuda_hist

        cuda_hist.load()


def _declared_width(booster) -> Optional[int]:
    """The model's feature count: the training set's, or the model
    text's feature names (None when neither says)."""
    g = booster._gbdt
    if g.train_set is not None:
        return g.train_set.num_total_features
    return len(getattr(g, "feature_names", []) or []) or None


class ModelRegistry:
    """Thread-safe named + versioned model store."""

    # the online loop's attachment points (OnlineLoop.attach): the
    # transports route the ingest op to ingest_sink, and /readyz reads
    # health_probe
    ingest_sink = None
    health_probe = None

    def __init__(self, mesh=None, buckets=DEFAULT_BUCKETS,
                 warmup: bool = False, deadline_s: float = 0.0,
                 queue_cap: int = 0, host_fallback: bool = False,
                 replicas: int = 1, device="cuda"):
        self.mesh = mesh
        self.device = serve_device(device)
        self.host_fallback = bool(host_fallback)
        self.buckets = tuple(int(b) for b in buckets)
        self.default_warmup = bool(warmup)
        self.replicas = max(int(replicas), 1)
        # default queue deadline + admission cap for every lazily built
        # MicroBatcher
        self.deadline_s = float(deadline_s)
        self.queue_cap = int(queue_cap)
        self._lock = threading.RLock()
        self._models: Dict[str, List[ModelVersion]] = {}
        self._active: Dict[str, int] = {}
        self._rr = 0  # round-robin cursor for direct replica predicts

    # ------------------------------------------------------------------
    def load(self, name: str, source: Any, *, activate: bool = True,
             warmup: Optional[bool] = None,
             num_features: Optional[int] = None) -> int:
        """Build device tables for a model and register a new version.

        Packing, captures and warm-up happen OUTSIDE the lock: a load
        never stalls scoring on already-active models."""
        booster, src = _booster_from(source)
        build_kernels(self.device)
        forest = TensorForest.from_booster(booster, device=self.device,
                                           mesh=self.mesh)
        dispatchers = [
            BucketDispatcher(
                forest, self.buckets,
                name=f"serve:{name}" if i == 0 else f"serve:{name}:r{i}",
            )
            for i in range(self.replicas)
        ]
        if self.host_fallback:
            fb = _make_host_fallback(booster, forest)
            for d in dispatchers:
                d.host_fallback = fb
        do_warm = self.default_warmup if warmup is None else warmup
        if do_warm:
            if num_features is None:
                # warm at the model's DECLARED width (protocol rows carry
                # every column): max_feature+1 would be too narrow, and
                # each rung would capture again on the first real batch
                num_features = _declared_width(booster)
            for d in dispatchers:  # each replica captures its own graphs
                d.warmup(num_features)
        with self._lock:
            versions = self._models.setdefault(name, [])
            v = (versions[-1].version + 1) if versions else 1
            versions.append(ModelVersion(
                v, booster, forest, dispatchers[0], src,
                replicas=dispatchers,
            ))
            if activate or name not in self._active:
                self._active[name] = v
        record_registry_event("load", name)
        log.info(f"serving registry: loaded {name!r} v{v} from {src}")
        return v

    def _entry(self, name: str, version: Optional[int] = None) -> ModelVersion:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}")
            v = self._active[name] if version is None else int(version)
            for mv in self._models[name]:
                if mv.version == v:
                    return mv
            raise KeyError(f"model {name!r} has no version {v}")

    def swap(self, name: str, version: int) -> None:
        """Atomically point `name` at an already-loaded version."""
        with self._lock:
            mv = self._entry(name, version)
            self._active[name] = mv.version
        record_registry_event("swap", name)

    def rollback(self, name: str) -> int:
        """Activate the newest version BELOW the active one."""
        with self._lock:
            cur = self._active[name]
            older = [mv.version for mv in self._models[name]
                     if mv.version < cur]
            if not older:
                raise KeyError(f"model {name!r} has no version below {cur}")
            self._active[name] = max(older)
            active = self._active[name]
        record_registry_event("rollback", name)
        return active

    def unload(self, name: str, version: Optional[int] = None) -> None:
        """Drop one version (or the whole name); the active version of a
        name can only be dropped by dropping the name. Dropped versions'
        microbatch workers are closed, so unload really releases the
        tables and graphs (a parked worker thread would pin them)."""
        dropped: List[ModelVersion] = []
        with self._lock:
            if version is None:
                dropped = self._models.pop(name, [])
                self._active.pop(name, None)
            else:
                if self._active.get(name) == int(version):
                    raise ValueError(
                        f"version {version} of {name!r} is active; swap "
                        "first or unload the whole name"
                    )
                kept = []
                for mv in self._models.get(name, []):
                    (kept if mv.version != int(version)
                     else dropped).append(mv)
                self._models[name] = kept
        for mv in dropped:  # outside the lock: close() joins the workers
            if mv.batcher is not None:
                mv.batcher.close()
        if dropped:
            record_registry_event("unload", name)

    def models(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "active": self._active.get(name),
                    "versions": [
                        {"version": mv.version, "source": mv.source,
                         "num_trees": mv.forest.num_trees,
                         "num_class": mv.forest.num_class,
                         "loaded_at": mv.loaded_at}
                        for mv in versions
                    ],
                }
                for name, versions in self._models.items()
            }

    def device_faults(self) -> Dict[str, str]:
        """"name:vN" -> the last capture, launch or replay error of one of
        the version's dispatchers; /readyz is not ready while any is
        kept (a host fallback never clears one)."""
        with self._lock:
            return {f"{name}:v{mv.version}": d.device_error
                    for name, versions in self._models.items()
                    for mv in versions
                    for d in (mv.replicas or [mv.dispatcher])
                    if d.device_error}

    def stats(self) -> Dict[str, Any]:
        # one pass under the lock (like models()): resolving entries
        # after releasing it would let a concurrent unload turn the
        # whole stats request into a KeyError
        with self._lock:
            return {
                name: self._entry(name).dispatcher.stats()
                for name in self._models
            }

    def _batcher_for(self, name: str, mv) -> Optional[Any]:
        """The version's MicroBatcher, created lazily under the lock;
        None when mv was unloaded concurrently (a fresh worker thread
        nothing would ever close must not be resurrected)."""
        with self._lock:
            if not any(m is mv for m in self._models.get(name, [])):
                return None
            if mv.batcher is None:
                from .dispatch import MicroBatcher

                mv.batcher = MicroBatcher(
                    mv.replicas or mv.dispatcher,
                    deadline_s=self.deadline_s,
                    queue_cap=self.queue_cap,
                )
            return mv.batcher

    def batcher(self, name: str, version: Optional[int] = None):
        """The model's continuous-batching front (the MicroBatcher that
        ``predict(via_queue=True)`` coalesces through, drained by one
        worker per replica). Async clients ``submit(rows)`` and collect
        futures, each resolving to that request's (n, K) RAW margins."""
        mv = self._entry(name, version)
        b = self._batcher_for(name, mv)
        if b is None:
            raise KeyError(f"model {name!r} was unloaded")
        return b

    # ------------------------------------------------------------------
    def predict(self, name: str, X, *, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False,
                via_queue: bool = False,
                version: Optional[int] = None,
                deadline_s: Optional[float] = None) -> np.ndarray:
        """One scoring entry point for every registered model; output
        layout matches Booster.predict ((N,) single-class, (N, K)
        multiclass, (N, T) for pred_leaf, (N, K*(F+1)) for pred_contrib
        — device TreeSHAP).

        via_queue=True routes default-parameter scoring through the
        version's MicroBatcher, so concurrent callers coalesce into
        shared padded device calls; truncated, pred_leaf and
        pred_contrib requests always dispatch directly (a coalesced
        batch shares one parameter set)."""
        mv = self._entry(name, version)
        if pred_leaf:
            return mv.dispatcher.predict_leaf(
                X, start_iteration, num_iteration
            )
        if pred_contrib:
            # an explanation, not a margin: no objective transform, no
            # queue coalescing (its ladder cap differs)
            return mv.dispatcher.predict_contrib(
                X, start_iteration, num_iteration
            )
        batcher = None
        if via_queue and start_iteration == 0 and num_iteration == -1:
            batcher = self._batcher_for(name, mv)
        if batcher is not None:
            # per-request deadline overrides the registry default;
            # QueueOverflow / DeadlineExceeded propagate to the caller
            raw = batcher.submit(X, deadline_s=deadline_s).result().T
        else:
            d = mv.dispatcher
            if len(mv.replicas) > 1:
                with self._lock:
                    self._rr += 1
                    d = mv.replicas[self._rr % len(mv.replicas)]
            raw = d.score_raw(X, start_iteration, num_iteration)
        if not raw_score:
            raw = mv.booster._gbdt.convert_output(raw)
        return raw[0] if mv.forest.num_class == 1 else raw.T
