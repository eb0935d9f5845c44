"""Bucket-batched scoring dispatcher + thread-safe microbatch queue.

The port of lightgbm_tpu/serving/dispatch.py. Serving traffic arrives in
arbitrary batch sizes. The dispatcher pads every request up to a small
fixed ladder of row counts (config.DEFAULT_SERVE_BUCKETS) and chunks
oversized batches into top-rung pieces, so no request shape escapes the
ladder. Where the JAX package bounds its XLA compiles by the ladder, the
port bounds its CUDA graphs by it: on the card each (rung, width) is one
CUDA graph of the whole forest_apply (every traversal level, the leaf
gather, the class sums), captured at warmup() or at its first use and
replayed after that. A graph reads its rows and its (T,) tree weights
from static buffers that each call overwrites, so start_iteration /
num_iteration change a buffer, never a capture; `captures` counts the
captures (the JAX package's retrace guard's counterpart). Nothing is
read back to the host inside a graph; a capture that fails raises.

Each dispatcher owns a CUDA stream of its own, so replicas of one model
(serving/registry.py) score concurrently on one card; calls into one
dispatcher are serialized by its lock (its buffers are shared). On the
CPU the same padded calls run directly, with no graph.

The programs, their lock and their stream form a ProgramSet. The model
fleet (serving/fleet.py) gives every tenant of one family stack a
dispatcher of its own (its stats, its rows' width check) over the
stack's one ProgramSet: a call binds the tenant first (forest.bind(),
which writes its slot into the stack's slot buffer) and replays the
family's graph, all under the set's lock.

``MicroBatcher`` is the queueing half: callers ``submit()`` rows from any
thread and get a Future; one worker per dispatcher drains the queue,
coalesces pending requests into one padded device call, and fans the
rows of the result back out, with admission control (QueueOverflow),
per-request deadlines (DeadlineExceeded) and ShutdownError on close().

A chunk whose host-to-device copy fails (an injected fault at the
``device_put`` site, or the card out of memory) degrades to the host
walker when ``host_fallback`` is set (ModelRegistry / ModelFleet
``host_fallback=True``): slower, warned once and counted in
``lgbmtpu_serve_host_fallback_total``, but the request answers. Without
it the error propagates. Any other error of the device call (a capture,
launch or replay, after which the card may be in a sticky error state)
always propagates, and the dispatcher keeps it in ``device_error``,
which /readyz reports as not ready (an out-of-memory error propagates
too, and is not kept). A row-sharded forest (mesh=) aligns the rungs
to multiples of its ranks and runs uncaptured: its collectives leave the
card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_SERVE_BUCKETS as DEFAULT_BUCKETS
from .. import log
from ..obs.metrics import (
    record_bucket_dispatch,
    record_coalesce,
    record_host_fallback,
    record_queue_depth,
    record_serve_rejection,
)
from ..resilience.errors import (
    DeadlineExceeded,
    InjectedFault,
    QueueOverflow,
    ShutdownError,
)
from ..resilience.faultinject import fault_point
from ..timer import latency_stats

# cap on rows per device TreeSHAP call: contrib intermediates are
# (rows, trees, leaves, path) tensors, ~leaves x path larger per row
# than scoring
CONTRIB_MAX_ROWS = 256

# one capture at a time in the process: a capture turns the garbage
# collector off and on again (CudaGraph.capture), which is process-wide,
# and replicas that capture their rungs at first use do so from their
# own worker threads
_CAPTURE_LOCK = threading.Lock()


class ProgramSet:
    """The rungs' programs of one table set, with the lock and the CUDA
    stream that every call into them takes. A dispatcher owns one; the
    fleet's tenants of one family stack share theirs (their graphs read
    the stack's slot buffer), so a family captures each rung once
    however many tenants page through it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.lock = threading.Lock()
        self.by_shape: Dict[Tuple[int, int], "_Program"] = {}
        self.captures = 0  # CUDA graphs captured (one per rung and width)

    def scope(self):
        """The set's stream as torch's current stream (the CPU: none)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


@dataclass
class _Program:
    """One rung's static buffers and, on the card, its CUDA graph and the
    graph's outputs (allocated in the graph's memory pool)."""

    x: torch.Tensor
    tree_w: torch.Tensor
    graph: Any = None
    score: Optional[torch.Tensor] = None
    leaf: Optional[torch.Tensor] = None


class BucketDispatcher:
    """Pads requests to a fixed shape ladder and scores on the forest's
    device (one CUDA graph per rung on the card)."""

    def __init__(self, forest, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 name: str = "serve", model: Optional[str] = None,
                 programs: Optional[ProgramSet] = None):
        if not buckets:
            raise ValueError("need at least one bucket size")
        n_dev = max(int(getattr(forest, "num_devices", 1)), 1)
        # every rung must shard evenly over a mesh's ranks
        aligned = sorted({-(-max(int(b), 1) // n_dev) * n_dev
                          for b in buckets})
        if aligned != sorted({max(int(b), 1) for b in buckets}):
            log.warning(
                f"serving buckets {sorted(int(b) for b in buckets)} "
                f"realigned to {aligned} (a mesh of {n_dev} ranks needs "
                "row counts divisible by the rank count)")
        self.buckets: Tuple[int, ...] = tuple(aligned)
        self.forest = forest
        self.name = name
        self.device = forest.device
        self._cuda = self.device.type == "cuda"
        # a row-sharded forest's collectives cannot be captured
        self._capture = (self._cuda
                         and getattr(forest, "mesh", None) is None)
        self._stats = latency_stats(name, model=model)
        # the rungs' programs, lock and stream: the dispatcher's own, or a
        # fleet family's, shared with its other tenants
        self.program_set = programs if programs is not None else \
            ProgramSet(self.device)
        # (rows, start, end) -> (raw (n, K) sums, leaves (n, T)) on the
        # host, for a chunk whose host-to-device copy failed (registry.py)
        self.host_fallback = None
        self._fallback_warned = False
        # the last capture / launch / replay error (None: healthy)
        self.device_error: Optional[str] = None
        self.stream = self.program_set.stream
        self._lock = self.program_set.lock
        self._programs = self.program_set.by_shape

    @property
    def captures(self) -> int:
        """CUDA graphs captured for this dispatcher's programs (one per
        rung and width; a fleet family's, for all its tenants)."""
        return self.program_set.captures

    # ------------------------------------------------------------------
    @property
    def programs(self) -> Tuple[Tuple[int, int], ...]:
        """The (rows, width) shapes built so far, one per rung used."""
        return tuple(sorted(self._programs))

    def graph_nodes(self) -> Dict[int, int]:
        """Nodes of each rung's CUDA graph (empty on the CPU)."""
        return {b: p.graph.nodes for (b, _), p in self._programs.items()
                if p.graph is not None}

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n, else the largest (caller chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _scope(self):
        return self.program_set.scope()

    def _program(self, b: int, F: int) -> _Program:
        """The rung's program, built at first use (caller holds the lock
        and the dispatcher's stream)."""
        prog = self._programs.get((b, F))
        if prog is not None:
            return prog
        f = self.forest
        prog = _Program(
            x=torch.zeros((b, F), dtype=torch.float32, device=self.device),
            tree_w=torch.ones(f.weight_len, dtype=torch.float32,
                              device=self.device))
        if self._capture:
            from ..learner.device_loop import CudaGraph

            with _CAPTURE_LOCK:
                # one uncaptured call first: it loads the kernels, so
                # nothing is loaded or built inside the capture
                f.apply(prog.x, prog.tree_w)
                graph = CudaGraph(self.device)
                outs: List[torch.Tensor] = []
                graph.capture(lambda _loop: outs.extend(
                    f.apply(prog.x, prog.tree_w)))
            prog.graph, (prog.score, prog.leaf) = graph, outs
            self.program_set.captures += 1
        self._programs[(b, F)] = prog
        return prog

    def warmup(self, num_features: Optional[int] = None) -> None:
        """Build every rung up front (on the card: capture its graph), so
        no capture lands on the serving path. num_features defaults to
        the forest's widest referenced feature + 1; pass the true width
        when it is larger, or the first real batch captures again."""
        F = max(self.forest.max_feature + 1, 1) \
            if num_features is None else int(num_features)
        with self._lock, self._scope():
            for b in self.buckets:
                self._program(b, F)
            if self._cuda:
                self.stream.synchronize()

    def warm_rung(self, b: int, num_features: int) -> None:
        """Build rung b's program for rows of num_features (on the card:
        capture its graph the first time) and run it once for this
        forest, waiting for the card: the fleet's page-in, after which a
        request is pure scoring."""
        with self._lock, self._scope():
            prog = self._program(self.bucket_for(int(b)), int(num_features))
            self.forest.bind()
            if prog.graph is not None:
                prog.graph.replay()
            else:
                self.forest.apply(prog.x, prog.tree_w)
            if self._cuda:
                self.stream.synchronize()

    # ------------------------------------------------------------------
    def _bucketed_chunks(self, X: np.ndarray, tw: np.ndarray, start: int,
                         end: int):
        """Yield (score (n,K), leaf (n,T)) per top-rung chunk, each scored
        at its padded ladder shape: EVERY device call of the dispatcher
        goes through here, so no request shape escapes the ladder. A
        chunk whose host-to-device copy fails is scored by host_fallback
        when one is set (module docstring); any other device error
        propagates and is kept in device_error."""
        N, F = X.shape
        top = self.buckets[-1]
        twt = torch.from_numpy(tw)
        for pos in range(0, N, top):
            chunk = X[pos: pos + top]
            rows = chunk.shape[0]
            b = self.bucket_for(rows)
            record_bucket_dispatch(self.name, b, rows)
            out = None
            with self._lock, self._scope():
                try:
                    prog = self._program(b, F)
                    self.forest.bind()
                    if self._copy_in(prog, chunk, twt):
                        if prog.graph is not None:
                            prog.graph.replay()
                            score, leaf = prog.score, prog.leaf
                        else:
                            score, leaf = self.forest.apply(prog.x,
                                                            prog.tree_w)
                        out = (score[:rows].cpu().numpy(),
                               leaf[:rows].cpu().numpy())
                except (InjectedFault, torch.cuda.OutOfMemoryError):
                    raise  # transient: the next call may succeed
                except Exception as exc:  # noqa: BLE001 — kept, re-raised
                    self.device_error = f"{type(exc).__name__}: {exc}"
                    raise
            if out is None:  # the copy failed: the host walker answers
                if not self._fallback_warned:
                    self._fallback_warned = True
                    log.warning(
                        f"device copy fault on entry {self.name!r}; "
                        "degrading faulted chunks to the host tree-walker "
                        "(slower; counted in "
                        "lgbmtpu_serve_host_fallback_total)")
                record_host_fallback(self.name)
                s, lf = self.host_fallback(chunk, start, end)
                out = (np.asarray(s, np.float32), np.asarray(lf))
            yield out

    def _copy_in(self, prog: _Program, chunk: np.ndarray,
                 twt: torch.Tensor) -> bool:
        """Copy a chunk's rows and the tree weights into the program's
        inputs; False when the copy faulted and host_fallback is set (the
        fallback's only trigger), else the fault propagates."""
        rows, b = chunk.shape[0], prog.x.shape[0]
        try:
            fault_point("device_put")
            prog.x[:rows].copy_(torch.from_numpy(chunk))
            if rows < b:
                prog.x[rows:].zero_()
            prog.tree_w.copy_(twt)
        except (InjectedFault, torch.cuda.OutOfMemoryError):
            if self.host_fallback is None:
                raise
            return False
        return True

    def _prep(self, X, start_iteration: int, num_iteration: int):
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        self.forest._check_width(X)
        tw, start, end = self.forest._tree_weights(
            start_iteration, num_iteration
        )
        return X, tw, start, end

    def score_raw(self, X: np.ndarray, start_iteration: int = 0,
                  num_iteration: int = -1) -> np.ndarray:
        """(K, N) raw margins via bucket-padded device calls."""
        X, tw, start, end = self._prep(X, start_iteration, num_iteration)
        if X.shape[0] == 0:  # filtered-empty request, not an error
            return np.zeros((self.forest.num_class, 0), np.float64)
        t0 = time.perf_counter()
        outs = [s for s, _ in self._bucketed_chunks(X, tw, start, end)]
        out = np.concatenate(outs).T.astype(np.float64)  # (K, N)
        if self.forest.average_output and end > start:
            out /= end - start
        self._stats.observe(time.perf_counter() - t0, X.shape[0])
        return out

    def predict_leaf(self, X: np.ndarray, start_iteration: int = 0,
                     num_iteration: int = -1) -> np.ndarray:
        """(N, used_trees) leaf indices through the same bucket ladder."""
        X, tw, start, end = self._prep(X, start_iteration, num_iteration)
        K = self.forest.num_class
        if X.shape[0] == 0:
            return np.zeros((0, (end - start) * K), np.int64)
        t0 = time.perf_counter()
        leaves = [lf for _, lf in self._bucketed_chunks(X, tw, start, end)]
        out = np.concatenate(leaves)[:, start * K: end * K]
        self._stats.observe(time.perf_counter() - t0, X.shape[0])
        return out.astype(np.int64)

    def predict_contrib(self, X: np.ndarray, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """(N, K*(F+1)) SHAP contributions (Booster pred_contrib layout)
        through a ladder capped at CONTRIB_MAX_ROWS, run uncaptured on the
        dispatcher's stream (an explanation request, not the scoring
        path)."""
        X, tw, start, end = self._prep(X, start_iteration, num_iteration)
        F = X.shape[1]
        K = self.forest.num_class
        if X.shape[0] == 0:
            return np.zeros((0, K * (F + 1)), np.float64)
        t0 = time.perf_counter()
        top = min(self.buckets[-1], CONTRIB_MAX_ROWS)
        rungs = [b for b in self.buckets if b <= top] or [top]
        twt = torch.from_numpy(tw).to(self.device)
        outs = []
        N = X.shape[0]
        for pos in range(0, N, top):
            chunk = X[pos: pos + top]
            rows = chunk.shape[0]
            b = next((r for r in rungs if rows <= r), rungs[-1])
            record_bucket_dispatch(f"{self.name}:contrib", b, rows)
            if rows < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - rows, F), np.float32)])
            with self._lock, self._scope():
                out = self.forest.apply_contrib(
                    torch.from_numpy(chunk).to(self.device), twt)
                outs.append(out[:rows].cpu().numpy())
        out = np.concatenate(outs).astype(np.float64)
        if self.forest.average_output and end > start:
            out /= end - start
        self._stats.observe(time.perf_counter() - t0, N)
        return out

    def stats(self) -> dict:
        return self._stats.snapshot()


class MicroBatcher:
    """Thread-safe request queue in front of one or more
    BucketDispatchers.

    submit(rows) -> Future resolving to that request's (n, K) scores.
    One worker thread PER DISPATCHER drains a shared queue: everything
    pending (up to the largest bucket) coalesces into a single padded
    device call. With replica dispatchers this is the continuous-
    batching front: while replica 0's batch is in flight on its stream,
    replica 1's worker is already coalescing and admitting the next
    batch.

    Overload handling:

    - ``queue_cap`` bounds the ROWS admitted to the queue; a submit
      past the cap fast-fails with :class:`QueueOverflow` in the
      caller's thread (the HTTP transport maps it to 503 +
      Retry-After) instead of growing an unbounded backlog.
    - ``deadline_s`` (per-instance default, overridable per submit)
      bounds time-in-queue: the worker sweeps expired requests on
      every drain and fails them with :class:`DeadlineExceeded` (HTTP
      504) without spending a device call on them. A request already
      coalesced into a device call is never cancelled.
    - ``close()`` fails everything still queued with
      :class:`ShutdownError` — a shutdown never leaves a caller
      blocked forever on ``Future.result()``.
    """

    def __init__(self, dispatcher, max_delay_s: float = 0.002,
                 deadline_s: float = 0.0,
                 queue_cap: int = 0):
        # a single dispatcher (anything duck-typing BucketDispatcher)
        # or a list/tuple of replicas sharing identical model + ladder
        # (the registry builds the replica list)
        if isinstance(dispatcher, (list, tuple)):
            self.dispatchers: Tuple[BucketDispatcher, ...] = tuple(dispatcher)
        else:
            self.dispatchers = (dispatcher,)
        if not self.dispatchers:
            raise ValueError("MicroBatcher needs at least one dispatcher")
        self.dispatcher = self.dispatchers[0]  # primary (stats, width)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = float(deadline_s)  # 0 = no default deadline
        self.queue_cap = int(queue_cap)      # rows; 0 = unbounded
        # entries are (X, future, expiry | None) in monotonic time
        self._pending: List[Tuple[np.ndarray, Future,
                                  Optional[float]]] = []
        self._pending_rows = 0
        self._cond = threading.Condition()
        self._closed = False
        self._workers = [
            threading.Thread(
                target=self._run, args=(d,),
                name=f"lgb-serve-microbatch-{i}", daemon=True,
            )
            for i, d in enumerate(self.dispatchers)
        ]
        for w in self._workers:
            w.start()

    def submit(self, X: np.ndarray,
               deadline_s: Optional[float] = None) -> Future:
        """Queue rows for coalesced default-parameter scoring; resolves
        to that request's (n, K) RAW margins. Non-default scoring
        options (truncation, pred_leaf) go through the dispatcher
        directly — requests in one coalesced batch share one parameter
        set. ``deadline_s`` overrides the instance default (<= 0
        disables the deadline for this request)."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        # validate in the submitter's thread: a malformed request fails
        # ITS caller, never the requests it would be coalesced with
        self.dispatcher.forest._check_width(X)
        dl = self.deadline_s if deadline_s is None else float(deadline_s)
        expiry = time.monotonic() + dl if dl > 0 else None
        fut: Future = Future()
        try:
            with self._cond:
                if self._closed:
                    raise ShutdownError("MicroBatcher is closed")
                # admission control: reject while a backlog exists (a
                # single request larger than the cap is still admitted
                # into an EMPTY queue — it chunks through the ladder)
                if (self.queue_cap > 0 and self._pending
                        and self._pending_rows + X.shape[0]
                        > self.queue_cap):
                    raise QueueOverflow(
                        f"microbatch queue full "
                        f"({self._pending_rows} rows queued, "
                        f"cap {self.queue_cap})"
                    )
                self._pending.append((X, fut, expiry))
                self._pending_rows += X.shape[0]
                depth = len(self._pending)
                self._cond.notify()
        except QueueOverflow:
            # counter outside the condition: the metrics registry has
            # its own lock and must not nest under the queue's
            record_serve_rejection(self.dispatcher.name, "overloaded")
            raise
        record_queue_depth(self.dispatcher.name, depth)
        return fut

    def close(self) -> None:
        """Stop the workers and fail anything still pending with
        ShutdownError. The workers drain the queue on the way out; the
        sweep below only matters when one cannot finish within the join
        timeout — futures must fail, not hang their callers forever."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=5)
        with self._cond:
            leftovers = self._pending
            self._pending = []
            self._pending_rows = 0
        for _, fut, _ in leftovers:  # outside the lock: may run callbacks
            if not fut.done():
                fut.set_exception(
                    ShutdownError("MicroBatcher closed before scoring")
                )

    # ------------------------------------------------------------------
    def _sweep_expired_locked(
        self, now: float
    ) -> List[Tuple[np.ndarray, Future, Optional[float]]]:
        """Pop expired entries (caller holds the condition; the popped
        futures are failed OUTSIDE the lock — done-callbacks may run)."""
        expired = [e for e in self._pending
                   if e[2] is not None and now >= e[2]]
        if expired:
            # both callers hold self._cond (the _locked suffix is the
            # contract; the per-function lint cannot see the call sites)
            self._pending = [e for e in self._pending  # lint: allow[unlocked-write]
                             if e[2] is None or now < e[2]]
            self._pending_rows = sum(  # lint: allow[unlocked-write]
                e[0].shape[0] for e in self._pending)
        return expired

    def _run(self, dispatcher: BucketDispatcher) -> None:
        top = dispatcher.buckets[-1]
        while True:
            expired: List[Tuple[np.ndarray, Future, Optional[float]]] = []
            batch: List[Tuple[np.ndarray, Future]] = []
            rows = 0
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                expired = self._sweep_expired_locked(time.monotonic())
                # brief linger so near-simultaneous submitters coalesce
                if (len(self._pending) == 1
                        and self._pending[0][0].shape[0] < top
                        and not self._closed):
                    self._cond.wait(self.max_delay_s)
                    expired += self._sweep_expired_locked(
                        time.monotonic()
                    )
                if self._pending:
                    # coalesce only same-width requests (widths >= the
                    # model's widest feature are all valid, so a mixed
                    # queue would break np.concatenate); stragglers
                    # stay pending for the next drain
                    width = self._pending[0][0].shape[1]
                    while (self._pending and rows < top
                           and self._pending[0][0].shape[1] == width):
                        X, fut, _ = self._pending.pop(0)
                        self._pending_rows -= X.shape[0]
                        batch.append((X, fut))
                        rows += X.shape[0]
                depth = len(self._pending)
            for _, fut, _ in expired:
                record_serve_rejection(dispatcher.name, "deadline")
                if not fut.done():
                    fut.set_exception(DeadlineExceeded(
                        "request expired in the microbatch queue"
                    ))
            if not batch:
                continue
            record_queue_depth(dispatcher.name, depth)
            record_coalesce(dispatcher.name, len(batch), rows)
            try:
                Xall = np.concatenate([x for x, _ in batch]) \
                    if len(batch) > 1 else batch[0][0]
                out = dispatcher.score_raw(Xall)  # (K, N)
                pos = 0
                for X, fut in batch:
                    n = X.shape[0]
                    fut.set_result(out[:, pos: pos + n].T)  # (n, K)
                    pos += n
            except Exception as e:  # noqa: BLE001 — fan the error out
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
