"""The loops of one boosting step, and the CUDA graph that replays it.

The JAX package keeps every data-dependent loop of an iteration on the
device: the rounds of a tree (lax.while_loop, learner/rounds.py), the
levels of a traversal (tree.py traverse_tree_bins) and the iterations of
a dispatch (lax.scan, boosting.fused_dispatch). In the port each such
loop is a Python loop over a bounded number of steps whose body is
written once and runs in one of three modes (DeviceLoop):

- EAGER: the host reads what the loop needs (a round's split count, a
  tree's depth, whether an iteration runs) and runs only those steps
  (the eager training loop, Booster.update, and the fused loop on the
  CPU, where a read costs no sync);
- BOUNDED: every step runs and nothing is read back; a step whose
  predicate is false is a no-op by construction (the first fused
  iteration on the card, which warms up the kernels and their scratch
  before capture, and the CPU tests that hold the fused step to reading
  nothing);
- CAPTURE: each step sits in an IF node of the CUDA graph being
  captured, on the predicate the graph computes itself (CudaGraph.when);
  a replay runs only the steps whose predicate holds.

The three modes compute the same numbers on the steps that do run, and
a skipped step would have changed nothing, so their results agree bit
for bit.

CudaGraph captures one function on a stream of its own, with the
allocations of the capture routed to a memory pool that lives as long as
the graph (torch.cuda.MemPool), and replays it on torch's current stream.
Its IF nodes come from csrc/graph.cu (the installed torch may lack
CUDAGraph.begin_capture_to_if_node): each body is captured on a stream
of its nesting depth, and whatever the capture records after a body
depends on it. The kernels' scratch (cuda_hist._scratch) is keyed on the
capture stream for the whole capture, bodies included, so the buffers
the warm-up zeroed serve every launch in the graph. A capture that
fails, a sync inside it, or a launch the graph refuses raises; nothing
falls back to the eager loop.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

EAGER, BOUNDED, CAPTURE = "eager", "bounded", "capture"


class DeviceLoop:
    """How the loops of a step run (module docstring), and what the
    bounded loops leave behind: per tree, the rounds it took and whether
    it was still growing at its bound (`trees`, device tensors)."""

    def __init__(self, mode: str = EAGER, graph: "Optional[CudaGraph]" = None):
        if mode not in (EAGER, BOUNDED, CAPTURE):
            raise ValueError(f"unknown loop mode {mode!r}")
        if (mode == CAPTURE) != (graph is not None):
            raise ValueError("a CAPTURE loop needs the graph it captures")
        self.mode = mode
        self.graph = graph
        self.trees: List[tuple] = []

    @property
    def bounded(self) -> bool:
        """True when the loops run to their bound without host reads."""
        return self.mode != EAGER

    def run(self, n: int, pred: Callable[[], torch.Tensor],
            body: Callable[[], None]) -> None:
        """n steps of body() in a bounded loop, each one a no-op once
        pred() (a 0-dim device bool) is false: all of them (BOUNDED), or
        each in an IF node on pred() (CAPTURE). An eager loop reads its
        own bound instead (the rounds their split count, the traversal
        the tree's depth)."""
        if self.mode == EAGER:
            raise ValueError("an eager loop reads its own bound")
        for _ in range(n):
            if self.mode == BOUNDED:
                body()
            else:
                with self.graph.when(pred()):
                    body()

    def ladder(self, value: torch.Tensor, caps: Tuple[int, ...],
               body: Callable[[int], None]) -> None:
        """body(cap) for the smallest of `caps` (descending; caps[0]
        bounds every value) that is >= value, a one-element device int:
        that body alone, its cap chosen on the host (EAGER), the widest
        body, which serves every value and reads nothing (BOUNDED), or
        every body in an IF node on its own range of values (CAPTURE).
        A body's result must not depend on the cap it runs at."""
        if self.mode == EAGER:
            v = int(value)
            body(min(c for c in caps if c >= v))
        elif self.mode == BOUNDED or len(caps) == 1:
            body(caps[0])
        else:
            v = value.reshape(())
            for j, cap in enumerate(caps):
                # the values for which cap is the smallest that fits
                if j + 1 == len(caps):
                    pred = v <= cap
                elif j == 0:
                    pred = v > caps[1]
                else:
                    pred = (v <= cap) & (v > caps[j + 1])
                with self.graph.when(pred):
                    body(cap)

    def cond(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        """body() when pred (a 0-dim device bool) holds: read on the host
        (EAGER), an IF node (CAPTURE), or run regardless (BOUNDED, where
        body must then change nothing)."""
        if self.mode == EAGER:
            if bool(pred):
                body()
        elif self.mode == BOUNDED:
            body()
        else:
            with self.graph.when(pred):
                body()


@contextlib.contextmanager
def _gc_restored(enabled: bool):
    try:
        yield
    finally:
        if enabled:
            gc.enable()


# A graph's memory pool must not die while any capture is under way, in
# any thread: the pool's destructor empties it, which torch's allocator
# refuses then (an internal assert, raised from a destructor: the
# process aborts). That happens when a serving worker captures while
# another thread drops an earlier graph (an unload, or a collection that
# thread ran). So a pool that dies during a capture is parked here and
# freed when the last capture ends, under the lock that starts captures.
_CAPTURE_STATE = threading.RLock()
_captures_under_way = 0
_parked_pools: List[object] = []


@contextlib.contextmanager
def _capture_under_way():
    global _captures_under_way
    with _CAPTURE_STATE:
        _captures_under_way += 1
    try:
        yield
    finally:
        with _CAPTURE_STATE:
            _captures_under_way -= 1
            if _captures_under_way == 0:
                _parked_pools.clear()  # the parked pools die here


def _release_pool(graph: "CudaGraph") -> None:
    """Drop a dying graph's pool now, or park it while a capture is
    under way."""
    with _CAPTURE_STATE:
        pool = getattr(graph, "pool", None)
        graph.pool = None
        if pool is not None and _captures_under_way:
            _parked_pools.append(pool)
        del pool


def _lib():
    from .cuda_hist import load

    return load()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA graph: {what} failed with CUDA error "
                           f"{rc} ({torch.cuda.get_device_name()})")


class CudaGraph:
    """One captured CUDA graph (module docstring): capture(fn) once, then
    replay() any number of times. `nodes` counts the graph's nodes, IF
    bodies included; `capture_s` the capture and instantiation;
    `replays` the launches."""

    def __init__(self, device: torch.device):
        if not hasattr(torch.cuda, "MemPool") or not hasattr(
                torch.cuda, "use_mem_pool"):
            raise RuntimeError(
                f"torch {torch.__version__} has no torch.cuda.MemPool / "
                "use_mem_pool, which the graph's allocations need")
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        self.pool = torch.cuda.MemPool()
        self.stream = torch.cuda.Stream(self.device)
        self._bodies: List[torch.cuda.Stream] = []  # one per IF depth
        self._depth = 0
        self._graph = ctypes.c_void_p()
        self._exec = ctypes.c_void_p()
        self.nodes = 0
        self.capture_s: Optional[float] = None
        self.replays = 0

    @property
    def captured(self) -> bool:
        return bool(self._exec.value)

    def capture(self, fn: Callable[[DeviceLoop], None]) -> None:
        """Capture fn(DeviceLoop(CAPTURE, self)) on the graph's stream."""
        from . import cuda_hist

        if self.captured:
            raise RuntimeError("this graph is captured already")
        lib = _lib()
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        handle = self.stream.cuda_stream
        # no garbage collection while the pool takes the allocations; a
        # graph that dies meanwhile (in any thread) parks its pool until
        # no capture is under way (_release_pool)
        gc_was_on = gc.isenabled()
        gc.disable()
        with _gc_restored(gc_was_on), _capture_under_way(), \
                torch.cuda.use_mem_pool(self.pool, self.device), \
                torch.cuda.stream(self.stream), \
                cuda_hist.scratch_stream(handle):
            _check(lib.lgbm_graph_begin(ctypes.c_void_p(handle)),
                   "begin capture")
            nodes = ctypes.c_longlong()
            try:
                fn(DeviceLoop(CAPTURE, self))
            except BaseException:
                # end the broken capture so the stream can be used again
                lib.lgbm_graph_end(ctypes.c_void_p(handle),
                                   ctypes.byref(self._graph),
                                   ctypes.byref(self._exec),
                                   ctypes.byref(nodes))
                self.close()
                raise
            _check(lib.lgbm_graph_end(ctypes.c_void_p(handle),
                                      ctypes.byref(self._graph),
                                      ctypes.byref(self._exec),
                                      ctypes.byref(nodes)),
                   "end capture / instantiate (a launch inside the capture "
                   "was refused, or something synchronized)")
        cur.wait_stream(self.stream)
        self.nodes += nodes.value
        self.capture_s = time.perf_counter() - t0

    @contextlib.contextmanager
    def when(self, pred: torch.Tensor):
        """Capture the section as the body of an IF node on pred, a 0-dim
        bool on the graph's device."""
        if pred.dim() != 0 or pred.dtype != torch.bool or \
                pred.device != self.device:
            raise ValueError("an IF node's predicate must be a 0-dim bool "
                             f"on {self.device}, got {pred.dtype} "
                             f"{tuple(pred.shape)} on {pred.device}")
        lib = _lib()
        parent = torch.cuda.current_stream(self.device)
        if self._depth == len(self._bodies):
            self._bodies.append(torch.cuda.Stream(self.device))
        body = self._bodies[self._depth]
        _check(lib.lgbm_if_begin(ctypes.c_void_p(parent.cuda_stream),
                                 ctypes.c_void_p(body.cuda_stream),
                                 ctypes.c_void_p(pred.data_ptr())),
               "IF node")
        self._depth += 1
        nodes = ctypes.c_longlong()
        try:
            with torch.cuda.stream(body):
                yield
        finally:
            self._depth -= 1
            rc = lib.lgbm_if_end(ctypes.c_void_p(body.cuda_stream),
                                 ctypes.byref(nodes))
        _check(rc, "IF body capture")
        self.nodes += nodes.value

    def replay(self) -> None:
        """Launch the graph on torch's current stream."""
        if not self.captured:
            raise RuntimeError("replay before capture")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(_lib().lgbm_graph_launch(self._exec, ctypes.c_void_p(stream)),
               "replay")
        self.replays += 1

    def close(self) -> None:
        if self._graph.value or self._exec.value:
            _lib().lgbm_graph_destroy(self._graph, self._exec)
        self._graph = ctypes.c_void_p()
        self._exec = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
            _release_pool(self)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
