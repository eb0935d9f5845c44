"""Multi-tenant model fleet: many models behind one process, resident as
stacked forest tables with LRU device paging.

The port of lightgbm_tpu/serving/fleet.py. The registry (registry.py)
keeps one TensorForest, one table set and one set of CUDA graphs per
loaded version: right for a handful of models, wrong for hundreds
(device memory fills, and every table shape captures its own rungs).
The fleet changes the unit of residency:

- models group into SHAPE FAMILIES by their power-of-two-quantized
  table dimensions (forest.family_key); each family owns one or more
  stacks of S slots (ForestStack: one forest of S x T trees on the
  card, forest.stack_tables). Slot s scores through
  forest.stacked_forest_apply with the slot read from a 0-dim device
  buffer, so a family's stack captures ONE CUDA graph a rung (and row
  width) and every tenant that pages through it replays that graph:
  paging never captures. Graphs = stacks x rungs, one stack a family
  while its resident tenants fit slots_per_family.
- an LRU pager moves models between host tables (always held, numpy)
  and a stack slot. A page-in writes the slot's rows in place and warms
  the smallest rung (a stack's first page-in captures it); eviction
  only releases the slot. A PIN COUNT per model keeps every model of an
  in-flight request resident until its output is on the host, so a
  request never sees a torn slot or another tenant's trees.
- per-model QoS: each tenant carries its own queue deadline and
  admission cap (default: the fleet's), applied to its lazily built
  MicroBatcher; per-model lgbmtpu_* series land on /metrics through its
  dispatcher's latency ring.
- hot swap and rollback keep registry semantics: versions are separate
  residency entries and the active pointer moves atomically under the
  fleet's condition; requests pinned to the old version finish on its
  slot.
- pred_contrib serves device TreeSHAP from per-model tables packed on
  the first explanation request and dropped on eviction.

Ordering on the card. A family's tenants share one ProgramSet
(dispatch.py): one lock, one CUDA stream, the rungs' graphs and their
static row, tree-weight and slot buffers. Every replay, slot write and
warm-up of the family runs under that lock on that stream, so a write
into a slot after an eviction is stream-ordered behind every earlier
replay that read the slot; and a pin is released only after the
request's output has been copied off the card.

Locking: ONE condition variable guards all fleet state (names, versions,
stacks, pins, residency counts). Device work (slot writes, warm-up,
scoring) happens OUTSIDE it; a stack's writers are serialized by its
`writing` flag under the condition, and a slot is never reassigned
while pinned.

Faults: the ``fleet_page`` fault site precedes each page-in's table
write (a fault there leaves the tenant cold, as any page-in failure
does), and ``host_fallback=True`` gives every tenant's dispatcher the
registry's host fallback (a chunk whose host-to-device copy failed is
scored on the host walker; default False, as the registry's; other
device errors propagate and ``device_faults()`` keeps them). A mesh is
ignored with a warning, as in the JAX package: a stack's slots share
one program set.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import log
from ..obs.metrics import (
    record_fleet_page,
    record_fleet_resident,
    record_registry_event,
    record_serve_rejection,
)
from ..resilience.errors import QueueOverflow
from ..resilience.faultinject import fault_point
from .dispatch import DEFAULT_BUCKETS, BucketDispatcher, ProgramSet
from .forest import (
    PACK_FIELDS,
    contrib_apply,
    device_tables,
    family_key,
    pack_contrib_tables,
    pack_forest_tables,
    pad_forest_tables,
    serve_device,
    slot_views,
    stack_tables,
    stacked_forest_apply,
)
from .registry import (
    _booster_from,
    _declared_width,
    _make_host_fallback,
    build_kernels,
)


class ForestStack:
    """One family's stacked device tables (forest.stack_tables) with a
    slot -> entry occupancy map, the slot buffer its graphs read and the
    ProgramSet its tenants share. Occupancy changes under the fleet's
    condition; table writes under the ProgramSet's lock."""

    def __init__(self, key: Tuple, slots: int, device: torch.device):
        self.key = key
        self.slots = int(slots)
        self.device = device
        self.tables: Optional[Dict[str, torch.Tensor]] = None
        self.occupant: List[Optional[Any]] = [None] * self.slots
        # one page-in at a time a stack (the fleet serializes writers on
        # this flag under its condition; readers are unaffected)
        self.writing = False
        self.programs = ProgramSet(device)
        # the slot the family's graphs score: written before each call,
        # under the ProgramSet's lock
        self.slot = torch.zeros((), dtype=torch.int32, device=device)

    def write(self, slot: int, padded: Dict[str, np.ndarray]) -> None:
        """Upload one padded model into its slot, on the family's stream
        under its lock (device work; outside the fleet condition). The
        pack goes up as the host packed it and becomes the slot's node
        records on the card (their zero columns are never written)."""
        ps = self.programs
        with ps.lock, ps.scope():
            if self.tables is None:
                self.tables = stack_tables(padded, self.slots, self.device)
            views = slot_views(self.tables, slot, self.slots)
            for k, v in padded.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                if k == "pack":
                    views[k][:, :PACK_FIELDS].copy_(src.to(self.device).T)
                else:
                    views[k].copy_(src)


class _SlotForest:
    """The TensorForest protocol over a fleet residency entry, so that
    BucketDispatcher (ladder, chunking, stats) works unchanged for fleet
    tenants. bind() writes the entry's slot into the stack's slot buffer
    (the dispatcher calls it under the family's lock); callers hold a
    pin for the whole request, so the slot is not reassigned under it."""

    def __init__(self, fleet: "ModelFleet", entry: "_FleetEntry"):
        self._fleet = fleet
        self._entry = entry
        meta = entry.meta
        self.meta = meta
        self.device = fleet.device
        self.num_class = meta["num_class"]
        self.num_trees = meta["num_trees"]  # the model's own tree count
        self.average_output = bool(entry.average_output)
        self.max_feature = meta["max_feature"]
        self.weight_len = entry.family[0]  # the stack's trees a slot

    def _tree_weights(self, start_iteration: int,
                      num_iteration: int) -> Tuple[np.ndarray, int, int]:
        K = self.num_class
        n_iters = self.num_trees // K
        end = n_iters if num_iteration <= 0 else min(
            n_iters, start_iteration + num_iteration)
        # padded to the slot's tree count: padding trees score 0
        tw = np.zeros(self.weight_len, np.float32)
        tw[start_iteration * K: end * K] = 1.0
        return tw, start_iteration, end

    def _check_width(self, X: np.ndarray) -> None:
        if X.shape[1] <= self.max_feature:
            raise IndexError(
                f"input has {X.shape[1]} features but the model "
                f"references feature {self.max_feature}")

    def _resident(self) -> "ForestStack":
        e = self._entry
        with self._fleet._cond:
            if e.state != "ready":
                raise RuntimeError(
                    f"fleet model {e.name!r} v{e.version} scored while not "
                    "resident (missing pin)")
            return e.stack

    def bind(self) -> None:
        st = self._resident()
        st.slot.fill_(self._entry.slot)

    def apply(self, X: torch.Tensor, tree_w: torch.Tensor):
        """The family's scoring call on the stack's slot buffer (what the
        rungs' graphs capture)."""
        st = self._resident()
        fam = self._entry.family
        return stacked_forest_apply(st.tables, st.slot, X, tree_w,
                                    has_cat=fam[7], linear=fam[8],
                                    levels=fam[6])

    def apply_contrib(self, X: torch.Tensor, tree_w: torch.Tensor):
        """Device TreeSHAP on the entry's own (unpadded) tables: the
        dispatcher's weights are slot-wide, the model's are a prefix."""
        main, ct = self._fleet._contrib_tables(self._entry)
        return contrib_apply(main, ct, X, tree_w[:self.num_trees],
                             has_cat=self.meta["has_cat"])


@dataclass
class _FleetEntry:
    """One (name, version): host tables always, a stack slot when hot."""

    name: str
    version: int
    booster: Any
    host_tables: Dict[str, np.ndarray]  # unpadded numpy (the cold copy)
    meta: Dict[str, Any]
    source: str
    family: Tuple
    average_output: bool
    deadline_s: float
    queue_cap: int
    width: int  # the row width the tenant is warmed at
    loaded_at: float = field(default_factory=time.time)
    state: str = "cold"  # cold | loading | ready
    stack: Optional[ForestStack] = None
    slot: int = -1
    pins: int = 0
    last_used: float = 0.0
    retired: bool = False
    forest: Any = None       # _SlotForest
    dispatcher: Any = None   # BucketDispatcher over the stack's programs
    batcher: Any = None      # lazy MicroBatcher (via_queue)
    ctables: Any = None      # lazy (main tables, contrib tables) on device


class ModelFleet:
    """Registry-compatible multi-tenant model store: the same load / swap
    / rollback / unload / models / stats / predict surface as
    ModelRegistry, so ScoringServer and the HTTP front end work
    unchanged, over a capacity-bounded device residency."""

    # the online loop's attachment points (OnlineLoop.attach): the
    # same duck-typed surface as ModelRegistry
    ingest_sink = None
    health_probe = None

    def __init__(self, mesh=None, buckets=DEFAULT_BUCKETS,
                 warmup: bool = False, deadline_s: float = 0.0,
                 queue_cap: int = 0, host_fallback: bool = False,
                 capacity: int = 32, slots_per_family: int = 8,
                 page_timeout_s: float = 30.0, device="cuda"):
        if mesh is not None:
            log.warning("fleet serving ignores the mesh: stacked "
                        "families score on this rank's device")
        self.device = serve_device(device)
        self.host_fallback = bool(host_fallback)
        self.buckets = tuple(int(b) for b in buckets)
        self.default_warmup = bool(warmup)
        self.deadline_s = float(deadline_s)
        self.queue_cap = int(queue_cap)
        self.capacity = max(int(capacity), 1)
        self.slots_per_family = max(int(slots_per_family), 1)
        self.page_timeout_s = float(page_timeout_s)
        self._cond = threading.Condition()
        self._names: Dict[str, Dict[str, Any]] = {}
        self._stacks: Dict[Tuple, List[ForestStack]] = {}
        self._resident = 0
        self._pages_in = 0
        self._evictions = 0

    # ---------------------------------------------------------- load
    def load(self, name: str, source: Any, *, activate: bool = True,
             warmup: Optional[bool] = None,
             num_features: Optional[int] = None,
             deadline_ms: Optional[float] = None,
             queue_cap: Optional[int] = None) -> int:
        """Register a model version: pack its host tables (outside the
        condition: a load never stalls scoring), record its QoS, and page
        it in now when `warmup` says so. deadline_ms / queue_cap are the
        tenant's QoS; left out, the fleet's defaults. num_features: the
        row width its page-in warms (default: the model's declared
        width)."""
        booster, src = _booster_from(source)
        build_kernels(self.device)
        g = booster._gbdt
        tables, meta = pack_forest_tables(list(g.models), g.num_class)
        fam = family_key(meta, tables)
        width = int(num_features or _declared_width(booster)
                    or meta["max_feature"] + 1)
        entry = _FleetEntry(
            name=name, version=0, booster=booster, host_tables=tables,
            meta=meta, source=src, family=fam,
            average_output=bool(getattr(g, "average_output", False)),
            deadline_s=(self.deadline_s if deadline_ms is None
                        else float(deadline_ms) / 1000.0),
            queue_cap=(self.queue_cap if queue_cap is None
                       else int(queue_cap)),
            width=max(width, meta["max_feature"] + 1, 1))
        with self._cond:
            rec = self._names.setdefault(name, {"versions": [], "active": 0})
            v = (rec["versions"][-1].version + 1) if rec["versions"] else 1
            entry.version = v
            rec["versions"].append(entry)
            if activate or rec["active"] == 0:
                rec["active"] = v
        entry.forest = _SlotForest(self, entry)
        record_registry_event("load", name)
        do_warm = self.default_warmup if warmup is None else warmup
        if do_warm:
            self._acquire(entry)
            self._release(entry)
        log.info(f"fleet: loaded {name!r} v{v} from {src} (family {fam})")
        return v

    # ------------------------------------------------------ residency
    def _find_slot_locked(self, family: Tuple) -> Tuple[ForestStack, int]:
        """A free slot in the family's stacks, growing a new stack when
        none is free (the global capacity is the caller's check)."""
        stacks = self._stacks.setdefault(family, [])
        for st in stacks:
            for s, occ in enumerate(st.occupant):
                if occ is None:
                    return st, s
        st = ForestStack(family, self.slots_per_family, self.device)
        stacks.append(st)
        return st, 0

    def _evict_locked(self, entry: "_FleetEntry", event: str) -> None:
        entry.state = "cold"
        if entry.stack is not None and entry.slot >= 0:
            entry.stack.occupant[entry.slot] = None
        entry.stack, entry.slot = None, -1
        entry.ctables = None  # the contrib tables go with the slot
        # every caller holds self._cond (the _locked suffix is the
        # contract; the per-function lint cannot see the call sites)
        self._resident -= 1  # lint: allow[unlocked-write]
        self._evictions += 1  # lint: allow[unlocked-write]
        record_fleet_page(entry.name, event)

    def _evict_lru_locked(self) -> bool:
        """Evict the least recently used unpinned resident entry; False
        when every resident entry is pinned (the caller waits)."""
        victim: Optional[_FleetEntry] = None
        for rec in self._names.values():
            for e in rec["versions"]:
                if e.state == "ready" and e.pins == 0:
                    if victim is None or e.last_used < victim.last_used:
                        victim = e
        if victim is None:
            return False
        self._evict_locked(victim, "evict")
        return True

    def _dispatcher_locked(self, entry: "_FleetEntry") -> BucketDispatcher:
        """The tenant's dispatcher over its stack's programs, built when
        it is first paged into that stack (a family has one stack while
        its resident tenants fit slots_per_family)."""
        d = entry.dispatcher
        if d is None or d.program_set is not entry.stack.programs:
            name = (f"fleet:{entry.name}" if entry.version == 1
                    else f"fleet:{entry.name}:v{entry.version}")
            d = BucketDispatcher(entry.forest, self.buckets, name=name,
                                 model=entry.name,
                                 programs=entry.stack.programs)
            if self.host_fallback:
                d.host_fallback = _make_host_fallback(entry.booster,
                                                      entry.forest)
            entry.dispatcher = d
        return d

    def _acquire(self, entry: "_FleetEntry") -> None:
        """Pin `entry` resident, paging it in when cold. Waits while
        another thread pages it; raises QueueOverflow when pinned models
        hold the whole residency for longer than page_timeout_s (the
        HTTP front end answers 503: overload, not failure)."""
        deadline = time.monotonic() + self.page_timeout_s
        with self._cond:
            while True:
                if entry.retired:
                    raise KeyError(f"model {entry.name!r} v{entry.version} "
                                   "was unloaded")
                if entry.state == "ready":
                    entry.pins += 1
                    entry.last_used = time.monotonic()
                    return
                if entry.state == "loading":
                    self._wait_or_reject_locked(entry, deadline)
                    continue
                # cold: make room, claim a slot, page in
                if self._resident >= self.capacity:
                    if not self._evict_lru_locked():
                        self._wait_or_reject_locked(entry, deadline)
                        continue
                st, slot = self._find_slot_locked(entry.family)
                if st.writing:
                    # another tenant is paging into this stack
                    self._wait_or_reject_locked(entry, deadline)
                    continue
                st.writing = True
                st.occupant[slot] = entry
                entry.stack, entry.slot = st, slot
                entry.state = "loading"
                self._resident += 1
                self._dispatcher_locked(entry)
                break
        # ---- device work outside the condition
        pinned = False
        try:
            fault_point("fleet_page")
            fam = entry.family
            padded, _ = pad_forest_tables(
                entry.host_tables, entry.meta, num_trees=fam[0],
                max_nodes=fam[1], max_leaves=fam[2], cat_words=fam[4],
                lin_feats=fam[5])
            entry.stack.write(entry.slot, padded)
            with self._cond:
                # resident, and pinned for the caller before the warm-up
                # scores the slot
                entry.state = "ready"
                entry.pins += 1
                entry.last_used = time.monotonic()
                pinned = True
            entry.dispatcher.warm_rung(self.buckets[0], entry.width)
            record_fleet_page(entry.name, "warmup")
        except Exception:
            with self._cond:
                entry.stack.writing = False
                if pinned:
                    entry.pins -= 1
                self._evict_locked(entry, "page_fail")
                self._cond.notify_all()
            raise
        with self._cond:
            entry.stack.writing = False
            resident = self._resident
            self._pages_in += 1
            self._cond.notify_all()
        record_fleet_page(entry.name, "page_in")
        record_fleet_resident(resident, self.capacity)

    def _wait_or_reject_locked(self, entry: "_FleetEntry",
                               deadline: float) -> None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            record_serve_rejection(f"fleet:{entry.name}", "overloaded")
            raise QueueOverflow(
                f"fleet residency exhausted: {self._resident}/"
                f"{self.capacity} resident, all pinned")
        self._cond.wait(min(remaining, 0.1))

    def _release(self, entry: "_FleetEntry") -> None:
        with self._cond:
            entry.pins -= 1
            if entry.retired and entry.pins == 0 and entry.state == "ready":
                # unload arrived while this request was in flight
                self._evict_locked(entry, "evict")
            self._cond.notify_all()

    def _contrib_tables(self, entry: "_FleetEntry"):
        """The tenant's device TreeSHAP tables (its own unpadded main
        tables and the packed contrib tables), built on first use and
        dropped on eviction."""
        with self._cond:
            if entry.ctables is not None:
                return entry.ctables
        g = entry.booster._gbdt
        ct, _ = pack_contrib_tables(list(g.models), entry.meta["num_class"])
        to_dev = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v))
                            .to(self.device) for k, v in d.items()}
        built = (device_tables(entry.host_tables, self.device), to_dev(ct))
        with self._cond:
            # two racing packers both built valid tables: keep one
            if entry.ctables is None:
                entry.ctables = built
            return entry.ctables

    # ------------------------------------------------------- registry
    def _entry_locked(self, name: str,
                      version: Optional[int] = None) -> "_FleetEntry":
        if name not in self._names:
            raise KeyError(f"unknown model {name!r}")
        rec = self._names[name]
        v = rec["active"] if version is None else int(version)
        for e in rec["versions"]:
            if e.version == v:
                return e
        raise KeyError(f"model {name!r} has no version {v}")

    def swap(self, name: str, version: int) -> None:
        with self._cond:
            e = self._entry_locked(name, version)
            self._names[name]["active"] = e.version
        record_registry_event("swap", name)

    def rollback(self, name: str) -> int:
        with self._cond:
            if name not in self._names:
                raise KeyError(f"unknown model {name!r}")
            rec = self._names[name]
            cur = rec["active"]
            older = [e.version for e in rec["versions"] if e.version < cur]
            if not older:
                raise KeyError(f"model {name!r} has no version below {cur}")
            rec["active"] = max(older)
            active = rec["active"]
        record_registry_event("rollback", name)
        return active

    def unload(self, name: str, version: Optional[int] = None) -> None:
        dropped: List[_FleetEntry] = []
        with self._cond:
            if version is None:
                rec = self._names.pop(name, None)
                if rec:
                    dropped = rec["versions"]
            else:
                rec = self._names.get(name)
                if rec is None:
                    return
                if rec["active"] == int(version):
                    raise ValueError(
                        f"version {version} of {name!r} is active; swap "
                        "first or unload the whole name")
                kept = []
                for e in rec["versions"]:
                    (kept if e.version != int(version)
                     else dropped).append(e)
                rec["versions"] = kept
            for e in dropped:
                e.retired = True
                if e.state == "ready" and e.pins == 0:
                    self._evict_locked(e, "evict")
                # pinned entries are evicted by _release when their last
                # request lands
            self._cond.notify_all()
        for e in dropped:  # outside the condition: close() joins workers
            if e.batcher is not None:
                e.batcher.close()
        if dropped:
            record_registry_event("unload", name)

    def models(self) -> Dict[str, Dict[str, Any]]:
        with self._cond:
            return {
                name: {
                    "active": rec["active"],
                    "versions": [
                        {"version": e.version, "source": e.source,
                         "num_trees": e.meta["num_trees"],
                         "num_class": e.meta["num_class"],
                         "loaded_at": e.loaded_at,
                         "resident": e.state == "ready"}
                        for e in rec["versions"]
                    ],
                }
                for name, rec in self._names.items()
            }

    def device_faults(self) -> Dict[str, str]:
        """"name:vN" -> the last capture, launch or replay error of the
        tenant's dispatcher (ModelRegistry.device_faults)."""
        with self._cond:
            return {f"{name}:v{e.version}": e.dispatcher.device_error
                    for name, rec in self._names.items()
                    for e in rec["versions"]
                    if e.dispatcher is not None
                    and e.dispatcher.device_error}

    def stats(self) -> Dict[str, Any]:
        """Per model, its active version's latency stats (empty before
        its first page-in)."""
        with self._cond:
            out = {}
            for name in self._names:
                d = self._entry_locked(name).dispatcher
                out[name] = d.stats() if d is not None else {}
            return out

    def captures(self) -> int:
        """CUDA graphs captured over every stack (0 on the CPU): a rung
        and row width a stack, whatever the page-ins."""
        with self._cond:
            return sum(st.programs.captures for v in self._stacks.values()
                       for st in v)

    def fleet_stats(self) -> Dict[str, Any]:
        with self._cond:
            families = {
                str(k): sum(1 for st in v for o in st.occupant
                            if o is not None)
                for k, v in self._stacks.items()
            }
            return {
                "resident": self._resident,
                "capacity": self.capacity,
                "models": len(self._names),
                "pages_in": self._pages_in,
                "evictions": self._evictions,
                "families": families,
                "stacks": sum(len(v) for v in self._stacks.values()),
                "captures": sum(st.programs.captures
                                for v in self._stacks.values() for st in v),
            }

    def close(self) -> None:
        """Shutdown: close every tenant's batcher."""
        with self._cond:
            entries = [e for rec in self._names.values()
                       for e in rec["versions"]]
        for e in entries:
            if e.batcher is not None:
                e.batcher.close()

    # -------------------------------------------------------- predict
    def predict(self, name: str, X, *, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False,
                via_queue: bool = False, version: Optional[int] = None,
                deadline_s: Optional[float] = None) -> np.ndarray:
        """ModelRegistry.predict over the fleet: resolve the active
        version, pin it resident for the whole request (paging it in when
        cold), score through its dispatcher, release once the output is
        on the host. The pin spans a queued request's submit and result,
        so every request coalesced into a device call holds its model in
        place."""
        with self._cond:
            entry = self._entry_locked(name, version)
        self._acquire(entry)
        try:
            d = entry.dispatcher  # fixed while the pin holds the slot
            if pred_leaf:
                return d.predict_leaf(X, start_iteration, num_iteration)
            if pred_contrib:
                return d.predict_contrib(X, start_iteration, num_iteration)
            batcher = None
            if via_queue and start_iteration == 0 and num_iteration == -1:
                with self._cond:
                    if not entry.retired:
                        if entry.batcher is None or \
                                entry.batcher.dispatcher is not d:
                            from .dispatch import MicroBatcher

                            if entry.batcher is not None:
                                entry.batcher.close()
                            entry.batcher = MicroBatcher(
                                d, deadline_s=entry.deadline_s,
                                queue_cap=entry.queue_cap)
                        batcher = entry.batcher
            if batcher is not None:
                raw = batcher.submit(X, deadline_s=deadline_s).result().T
            else:
                raw = d.score_raw(X, start_iteration, num_iteration)
            if not raw_score:
                raw = entry.booster._gbdt.convert_output(raw)
            K = entry.meta["num_class"]
            return raw[0] if K == 1 else raw.T
        finally:
            self._release(entry)
