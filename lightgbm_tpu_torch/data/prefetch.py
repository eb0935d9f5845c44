"""Chunk prefetch and the device assembly of a streamed bin matrix (the
port of lightgbm_tpu/data/prefetch.py, redesigned for the card).

While the card takes chunk *k*, a reader thread prepares chunk *k+1*:
it reads the chunk from the binned spool, verifies it, and copies its
bins, in their stored dtype (uint8 for <= 256 bins), into a free pinned
host slot. It makes no CUDA call. The main thread then

- copies the slot to a device staging buffer with
  ``copy_(..., non_blocking=True)`` on a side ``torch.cuda.Stream``,
- widens it to int32 into ``buf[:, lo:lo + rows]`` on the same stream,
- records an event on the slot, and hands the slot back to the reader
  only once that event has completed (a slot reused while its copy is in
  flight would corrupt bins silently);

and after the last chunk the training stream waits on the copy stream.
The slots are ``depth`` page-locked (G, chunk_rows) buffers allocated
once before chunk 0; free slots return through a bounded queue. The JAX
package widens each chunk to int32 on the host and transfers that: the
stored dtype is a quarter of the bytes over PCIe, and a pinned source
needs no pageable staging copy. On the CPU the same classes run without
pinning or streams.

Thread discipline (the JAX package's concurrency lint): every queue has
an explicit maxsize, puts wait with a timeout under a stop event, and an
error on the reader thread crosses to the consumer with its traceback
chained.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

DEFAULT_PREFETCH_DEPTH = 2

# sentinel chunk index for an exception crossing the thread boundary
_ERR = -1


def read_rss_mb() -> float:
    """This process's resident set size in MB (/proc/self/statm; 0.0
    where it cannot be read)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except (OSError, ValueError, IndexError):
        return 0.0


def prefetch_depth(chunk_bytes: int, budget_bytes: int) -> int:
    """Queue depth that keeps (depth + 1) chunks inside the RAM budget,
    clamped to [1, DEFAULT_PREFETCH_DEPTH] (the JAX package's formula)."""
    if chunk_bytes <= 0:
        return DEFAULT_PREFETCH_DEPTH
    fit = budget_bytes // max(1, chunk_bytes) - 1
    return int(max(1, min(DEFAULT_PREFETCH_DEPTH * 2, fit,
                          DEFAULT_PREFETCH_DEPTH)))


class ChunkPrefetcher:
    """A background reader yielding chunks in order.

    ``load_fn(idx)`` runs on the reader thread and is host-only: it
    reads and verifies chunk ``idx`` and returns (array, payload). With
    ``slots`` (``depth`` writable flat numpy buffers, the views of pinned
    host memory), the reader waits for a free slot, copies the array
    into its head and yields the slot's index; the consumer gives it back
    with :meth:`release` once the card has read it. Without slots the
    array itself is yielded. The consumer iterates (idx, array or slot,
    payload)."""

    def __init__(self, load_fn: Callable[[int], Tuple[np.ndarray, Any]],
                 n_chunks: int, depth: int = DEFAULT_PREFETCH_DEPTH,
                 slots: Optional[List[np.ndarray]] = None):
        self._load = load_fn
        self._n = int(n_chunks)
        self._slots = slots
        depth = max(1, int(depth))
        # bounded: the reader blocks once `depth` chunks are ready
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._free: "queue.Queue" = queue.Queue(
            maxsize=len(slots) if slots else 1)
        for i in range(len(slots) if slots else 0):
            self._free.put_nowait(i)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._reader_loop, name="chunk-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _free_slot(self) -> Optional[int]:
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    def _reader_loop(self) -> None:
        try:
            for idx in range(self._n):
                if self._stop.is_set():
                    return
                arr, payload = self._load(idx)
                if self._slots is not None:
                    slot = self._free_slot()
                    if slot is None:
                        return
                    head = self._slots[slot][:arr.size]
                    head.reshape(arr.shape)[...] = arr
                    arr = slot
                if not self._put((idx, arr, payload)):
                    return
            self._put(None)
        except BaseException as e:  # noqa: BLE001 — to the consumer
            try:
                self._q.put((_ERR, None, e), timeout=5.0)
            except queue.Full:
                pass

    def __iter__(self) -> Iterator[Tuple[int, Any, Any]]:
        expect = 0
        while True:
            item = self._q.get()
            if item is None:
                if expect != self._n:
                    raise RuntimeError(
                        f"prefetcher ended after {expect} of {self._n} "
                        "chunks")
                return
            idx, buf, payload = item
            if idx == _ERR:
                raise RuntimeError("chunk prefetch reader failed") from payload
            if idx != expect:
                raise RuntimeError(
                    f"prefetcher yielded chunk {idx}, expected {expect}")
            expect += 1
            yield idx, buf, payload

    def release(self, slot: int) -> None:
        """Give a slot back to the reader (the card is done with it)."""
        self._free.put_nowait(slot)

    def close(self) -> None:
        """Stop the reader and join it (idempotent; safe mid-iteration)."""
        self._stop.set()
        # drain so a blocked put() sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc: Any) -> Optional[bool]:
        self.close()
        return None


class _Slots:
    """The card's side of the assembly: ``depth`` pinned host slots
    (flat, the stored dtype), a device staging buffer each, a side copy
    stream and the event of each slot's last copy."""

    def __init__(self, torch, device, depth: int, elems: int, np_dtype):
        tdt = {np.dtype(np.uint8): torch.uint8,
               np.dtype(np.uint16): torch.int16,  # widened & 0xFFFF
               np.dtype(np.int32): torch.int32}[np.dtype(np_dtype)]
        self.torch = torch
        self.u16 = np.dtype(np_dtype) == np.uint16
        self.pinned = [torch.empty(elems, dtype=tdt, pin_memory=True)
                       for _ in range(depth)]
        # the reader writes through these views (numpy, no CUDA call)
        self.views = [p.numpy().view(np_dtype) for p in self.pinned]
        self.staging = [torch.empty(elems, dtype=tdt, device=device)
                        for _ in range(depth)]
        self.stream = torch.cuda.Stream(device=device)
        self.events: Dict[int, Any] = {}
        self.in_flight: List[int] = []
        self.copy_ms: List[float] = []  # each chunk's H2D copy, in order
        self.h2d_ms = 0.0
        self.h2d_bytes = 0
        self.timers: List[Tuple[Any, Any]] = []

    def copy(self, slot: int, shape: Tuple[int, int], buf, lo: int) -> None:
        torch = self.torch
        n = shape[0] * shape[1]
        src, stage = self.pinned[slot][:n], self.staging[slot][:n]
        dst = buf[:, lo:lo + shape[1]]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            # t0 fires as soon as the idle stream reaches it: the host's
            # gap before the copy is enqueued (the reader thread holds the
            # GIL at times) counts in the copy's time, so keep it to one
            # call
            t0.record()
            stage.copy_(src, non_blocking=True)
            t1.record()
            dst.copy_(stage.view(shape))  # widened to int32 on the card
            if self.u16:
                dst &= 0xFFFF
            ev = torch.cuda.Event()
            ev.record()
        self.timers.append((t0, t1))
        self.h2d_bytes += n * self.pinned[slot].element_size()
        self.events[slot] = ev
        self.in_flight.append(slot)

    def reclaim(self, pf: ChunkPrefetcher, block: bool) -> None:
        """Hand back every slot whose copy has completed; with ``block``,
        wait for the oldest first (every slot is in flight, so the reader
        cannot go on)."""
        if block and self.in_flight:
            self.events[self.in_flight[0]].synchronize()
        for slot in list(self.in_flight):
            if self.events[slot].query():
                self.in_flight.remove(slot)
                pf.release(slot)

    def finish(self) -> None:
        """The training stream waits on the copy stream; the copies are
        complete before the slots can be freed."""
        torch = self.torch
        torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)
        self.stream.synchronize()
        self.copy_ms = [a.elapsed_time(b) for a, b in self.timers]
        self.h2d_ms = sum(self.copy_ms)


def assemble(buf, n_chunks: int, load: Callable[[int], Tuple[np.ndarray,
                                                              Any]],
             depth: int, chunk_elems: int, np_dtype
             ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Fill the zeroed (G, Np) int32 tensor ``buf`` from ``n_chunks``
    chunks: ``load(idx)`` -> ((G, rows) bins in ``np_dtype``, {"lo": the
    first row, "shape": (G, rows)}). On a CUDA ``buf`` through pinned
    slots on a copy stream (each chunk's record gains its copy's
    ``h2d_ms``), on a CPU one by plain copies. Returns (the per-chunk
    records, the transfer's numbers)."""
    import torch

    on_card = buf.device.type == "cuda"
    slots = None
    if on_card:
        # buf's zero fill (the training stream) precedes every copy
        slots = _Slots(torch, buf.device, depth, chunk_elems, np_dtype)
        slots.stream.wait_stream(torch.cuda.current_stream(buf.device))
    per_chunk: List[Dict[str, Any]] = []
    prev_rss = read_rss_mb()
    with ChunkPrefetcher(load, n_chunks, depth=depth,
                         slots=None if slots is None else slots.views) as pf:
        for idx, item, info in pf:
            lo, (_g, rows) = info["lo"], info["shape"]
            if slots is not None:
                slots.copy(item, info["shape"], buf, lo)
            else:  # the CPU: the host array itself, widened by the copy
                if item.dtype == np.uint16:
                    item = item.astype(np.int32)
                buf[:, lo:lo + rows] = torch.from_numpy(item)
            rss = read_rss_mb()
            per_chunk.append({"chunk": idx, "rows": int(rows),
                              "rss_mb": round(rss, 1),
                              "rss_delta_mb": round(rss - prev_rss, 1)})
            prev_rss = rss
            if slots is not None:
                # every slot in flight: the reader waits for the oldest
                slots.reclaim(pf, block=len(slots.in_flight) == depth)
    if slots is None:
        return per_chunk, {"h2d_bytes": 0, "h2d_seconds": 0.0,
                           "pinned_mb": 0.0}
    slots.finish()
    for rec, ms in zip(per_chunk, slots.copy_ms):
        rec["h2d_ms"] = ms
    return per_chunk, {
        "h2d_bytes": int(slots.h2d_bytes),
        "h2d_seconds": slots.h2d_ms / 1e3,
        "pinned_mb": depth * chunk_elems * np.dtype(np_dtype).itemsize
        / (1 << 20),
    }

