"""The port's collective layer: a mesh axis over torch.distributed.

The JAX package names a mesh axis ("data" or "feature") and its growers
call lax.psum / psum_scatter / all_gather over it inside one program.
Here each rank is one process with one device, and a Mesh holds what
the growers need to reach the others: the process group, the axis name,
this rank, the group's size, its backend and the device.

- all_reduce (sum or max), reduce_scatter (tiled on one dimension,
  padded to a multiple of the size) and all_gather, on tensors of the
  mesh's device;
- the dtype policy: neither gloo nor NCCL reduces int16 (nor int8 or
  bool), so where the JAX package puts int16 on the wire
  (histogram.rs_wire_dtype) the port puts int32, on both backends
  (wire_dtype). The counters report the bytes actually sent;
- staging: gloo reduces host tensors. A CUDA tensor under gloo is copied
  into a pinned host buffer, reduced there and copied back, explicitly
  (WireStats.staged_bytes counts it). The backend is the group's, named
  in every report: nothing here switches backend.

NCCL is the backend on the card, gloo on the CPU; several gloo ranks may
share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# dtypes neither backend reduces: they cross the wire as int32
_WIDEN = (torch.int8, torch.uint8, torch.int16, torch.bool)


def wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor of `dtype` crosses the wire in: int32 for the
    integer types narrower than 32 bits (and bool), else itself."""
    return torch.int32 if dtype in _WIDEN else dtype


@dataclass
class WireStats:
    """What one mesh's collectives sent: per operation its calls and
    payload bytes (after widening and padding), the host seconds they
    took (staging included), and the bytes staged through host memory."""

    calls: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)
    staged_bytes: int = 0

    def add(self, op: str, nbytes: int, seconds: float) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)
        self.seconds[op] = self.seconds.get(op, 0.0) + float(seconds)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds.values())

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()
        self.staged_bytes = 0

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": dict(self.seconds),
                "staged_bytes": self.staged_bytes,
                "total_bytes": self.total_bytes}


class Mesh:
    """One axis over a process group: this rank's place in it and the
    device its tensors live on (the JAX package's Mesh and axis name).
    group None is the default (world) group."""

    def __init__(self, group=None, axis_name: str = "data",
                 device: Optional[torch.device] = None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed initialized "
                               "(parallel.multihost.init_distributed)")
        self.group = group
        self.axis_name = axis_name
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device if device is not None else "cpu")
        self.stats = WireStats()

    def __repr__(self) -> str:
        return (f"Mesh(axis={self.axis_name!r}, rank={self.rank}, "
                f"size={self.size}, backend={self.backend}, "
                f"device={self.device})")

    def describe(self) -> dict:
        return {"axis": self.axis_name, "rank": self.rank, "size": self.size,
                "backend": self.backend, "device": str(self.device),
                "staged": self.staging(self.device)}

    # ------------------------------------------------------------ staging
    def staging(self, device) -> bool:
        """Whether a tensor on `device` goes through pinned host memory:
        under gloo, every CUDA tensor does."""
        return self.backend == "gloo" and torch.device(device).type == "cuda"

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        w = t.to(wire_dtype(t.dtype))
        if self.staging(t.device):
            host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
            host.copy_(w)
            self.stats.staged_bytes += host.numel() * host.element_size()
            return host
        return w.contiguous()

    def _from_wire(self, w: torch.Tensor, like: torch.Tensor
                   ) -> torch.Tensor:
        if w.device != like.device:
            w = w.to(like.device)
        return w

    # -------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max) of t over the axis, in t's wire dtype, on t's
        device."""
        t0 = time.perf_counter()
        w = self._to_wire(t)
        dist.all_reduce(w, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        out = self._from_wire(w, t)
        self.stats.add(f"all_reduce_{op}", w.numel() * w.element_size(),
                       time.perf_counter() - t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of t over the axis, tiled on `dim`: this rank's block
        of ceil(t.shape[dim] / size) entries (lax.psum_scatter with
        tiled=True), the dimension padded with zeros to a multiple of the
        size."""
        t0 = time.perf_counter()
        n = self.size
        d = dim % t.dim()
        size_d = t.shape[d]
        blk = -(-size_d // n)
        x = t.movedim(d, 0)
        if blk * n != size_d:
            pad = torch.zeros((blk * n - size_d,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad])
        w = self._to_wire(x)
        out = torch.empty((blk,) + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device,
                          pin_memory=w.device.type == "cpu"
                          and self.staging(t.device))
        dist.reduce_scatter_tensor(out, w, group=self.group)
        out = self._from_wire(out, t).movedim(0, d)
        self.stats.add("reduce_scatter", w.numel() * w.element_size(),
                       time.perf_counter() - t0)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        t0 = time.perf_counter()
        w = self._to_wire(t.reshape((1,) + tuple(t.shape)))
        # the output concatenates the ranks' inputs along dimension 0
        out = torch.empty((self.size,) + tuple(t.shape), dtype=w.dtype,
                          device=w.device)
        dist.all_gather_into_tensor(out, w, group=self.group)
        out = self._from_wire(out, t)
        self.stats.add("all_gather", w.numel() * w.element_size(),
                       time.perf_counter() - t0)
        return out

    # ----------------------------------------------------- host helpers
    def gather_rows(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's host array of uneven leading length, concatenated
        in rank order (multihost.gather_host_rows): lengths first, rows
        padded to the longest, trimmed after the gather."""
        arr = np.ascontiguousarray(arr)
        hd = self._host_dev()
        counts = self.all_gather(torch.tensor([arr.shape[0]],
                                              dtype=torch.int64, device=hd)
                                 ).reshape(-1).cpu().numpy()
        mx = int(counts.max())
        pad = np.zeros((mx,) + arr.shape[1:], arr.dtype)
        pad[:arr.shape[0]] = arr
        raw = torch.from_numpy(pad.reshape(mx, -1).view(np.uint8).copy())
        g = self.all_gather(raw.to(hd)).to(torch.uint8).cpu().numpy()
        rows = np.ascontiguousarray(g).view(arr.dtype).reshape(
            (self.size, mx) + arr.shape[1:])
        return np.concatenate([rows[i, :counts[i]]
                               for i in range(self.size)])

    def _host_dev(self) -> torch.device:
        """Where host-side helper tensors go: NCCL reduces CUDA tensors
        only, gloo host tensors."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(axis_name: str = "data", device=None, min_size: int = 2
              ) -> Optional[Mesh]:
    """A Mesh over the default group, or None when torch.distributed is
    not initialized or has fewer than min_size ranks (one rank trains
    serially, as the JAX package does on one device). min_size=1 gives
    a one-rank mesh whose collectives still run (the card's NCCL path at
    world size 1)."""
    if world_size() < max(1, int(min_size)) or not dist.is_initialized():
        return None
    return Mesh(None, axis_name, device)
