"""Process helpers for the port's operations scripts and their tests.

The scripts (``serve_smoke``, ``gateway_rolling``) drive ``python -m
lightgbm_tpu_torch`` in child processes: ``task=serve`` backends, a
``task=gateway`` front end, a ``task=loop`` online loop. This module
holds what they share:

- ``free_port`` — a free local port for a child's listener, below the
  kernel's ephemeral range, so that no client connection can take it
  while its server restarts; ``wait_port_free`` before a restart;
- ``require_device`` — a run on the card refuses at once, naming it,
  when torch sees none (``--device cpu`` runs the plain versions);
- ``prebuild`` — the kernels and the native host library built once in
  the parent, so that N children starting together each load the built
  library instead of running N copies of nvcc and g++ at once;
- ``spawn`` — one child with an explicit ``device_type``, its stdout
  and stderr in a log file (a pipe that fills would block the child);
- ``wait_ready`` — ``GET /readyz`` until 200 within a deadline; a child
  that exits first raises ``ChildExited`` with the tail of its log,
  never a quiet retry;
- ``post`` / ``get`` — one JSON request, the HTTP status kept;
- ``terminate_all`` — SIGKILL to every child still running, for a
  ``finally``: no child outlives a failed run holding the card.

Host-side only: nothing here imports torch except ``require_device``
and ``prebuild``.
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

# the repository root: children import the package from here
REPO = Path(__file__).resolve().parents[2]
FAULT_ENV = "LGBMTPU_FAULT_PLAN"


class ChildExited(RuntimeError):
    """A child process ended before it was asked to."""


_HANDED: set = set()  # ports this process has handed out


def _ephemeral_low() -> int:
    try:
        return int(Path("/proc/sys/net/ipv4/ip_local_port_range")
                   .read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _bindable(port: int, reuse: bool = False) -> bool:
    s = socket.socket()
    try:
        if reuse:  # as the servers bind (allow_reuse_address)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def free_port() -> int:
    """A port no socket holds, below the ephemeral range: a server that
    restarts on it must find it free, and a port of the ephemeral range
    may meanwhile become the local end of any client's connection (a
    gateway under load opens hundreds a second)."""
    low = _ephemeral_low()
    if low > 12000:
        rng = random.SystemRandom()
        for _ in range(200):
            port = rng.randrange(10000, low)
            if port not in _HANDED and _bindable(port):
                _HANDED.add(port)
                return port
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_port_free(port: int, timeout: float = 30.0) -> None:
    """Until a server could bind ``port`` again (its last owner's
    socket is gone); TimeoutError at the deadline."""
    t0 = time.monotonic()
    while not _bindable(port, reuse=True):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"port {port} still bound {timeout:.0f} s "
                               f"after its server stopped")
        time.sleep(0.05)


def require_device(device: str) -> None:
    """SystemExit naming the card when ``device`` is cuda and torch sees
    no CUDA device."""
    if device != "cuda":
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA card: torch.cuda.is_available() is false (these "
            "scripts run on the card by default; pass --device cpu to run "
            "the plain versions on the CPU)")


def prebuild(device: str) -> Dict[str, Any]:
    """Build the native host library, and on the card the kernel library,
    in this process before any child starts; returns the build seconds."""
    from lightgbm_tpu_torch import native

    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    if device == "cuda":
        from lightgbm_tpu_torch.learner import cuda_hist

        cuda_hist.build()
        out["kernels_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError(f"the native library did not build: "
                           f"{native.BUILD_ERROR}")
    out["native_s"] = time.perf_counter() - t1
    return out


def child_env() -> Dict[str, str]:
    """This process's environment with the repository on PYTHONPATH and
    no inherited fault plan (a plan is passed as ``fault_plan=``)."""
    env = dict(os.environ)
    env.pop(FAULT_ENV, None)
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + path if path else "")
    return env


class Child:
    """A running ``python -m lightgbm_tpu_torch`` process and its log."""

    def __init__(self, name: str, proc: subprocess.Popen, log_path: Path):
        self.name = name
        self.proc = proc
        self.log_path = log_path

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def signal(self, sig: int) -> None:
        self.proc.send_signal(sig)

    def wait(self, timeout: float) -> int:
        return self.proc.wait(timeout=timeout)

    def tail(self, n: int = 2000) -> str:
        try:
            return self.log_path.read_text(errors="replace")[-n:]
        except OSError:
            return ""

    def exited(self, what: str = "exited") -> ChildExited:
        return ChildExited(f"{self.name} {what} rc={self.proc.returncode}:"
                           f"\n{self.tail()}")


def spawn(task: str, params: Dict[str, Any], device: str, log_path,
          name: Optional[str] = None, stdin=subprocess.DEVNULL,
          stdout=None) -> Child:
    """``python -m lightgbm_tpu_torch task=<task> device_type=<device>``
    plus ``params`` as key=value pairs. stderr (and stdout unless a
    stream is given) goes to ``log_path``."""
    log_path = Path(log_path)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    args = [sys.executable, "-m", "lightgbm_tpu_torch", f"task={task}",
            f"device_type={device}"]
    args += [f"{k}={v}" for k, v in params.items()]
    logf = open(log_path, "w")
    try:
        proc = subprocess.Popen(
            args, cwd=str(REPO), env=child_env(), stdin=stdin,
            stdout=logf if stdout is None else stdout, stderr=logf,
            text=True)
    finally:
        logf.close()  # the child holds its own descriptor
    return Child(name or task, proc, log_path)


def get(url: str, path: str, timeout: float = 30.0) -> Tuple[int, str]:
    """GET url+path -> (status, body text); an HTTP error's status kept."""
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def post(url: str, op: str, body: Dict[str, Any], timeout: float = 60.0
         ) -> Tuple[int, Dict[str, Any]]:
    """POST url/v1/<op> with a JSON body -> (status, JSON response); an
    HTTP error's status and body kept."""
    req = urllib.request.Request(
        f"{url}/v1/{op}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        raw = e.read().decode()
        return e.code, json.loads(raw) if raw.startswith("{") else {
            "ok": False, "error": raw}


def wait_ready(url: str, child: Child, timeout: float = 300.0,
               path: str = "/readyz") -> float:
    """Poll ``url + path`` until it answers 200; the seconds waited.
    ChildExited if the child ends first, TimeoutError at the deadline."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if child.poll() is not None:
            raise child.exited("exited before it was ready")
        try:
            with urllib.request.urlopen(url + path, timeout=2) as r:
                if r.status == 200:
                    return time.monotonic() - t0
        except (OSError, ValueError):
            pass  # not listening yet, or not ready (503)
        time.sleep(0.1)
    raise TimeoutError(f"{child.name} at {url} not ready within "
                       f"{timeout:.0f} s:\n{child.tail()}")


def stop(child: Child, sig: int = signal.SIGTERM, timeout: float = 120.0
         ) -> int:
    """Send ``sig`` and wait for the exit; the exit code."""
    child.signal(sig)
    return child.wait(timeout)


def terminate_all(children: Iterable[Optional[Child]]) -> List[int]:
    """SIGKILL every child still running and reap it; the pids killed."""
    children = [c for c in children if c is not None]
    killed = []
    for c in children:
        if c.poll() is not None:
            continue
        try:
            c.proc.kill()
            killed.append(c.pid)
        except OSError:
            pass
    for c in children:
        try:
            c.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
    return killed
