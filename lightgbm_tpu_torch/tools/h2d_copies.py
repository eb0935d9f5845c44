"""Where the data plane's per-chunk host-to-device copy time goes, on
one card.

    python3 -m lightgbm_tpu_torch.tools.h2d_copies

The streamed assembly (data/prefetch.py) times each chunk's copy between
two CUDA events on its copy stream. This script copies 14 chunks of 28 x
73,728 uint8 bins (chip_smoke's data_plane shape) through the same
pinned slots (``prefetch._Slots``, depth 2) in five settings and prints
one JSON line of each copy's milliseconds:

- ``queued``: ten back-to-back copies of one chunk, the stream never
  idle, so each event pair brackets the copy alone (the link);
- ``serial``: the main thread fills a slot, then copies it (the stream
  idle at each first event, so the copy's enqueue counts in);
- ``serial_gap_1ms``: the same with 1 ms between the fill and the copy;
- ``serial_numpy_thread`` / ``serial_python_thread``: the same beside a
  thread running crc32 and numpy (it releases the GIL) or pure Python
  (it holds the GIL up to the interpreter's switch interval);
- ``assemble``: ``prefetch.assemble`` with its reader thread loading the
  chunks from memory.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
import zlib

import numpy as np

G, ROWS, DEPTH, CHUNKS = 28, 73728, 2, 14


def _serial(torch, pf, dev, buf, data, gap_s=0.0, background=None):
    n = G * ROWS
    slots = pf._Slots(torch, dev, DEPTH, n, np.uint8)
    slots.stream.wait_stream(torch.cuda.current_stream(dev))
    stop = threading.Event()  # lint: allow[per-call-lock] — shared with the thread this call starts
    th = None
    if background is not None:
        th = threading.Thread(target=background, args=(stop,), daemon=True)
        th.start()
    try:
        for i in range(CHUNKS):
            s = i % DEPTH
            if s in slots.events:
                slots.events[s].synchronize()
            slots.views[s][:n].reshape(G, ROWS)[...] = data[i]
            if gap_s:
                time.sleep(gap_s)
            slots.copy(s, (G, ROWS), buf, i * ROWS)
        slots.finish()
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=10)
    return slots.copy_ms


def _numpy_work(stop):
    b = np.random.bytes(2 << 20)
    while not stop.is_set():
        zlib.crc32(b)
        np.frombuffer(b, np.uint8).astype(np.int32).sum()


def _python_work(stop):
    x = 0
    while not stop.is_set():
        for i in range(1000):
            x += i


def main() -> int:
    import torch

    from lightgbm_tpu_torch.data import prefetch as pf

    if not torch.cuda.is_available():
        raise SystemExit("h2d_copies: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    data = [rs.randint(0, 255, (G, ROWS)).astype(np.uint8)
            for _ in range(CHUNKS)]
    buf = torch.zeros((G, ROWS * CHUNKS), dtype=torch.int32, device=dev)
    run = lambda **kw: _serial(torch, pf, dev, buf, data, **kw)
    run()  # warm-up
    out = {"nvidia_smi": smi, "chunk_bytes": G * ROWS,
           "serial": run(), "serial_gap_1ms": run(gap_s=0.001),
           "serial_numpy_thread": run(background=_numpy_work),
           "serial_python_thread": run(background=_python_work)}

    def load(idx):
        return data[idx], {"lo": idx * ROWS, "shape": data[idx].shape}

    per, _ = pf.assemble(buf, CHUNKS, load, DEPTH, G * ROWS, np.uint8)
    out["assemble"] = [c["h2d_ms"] for c in per]
    host = torch.empty(G * ROWS, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(G * ROWS, dtype=torch.uint8, device=dev)
    pairs = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        card.copy_(host, non_blocking=True)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    out["queued"] = [a.elapsed_time(b) for a, b in pairs]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
