"""The native host library (fastparse.cpp), loaded through ctypes.

The port's copy of lightgbm_tpu/native/: the reference's data loader is
C++ (src/io/parser.cpp, text_reader.h), and so are these host paths:

- ``parse_delim`` / ``parse_libsvm``: CSV / TSV / LibSVM text into dense
  float64 matrices, threaded over line ranges (parsers.py);
- ``greedy_find_bin``: GreedyFindBin for features of more than 512
  distinct values (binning.py), the same double arithmetic as the
  Python loop;
- ``values_to_bins``: numerical ValueToBin over more than 32,768 values,
  threaded (binning.BinMapper.values_to_bins);
- ``PackedModel`` / ``predict_packed``: the host predictor's batch walk
  over more than 256 rows (boosting.GBDT.predict_raw), summing each row's
  leaves in tree order in float64 as the numpy walk does.

Each returns exactly what the Python path returns. The library is built
on first use with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into
``build/lgbm_torch_native/<source hash>/`` at the repository root (a
fresh checkout always builds; a changed source builds anew). Without
g++, or when the build fails, every function returns None and its caller
takes the Python path; a failed build is logged as a warning carrying
the compiler's error (``BUILD_ERROR``), and ``get_lib()`` says whether
the library is loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastparse.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lgbm_torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
BUILD_ERROR: Optional[str] = None  # the compiler's output of a failed build
BUILD_SECONDS: Optional[float] = None  # 0.0 when an earlier process built it


def source_hash() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD_ROOT / source_hash() / "_fastparse.so"


def _build(out: Path) -> bool:
    """Compile fastparse into a file of this process and thread, then
    rename it into place: a reader only ever sees a whole library, and
    concurrent builders need no lock (the rename is atomic)."""
    global BUILD_ERROR, BUILD_SECONDS
    from .. import log
    from ..obs.metrics import record_native_build

    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.build.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=180)
        if r.returncode != 0:
            BUILD_ERROR = (r.stderr or r.stdout).strip()
        else:
            os.replace(tmp, out)
            BUILD_SECONDS = time.perf_counter() - t0
            record_native_build(BUILD_SECONDS, ok=True)
            return True
    except (OSError, subprocess.TimeoutExpired) as e:
        BUILD_ERROR = f"{type(e).__name__}: {e}"
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    record_native_build(time.perf_counter() - t0, ok=False)
    log.warning("native library build failed (the numpy paths run "
                f"instead): {BUILD_ERROR[-2000:]}")
    return False


def _load_or_build() -> Optional[ctypes.CDLL]:
    """Build if missing, dlopen and bind; called outside the module lock
    (a g++ run under it would stall every thread that parses)."""
    global BUILD_ERROR, BUILD_SECONDS
    out = library_path()
    if out.exists():
        if BUILD_SECONDS is None:
            BUILD_SECONDS = 0.0
    elif not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
        _bind(lib)
    except (OSError, AttributeError) as e:
        from .. import log

        BUILD_ERROR = f"{type(e).__name__}: {e}"
        log.warning(f"native library {out} did not load: {BUILD_ERROR}")
        return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it is not loaded (no
    g++, or a failed build: BUILD_ERROR says why)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
    lib = _load_or_build()
    with _lock:
        # a loader that failed must not cache None over another
        # thread's good handle
        if not _tried or (_lib is None and lib is not None):
            _tried = True
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    lib.fp_parse_delim.restype = ctypes.c_int
    lib.fp_parse_delim.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        P(P(ctypes.c_double)), P(ctypes.c_int64), P(ctypes.c_int64),
    ]
    lib.fp_parse_libsvm.restype = ctypes.c_int
    lib.fp_parse_libsvm.argtypes = [
        ctypes.c_char_p, P(P(ctypes.c_double)), P(P(ctypes.c_double)),
        P(ctypes.c_int64), P(ctypes.c_int64),
    ]
    lib.fp_free.restype = None
    lib.fp_free.argtypes = [P(ctypes.c_double)]
    lib.fp_greedy_find_bin.restype = ctypes.c_int64
    lib.fp_greedy_find_bin.argtypes = [
        P(ctypes.c_double), P(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, P(ctypes.c_double),
    ]
    lib.fp_values_to_bins.restype = None
    lib.fp_values_to_bins.argtypes = [
        P(ctypes.c_double), ctypes.c_int64, P(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int32, P(ctypes.c_int32),
    ]
    lib.fp_predict.restype = ctypes.c_int64
    lib.fp_predict.argtypes = [
        P(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        P(ctypes.c_int32), ctypes.c_int64,
        P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_double),
        P(ctypes.c_int32), P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_int64), P(ctypes.c_double),
        P(ctypes.c_uint32), P(ctypes.c_int64), P(ctypes.c_int64),
        P(ctypes.c_double),
    ]


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _take(lib, ptr, shape) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=shape).copy()
    lib.fp_free(ptr)
    return arr


def parse_delim(path: str, delim: str, skip_rows: int
                ) -> Optional[np.ndarray]:
    """(rows, cols) float64 matrix; None when the library is not loaded
    or the file is malformed (the numpy path then parses or raises)."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.fp_parse_delim(str(path).encode(), delim.encode(),
                            int(skip_rows), ctypes.byref(out),
                            ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    return _take(lib, out, (rows.value, cols.value))


def parse_libsvm(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(labels (N,), dense features (N, F)); None when not loaded."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    lab = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.fp_parse_libsvm(str(path).encode(), ctypes.byref(out),
                             ctypes.byref(lab), ctypes.byref(rows),
                             ctypes.byref(cols))
    if rc != 0:
        return None
    feats = _take(lib, out, (rows.value, cols.value))
    labels = _take(lib, lab, (rows.value,))
    return labels, feats


def greedy_find_bin(distinct: np.ndarray, counts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int
                    ) -> Optional[np.ndarray]:
    """GreedyFindBin (binning.greedy_find_bin, reference bin.cpp:80) in
    C++, bit for bit; None when not loaded."""
    lib = get_lib()
    if lib is None:
        return None
    distinct = np.ascontiguousarray(distinct, dtype=np.float64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(max(int(max_bin), 1) + 2, dtype=np.float64)
    n = lib.fp_greedy_find_bin(
        _ptr(distinct, ctypes.c_double), _ptr(counts, ctypes.c_int64),
        len(distinct), int(max_bin), int(total_cnt), int(min_data_in_bin),
        _ptr(out, ctypes.c_double))
    return out[:n]


def values_to_bins(values: np.ndarray, bounds: np.ndarray, nan_target: int
                   ) -> Optional[np.ndarray]:
    """Numerical ValueToBin (the left search over the upper bounds, NaN
    to nan_target), threaded; None when not loaded."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.float64)
    bounds = np.ascontiguousarray(bounds, dtype=np.float64)
    out = np.empty(len(values), dtype=np.int32)
    lib.fp_values_to_bins(_ptr(values, ctypes.c_double), len(values),
                          _ptr(bounds, ctypes.c_double), len(bounds),
                          int(nan_target), _ptr(out, ctypes.c_int32))
    return out


class PackedModel:
    """A forest's host trees as flat arrays for fp_predict: per-tree node
    and leaf offsets into shared 1-D arrays (reference SingleRowPredictor
    caching, c_api.cpp:66). The decision semantics are tree.py's
    Tree.predict_leaf: decision_type bit 0 categorical, bit 1 default
    left, bits 2-3 the missing type; NaN with a missing type other than
    NaN is 0.0; a categorical NaN goes right."""

    def __init__(self, trees) -> None:
        n_nodes = [max(t.num_leaves - 1, 0) for t in trees]
        off = np.zeros(len(trees) + 1, np.int64)
        np.cumsum(n_nodes, out=off[1:])
        loff = np.zeros(len(trees) + 1, np.int64)
        np.cumsum([max(t.num_leaves, 1) for t in trees], out=loff[1:])
        tot = int(off[-1])
        self.node_off = off
        self.leaf_off = loff
        self.feature = np.zeros(tot, np.int32)
        self.threshold = np.zeros(tot, np.float64)
        self.dtype = np.zeros(tot, np.int32)
        self.left = np.zeros(tot, np.int32)
        self.right = np.zeros(tot, np.int32)
        self.leaf_value = np.zeros(int(loff[-1]), np.float64)
        self.cat_lo = np.zeros(tot, np.int64)
        self.cat_hi = np.zeros(tot, np.int64)
        catw_parts = []
        wbase = 0
        for ti, t in enumerate(trees):
            a, b = int(off[ti]), int(off[ti + 1])
            if b > a:
                self.feature[a:b] = t.split_feature[: b - a]
                self.threshold[a:b] = t.threshold[: b - a]
                self.dtype[a:b] = np.asarray(t.decision_type[: b - a],
                                             np.int32)
                self.left[a:b] = t.left_child[: b - a]
                self.right[a:b] = t.right_child[: b - a]
                cb = np.asarray(t.cat_boundaries, np.int64)
                words = np.asarray(t.cat_threshold, np.uint32)
                if len(words):
                    catw_parts.append(words)
                cat_k = a + np.flatnonzero(self.dtype[a:b] & 1)
                if len(cat_k):
                    ci = self.threshold[cat_k].astype(np.int64)
                    self.cat_lo[cat_k] = wbase + cb[ci]
                    self.cat_hi[cat_k] = wbase + cb[ci + 1]
                wbase += len(words)
            lv = np.asarray(t.leaf_value, np.float64)
            la = int(loff[ti])
            self.leaf_value[la: la + len(lv)] = lv
        self.catw = (np.concatenate(catw_parts).astype(np.uint32)
                     if catw_parts else np.zeros(1, np.uint32))
        # the widest feature referenced: X must have more columns (the
        # numpy walk raises IndexError; the C side would read past a row)
        self.max_feature = int(self.feature.max()) if tot else -1


def predict_packed(pm: PackedModel, X: np.ndarray, tree_idx: np.ndarray
                   ) -> Optional[np.ndarray]:
    """Per row, the float64 sum of the leaf outputs of the trees
    `tree_idx`, in that order; None when the library is not loaded or X
    is too narrow (the numpy walk then raises)."""
    lib = get_lib()
    if lib is None or X.shape[1] <= pm.max_feature:
        return None
    X = np.ascontiguousarray(X, dtype=np.float64)
    tree_idx = np.ascontiguousarray(tree_idx, dtype=np.int32)
    out = np.empty(X.shape[0], np.float64)
    lib.fp_predict(
        _ptr(X, ctypes.c_double), X.shape[0], X.shape[1],
        _ptr(tree_idx, ctypes.c_int32), len(tree_idx),
        _ptr(pm.node_off, ctypes.c_int64), _ptr(pm.feature, ctypes.c_int32),
        _ptr(pm.threshold, ctypes.c_double), _ptr(pm.dtype, ctypes.c_int32),
        _ptr(pm.left, ctypes.c_int32), _ptr(pm.right, ctypes.c_int32),
        _ptr(pm.leaf_off, ctypes.c_int64),
        _ptr(pm.leaf_value, ctypes.c_double),
        _ptr(pm.catw, ctypes.c_uint32), _ptr(pm.cat_lo, ctypes.c_int64),
        _ptr(pm.cat_hi, ctypes.c_int64), _ptr(out, ctypes.c_double))
    return out
