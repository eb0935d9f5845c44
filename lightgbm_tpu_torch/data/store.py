"""Disk-backed chunked columnar store (the port of
lightgbm_tpu/data/store.py, in its file format).

A spool directory holds fixed-row-count chunks of feature columns:

    spool/
      manifest.json          # atomic (tmp + fsync + os.replace)
      chunk_000000.npz       # "cols" (F, rows) + optional 1-D metadata
      chunk_000001.npz       # (a binned store: "bins" (G, rows))
      ...

Durability: a chunk is written to ``<name>.tmp``, fsynced, read back for
its byte size and crc32, renamed into place with ``os.replace``, the
directory fsynced, and only then listed in the manifest, which is
rewritten atomically (resilience/checkpoint.atomic_write_json) after
every commit. A kill at any instant leaves a committed prefix
(:meth:`ChunkStore.resume` continues it) and at most an ignored ``.tmp``
straggler; never a chunk the manifest lists and the disk lacks. Reads
check size and crc32 before deserializing, so a truncated or flipped
chunk raises :class:`ChunkIntegrityError` naming the chunk and the byte
offset.

Chunks are columnar ((F, rows), features major), so pass 2 bins each
feature from one contiguous row.
"""

from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .. import log
from ..resilience.checkpoint import atomic_write_json

MANIFEST_SCHEMA = "lightgbm-tpu/chunk-store/v1"
MANIFEST_NAME = "manifest.json"
DEFAULT_CHUNK_ROWS = 65536

# per-row metadata arrays a chunk may carry beside its columns
_META_KEYS = ("label", "weight", "init_score", "position", "qid")


class ChunkStoreError(Exception):
    """A malformed spool directory, or a misuse of the store."""


class ChunkIntegrityError(ChunkStoreError):
    """A chunk failed its size / crc32 check: the read fails, naming the
    chunk and the byte offset."""


def _crc_and_size(path: Path) -> Tuple[int, int]:
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            crc = zlib.crc32(block, crc)
            size += len(block)
    return crc & 0xFFFFFFFF, size


class ChunkStore:
    """One spool directory of fixed-row-count columnar chunks.

    ``kind`` is "raw" (float feature columns) or "binned" ((G, rows)
    bin columns, the pass-2 output). Every chunk but the last holds
    ``chunk_rows`` rows; the manifest records each chunk's ``row0``
    too."""

    def __init__(self, root: Path, manifest: Dict[str, Any],
                 writable: bool = False):
        self.root = Path(root)
        self.manifest = manifest
        self.writable = writable
        self._buf: List[Dict[str, np.ndarray]] = []
        self._buf_rows = 0

    # ------------------------------------------------------------ open
    @classmethod
    def create(cls, root, n_features: int, chunk_rows: int = 0,
               kind: str = "raw", value_dtype: str = "float64",
               feature_names: Optional[List[str]] = None,
               extra: Optional[Dict[str, Any]] = None) -> "ChunkStore":
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        if (root / MANIFEST_NAME).exists():
            raise ChunkStoreError(
                f"refusing to create over an existing spool at {root} "
                "(open/resume it, or point data_spool_dir elsewhere)")
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "kind": kind,
            "n_features": int(n_features),
            "chunk_rows": int(chunk_rows or DEFAULT_CHUNK_ROWS),
            "value_dtype": value_dtype,
            "feature_names": list(feature_names or []),
            "total_rows": 0,
            "complete": False,
            "chunks": [],
            "extra": dict(extra or {}),
        }
        store = cls(root, manifest, writable=True)
        store._write_manifest()
        return store

    @classmethod
    def open(cls, root) -> "ChunkStore":
        root = Path(root)
        mpath = root / MANIFEST_NAME
        if not mpath.exists():
            raise ChunkStoreError(f"no chunk-store manifest at {mpath}")
        manifest = json.loads(mpath.read_text())
        if manifest.get("schema") != MANIFEST_SCHEMA:
            raise ChunkStoreError(
                f"{mpath}: schema {manifest.get('schema')!r} is not "
                f"{MANIFEST_SCHEMA!r}")
        return cls(root, manifest, writable=False)

    @classmethod
    def resume(cls, root) -> "ChunkStore":
        """Reopen an interrupted spool for appending: the committed
        prefix stays, ``.tmp`` stragglers of the crashed writer go, and
        appending continues from ``total_rows``."""
        store = cls.open(root)
        if store.manifest["complete"]:
            raise ChunkStoreError(
                f"spool at {root} is already finalized; nothing to resume")
        for straggler in store.root.glob("*.tmp"):
            log.warning(
                f"chunk store {store.root}: discarding uncommitted "
                f"{straggler.name} left by an interrupted writer")
            straggler.unlink()
        store.writable = True
        return store

    # ------------------------------------------------------ properties
    @property
    def kind(self) -> str:
        return self.manifest["kind"]

    @property
    def n_features(self) -> int:
        return int(self.manifest["n_features"])

    @property
    def chunk_rows(self) -> int:
        return int(self.manifest["chunk_rows"])

    @property
    def total_rows(self) -> int:
        return int(self.manifest["total_rows"])

    @property
    def num_chunks(self) -> int:
        return len(self.manifest["chunks"])

    @property
    def complete(self) -> bool:
        return bool(self.manifest["complete"])

    def spool_bytes(self) -> int:
        return sum(int(c["bytes"]) for c in self.manifest["chunks"])

    def has_meta(self, key: str) -> bool:
        return any(key in c.get("keys", ()) for c in self.manifest["chunks"])

    # --------------------------------------------------------- writing
    def _chunk_path(self, idx: int) -> Path:
        return self.root / f"chunk_{idx:06d}.npz"

    def _write_manifest(self) -> None:
        atomic_write_json(str(self.root / MANIFEST_NAME), self.manifest)

    def _commit_chunk(self, arrays: Dict[str, np.ndarray], rows: int) -> None:
        idx = self.num_chunks
        path = self._chunk_path(idx)
        tmp = Path(str(path) + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        crc, size = _crc_and_size(tmp)
        os.replace(tmp, path)
        dir_fd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self.manifest["chunks"].append({
            "file": path.name,
            "row0": self.total_rows,
            "rows": int(rows),
            "bytes": int(size),
            "crc32": int(crc),
            "keys": sorted(arrays),
        })
        self.manifest["total_rows"] = self.total_rows + int(rows)
        self._write_manifest()

    def append_rows(self, X: np.ndarray, **meta: Optional[np.ndarray]
                    ) -> None:
        """Append a (rows, F) row-major block, with aligned 1-D metadata
        (``label / weight / init_score / position / qid``). Blocks are
        re-cut to chunk_rows; at most one chunk of rows is buffered."""
        if not self.writable:
            raise ChunkStoreError("store opened read-only")
        if self.complete:
            raise ChunkStoreError("store already finalized")
        X = np.asarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] != self.n_features:
            raise ChunkStoreError(
                f"block has {X.shape[1]} features, store has "
                f"{self.n_features}")
        bad = set(meta) - set(_META_KEYS)
        if bad:
            raise ChunkStoreError(f"unknown metadata keys {sorted(bad)}")
        entry = {"X": X}
        for k, v in meta.items():
            if v is None:
                continue
            v = np.asarray(v).ravel()
            if len(v) != X.shape[0]:
                raise ChunkStoreError(
                    f"metadata {k!r} has {len(v)} rows, block has "
                    f"{X.shape[0]}")
            entry[k] = v
        self._buf.append(entry)
        self._buf_rows += X.shape[0]
        while self._buf_rows >= self.chunk_rows:
            self._flush_chunk(self.chunk_rows)

    def append_binned(self, bins: np.ndarray) -> None:
        """Append one (G, rows) binned chunk as it is (pass 2 keeps the
        raw chunks' boundaries)."""
        if not self.writable:
            raise ChunkStoreError("store opened read-only")
        if self.kind != "binned":
            raise ChunkStoreError("append_binned on a non-binned store")
        self._commit_chunk({"bins": np.ascontiguousarray(bins)},
                           bins.shape[1])

    def _flush_chunk(self, rows: int) -> None:
        """Cut exactly `rows` rows off the buffer into one committed
        columnar chunk."""
        take: List[Dict[str, np.ndarray]] = []
        need = rows
        while need > 0:
            entry = self._buf[0]
            n = entry["X"].shape[0]
            if n <= need:
                take.append(self._buf.pop(0))
                need -= n
            else:
                take.append({k: v[:need] for k, v in entry.items()})
                self._buf[0] = {k: v[need:] for k, v in entry.items()}
                need = 0
        self._buf_rows -= rows
        X = (take[0]["X"] if len(take) == 1
             else np.concatenate([t["X"] for t in take], axis=0))
        arrays: Dict[str, np.ndarray] = {"cols": np.ascontiguousarray(X.T)}
        for k in _META_KEYS:
            if any(k in t for t in take):
                if not all(k in t for t in take):
                    raise ChunkStoreError(
                        f"metadata {k!r} supplied for some appended "
                        "blocks but not others")
                arrays[k] = np.concatenate([t[k] for t in take])
        self._commit_chunk(arrays, rows)

    def finalize(self) -> "ChunkStore":
        """Flush the tail chunk and mark the spool complete."""
        if not self.writable:
            raise ChunkStoreError("store opened read-only")
        if self._buf_rows:
            self._flush_chunk(self._buf_rows)
        self.manifest["complete"] = True
        self._write_manifest()
        return self

    # --------------------------------------------------------- reading
    def chunk_meta(self, idx: int) -> Dict[str, Any]:
        return self.manifest["chunks"][idx]

    def read_chunk(self, idx: int) -> Dict[str, np.ndarray]:
        """Read and verify one chunk: size and crc32 against the
        manifest before deserializing; a failure raises
        :class:`ChunkIntegrityError` naming the chunk and the byte
        offset where the file stops matching."""
        meta = self.chunk_meta(idx)
        path = self.root / meta["file"]
        if not path.exists():
            raise ChunkIntegrityError(
                f"chunk {idx} ({path}) is missing from the spool "
                f"(manifest expects {meta['bytes']} bytes)")
        actual = path.stat().st_size
        expected = int(meta["bytes"])
        if actual != expected:
            raise ChunkIntegrityError(
                f"chunk {idx} ({path}) truncated/corrupt at byte "
                f"offset {min(actual, expected)}: expected {expected} "
                f"bytes, found {actual}")
        crc, _size = _crc_and_size(path)
        if crc != int(meta["crc32"]):
            raise ChunkIntegrityError(
                f"chunk {idx} ({path}) corrupt: crc32 {crc:#010x} != "
                f"manifest {int(meta['crc32']):#010x} over byte offsets "
                f"[0, {expected})")
        try:
            with np.load(path, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 — degrade to the loud path
            raise ChunkIntegrityError(
                f"chunk {idx} ({path}) passed crc but failed to "
                f"deserialize: {e}") from e

    def iter_chunks(self) -> Iterator[Tuple[int, int, Dict[str, np.ndarray]]]:
        """(chunk index, row0, arrays) in order, one chunk at a time."""
        for idx in range(self.num_chunks):
            meta = self.chunk_meta(idx)
            yield idx, int(meta["row0"]), self.read_chunk(idx)

    def gather_meta(self, key: str) -> Optional[np.ndarray]:
        """One per-row metadata column across the chunks (O(N) scalars,
        kept in RAM as the reference keeps its Metadata)."""
        if not self.has_meta(key):
            return None
        parts = []
        for idx in range(self.num_chunks):
            arrays = self.read_chunk(idx)
            if key not in arrays:
                raise ChunkStoreError(
                    f"metadata {key!r} present in some chunks but "
                    f"missing from chunk {idx}")
            parts.append(arrays[key])
        return np.concatenate(parts)


class SpooledData:
    """A raw spool that flows through the Dataset / sklearn API in place
    of a matrix: basic.Dataset.construct takes the chunked path on it
    without concatenating it on the host."""

    def __init__(self, store: ChunkStore):
        if store.kind != "raw":
            raise ChunkStoreError("SpooledData wraps a raw store")
        self.store = store

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.store.total_rows, self.store.n_features)

    def __len__(self) -> int:
        return self.store.total_rows


# ---------------------------------------------------------------------------
# spoolers: numpy / row-block iterators / delimited text
# ---------------------------------------------------------------------------
def spool_numpy(X: np.ndarray, root, chunk_rows: int,
                **meta: Optional[np.ndarray]) -> ChunkStore:
    """Spool an in-RAM matrix chunk by chunk (float32 stays float32)."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    store = ChunkStore.create(root, n_features=X.shape[1],
                              chunk_rows=chunk_rows,
                              value_dtype=str(X.dtype))
    for lo in range(0, X.shape[0], chunk_rows):
        sl = slice(lo, lo + chunk_rows)
        store.append_rows(
            X[sl], **{k: (None if v is None else np.asarray(v)[sl])
                      for k, v in meta.items()})
    return store.finalize()


def spool_blocks(blocks: Iterable[np.ndarray], root, chunk_rows: int,
                 n_features: Optional[int] = None) -> ChunkStore:
    """Spool any iterator of (rows, F) blocks; n_features defaults to
    the first block's."""
    store: Optional[ChunkStore] = None
    for block in blocks:
        block = np.asarray(block)
        if block.ndim == 1:
            block = block.reshape(1, -1)
        if store is None:
            store = ChunkStore.create(
                root, n_features=(n_features if n_features is not None
                                  else block.shape[1]),
                chunk_rows=chunk_rows)
        store.append_rows(block)
    if store is None:
        raise ChunkStoreError("cannot spool an empty block iterator")
    return store.finalize()


def spool_text_file(path, root, chunk_rows: int, *,
                    header: bool = False, label_column: Any = 0,
                    weight_column: Any = "", group_column: Any = "",
                    ignore_column: Any = "",
                    ) -> Tuple[ChunkStore, List[str]]:
    """Spool a delimited text file (CSV / TSV) in one sequential pass
    through parsers.iter_text_chunks, host memory O(chunk); label,
    weight and query columns become per-chunk metadata. Returns (the
    finalized store, the feature names). LibSVM raises ChunkStoreError
    (the caller falls back to the whole-file loader)."""
    from ..parsers import delimited_layout, iter_text_chunks

    p = Path(path)
    if not p.exists():
        log.fatal(f"data file {path} does not exist")
    layout = delimited_layout(p, header, label_column, weight_column,
                              group_column, ignore_column)
    if layout is None:
        raise ChunkStoreError(
            "chunked spooling supports delimited formats; LibSVM needs "
            "the whole-file loader")
    delim, skip, keep, feat_names, lbl_idx, w_idx, g_idx = layout
    store = ChunkStore.create(root, n_features=len(keep),
                              chunk_rows=chunk_rows,
                              feature_names=feat_names,
                              extra={"source": str(p)})
    for chunk in iter_text_chunks(p, delim, skip, chunk_rows):
        store.append_rows(
            chunk[:, keep],
            label=chunk[:, lbl_idx] if lbl_idx is not None else None,
            weight=chunk[:, w_idx] if w_idx is not None else None,
            qid=chunk[:, g_idx] if g_idx is not None else None)
    return store.finalize(), feat_names
