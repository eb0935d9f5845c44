"""Streaming two-pass binning over a chunk store (the port of
lightgbm_tpu/data/streaming.py).

Pass 1 reads each raw chunk once and keeps only the sampled rows: the
same ``data_random_seed`` / ``bin_construct_sample_cnt`` draw over global
row indices that the in-RAM ``BinnedDataset.from_numpy`` makes, so the
bin mappers are the in-RAM path's (and when the sample is the whole
data, the EFB layout too, which makes the fit bit-exact).

Pass 2 re-reads the chunks in order and spools the packed (G, rows) bins
into a second, "binned" store with the same chunk boundaries. No two raw
chunks are ever resident.

The resulting :class:`StreamedBinnedDataset` never holds the (G, N) host
matrix: ``device_arrays`` allocates the (G, Np) int32 matrix once on the
device, zero-filled, and fills it chunk by chunk through
prefetch.assemble (pinned slots and a copy stream on the card), recording
per-chunk RSS and the transfer for the run manifest.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import ram_budget_bytes, record_stats, warn_over_budget
from .. import log
from ..config import Config
from ..dataset import BinnedDataset, Metadata, _choose_bin_dtype, bin_chunk
from ..learner.histogram import HIST_BLK
from .prefetch import assemble, prefetch_depth, read_rss_mb
from .store import ChunkStore, ChunkStoreError, SpooledData, spool_numpy

# bounds of the derived chunk size (rows); both HIST_BLK multiples
_MIN_CHUNK_ROWS = HIST_BLK
_MAX_CHUNK_ROWS = 1 << 20


def resolve_chunk_rows(n_features: int, config: Config) -> int:
    """Rows a chunk: ``data_chunk_rows`` when set; else ~4 raw float64
    chunks in ``ram_budget_mb`` (1 resident + prefetch depth + slack),
    clamped and rounded down to a HIST_BLK multiple."""
    if config.data_chunk_rows:
        rows = int(config.data_chunk_rows)
    else:
        budget = ram_budget_bytes(config.ram_budget_mb)
        per_row = max(1, int(n_features)) * 8
        rows = budget // (4 * per_row)
    rows = max(_MIN_CHUNK_ROWS, min(_MAX_CHUNK_ROWS, rows))
    return (rows // HIST_BLK) * HIST_BLK


# ---------------------------------------------------------------------------
# pass 1: the mappers from the in-RAM path's sample draw
# ---------------------------------------------------------------------------
def _gather_sample(store: ChunkStore, config: Config) -> np.ndarray:
    """(sample_cnt, F) float64 rows drawn as from_numpy draws them: the
    same seed, the same sorted choice over global row indices; each
    chunk gives the rows that fall in its range."""
    total = store.total_rows
    rng = np.random.RandomState(config.data_random_seed)
    sample_cnt = min(total, config.bin_construct_sample_cnt)
    if sample_cnt < total:
        idx = np.sort(rng.choice(total, sample_cnt, replace=False))
    else:
        idx = np.arange(total, dtype=np.int64)
    sample = np.empty((len(idx), store.n_features), dtype=np.float64)
    for _ci, row0, arrays in store.iter_chunks():
        rows = arrays["cols"].shape[1]
        lo = int(np.searchsorted(idx, row0))
        hi = int(np.searchsorted(idx, row0 + rows))
        if hi > lo:
            sample[lo:hi] = arrays["cols"].T[idx[lo:hi] - row0]
    return sample


def stream_bin(store: ChunkStore, config: Config, bin_root,
               categorical_feature: Optional[Sequence[int]] = None,
               feature_names: Optional[Sequence[str]] = None,
               ) -> Tuple[BinnedDataset, ChunkStore]:
    """Two-pass binning: (proto, binned store). The proto carries the
    mappers, the EFB layout and the feature bookkeeping over an empty
    (G, 0) bin matrix; the bins live on disk, on the raw chunks'
    boundaries."""
    t0 = time.monotonic()
    if not store.complete:
        raise ChunkStoreError(
            f"spool at {store.root} is not finalized; resume + finalize "
            "it before binning")
    if store.total_rows == 0:
        log.fatal("cannot construct Dataset from an empty spool")
    sample = _gather_sample(store, config)
    if not feature_names and store.manifest.get("feature_names"):
        feature_names = list(store.manifest["feature_names"])
    proto = BinnedDataset.from_numpy(sample, config,
                                     categorical_feature=categorical_feature,
                                     feature_names=feature_names)
    dtype = proto.bins.dtype
    G = proto.bins.shape[0]
    proto.bins = np.empty((G, 0), dtype=dtype)  # the sample's: dead weight
    t1 = time.monotonic()
    record_stats("pass1", {
        "sample_rows": int(sample.shape[0]),
        "total_rows": int(store.total_rows),
        "seconds": round(t1 - t0, 3),
        "rss_mb": round(read_rss_mb(), 1),
    })
    del sample

    bin_store = ChunkStore.create(
        bin_root, n_features=G, chunk_rows=store.chunk_rows, kind="binned",
        value_dtype=str(np.dtype(dtype)),
        extra={"raw_spool": str(store.root)})
    rss_per_chunk: List[float] = []
    for _ci, _row0, arrays in store.iter_chunks():
        chunk = np.ascontiguousarray(arrays["cols"].T)
        del arrays  # the raw chunk goes before the next read
        bin_store.append_binned(bin_chunk(proto, chunk, dtype))
        del chunk
        rss_per_chunk.append(round(read_rss_mb(), 1))
    bin_store.finalize()
    t2 = time.monotonic()
    record_stats("pass2", {
        "chunks": bin_store.num_chunks,
        "chunk_rows": store.chunk_rows,
        "seconds": round(t2 - t1, 3),
        "rows_per_sec": round(store.total_rows / max(1e-9, t2 - t1)),
        "rss_mb_per_chunk": rss_per_chunk,
        "binned_bytes": bin_store.spool_bytes(),
    })
    return proto, bin_store


# ---------------------------------------------------------------------------
# the streamed dataset: bins on disk, the device matrix built chunk-wise
# ---------------------------------------------------------------------------
@dataclass
class StreamedBinnedDataset(BinnedDataset):
    """A BinnedDataset whose bin matrix lives in a binned chunk store.

    ``bins`` is a (G, 0) placeholder. Training reads the matrix through
    :meth:`device_arrays`, which assembles it on the device chunk by
    chunk; the host-matrix consumers (save_binary, subset) stream the
    chunks through :meth:`materialize_bins` / :meth:`copy_subrow`."""

    bin_store: Optional[ChunkStore] = None
    ram_budget_mb: int = 0

    def device_arrays(self, device="cpu") -> Dict[str, Any]:
        """BinnedDataset.device_arrays' dict, its (G, Np) int32 bins
        allocated once on ``device``, zero-filled (the padding rows are
        bin 0) and filled chunk by chunk (prefetch.assemble); the
        assembly's numbers go to record_stats("assemble")."""
        import torch

        device = torch.device(device)
        if self._device is not None and self._device["bins"].device == device:
            return self._device
        assert self.bin_store is not None
        store = self.bin_store
        G = store.n_features  # bundle columns
        chunk_rows = store.chunk_rows
        dtype = np.dtype(store.manifest["value_dtype"])

        def load(idx: int) -> Tuple[np.ndarray, Dict[str, Any]]:
            # the reader thread: read and verify, host only
            b = store.read_chunk(idx)["bins"]
            lo = int(store.chunk_meta(idx)["row0"])
            return b, {"lo": lo, "shape": b.shape}

        # the JAX package's depth: its chunks travel as int32
        depth = prefetch_depth(G * chunk_rows * 4,
                               ram_budget_bytes(self.ram_budget_mb))
        t0 = time.monotonic()
        buf = torch.zeros((G, self.num_rows_padded()), dtype=torch.int32,
                          device=device)
        per_chunk, h2d = assemble(buf, store.num_chunks, load, depth,
                                  G * chunk_rows, dtype)
        # flatness: the spread of steady-state RSS (chunk 0 excluded: it
        # pays the device buffer and the pinned slots once)
        steady = [c["rss_mb"] for c in per_chunk[1:]] or \
            [c["rss_mb"] for c in per_chunk]
        record_stats("assemble", {
            "chunks": len(per_chunk),
            "chunk_rows": chunk_rows,
            "prefetch_depth": depth,
            "donate": False,
            "seconds": round(time.monotonic() - t0, 3),
            "per_chunk": per_chunk,
            "peak_rss_mb": round(max(c["rss_mb"] for c in per_chunk), 1),
            "rss_spread_mb": round(max(steady) - min(steady), 1),
            **h2d,
        })
        self._device = self._device_dict(buf, device)
        return self._device

    # ------------------------------------------------ host-matrix paths
    def materialize_bins(self) -> np.ndarray:
        """The whole (G, N) bin matrix in host memory, streamed back
        (save_binary); warns through the budget path first."""
        assert self.bin_store is not None
        store = self.bin_store
        dtype = _choose_bin_dtype(self.col_bins)
        nbytes = store.n_features * self.num_data * np.dtype(dtype).itemsize
        warn_over_budget(
            f"materializing the binned matrix of {self.num_data} rows",
            nbytes, self.ram_budget_mb,
            "prefer the chunked consumers (device_arrays/save chunked)")
        out = np.empty((store.n_features, self.num_data), dtype=dtype)
        for _ci, row0, arrays in store.iter_chunks():
            b = arrays["bins"]
            out[:, row0: row0 + b.shape[1]] = b.astype(dtype)
        return out

    def copy_subrow(self, indices: np.ndarray) -> BinnedDataset:
        """A row subset, streaming only the chunks that hold its rows; an
        ordinary in-RAM BinnedDataset (subsets are small: folds, valid
        slices)."""
        idx = np.asarray(indices, dtype=np.int64)
        assert self.bin_store is not None
        store = self.bin_store
        dtype = _choose_bin_dtype(self.col_bins)
        sub = np.empty((store.n_features, len(idx)), dtype=dtype)
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        pos = 0
        for ci in range(store.num_chunks):
            meta = store.chunk_meta(ci)
            row0, rows = int(meta["row0"]), int(meta["rows"])
            hi = int(np.searchsorted(sidx, row0 + rows))
            if hi <= pos:
                continue
            arrays = store.read_chunk(ci)
            local = sidx[pos:hi] - row0
            sub[:, order[pos:hi]] = arrays["bins"][:, local].astype(dtype)
            pos = hi
            if pos == len(sidx):
                break
        return BinnedDataset(
            bins=sub,
            mappers=self.mappers,
            used_features=self.used_features,
            num_data=len(idx),
            metadata=self._subset_metadata(idx),
            feature_names=self.feature_names,
            max_num_bin=self.max_num_bin,
            row_block=self.row_block,
            monotone_constraints=self.monotone_constraints,
            bundle_layout=self.bundle_layout,
            bundle_expand=self.bundle_expand,
        )


# ---------------------------------------------------------------------------
# the entry point: raw input of any kind -> StreamedBinnedDataset
# ---------------------------------------------------------------------------
def construct_chunked(
    data: Any,
    config: Config,
    label: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    init_score: Optional[np.ndarray] = None,
    position: Optional[np.ndarray] = None,
    categorical_feature: Optional[Sequence[int]] = None,
    feature_names: Optional[Sequence[str]] = None,
) -> StreamedBinnedDataset:
    """The data_source=chunked construct: spool ``data`` (a numpy matrix,
    a SpooledData, a list of Sequences or a delimited text path) into a
    raw chunk store, stream-bin it and return the disk-backed dataset.
    The spool lives in ``data_spool_dir``, or in a temporary directory
    removed at exit."""
    t0 = time.monotonic()
    owned, root = _spool_root(config)
    qid = None

    if isinstance(data, SpooledData):
        store = data.store
        if not store.complete:
            store.finalize()
    elif isinstance(data, (str, Path)):
        from .store import spool_text_file

        store, names = spool_text_file(
            data, root / "raw",
            chunk_rows=resolve_chunk_rows(1, config)
            if config.data_chunk_rows == 0 else int(config.data_chunk_rows),
            header=config.header,
            label_column=config.label_column or 0,
            weight_column=config.weight_column,
            group_column=config.group_column,
            ignore_column=config.ignore_column)
        if names and feature_names is None:
            feature_names = names
        if label is None:
            label = store.gather_meta("label")
        if weight is None:
            weight = store.gather_meta("weight")
        qid = store.gather_meta("qid")
    elif isinstance(data, np.ndarray) or hasattr(data, "__array__"):
        X = np.asarray(data)
        store = spool_numpy(X, root / "raw",
                            chunk_rows=resolve_chunk_rows(X.shape[1], config))
    elif isinstance(data, (list, tuple)) or hasattr(data, "__getitem__"):
        seqs = data if isinstance(data, (list, tuple)) else [data]
        nf = int(np.asarray(seqs[0][0]).reshape(-1).shape[0])
        store = ChunkStore.create(root / "raw", n_features=nf,
                                  chunk_rows=resolve_chunk_rows(nf, config))
        for s in seqs:
            bs = int(getattr(s, "batch_size", 4096) or 4096)
            for lo in range(0, len(s), bs):
                block = np.asarray(s[lo: lo + bs], np.float64)
                if block.ndim == 1:
                    block = block.reshape(1, -1)
                store.append_rows(block)
        store.finalize()
    else:
        raise ChunkStoreError(
            f"data_source=chunked cannot ingest {type(data).__name__}")

    t1 = time.monotonic()
    record_stats("spool", {
        "rows": store.total_rows,
        "features": store.n_features,
        "chunks": store.num_chunks,
        "chunk_rows": store.chunk_rows,
        "spool_bytes": store.spool_bytes(),
        "seconds": round(t1 - t0, 3),
        "rows_per_sec": round(store.total_rows / max(1e-9, t1 - t0)),
        "root": str(store.root),
        "owned_tmp": owned,
    })
    warn_over_budget(
        f"raw dataset of {store.total_rows} rows x {store.n_features} "
        "features", store.total_rows * store.n_features * 8,
        config.ram_budget_mb,
        "streaming it chunked from disk (data_source=chunked active)")

    proto, bin_store = stream_bin(store, config, root / "binned",
                                  categorical_feature=categorical_feature,
                                  feature_names=feature_names)
    if group is None and qid is not None:
        # the qid column -> per-query sizes (contiguous runs)
        change = np.nonzero(np.diff(qid))[0]
        bounds = np.concatenate([[0], change + 1, [len(qid)]])
        group = np.diff(bounds).astype(np.int64)
    as_ = lambda v, t: None if v is None else np.asarray(v, t).ravel()
    meta = Metadata(label=as_(label, np.float32),
                    weight=as_(weight, np.float32),
                    group=as_(group, np.int64),
                    init_score=as_(init_score, np.float64),
                    position=as_(position, np.int32))
    meta.check(store.total_rows)
    return StreamedBinnedDataset(
        bins=proto.bins,  # (G, 0) placeholder
        mappers=proto.mappers,
        used_features=proto.used_features,
        num_data=store.total_rows,
        metadata=meta,
        feature_names=list(proto.feature_names),
        max_num_bin=proto.max_num_bin,
        row_block=proto.row_block,
        monotone_constraints=proto.monotone_constraints,
        bundle_layout=proto.bundle_layout,
        bundle_expand=proto.bundle_expand,
        bin_store=bin_store,
        ram_budget_mb=config.ram_budget_mb,
    )


def _spool_root(config: Config) -> Tuple[bool, Path]:
    if config.data_spool_dir:
        root = Path(config.data_spool_dir)
        root.mkdir(parents=True, exist_ok=True)
        return False, root
    import atexit
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="lgbm_tpu_spool_"))
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    return True, tmp
