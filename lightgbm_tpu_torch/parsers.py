"""Text data loading: CSV / TSV / LibSVM parsers with format
autodetection, label / weight / group / ignore column handling, metadata
sidecar files, and the binned dataset's binary cache.

The port of lightgbm_tpu/parsers.py (reference src/io/parser.cpp, the
DatasetLoader text pipeline dataset_loader.cpp:210 LoadFromFile, the
sidecar loading of src/io/metadata.cpp: <data>.weight, <data>.query /
<data>.group, <data>.init, and Dataset::SaveBinaryFile dataset.h:700).
Parsing gives one dense float64 matrix: the native library's threaded
C++ parsers (native/fastparse.cpp) when it is loaded, else np.loadtxt
for the delimited formats and a bulk numpy conversion for LibSVM. Both
paths give the same doubles (a value written with %.17g reads back as
itself); the native parser also takes LightGBM's missing-value tokens
(na, null, none, ?, an empty field) as NaN, where np.loadtxt raises.
The .bin cache stores the binned dataset (mappers, bin matrix,
metadata) as an npz in the JAX package's format, so either package reads
the other's file; the port adds one key, `bundle`, holding the EFB
layout, which the JAX package's writer drops.

Streamed loading (two_round=true, reference dataset_loader.cpp:210 and
the two-pass extract at :1399): iter_text_chunks reads a delimited file
a chunk of lines at a time, each chunk through np.loadtxt as the JAX
package reads it (so a missing-value token raises there, where the
whole-file native parser gives NaN); scan_text_file reservoir-samples
pass 1 with the JAX package's RandomState draws, and
load_text_file_two_round bins pass 2 chunk by chunk, host memory
O(chunk) plus the binned matrix. The chunk store's text spool
(data/store.py) reads through the same chunks.
"""

from __future__ import annotations

import io
import os
import pickle
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import log
from .log import LightGBMError

BIN_MAGIC = "lightgbm_tpu.bin.v1"


def detect_format(sample_lines: List[str]) -> str:
    """'libsvm' | 'tsv' | 'csv' from a handful of data lines (reference
    parser.cpp GetParserType)."""
    for line in sample_lines:
        if re.search(r"\d+:[\d.eE+-]+", line) and ":" in line.split()[-1]:
            return "libsvm"
    tabs = sum(line.count("\t") for line in sample_lines)
    commas = sum(line.count(",") for line in sample_lines)
    if tabs >= commas and tabs > 0:
        return "tsv"
    if commas > 0:
        return "csv"
    return "tsv"  # single-column / space-separated fallback


def _read_lines(path: Path, limit: Optional[int] = None) -> List[str]:
    out = []
    with open(path, "r") as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            line = line.strip("\r\n")
            if line:
                out.append(line)
    return out


def _parse_delim(path: Path, delim: str,
                 header: bool) -> Tuple[np.ndarray, List[str]]:
    names: List[str] = []
    skip = 0
    if header:
        first = _read_lines(path, 1)[0]
        names = [c.strip() for c in first.split(delim)]
        skip = 1
    from . import native

    data = native.parse_delim(str(path), delim, skip)
    if data is None:  # no library, or a file the C++ parser refuses
        data = np.loadtxt(path, delimiter=delim, skiprows=skip,
                          dtype=np.float64, ndmin=2)
    return data, names


def _parse_libsvm(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """LibSVM 'label idx:val ...' -> (label, dense matrix). Indices are
    used as they are (0- and 1-based files both occur; the reference's
    LibSVMParser keeps raw indices); a token without ':' is skipped and a
    repeated index keeps its last value, as the JAX package parses it.
    The native parser does it when the library is loaded; else the
    tokens are converted in two bulk numpy calls."""
    from . import native

    res = native.parse_libsvm(str(path))
    if res is not None:
        return res
    labels: List[str] = []
    counts: List[int] = []
    pairs: List[str] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(parts[0])
            kv = [t for t in parts[1:] if ":" in t]
            counts.append(len(kv))
            pairs.extend(kv)
    n = len(labels)
    label = np.array(labels, dtype=np.float64) if n else np.zeros(0)
    if not pairs:
        return label, np.zeros((n, 0), dtype=np.float64)
    flat = np.array(" ".join(pairs).replace(":", " ").split(),
                    dtype=np.float64).reshape(-1, 2)
    idx = flat[:, 0].astype(np.int64)
    rows = np.repeat(np.arange(n), counts)
    X = np.zeros((n, int(idx.max()) + 1), dtype=np.float64)
    X[rows, idx] = flat[:, 1]
    return label, X


def _resolve_column(spec: Any, names: List[str]) -> Optional[int]:
    """Column spec: an int index, '<int>' or 'name:<col>' (config.h
    label_column semantics)."""
    if spec is None or spec == "":
        return None
    s = str(spec)
    if s.startswith("name:"):
        nm = s[5:]
        if nm not in names:
            log.fatal(f"column name {nm} not found in header")
        return names.index(nm)
    return int(s)


def _resolve_columns(spec: Any, names: List[str]) -> List[int]:
    if spec is None or spec == "":
        return []
    s = str(spec)
    if s.startswith("name:"):
        return [names.index(n) for n in s[5:].split(",") if n in names]
    return [int(c) for c in s.split(",") if c != ""]


def load_text_file(
    path: str,
    *,
    header: bool = False,
    label_column: Any = 0,
    weight_column: Any = "",
    group_column: Any = "",
    ignore_column: Any = "",
    categorical_feature: Any = "",
) -> Dict[str, Any]:
    """Parse a text data file into {X, label, weight, group, init_score,
    feature_names, categorical_feature} (host numpy). Sidecar files
    (reference metadata.cpp LoadWeights / LoadQueryBoundaries /
    LoadInitialScore): <path>.weight (one per row), <path>.query or
    <path>.group (rows per query), <path>.init (initial scores)."""
    p = Path(path)
    if not p.exists():
        log.fatal(f"data file {path} does not exist")
    sample = _read_lines(p, 5)
    fmt = detect_format(sample[1:] if header and len(sample) > 1 else sample)

    weight = None
    group = None
    init_score = None
    if fmt == "libsvm":
        label, X = _parse_libsvm(p)
        names: List[str] = []
    else:
        delim = "\t" if fmt == "tsv" else ","
        data, names = _parse_delim(p, delim, header)
        lbl_idx = _resolve_column(label_column, names)
        w_idx = _resolve_column(weight_column, names)
        g_idx = _resolve_column(group_column, names)
        ign = set(_resolve_columns(ignore_column, names))

        label = (data[:, lbl_idx] if lbl_idx is not None
                 else np.zeros(len(data)))
        weight = data[:, w_idx] if w_idx is not None else None
        qid = data[:, g_idx] if g_idx is not None else None
        drop = {i for i in (lbl_idx, w_idx, g_idx) if i is not None} | ign
        keep = [i for i in range(data.shape[1]) if i not in drop]
        X = data[:, keep]
        names = [names[i] for i in keep] if names else []
        if qid is not None:
            # query id column -> rows per query (contiguous runs)
            runs = np.flatnonzero(np.diff(qid)) + 1
            group = np.diff(np.concatenate([[0], runs, [len(qid)]])
                            ).astype(np.int64)

    wf = Path(str(p) + ".weight")
    if weight is None and wf.exists():
        weight = np.loadtxt(wf, dtype=np.float64, ndmin=1)
    qf = Path(str(p) + ".query")
    gf = Path(str(p) + ".group")
    if group is None:
        if qf.exists():
            group = np.loadtxt(qf, dtype=np.int64, ndmin=1)
        elif gf.exists():
            group = np.loadtxt(gf, dtype=np.int64, ndmin=1)
    inf = Path(str(p) + ".init")
    if inf.exists():
        init_score = np.loadtxt(inf, dtype=np.float64, ndmin=1)

    cats = _resolve_columns(categorical_feature, names)
    return {
        "X": X,
        "label": label,
        "weight": weight,
        "group": group,
        "init_score": init_score,
        "feature_names": names or None,
        "categorical_feature": cats or None,
    }


def delimited_layout(p: Path, header: bool, label_column: Any,
                     weight_column: Any, group_column: Any,
                     ignore_column: Any):
    """The columns of a delimited text file as the streamed readers take
    them (two_round, the chunk store's text spool): None for LibSVM, else
    (delimiter, header lines to skip, the kept feature columns, their
    names, the label / weight / group column indices or None)."""
    sample_lines = _read_lines(p, 5)
    fmt = detect_format(sample_lines[1:] if header and len(sample_lines) > 1
                        else sample_lines)
    if fmt == "libsvm":
        return None
    delim = "\t" if fmt == "tsv" else ","
    names: List[str] = []
    skip = 0
    if header:
        names = [c.strip() for c in sample_lines[0].split(delim)]
        skip = 1
    ncol = len(sample_lines[skip].split(delim))
    lbl_idx = _resolve_column(label_column, names)
    w_idx = _resolve_column(weight_column, names)
    g_idx = _resolve_column(group_column, names)
    ign = set(_resolve_columns(ignore_column, names))
    drop = {i for i in (lbl_idx, w_idx, g_idx) if i is not None} | ign
    keep = [i for i in range(ncol) if i not in drop]
    feat_names = [names[i] for i in keep] if names else []
    return delim, skip, keep, feat_names, lbl_idx, w_idx, g_idx


def iter_text_chunks(path: Path, delim: str, skip: int,
                     chunk_rows: int = 65536):
    """(rows, columns) float64 chunks of a delimited text file, one
    sequential read, each chunk of at most chunk_rows lines parsed by
    np.loadtxt."""
    buf: List[str] = []
    with open(path, "r") as f:
        for _ in range(skip):
            f.readline()
        for line in f:
            line = line.strip("\r\n")
            if not line:
                continue
            buf.append(line)
            if len(buf) >= chunk_rows:
                yield np.loadtxt(io.StringIO("\n".join(buf)),
                                 delimiter=delim, dtype=np.float64, ndmin=2)
                buf = []
    if buf:
        yield np.loadtxt(io.StringIO("\n".join(buf)), delimiter=delim,
                         dtype=np.float64, ndmin=2)


def scan_text_file(path: Path, delim: str, skip: int, n_sample: int,
                   seed: int, keep_cols: List[int],
                   small_cols: List[Optional[int]],
                   chunk_rows: int = 65536):
    """Pass 1 of two_round loading: one sequential read that
    reservoir-samples `n_sample` feature rows (Algorithm R, vectorized a
    chunk at a time with the JAX package's RandomState draws; the
    reference's SampleTextData, dataset_loader.cpp:1399) and keeps the
    per-row metadata columns whole (O(N) scalars).

    Returns (total rows, sample (n, F), [the metadata columns])."""
    rng = np.random.RandomState(seed)
    reservoir: Optional[np.ndarray] = None
    seen = 0
    meta_parts: List[List[np.ndarray]] = [[] for _ in small_cols]
    for chunk in iter_text_chunks(path, delim, skip, chunk_rows):
        m = len(chunk)
        feats = chunk[:, keep_cols]
        for j, c in enumerate(small_cols):
            if c is not None:
                meta_parts[j].append(chunk[:, c].copy())
        if reservoir is None:
            reservoir = np.empty((n_sample, feats.shape[1]), np.float64)
        fill = min(max(n_sample - seen, 0), m)
        if fill:
            reservoir[seen:seen + fill] = feats[:fill]
        if m > fill:
            # rows seen+fill+1 .. seen+m: each accepted with probability
            # n / (its index) into a uniform slot (Algorithm R)
            idx = np.arange(seen + fill + 1, seen + m + 1)
            accept = rng.rand(m - fill) < (n_sample / idx)
            nacc = int(accept.sum())
            if nacc:
                slots = rng.randint(0, n_sample, nacc)
                reservoir[slots] = feats[fill:][accept]
        seen += m
    if seen == 0:
        log.fatal(f"data file {path} has no data rows")
    metas = [(np.concatenate(p) if p else None) for p in meta_parts]
    return seen, reservoir[: min(n_sample, seen)], metas


def load_text_file_two_round(
    path: str,
    config,
    *,
    header: bool = False,
    label_column: Any = 0,
    weight_column: Any = "",
    group_column: Any = "",
    ignore_column: Any = "",
    categorical_feature: Any = "",
    chunk_rows: int = 65536,
) -> Optional[Dict[str, Any]]:
    """The streamed (two_round) load: pass 1 samples and counts, pass 2
    bins chunk by chunk into the integer matrix; the float matrix never
    exists in host memory. Delimited formats only: LibSVM warns and
    returns None (the caller takes the whole-file loader)."""
    from .dataset import BinnedDataset, Metadata, bin_chunk

    p = Path(path)
    if not p.exists():
        log.fatal(f"data file {path} does not exist")
    layout = delimited_layout(p, header, label_column, weight_column,
                              group_column, ignore_column)
    if layout is None:
        log.warning("two_round streaming supports delimited formats; "
                    "LibSVM falls back to whole-file loading")
        return None
    delim, skip, keep, feat_names, lbl_idx, w_idx, g_idx = layout
    total, sample, (label, weight, qid) = scan_text_file(
        p, delim, skip, min(config.bin_construct_sample_cnt, 10 ** 9),
        config.data_random_seed, keep, [lbl_idx, w_idx, g_idx],
        chunk_rows=chunk_rows)
    cats = _resolve_columns(categorical_feature, feat_names)
    proto = BinnedDataset.from_numpy(sample, config,
                                     categorical_feature=cats or None,
                                     feature_names=feat_names or None)
    dtype = proto.bins.dtype
    bins = np.empty((proto.bins.shape[0], total), dtype=dtype)
    row0 = 0
    for chunk in iter_text_chunks(p, delim, skip, chunk_rows):
        bins[:, row0:row0 + len(chunk)] = bin_chunk(proto, chunk[:, keep],
                                                    dtype)
        row0 += len(chunk)

    group = None
    if qid is not None:
        runs = np.flatnonzero(np.diff(qid)) + 1
        group = np.diff(np.concatenate([[0], runs, [len(qid)]])
                        ).astype(np.int64)
    init_score = None
    wf = Path(str(p) + ".weight")
    if weight is None and wf.exists():
        weight = np.loadtxt(wf, dtype=np.float64, ndmin=1)
    qf, gf = Path(str(p) + ".query"), Path(str(p) + ".group")
    if group is None and qf.exists():
        group = np.loadtxt(qf, dtype=np.int64, ndmin=1)
    elif group is None and gf.exists():
        group = np.loadtxt(gf, dtype=np.int64, ndmin=1)
    inf = Path(str(p) + ".init")
    if inf.exists():
        init_score = np.loadtxt(inf, dtype=np.float64, ndmin=1)

    meta = Metadata(
        label=(np.asarray(label, np.float32) if label is not None
               else np.zeros(total, np.float32)),
        weight=(np.asarray(weight, np.float32) if weight is not None
                else None),
        group=group,
        init_score=(np.asarray(init_score, np.float64)
                    if init_score is not None else None),
        position=None,
    )
    meta.check(total)
    binned = BinnedDataset(
        bins=bins,
        mappers=proto.mappers,
        used_features=proto.used_features,
        num_data=total,
        metadata=meta,
        feature_names=list(proto.feature_names),
        max_num_bin=proto.max_num_bin,
        row_block=proto.row_block,
        monotone_constraints=proto.monotone_constraints,
        bundle_layout=proto.bundle_layout,
        bundle_expand=proto.bundle_expand,
    )
    return {"binned": binned, "feature_names": feat_names or None,
            "categorical_feature": cats or None}


def save_binary(binned, path: str) -> None:
    """Serialize a constructed BinnedDataset (reference SaveBinaryFile,
    dataset.h:700): bin matrix, per-feature mappers, metadata; loading
    skips parsing and FindBin. A streamed dataset's matrix (a (G, 0)
    placeholder in memory) is streamed back from its chunks first."""
    m = binned.metadata
    mapper_blobs = []
    for mp in binned.mappers:
        mapper_blobs.append(dict(
            upper_bounds=np.asarray(mp.upper_bounds, np.float64),
            bin_type=int(mp.bin_type.value),
            missing_type=int(mp.missing_type.value),
            categories=np.asarray(mp.categories, np.int64),
            num_bin=mp.num_bin,
            is_trivial=int(mp.is_trivial),
            min_value=mp.min_value,
            max_value=mp.max_value,
            most_freq_bin=mp.most_freq_bin,
            default_bin=mp.default_bin,
        ))
    extra = {}
    if binned.bundle_layout is not None:
        extra["bundle"] = np.frombuffer(pickle.dumps(
            (tuple(binned.bundle_layout),
             np.asarray(binned.bundle_expand))), dtype=np.uint8)
    fh = open(path, "wb")  # np.savez appends .npz to bare paths
    np.savez_compressed(
        fh,
        magic=BIN_MAGIC,
        bins=(binned.materialize_bins()
              if hasattr(binned, "materialize_bins") else binned.bins),
        used_features=np.asarray(binned.used_features, np.int64),
        label=(np.asarray(m.label, np.float64) if m.label is not None
               else np.zeros(0)),
        has_label=m.label is not None,
        weight=(np.asarray(m.weight, np.float64) if m.weight is not None
                else np.zeros(0)),
        has_weight=m.weight is not None,
        group=(np.asarray(m.group, np.int64) if m.group is not None
               else np.zeros(0, np.int64)),
        has_group=m.group is not None,
        init_score=(np.asarray(m.init_score, np.float64)
                    if m.init_score is not None else np.zeros(0)),
        has_init=m.init_score is not None,
        feature_names=(np.asarray(binned.feature_names, dtype=object)
                       if binned.feature_names
                       else np.zeros(0, dtype=object)),
        mappers=np.frombuffer(pickle.dumps(mapper_blobs), dtype=np.uint8),
        num_data=binned.num_data,
        row_block=binned.row_block,
        mono=(np.asarray(binned.monotone_constraints, np.int8)
              if binned.monotone_constraints is not None
              else np.zeros(0, np.int8)),
        **extra,
    )
    fh.close()


def is_binary_file(path: str) -> bool:
    if not os.path.exists(path):
        return False
    try:
        with np.load(path, allow_pickle=True) as z:
            return str(z.get("magic", "")) == BIN_MAGIC
    except Exception:  # noqa: BLE001 - any non-npz file is "not a cache"
        return False


def load_binary(path: str):
    """A .bin cache back into a BinnedDataset. Labels and weights come
    back as float32, the type the binned dataset holds them in."""
    from .binning import BinMapper, BinType, MissingType
    from .bundling import BundleLayout
    from .dataset import BinnedDataset, Metadata

    with np.load(path, allow_pickle=True) as z:
        if str(z["magic"]) != BIN_MAGIC:
            log.fatal(f"{path} is not a lightgbm_tpu binary dataset")
        mapper_blobs = pickle.loads(z["mappers"].tobytes())
        mappers = []
        for b in mapper_blobs:
            mp = BinMapper(
                upper_bounds=b["upper_bounds"],
                bin_type=BinType(b["bin_type"]),
                missing_type=MissingType(b["missing_type"]),
                categories=tuple(int(c) for c in b["categories"]),
                num_bin=int(b["num_bin"]),
                most_freq_bin=int(b["most_freq_bin"]),
                default_bin=int(b["default_bin"]),
                is_trivial=bool(b["is_trivial"]),
                min_value=float(b["min_value"]),
                max_value=float(b["max_value"]),
            )
            if mp.bin_type == BinType.CATEGORICAL:
                mp._cat_to_bin = {int(c): i
                                  for i, c in enumerate(mp.categories)}
            mappers.append(mp)
        f32 = lambda key: np.asarray(z[key], np.float32)
        meta = Metadata(
            label=f32("label") if bool(z["has_label"]) else None,
            weight=f32("weight") if bool(z["has_weight"]) else None,
            group=z["group"] if bool(z["has_group"]) else None,
            init_score=z["init_score"] if bool(z["has_init"]) else None,
        )
        names = ([str(n) for n in z["feature_names"]]
                 if len(z["feature_names"]) else None)
        used = np.asarray(z["used_features"], np.int64)
        max_num_bin = max((mappers[f].num_bin for f in used), default=1)
        mono = (np.asarray(z["mono"], np.int8)
                if "mono" in z and len(z["mono"]) else None)
        bins = np.asarray(z["bins"])  # keep the stored narrow dtype
        layout = expand = None
        if "bundle" in z:
            fields, expand = pickle.loads(z["bundle"].tobytes())
            layout = BundleLayout(*fields)
        elif bins.shape[0] != len(used):
            raise LightGBMError(
                f"{path} holds {bins.shape[0]} bundled columns for "
                f"{len(used)} features but no bundle layout (its writer "
                "dropped it); build the Dataset from the source data")
        return BinnedDataset(
            bins=bins,
            mappers=mappers,
            used_features=used,
            metadata=meta,
            num_data=int(z["num_data"]),
            feature_names=names or [f"Column_{i}"
                                    for i in range(len(mappers))],
            max_num_bin=max_num_bin,
            row_block=int(z["row_block"]),
            monotone_constraints=mono,
            bundle_layout=layout,
            bundle_expand=expand,
        )
