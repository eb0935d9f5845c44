"""Dataset and Booster, the LightGBM Python API surface of the port.

The port of lightgbm_tpu/basic.py. A Dataset takes a dense matrix, a
pandas DataFrame / Series (column names become feature names), a pyarrow
Table / RecordBatch / Array / ChunkedArray (nulls become NaN), a scipy
sparse matrix (binned from its stored values by BinnedDataset.from_csr,
never densified; categorical features and linear trees take the dense
path, with a warning), a CSV / TSV / LibSVM text file with its header,
label / weight / group / ignore columns and .weight / .query / .group /
.init sidecars (parsers.py), or a binary cache written by save_binary in
either package's format. Construction is lazy (construct), a validation
set bins with its reference's mappers, and the metadata (label, weight,
group, init_score, position) have set_ / get_ accessors and
set_field / get_field, before or after construct. subset takes a row
subset (BinnedDataset.copy_subrow after construct, the raw rows before),
and add_features_from stacks another Dataset's columns.

A Booster trains (update, with a custom objective's gradients too),
continues from a loaded model (_continue_from), takes new parameters
between iterations (reset_parameter), evaluates with custom metrics,
predicts on the host (pred_leaf, pred_contrib, the per-row prediction
early stop) or on the card (device="cuda", serving/forest.py), rolls
iterations back, refits its trees' leaves on new data, reads and writes
leaf outputs, gives feature importances and bounds, shuffles its trees,
and saves / loads the text model and dumps the JSON one.

Inputs larger than host RAM (the data plane, data/): a Sequence or a
list of them bins in two streamed passes (BinnedDataset.from_sequences);
two_round=true streams a delimited text file
(parsers.load_text_file_two_round); data_source=chunked (or a
data.store.SpooledData input) spools any input to a disk chunk store,
bins it in two passes and assembles the card's bin matrix chunk by chunk
from pinned buffers (data/streaming.py). Inputs the chunked path cannot
take (a reference= validation set, linear_tree, scipy sparse, a .bin
cache) warn and take the in-RAM path.

set_network (and num_machines > 1 in a Booster's params, and
Booster.set_network) joins a torch.distributed process group
(parallel/multihost.py); free_network leaves it.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import log
from .config import Config, resolve_device
from .dataset import BinnedDataset
from .log import LightGBMError

_EARLY_STOP_KEYS = ("pred_early_stop", "pred_early_stop_freq",
                    "pred_early_stop_margin")
# rows densified at a time when the host walker scores a sparse matrix
_SPARSE_ROWS = 65536


class Sequence:
    """A random-access row sequence for streamed Dataset construction
    (reference basic.py:905 Sequence ABC). Subclass with ``__len__`` and
    ``__getitem__`` (an int row or a slice -> numpy rows), optionally
    set ``batch_size``, and pass one Sequence or a list of them as
    ``Dataset(data=...)``: the bin matrix is built in two streamed passes
    without the whole float matrix."""

    batch_size: int = 4096

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError


def _is_sequence_input(data: Any) -> bool:
    if isinstance(data, Sequence):
        return True
    return (isinstance(data, list) and len(data) > 0
            and all(isinstance(s, Sequence) for s in data))


def set_network(
    machines: Any,
    local_listen_port: int = 12400,
    listen_time_out: int = 120,
    num_machines: int = 1,
    *,
    machine_list_file: str = "",
    machine_rank: "int | None" = None,
    backend: "str | None" = None,
    device: Any = None,
    init_method: "str | None" = None,
) -> None:
    """Join the training cluster (reference basic.py set_network ->
    LGBM_NetworkInit; the positional order matches: machines,
    local_listen_port, listen_time_out, num_machines): a torch.distributed
    process group over TCP, the first machine hosting its store
    (parallel/multihost.init_distributed). backend: gloo or nccl (NCCL
    for a CUDA device by default, gloo otherwise); listen_time_out is the
    group's timeout in seconds; init_method overrides the address (a
    file:// store, or env:// under torchrun)."""
    from .parallel import multihost

    if machines is not None and not isinstance(machines, str):
        machines = ",".join(str(m) for m in machines)
    multihost.init_distributed(
        machines=machines or None,
        machine_list_file=machine_list_file or None,
        num_machines=num_machines if num_machines > 1 else None,
        local_listen_port=local_listen_port,
        machine_rank=machine_rank,
        backend=backend,
        device=device,
        init_method=init_method,
        timeout_s=max(float(listen_time_out), 1.0) * 5,
    )


def _is_sparse(data: Any) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "tocsr")


def _is_arrow(data: Any) -> bool:
    return (type(data).__module__ + "." + type(data).__name__).startswith(
        "pyarrow.")


def _arrow_f64(col) -> np.ndarray:
    """A pyarrow column as float64 with nulls as NaN (cast first, so a
    nullable bool or int column becomes float64, not objects)."""
    import pyarrow as pa  # the caller holds a pyarrow object

    return np.asarray(col.cast(pa.float64()).to_numpy(zero_copy_only=False))


def _to_2d_numpy(data: Any) -> Tuple[np.ndarray, Optional[List[str]]]:
    """(float64 matrix, column names or None) of a dense input: numpy-like,
    pandas DataFrame / Series, or pyarrow Table / RecordBatch / Array /
    ChunkedArray (the reference's Arrow ingest, c_api.cpp:1645). A scipy
    sparse matrix is densified: callers that must not densify test
    _is_sparse first."""
    try:  # pandas without importing it eagerly
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            return (data.to_numpy(dtype=np.float64),
                    [str(c) for c in data.columns])
        if isinstance(data, pd.Series):
            return data.to_numpy(dtype=np.float64).reshape(-1, 1), None
    except ImportError:
        pass
    if _is_arrow(data):
        import pyarrow as pa

        if isinstance(data, pa.RecordBatch):
            data = pa.Table.from_batches([data])
        if isinstance(data, pa.Table):
            cols = [_arrow_f64(data.column(i))
                    for i in range(data.num_columns)]
            return (np.column_stack(cols),
                    [str(c) for c in data.column_names])
        if isinstance(data, (pa.ChunkedArray, pa.Array)):
            return _arrow_f64(data).reshape(-1, 1), None
    if hasattr(data, "toarray"):
        return np.asarray(data.toarray(), dtype=np.float64), None
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr.astype(np.float64, copy=False), None


def _to_1d(v: Any) -> Optional[np.ndarray]:
    if v is None:
        return None
    try:
        import pandas as pd

        if isinstance(v, (pd.Series, pd.DataFrame)):
            return v.to_numpy().ravel()
    except ImportError:
        pass
    if _is_arrow(v):
        import pyarrow as pa

        if isinstance(v, pa.Table):
            if v.num_columns != 1:
                raise ValueError(f"expected a 1-column table, got "
                                 f"{v.num_columns} columns")
            v = v.column(0)
        return _arrow_f64(v).ravel()
    return np.asarray(v).ravel()


def _host_rows(data: Any, fn: Callable[[np.ndarray], np.ndarray]):
    """fn over the rows of a prediction input: a dense input at once, a
    sparse matrix _SPARSE_ROWS rows at a time (never the whole matrix
    dense), the results stacked on the row axis."""
    if not _is_sparse(data):
        return fn(_to_2d_numpy(data)[0])
    csr = data.tocsr()
    parts = [fn(np.asarray(csr[i: i + _SPARSE_ROWS].toarray(), np.float64))
             for i in range(0, max(csr.shape[0], 1), _SPARSE_ROWS)]
    return np.concatenate(parts, axis=0)


class Dataset:
    """Dataset wrapper (reference basic.py:1746)."""

    _FIELDS = ("label", "weight", "group", "init_score", "position")

    def __init__(
        self,
        data: Any,
        label: Any = None,
        reference: Optional["Dataset"] = None,
        weight: Any = None,
        group: Any = None,
        init_score: Any = None,
        feature_name: Union[str, List[str]] = "auto",
        categorical_feature: Union[str, List[Union[int, str]]] = "auto",
        params: Optional[Dict[str, Any]] = None,
        free_raw_data: bool = True,
        position: Any = None,
    ):
        self.data = data
        self.label = _to_1d(label)
        self.reference = reference
        self.weight = _to_1d(weight)
        self.group = _to_1d(group)
        self.position = _to_1d(position)
        self.init_score = _to_1d(init_score)
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) or {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None
        self.used_indices: Optional[np.ndarray] = None
        self.pandas_categorical = None

    def _resolve_categorical(self, feature_names: List[str]) -> List[int]:
        """The constructor's categorical_feature as column indices: ints
        as they are, names looked up in feature_names (unknown names
        warned about and dropped). Like the JAX package, a
        `categorical_feature` key in params is not read on a matrix (a
        text file reads it as its column spec)."""
        cf = self.categorical_feature
        if cf == "auto" or cf is None:
            return []
        out = []
        for c in cf:
            if isinstance(c, str):
                if c in feature_names:
                    out.append(feature_names.index(c))
                else:
                    log.warning(f"Unknown categorical feature {c}")
            else:
                out.append(int(c))
        return out

    def _names(self) -> Optional[List[str]]:
        return ([str(n) for n in self.feature_name]
                if isinstance(self.feature_name, list) else None)

    def construct(self) -> "Dataset":
        """Bin the data (host numpy). Like train, this refuses to run when
        the card is asked for (device_type default) and torch sees none:
        the port never carries on quietly on the CPU."""
        if self._binned is not None:
            return self
        # a validation set takes its reference's parameters (device, row
        # block, the file keys) unless it sets its own
        base = self.reference.params if self.reference is not None else {}
        merged = {**base, **self.params}
        cfg = Config(merged)
        resolve_device(cfg)
        if self.data is None:
            log.fatal("Cannot construct Dataset: raw data was freed")
        from .data.store import SpooledData

        if cfg.data_source == "chunked" or isinstance(self.data,
                                                      SpooledData):
            # out-of-core: spool, bin in two passes, assemble the device
            # matrix chunk-wise; an input it cannot take warns and falls
            # through to the in-RAM paths below
            binned = self._construct_chunked(cfg)
            if binned is not None:
                self._binned = binned
                if self.feature_name == "auto" and binned.feature_names:
                    self.feature_name = list(binned.feature_names)
                return self._freed()
        if _is_sequence_input(self.data):
            if cfg.linear_tree:
                log.fatal("linear_tree needs raw feature values; Sequence "
                          "streaming does not retain them")
            names = self._names()
            self._binned = BinnedDataset.from_sequences(
                self.data if isinstance(self.data, list) else [self.data],
                cfg, label=self.label, weight=self.weight, group=self.group,
                init_score=self.init_score, position=self.position,
                categorical_feature=self._resolve_categorical(names or []),
                feature_names=names)
            return self._freed()
        if isinstance(self.data, (str, Path)):
            if self._construct_file(str(self.data), merged, cfg):
                return self
        ref_binned = None
        if self.reference is not None:
            self.reference.construct()
            ref_binned = self.reference._binned
        if _is_sparse(self.data):
            names = self._names()
            if not self._resolve_categorical(names or []) \
                    and not cfg.linear_tree:
                self._binned = BinnedDataset.from_csr(
                    self.data, cfg, label=self.label, weight=self.weight,
                    group=self.group, init_score=self.init_score,
                    position=self.position, feature_names=names,
                    reference=ref_binned)
                return self._freed()
            n, f = self.data.shape
            log.warning(f"sparse input with categorical features or "
                        f"linear_tree takes the dense path: a {n} x {f} "
                        f"float64 copy ({n * f * 8 / 2 ** 20:.1f} MB)")
        arr, frame_names = _to_2d_numpy(self.data)
        names = self._names() or frame_names or [
            f"Column_{i}" for i in range(arr.shape[1])]
        self._binned = BinnedDataset.from_numpy(
            arr, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, position=self.position,
            categorical_feature=self._resolve_categorical(names),
            feature_names=names, reference=ref_binned,
            keep_raw=bool(cfg.linear_tree))
        return self._freed()

    def _freed(self) -> "Dataset":
        """construct's end: the raw data goes unless free_raw_data=False."""
        if self.free_raw_data:
            self.data = None
        return self

    def _construct_chunked(self, cfg: Config) -> Optional[BinnedDataset]:
        """The data_source=chunked construct (data/streaming.py), or None
        when this input takes an in-RAM path (warned: a reference=
        validation set must bin with its training set's mappers,
        linear_tree needs the raw values, a scipy sparse matrix bins
        sparse; a .bin cache loads binned)."""
        from .data.store import ChunkStoreError, SpooledData
        from .data.streaming import construct_chunked

        if self.reference is not None:
            log.warning("data_source=chunked: valid sets with reference= "
                        "must bin with the training set's mappers; using "
                        "the in-RAM path")
            return None
        if cfg.linear_tree:
            log.warning("data_source=chunked does not retain raw feature "
                        "values required by linear_tree; using the in-RAM "
                        "path")
            return None
        data = self.data
        names = self._names()
        if isinstance(data, (str, Path)):
            from .parsers import is_binary_file

            if is_binary_file(str(data)):
                return None
        elif _is_sparse(data):
            log.warning("data_source=chunked does not ingest scipy sparse "
                        "matrices; using the sparse in-RAM path")
            return None
        elif _is_sequence_input(data):
            data = data if isinstance(data, list) else [data]
        elif not isinstance(data, (SpooledData, np.ndarray)):
            data, frame_names = _to_2d_numpy(data)
            names = names or frame_names
        try:
            return construct_chunked(
                data, cfg, label=self.label, weight=self.weight,
                group=self.group, init_score=self.init_score,
                position=self.position,
                categorical_feature=self._resolve_categorical(names or []),
                feature_names=names)
        except ChunkStoreError as e:
            log.warning(f"data_source=chunked ingestion failed ({e}); "
                        "falling back to the in-RAM path")
            return None

    def _override_meta(self, md) -> None:
        """The constructor's metadata over a loaded dataset's own."""
        for name, typ in (("label", np.float32), ("weight", np.float32),
                          ("group", np.int64), ("init_score", np.float64),
                          ("position", np.int32)):
            if getattr(self, name) is not None:
                setattr(md, name, np.asarray(getattr(self, name), typ))

    def _construct_file(self, path: str, params: Dict[str, Any],
                        cfg: Config) -> bool:
        """A file input (reference DatasetLoader::LoadFromFile): a binary
        cache loads binned, with the constructor's metadata over its own
        (True: done); a text file is parsed and its matrix, metadata,
        names and categorical columns taken up (False: bin the matrix)."""
        from .config import resolve_alias
        from .parsers import is_binary_file, load_binary, load_text_file

        if is_binary_file(path):
            self._binned = load_binary(path)
            self._override_meta(self._binned.metadata)
            self._freed()
            return True
        fp = {resolve_alias(k): v for k, v in params.items()}
        columns = dict(
            header=str(fp.get("header", "false")).lower() in ("true", "1"),
            label_column=fp.get("label_column", 0),
            weight_column=fp.get("weight_column", ""),
            group_column=fp.get("group_column", ""),
            ignore_column=fp.get("ignore_column", ""),
            categorical_feature=fp.get("categorical_feature", ""),
        )
        # two_round streams only when asked (reference
        # dataset_loader.cpp:210): its bin boundaries come from
        # reservoir-sampled rows, so a large file only warns. A reference=
        # set (its training set's mappers), linear_tree (raw values) and a
        # constructor categorical_feature (names unknown before the parse)
        # take the whole-file loader.
        stream_ok = (not cfg.linear_tree and self.reference is None
                     and self.categorical_feature in ("auto", None, ""))
        if cfg.two_round and not stream_ok:
            log.warning("two_round streaming skipped: linear_tree / "
                        "reference= / constructor categorical_feature need "
                        "the whole-file loader")
        elif cfg.two_round:
            from .parsers import load_text_file_two_round

            res = load_text_file_two_round(path, cfg, **columns)
            if res is not None:  # None: LibSVM, the whole-file loader
                self._binned = res["binned"]
                self._override_meta(self._binned.metadata)
                if self.feature_name == "auto" and res["feature_names"]:
                    self.feature_name = res["feature_names"]
                self._freed()
                return True
        elif stream_ok:
            from .data import warn_over_budget

            warn_over_budget(
                f"text file {path}", os.path.getsize(path),
                cfg.ram_budget_mb,
                "pass two_round=true or data_source=chunked to stream it "
                "with bounded host memory (streamed binning samples rows, "
                "so results may differ slightly from the whole-file "
                "loader)")
        loaded = load_text_file(path, **columns)
        self.data = loaded["X"]
        for name in ("label", "weight", "group", "init_score"):
            if getattr(self, name) is None and loaded[name] is not None:
                setattr(self, name, np.asarray(loaded[name]))
        if self.feature_name == "auto" and loaded["feature_names"]:
            self.feature_name = loaded["feature_names"]
        if (self.categorical_feature == "auto"
                and loaded["categorical_feature"]):
            self.categorical_feature = loaded["categorical_feature"]
        return False

    @classmethod
    def from_binned(cls, binned: BinnedDataset) -> "Dataset":
        """Wrap an already-binned dataset (the .bin cache's fast path,
        reference dataset_loader.cpp:424 LoadFromBinFile)."""
        ds = cls(data=None, free_raw_data=True)
        ds.label = binned.metadata.label
        ds.weight = binned.metadata.weight
        ds.group = binned.metadata.group
        ds.init_score = binned.metadata.init_score
        ds.feature_name = binned.feature_names
        ds._binned = binned
        return ds

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None,
                     position=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, position=position)

    # ---- the metadata, set before or after construct; after it the
    # binned metadata changes too, which a Booster made later reads
    def _set_meta(self, name: str, value, typ) -> "Dataset":
        setattr(self, name, _to_1d(value))
        if self._binned is not None:
            setattr(self._binned.metadata, name,
                    None if value is None
                    else np.asarray(getattr(self, name), dtype=typ))
        return self

    def set_label(self, label) -> "Dataset":
        return self._set_meta("label", label, np.float32)

    def set_weight(self, weight) -> "Dataset":
        return self._set_meta("weight", weight, np.float32)

    def set_group(self, group) -> "Dataset":
        return self._set_meta("group", group, np.int64)

    def set_init_score(self, init_score) -> "Dataset":
        return self._set_meta("init_score", init_score, np.float64)

    def set_position(self, position) -> "Dataset":
        return self._set_meta("position", position, np.int32)

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def get_init_score(self):
        return self.init_score

    def get_position(self):
        return self.position

    def set_field(self, field_name: str, data) -> "Dataset":
        """Metadata setter by name (LGBM_DatasetSetField)."""
        if field_name not in self._FIELDS:
            raise KeyError(f"unknown field {field_name!r}")
        return getattr(self, f"set_{field_name}")(data)

    def get_field(self, field_name: str):
        """Metadata getter by name (LGBM_DatasetGetField)."""
        if field_name not in self._FIELDS:
            raise KeyError(f"unknown field {field_name!r}")
        return getattr(self, f"get_{field_name}")()

    def get_data(self):
        """The raw data this Dataset was built from; gone once construct
        freed it (free_raw_data=True)."""
        if self.data is None:
            raise LightGBMError(
                "Cannot call get_data after freeing raw data; "
                "set free_raw_data=False when constructing the Dataset")
        return self.data

    def get_params(self) -> Dict[str, Any]:
        """The Dataset-relevant parameters this Dataset carries."""
        from .config import DATASET_PARAMS, resolve_alias

        return {k: v for k, v in self.params.items()
                if resolve_alias(k) in DATASET_PARAMS}

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this Dataset with another Dataset's mappers."""
        if self._binned is not None and self.reference is not reference:
            raise LightGBMError(
                "Cannot set reference after the Dataset was constructed; "
                "pass reference= at creation")
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100):
        """The Datasets reachable through .reference links."""
        head = self
        chain = set()
        while len(chain) < ref_limit and isinstance(head, Dataset):
            chain.add(head)
            if head.reference is None:
                break
            head = head.reference
        return chain

    def set_feature_name(self, feature_name) -> "Dataset":
        """Set feature names; after construct they rename in place."""
        self.feature_name = feature_name
        if self._binned is not None and feature_name != "auto":
            names = list(feature_name)
            if len(names) != self._binned.num_total_features:
                raise LightGBMError(
                    f"Length of feature names {len(names)} does not match "
                    f"number of features {self._binned.num_total_features}")
            self._binned.feature_names = names
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Set categorical features; they bind at construct."""
        if self.categorical_feature == categorical_feature:
            return self
        if self._binned is not None:
            raise LightGBMError(
                "Cannot set categorical feature after the Dataset was "
                "constructed; set it at creation")
        self.categorical_feature = categorical_feature
        return self

    def feature_num_bin(self, feature: Union[int, str]) -> int:
        """Bins of one feature (LGBM_DatasetGetFeatureNumBin)."""
        self.construct()
        if isinstance(feature, str):
            feature = self._binned.feature_names.index(feature)
        return int(self._binned.mappers[feature].num_bin)

    def save_binary(self, filename: Union[str, Path]) -> "Dataset":
        """The binned form as a binary cache (Dataset::SaveBinaryFile,
        dataset.h:700); Dataset(filename) loads it back."""
        from .parsers import save_binary

        self.construct()
        save_binary(self._binned, str(filename))
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Stack another Dataset's columns onto this one's (reference
        LGBM_DatasetAddFeaturesFrom) as the JAX package does it: the two
        raw matrices are concatenated (both Datasets need their raw data,
        free_raw_data=False) and the next construct bins the result."""
        if self.data is None or other.data is None:
            raise LightGBMError(
                "add_features_from requires raw data on both Datasets "
                "(free_raw_data=False)")
        if _is_sparse(self.data) or _is_sparse(other.data):
            log.warning("add_features_from densifies a sparse input")
        a, _ = _to_2d_numpy(self.data)
        b, _ = _to_2d_numpy(other.data)
        if a.shape[0] != b.shape[0]:
            raise LightGBMError(
                f"Cannot add features from a Dataset with {b.shape[0]} "
                f"rows to one with {a.shape[0]} rows")
        self.data = np.concatenate([a, b], axis=1)
        if (isinstance(self.feature_name, list)
                and isinstance(other.feature_name, list)):
            self.feature_name = (list(self.feature_name)
                                 + list(other.feature_name))
        else:
            self.feature_name = "auto"
        cf_a, cf_b = self.categorical_feature, other.categorical_feature
        if cf_a != "auto" or cf_b != "auto":
            # names survive (the name lists were concatenated); the other
            # Dataset's indices shift by this one's width
            merged = [] if cf_a == "auto" else list(cf_a)
            if cf_b != "auto":
                merged += [c if isinstance(c, str) else c + a.shape[1]
                           for c in cf_b]
            self.categorical_feature = merged
        self._binned = None  # bin the widened matrix at the next construct
        return self

    def _shape(self) -> Tuple[int, int]:
        if self._binned is None and isinstance(self.data, (str, Path)):
            self.construct()  # a file's shape is known once it is parsed
        if self._binned is not None:
            return self._binned.num_data, self._binned.num_total_features
        if _is_sparse(self.data):
            return tuple(self.data.shape)
        return _to_2d_numpy(self.data)[0].shape

    def num_data(self) -> int:
        return self._shape()[0]

    def num_feature(self) -> int:
        return self._shape()[1]

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._binned.feature_names)

    def subset(self, used_indices, params=None) -> "Dataset":
        """A row subset, binned with this Dataset's mappers. After
        construct it is BinnedDataset.copy_subrow (a query-aligned subset
        keeps the groups, any other drops them with a warning); before it,
        the raw rows, binned at their own construct."""
        idx = np.asarray(used_indices)
        take = lambda v: None if v is None else v[idx]
        if self._binned is not None:
            sub = Dataset.__new__(Dataset)
            sub.__dict__.update(
                data=None, label=take(self.label), reference=self,
                weight=take(self.weight), group=None,
                position=take(self.position),
                init_score=take(self.init_score),
                feature_name=self.feature_name,
                categorical_feature=self.categorical_feature,
                params=copy.deepcopy(params or self.params),
                free_raw_data=self.free_raw_data,
                _binned=self._binned.copy_subrow(idx), used_indices=idx,
                pandas_categorical=self.pandas_categorical,
            )
            g = sub._binned.metadata.group
            sub.group = None if g is None else np.asarray(g)
            return sub
        if self.data is None:
            log.fatal("Cannot subset: raw data was freed")
        rows = (self.data.tocsr()[idx] if _is_sparse(self.data)
                else _to_2d_numpy(self.data)[0][idx])
        sub = Dataset(
            rows, label=take(self.label), reference=self,
            weight=take(self.weight), position=take(self.position),
            init_score=take(self.init_score), feature_name=self.feature_name,
            categorical_feature=self.categorical_feature,
            params=params or self.params, free_raw_data=self.free_raw_data)
        sub.used_indices = idx
        return sub


class Booster:
    """Booster wrapper (reference basic.py:3543)."""

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        train_set: Optional[Dataset] = None,
        model_file: Optional[Union[str, Path]] = None,
        model_str: Optional[str] = None,
    ):
        self.params = copy.deepcopy(params) or {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            from .boosting import create_boosting
            from .config import DATASET_PARAMS, resolve_alias

            net = {resolve_alias(k): v for k, v in self.params.items()}
            nm = int(net.get("num_machines", 1))
            if nm > 1:
                # distributed network params join the cluster before the
                # booster's set-up (reference basic.py:3606); a process
                # group that already exists is kept
                dt = str(net.get("device_type", "cuda"))
                set_network(
                    machines=net.get("machines", ""),
                    local_listen_port=int(net.get("local_listen_port",
                                                  12400)),
                    num_machines=nm,
                    machine_list_file=net.get("machine_list_filename", ""),
                    device="cpu" if dt == "cpu" else "cuda")
            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            ds_part = {k: v for k, v in train_set.params.items()
                       if resolve_alias(k) in DATASET_PARAMS}
            self.config = Config({**ds_part, **self.params})
            self._gbdt = create_boosting(self.config, train_set._binned)
            self.train_set = train_set
            self._valid_sets: List[Dataset] = []
            self._name_valid_sets: List[str] = []
        elif model_file is not None or model_str is not None:
            from .model_io import load_model_string

            if model_file is not None:
                model_str = Path(model_file).read_text()
            self.config, self._gbdt = load_model_string(model_str)
            self.train_set = None
            self._valid_sets = []
            self._name_valid_sets = []
        else:
            raise TypeError("At least one of train_set, model_file or "
                            "model_str should be not None.")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        if data.reference is not self.train_set:
            data.reference = self.train_set
        data.construct()
        self._gbdt.add_valid(data._binned, name)
        self._valid_sets.append(data)
        self._name_valid_sets.append(name)
        return self

    def _continue_from(self, init_booster: "Booster") -> None:
        """Continued training (reference input_model / python init_model,
        boosting.h:311; the JAX package's Booster._continue_from): adopt
        the loaded model's trees, count their iterations in iter_ (every
        draw keys on the global iteration), and seed every score set with
        their binned-traversal predictions. Call after add_valid."""
        from .tree import tree_to_arrays

        gb = self._gbdt
        src = init_booster._gbdt
        K = gb.num_class
        if src.num_class != K:
            log.fatal(f"init_model has {src.num_class} models per "
                      f"iteration, training config has {K}")
        models = list(src.models)
        gb.models = list(models)
        gb.iter_ = gb._init_iters = len(models) // K
        for mi, t in enumerate(models):
            arrays = tree_to_arrays(t, gb.train_set, gb.device)
            gb.device_trees.append(arrays)
            k = mi % K
            for ss in [gb.train] + gb.valids:
                if t.num_leaves > 1:
                    leaf = gb._traverse(arrays, ss.dev)
                    ss.score[k] += arrays.leaf_value[leaf.long()]
                else:
                    ss.score[k] += float(t.leaf_value[0])

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True if training stopped. fobj(preds,
        train_set) -> (grad, hess) over the raw training scores."""
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Resetting train_set is not supported")
        if fobj is None:
            return self._gbdt.train_one_iter()
        # DART drops its trees before the score is read (dart.hpp:80)
        if hasattr(self._gbdt, "before_gradients"):
            self._gbdt.before_gradients()
        grad, hess = fobj(self._inner_predict_raw(0), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their score contributions
        (GBDT::RollbackOneIter, gbdt.cpp:462)."""
        self._gbdt.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_class

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New parameters between iterations: the learning rate and the
        split parameters are derived anew; the sampling strategy and the
        feature sampler read the live config."""
        from .learner.grower import make_split_params

        self.params.update(params)
        self.config.update(params)
        self._gbdt.shrinkage_rate = self.config.learning_rate
        self._gbdt.params = make_split_params(self.config)
        return self

    def _inner_predict_raw(self, data_idx: int) -> np.ndarray:
        """The raw scores of the training set (0) or a validation set."""
        g = self._gbdt
        ss = g.train if data_idx == 0 else g.valids[data_idx - 1]
        score = g.get_score(ss)
        return score if g.num_class > 1 else score[0]

    def eval(self, data: Dataset, name: str, feval=None):
        raise NotImplementedError("use eval_train/eval_valid")

    def eval_train(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        out = [(self._train_data_name, n, v, hb)
               for (_dn, n, v, hb) in self._gbdt.eval_train()]
        if feval is not None:
            out.extend(self._run_feval(feval, 0, self._train_data_name))
        return out

    def eval_valid(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        out = self._gbdt.eval_valid()
        if feval is not None:
            for i, name in enumerate(self._name_valid_sets):
                out.extend(self._run_feval(feval, i + 1, name))
        return out

    def _run_feval(self, feval, data_idx: int, name: str):
        """feval(preds, dataset) -> (name, value, higher_better) or a list
        of them; one callable or a list. preds are the converted scores
        (GetPredictAt -> ConvertOutput, gbdt.cpp:709); objective none
        converts nothing."""
        ds = self.train_set if data_idx == 0 else \
            self._valid_sets[data_idx - 1]
        preds = self._inner_predict_raw(data_idx)
        if self._gbdt.objective is not None:
            preds = self._gbdt.objective.convert_output(preds)
        results = []
        for f in feval if isinstance(feval, (list, tuple)) else [feval]:
            res = f(preds, ds)
            results.extend(res if isinstance(res, list) else [res])
        return [(name, rn, rv, rhb) for rn, rv, rhb in results]

    def predict(self, data: Any, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                validate_features: bool = False,
                device: Optional[str] = None, **kwargs: Any) -> np.ndarray:
        """Predictions of the host walker (device None / "cpu" / "host"),
        or of the tensorized forest on the card (device "cuda", "gpu" or
        "tpu"; it raises when torch sees no card). pred_leaf gives the
        (N, trees) leaf indices, pred_contrib the (N, K * (F + 1)) SHAP
        values of host TreeSHAP, which has no device version behind this
        entry point (a warning says so under device=; the forest's
        device TreeSHAP is serving's contrib op). validate_features is
        accepted and, as in the JAX package on a dense matrix, checks
        nothing: a numpy matrix carries no feature names."""
        other = set(kwargs) - set(_EARLY_STOP_KEYS)
        if other:
            raise NotImplementedError(
                f"prediction options {sorted(other)} are not ported yet "
                "(ROADMAP queue A)")
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        g = self._gbdt
        if device not in (None, "", "cpu", "host"):
            from .serving.forest import serve_device

            dev = serve_device(device)  # raises without a card
            if pred_contrib:
                log.warning("pred_contrib has no device implementation; "
                            "using the host SHAP path")
            elif kwargs.get("pred_early_stop",
                            self.params.get("pred_early_stop", False)):
                log.warning("pred_early_stop has no device implementation; "
                            "using the host predictor")
            else:
                from .serving.forest import TensorForest

                forest = TensorForest.from_booster(self, device=dev)
                if pred_leaf:
                    return _host_rows(data, lambda x: forest.predict_leaf(
                        x, start_iteration, num_iteration))

                def scores(x):
                    raw = forest.predict_raw(x, start_iteration,
                                             num_iteration)
                    if not raw_score:
                        raw = g.convert_output(raw)
                    return raw[0] if g.num_class == 1 else raw.T

                return _host_rows(data, scores)
        if pred_leaf:
            return _host_rows(data, lambda x: g.predict_leaf_index(
                x, start_iteration, num_iteration))
        if pred_contrib:
            if any(t.is_linear for t in g.models):
                log.fatal("pred_contrib (SHAP) is not supported for models "
                          "with linear trees")
            return _host_rows(data, lambda x: g.predict_contrib(
                x, start_iteration, num_iteration))
        early_stop = self._early_stop(kwargs)
        return _host_rows(data, lambda x: g.predict(
            x, start_iteration, num_iteration, raw_score=raw_score,
            early_stop=early_stop))

    def _early_stop(self, kwargs) -> Optional[Tuple[int, float]]:
        """The per-row prediction early stop (prediction_early_stop.cpp)
        as the JAX package's predict reads it: kwargs first, then the
        Booster's params; (freq, margin) for classification, else None
        with a warning."""
        keys = dict(zip(_EARLY_STOP_KEYS, (False, 10, 10.0)))
        get = lambda k: kwargs.get(k, self.params.get(k, keys[k]))
        if not get("pred_early_stop"):
            return None
        if not (self._gbdt.num_class > 1 or getattr(
                self.config, "objective", "") in (
                    "binary", "cross_entropy", "cross_entropy_lambda")):
            log.warning("pred_early_stop only applies to classification; "
                        "ignored")
            return None
        return (int(get("pred_early_stop_freq")),
                float(get("pred_early_stop_margin")))

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        """The text model; importance_type is accepted as the JAX package
        accepts it (its footer counts splits)."""
        from .model_io import save_model_string

        ni = num_iteration
        if ni is None:
            ni = self.best_iteration if self.best_iteration > 0 else -1
        return save_model_string(self._gbdt, self.config, ni, start_iteration)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0, importance_type: str = "split",
                   object_hook=None) -> Dict[str, Any]:
        """The JSON model (LGBM_BoosterDumpModel) as a dict; object_hook
        is applied as json.loads applies it, bottom-up over every
        dict."""
        from .model_io import dump_model_dict

        ni = num_iteration
        if ni is None:
            ni = self.best_iteration if self.best_iteration > 0 else -1
        d = dump_model_dict(self._gbdt, self.config, ni, start_iteration,
                            importance_type)
        if object_hook is not None:
            import json

            d = json.loads(json.dumps(d), object_hook=object_hook)
        return d

    @classmethod
    def _from_loaded(cls, config: Config, gbdt) -> "Booster":
        """A prediction-capable Booster around a loaded (config, GBDT),
        as load_model_dict returns them."""
        b = cls.__new__(cls)
        b.params, b.best_iteration, b.best_score = {}, -1, {}
        b._train_data_name = "training"
        b.config, b._gbdt = config, gbdt
        b.train_set, b._valid_sets, b._name_valid_sets = None, [], []
        return b

    def save_model(self, filename: Union[str, Path],
                   num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        Path(filename).write_text(
            self.model_to_string(num_iteration, start_iteration))
        return self

    # ---- model surgery and inspection (the JAX package's basic.py
    # :1140-1389)
    def refit(self, data: Any, label: Any, decay_rate: float = 0.9,
              **kwargs: Any) -> "Booster":
        """A new Booster whose trees keep their structure and take leaf
        outputs refitted on data (Booster.refit / LGBM_BoosterRefit,
        GBDT.refit). The source Booster is left unchanged: its trees are
        copied, its score sets' tensors cloned; the binned training data
        is shared."""
        import dataclasses

        if _is_sparse(data):
            log.warning("refit densifies its sparse input")
        arr, _ = _to_2d_numpy(data)
        src = self._gbdt
        new = copy.copy(self)
        gb = new._gbdt = copy.copy(src)
        gb.models = [copy.deepcopy(t) for t in src.models]
        gb.device_trees = list(src.device_trees)
        gb._fused = None
        if src.train_set is not None:
            gb.train = dataclasses.replace(src.train,
                                           score=src.train.score.clone())
            gb.valids = [dataclasses.replace(v, score=v.score.clone())
                         for v in src.valids]
        from .config import resolve_alias

        params = dict(self.config.explicit_params())
        # a loaded model's Booster takes its device from its own params
        params.update({k: v for k, v in self.params.items()
                       if resolve_alias(k) == "device_type"})
        params["refit_decay_rate"] = decay_rate
        new.config = gb.config = Config(params)
        gb.refit(arr, _to_1d(label), weight=kwargs.get("weight"),
                 group=kwargs.get("group"))
        return new

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of the numerical thresholds the model chose for one
        feature (reference basic.py:5065): numpy.histogram's (hist,
        bin_edges), or with xgboost_style a (SplitValue, Count) matrix
        (a DataFrame when pandas is there)."""
        values = _split_values(self, feature)
        n_unique = len(set(values))
        if bins is None or (isinstance(bins, int) and xgboost_style
                            and bins > n_unique):
            bins = max(n_unique, 1)
        hist, edges = np.histogram(np.asarray(values, dtype=np.float64),
                                   bins=bins)
        if not xgboost_style:
            return hist, edges
        keep = hist != 0
        out = np.column_stack((edges[1:][keep], hist[keep]))
        try:
            import pandas as pd

            return pd.DataFrame(out, columns=["SplitValue", "Count"])
        except ImportError:
            return out

    def feature_importance(self, importance_type: str = "split",
                           iteration=None) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)

    def feature_name(self) -> List[str]:
        if self.train_set is not None:
            return self.train_set.get_feature_name()
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        if self._gbdt.train_set is not None:
            return self._gbdt.train_set.num_total_features
        return len(self._gbdt.feature_names)

    def free_dataset(self) -> "Booster":
        self.train_set = None
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """The training set's name in eval output."""
        self._train_data_name = name
        return self

    def model_from_string(self, model_str: str) -> "Booster":
        """Load a text model in place."""
        from .model_io import load_model_string

        self.config, self._gbdt = load_model_string(model_str)
        self.train_set = None
        self._valid_sets = []
        self._name_valid_sets = []
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """One leaf's output (LGBM_BoosterGetLeafValue)."""
        return float(self._gbdt.models[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """Overwrite one leaf's output (LGBM_BoosterSetLeafValue,
        Tree::SetLeafOutput): the host tree and the device tree's
        leaf_value (a new tensor, so a refit copy sharing the old one is
        untouched). As in the reference, scores already accumulated are
        not adjusted."""
        g = self._gbdt
        g.models[tree_id].leaf_value[leaf_id] = float(value)
        if tree_id < len(g.device_trees):
            arrays = g.device_trees[tree_id]
            lv = arrays.leaf_value.clone()
            lv[leaf_id] = float(value)
            g.device_trees[tree_id] = arrays._replace(leaf_value=lv)
        return self

    def lower_bound(self) -> float:
        """The least raw score any input can get
        (LGBM_BoosterGetLowerBoundValue: the sum of the trees' minima)."""
        return float(sum(float(np.min(t.leaf_value[: t.num_leaves]))
                         for t in self._gbdt.models))

    def upper_bound(self) -> float:
        """The largest raw score (LGBM_BoosterGetUpperBoundValue)."""
        return float(sum(float(np.max(t.leaf_value[: t.num_leaves]))
                         for t in self._gbdt.models))

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the iterations in [start, end) with numpy's global
        generator (LGBM_BoosterShuffleModels; predictions do not depend
        on the order)."""
        g = self._gbdt
        K = g.num_class
        n_iter = g.num_trees() // K
        end = n_iter if end_iteration < 0 else min(end_iteration, n_iter)
        idx = np.arange(start_iteration, end)
        np.random.shuffle(idx)
        order = np.concatenate([np.arange(start_iteration), idx,
                                np.arange(end, n_iter)])
        models, dev = g.models, g.device_trees
        g.models = [models[i * K + k] for i in order for k in range(K)]
        if len(dev) == len(models):
            g.device_trees = [dev[i * K + k] for i in order for k in range(K)]
        return self

    def trees_to_dataframe(self):
        """Every tree flattened to one pandas DataFrame, a row a node or
        leaf (reference Booster.trees_to_dataframe's columns). pandas is
        imported here, and its absence raises ImportError."""
        import pandas as pd

        if self._gbdt.num_trees() == 0:
            raise LightGBMError("There are no trees in this Booster and "
                                "thus nothing to parse")
        names = self.feature_name()

        def node_ix(tree_index: int, node: Dict[str, Any]) -> str:
            if "split_index" in node:
                return f"{tree_index}-S{node['split_index']}"
            return f"{tree_index}-L{node.get('leaf_index', 0)}"

        rows: List[Dict[str, Any]] = []
        for t in self.dump_model()["tree_info"]:
            ti = t["tree_index"]
            # an explicit preorder stack: a chain-shaped deep tree must not
            # reach the interpreter's recursion limit
            stack = [(t["tree_structure"], 1, None)]
            while stack:
                node, depth, parent = stack.pop()
                ix = node_ix(ti, node)
                is_split = "split_index" in node
                left, right = node.get("left_child"), node.get("right_child")
                f = node.get("split_feature")
                rows.append({
                    "tree_index": ti,
                    "node_depth": depth,
                    "node_index": ix,
                    "left_child": node_ix(ti, left) if left else None,
                    "right_child": node_ix(ti, right) if right else None,
                    "parent_index": parent,
                    "split_feature": ((names[f] if f < len(names)
                                       else f"Column_{f}")
                                      if is_split else None),
                    "split_gain": node.get("split_gain"),
                    "threshold": node.get("threshold"),
                    "decision_type": node.get("decision_type"),
                    "missing_direction": (
                        ("left" if node.get("default_left") else "right")
                        if is_split else None),
                    "missing_type": node.get("missing_type"),
                    "value": node.get("internal_value",
                                      node.get("leaf_value")),
                    "weight": node.get("internal_weight",
                                       node.get("leaf_weight")),
                    "count": node.get("internal_count",
                                      node.get("leaf_count")),
                })
                if is_split:
                    stack.append((right, depth + 1, ix))
                    stack.append((left, depth + 1, ix))
        return pd.DataFrame(rows)

    def set_network(self, machines: Any, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Join the cluster from an existing Booster (reference basic.py
        Booster.set_network; the module-level set_network applies)."""
        set_network(machines, local_listen_port, listen_time_out,
                    num_machines)
        self._network = True
        return self

    def free_network(self) -> "Booster":
        """Leave the cluster (destroys the process group, if any)."""
        from .parallel.multihost import free_distributed

        free_distributed()
        self._network = False
        return self


def _split_values(bst: Booster, feature: Union[int, str]) -> List[float]:
    """The numerical thresholds of every split on one feature, in the
    JSON model's preorder (the JAX package's plotting._split_values)."""
    model = bst.dump_model()
    names = [f["name"] if isinstance(f, dict) else f
             for f in model.get("feature_names", [])]
    if isinstance(feature, str):
        if feature not in names:
            raise ValueError(f"unknown feature name {feature!r}")
        fidx = names.index(feature)
    else:
        fidx = int(feature)
    out: List[float] = []
    for t in model["tree_info"]:
        stack = [t.get("tree_structure", {})]
        while stack:
            node = stack.pop()
            if (node.get("split_feature") == fidx
                    and node.get("decision_type") == "<="):
                out.append(float(node["threshold"]))
            for side in ("right_child", "left_child"):
                if isinstance(node.get(side), dict):
                    stack.append(node[side])
    return out
