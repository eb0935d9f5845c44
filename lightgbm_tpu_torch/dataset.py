"""Binned dataset: host construction + device residency.

Equivalent of the reference Dataset/FeatureGroup/Metadata stack
(include/LightGBM/dataset.h:487, src/io/dataset.cpp, src/io/metadata.cpp),
as lightgbm_tpu/dataset.py lays it out, with torch tensors on a chosen
device:

- all features are stored as ONE dense feature-major bin matrix
  (num_used_features, num_rows_padded) in the narrowest integer dtype,
  padded on the row axis to a 2048-row block multiple (the JAX
  package's layout, kept at the public functions so both packages see
  the same matrix);
- trivial (constant) features are dropped up front (feature_pre_filter);
- metadata (label/weight/group/init_score/position, reference
  dataset.h:48-399) is validated host-side and shipped as device arrays;
- a scipy sparse matrix is binned from its stored values (from_csr,
  never densified), and copy_subrow takes a row subset that shares the
  mappers and the EFB layout (Dataset.subset, cv's folds);
- Sequence inputs bin in two streamed passes (from_sequences, bin_chunk),
  and data/streaming.py's StreamedBinnedDataset keeps its bins on disk
  and assembles the device matrix chunk by chunk.

There is no FixHistogram equivalent: the reference omits each feature's
most-frequent bin from sparse storage and reconstructs it from parent
sums (dataset.h:768); our dense device matrix stores every bin, so
histograms are complete by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import log
from .binning import BinMapper, BinType
from .config import Config

from .learner.histogram import HIST_BLK

DEFAULT_ROW_BLOCK = HIST_BLK  # device row padding block


def _row_block(config: Config) -> int:
    """The device row padding block: tpu_row_block rounded up to a
    HIST_BLK multiple, as the JAX package rounds it, so both packages pad
    to the same row count."""
    row_block = config.tpu_row_block or DEFAULT_ROW_BLOCK
    if row_block % HIST_BLK != 0:
        rounded = ((row_block + HIST_BLK - 1) // HIST_BLK) * HIST_BLK
        log.warning(
            f"tpu_row_block={row_block} is not a multiple of the "
            f"device row block ({HIST_BLK}); rounding up to {rounded}"
        )
        row_block = rounded
    return row_block


def _metadata(num_data, label, weight, group, init_score,
              position) -> "Metadata":
    """The metadata in the binned dataset's types, checked."""
    arr = lambda v, t: None if v is None else np.asarray(v, t).ravel()
    meta = Metadata(label=arr(label, np.float32),
                    weight=arr(weight, np.float32),
                    group=arr(group, np.int64),
                    init_score=arr(init_score, np.float64),
                    position=arr(position, np.int32))
    meta.check(num_data)
    return meta


def _used_features(mappers: List[BinMapper], config: Config):
    """(the non-trivial features, the widest of their bin counts, their
    monotone constraints or None) of freshly built mappers."""
    used = np.array([f for f, m in enumerate(mappers) if not m.is_trivial],
                    dtype=np.int64)
    if len(used) == 0:
        log.fatal("cannot construct Dataset: all features are constant")
    max_num_bin = max(mappers[f].num_bin for f in used)
    mono = None
    mc = list(config.monotone_constraints)
    if mc:
        if len(mc) != len(mappers):
            log.fatal("monotone_constraints length must equal num features")
        mono = np.array([mc[f] for f in used], dtype=np.int8)
    return used, max_num_bin, mono


def _choose_bin_dtype(max_num_bin: int) -> Any:
    if max_num_bin <= 256:
        return np.uint8
    if max_num_bin <= 65536:
        return np.uint16
    return np.int32


def bin_chunk(proto: "BinnedDataset", chunk: np.ndarray, dtype) -> np.ndarray:
    """One (rows, features) float chunk binned with a constructed
    dataset's mappers (and EFB-encoded) -> its (G, rows) columns: the
    second pass of the reference's two-pass extract
    (dataset_loader.cpp:1399), shared by the Sequence path, two_round text
    loading and the chunk store. values_to_bins takes the native path
    above 32,768 values and gives the Python path's bins bit for bit."""
    used = proto.used_features
    sub = np.empty((len(used), chunk.shape[0]), dtype=dtype)
    for i, f in enumerate(used):
        sub[i] = proto.mappers[f].values_to_bins(chunk[:, f]).astype(dtype)
    if proto.bundle_layout is not None:
        from .bundling import encode

        um = [proto.mappers[f] for f in used]
        sub, _ = encode(sub, proto.bundle_layout,
                        [m.num_bin for m in um],
                        [m.most_freq_bin for m in um], dtype)
    return sub


@dataclass
class Metadata:
    """Labels/weights/query groups/init scores (reference dataset.h:48)."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    group: Optional[np.ndarray] = None  # per-query sizes (reference convention)
    init_score: Optional[np.ndarray] = None
    position: Optional[np.ndarray] = None

    def query_boundaries(self) -> Optional[np.ndarray]:
        if self.group is None:
            return None
        return np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)

    def check(self, num_data: int) -> None:
        if self.label is not None and len(self.label) != num_data:
            log.fatal(f"label length {len(self.label)} != num_data {num_data}")
        if self.weight is not None and len(self.weight) != num_data:
            log.fatal(f"weight length {len(self.weight)} != num_data {num_data}")
        if self.group is not None and int(np.sum(self.group)) != num_data:
            log.fatal("sum of query group sizes != num_data")


@dataclass
class BinnedDataset:
    """Host-side binned dataset + on-demand device arrays."""

    bins: np.ndarray  # (num_used_features, num_rows) int
    mappers: List[BinMapper]  # one per ORIGINAL feature
    used_features: np.ndarray  # original indices of non-trivial features
    num_data: int
    metadata: Metadata
    feature_names: List[str]
    max_num_bin: int  # uniform bin-axis size on device
    row_block: int
    monotone_constraints: Optional[np.ndarray] = None  # per used feature, in {-1,0,1}
    raw_data: Optional[np.ndarray] = None  # kept for linear trees / refit
    # EFB (bundling.py): when set, `bins` holds BUNDLE columns (G, N)
    # and these describe the feature -> column mapping
    bundle_layout: Optional[Any] = None
    bundle_expand: Optional[np.ndarray] = None  # (F, max_num_bin) int32
    _device: Optional[Dict[str, Any]] = field(default=None, repr=False)

    # ---------------- construction ----------------
    @staticmethod
    def from_numpy(
        data: np.ndarray,
        config: Config,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        group: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
        position: Optional[np.ndarray] = None,
        categorical_feature: Optional[Sequence[int]] = None,
        feature_names: Optional[Sequence[str]] = None,
        reference: Optional["BinnedDataset"] = None,
        keep_raw: bool = False,
    ) -> "BinnedDataset":
        """Build bin mappers from a sample and bin the full matrix.

        Mirrors DatasetLoader::ConstructFromSampleData semantics
        (src/io/dataset_loader.cpp:1079): sample up to
        bin_construct_sample_cnt rows, FindBin per feature, then bin all
        rows. With `reference`, reuse its mappers (python-package aligned
        valid-set behavior, basic.py Dataset reference semantics).
        """
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("data must be 2-dimensional")
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        num_data, num_features = data.shape
        cat_set = set(int(c) for c in (categorical_feature or ()))

        if feature_names is None:
            feature_names = [f"Column_{i}" for i in range(num_features)]
        feature_names = list(feature_names)

        if reference is not None:
            mappers = reference.mappers
            if len(mappers) != num_features:
                log.fatal("reference dataset has different number of features")
            used = reference.used_features.copy()
            max_num_bin = reference.max_num_bin
            mono = reference.monotone_constraints
        else:
            rng = np.random.RandomState(config.data_random_seed)
            sample_cnt = min(num_data, config.bin_construct_sample_cnt)
            if sample_cnt < num_data:
                sample_idx = np.sort(rng.choice(num_data, sample_cnt, replace=False))
                sample = data[sample_idx]
            else:
                sample = data
            max_bin_by_feature = list(config.max_bin_by_feature)
            from .binning import load_forced_bins

            forced_map = load_forced_bins(
                config.forcedbins_filename, num_features
            )
            mappers = []
            for f in range(num_features):
                mb = (
                    max_bin_by_feature[f]
                    if f < len(max_bin_by_feature)
                    else config.max_bin
                )
                col = sample[:, f]
                mappers.append(
                    BinMapper.from_sample(
                        col,
                        total_sample_cnt=len(sample),
                        # the reference passes config max_bin straight to
                        # FindBin (dataset_loader.cpp:652) — num_bin ends
                        # <= max_bin, NOT max_bin+1
                        max_bin=mb,
                        min_data_in_bin=config.min_data_in_bin,
                        use_missing=config.use_missing,
                        zero_as_missing=config.zero_as_missing,
                        bin_type=BinType.CATEGORICAL if f in cat_set else BinType.NUMERICAL,
                        max_cat_threshold=config.max_cat_threshold,
                        forced_bounds=forced_map.get(f),
                    )
                )
            used, max_num_bin, mono = _used_features(mappers, config)

        # bin the full matrix, feature-major
        dtype = _choose_bin_dtype(max_num_bin)
        bins = np.empty((len(used), num_data), dtype=dtype)
        for i, f in enumerate(used):
            bins[i] = mappers[f].values_to_bins(data[:, f]).astype(dtype)

        # EFB bundling (dataset.cpp:111 FindGroups / :250
        # FastFeatureBundling): merge near-exclusive sparse features into
        # shared columns. A reference dataset's layout is reused verbatim
        # (valid sets must bin + bundle identically).
        bundle_layout = None
        bundle_expand = None
        if reference is not None:
            bundle_layout = reference.bundle_layout
            bundle_expand = reference.bundle_expand
            if bundle_layout is not None:
                from .bundling import encode

                um = [mappers[f] for f in used]
                merged, _ = encode(
                    bins, bundle_layout,
                    [m.num_bin for m in um],
                    [m.most_freq_bin for m in um],
                    _choose_bin_dtype(bundle_layout.col_bins),
                )
                bins = merged
        elif config.enable_bundle and len(used) > 1:
            from .bundling import bundle_features

            um = [mappers[f] for f in used]
            res = bundle_features(bins, um, config.max_bin)
            if res is not None:
                bins, bundle_layout, bundle_expand = res
                log.info(
                    f"EFB: bundled {len(used)} features into "
                    f"{bundle_layout.num_columns} columns "
                    f"(col bins={bundle_layout.col_bins})"
                )

        meta = _metadata(num_data, label, weight, group, init_score,
                         position)
        return BinnedDataset(
            bins=bins,
            mappers=mappers,
            used_features=used,
            num_data=num_data,
            metadata=meta,
            feature_names=feature_names,
            max_num_bin=max_num_bin,
            row_block=_row_block(config),
            monotone_constraints=mono,
            raw_data=data if keep_raw else None,
            bundle_layout=bundle_layout,
            bundle_expand=bundle_expand,
        )

    @staticmethod
    def from_csr(
        data,
        config: Config,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        group: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
        position: Optional[np.ndarray] = None,
        feature_names: Optional[Sequence[str]] = None,
        reference: Optional["BinnedDataset"] = None,
    ) -> "BinnedDataset":
        """A scipy sparse matrix (any format with tocsc / tocsr) binned
        without densifying it (the JAX package's from_csr; reference
        sparse_bin.hpp:73). The mappers bin each column's stored values,
        the implicit zeros inferred from the row counts as FindBin infers
        them from its zero-omitting sample; EFB's conflicts are sorted
        row-index intersections (bundling.find_groups_sparse); only the
        bundled (G, N) bin matrix is ever built. Categorical features and
        linear trees take the dense path (basic.Dataset.construct)."""
        csc = data.tocsc()
        csc.sort_indices()
        num_data, num_features = csc.shape

        if reference is not None:
            mappers = reference.mappers
            if len(mappers) != num_features:
                log.fatal("reference dataset has different number of features")
            used = reference.used_features.copy()
            max_num_bin = reference.max_num_bin
            mono = reference.monotone_constraints
        else:
            rng = np.random.RandomState(config.data_random_seed)
            sample_cnt = min(num_data, config.bin_construct_sample_cnt)
            if sample_cnt < num_data:
                idx = np.sort(rng.choice(num_data, sample_cnt, replace=False))
                s_csc = data.tocsr()[idx].tocsc()
            else:
                s_csc = csc
            mb_list = list(config.max_bin_by_feature)
            from .binning import load_forced_bins

            forced_map = load_forced_bins(config.forcedbins_filename,
                                          num_features)
            mappers = []
            for f in range(num_features):
                vals = s_csc.data[s_csc.indptr[f]: s_csc.indptr[f + 1]]
                mb = mb_list[f] if f < len(mb_list) else config.max_bin
                mappers.append(BinMapper.from_sample(
                    vals,
                    total_sample_cnt=s_csc.shape[0],
                    max_bin=mb,
                    min_data_in_bin=config.min_data_in_bin,
                    use_missing=config.use_missing,
                    zero_as_missing=config.zero_as_missing,
                    forced_bounds=forced_map.get(f),
                ))
            used, max_num_bin, mono = _used_features(mappers, config)

        # per used feature its stored (rows, bins) and non-default rows
        nz = []
        nd_rows: List[Optional[np.ndarray]] = []
        for f in used:
            f = int(f)
            lo, hi = csc.indptr[f], csc.indptr[f + 1]
            rows = csc.indices[lo:hi]
            b = mappers[f].values_to_bins(csc.data[lo:hi])
            nz.append((rows, b))
            m = mappers[f]
            # mergeable only when the implicit zeros sit in the most
            # frequent bin (merged columns never store that bin)
            if m.most_freq_bin == m.default_bin:
                nd_rows.append(np.asarray(rows[b != m.most_freq_bin]))
            else:
                nd_rows.append(None)

        from .bundling import build_expand_idx, build_layout, find_groups_sparse

        um = [mappers[int(f)] for f in used]
        u_bins = [m.num_bin for m in um]
        if reference is not None:
            layout = reference.bundle_layout
            groups = (layout.groups if layout is not None
                      else [[i] for i in range(len(used))])
        elif config.enable_bundle and len(used) > 1:
            groups = find_groups_sparse(
                nd_rows, u_bins, num_data,
                max(config.max_bin + 1, 256),  # the dense path's cap
            )
            if all(len(g) == 1 for g in groups):
                layout = None
                groups = [[i] for i in range(len(used))]
            else:
                layout = build_layout(groups, u_bins)
                log.info(f"EFB (sparse): bundled {len(used)} features into "
                         f"{layout.num_columns} columns "
                         f"(col bins={layout.col_bins})")
        else:
            layout = None
            groups = [[i] for i in range(len(used))]

        col_bins = layout.col_bins if layout is not None else max_num_bin
        dtype = _choose_bin_dtype(max(col_bins, max_num_bin))
        bins = np.zeros((len(groups), num_data), dtype=dtype)
        mfb = np.full(len(used), -1, np.int32)
        for gid, feats in enumerate(groups):
            if len(feats) == 1:
                i = feats[0]
                rows, b = nz[i]
                db = um[i].default_bin
                if db != 0:
                    bins[gid, :] = db
                bins[gid, rows] = b.astype(dtype)
                continue
            col = bins[gid]
            for i in feats:
                rows, b = nz[i]
                m = int(um[i].most_freq_bin)
                mfb[i] = m
                db = int(um[i].default_bin)
                if db != m:
                    # a reference layout built densely may merge a feature
                    # whose most frequent bin is not the zero bin: its
                    # implicit zero rows carry default_bin, offset-encoded
                    # like any other stored bin
                    imp = np.setdiff1d(np.arange(num_data, dtype=rows.dtype),
                                       rows, assume_unique=True)
                    col[imp] = dtype(int(layout.off_lo[i]) + db - (db > m))
                ndm = b != m
                shifted = b[ndm].astype(np.int64) - (b[ndm] > m)
                col[rows[ndm]] = (layout.off_lo[i] + shifted).astype(dtype)
        bundle_layout = bundle_expand = None
        if layout is not None:
            if reference is None:
                layout = layout._replace(mfb=mfb)
                bundle_expand = build_expand_idx(layout, u_bins, max_num_bin)
            else:
                bundle_expand = reference.bundle_expand
            bundle_layout = layout

        return BinnedDataset(
            bins=bins,
            mappers=mappers,
            used_features=used,
            num_data=num_data,
            metadata=_metadata(num_data, label, weight, group, init_score,
                               position),
            feature_names=(list(feature_names) if feature_names is not None
                           else [f"Column_{i}" for i in range(num_features)]),
            max_num_bin=max_num_bin,
            row_block=_row_block(config),
            monotone_constraints=mono,
            bundle_layout=bundle_layout,
            bundle_expand=bundle_expand,
        )

    @staticmethod
    def from_sequences(
        seqs: Sequence[Any],
        config: Config,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        group: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
        position: Optional[np.ndarray] = None,
        categorical_feature: Optional[Sequence[int]] = None,
        feature_names: Optional[Sequence[str]] = None,
    ) -> "BinnedDataset":
        """Two-pass construction from random-access Sequences (reference
        python Sequence basic.py:905 and the push APIs dataset.h:518-627):
        pass 1 samples rows across all sequences (the JAX package's draw)
        and builds the mappers; pass 2 bins batch-sized chunks straight
        into the integer matrix. The whole float matrix never exists."""
        lens = [len(s) for s in seqs]
        total = int(np.sum(lens))
        if total == 0:
            log.fatal("cannot construct Dataset from empty sequences")
        rng = np.random.RandomState(config.data_random_seed)
        n_sample = min(total, config.bin_construct_sample_cnt)
        idx = np.sort(rng.choice(total, n_sample, replace=False))
        bounds = np.concatenate([[0], np.cumsum(lens)])

        def row(g: int) -> np.ndarray:
            s = int(np.searchsorted(bounds, g, side="right")) - 1
            return np.asarray(seqs[s][int(g - bounds[s])],
                              np.float64).reshape(-1)

        sample = np.asarray([row(g) for g in idx])
        proto = BinnedDataset.from_numpy(
            sample, config, categorical_feature=categorical_feature,
            feature_names=feature_names)
        dtype = proto.bins.dtype
        bins = np.empty((proto.bins.shape[0], total), dtype=dtype)
        row0 = 0
        for s in seqs:
            bs = int(getattr(s, "batch_size", 4096) or 4096)
            for lo in range(0, len(s), bs):
                chunk = np.asarray(s[lo: lo + bs], np.float64)
                if chunk.ndim == 1:
                    chunk = chunk.reshape(1, -1)
                bins[:, row0: row0 + chunk.shape[0]] = bin_chunk(
                    proto, chunk, dtype)
                row0 += chunk.shape[0]
        return BinnedDataset(
            bins=bins,
            mappers=proto.mappers,
            used_features=proto.used_features,
            num_data=total,
            metadata=_metadata(total, label, weight, group, init_score,
                               position),
            feature_names=list(proto.feature_names),
            max_num_bin=proto.max_num_bin,
            row_block=proto.row_block,
            monotone_constraints=proto.monotone_constraints,
            bundle_layout=proto.bundle_layout,
            bundle_expand=proto.bundle_expand,
        )

    def _subset_metadata(self, idx: np.ndarray) -> Metadata:
        """The metadata of a row subset. Only a subset aligned with whole
        queries (each query's rows, in order, one query after another)
        keeps the query sizes; any other drops them with a warning."""
        meta = self.metadata
        group = None
        if meta.group is not None:
            qb = meta.query_boundaries()
            starts = set(qb[:-1].tolist())
            sizes = []
            i = 0
            aligned = True
            while i < len(idx):
                if int(idx[i]) not in starts:
                    aligned = False
                    break
                q = int(np.searchsorted(qb, idx[i], side="right")) - 1
                qlen = int(qb[q + 1] - qb[q])
                if i + qlen > len(idx) or not np.array_equal(
                        idx[i: i + qlen], np.arange(idx[i], idx[i] + qlen)):
                    aligned = False
                    break
                sizes.append(qlen)
                i += qlen
            if aligned:
                group = np.asarray(sizes, dtype=np.int64)
            else:
                log.warning("subset indices do not align with query "
                            "boundaries; group info dropped")
        take = lambda v: None if v is None else v[idx]
        return Metadata(label=take(meta.label), weight=take(meta.weight),
                        group=group, init_score=take(meta.init_score),
                        position=take(meta.position))

    def copy_subrow(self, indices: np.ndarray) -> "BinnedDataset":
        """A row subset sharing the mappers and the EFB layout (reference
        Dataset::CopySubrow; python Dataset.subset). It keeps row_block,
        so it pads its rows as from_numpy pads a matrix of its size."""
        idx = np.asarray(indices, dtype=np.int64)
        return BinnedDataset(
            bins=np.ascontiguousarray(self.bins[:, idx]),
            mappers=self.mappers,
            used_features=self.used_features,
            num_data=len(idx),
            metadata=self._subset_metadata(idx),
            feature_names=self.feature_names,
            max_num_bin=self.max_num_bin,
            row_block=self.row_block,
            monotone_constraints=self.monotone_constraints,
            raw_data=None if self.raw_data is None else self.raw_data[idx],
            bundle_layout=self.bundle_layout,
            bundle_expand=self.bundle_expand,
        )

    # ---------------- derived host info ----------------
    @property
    def num_used_features(self) -> int:
        return len(self.used_features)

    @property
    def num_total_features(self) -> int:
        return len(self.mappers)

    def used_mappers(self) -> List[BinMapper]:
        return [self.mappers[f] for f in self.used_features]

    def num_rows_padded(self) -> int:
        b = self.row_block
        n = ((self.num_data + b - 1) // b) * b
        return max(n, getattr(self, "_min_padded_rows", 0))

    def ensure_min_padded_rows(self, target: int) -> None:
        """Pad to at least `target` rows (a row_block multiple): the
        ranks of a data-parallel run pad to the cluster-wide maximum, so
        every rank's per-row arrays have one shape (the JAX package's
        ensure_min_padded_rows, dataset.py:644)."""
        if target % self.row_block != 0:
            raise ValueError((target, self.row_block))
        if target > self.num_rows_padded():
            self._min_padded_rows = int(target)
            self._device = None

    # ---------------- device arrays ----------------
    def device_arrays(self, device="cpu") -> Dict[str, Any]:
        """Push the bin matrix + per-feature info to `device` (cached per
        device).

        Returns dict with:
          bins      (F, Np) int32 — feature-major bin matrix, rows padded
                    with bin 0 to a row_block multiple
          valid     (Np,)  float32  — 1.0 for real rows, 0.0 for padding
          nan_bin   (F,)   int32    — NaN bin index per feature, -1 if none
          num_bins  (F,)   int32    — per-feature bin count
          mono      (F,)   int32    — monotone constraint per feature
          is_cat    (F,)   bool     — categorical flag
          bundle    BundleInfo or None (EFB)
        """
        import torch

        device = torch.device(device)
        if self._device is not None and self._device["bins"].device == device:
            return self._device
        bins_fm = np.zeros((self.bins.shape[0], self.num_rows_padded()),
                           dtype=np.int32)  # bundle columns x padded rows
        bins_fm[:, : self.num_data] = self.bins
        self._device = self._device_dict(torch.from_numpy(bins_fm).to(device),
                                         device)
        return self._device

    def _device_dict(self, bins, device) -> Dict[str, Any]:
        """device_arrays' dict around an assembled (G, Np) int32 matrix."""
        import torch

        npad = self.num_rows_padded()
        f = self.num_used_features
        um = self.used_mappers()
        nan_bin = np.array([m.nan_bin for m in um], dtype=np.int32)
        num_bins = np.array([m.num_bin for m in um], dtype=np.int32)
        is_cat = np.array([m.bin_type == BinType.CATEGORICAL for m in um],
                          dtype=bool)
        mono = (
            self.monotone_constraints.astype(np.int32)
            if self.monotone_constraints is not None
            else np.zeros(f, dtype=np.int32)
        )
        valid = np.zeros(npad, dtype=np.float32)
        valid[: self.num_data] = 1.0
        t = lambda a: torch.from_numpy(a).to(device)
        return {
            "bins": bins,
            "valid": t(valid),
            "nan_bin": t(nan_bin),
            "num_bins": t(num_bins),
            "mono": t(mono),
            "is_cat": t(is_cat),
            "bundle": self._bundle_info(device),
        }

    def _bundle_info(self, device):
        """Device BundleInfo for the grower, or None without EFB."""
        if self.bundle_layout is None:
            return None
        import torch

        from .learner.bundle import BundleInfo

        lay = self.bundle_layout
        um = self.used_mappers()
        width = np.array(
            [m.num_bin - (1 if lay.mfb[i] >= 0 else 0) for i, m in enumerate(um)],
            dtype=np.int32,
        )
        t = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)
        return BundleInfo(
            bundle_of=t(lay.bundle_of),
            off_lo=t(lay.off_lo),
            mfb=t(lay.mfb),
            expand_idx=t(self.bundle_expand),
            width=t(width),
        )

    @property
    def col_bins(self) -> int:
        """Uniform device bin-axis size of the stored columns."""
        if self.bundle_layout is not None:
            return max(self.bundle_layout.col_bins, self.max_num_bin)
        return self.max_num_bin

    def padded(self, arr: Optional[np.ndarray], fill: float = 0.0, dtype=np.float32) -> np.ndarray:
        """Pad a per-row array to num_rows_padded."""
        npad = self.num_rows_padded()
        out = np.full(npad, fill, dtype=dtype)
        if arr is not None:
            out[: self.num_data] = arr
        return out

    def feature_infos(self) -> List[str]:
        return [m.feature_info_str() for m in self.mappers]
