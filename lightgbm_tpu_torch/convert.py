"""Carry the JAX package's state into the port, as plain numpy.

A GBDT's "weights" are its binned dataset and its trees. These functions
take what lightgbm_tpu holds, handed over as numpy arrays, model text or
the JSON model dict (the port imports nothing of lightgbm_tpu), and
build the port's objects, so a test can feed both growers the same
binned data and check that the port predicts what a JAX-trained model
predicts.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .binning import BinMapper, BinType, MissingType
from .bundling import BundleLayout
from .dataset import BinnedDataset, Metadata
from .learner.grower import TreeArrays


def _mapper(d: Mapping[str, Any]) -> BinMapper:
    m = BinMapper(
        upper_bounds=np.asarray(d["upper_bounds"], np.float64),
        bin_type=BinType(d["bin_type"]),
        missing_type=MissingType(d["missing_type"]),
        categories=tuple(d.get("categories", ())),
        num_bin=int(d["num_bin"]),
        is_trivial=bool(d["is_trivial"]),
        min_value=float(d["min_value"]),
        max_value=float(d["max_value"]),
    )
    m.most_freq_bin = int(d["most_freq_bin"])
    m.default_bin = int(d["default_bin"])
    return m


def binned_dataset_from_numpy(state: Mapping[str, Any]) -> BinnedDataset:
    """The port's BinnedDataset from the JAX package's binned state:

    - `bins` (G, num_data) host bin matrix (bundle columns under EFB),
      `used_features`, `num_data`, `max_num_bin`, `row_block`,
      `feature_names`;
    - `mappers`: one dict per original feature with the BinMapper fields
      (upper_bounds, bin_type, missing_type, categories, num_bin,
      is_trivial, min_value, max_value, most_freq_bin, default_bin);
    - optional `label`, `weight`, `init_score`, `monotone_constraints`;
    - optional EFB layout: `bundle_layout` dict of the BundleLayout
      fields and `bundle_expand` (F, max_num_bin) int32."""
    layout = None
    if state.get("bundle_layout") is not None:
        lay = dict(state["bundle_layout"])
        layout = BundleLayout(**{
            k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in lay.items()
        })
    meta = Metadata(
        label=None if state.get("label") is None
        else np.asarray(state["label"], np.float32),
        weight=None if state.get("weight") is None
        else np.asarray(state["weight"], np.float32),
        init_score=None if state.get("init_score") is None
        else np.asarray(state["init_score"], np.float64),
    )
    mono = state.get("monotone_constraints")
    return BinnedDataset(
        bins=np.asarray(state["bins"]),
        mappers=[_mapper(d) for d in state["mappers"]],
        used_features=np.asarray(state["used_features"], np.int64),
        num_data=int(state["num_data"]),
        metadata=meta,
        feature_names=list(state["feature_names"]),
        max_num_bin=int(state["max_num_bin"]),
        row_block=int(state["row_block"]),
        monotone_constraints=None if mono is None
        else np.asarray(mono, np.int8),
        bundle_layout=layout,
        bundle_expand=None if state.get("bundle_expand") is None
        else np.asarray(state["bundle_expand"], np.int32),
    )


def tree_arrays_from_numpy(d: Mapping[str, Any],
                           device="cpu") -> TreeArrays:
    """The port's TreeArrays from a dict of numpy arrays keyed by the
    TreeArrays field names (the JAX package's TreeArrays._asdict())."""
    dtypes = {
        "num_nodes": torch.int32, "node_feature": torch.int32,
        "node_bin": torch.int32, "node_gain": torch.float32,
        "node_default_left": torch.bool, "node_cat": torch.bool,
        "node_cat_mask": torch.bool, "node_left": torch.int32,
        "node_right": torch.int32, "node_value": torch.float32,
        "node_weight": torch.float32, "node_count": torch.float32,
        "leaf_value": torch.float32, "leaf_weight": torch.float32,
        "leaf_count": torch.float32, "leaf_depth": torch.int32,
    }
    return TreeArrays(**{
        k: torch.as_tensor(np.array(d[k]), dtype=dt, device=device)
        for k, dt in dtypes.items()
    })


def booster_from_model_string(s: str):
    """A prediction-capable Booster from a model text the JAX package
    wrote (Booster.model_to_string / save_model)."""
    from .basic import Booster

    return Booster(model_str=s)


def booster_from_model_dict(d: Mapping[str, Any]):
    """A prediction-capable Booster from the JSON model dict the JAX
    package dumps (Booster.dump_model), through the port's loader."""
    from .basic import Booster
    from .model_io import load_model_dict

    return Booster._from_loaded(*load_model_dict(dict(d)))
