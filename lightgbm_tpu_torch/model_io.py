"""LightGBM text model format: writer and parser.

A copy of the text save and load of lightgbm_tpu/model_io.py
(save_model_string, load_model_string), byte-compatible with the
reference format (src/boosting/gbdt_model_text.cpp SaveModelToString
:314 / LoadModelFromString :424, per-tree blocks src/io/tree.cpp
Tree::ToString :343). Models written by either package load in the
other. The JSON dump (dump_model_dict, Booster.dump_model) and its
loader (load_model_dict) are copies of the JAX package's too, and so is
the C++ code generator of task=convert_model (model_to_if_else).
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .tree import Tree

MODEL_VERSION = "v4"


def _fmt_d(values) -> str:
    return " ".join(str(int(v)) for v in values)


def _fmt_f(values, precision: int = 6) -> str:
    return " ".join(f"{float(v):g}" for v in values)


def _fmt_hp(values) -> str:
    """High-precision doubles (ArrayToString<true>)."""
    return " ".join(repr(float(v)) for v in values)


def _objective_to_string(cfg: Config) -> str:
    o = cfg.objective
    if o == "binary":
        return f"binary sigmoid:{cfg.sigmoid:g}"
    if o == "multiclass":
        return f"multiclass num_class:{cfg.num_class}"
    if o == "multiclassova":
        return f"multiclassova num_class:{cfg.num_class} sigmoid:{cfg.sigmoid:g}"
    if o == "lambdarank":
        return "lambdarank"
    if o == "quantile":
        return f"quantile alpha:{cfg.alpha:g}"
    if o == "huber":
        return f"huber alpha:{cfg.alpha:g}"
    if o == "fair":
        return f"fair c:{cfg.fair_c:g}"
    if o == "tweedie":
        return f"tweedie tweedie_variance_power:{cfg.tweedie_variance_power:g}"
    return o


def tree_to_string(t: Tree) -> str:
    n = t.num_leaves
    buf = io.StringIO()
    buf.write(f"num_leaves={n}\n")
    buf.write(f"num_cat={t.num_cat}\n")
    buf.write("split_feature=" + _fmt_d(t.split_feature) + "\n")
    buf.write("split_gain=" + _fmt_f(t.split_gain) + "\n")
    buf.write("threshold=" + _fmt_hp(t.threshold) + "\n")
    buf.write("decision_type=" + _fmt_d(t.decision_type) + "\n")
    buf.write("left_child=" + _fmt_d(t.left_child) + "\n")
    buf.write("right_child=" + _fmt_d(t.right_child) + "\n")
    buf.write("leaf_value=" + _fmt_hp(t.leaf_value) + "\n")
    buf.write("leaf_weight=" + _fmt_hp(t.leaf_weight) + "\n")
    buf.write("leaf_count=" + _fmt_d(t.leaf_count) + "\n")
    buf.write("internal_value=" + _fmt_f(t.internal_value) + "\n")
    buf.write("internal_weight=" + _fmt_f(t.internal_weight) + "\n")
    buf.write("internal_count=" + _fmt_d(t.internal_count) + "\n")
    if t.num_cat > 0:
        buf.write("cat_boundaries=" + _fmt_d(t.cat_boundaries) + "\n")
        buf.write("cat_threshold=" + _fmt_d(t.cat_threshold) + "\n")
    buf.write(f"is_linear={1 if t.is_linear else 0}\n")
    if t.is_linear:
        # linear-leaf blocks (tree.cpp:381-405 Tree::ToString is_linear)
        buf.write("leaf_const=" + _fmt_hp(t.leaf_const) + "\n")
        nfeat = [len(f) for f in t.leaf_features]
        buf.write("num_features=" + " ".join(str(x) for x in nfeat) + "\n")
        buf.write(
            "leaf_features="
            + " ".join(
                " ".join(str(f) for f in feats) for feats in t.leaf_features if feats
            )
            + "\n"
        )
        buf.write(
            "leaf_coeff="
            + " ".join(
                " ".join(repr(float(c)) for c in cs) for cs in t.leaf_coeff if cs
            )
            + "\n"
        )
    buf.write(f"shrinkage={t.shrinkage:g}\n")
    buf.write("\n")
    return buf.getvalue()


def save_model_string(
    gbdt, cfg: Config, num_iteration: int = -1, start_iteration: int = 0
) -> str:
    ds = gbdt.train_set
    feature_names = ds.feature_names if ds is not None else getattr(gbdt, "feature_names", [])
    feature_infos = ds.feature_infos() if ds is not None else getattr(gbdt, "feature_infos_", ["none"] * len(feature_names))
    K = gbdt.num_class

    buf = io.StringIO()
    buf.write("tree\n")
    buf.write(f"version={MODEL_VERSION}\n")
    buf.write(f"num_class={cfg.num_class}\n")
    buf.write(f"num_tree_per_iteration={K}\n")
    buf.write("label_index=0\n")
    buf.write(f"max_feature_idx={len(feature_names) - 1}\n")
    buf.write(f"objective={_objective_to_string(cfg)}\n")
    buf.write("feature_names=" + " ".join(feature_names) + "\n")
    mc = list(cfg.monotone_constraints)
    if mc:
        buf.write("monotone_constraints=" + " ".join(str(int(v)) for v in mc) + "\n")
    buf.write("feature_infos=" + " ".join(feature_infos) + "\n")
    if gbdt.average_output:
        buf.write("average_output\n")

    total_iteration = len(gbdt.models) // K
    start_iteration = max(0, min(start_iteration, total_iteration))
    num_used = len(gbdt.models)
    if num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * K, num_used)
    start_model = start_iteration * K

    tree_strs = []
    for i in range(start_model, num_used):
        tree_strs.append(f"Tree={i - start_model}\n" + tree_to_string(gbdt.models[i]) + "\n")
    buf.write("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs) + "\n")
    buf.write("\n")
    for s in tree_strs:
        buf.write(s)
    buf.write("end of trees\n")

    # feature importances (split counts) over exactly the dumped tree
    # range, sorted desc (gbdt_model_text.cpp:380 FeatureImportance
    # takes num_iteration). Summing over ALL models would let a sliced
    # save (snapshot / training checkpoint) leak later trees into the
    # footer — a checkpointed model must bit-match a run that stopped
    # at that round (docs/RESILIENCE.md).
    imp = np.zeros(len(feature_names))
    for t in gbdt.models[start_model:num_used]:
        imp += t.feature_importance_split(len(feature_names))
    pairs = [(int(imp[i]), feature_names[i]) for i in range(len(feature_names)) if imp[i] > 0]
    pairs.sort(key=lambda p: -p[0])
    buf.write("\nfeature_importances:\n")
    for v, name in pairs:
        buf.write(f"{name}={v}\n")

    buf.write("\nparameters:\n")
    for k, v in cfg.explicit_params().items():
        buf.write(f"[{k}: {v}]\n")
    buf.write("end of parameters\n")
    buf.write("\npandas_categorical:null\n")
    return buf.getvalue()


def _parse_array(s: str, typ) -> np.ndarray:
    s = s.strip()
    if not s:
        return np.asarray([], dtype=typ)
    return np.asarray([typ(x) for x in s.split(" ")], dtype=typ)


def parse_tree_block(lines: Dict[str, str]) -> Tree:
    n = int(lines["num_leaves"])
    t = Tree(num_leaves=n)
    t.num_cat = int(lines.get("num_cat", "0"))
    t.split_feature = _parse_array(lines.get("split_feature", ""), np.int32)
    t.split_gain = _parse_array(lines.get("split_gain", ""), np.float64)
    t.threshold = _parse_array(lines.get("threshold", ""), np.float64)
    t.decision_type = _parse_array(lines.get("decision_type", ""), np.int32)
    t.left_child = _parse_array(lines.get("left_child", ""), np.int32)
    t.right_child = _parse_array(lines.get("right_child", ""), np.int32)
    t.leaf_value = _parse_array(lines.get("leaf_value", "0"), np.float64)
    if len(t.leaf_value) == 0:
        t.leaf_value = np.zeros(n, np.float64)
    t.leaf_weight = _parse_array(lines.get("leaf_weight", ""), np.float64)
    t.leaf_count = _parse_array(lines.get("leaf_count", ""), np.int64)
    t.internal_value = _parse_array(lines.get("internal_value", ""), np.float64)
    t.internal_weight = _parse_array(lines.get("internal_weight", ""), np.float64)
    t.internal_count = _parse_array(lines.get("internal_count", ""), np.int64)
    if t.num_cat > 0:
        t.cat_boundaries = _parse_array(lines["cat_boundaries"], np.int64)
        t.cat_threshold = _parse_array(lines["cat_threshold"], np.uint32).astype(np.uint32)
    t.is_linear = lines.get("is_linear", "0").strip() == "1"
    if t.is_linear:
        t.leaf_const = _parse_array(lines.get("leaf_const", ""), np.float64)
        if len(t.leaf_const) < n:
            t.leaf_const = np.concatenate(
                [t.leaf_const, np.zeros(n - len(t.leaf_const))]
            )
        nfeat = _parse_array(lines.get("num_features", ""), np.int64)
        flat_f = _parse_array(lines.get("leaf_features", ""), np.int64)
        flat_c = _parse_array(lines.get("leaf_coeff", ""), np.float64)
        t.leaf_features, t.leaf_coeff = [], []
        pos = 0
        for li in range(n):
            k = int(nfeat[li]) if li < len(nfeat) else 0
            t.leaf_features.append([int(x) for x in flat_f[pos : pos + k]])
            t.leaf_coeff.append([float(x) for x in flat_c[pos : pos + k]])
            pos += k
    t.shrinkage = float(lines.get("shrinkage", "1"))
    return t


def _parse_objective(s: str) -> Dict[str, Any]:
    parts = s.strip().split(" ")
    out: Dict[str, Any] = {"objective": parts[0]}
    for p in parts[1:]:
        if ":" in p:
            k, v = p.split(":", 1)
            out[k] = v
    return out


def load_model_string(model_str: str):
    """Parse a text model (reference LoadModelFromString) into a
    prediction-capable GBDT."""
    lines = model_str.split("\n")
    header: Dict[str, str] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            break
        if line == "average_output":
            header["average_output"] = "1"
        elif "=" in line:
            k, v = line.split("=", 1)
            header[k.strip()] = v
        i += 1

    params: Dict[str, Any] = {}
    if "objective" in header:
        obj = _parse_objective(header["objective"])
        params["objective"] = obj["objective"]
        if "num_class" in obj:
            params["num_class"] = int(obj["num_class"])
        if "sigmoid" in obj:
            params["sigmoid"] = float(obj["sigmoid"])
        if "alpha" in obj:
            params["alpha"] = float(obj["alpha"])
        if "c" in obj:
            params["fair_c"] = float(obj["c"])
        if "tweedie_variance_power" in obj:
            params["tweedie_variance_power"] = float(obj["tweedie_variance_power"])
    from .boosting import GBDT

    cfg = Config(params)
    gbdt = GBDT(cfg, None)
    gbdt.num_class = int(header.get("num_tree_per_iteration", "1"))
    gbdt.average_output = header.get("average_output") == "1"
    gbdt.feature_names = header.get("feature_names", "").split(" ") if header.get("feature_names") else []
    gbdt.feature_infos_ = header.get("feature_infos", "").split(" ") if header.get("feature_infos") else []

    # tree blocks
    trees: List[Tree] = []
    cur: Optional[Dict[str, str]] = None
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            if cur is not None:
                trees.append(parse_tree_block(cur))
            cur = {}
        elif line == "end of trees":
            if cur is not None:
                trees.append(parse_tree_block(cur))
                cur = None
            break
        elif "=" in line and cur is not None:
            k, v = line.split("=", 1)
            cur[k] = v
        i += 1
    if cur is not None:
        trees.append(parse_tree_block(cur))
    gbdt.models = trees
    return cfg, gbdt


# ----------------------------------------------------------------------
def _node_to_dict(t: Tree, index: int) -> Dict[str, Any]:
    """Nested node dict (src/io/tree.cpp:462 NodeToJSON)."""
    if index >= 0:
        dt = int(t.decision_type[index])
        d: Dict[str, Any] = {
            "split_index": index,
            "split_feature": int(t.split_feature[index]),
            "split_gain": float(t.split_gain[index]),
        }
        if dt & 1:  # categorical
            ci = int(t.threshold[index])
            lo, hi = int(t.cat_boundaries[ci]), int(t.cat_boundaries[ci + 1])
            words = t.cat_threshold[lo:hi]
            cats = [
                32 * w + b
                for w in range(len(words))
                for b in range(32)
                if (int(words[w]) >> b) & 1
            ]
            d["threshold"] = "||".join(str(cv) for cv in cats)
            d["decision_type"] = "=="
        else:
            d["threshold"] = float(t.threshold[index])
            d["decision_type"] = "<="
        d["default_left"] = bool(dt & 2)
        d["missing_type"] = ("None", "Zero", "NaN")[min((dt >> 2) & 3, 2)]
        d["internal_value"] = float(t.internal_value[index]) if index < len(t.internal_value) else 0.0
        d["internal_weight"] = float(t.internal_weight[index]) if index < len(t.internal_weight) else 0.0
        d["internal_count"] = int(t.internal_count[index]) if index < len(t.internal_count) else 0
        d["left_child"] = _node_to_dict(t, int(t.left_child[index]))
        d["right_child"] = _node_to_dict(t, int(t.right_child[index]))
        return d
    leaf = ~index
    d = {
        "leaf_index": leaf,
        "leaf_value": float(t.leaf_value[leaf]),
        "leaf_weight": float(t.leaf_weight[leaf]) if leaf < len(t.leaf_weight) else 0.0,
        "leaf_count": int(t.leaf_count[leaf]) if leaf < len(t.leaf_count) else 0,
    }
    if t.is_linear:
        # linear-leaf model terms (extension: the reference ToJSON emits
        # none, so its dumps cannot round-trip linear trees; ours can —
        # keys only appear on linear models, non-linear dumps unchanged)
        d["leaf_const"] = (
            float(t.leaf_const[leaf]) if leaf < len(t.leaf_const) else 0.0
        )
        d["leaf_features"] = (
            [int(f) for f in t.leaf_features[leaf]]
            if leaf < len(t.leaf_features) else []
        )
        d["leaf_coeff"] = (
            [float(c) for c in t.leaf_coeff[leaf]]
            if leaf < len(t.leaf_coeff) else []
        )
    return d


def tree_to_dict(t: Tree, tree_index: int) -> Dict[str, Any]:
    """(src/io/tree.cpp:415 ToJSON)"""
    d: Dict[str, Any] = {
        "tree_index": tree_index,
        "num_leaves": t.num_leaves,
        "num_cat": t.num_cat,
        "shrinkage": t.shrinkage,
    }
    if t.is_linear:
        d["is_linear"] = True
    if t.num_leaves == 1:
        d["tree_structure"] = {
            "leaf_value": float(t.leaf_value[0]),
            "leaf_count": int(t.leaf_count[0]) if len(t.leaf_count) else 0,
        }
        if t.is_linear and len(t.leaf_const):
            d["tree_structure"]["leaf_const"] = float(t.leaf_const[0])
            d["tree_structure"]["leaf_features"] = []
            d["tree_structure"]["leaf_coeff"] = []
    else:
        d["tree_structure"] = _node_to_dict(t, 0)
    return d


def dump_model_dict(
    gbdt, cfg: Config, num_iteration: int = -1, start_iteration: int = 0,
    importance_type: str = "split",
) -> Dict[str, Any]:
    """JSON model dump (gbdt_model_text.cpp:24 DumpModel), as returned by
    Booster.dump_model()."""
    ds = gbdt.train_set
    feature_names = ds.feature_names if ds is not None else getattr(gbdt, "feature_names", [])
    feature_infos = ds.feature_infos() if ds is not None else getattr(
        gbdt, "feature_infos_", ["none"] * len(feature_names))
    K = gbdt.num_class

    total_iteration = len(gbdt.models) // K
    start_iteration = max(0, min(start_iteration, total_iteration))
    num_used = len(gbdt.models)
    if num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * K, num_used)
    start_model = start_iteration * K

    infos = []
    for s in feature_infos:
        if s.startswith("["):
            lo, hi = s[1:-1].split(":")
            infos.append({"min_value": float(lo), "max_value": float(hi), "values": []})
        elif s and s != "none":
            infos.append({
                "min_value": 0, "max_value": 0,
                "values": [int(v) for v in s.split(":")],
            })
        else:
            infos.append({"min_value": 0, "max_value": 0, "values": []})

    # importances over exactly the dumped tree range
    imp = np.zeros(len(feature_names))
    for i in range(start_model, num_used):
        t = gbdt.models[i]
        if importance_type == "gain":
            imp += t.feature_importance_gain(len(feature_names))
        else:
            imp += t.feature_importance_split(len(feature_names))
    cast = float if importance_type == "gain" else int
    pairs = [(cast(imp[i]), feature_names[i]) for i in range(len(feature_names)) if imp[i] > 0]
    pairs.sort(key=lambda p: -p[0])

    return {
        "name": "tree",
        "version": MODEL_VERSION,
        "num_class": cfg.num_class,
        "num_tree_per_iteration": K,
        "label_index": 0,
        "max_feature_idx": len(feature_names) - 1,
        "objective": _objective_to_string(cfg),
        "average_output": bool(gbdt.average_output),
        "feature_names": list(feature_names),
        "monotone_constraints": list(cfg.monotone_constraints),
        "feature_infos": dict(zip(feature_names, infos)),
        "tree_info": [
            tree_to_dict(gbdt.models[i], i - start_model)
            for i in range(start_model, num_used)
        ],
        "feature_importances": {name: v for v, name in pairs},
        "pandas_categorical": None,
    }


    if cur is not None:
        trees.append(parse_tree_block(cur))
    gbdt.models = trees
    return cfg, gbdt


# ---------------------------------------------------------------------------
# JSON model loading: the inverse of dump_model_dict, so a Booster
# round-trips through its dump_model() JSON (the registry's second
# interop surface next to the text format; the reference only WRITES
# JSON — DumpModel has no C++ loader — so this is a deliberate
# extension for the serving registry).

_MISSING_TYPE_BITS = {"None": 0, "Zero": 1, "NaN": 2}


def tree_from_dict(d: Dict[str, Any]) -> Tree:
    """Nested tree_structure dict (tree_to_dict output) -> Tree."""
    n = int(d["num_leaves"])
    t = Tree(num_leaves=n, shrinkage=float(d.get("shrinkage", 1.0)))
    t.is_linear = bool(d.get("is_linear", False))
    root = d.get("tree_structure", {})
    if t.is_linear:
        t.leaf_const = np.zeros(n, np.float64)
        t.leaf_features = [[] for _ in range(n)]
        t.leaf_coeff = [[] for _ in range(n)]
    if n <= 1:
        t.leaf_value = np.asarray([float(root.get("leaf_value", 0.0))])
        t.leaf_count = np.asarray([int(root.get("leaf_count", 0))], np.int64)
        t.leaf_weight = np.zeros(1, np.float64)
        if t.is_linear:
            t.leaf_const[0] = float(
                root.get("leaf_const", root.get("leaf_value", 0.0))
            )
        return t
    m = n - 1
    t.split_feature = np.zeros(m, np.int32)
    t.split_gain = np.zeros(m, np.float64)
    t.threshold = np.zeros(m, np.float64)
    t.decision_type = np.zeros(m, np.int32)
    t.left_child = np.zeros(m, np.int32)
    t.right_child = np.zeros(m, np.int32)
    t.internal_value = np.zeros(m, np.float64)
    t.internal_weight = np.zeros(m, np.float64)
    t.internal_count = np.zeros(m, np.int64)
    t.leaf_value = np.zeros(n, np.float64)
    t.leaf_weight = np.zeros(n, np.float64)
    t.leaf_count = np.zeros(n, np.int64)
    cat_boundaries = [0]
    cat_threshold: List[int] = []
    n_cat = 0

    def child_ix(node: Dict[str, Any]) -> int:
        if "split_index" in node:
            return int(node["split_index"])
        return ~int(node.get("leaf_index", 0))

    stack = [root]
    while stack:
        node = stack.pop()
        if "split_index" not in node:  # leaf
            li = int(node.get("leaf_index", 0))
            t.leaf_value[li] = float(node.get("leaf_value", 0.0))
            t.leaf_weight[li] = float(node.get("leaf_weight", 0.0))
            t.leaf_count[li] = int(node.get("leaf_count", 0))
            if t.is_linear:
                t.leaf_const[li] = float(
                    node.get("leaf_const", node.get("leaf_value", 0.0))
                )
                t.leaf_features[li] = [
                    int(f) for f in node.get("leaf_features", [])
                ]
                t.leaf_coeff[li] = [
                    float(c) for c in node.get("leaf_coeff", [])
                ]
            continue
        i = int(node["split_index"])
        t.split_feature[i] = int(node["split_feature"])
        t.split_gain[i] = float(node.get("split_gain", 0.0))
        dt = 0
        if node.get("decision_type") == "==":  # categorical bitset
            dt |= 1
            cats = [int(c) for c in str(node["threshold"]).split("||") if c]
            n_words = (max(cats) // 32 + 1) if cats else 1
            words = [0] * n_words
            for cv in cats:
                words[cv // 32] |= 1 << (cv % 32)
            t.threshold[i] = float(n_cat)
            cat_threshold.extend(words)
            cat_boundaries.append(len(cat_threshold))
            n_cat += 1
        else:
            t.threshold[i] = float(node["threshold"])
        if node.get("default_left"):
            dt |= 2
        dt |= _MISSING_TYPE_BITS.get(str(node.get("missing_type")), 0) << 2
        t.decision_type[i] = dt
        t.internal_value[i] = float(node.get("internal_value", 0.0))
        t.internal_weight[i] = float(node.get("internal_weight", 0.0))
        t.internal_count[i] = int(node.get("internal_count", 0))
        left, right = node["left_child"], node["right_child"]
        t.left_child[i] = child_ix(left)
        t.right_child[i] = child_ix(right)
        stack.append(right)
        stack.append(left)
    t.num_cat = n_cat
    t.cat_boundaries = np.asarray(cat_boundaries, np.int64)
    t.cat_threshold = np.asarray(cat_threshold, np.uint32)
    return t


def load_model_dict(d: Dict[str, Any]):
    """dump_model_dict output -> prediction-capable (Config, GBDT)."""
    params: Dict[str, Any] = {}
    obj = _parse_objective(str(d.get("objective", "regression")))
    params["objective"] = obj["objective"]
    for src, dst, typ in (("num_class", "num_class", int),
                          ("sigmoid", "sigmoid", float),
                          ("alpha", "alpha", float),
                          ("c", "fair_c", float),
                          ("tweedie_variance_power",
                           "tweedie_variance_power", float)):
        if src in obj:
            params[dst] = typ(obj[src])
    from .boosting import GBDT

    cfg = Config(params)
    gbdt = GBDT(cfg, None)
    gbdt.num_class = int(d.get("num_tree_per_iteration", 1))
    gbdt.average_output = bool(d.get("average_output", False))
    gbdt.feature_names = list(d.get("feature_names", []))
    infos = []
    for name in gbdt.feature_names:
        fi = (d.get("feature_infos") or {}).get(name)
        if not fi:
            infos.append("none")
        elif fi.get("values"):
            infos.append(":".join(str(int(v)) for v in fi["values"]))
        elif fi.get("min_value") or fi.get("max_value"):
            infos.append(f"[{fi['min_value']:g}:{fi['max_value']:g}]")
        else:
            infos.append("none")
    gbdt.feature_infos_ = infos
    gbdt.models = [tree_from_dict(td) for td in d.get("tree_info", [])]
    return cfg, gbdt



# ---------------------------------------------------------------------------
# convert_model: if-else C++ export (reference GBDT::SaveModelToIfElse,
# src/boosting/gbdt_model_text.cpp:289 + Tree::ToIfElse, src/io/tree.cpp:566).
# Deviation (deliberate): the reference emits member-function snippets
# that only compile inside its own build tree; this emits a SELF-CONTAINED
# translation unit with the same PredictTree{i} functions plus an
# `extern "C" Predict` entry, so the artifact is usable standalone. The
# ByMap variants are not emitted.

def _node_if_else(t: Tree, node: int, indent: str) -> str:
    from .tree import _CAT_MASK, _DEFAULT_LEFT_MASK

    if node < 0:  # leaf
        return f"{indent}return {float(t.leaf_value[~node])!r};\n"
    dt = int(t.decision_type[node])
    f = int(t.split_feature[node])
    out = [f"{indent}fval = arr[{f}];\n"]
    if dt & _CAT_MASK:
        ci = int(t.threshold[node])
        lo = int(t.cat_boundaries[ci])
        hi = int(t.cat_boundaries[ci + 1])
        out.append(
            f"{indent}ifv = std::isnan(fval) ? -1 : (int)fval;\n"
            f"{indent}if (ifv >= 0 && ifv < {32 * (hi - lo)} && "
            f"((cat_threshold[{lo} + ifv / 32] >> (ifv & 31)) & 1)) {{\n"
        )
    else:
        mt = (dt >> 2) & 3
        dl = bool(dt & _DEFAULT_LEFT_MASK)
        thr = repr(float(t.threshold[node]))
        if mt != 2:  # missing != NaN: NaN behaves as 0.0 (tree.h Decision)
            out.append(f"{indent}if (std::isnan(fval)) fval = 0.0;\n")
        if mt == 2:
            cond = (f"std::isnan(fval) || fval <= {thr}" if dl
                    else f"!std::isnan(fval) && fval <= {thr}")
        elif mt == 1:
            z = "std::fabs(fval) <= 1e-35"
            cond = (f"({z}) || fval <= {thr}" if dl
                    else f"!({z}) && fval <= {thr}")
        else:
            cond = f"fval <= {thr}"
        out.append(f"{indent}if ({cond}) {{\n")
    out.append(_node_if_else(t, int(t.left_child[node]), indent + "  "))
    out.append(f"{indent}}} else {{\n")
    out.append(_node_if_else(t, int(t.right_child[node]), indent + "  "))
    out.append(f"{indent}}}\n")
    return "".join(out)


def model_to_if_else(models: List[Tree], num_class: int,
                     average_output: bool = False) -> str:
    """The full if-else translation unit for a trained model."""
    import sys

    if any(t.is_linear for t in models):
        from . import log

        log.fatal(
            "convert_model does not support linear trees (leaf_coeff "
            "terms have no if-else form in the reference either)"
        )
    # chain-shaped trees recurse once per level; bound is num_leaves.
    # Raise the interpreter limit only for the duration of the walk —
    # it is process-global state and must not outlive this call.
    max_leaves = max((t.num_leaves for t in models), default=1)
    old_limit = sys.getrecursionlimit()
    parts = [
        "// generated by lightgbm_tpu convert_model "
        "(reference: GBDT::SaveModelToIfElse)\n",
        "#include <cmath>\n#include <cstring>\n\n",
    ]
    try:
        sys.setrecursionlimit(max(old_limit, 4 * max_leaves + 1000))
        for i, t in enumerate(models):
            parts.append(f"double PredictTree{i}(const double* arr) {{\n")
            if t.num_leaves <= 1:
                parts.append(f"  return {float(t.leaf_value[0])!r};\n}}\n\n")
                continue
            if len(t.cat_threshold):
                words = ",".join(str(int(w)) for w in t.cat_threshold)
                parts.append(
                    f"  static const unsigned int cat_threshold[] = "
                    f"{{{words}}};\n"
                )
            parts.append("  double fval = 0.0; (void)fval;\n")
            if len(t.cat_threshold):
                parts.append("  int ifv = 0; (void)ifv;\n")
            parts.append(_node_if_else(t, 0, "  "))
            parts.append("}\n\n")
    finally:
        sys.setrecursionlimit(old_limit)

    n = len(models)
    ptrs = ", ".join(f"PredictTree{i}" for i in range(n))
    parts.append(
        f"double (*PredictTreePtr[])(const double*) = {{ {ptrs} }};\n\n"
        f"static const int num_tree_per_iteration_ = {num_class};\n"
        f"static const int num_iteration_for_pred_ = {n // max(num_class, 1)};\n\n"
        "extern \"C\" void Predict(const double* features, double* output) {\n"
        "  std::memset(output, 0, sizeof(double) * num_tree_per_iteration_);\n"
        "  for (int i = 0; i < num_iteration_for_pred_; ++i)\n"
        "    for (int k = 0; k < num_tree_per_iteration_; ++k)\n"
        "      output[k] += (*PredictTreePtr[i * num_tree_per_iteration_ + k])(features);\n"
    )
    if average_output:  # boosting=rf reports the MEAN of the trees
        parts.append(
            "  for (int k = 0; k < num_tree_per_iteration_; ++k)\n"
            "    output[k] /= num_iteration_for_pred_;\n"
        )
    parts.append("}\n")
    return "".join(parts)
