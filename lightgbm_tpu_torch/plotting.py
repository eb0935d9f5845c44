"""Plotting: feature importance, split-value histograms, metric curves
and trees.

The port of lightgbm_tpu/plotting.py, the user surface of LightGBM's
``python-package/lightgbm/plotting.py`` (plot_importance:37,
plot_split_value_histogram:171, plot_metric:287, create_tree_digraph:616,
plot_tree:742) on the package's own model introspection
(``Booster.dump_model`` / ``feature_importance``); host-side, no card:

- ``plot_tree`` draws with matplotlib alone, no graphviz binary;
- ``create_tree_digraph`` emits DOT through the python ``graphviz``
  package when it imports, else returns a stand-in with the same
  ``.source`` / ``.save()``.

Each plot needs matplotlib and raises ImportError without it.
"""

from __future__ import annotations

import math
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = [
    "plot_importance",
    "plot_split_value_histogram",
    "plot_metric",
    "plot_tree",
    "create_tree_digraph",
]


# ----------------------------------------------------------------------
# helpers


def _plt():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("matplotlib is required for plotting") from e
    return plt


def _to_booster(obj: Any):
    """Accept Booster or fitted LGBMModel; return the Booster."""
    from .basic import Booster
    from .sklearn import LGBMModel

    if isinstance(obj, LGBMModel):
        return obj.booster_
    if isinstance(obj, Booster):
        return obj
    raise TypeError(f"booster must be Booster or LGBMModel, got {type(obj)}")


def _fmt(value: float, precision: Optional[int]) -> str:
    if precision is None:
        return str(value)
    if isinstance(value, float):
        return f"{value:.{precision}g}"
    return str(value)


def _check_pair(obj: Any, name: str) -> None:
    if obj is not None and (not isinstance(obj, tuple) or len(obj) != 2):
        raise TypeError(f"{name} must be a tuple of 2 elements or None")


def _new_axes(ax, figsize, dpi):
    if ax is not None:
        return ax
    plt = _plt()
    _check_pair(figsize, "figsize")
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


# ----------------------------------------------------------------------
# plot_importance


def plot_importance(
    booster: Any,
    ax=None,
    height: float = 0.2,
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = "Feature importance",
    xlabel: Optional[str] = "Feature importance",
    ylabel: Optional[str] = "Features",
    importance_type: str = "auto",
    max_num_features: Optional[int] = None,
    ignore_zero: bool = True,
    figsize: Optional[Tuple[float, float]] = None,
    dpi: Optional[int] = None,
    grid: bool = True,
    precision: Optional[int] = 3,
    **kwargs: Any,
):
    """Horizontal bar chart of per-feature importances
    (reference plotting.py:37). ``importance_type='auto'`` uses the
    estimator's ``importance_type`` for sklearn models and ``'split'``
    for raw Boosters."""
    from .sklearn import LGBMModel

    if importance_type == "auto":
        importance_type = (
            booster.importance_type if isinstance(booster, LGBMModel)
            else "split"
        )
    bst = _to_booster(booster)

    values = np.asarray(bst.feature_importance(importance_type))
    names = bst.feature_name()
    pairs = [
        (float(v), n) for v, n in zip(values, names)
        if not (ignore_zero and v == 0)
    ]
    if not pairs:
        raise ValueError("Booster's feature_importance is empty.")
    pairs.sort(key=lambda p: p[0])
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    vals = [p[0] for p in pairs]
    labels = [p[1] for p in pairs]

    ax = _new_axes(ax, figsize, dpi)
    ypos = np.arange(len(vals))
    ax.barh(ypos, vals, height=height, align="center", **kwargs)
    for y, v in zip(ypos, vals):
        ax.text(v + 1, y, _fmt(v, precision) if importance_type == "gain"
                else str(int(v)), va="center")
    ax.set_yticks(ypos)
    ax.set_yticklabels(labels)
    _check_pair(xlim, "xlim")
    ax.set_xlim(xlim if xlim is not None else (0, max(vals) * 1.1))
    _check_pair(ylim, "ylim")
    ax.set_ylim(ylim if ylim is not None else (-1, len(vals)))
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel.replace("@importance_type@", importance_type))
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


# ----------------------------------------------------------------------
# plot_split_value_histogram


def _iter_nodes(node: Dict[str, Any]):
    yield node
    for side in ("left_child", "right_child"):
        child = node.get(side)
        if isinstance(child, dict):
            yield from _iter_nodes(child)


def _split_values(bst, feature: Union[int, str]) -> List[float]:
    model = bst.dump_model()
    names = [f["name"] if isinstance(f, dict) else f
             for f in model.get("feature_names", [])]
    if isinstance(feature, str):
        try:
            fidx = names.index(feature)
        except ValueError:
            raise ValueError(f"unknown feature name {feature!r}")
    else:
        fidx = int(feature)
    out: List[float] = []
    for t in model["tree_info"]:
        root = t.get("tree_structure", {})
        for node in _iter_nodes(root):
            if (
                node.get("split_feature") == fidx
                and node.get("decision_type") == "<="
            ):
                out.append(float(node["threshold"]))
    return out


def plot_split_value_histogram(
    booster: Any,
    feature: Union[int, str],
    bins: Union[int, str, None] = None,
    ax=None,
    width_coef: float = 0.8,
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = "Split value histogram for feature with "
                           "@index/name@ @feature@",
    xlabel: Optional[str] = "Feature split value",
    ylabel: Optional[str] = "Count",
    figsize: Optional[Tuple[float, float]] = None,
    dpi: Optional[int] = None,
    grid: bool = True,
    **kwargs: Any,
):
    """Histogram of the numeric thresholds the model chose for one
    feature across all trees (reference plotting.py:171)."""
    bst = _to_booster(booster)
    values = _split_values(bst, feature)
    if not values:
        raise ValueError(
            f"Cannot plot split value histogram, "
            f"because feature {feature} was not used in splitting"
        )
    if bins is None:
        bins = min(len(set(values)), 100) or 1
    hist, edges = np.histogram(np.asarray(values), bins=bins)
    centers = (edges[:-1] + edges[1:]) / 2
    width = width_coef * (edges[1] - edges[0]) if len(edges) > 1 else 1.0

    ax = _new_axes(ax, figsize, dpi)
    ax.bar(centers, hist, width=width, align="center", **kwargs)
    _check_pair(xlim, "xlim")
    if xlim is not None:
        ax.set_xlim(xlim)
    _check_pair(ylim, "ylim")
    ax.set_ylim(ylim if ylim is not None else (0, max(hist) * 1.1))
    if title:
        title = title.replace(
            "@index/name@", "index" if isinstance(feature, int) else "name"
        ).replace("@feature@", str(feature))
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


# ----------------------------------------------------------------------
# plot_metric


def plot_metric(
    booster: Any,
    metric: Optional[str] = None,
    dataset_names: Optional[List[str]] = None,
    ax=None,
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = "Metric during training",
    xlabel: Optional[str] = "Iterations",
    ylabel: Optional[str] = "@metric@",
    figsize: Optional[Tuple[float, float]] = None,
    dpi: Optional[int] = None,
    grid: bool = True,
):
    """Plot one recorded eval metric over iterations, from a
    ``record_evaluation`` dict or a fitted sklearn estimator
    (reference plotting.py:287)."""
    from .basic import Booster
    from .sklearn import LGBMModel

    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif isinstance(booster, Booster):
        raise TypeError(
            "booster must be dict or LGBMModel; pass the dict filled by "
            "the record_evaluation() callback"
        )
    else:
        raise TypeError("booster must be dict or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")

    if dataset_names is None:
        use = list(eval_results.keys())
    else:
        use = [n for n in dataset_names if n in eval_results]
        if not use:
            raise ValueError("dataset_names has no matching recorded sets")

    first = eval_results[use[0]]
    if metric is None:
        if len(first) > 1:
            from .log import warning

            warning("More than one metric available, picking one to plot.")
        metric = next(iter(first))
    ax = _new_axes(ax, figsize, dpi)
    max_len = 0
    for name in use:
        if metric not in eval_results[name]:
            raise ValueError(f"metric {metric!r} not recorded for {name!r}")
        ys = eval_results[name][metric]
        max_len = max(max_len, len(ys))
        ax.plot(range(len(ys)), ys, label=name)
    ax.legend(loc="best")
    _check_pair(xlim, "xlim")
    ax.set_xlim(xlim if xlim is not None else (0, max_len))
    _check_pair(ylim, "ylim")
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


# ----------------------------------------------------------------------
# tree visualization


_SHOW_INFO = (
    "split_gain", "internal_value", "internal_count", "internal_weight",
    "leaf_count", "leaf_weight", "data_percentage",
)


def _node_label(
    node: Dict[str, Any],
    feature_names: List[str],
    show_info: List[str],
    precision: Optional[int],
    total_count: int,
    max_category_values: int,
) -> str:
    lines: List[str] = []
    if "split_feature" in node:
        f = node["split_feature"]
        name = (
            feature_names[f]
            if feature_names and f < len(feature_names)
            else f"Column_{f}"
        )
        if node.get("decision_type") == "==":
            cats = str(node["threshold"]).split("||")
            if len(cats) > max_category_values:
                cats = cats[:max_category_values] + ["..."]
            lines.append(f"{name} in {{{'|'.join(cats)}}}")
        else:
            lines.append(
                f"{name} <= {_fmt(float(node['threshold']), precision)}"
            )
        for key in ("split_gain", "internal_value", "internal_weight",
                    "internal_count"):
            if key in show_info and key in node:
                lines.append(f"{key.split('_')[-1]}: "
                             f"{_fmt(node[key], precision)}")
        if "data_percentage" in show_info and node.get("internal_count"):
            pct = 100.0 * node["internal_count"] / max(total_count, 1)
            lines.append(f"{_fmt(pct, precision)}% of data")
    else:
        lines.append(
            f"leaf {node.get('leaf_index', 0)}: "
            f"{_fmt(float(node.get('leaf_value', 0.0)), precision)}"
        )
        for key in ("leaf_weight", "leaf_count"):
            if key in show_info and key in node:
                lines.append(f"{key.split('_')[-1]}: "
                             f"{_fmt(node[key], precision)}")
        if "data_percentage" in show_info and node.get("leaf_count"):
            pct = 100.0 * node["leaf_count"] / max(total_count, 1)
            lines.append(f"{_fmt(pct, precision)}% of data")
    return "\n".join(lines)


def _decision_path(root: Dict[str, Any], row: np.ndarray) -> set:
    """ids(path) of nodes a single example visits (example_case)."""
    path = set()
    node = root
    while "split_feature" in node:
        path.add(id(node))
        fval = row[node["split_feature"]]
        missing = fval is None or (
            isinstance(fval, float) and math.isnan(fval)
        )
        if node.get("missing_type") == "Zero" and not missing:
            missing = fval == 0.0
        if node.get("decision_type") == "==":
            cats = str(node["threshold"]).split("||")
            left = (not missing) and str(int(fval)) in cats
        elif missing and node.get("missing_type") != "None":
            left = bool(node.get("default_left", True))
        else:
            v = 0.0 if missing else float(fval)
            left = v <= float(node["threshold"])
        node = node["left_child"] if left else node["right_child"]
    path.add(id(node))
    return path


class _DotStandin:
    """Minimal graphviz.Digraph lookalike (``.source`` / ``.save``) used
    when the python graphviz package is unavailable."""

    def __init__(self, name: str, graph_attr=None, **_kw):
        self._lines: List[str] = [f"digraph {name} {{"]
        for k, v in (graph_attr or {}).items():
            self._lines.append(f'\tgraph [{k}="{v}"]')

    def node(self, name: str, label: str = "", **attrs):
        a = "".join(
            f' {k}="{v}"' for k, v in attrs.items()
        )
        label = label.replace("\n", "\\n")
        self._lines.append(f'\t{name} [label="{label}"{a}]')

    def edge(self, a: str, b: str, label: str = "", **attrs):
        at = "".join(f' {k}="{v}"' for k, v in attrs.items())
        self._lines.append(f'\t{a} -> {b} [label="{label}"{at}]')

    @property
    def source(self) -> str:
        return "\n".join(self._lines + ["}"])

    def save(self, filename: str, directory: Optional[str] = None) -> str:
        import os

        path = os.path.join(directory or ".", filename)
        with open(path, "w") as f:
            f.write(self.source)
        return path


def create_tree_digraph(
    booster: Any,
    tree_index: int = 0,
    show_info: Optional[List[str]] = None,
    precision: Optional[int] = 3,
    orientation: str = "horizontal",
    example_case: Optional[Any] = None,
    max_category_values: int = 10,
    **kwargs: Any,
):
    """DOT digraph of one tree (reference plotting.py:616). Returns a
    ``graphviz.Digraph`` when the package is importable, else a stand-in
    with the same ``.source``."""
    bst = _to_booster(booster)
    model = bst.dump_model()
    trees = model["tree_info"]
    if not 0 <= tree_index < len(trees):
        raise IndexError(f"tree_index {tree_index} out of range")
    root = trees[tree_index]["tree_structure"]
    feature_names = list(model.get("feature_names", []))
    show_info = [s for s in (show_info or []) if s in _SHOW_INFO]
    total_count = int(root.get("internal_count", root.get("leaf_count", 0)))

    highlighted: set = set()
    if example_case is not None:
        arr = np.asarray(example_case, dtype=object)
        if arr.ndim == 2:
            if arr.shape[0] != 1:
                raise ValueError("example_case must be one row")
            arr = arr[0]
        row = np.array(
            [np.nan if v is None else float(v) for v in arr], dtype=np.float64
        )
        highlighted = _decision_path(root, row)

    rankdir = "LR" if orientation == "horizontal" else "TB"
    try:
        from graphviz import Digraph

        graph = Digraph(name=f"Tree{tree_index}",
                        graph_attr={"rankdir": rankdir}, **kwargs)
    except ImportError:
        graph = _DotStandin(f"Tree{tree_index}",
                            graph_attr={"rankdir": rankdir}, **kwargs)

    counter = [0]

    def add(node: Dict[str, Any]) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        attrs = {"shape": "rectangle"}
        if id(node) in highlighted:
            attrs.update(color="blue", penwidth="3")
        graph.node(
            nid,
            _node_label(node, feature_names, show_info, precision,
                        total_count, max_category_values),
            **attrs,
        )
        if "split_feature" in node:
            missing_left = bool(node.get("default_left", True)) and \
                node.get("missing_type") != "None"
            lid = add(node["left_child"])
            rid = add(node["right_child"])
            graph.edge(nid, lid,
                       label="yes" + (" (missing)" if missing_left else ""))
            graph.edge(nid, rid,
                       label="no" + ("" if missing_left else " (missing)"))
        return nid

    add(root)
    return graph


def _layout(node: Dict[str, Any], depth: int, next_y: List[int],
            pos: Dict[int, Tuple[float, float]]) -> float:
    """leaves at consecutive y slots; parents centered over children."""
    if "split_feature" not in node:
        y = float(next_y[0])
        next_y[0] += 1
        pos[id(node)] = (float(depth), y)
        return y
    ly = _layout(node["left_child"], depth + 1, next_y, pos)
    ry = _layout(node["right_child"], depth + 1, next_y, pos)
    y = (ly + ry) / 2.0
    pos[id(node)] = (float(depth), y)
    return y


def plot_tree(
    booster: Any,
    ax=None,
    tree_index: int = 0,
    figsize: Optional[Tuple[float, float]] = None,
    dpi: Optional[int] = None,
    show_info: Optional[List[str]] = None,
    precision: Optional[int] = 3,
    orientation: str = "horizontal",
    example_case: Optional[Any] = None,
    **kwargs: Any,
):
    """Draw one tree with matplotlib (reference plotting.py:742 — but
    self-contained: the reference renders through the graphviz binary,
    this draws boxes and edges directly so it works anywhere
    matplotlib does)."""
    bst = _to_booster(booster)
    model = bst.dump_model()
    trees = model["tree_info"]
    if not 0 <= tree_index < len(trees):
        raise IndexError(f"tree_index {tree_index} out of range")
    root = trees[tree_index]["tree_structure"]
    feature_names = list(model.get("feature_names", []))
    show_info = [s for s in (show_info or []) if s in _SHOW_INFO]
    total_count = int(root.get("internal_count", root.get("leaf_count", 0)))

    highlighted: set = set()
    if example_case is not None:
        arr = np.asarray(example_case, dtype=object)
        if arr.ndim == 2:
            arr = arr[0]
        row = np.array(
            [np.nan if v is None else float(v) for v in arr], dtype=np.float64
        )
        highlighted = _decision_path(root, row)

    pos: Dict[int, Tuple[float, float]] = {}
    _layout(root, 0, [0], pos)
    horizontal = orientation == "horizontal"

    ax = _new_axes(ax, figsize, dpi)

    def draw(node: Dict[str, Any]):
        d, y = pos[id(node)]
        x, yy = (d, -y) if horizontal else (y, -d)
        is_path = id(node) in highlighted
        box = dict(
            boxstyle="round,pad=0.3",
            fc="#d8e8f8" if "split_feature" in node else "#e8f8d8",
            ec="blue" if is_path else "gray",
            lw=2.5 if is_path else 1.0,
        )
        ax.text(
            x, yy,
            _node_label(node, feature_names, show_info, precision,
                        total_count, max_category_values=10),
            ha="center", va="center", fontsize=8, bbox=box, zorder=3,
        )
        if "split_feature" in node:
            for side, lab in (("left_child", "yes"), ("right_child", "no")):
                child = node[side]
                cd, cy = pos[id(child)]
                cx, cyy = (cd, -cy) if horizontal else (cy, -cd)
                ax.plot([x, cx], [yy, cyy], "-", color="gray", lw=1,
                        zorder=1)
                ax.annotate(
                    lab, ((x + cx) / 2, (yy + cyy) / 2),
                    fontsize=7, color="gray", zorder=2,
                )
                draw(child)

    draw(root)
    ax.axis("off")
    return ax
