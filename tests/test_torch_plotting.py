"""The port's plots (lightgbm_tpu_torch/plotting.py) against the JAX
package's on the Agg backend: the same model text loaded into both
packages' Boosters gives the same bar heights, tick labels, line data,
node texts and DOT source."""

import builtins

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu as lgb_j  # noqa: E402
import lightgbm_tpu_torch as lgb_t  # noqa: E402
from lightgbm_tpu import plotting as plot_j  # noqa: E402
from lightgbm_tpu_torch import plotting as plot_t  # noqa: E402
from _port_threads import one_torch_thread  # noqa: E402

one_torch_thread()  # one torch thread a test worker (see the module)


@pytest.fixture(scope="module")
def models():
    """One JAX-trained model (a categorical column among numerical ones)
    as text, loaded into a Booster of each package, and the evaluation
    record of its training."""
    rs = np.random.RandomState(11)
    X = rs.randn(500, 5)
    X[:, 4] = rs.randint(0, 6, 500)
    y = (X[:, 0] + 0.5 * X[:, 1] + (X[:, 4] > 2) > 0).astype(float)
    ev = {}
    ds = lgb_j.Dataset(X[:400], label=y[:400], categorical_feature=[4],
                       free_raw_data=False)
    vs = lgb_j.Dataset(X[400:], label=y[400:], reference=ds)
    bst = lgb_j.train({"objective": "binary", "num_leaves": 7,
                       "metric": ["auc", "binary_logloss"],
                       "verbosity": -1, "tpu_growth_mode": "rounds",
                       "tpu_hist_dtype": "int16"}, ds, 6,
                      valid_sets=[ds, vs], valid_names=["train", "valid"],
                      callbacks=[lgb_j.record_evaluation(ev)])
    text = bst.model_to_string()
    return (lgb_j.Booster(model_str=text), lgb_t.Booster(model_str=text),
            ev, X)


def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


def _texts(ax):
    return [t.get_text() for t in ax.texts]


def _labels(ax):
    return ([t.get_text() for t in ax.get_yticklabels()],
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            ax.get_xlim(), ax.get_ylim())


@pytest.mark.parametrize("kw", [
    {}, {"importance_type": "gain"}, {"max_num_features": 2},
    {"ignore_zero": False, "precision": 2}])
def test_plot_importance_matches(models, kw):
    bj, bt, _, _ = models
    aj = plot_j.plot_importance(bj, **kw)
    at = lgb_t.plot_importance(bt, **kw)
    assert _bars(at) == _bars(aj) and _texts(at) == _texts(aj)
    assert _labels(at) == _labels(aj)
    plt.close("all")


@pytest.mark.parametrize("feature,bins", [(0, None), (1, 3),
                                          ("Column_0", None)])
def test_plot_split_value_histogram_matches(models, feature, bins):
    bj, bt, _, _ = models
    aj = plot_j.plot_split_value_histogram(bj, feature, bins=bins)
    at = lgb_t.plot_split_value_histogram(bt, feature, bins=bins)
    assert _bars(at) == _bars(aj) and len(_bars(at)) > 0
    assert at.get_title() == aj.get_title() and \
        at.get_ylim() == aj.get_ylim()
    plt.close("all")
    with pytest.raises(ValueError):
        plot_t.plot_split_value_histogram(bt, "no_such_feature")


@pytest.mark.parametrize("metric,names", [
    (None, None), ("binary_logloss", ["valid"]), ("auc", ["train"])])
def test_plot_metric_matches(models, metric, names):
    _, _, ev, _ = models
    aj = plot_j.plot_metric(ev, metric=metric, dataset_names=names)
    at = lgb_t.plot_metric(ev, metric=metric, dataset_names=names)
    lines = lambda ax: [(ln.get_label(), list(ln.get_xdata()),  # noqa: E731
                         list(ln.get_ydata())) for ln in ax.get_lines()]
    assert lines(at) == lines(aj) and len(lines(at)) >= 1
    assert at.get_ylabel() == aj.get_ylabel()
    assert at.get_xlim() == aj.get_xlim()
    plt.close("all")
    with pytest.raises(TypeError):
        lgb_t.plot_metric(models[1])


@pytest.mark.parametrize("tree,kw", [
    (0, {}),
    (3, {"show_info": ["split_gain", "internal_count", "leaf_count",
                       "data_percentage"], "precision": 4}),
    (5, {"orientation": "vertical", "example_case": "row"})])
def test_tree_digraph_and_plot_tree_match(models, tree, kw):
    bj, bt, _, X = models
    kw = dict(kw)
    if kw.get("example_case") == "row":
        kw["example_case"] = X[7:8]
    gj = plot_j.create_tree_digraph(bj, tree_index=tree, **kw)
    gt = lgb_t.create_tree_digraph(bt, tree_index=tree, **kw)
    assert gt.source == gj.source and "->" in gt.source
    aj = plot_j.plot_tree(bj, tree_index=tree, **kw)
    at = lgb_t.plot_tree(bt, tree_index=tree, **kw)
    assert _texts(at) == _texts(aj) and len(_texts(at)) > 1
    plt.close("all")


def test_dot_standin_without_graphviz(models, monkeypatch, tmp_path):
    """Without the graphviz package both packages give the stand-in with
    the same source, and .save writes it."""
    bj, bt, _, _ = models
    real = builtins.__import__

    def no_graphviz(name, *a, **k):
        if name == "graphviz":
            raise ImportError("graphviz hidden for the test")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_graphviz)
    gj = plot_j.create_tree_digraph(bj, tree_index=1,
                                    show_info=["internal_value"])
    gt = plot_t.create_tree_digraph(bt, tree_index=1,
                                    show_info=["internal_value"])
    assert isinstance(gt, plot_t._DotStandin)
    assert gt.source == gj.source
    path = gt.save("t.dot", directory=str(tmp_path))
    assert open(path).read() == gt.source


def test_plots_refuse_as_the_jax_package(models, monkeypatch):
    bj, bt, _, _ = models
    for mod, b in ((plot_t, bt), (plot_j, bj)):
        with pytest.raises(IndexError):
            mod.create_tree_digraph(b, tree_index=99)
        with pytest.raises(TypeError):
            mod.plot_importance(object())
        with pytest.raises(TypeError):
            mod.plot_importance(b, figsize=(1, 2, 3))
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError("matplotlib hidden for the test")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib is required"):
        plot_t.plot_tree(bt)
