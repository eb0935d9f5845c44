"""The serving forest's node-major table and its gather, on the CPU
(lightgbm_tpu_torch/serving/forest.py, learner/histogram.take_rows).

The table is one record a node, (T * max_nodes, PACK_WIDTH) f32, laid
out on its device from the host packer's (9, T * max_nodes) array, the
JAX package's layout. These tests hold the new layout to the old one
bit for bit: the host tables against the JAX package's packer and
padder, and the records against them; take_rows_plain on the node-major table against take_cols_plain on the
(k, L) table (ragged N, indices below 0, at L and past it, tables under
and past take_small's 48 KB shared-memory stage); forest_apply,
stacked_forest_apply over a 3-slot stack written as a fleet page-in
writes it, and contrib_apply against a reference that runs the same
code on the JAX package's tables, its gathers through take_cols_plain;
and the port's forest against the JAX package's TensorForest within
rtol / atol 1e-5 (tests/test_torch_serving.py's), leaves exact. The
kernel itself is held against take_rows_plain on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.serving import TensorForest as JaxForest
from lightgbm_tpu.serving import forest as jfo
from lightgbm_tpu_torch.learner import cuda_hist
from lightgbm_tpu_torch.learner import histogram as ht
from lightgbm_tpu_torch.serving import forest as fo
from lightgbm_tpu_torch.serving.fleet import ForestStack
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


# ---------------------------------------------- the gather, plain versions
@pytest.mark.parametrize("k", [9, 16])
@pytest.mark.parametrize("L", [500, 2000])  # (9, L) f32: 18 KB, 72 KB
@pytest.mark.parametrize("n", [1, 37, 1024, 1027])
def test_take_rows_plain_equals_take_cols_plain(k, L, n):
    """The forest's k = 9 fields from 16-float records whose padding
    holds junk, and whole records (k = 16); the table holds -0.0, NaN
    and infinities, compared as bits."""
    rs = np.random.RandomState(L + n + k)
    rows = np.full((L, 16), 7.5, np.float32)
    rows[:, :9] = rs.randn(L, 9)
    rows[:5, 0] = [-0.0, np.nan, np.inf, -np.inf, 0.0]
    tab9 = np.ascontiguousarray(rows[:, :k].T)
    idx = rs.randint(0, L, n).astype(np.int32)
    idx[::5] = -1 - rs.randint(0, 3, len(idx[::5]))
    idx[1::7] = L
    idx[2::11] = L + 1 + rs.randint(0, 100, len(idx[2::11]))
    got = ht.take_rows_plain(torch.from_numpy(rows), torch.from_numpy(idx), k)
    want = ht.take_cols_plain(torch.from_numpy(tab9), torch.from_numpy(idx))
    assert got.shape == (k, n) and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))
    # the CPU entry point is the plain version
    assert torch.equal(_bits(ht.take_rows(torch.from_numpy(rows),
                                          torch.from_numpy(idx), k)),
                       _bits(want))


# ------------------------------------------------------ models and the JAX
# layout's reference
def _binary_cat(seed=5):
    """A binary model with a categorical column and NaN missing values,
    trained by the port on the CPU, and rows with unseen / negative
    categories and NaN."""
    rs = np.random.RandomState(seed)
    X = rs.randn(600, 6)
    X[:, 2] = rs.randint(0, 9, 600)
    X[rs.rand(600) < 0.05, 4] = np.nan
    y = (np.nan_to_num(X[:, 0]) + (X[:, 2] % 2) > 0.4).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, "device_type": "cpu"}
    bst = lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p,
                                       categorical_feature=[2]), 6)
    Xq = rs.randn(200, 6)
    Xq[:, 2] = rs.randint(-2, 14, 200)
    Xq[rs.rand(200) < 0.05, 4] = np.nan
    return bst.model_to_string(), Xq


def _regression(seed):
    """Models of one shape family (depth pinned; tests/test_torch_fleet.py
    `family`)."""
    r = np.random.RandomState(seed)
    X = r.randn(500, 6)
    y = X[:, 0] * (seed % 5 + 1) + X[:, 1] + 0.1 * r.randn(500)
    p = {"objective": "regression", "num_leaves": 6 + seed % 3,
         "verbosity": -1, "min_data_in_leaf": 5, "device_type": "cpu",
         "max_depth": 3}
    return lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 5 + seed)


@pytest.fixture(scope="module")
def cat_model():
    text, Xq = _binary_cat()
    return lgb_t.Booster(model_str=text), text, Xq


def _jax_tables(text):
    """The JAX package's host tables and metadata of a model text."""
    g = lgb_j.Booster(model_str=text)._gbdt
    return jfo.pack_forest_tables(list(g.models), g.num_class)


def test_node_records_lay_the_pack_out_node_major(cat_model):
    """The host tables are the JAX package's, padded too; record i of
    the forest's table holds column i of the (9, T*M) pack, then
    zeros."""
    bst, text, _ = cat_model
    g = bst._gbdt
    tables, meta = fo.pack_forest_tables(list(g.models), g.num_class)
    jtables, jmeta = _jax_tables(text)
    assert meta == jmeta and tables.keys() == jtables.keys()
    for k in tables:
        np.testing.assert_array_equal(tables[k], jtables[k])
    dims = dict(num_trees=meta["num_trees"] + 3,
                max_nodes=meta["max_nodes"] + 5,
                max_leaves=meta["max_leaves"] + 1,
                cat_words=tables["catw"].shape[0] + 2, lin_feats=2)
    padded, _ = fo.pad_forest_tables(tables, meta, **dims)
    jpadded, _ = jfo.pad_forest_tables(jtables, jmeta, **dims)
    for k in padded:
        np.testing.assert_array_equal(padded[k], jpadded[k])
    rec = fo.TensorForest(list(g.models), g.num_class,
                          device="cpu").tables["pack"]
    assert rec.shape == (meta["num_trees"] * meta["max_nodes"],
                         fo.PACK_WIDTH)
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    assert fo.PACK_WIDTH == cuda_hist.TAKE_ROWS_RECORD  # the kernel's record
    np.testing.assert_array_equal(rec[:, :fo.PACK_FIELDS].numpy(),
                                  jtables["pack"].T)
    assert not rec[:, fo.PACK_FIELDS:].any()


def _reference(fn, tables, *args, **kw):
    """fn (forest_apply, stacked_forest_apply, contrib_apply) run on the
    JAX package's host tables: the pack is its (9, T*M) array, handed
    over as its (T*M, 9) transpose view, and every gather of it is
    take_cols_plain on that array."""
    ref = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in tables.items()}
    assert ref["pack"].shape[0] == fo.PACK_FIELDS
    ref["pack"] = ref["pack"].T

    def take_from_cols(tab, idx, k):
        return ht.take_cols_plain(tab.T, idx)[:k]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ht, "take_rows", take_from_cols)
        return fn(ref, *args, **kw)


def _x(X):
    return torch.from_numpy(np.ascontiguousarray(X, np.float32))


def test_forest_apply_gives_the_jax_layouts_bits(cat_model):
    bst, text, Xq = cat_model
    g = bst._gbdt
    f = fo.TensorForest(list(g.models), g.num_class, device="cpu")
    assert f.meta["has_cat"]
    assert f.tables["pack"].shape == (
        f.meta["num_trees"] * f.meta["max_nodes"], fo.PACK_WIDTH)
    tables, _ = _jax_tables(text)
    tw = torch.ones(f.num_trees)
    score, leaf = f.apply(_x(Xq), tw)
    rscore, rleaf = _reference(fo.forest_apply, tables, _x(Xq), tw,
                               has_cat=True, levels=f.levels)
    assert torch.equal(leaf, rleaf)
    assert torch.equal(_bits(score), _bits(rscore))


def test_contrib_apply_gives_the_jax_layouts_bits(cat_model):
    bst, text, Xq = cat_model
    g = bst._gbdt
    f = fo.TensorForest(list(g.models), g.num_class, device="cpu")
    tables, _ = _jax_tables(text)
    ct, _ = f.contrib_tables()
    tw = torch.ones(f.num_trees)
    got = f.apply_contrib(_x(Xq[:40]), tw)
    want = _reference(fo.contrib_apply, tables, ct, _x(Xq[:40]), tw,
                      has_cat=True)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_stacked_slots_give_the_jax_layouts_bits():
    """Three models of one family written into a 3-slot stack as a fleet
    page-in writes them (ForestStack.write: node records, each slot's
    rows one block), each slot scored against the JAX package's padded
    tables stacked the same way (the (9, T*M) packs side by side) and
    against the model's own forest."""
    boosters = [_regression(s) for s in range(3)]
    packed = [fo.pack_forest_tables(list(b._gbdt.models), 1)
              for b in boosters]
    fams = {fo.family_key(m, t) for t, m in packed}
    assert len(fams) == 1
    fam = fams.pop()
    dims = dict(num_trees=fam[0], max_nodes=fam[1], max_leaves=fam[2],
                cat_words=fam[4], lin_feats=fam[5])
    padded = [fo.pad_forest_tables(t, m, **dims)[0] for t, m in packed]
    jpadded = [jfo.pad_forest_tables(
        *_jax_tables(b.model_to_string()), **dims)[0] for b in boosters]
    stack = ForestStack(fam, 3, torch.device("cpu"))
    for s in (2, 0, 1):
        stack.write(s, padded[s])
    rows = fam[0] * fam[1]
    assert stack.tables["pack"].shape == (3 * rows, fo.PACK_WIDTH)
    jax_stack = {k: np.concatenate([p[k] for p in jpadded],
                                   axis=1 if k == "pack" else 0)
                 for k in jpadded[0]}
    X = _x(np.random.RandomState(8).randn(60, 6))
    for s, b in enumerate(boosters):
        # the slot's records are one contiguous block of the stack
        np.testing.assert_array_equal(
            stack.tables["pack"][s * rows:(s + 1) * rows].numpy(),
            fo.node_records(torch.from_numpy(padded[s]["pack"])).numpy())
        T = b.num_trees()
        tw = torch.zeros(fam[0])
        tw[:T] = 1.0
        slot = torch.tensor(s, dtype=torch.int32)
        kw = dict(has_cat=fam[7], linear=fam[8], levels=fam[6])
        score, leaf = fo.stacked_forest_apply(stack.tables, slot, X, tw,
                                              **kw)
        rscore, rleaf = _reference(fo.stacked_forest_apply, jax_stack,
                                   slot, X, tw, **kw)
        assert torch.equal(leaf, rleaf)
        assert torch.equal(_bits(score), _bits(rscore))
        own = fo.TensorForest(list(b._gbdt.models), 1, device="cpu")
        oscore, oleaf = own.apply(X, torch.ones(T))
        assert torch.equal(_bits(score), _bits(oscore))
        assert torch.equal(leaf[:, :T], oleaf)


def test_forest_matches_the_jax_forest(cat_model):
    """The port's forest on the node-major table against the JAX
    package's TensorForest on the same model text."""
    bst, text, Xq = cat_model
    ft = fo.TensorForest.from_booster(bst, device="cpu")
    fj = JaxForest.from_booster(lgb_j.Booster(model_str=text))
    np.testing.assert_allclose(ft.predict_raw(Xq), fj.predict_raw(Xq), **TOL)
    np.testing.assert_array_equal(ft.predict_leaf(Xq), fj.predict_leaf(Xq))
    np.testing.assert_allclose(ft.predict_raw(Xq, 1, 3),
                               fj.predict_raw(Xq, 1, 3), **TOL)
