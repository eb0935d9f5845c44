"""The port's out-of-core data plane (lightgbm_tpu_torch/data/) against
the JAX package's (lightgbm_tpu/data/), with JAX on the CPU.

- the chunk store: a roundtrip with metadata; a spool written by either
  package opens in the other with the same arrays, each chunk passing
  the reader's size / crc32 check; truncated and corrupt chunks raise
  ChunkIntegrityError naming the chunk; resume discards stragglers;
- the prefetcher: ordered, bounded, closable mid-iteration, its reader's
  errors chained into the consumer's, and no torch call on its thread;
  resolve_chunk_rows and prefetch_depth equal the JAX package's on a grid;
- the chunked fit (data_chunk_rows=2048, 2,500 rows, two chunks) for
  binary, multiclass, lambdarank with group, a categorical column and an
  EFB-bundled pair: the model text (modulo the four data-plane parameter
  lines) and the predictions bit for bit the port's in-RAM fit; the bins
  and mappers the JAX package's chunked construct's, bit for bit; the
  trees the JAX package's chunked fit's at the tolerances of
  tests/test_torch_train.py;
- Sequence inputs: the bins of the chunked path, and from_sequences
  exactly the JAX package's (mappers, bins, metadata);
- the streamed subset, the save_binary roundtrip with the .bin read by
  the JAX package, warn_over_budget's one path, SpooledData through the
  sklearn estimators and the run manifest's data_plane keys.

Both sides pin tpu_growth_mode=rounds and tpu_hist_dtype=int16 (the
port's defaults; ROADMAP "Reference-side pins").
"""

import threading

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.data import prefetch as pf_j
from lightgbm_tpu.data import store as st_j
from lightgbm_tpu.data import streaming as sm_j
from lightgbm_tpu_torch import log as log_t
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import (last_stats, ram_budget_bytes,
                                     reset_stats, warn_over_budget)
from lightgbm_tpu_torch.data import prefetch as pf_t
from lightgbm_tpu_torch.data import store as st_t
from lightgbm_tpu_torch.data import streaming as sm_t
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

PINS = {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16",
        "verbosity": -1}
CPU = {"device_type": "cpu"}
CHUNKED = {"data_source": "chunked", "data_chunk_rows": 2048}
DATA_LINES = ("[data_source", "[ram_budget_mb", "[data_chunk_rows",
              "[data_spool_dir")


_STRUCT = ("num_leaves", "split_feature", "threshold", "decision_type",
           "left_child", "right_child", "leaf_count", "internal_count")


def _trees(text):
    trees, cur = [], None
    for line in text.split("end of trees")[0].splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    return trees


def _strip(text: str) -> str:
    """The model text without the data plane's parameter lines."""
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith(DATA_LINES))


def _xy(seed=0, n=2500, f=8):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    X[:, 2] = X[:, 2] > 0.3
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + rs.randn(n) * 0.1
    return X, y


# ---------------------------------------------------------------- store
def test_store_roundtrip_with_metadata(tmp_path):
    rs = np.random.RandomState(1)
    X = rs.randn(700, 5)
    w = rs.rand(700).astype(np.float32)
    store = st_t.spool_numpy(X, tmp_path / "s", chunk_rows=256,
                             label=X[:, 0], weight=w)
    assert (store.total_rows, store.num_chunks, store.complete) == \
        (700, 3, True)  # 256 + 256 + 188
    back = st_t.ChunkStore.open(tmp_path / "s")
    rows = []
    for idx, row0, arrays in back.iter_chunks():
        assert row0 == idx * 256
        rows.append(arrays["cols"].T)
    np.testing.assert_array_equal(np.concatenate(rows), X)
    np.testing.assert_array_equal(back.gather_meta("label"), X[:, 0])
    np.testing.assert_array_equal(back.gather_meta("weight"), w)
    assert back.gather_meta("qid") is None
    # float32 stays float32 on disk
    s32 = st_t.spool_numpy(X.astype(np.float32), tmp_path / "s32", 256)
    assert s32.manifest["value_dtype"] == "float32"
    assert s32.read_chunk(0)["cols"].dtype == np.float32


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spool_opens_in_the_other_package(writer, tmp_path):
    rs = np.random.RandomState(2)
    X = rs.randn(900, 4).astype(np.float32)
    lbl = rs.rand(900)
    qid = np.repeat(np.arange(90), 10).astype(np.float64)
    w_mod, r_mod = (st_j, st_t) if writer == "jax" else (st_t, st_j)
    w_mod.spool_numpy(X, tmp_path / "s", chunk_rows=256, label=lbl, qid=qid)
    back = r_mod.ChunkStore.open(tmp_path / "s")
    assert back.complete and back.total_rows == 900
    got = np.concatenate([a["cols"].T for _i, _r, a in back.iter_chunks()])
    np.testing.assert_array_equal(got, X)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(back.gather_meta("label"), lbl)
    np.testing.assert_array_equal(back.gather_meta("qid"), qid)
    # each chunk's crc32 as the reader computes it is the writer's
    for i in range(back.num_chunks):
        crc, size = r_mod._crc_and_size(back.root / back.chunk_meta(i)["file"])
        assert (crc, size) == (back.chunk_meta(i)["crc32"],
                               back.chunk_meta(i)["bytes"])
    # the binned spool of pass 2 opens in the other package too
    cfg = {"bin_construct_sample_cnt": 200000, "data_random_seed": 1}
    if writer == "jax":
        from lightgbm_tpu.config import Config as ConfigJ

        _, bs = sm_j.stream_bin(w_mod.ChunkStore.open(tmp_path / "s"),
                                ConfigJ(cfg), tmp_path / "b")
    else:
        _, bs = sm_t.stream_bin(w_mod.ChunkStore.open(tmp_path / "s"),
                                Config(cfg), tmp_path / "b")
    bb = r_mod.ChunkStore.open(tmp_path / "b")
    assert bb.kind == "binned" and bb.num_chunks == bs.num_chunks
    for i in range(bb.num_chunks):
        np.testing.assert_array_equal(bb.read_chunk(i)["bins"],
                                      bs.read_chunk(i)["bins"])


@pytest.mark.parametrize("how", ["truncated", "bitflip", "missing"])
def test_damaged_chunk_raises_naming_it(how, tmp_path):
    store = st_t.spool_numpy(np.random.RandomState(3).randn(600, 4),
                             tmp_path / "s", chunk_rows=256)
    victim = store.root / store.chunk_meta(1)["file"]
    data = victim.read_bytes()
    if how == "truncated":
        victim.write_bytes(data[: len(data) // 2])
    elif how == "bitflip":
        raw = bytearray(data)
        raw[len(raw) // 2] ^= 0xFF
        victim.write_bytes(bytes(raw))
    else:
        victim.unlink()
    back = st_t.ChunkStore.open(tmp_path / "s")
    with pytest.raises(st_t.ChunkIntegrityError) as ei:
        back.read_chunk(1)
    msg = str(ei.value)
    assert "chunk 1" in msg
    expect = {"truncated": f"offset {len(data) // 2}", "bitflip": "crc32",
              "missing": "missing"}[how]
    assert expect in msg
    back.read_chunk(0)  # the damage stays with its chunk
    # the JAX package's reader refuses the same chunk
    with pytest.raises(st_j.ChunkIntegrityError, match="chunk 1"):
        st_j.ChunkStore.open(tmp_path / "s").read_chunk(1)


def test_resume_discards_stragglers_and_continues(tmp_path):
    X = np.random.RandomState(4).randn(900, 3)
    store = st_t.ChunkStore.create(tmp_path / "s", n_features=3,
                                   chunk_rows=256)
    store.append_rows(X[:600])  # 2 committed chunks, 88 rows buffered
    assert store.total_rows == 512 and not store.complete
    (tmp_path / "s" / "chunk_000002.npz.tmp").write_bytes(b"partial")
    resumed = st_t.ChunkStore.resume(tmp_path / "s")
    assert resumed.total_rows == 512
    assert not list((tmp_path / "s").glob("*.tmp"))
    resumed.append_rows(X[512:])
    resumed.finalize()
    back = st_j.ChunkStore.open(tmp_path / "s")  # either package reads it
    assert back.complete and back.total_rows == 900
    got = np.concatenate([a["cols"].T for _i, _r, a in back.iter_chunks()])
    np.testing.assert_array_equal(got, X)
    with pytest.raises(st_t.ChunkStoreError, match="finalized"):
        st_t.ChunkStore.resume(tmp_path / "s")
    with pytest.raises(st_t.ChunkStoreError, match="existing spool"):
        st_t.ChunkStore.create(tmp_path / "s", n_features=3)


def test_spool_blocks_and_text(tmp_path):
    X = np.random.RandomState(5).randn(500, 3)
    s = st_t.spool_blocks(iter(np.array_split(X, 7)), tmp_path / "b", 128)
    got = np.concatenate([a["cols"].T for _i, _r, a in s.iter_chunks()])
    np.testing.assert_array_equal(got, X)
    with pytest.raises(st_t.ChunkStoreError, match="empty"):
        st_t.spool_blocks(iter(()), tmp_path / "e", 128)
    path = tmp_path / "t.csv"
    rows = np.column_stack([np.arange(500) % 2, X, np.repeat(np.arange(50),
                                                             10)])
    with open(path, "w") as f:
        f.write("y,a,b,c,q\n")
        np.savetxt(f, rows, delimiter=",", fmt="%.17g")
    kw = dict(header=True, label_column="name:y", group_column="name:q")
    st_t_, names_t = st_t.spool_text_file(path, tmp_path / "tt", 128, **kw)
    st_j_, names_j = st_j.spool_text_file(path, tmp_path / "tj", 128, **kw)
    assert names_t == names_j == ["a", "b", "c"]
    assert st_t_.manifest["chunks"][-1]["keys"] == \
        st_j_.manifest["chunks"][-1]["keys"]
    for i in range(st_t_.num_chunks):
        a, b = st_t_.read_chunk(i), st_j_.read_chunk(i)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------- prefetch
@pytest.mark.parametrize("slotted", [False, True])
def test_prefetcher_ordered_and_bounded(slotted):
    loads = []

    def load(i):
        loads.append(i)
        return np.full((2, 4), i, np.uint8), {"i": i}

    slots = [np.zeros(8, np.uint8) for _ in range(2)] if slotted else None
    pf = pf_t.ChunkPrefetcher(load, n_chunks=6, depth=2, slots=slots)
    assert pf._q.maxsize == 2  # the bounded queue is the contract
    seen = []
    for idx, buf, info in pf:
        if slotted:
            assert buf in (0, 1)
            np.testing.assert_array_equal(slots[buf], np.full(8, idx))
            pf.release(buf)
        else:
            np.testing.assert_array_equal(buf, np.full((2, 4), idx))
        seen.append((idx, info["i"]))
    pf.close()
    assert seen == [(i, i) for i in range(6)]
    assert sorted(loads) == list(range(6))


def test_prefetcher_slot_waits_for_release():
    """With every slot held by the consumer the reader waits: a slot is
    never refilled before release() hands it back."""
    slots = [np.zeros(4, np.int32)]
    pf = pf_t.ChunkPrefetcher(lambda i: (np.full(4, i, np.int32), {}),
                              n_chunks=3, depth=1, slots=slots)
    it = iter(pf)
    idx, slot, _ = next(it)
    threading.Event().wait(0.5)  # the reader has had time to run ahead
    np.testing.assert_array_equal(slots[slot], np.full(4, idx))
    pf.release(slot)
    assert [i for i, s, _ in (next(it),)] == [1]
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_closable_mid_iteration():
    pf = pf_t.ChunkPrefetcher(lambda i: (np.zeros((1, 1)), {}),
                              n_chunks=1000, depth=2)
    for idx, _b, _p in pf:
        if idx == 3:
            break
    pf.close()
    pf.close()  # idempotent
    assert not pf._thread.is_alive()


def test_prefetcher_error_propagates_chained():
    def load(i):
        if i == 1:
            raise ValueError("disk on fire")
        return np.zeros((1, 1), np.int32), {}

    with pf_t.ChunkPrefetcher(load, n_chunks=3, depth=1) as pf:
        with pytest.raises(RuntimeError, match="prefetch reader failed") \
                as ei:
            list(pf)
    assert isinstance(ei.value.__cause__, ValueError)
    assert "disk on fire" in str(ei.value.__cause__)
    assert ei.value.__cause__.__traceback__ is not None


def test_reader_thread_calls_no_torch(tmp_path):
    """The reader reads and copies with numpy only: no frame of torch
    runs on the chunk-prefetch thread during an assembly."""
    X, y = _xy(n=10000, f=4)
    ds = lgb_t.Dataset(X, label=y, params={**CPU, **CHUNKED})
    ds.construct()
    seen = set()

    def prof(frame, event, arg):
        if threading.current_thread().name == "chunk-prefetch":
            mod = frame.f_globals.get("__name__", "")
            if event == "c_call":
                mod = getattr(arg, "__module__", None) or ""
            if mod.split(".")[0] == "torch":
                seen.add(mod)

    threading.setprofile(prof)
    try:
        ds._binned.device_arrays("cpu")
    finally:
        threading.setprofile(None)
    assert last_stats()["assemble"]["chunks"] == 5
    assert not seen, seen


@pytest.mark.parametrize("n_features", [1, 4, 28, 500])
@pytest.mark.parametrize("budget,chunk", [(0, 0), (8, 0), (64, 0),
                                          (64, 5000), (1, 0), (4096, 0)])
def test_chunk_rows_and_depth_match_jax(n_features, budget, chunk):
    from lightgbm_tpu.config import Config as ConfigJ

    p = {"ram_budget_mb": budget, "data_chunk_rows": chunk}
    rows = sm_t.resolve_chunk_rows(n_features, Config(p))
    assert rows == sm_j.resolve_chunk_rows(n_features, ConfigJ(p))
    for g in (1, n_features):
        cb = g * rows * 4
        assert pf_t.prefetch_depth(cb, ram_budget_bytes(budget)) == \
            pf_j.prefetch_depth(cb, ram_budget_bytes(budget))
    assert pf_t.prefetch_depth(0, 1) == pf_j.prefetch_depth(0, 1)


# --------------------------------------------- the chunked fit, bit-exact
def _fit_case(name):
    rs = np.random.RandomState(11)
    n = 2500
    X = rs.randn(n, 6)
    ds_kw = {}
    params = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
              "seed": 7, **PINS}
    z = X[:, 0] + 0.5 * X[:, 1]
    y = (z + 0.3 * rs.randn(n) > 0).astype(float)
    if name == "multiclass":
        params.update(objective="multiclass", num_class=3, num_leaves=7)
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    elif name == "lambdarank":
        params.update(objective="lambdarank", num_leaves=7,
                      min_data_in_leaf=10)
        y = np.clip(np.round(z + 2 + 0.3 * rs.randn(n)), 0, 4)
        ds_kw["group"] = np.full(n // 25, 25)
    elif name == "categorical":
        X[:, 3] = rs.randint(0, 6, n)
        y = ((z + np.array([-1.5, 0.0, 1.5, -0.5, 0.7, 2.0])[
            X[:, 3].astype(int)] + 0.3 * rs.randn(n)) > 0).astype(float)
        ds_kw["categorical_feature"] = [3]
    elif name == "efb":
        # two sparse, mutually exclusive columns: one bundle
        half = np.arange(n) < n // 2
        X[:, 4] = np.where(half & (rs.rand(n) < 0.2), rs.randn(n) + 3, 0.0)
        X[:, 5] = np.where(~half & (rs.rand(n) < 0.2), rs.randn(n) - 3, 0.0)
        y = ((z + X[:, 4] - X[:, 5] + 0.3 * rs.randn(n)) > 0).astype(float)
    return params, X, y, ds_kw


FIT_CASES = ["binary", "multiclass", "lambdarank", "categorical", "efb"]


@pytest.fixture(scope="module", params=FIT_CASES)
def fits(request):
    name = request.param
    params, X, y, ds_kw = _fit_case(name)
    rounds = 5
    pt = {**params, **CPU}
    d_ram = lgb_t.Dataset(X, label=y, params=pt, **ds_kw)
    b_ram = lgb_t.train(pt, d_ram, rounds)
    reset_stats()
    d_chk = lgb_t.Dataset(X, label=y, params={**pt, **CHUNKED}, **ds_kw)
    b_chk = lgb_t.train({**pt, **CHUNKED}, d_chk, rounds)
    stats = last_stats()
    pj = {**params, **CHUNKED}
    d_j = lgb_j.Dataset(X, label=y, params=pj, **ds_kw)
    b_j = lgb_j.train(pj, d_j, rounds)
    return name, X, (d_ram, b_ram), (d_chk, b_chk), (d_j, b_j), stats


def test_chunked_fit_equals_in_ram_fit(fits):
    name, X, (d_ram, b_ram), (d_chk, b_chk), _, stats = fits
    assert isinstance(d_chk._binned, sm_t.StreamedBinnedDataset)
    assert d_chk._binned.bins.shape[1] == 0  # bins stay on disk
    assert _strip(b_chk.model_to_string()) == _strip(b_ram.model_to_string())
    assert b_chk.model_to_string() != b_ram.model_to_string()
    np.testing.assert_array_equal(b_chk.predict(X, raw_score=True),
                                  b_ram.predict(X, raw_score=True))
    dev_c = d_chk._binned.device_arrays("cpu")
    dev_r = d_ram._binned.device_arrays("cpu")
    for k in ("bins", "valid", "nan_bin", "num_bins", "mono", "is_cat"):
        assert dev_c[k].dtype == dev_r[k].dtype
        assert bool((dev_c[k] == dev_r[k]).all()), k
    assert (dev_c["bundle"] is None) == (name != "efb")
    asm = stats["assemble"]
    assert asm["chunks"] == 2 and asm["chunk_rows"] == 2048
    assert asm["prefetch_depth"] >= 1 and asm["donate"] is False
    assert asm["h2d_bytes"] == 0 and asm["pinned_mb"] == 0.0  # the CPU
    assert asm["rss_spread_mb"] <= 64.0
    assert {"spool", "pass1", "pass2", "assemble"} <= set(stats)


def test_chunked_construct_equals_jax(fits):
    """The data plane's output is the JAX package's bit for bit: the
    mappers, the layout and the device bins."""
    name, X, _, (d_chk, _b), (d_j, _bj), _ = fits
    bt, bj = d_chk._binned, d_j._binned
    assert type(bj).__name__ == "StreamedBinnedDataset"
    for mt, mj in zip(bt.mappers, bj.mappers):
        np.testing.assert_array_equal(mt.upper_bounds, mj.upper_bounds)
        assert (mt.num_bin, mt.most_freq_bin, mt.default_bin,
                mt.missing_type.value, mt.bin_type.value) == \
            (mj.num_bin, mj.most_freq_bin, mj.default_bin,
             mj.missing_type.value, mj.bin_type.value)
    np.testing.assert_array_equal(bt.used_features, bj.used_features)
    assert (bt.bundle_layout is None) == (bj.bundle_layout is None)
    if name == "efb":
        assert bt.bundle_layout.groups == bj.bundle_layout.groups
    np.testing.assert_array_equal(bt.device_arrays("cpu")["bins"].numpy(),
                                  np.asarray(bj.device_arrays()["bins"]))
    np.testing.assert_array_equal(bt.materialize_bins(),
                                  bj.materialize_bins())
    for f in ("label", "weight", "group"):
        a, b = getattr(bj.metadata, f), getattr(bt.metadata, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_chunked_fit_trees_match_jax(fits):
    """The trees of the JAX package's chunked fit. A categorical split
    may mirror its children where the two packages tie (ROADMAP C): that
    case is held as functions of the rows, each row's leaf value in each
    tree."""
    name, X, _, (_d, b_chk), (_dj, b_j), _ = fits
    tj, tt = _trees(b_j.model_to_string()), _trees(b_chk.model_to_string())
    assert len(tj) == len(tt) > 0
    lj = b_j.predict(X, pred_leaf=True).reshape(len(X), -1)
    lt = b_chk.predict(X, pred_leaf=True).reshape(len(X), -1)
    for i, (a, b) in enumerate(zip(tj, tt)):
        va = np.array(a["leaf_value"].split(), float)
        vb = np.array(b["leaf_value"].split(), float)
        if name == "categorical":
            np.testing.assert_allclose(vb[lt[:, i]], va[lj[:, i]],
                                       rtol=1e-5, atol=1e-7)
            continue
        for k in _STRUCT:
            assert a.get(k) == b.get(k), (name, k)
        np.testing.assert_allclose(vb, va, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b_chk.predict(X, raw_score=True),
                               b_j.predict(X, raw_score=True), atol=1e-5)


def test_chunked_fallbacks_warn(tmp_path, monkeypatch):
    """Inputs the chunked path cannot take warn and take the in-RAM path
    (on their format; none of them moves work off the card)."""
    import scipy.sparse as sp

    warned = []
    monkeypatch.setattr(log_t, "warning", warned.append)
    X, y = _xy(n=600, f=4)
    p = {**CPU, **CHUNKED, "verbosity": -1}
    train = lgb_t.Dataset(X, label=y, params=p).construct()
    valid = lgb_t.Dataset(X[:100], label=y[:100], params=p,
                          reference=train).construct()
    assert type(valid._binned).__name__ == "BinnedDataset"
    lin = lgb_t.Dataset(X, label=y, params={**p, "linear_tree": True})
    assert type(lin.construct()._binned).__name__ == "BinnedDataset"
    spd = lgb_t.Dataset(sp.csr_matrix(X), label=y, params=p).construct()
    assert type(spd._binned).__name__ == "BinnedDataset"
    path = str(tmp_path / "c.bin")
    train.save_binary(path)
    cache = lgb_t.Dataset(path, params=p).construct()
    assert type(cache._binned).__name__ == "BinnedDataset"
    text = " | ".join(warned)
    for what in ("reference=", "linear_tree", "scipy sparse"):
        assert what in text, what


# ------------------------------------------------------------- Sequence
class _SeqT(lgb_t.Sequence):
    def __init__(self, X, batch_size=512):
        self.X = X
        self.batch_size = batch_size

    def __len__(self):
        return self.X.shape[0]

    def __getitem__(self, idx):
        return self.X[idx]


class _SeqJ(lgb_j.Sequence):
    def __init__(self, X, batch_size=512):
        self.X = X
        self.batch_size = batch_size

    def __len__(self):
        return self.X.shape[0]

    def __getitem__(self, idx):
        return self.X[idx]


def test_sequence_bins_equal_chunked_bins():
    X, y = _xy(n=2500, f=6)
    ds_seq = lgb_t.Dataset(_SeqT(X), label=y, params=CPU).construct()
    ds_chk = lgb_t.Dataset(X, label=y, params={**CPU, **CHUNKED}).construct()
    assert bool((ds_seq._binned.device_arrays("cpu")["bins"]
                 == ds_chk._binned.device_arrays("cpu")["bins"]).all())
    # a list of sequences is one dataset of their rows
    ds_two = lgb_t.Dataset([_SeqT(X[:1000], 300), _SeqT(X[1000:], 700)],
                           label=y, params=CPU).construct()
    np.testing.assert_array_equal(ds_two._binned.bins, ds_seq._binned.bins)
    # data_source=chunked takes a Sequence through the chunk store
    ds_sc = lgb_t.Dataset(_SeqT(X), label=y,
                          params={**CPU, **CHUNKED}).construct()
    assert isinstance(ds_sc._binned, sm_t.StreamedBinnedDataset)
    np.testing.assert_array_equal(ds_sc._binned.materialize_bins(),
                                  ds_seq._binned.bins)


@pytest.mark.parametrize("sample_cnt", [200000, 700])
def test_from_sequences_equals_jax(sample_cnt):
    from lightgbm_tpu.config import Config as ConfigJ
    from lightgbm_tpu.dataset import BinnedDataset as BJ
    from lightgbm_tpu_torch.dataset import BinnedDataset as BT

    X, y = _xy(seed=9, n=2000, f=5)
    X[::7, 1] = np.nan
    X[:, 3] = np.random.RandomState(9).randint(0, 5, 2000)
    w = np.random.RandomState(10).rand(2000)
    p = {"bin_construct_sample_cnt": sample_cnt, "data_random_seed": 3}
    kw = dict(label=y, weight=w, group=np.full(40, 50),
              categorical_feature=[3], feature_names=list("abcde"))
    bt = BT.from_sequences([_SeqT(X[:1200], 256), _SeqT(X[1200:], 1000)],
                           Config(p), **kw)
    bj = BJ.from_sequences([_SeqJ(X[:1200], 256), _SeqJ(X[1200:], 1000)],
                           ConfigJ(p), **kw)
    for mt, mj in zip(bt.mappers, bj.mappers):
        np.testing.assert_array_equal(mt.upper_bounds, mj.upper_bounds)
        assert (mt.num_bin, mt.most_freq_bin, mt.default_bin,
                mt.missing_type.value, mt.bin_type.value,
                tuple(mt.categories)) == \
            (mj.num_bin, mj.most_freq_bin, mj.default_bin,
             mj.missing_type.value, mj.bin_type.value, tuple(mj.categories))
    np.testing.assert_array_equal(bt.bins, bj.bins)
    assert bt.bins.dtype == bj.bins.dtype
    assert bt.feature_names == bj.feature_names
    for f in ("label", "weight", "group"):
        np.testing.assert_array_equal(getattr(bt.metadata, f),
                                      getattr(bj.metadata, f))


# ------------------------------------------- host-matrix paths, manifest
def test_streamed_subset_matches_in_ram():
    X, y = _xy(n=2000, f=5)
    d_chk = lgb_t.Dataset(X, label=y, params={**CPU, **CHUNKED}).construct()
    d_ram = lgb_t.Dataset(X, label=y, params=CPU).construct()
    idx = np.random.RandomState(3).choice(2000, 300, replace=False)
    s_chk, s_ram = d_chk.subset(idx), d_ram.subset(idx)
    np.testing.assert_array_equal(s_chk._binned.bins, s_ram._binned.bins)
    np.testing.assert_array_equal(s_chk._binned.metadata.label,
                                  s_ram._binned.metadata.label)
    assert type(s_chk._binned).__name__ == "BinnedDataset"
    p = {**CPU, **PINS, "objective": "regression", "num_leaves": 7}
    np.testing.assert_array_equal(
        lgb_t.train(p, s_chk, 3).predict(X),
        lgb_t.train(p, s_ram, 3).predict(X))


def test_save_binary_roundtrip_streamed(tmp_path):
    from lightgbm_tpu.parsers import load_binary as load_j
    from lightgbm_tpu_torch.parsers import load_binary

    X, y = _xy(n=1500, f=4)
    ds = lgb_t.Dataset(X, label=y, params={**CPU, **CHUNKED}).construct()
    path = str(tmp_path / "cache.bin")
    ds.save_binary(path)
    ref = lgb_t.Dataset(X, label=y, params=CPU).construct()
    for back in (load_binary(path), load_j(path)):
        np.testing.assert_array_equal(back.bins, ref._binned.bins)
        np.testing.assert_array_equal(back.metadata.label,
                                      ref._binned.metadata.label)
    # the cache trains as the in-RAM set does
    p = {**CPU, **PINS, "objective": "regression", "num_leaves": 7}
    np.testing.assert_array_equal(
        lgb_t.train(p, lgb_t.Dataset(path, params=p), 3).predict(X),
        lgb_t.train(p, ref, 3).predict(X))


def test_warn_over_budget_is_single_path(monkeypatch):
    import lightgbm_tpu.log as log_j
    from lightgbm_tpu.data import warn_over_budget as warn_j

    msgs_t, msgs_j = [], []
    monkeypatch.setattr(log_t, "warning", msgs_t.append)
    monkeypatch.setattr(log_j, "warning", msgs_j.append)
    for nbytes, mb in (((2 << 20), 1), ((2 << 20), 8), ((1 << 30), 0),
                       ((1 << 30) + 1, 0)):
        assert warn_over_budget("thing", nbytes, mb, "h") == \
            warn_j("thing", nbytes, mb, "h")
    assert msgs_t == msgs_j and len(msgs_t) == 2
    assert "over the 1 MB host RAM budget" in msgs_t[0]
    assert "1024 MB default" in msgs_t[1]


def test_spooled_data_flows_through_sklearn(tmp_path):
    from lightgbm_tpu_torch.sklearn import LGBMClassifier, LGBMRegressor

    X, y = _xy(n=1000, f=4)
    sd = st_t.SpooledData(st_t.spool_numpy(X, tmp_path / "s",
                                           chunk_rows=2048))
    assert sd.shape == (1000, 4) and len(sd) == 1000
    kw = dict(n_estimators=4, device_type="cpu", **PINS)
    reset_stats()
    m = LGBMRegressor(data_source="chunked", **kw).fit(sd, y)
    assert last_stats()["spool"]["rows"] == 1000
    ref = LGBMRegressor(**kw).fit(X, y)
    np.testing.assert_array_equal(m.predict(X), ref.predict(X))
    yc = (y > 0).astype(int)
    c = LGBMClassifier(**kw).fit(sd, yc)  # SpooledData alone picks chunked
    np.testing.assert_array_equal(c.predict_proba(X),
                                  LGBMClassifier(**kw).fit(X, yc)
                                  .predict_proba(X))
    with pytest.raises(st_t.ChunkStoreError):
        st_t.SpooledData(st_t.ChunkStore.create(tmp_path / "b", 2,
                                                kind="binned"))


def test_manifest_carries_data_plane(tmp_path):
    from lightgbm_tpu.obs.manifest import build_manifest as build_j
    from lightgbm_tpu_torch.obs.manifest import build_manifest

    X, y = _xy(n=1200, f=4)
    reset_stats()
    p = {"objective": "regression", "data_spool_dir": str(tmp_path / "sp"),
         **CPU, **CHUNKED, **PINS}
    lgb_t.train(p, lgb_t.Dataset(X, label=y, params=p), 2)
    man = build_manifest(config=p)
    dp = man["data_plane"]
    assert set(dp) == {"spool", "pass1", "pass2", "assemble"}
    assert dp["spool"]["root"] == str(tmp_path / "sp" / "raw")
    assert dp["spool"]["owned_tmp"] is False
    assert (tmp_path / "sp" / "binned" / "manifest.json").exists()
    # the JAX package's keys, and the port's transfer keys beside them
    from lightgbm_tpu.data import reset_stats as reset_j

    reset_j()
    pj = {k: v for k, v in p.items() if k not in ("device_type",
                                                   "data_spool_dir")}
    lgb_j.train(pj, lgb_j.Dataset(X, label=y, params=pj), 2)
    dj = build_j(config=pj)["data_plane"]
    for section in dj:
        assert set(dj[section]) <= set(dp[section]), section
    assert set(dp["assemble"]) - set(dj["assemble"]) == \
        {"h2d_bytes", "h2d_seconds", "pinned_mb"}
    reset_stats()
    assert "data_plane" not in build_manifest(config=p)


def test_chunked_text_spool_equals_in_ram_text_fit(tmp_path):
    """A text file under data_source=chunked spools through the text
    chunks and fits as the whole-file loader's matrix does."""
    X, y = _xy(n=2500, f=5)
    path = tmp_path / "d.csv"
    with open(path, "w") as f:
        f.write("y,a,b,c,d,e\n")
        np.savetxt(f, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    p = {**CPU, **PINS, "objective": "regression", "num_leaves": 7,
         "header": True}
    b_ram = lgb_t.train(p, lgb_t.Dataset(str(path), params=p), 4)
    pc = {**p, **CHUNKED}
    d_chk = lgb_t.Dataset(str(path), params=pc)
    b_chk = lgb_t.train(pc, d_chk, 4)
    assert isinstance(d_chk._binned, sm_t.StreamedBinnedDataset)
    assert d_chk._binned.feature_names == list("abcde")
    assert _strip(b_chk.model_to_string()) == _strip(b_ram.model_to_string())
    np.testing.assert_array_equal(b_chk.predict(X), b_ram.predict(X))
