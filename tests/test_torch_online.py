"""The port's online train-and-serve loop (lightgbm_tpu_torch/online/)
against the JAX package's (lightgbm_tpu/online/), with JAX on the CPU.

- the ingest spool, the durable state and the gate's decide() against
  the JAX package's functions on the same inputs (the same bytes on
  disk, the same reads and verdicts);
- one OnlineLoop.cycle() in both packages from the same v0 text and
  microbatch: the same verdict and trees, holdout metrics within 1e-6,
  and v0 a bit-exact prefix of the spliced candidate;
- the poison (NaN labels) / reject (flipped labels) / promote sequence
  on the port, with the microbatches arriving through the serving
  ``ingest`` op and the registry scoring while a promotion swaps it;
- the in-process fault matrix: a raise at each ``loop_*`` site leaves a
  restart serving v(n), and the cycle then replays;
- ``task=loop`` over stdio: ingest, one promoted verdict, quit.

Both sides pin tpu_growth_mode=rounds and tpu_hist_dtype=int16 (the
port's defaults; ROADMAP "Reference-side pins").
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu import online as on_j
from lightgbm_tpu.resilience import faultinject as fi_j
from lightgbm_tpu.resilience.errors import CheckpointError as CkptErrJ
from lightgbm_tpu_torch import online as on_t
from lightgbm_tpu_torch.resilience import faultinject as fi_t
from lightgbm_tpu_torch.resilience.errors import (CheckpointError,
                                                  InjectedFault)
from lightgbm_tpu_torch.serving import ModelRegistry
from lightgbm_tpu_torch.serving.server import handle_request
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

CORE = {"objective": "binary", "metric": "auc", "num_leaves": 7,
        "min_data_in_leaf": 5, "learning_rate": 0.2, "verbosity": -1,
        "seed": 7, "tpu_growth_mode": "rounds", "tpu_hist_dtype": "int16"}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fi_t.disarm()
    fi_j.disarm()


def _xy(seed, n):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 4)
    return X, (X[:, 0] + X[:, 1] > 0).astype(np.float64)


def _batch(seed, n=40):
    X, y = _xy(seed, n)
    return X.tolist(), y.tolist()


@pytest.fixture(scope="module")
def v0_text():
    X, y = _xy(5, 300)
    return lgb_j.train(dict(CORE), lgb_j.Dataset(X, label=y,
                                                 free_raw_data=False),
                       6).model_to_string()


def _params(d, **over):
    return {**CORE, "loop_dir": str(d), "loop_min_rows": 64,
            "loop_rounds": 4, "loop_poll_s": 0.05, **over}


def _port_loop(d, v0, **over):
    return on_t.OnlineLoop({**_params(d, **over), "device_type": "cpu"},
                           _xy(9, 200), initial_model=v0, device="cpu")


def _tree_blocks(text):
    body = text.split("end of trees")[0]
    return ["Tree=" + b.strip() for b in body.split("\nTree=")[1:]]


# ----------------------------------------------------- spool and state
def test_spool_matches(tmp_path):
    """The same appends give the same file bytes and offsets; both
    readers read either file alike, a torn tail included; the same
    refusals."""
    sps = {"t": on_t.IngestSpool(on_t.spool_path(str(tmp_path / "t"))),
           "j": on_j.IngestSpool(on_j.spool_path(str(tmp_path / "j")))}
    rows, labels = _batch(20, 3)
    outs = {k: [sp.append(rows, labels),
                sp.append(rows, labels, weights=[1.0, 2.0, 3.0])]
            for k, sp in sps.items()}
    assert outs["t"] == outs["j"]
    raw = {k: open(sp.path, "rb").read() for k, sp in sps.items()}
    assert raw["t"] == raw["j"]
    for sp in sps.values():
        with open(sp.path, "a") as f:
            f.write('{"rows": [[1.0')
    for reader in sps.values():
        for sp in sps.values():
            for off in (0, outs["t"][0]["offset"]):
                got = reader.read_from.__func__(sp, off)
                assert got == sps["j"].read_from.__func__(sp, off)
    batches, end = sps["t"].read_from(0)
    assert end == outs["t"][1]["offset"]
    st, sj = on_t.stack_batches(batches), on_j.stack_batches(batches)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st[2], [1, 1, 1, 1, 2, 3])
    for sp in sps.values():
        for bad in (lambda: sp.append([], []),
                    lambda: sp.append(rows, labels[:-1]),
                    lambda: sp.append([[1.0], [1.0, 2.0]], [0.0, 1.0]),
                    lambda: sp.append(rows, labels, weights=[1.0])):
            with pytest.raises(ValueError):
                bad()


def test_state_matches(tmp_path):
    """Each package reads the other's state file; the same schema, the
    same paths and the same refusals of torn, foreign and partial
    files."""
    assert on_t.fresh_state() == on_j.fresh_state()
    d = str(tmp_path)
    assert on_t.state_path(d) == on_j.state_path(d)
    assert on_t.model_path(d, 3) == on_j.model_path(d, 3)
    st = on_t.fresh_state()
    st.update(version=3, model_path=on_t.model_path(d, 3), cycle=5)
    on_t.save_state(on_t.state_path(d), st)
    assert on_j.load_state(on_j.state_path(d)) == st
    st["cycle"] = 6
    on_j.save_state(on_j.state_path(d), st)
    assert on_t.load_state(on_t.state_path(d)) == st
    assert not os.path.exists(on_t.state_path(d) + ".tmp")
    cases = {
        "torn": ('{"schema": "lightgbm-tpu/online-loop/v1", "ver',
                 "corrupt"),
        "alien": (json.dumps({"schema": "something/else"}), "schema"),
        "partial": (json.dumps({"schema": "lightgbm-tpu/online-loop/v1",
                                "version": 1}), "missing"),
    }
    for name, (body, match) in cases.items():
        p = tmp_path / f"{name}.json"
        p.write_text(body)
        with pytest.raises(CheckpointError, match=match):
            on_t.load_state(str(p))
        with pytest.raises(CkptErrJ, match=match):
            on_j.load_state(str(p))
    with pytest.raises(CheckpointError, match="cannot read"):
        on_t.load_state(str(tmp_path / "absent.json"))


@pytest.mark.parametrize("cand,inc,names,hb,margin,trips", [
    ([0.9], [0.5], ["auc"], [True], 0.0, {"loss_spike": 1}),
    ([0.9], [0.5], ["auc"], [True], 0.0, {"loss_spike": 0}),
    ([0.84], [0.85], ["auc"], [True], 0.0, {}),
    ([0.84], [0.85], ["auc"], [True], 0.02, {}),
    ([0.50], [0.40], ["binary_logloss"], [False], 0.0, {}),
    ([0.39], [0.40], ["binary_logloss"], [False], 0.0, {}),
    ([0.9, 9.9], [0.5, 0.1], ["auc", "binary_logloss"], [True, False],
     0.0, {}),
    ([0.2], None, ["auc"], [True], 0.0, {}),
    ([0.5], [0.5], ["l2"], [False], 0.0, {"refit_error": 1}),
])
def test_decide_matches(cand, inc, names, hb, margin, trips):
    assert on_t.decide(cand, inc, names, hb, margin, trips) == \
        on_j.decide(cand, inc, names, hb, margin, trips)


# ------------------------------------------------ one cycle, both sides
@pytest.fixture(scope="module")
def one_cycle(tmp_path_factory, v0_text):
    """One verdict cycle in each package from the same v0 text and the
    same two microbatches."""
    out = {}
    for name in ("t", "j"):
        d = tmp_path_factory.mktemp("cycle_" + name) / "loop"
        if name == "t":
            loop = _port_loop(d, v0_text)
        else:
            loop = on_j.OnlineLoop(_params(d), _xy(9, 200),
                                   initial_model=v0_text)
        for seed in (31, 32):
            loop.spool.append(*_batch(seed, 40))
        outcome = loop.cycle()
        st = dict(loop.state)
        text = open(st["model_path"]).read()
        events = [json.loads(x) for x in
                  open(os.path.join(loop.loop_dir, "loop_events.jsonl"))]
        out[name] = (outcome, st, text, events[-1])
    return out


def test_cycle_verdict_and_state_match(one_cycle):
    (ot, st, _, et), (oj, sj, _, ej) = one_cycle["t"], one_cycle["j"]
    assert ot == oj == "promoted"
    for k in ("version", "cycle", "ingest_offset", "counts",
              "last_outcome"):
        assert st[k] == sj[k], k
    for k in ("outcome", "serving_version", "candidate_version", "rows",
              "spool_span", "anomaly_trips"):
        assert et[k] == ej[k], k
    assert et["metrics"]["names"] == ej["metrics"]["names"] == ["auc"]


def test_cycle_metrics_within_1e6(one_cycle):
    et, ej = one_cycle["t"][3], one_cycle["j"][3]
    for side in ("candidate", "incumbent"):
        np.testing.assert_allclose(et["metrics"][side],
                                   ej["metrics"][side], rtol=0, atol=1e-6)
    np.testing.assert_allclose(one_cycle["t"][1]["incumbent_metrics"],
                               one_cycle["j"][1]["incumbent_metrics"],
                               rtol=0, atol=1e-6)


def test_cycle_same_trees_and_exact_prefix(one_cycle, v0_text):
    """The candidate's first trees are v0's text, byte for byte, in both
    packages; the refit's trees are the JAX package's (structure, and
    leaf values within rtol 1e-5)."""
    tt, tj = one_cycle["t"][2], one_cycle["j"][2]
    v0b, bt, bj = _tree_blocks(v0_text), _tree_blocks(tt), _tree_blocks(tj)
    assert len(bt) == len(bj) == len(v0b) + 4
    assert bt[:len(v0b)] == v0b == bj[:len(v0b)]
    from test_torch_api import _same_trees

    assert _same_trees(tt, tj)
    X = _xy(9, 200)[0]
    np.testing.assert_array_equal(
        lgb_t.Booster(model_str=tt).predict(X, raw_score=True,
                                            num_iteration=6),
        lgb_t.Booster(model_str=v0_text).predict(X, raw_score=True))


def test_splice_continued_refusals(v0_text):
    from lightgbm_tpu_torch.boosting import splice_continued
    from lightgbm_tpu_torch.model_io import load_model_string

    _, base = load_model_string(v0_text)
    _, other = load_model_string(v0_text)
    other.num_class = 2
    with pytest.raises(ValueError, match="mismatch"):
        splice_continued(base, other)
    other.num_class = base.num_class
    other.average_output = True
    with pytest.raises(ValueError, match="averaged"):
        splice_continued(base, other)
    other.average_output = False
    n = len(base.models)
    assert splice_continued(base, other) is base
    assert len(base.models) == 2 * n and base.iter_ == 2 * n


# ------------------------------------------------ the port's sequences
def _jax_sequence(d, v0_text):
    """The same sequence of microbatches through the JAX package's loop:
    its verdicts."""
    loop = on_j.OnlineLoop(_params(d), _xy(9, 200), initial_model=v0_text)
    out = []
    for seed, kind, n in ((41, "nan", 80), (42, "flip", 80),
                          (43, "clean", 160)):
        rows, labels = _batch(seed, n)
        labels = {"nan": [float("nan")] * n,
                  "flip": [1.0 - v for v in labels]}.get(kind, labels)
        loop.spool.append(rows, labels)
        out.append(loop.cycle())
    return out


def test_poison_reject_promote_under_scoring(tmp_path, v0_text):
    """NaN labels roll back, flipped labels are rejected, a clean batch
    promotes, as in the JAX package on the same batches (an 80-row clean
    batch does not lift this holdout's AUC in either package: both
    reject it); every batch arrives through the serving ingest op, two
    threads score through the registry while the promotion swaps it
    (each answer v0's or v1's, none torn), and the offset moves past
    every verdict."""
    assert _jax_sequence(tmp_path / "jax", v0_text) == [
        "rolled_back", "rejected", "promoted"]
    loop = _port_loop(tmp_path / "loop", v0_text)
    reg = ModelRegistry(device="cpu", warmup=True, buckets=(16, 64))
    loop.attach(reg)
    assert reg.ingest_sink is loop.spool and reg.health_probe == loop.health

    def ingest(rows, labels):
        r = handle_request(reg, {"op": "ingest", "rows": rows,
                                 "labels": labels})
        assert r["ok"], r

    rows, labels = _batch(41, 80)
    ingest(rows, [float("nan")] * len(labels))
    assert loop.cycle() == "rolled_back"
    assert loop.state["version"] == 0
    assert loop.state["ingest_offset"] == loop.spool.size()
    rows, labels = _batch(42, 80)
    ingest(rows, [1.0 - v for v in labels])
    assert loop.cycle() == "rejected"
    ingest(*_batch(43, 160))

    probe = _xy(9, 200)[0][:16]
    v0 = lgb_t.Booster(model_str=v0_text)
    pred_v0 = v0.predict(probe)
    stop, seen, errs = threading.Event(), [], []

    def scorer():
        try:
            while not stop.is_set():
                seen.append(np.asarray(reg.predict("default", probe)))
        except Exception as e:  # noqa: BLE001 — shown below
            errs.append(e)

    ths = [threading.Thread(target=scorer) for _ in range(2)]
    for t in ths:
        t.start()
    try:
        assert loop.cycle() == "promoted"
    finally:
        stop.set()
        for t in ths:
            t.join(timeout=30)
    assert not errs and seen
    st = on_t.load_state(on_t.state_path(loop.loop_dir))
    assert st["version"] == 1 and st["counts"] == {
        "promoted": 1, "rejected": 1, "rolled_back": 1}
    v1 = lgb_t.Booster(model_file=st["model_path"])
    pred_v1 = v1.predict(probe)
    torn = [p for p in seen
            if not (np.allclose(p, pred_v0, rtol=1e-5, atol=1e-6)
                    or np.allclose(p, pred_v1, rtol=1e-5, atol=1e-6))]
    assert not torn
    np.testing.assert_allclose(reg.predict("default", probe), pred_v1,
                               rtol=1e-5, atol=1e-6)
    h = loop.health()
    assert h["loop"]["version"] == 1 and h["loop"]["spool_backlog_bytes"] == 0
    ingest(*_batch(44, 8))
    assert loop.cycle() is None  # under loop_min_rows: no verdict
    # run(): the backlog is under loop_min_rows, so one poll and a stop
    loop.stop_event.set()
    assert loop.run(max_cycles=1) == 0


def test_fault_matrix_inprocess(tmp_path, v0_text):
    """A raise at each loop_* site leaves a restart serving v0 (state
    untouched, the spool replayable); the cycle then replays and
    promotes with the refit's bytes of the uninterrupted run."""
    d = tmp_path / "loop"
    loop = _port_loop(d, v0_text)
    for seed in (51, 52):
        loop.spool.append(*_batch(seed, 40))
    probe = _xy(9, 200)[0][:8]
    pred_v0 = lgb_t.Booster(model_str=v0_text).predict(probe)
    params = {**_params(d), "device_type": "cpu"}
    for site in ("loop_ingest", "loop_refit", "loop_eval", "loop_promote"):
        plan = f"{site}:0:raise"
        fi_t.configure(plan)
        crash = on_t.OnlineLoop(dict(params, fault_plan=plan), _xy(9, 200),
                                device="cpu")
        with pytest.raises(InjectedFault):
            crash.cycle()
        fi_t.disarm()
        re = on_t.OnlineLoop(params, _xy(9, 200), device="cpu")
        assert re.state["version"] == 0, site
        assert re.state["ingest_offset"] == 0, site
        reg = ModelRegistry(device="cpu")
        re.attach(reg)
        np.testing.assert_allclose(reg.predict("default", probe), pred_v0,
                                   rtol=1e-5, atol=1e-6)
    # the loop_eval crash left a candidate text; the replay overwrites
    # it with the same bytes
    orphan = open(on_t.model_path(str(d), 1)).read()
    done = on_t.OnlineLoop(params, _xy(9, 200), device="cpu")
    assert done.cycle() == "promoted"
    assert open(on_t.model_path(str(d), 1)).read() == orphan
    assert done.state["version"] == 1


# ------------------------------------------------------ task=loop, stdio
class _Requests(io.StringIO):
    """stdin for ScoringServer: the ingest lines, then (once the loop's
    state records a verdict) a models request and quit."""

    def __init__(self, lines, state_file, timeout=120.0):
        super().__init__()
        self._lines, self._state, self._timeout = lines, state_file, timeout

    def __iter__(self):
        yield from self._lines
        t0 = time.monotonic()
        while time.monotonic() - t0 < self._timeout:
            if os.path.exists(self._state) and json.load(
                    open(self._state))["cycle"] >= 1:
                break
            time.sleep(0.05)
        yield json.dumps({"op": "models"})
        yield json.dumps({"op": "quit"})


def test_cli_task_loop_stdio(tmp_path, v0_text, monkeypatch, capsys):
    from lightgbm_tpu_torch.cli import main as main_t

    Xh, yh = _xy(9, 200)
    np.savetxt(tmp_path / "holdout.tsv", np.column_stack([yh, Xh]),
               delimiter="\t", fmt="%.17g")
    (tmp_path / "v0.txt").write_text(v0_text)
    # the clean batch the poison test promotes, in two requests
    rows, labels = _batch(43, 160)
    lines = [json.dumps({"op": "ingest", "rows": rows[i:i + 80],
                         "labels": labels[i:i + 80]}) for i in (0, 80)]
    loop_dir = tmp_path / "loop"
    monkeypatch.setattr("sys.stdin", _Requests(
        lines, str(loop_dir / "loop_state.json")))
    # both requests land before the loop sees loop_min_rows new rows
    args = [f"{k}={v}" for k, v in _params(loop_dir,
                                             loop_min_rows=160).items()]
    assert main_t(["task=loop", "device_type=cpu",
                   f"valid_data={tmp_path / 'holdout.tsv'}",
                   f"input_model={tmp_path / 'v0.txt'}", *args]) == 0
    out = capsys.readouterr().out.splitlines()
    assert all(line.startswith("{") for line in out)
    resp = [json.loads(line) for line in out]
    assert [r["ok"] for r in resp] == [True] * 4 and resp[-1]["quit"]
    assert resp[2]["models"]["default"]["active"] == 2
    st = on_t.load_state(on_t.state_path(str(loop_dir)))
    assert st["last_outcome"] == "promoted" and st["version"] == 1
