"""The command line of lightgbm_tpu_torch (cli.py, __main__.py) against the
JAX package's (lightgbm_tpu/cli.py) on the same conf files and seeded
data, with JAX on the CPU.

- parse_kv_args layers command-line pairs over a conf file as the JAX
  package's does;
- task=train on a conf file in LightGBM's own format (text data, a
  validation file, sidecar weights): the same trees as the JAX CLI (pins
  tpu_growth_mode=rounds and tpu_hist_dtype=int16 in the conf), and
  task=predict's output file within the parity tolerance of the JAX
  CLI's and equal to Booster.predict's; task=predict asks for the
  card unless device_type=cpu;
- task=save_binary, then task=train from the .bin: the model trained
  from the text file;
- task=convert_model writes the JAX package's C++ byte for byte, and it
  compiles to the booster's raw scores;
- task=refit: the JAX CLI's leaf values within the parity tolerance;
- task=serve over stdio answers as Booster.predict does;
- task=gateway and task=loop refuse a call without their required keys
  as the JAX CLI does (test_torch_online.py and test_torch_gateway.py
  drive them); profile_dir and run_manifest write their files.
"""

import ctypes
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest

import lightgbm_tpu as lgb_j
import lightgbm_tpu_torch as lgb_t
from lightgbm_tpu.cli import main as main_j, parse_kv_args as kv_j
from lightgbm_tpu.log import LightGBMError as LightGBMErrorJ
from lightgbm_tpu_torch.cli import main as main_t, parse_kv_args as kv_t
from test_torch_sampling import assert_same_sampled_models
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

CONF = """# LightGBM's own format: key = value, comments, blank lines
task = train
objective = binary
boosting_type = gbdt
data = train.tsv
valid_data = valid.tsv
num_trees = 6
num_leaves = 15
min_data_in_leaf = 5
learning_rate = 0.2
metric = auc,binary_logloss
is_training_metric = true
output_model = model.txt
verbosity = -1

tpu_growth_mode = rounds
tpu_hist_dtype = int16
"""


@pytest.fixture
def work(tmp_path):
    """train.tsv (with a .weight sidecar), valid.tsv and train.conf in a
    directory of each package, as the reference's examples lay them out."""
    rs = np.random.RandomState(5)
    X = rs.randn(700, 6)
    X[rs.rand(700, 6) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rs.randn(6) + 0.3 * rs.randn(700)) > 0
         ).astype(float)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        np.savetxt(tmp_path / d / "train.tsv",
                   np.column_stack([y[:500], X[:500]]), delimiter="\t",
                   fmt="%.17g")
        np.savetxt(tmp_path / d / "train.tsv.weight",
                   np.linspace(0.5, 1.5, 500), fmt="%.17g")
        np.savetxt(tmp_path / d / "valid.tsv",
                   np.column_stack([y[500:], X[500:]]), delimiter="\t",
                   fmt="%.17g")
        (tmp_path / d / "train.conf").write_text(CONF)
    return tmp_path, X, y


def _in(d, main, args):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        return main(args)
    finally:
        os.chdir(cwd)


def test_parse_kv_args_layering(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text("num_leaves = 31  # comment\n# a comment line\n"
                    "metric = auc\nlearning_rate=0.2\nx = \"q\"\n")
    args = [f"config={conf}", "num_leaves=7", "task=train"]
    got = kv_t(args)
    assert got == kv_j(args)
    assert got["num_leaves"] == "7" and got["x"] == "q"
    assert "config" not in got


def test_train_predict_match_jax_cli(work):
    tmp, X, y = work
    assert _in(tmp / "jax", main_j, ["config=train.conf"]) == 0
    assert _in(tmp / "port", main_t, ["config=train.conf",
                                      "device_type=cpu"]) == 0
    bj = lgb_j.Booster(model_file=str(tmp / "jax" / "model.txt"))
    bt = lgb_t.Booster(model_file=str(tmp / "port" / "model.txt"))
    assert bt.num_trees() == bj.num_trees() == 6
    assert_same_sampled_models(bj, bt, X[:500], X[500:])
    for d, main, extra in (("jax", main_j, []),
                           ("port", main_t, ["device_type=cpu"])):
        assert _in(tmp / d, main, [
            "task=predict", "data=valid.tsv", "input_model=model.txt",
            "output_result=pred.txt", *extra]) == 0
    pj = np.loadtxt(tmp / "jax" / "pred.txt")
    pt = np.loadtxt(tmp / "port" / "pred.txt")
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt, bt.predict(X[500:]), rtol=1e-8,
                               atol=1e-9)


@pytest.mark.parametrize("device_type,want", [("", "cuda"),
                                               ("cpu", None)])
def test_predict_runs_on_the_card_unless_cpu(work, monkeypatch, device_type,
                                             want):
    """task=predict asks Booster.predict for the card's tensorized forest
    unless device_type=cpu (the host walker); without a card the default
    raises rather than answering on the host."""
    tmp, X, y = work
    assert _in(tmp / "port", main_t, ["config=train.conf",
                                      "device_type=cpu"]) == 0
    seen = []
    real = lgb_t.Booster.predict

    def spy(self, data, *a, device=None, **k):
        seen.append(device)
        return real(self, data, *a, **k)  # answered on the host here

    monkeypatch.setattr(lgb_t.Booster, "predict", spy)
    args = ["task=predict", "data=valid.tsv", "input_model=model.txt",
            "output_result=pred.txt"]
    if device_type:
        args.append(f"device_type={device_type}")
    assert _in(tmp / "port", main_t, args) == 0
    assert seen == [want]
    monkeypatch.setattr(lgb_t.Booster, "predict", real)
    if want is not None:
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        with pytest.raises(RuntimeError):
            _in(tmp / "port", main_t, args)


def test_save_binary_then_train(work):
    tmp, X, y = work
    d = tmp / "port"
    assert _in(d, main_t, ["task=save_binary", "data=train.tsv",
                           "output_model=train.bin", "device_type=cpu"]) == 0
    assert _in(d, main_t, ["task=save_binary", "data=valid.tsv",
                           "output_model=valid.bin", "device_type=cpu"]) == 0
    assert _in(d, main_t, ["config=train.conf", "device_type=cpu",
                           "valid_data=", "output_model=from_text.txt"]) == 0
    assert _in(d, main_t, ["config=train.conf", "device_type=cpu",
                           "data=train.bin", "valid_data=",
                           "output_model=from_bin.txt"]) == 0
    a = (d / "from_text.txt").read_text().split("parameters:")[0]
    b = (d / "from_bin.txt").read_text().split("parameters:")[0]
    assert a == b


def test_convert_model_matches_jax_and_compiles(work):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    tmp, X, y = work
    assert _in(tmp / "jax", main_j, ["config=train.conf"]) == 0
    for d, main in (("jax", main_j), ("port", main_t)):
        assert _in(tmp / d, main, [
            "task=convert_model", f"input_model={tmp / 'jax' / 'model.txt'}",
            "convert_model=pred.cpp"]) == 0
    src = (tmp / "port" / "pred.cpp").read_text()
    assert src == (tmp / "jax" / "pred.cpp").read_text()
    so = tmp / "port" / "pred.so"
    subprocess.run(["g++", "-O1", "-shared", "-fPIC",
                    str(tmp / "port" / "pred.cpp"), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    P = ctypes.POINTER(ctypes.c_double)
    lib.Predict.argtypes = [P, P]
    bt = lgb_t.Booster(model_file=str(tmp / "jax" / "model.txt"))
    want = bt.predict(X[:30], raw_score=True)
    got = np.zeros(30)
    for i in range(30):
        row = np.ascontiguousarray(X[i], dtype=np.float64)
        out = (ctypes.c_double * 1)()
        lib.Predict(row.ctypes.data_as(P), out)
        got[i] = out[0]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_refit_matches_jax_cli(work):
    tmp, X, y = work
    assert _in(tmp / "jax", main_j, ["config=train.conf"]) == 0
    shutil.copy(tmp / "jax" / "model.txt", tmp / "port" / "model.txt")
    for d, main in (("jax", main_j), ("port", main_t)):
        extra = ["device_type=cpu"] if main is main_t else []
        assert _in(tmp / d, main, [
            "task=refit", "data=valid.tsv", "input_model=model.txt",
            "output_model=refit.txt", "verbosity=-1", *extra]) == 0
    mj = lgb_j.Booster(model_file=str(tmp / "jax" / "refit.txt"))._gbdt.models
    mt = lgb_t.Booster(model_file=str(tmp / "port" / "refit.txt")
                       )._gbdt.models
    assert len(mj) == len(mt) == 6
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)


def test_serve_stdio(work, monkeypatch, capsys):
    tmp, X, y = work
    d = tmp / "port"
    assert _in(d, main_t, ["config=train.conf", "device_type=cpu"]) == 0
    capsys.readouterr()
    bst = lgb_t.Booster(model_file=str(d / "model.txt"))
    reqs = [{"op": "ping"}, {"op": "score", "rows": X[:3].tolist()},
            {"op": "models"}, {"op": "quit"}]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "\n".join(json.dumps(r) for r in reqs)))
    assert main_t(["task=serve", f"input_model={d / 'model.txt'}",
                   "serve_buckets=8,32", "device_type=cpu",
                   "verbosity=-1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert all(line.startswith("{") for line in out)
    resp = [json.loads(line) for line in out]
    assert resp[0]["pong"] and resp[3]["quit"]
    np.testing.assert_allclose(resp[1]["pred"], bst.predict(X[:3]),
                               rtol=1e-5, atol=1e-6)
    assert resp[2]["models"]["default"]["active"] == 1


@pytest.mark.parametrize("task", ["gateway", "loop"])
def test_unported_tasks_raise(task):
    """task=gateway and task=loop are ported (they raised
    NotImplementedError until the second half of A.11): without their
    required keys each raises the JAX CLI's fatal, and no refusal."""
    need = {"gateway": "gateway_backends", "loop": "valid_data"}[task]
    with pytest.raises(lgb_t.LightGBMError, match=need):
        main_t([f"task={task}", "device_type=cpu"])
    with pytest.raises(LightGBMErrorJ, match=need):
        main_j([f"task={task}", "device_type=cpu"])


def test_profile_dir_and_manifest(work):
    tmp, X, y = work
    d = tmp / "port"
    assert _in(d, main_t, ["config=train.conf", "device_type=cpu",
                           "profile_dir=prof", "run_manifest=m.json",
                           "timetag=true", "snapshot_freq=3"]) == 0
    for f in ("trace_events.json", "trace_events.jsonl", "torch_trace.json",
              "run_manifest.json"):
        assert (d / "prof" / f).exists(), f
    m = json.loads((d / "m.json").read_text())
    assert m["schema"] == "lightgbm-tpu/run-manifest/v1"
    assert m["extra"] == {"task": "train"} and m["compile"] is None
    assert m["phase_timers"]["snapshot"]["calls"] == 2
    assert "round: fused step" in m["phase_timers"]
    spans = json.loads((d / "prof" / "trace_events.json").read_text())
    assert any(e["name"] == "round: fused step"
               for e in spans["traceEvents"])
