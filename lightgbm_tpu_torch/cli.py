"""Config-file-driven command line application.

The port of lightgbm_tpu/cli.py (reference src/main.cpp:14 +
src/application/application.cpp): ``python -m lightgbm_tpu_torch
config=train.conf [k=v ...]`` with the tasks train / predict /
save_binary / convert_model / refit (config.h:35 TaskType) and serve.
Parameter layering matches Application::LoadParameters
(application.cpp:53-89): command-line pairs first, then the ``config=``
file's lines (k = v, ``#`` comments), the FIRST occurrence of a key
winning (config.cpp KeepFirstValues). A conf file in LightGBM's own
format runs unmodified.

Every task runs on the card unless ``device_type=cpu`` is given. The
recovery keys (snapshot_freq, resume, fault_plan, record_file,
anomaly_policy, ...) reach engine.train through the params, and the
LGBMTPU_FAULT_PLAN environment variable arms a fault plan as in the JAX
package. ``profile_dir=`` records the run's timer spans (obs/tracing.py)
and a torch.profiler Chrome trace of the host and the card;
``run_manifest=`` writes the run manifest (obs/manifest.py).
``task=gateway`` fronts many ``task=serve`` HTTP backends
(serving/gateway.py; host-side, no card), and ``task=loop`` runs the
online train-and-serve loop (online/): it serves the promoted model
while each verdict cycle refits, gates and promotes on the card.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from . import log


def parse_kv_args(argv: List[str]) -> Dict[str, str]:
    """argv 'k=v' pairs + config= file lines; first occurrence wins."""
    params: Dict[str, str] = {}

    def add(k: str, v: str) -> None:
        k = k.strip()
        v = v.strip().strip('"').strip("'")
        if k and k not in params:
            params[k] = v

    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            add(k, v)
    cfg = params.get("config", "")
    if cfg:
        if not Path(cfg).exists():
            log.fatal(f"config file {cfg} does not exist")
        for line in Path(cfg).read_text().splitlines():
            if "#" in line:
                line = line[: line.index("#")]
            line = line.strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            add(k, v)
    params.pop("config", None)
    return params


def _truthy(v: Any) -> bool:
    return str(v).strip().lower() in ("true", "1", "yes", "on")


_DATA_KEYS = (
    "header", "label_column", "weight_column", "group_column",
    "ignore_column", "categorical_feature",
)


def _mappers_equal(a, b) -> bool:
    if len(a) != len(b):
        return False
    return all(
        ma.num_bin == mb.num_bin and ma.bin_type == mb.bin_type
        and ma.categories == mb.categories
        and np.array_equal(ma.upper_bounds, mb.upper_bounds)
        for ma, mb in zip(a, b))


def _read_text(params: Dict[str, str], path: str,
               categorical: bool = False) -> Dict[str, Any]:
    from .parsers import load_text_file

    return load_text_file(
        path,
        header=_truthy(params.get("header", "false")),
        label_column=params.get("label_column", 0),
        weight_column=params.get("weight_column", ""),
        group_column=params.get("group_column", ""),
        ignore_column=params.get("ignore_column", ""),
        categorical_feature=(params.get("categorical_feature", "")
                             if categorical else ""),
    )


def _load_dataset(params: Dict[str, str], path: str, reference=None):
    """A text file or a .bin cache -> a constructed Dataset."""
    from .basic import Dataset
    from .parsers import is_binary_file, load_binary

    if is_binary_file(path):
        log.info(f"Loading binary dataset cache {path}")
        binned = load_binary(path)
        if reference is not None:
            # a validation set must share the training set's bin mappers
            # (reference DatasetLoader::LoadFromFileAlignWithOtherDataset)
            reference.construct()
            if not _mappers_equal(binned.mappers, reference._binned.mappers):
                log.fatal(
                    f"binary cache {path} was binned with different bin "
                    "mappers than the training data; rebuild it with "
                    "task=save_binary against this training set")
        return Dataset.from_binned(binned)
    loaded = _read_text(params, path, categorical=True)
    train_params = {k: v for k, v in params.items() if k not in _DATA_KEYS}
    return Dataset(
        loaded["X"], label=loaded["label"], weight=loaded["weight"],
        group=loaded["group"], init_score=loaded["init_score"],
        feature_name=loaded["feature_names"] or "auto",
        categorical_feature=loaded["categorical_feature"] or "auto",
        params=train_params, reference=reference, free_raw_data=False)


def _task_train(params: Dict[str, str]) -> None:
    from .config import Config
    from .engine import train

    data_path = params.get("data", "")
    if not data_path:
        log.fatal("No training/prediction data, application quit")
    t0 = time.time()
    ds = _load_dataset(params, data_path)
    ds.construct()
    log.info(f"Loaded {ds.num_data()} rows x {ds.num_feature()} features "
             f"from {data_path} in {time.time() - t0:.1f}s")
    if _truthy(params.get("is_save_binary_file",
                          params.get("save_binary", "false"))):
        from .parsers import save_binary

        save_binary(ds._binned, data_path + ".bin")
        log.info(f"Saved binary cache to {data_path}.bin")
    valid_sets, valid_names = [], []
    vpaths = [v for v in str(params.get("valid_data",
                                        params.get("valid", ""))).split(",")
              if v]
    for i, vp in enumerate(vpaths):
        valid_sets.append(_load_dataset(params, vp, reference=ds))
        valid_names.append(f"valid_{i + 1}")  # the reference's naming
    cfg = Config(dict(params))
    if _truthy(params.get("is_training_metric",
                          params.get("train_metric", "false"))):
        valid_sets = [ds] + valid_sets
        valid_names = ["training"] + valid_names
    booster = train(dict(params), ds, num_boost_round=cfg.num_iterations,
                    valid_sets=valid_sets, valid_names=valid_names,
                    init_model=cfg.input_model or None)
    out = params.get("output_model", "LightGBM_model.txt")
    booster.save_model(out)
    log.info(f"Finished training; model saved to {out}")


def _task_predict(params: Dict[str, str]) -> None:
    """task=predict: the tensorized forest on the card (Booster.predict
    device="cuda"; pred_contrib and pred_early_stop take the host paths
    there, with a warning), the host walker under device_type=cpu."""
    from .basic import Booster
    from .config import Config

    data_path = params.get("data", "")
    model_path = params.get("input_model", "LightGBM_model.txt")
    if not data_path:
        log.fatal("No training/prediction data, application quit")
    if not Path(model_path).exists():
        log.fatal(f"input model {model_path} does not exist")
    bst = Booster(model_file=model_path)
    loaded = _read_text(params, data_path)
    es_kwargs = {}
    if _truthy(params.get("pred_early_stop", "false")):
        es_kwargs = {
            "pred_early_stop": True,
            "pred_early_stop_freq": int(params.get("pred_early_stop_freq",
                                                   10)),
            "pred_early_stop_margin": float(
                params.get("pred_early_stop_margin", 10.0)),
        }
    on_cpu = Config(dict(params)).device_type == "cpu"
    pred = bst.predict(
        loaded["X"],
        raw_score=_truthy(params.get("predict_raw_score", "false")),
        pred_leaf=_truthy(params.get("predict_leaf_index", "false")),
        pred_contrib=_truthy(params.get("predict_contrib", "false")),
        device=None if on_cpu else "cuda", **es_kwargs)
    out = params.get("output_result", "LightGBM_predict_result.txt")
    np.savetxt(out, np.atleast_2d(pred.T).T, delimiter="\t", fmt="%.9g")
    log.info(f"Finished prediction; results saved to {out}")


def _task_save_binary(params: Dict[str, str]) -> None:
    from .parsers import save_binary

    data_path = params.get("data", "")
    if not data_path:
        log.fatal("No training/prediction data, application quit")
    ds = _load_dataset(params, data_path)
    ds.construct()
    out = params.get("output_model", data_path + ".bin")
    save_binary(ds._binned, out)
    log.info(f"Finished saving binary dataset cache to {out}")


def _task_convert_model(params: Dict[str, str]) -> None:
    """task=convert_model (application.cpp:223 ConvertModel): the model
    as if-else C++ source (cpp is the only language, as in the
    reference)."""
    from .basic import Booster
    from .model_io import model_to_if_else

    lang = params.get("convert_model_language", "cpp")
    if lang not in ("", "cpp"):
        log.fatal(f"convert_model_language={lang} is not supported "
                  "(cpp only)")
    model_path = params.get("input_model", "LightGBM_model.txt")
    if not Path(model_path).exists():
        log.fatal(f"input model {model_path} does not exist")
    bst = Booster(model_file=model_path)
    out = params.get("convert_model", "gbdt_prediction.cpp")
    Path(out).write_text(model_to_if_else(
        bst._gbdt.models, bst._gbdt.num_class,
        average_output=bool(getattr(bst._gbdt, "average_output", False))))
    log.info(f"Finished converting model to if-else code at {out}")


def _task_refit(params: Dict[str, str]) -> None:
    """task=refit (config.h:35 kRefitTree): the model's leaf values
    recomputed from new data (Booster.refit)."""
    from .basic import Booster

    data_path = params.get("data", "")
    model_path = params.get("input_model", "LightGBM_model.txt")
    if not data_path:
        log.fatal("No training/prediction data, application quit")
    if not Path(model_path).exists():
        log.fatal(f"input model {model_path} does not exist")
    bst = Booster(model_file=model_path, params=dict(params))
    loaded = _read_text(params, data_path)
    new_bst = bst.refit(loaded["X"], loaded["label"],
                        decay_rate=float(params.get("refit_decay_rate", 0.9)),
                        weight=loaded["weight"], group=loaded["group"])
    out = params.get("output_model", "LightGBM_model.txt")
    new_bst.save_model(out)
    log.info(f"Finished the refit task; new model saved to {out}")


class _StderrLogger:
    """task=serve's stdio protocol owns stdout: log lines go to stderr."""

    @staticmethod
    def info(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    warning = info


def _save_logger():
    return (log._logger, log._info_method, log._warning_method,
            log._debug_method)


def _restore_logger(saved) -> None:
    (log._logger, log._info_method, log._warning_method,
     log._debug_method) = saved



def _serve_mesh(cfg, device: str):
    """task=serve over several ranks (the JAX package's cli.py:315-321):
    num_machines > 1 joins the cluster from the network params
    (set_network), and every rank then scores its block of each
    request's rows; None on one rank."""
    from .basic import set_network
    from .parallel.multihost import world_mesh

    if cfg.num_machines > 1:
        set_network(cfg.machines, cfg.local_listen_port,
                    num_machines=cfg.num_machines,
                    machine_list_file=cfg.machine_list_filename,
                    device=device)
    mesh = world_mesh()
    if mesh is None or mesh.size < 2:
        return None
    log.info(f"serving rows sharded over {mesh.size} ranks "
             f"({mesh.backend})")
    return mesh

def _task_serve(params: Dict[str, str]) -> None:
    """task=serve: load input_model into the serving registry (or, with
    serve_fleet=true, the model fleet) and answer requests:
    line-delimited JSON over stdin / stdout with serve_port=0 (the
    default), else HTTP on that port, SIGTERM draining it. fault_plan
    arms the serve_request / device_put / fleet_page sites, and
    host_fallback=true rescores a chunk whose host-to-device copy failed
    on the host walker."""
    from .config import Config
    from .resilience import faultinject
    from .serving import ModelFleet, ModelRegistry, ScoringServer, serve_http

    t0 = time.time()
    cfg = Config(dict(params))
    model_path = params.get("input_model", "LightGBM_model.txt")
    if not Path(model_path).exists():
        log.fatal(f"input model {model_path} does not exist")
    saved = _save_logger()
    if cfg.serve_port == 0:
        # before anything can log: an info line must never land among
        # the JSON responses (restored on exit, the logger is global)
        log.register_logger(_StderrLogger)
    try:
        faultinject.configure(cfg.fault_plan)
        device = "cpu" if cfg.device_type == "cpu" else "cuda"
        mesh = _serve_mesh(cfg, device)
        common = dict(buckets=cfg.serve_buckets, warmup=cfg.serve_warmup,
                      deadline_s=cfg.serve_deadline_ms / 1000.0,
                      queue_cap=cfg.serve_queue_cap,
                      host_fallback=cfg.host_fallback, device=device,
                      mesh=mesh)
        if cfg.serve_fleet:
            registry = ModelFleet(capacity=cfg.serve_fleet_capacity,
                                  slots_per_family=cfg.serve_fleet_slots,
                                  **common)
        else:
            registry = ModelRegistry(replicas=cfg.serve_replicas, **common)
        registry.load(cfg.serve_model_name, model_path)
        if cfg.serve_port > 0:
            import signal
            import threading

            # SIGTERM drains: readiness goes false, new requests shed
            # 503, in-flight ones finish, then the process exits
            draining = threading.Event()  # lint: allow[per-call-lock] — one a process, shared with every handler thread
            httpd = serve_http(
                registry, cfg.serve_port, cfg.serve_host, block=False,
                socket_timeout_s=cfg.serve_socket_timeout_s,
                max_body_mb=cfg.serve_max_body_mb, draining=draining)

            def _drain(signum, frame):  # noqa: ARG001 — signal API
                draining.set()
                threading.Thread(target=httpd.shutdown, daemon=True).start()

            try:
                signal.signal(signal.SIGTERM, _drain)
            except ValueError:
                pass  # not the main thread (an in-process caller)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.server_close()
        else:
            n = ScoringServer(registry).serve(sys.stdin, sys.stdout)
            print(f"[serve] handled {n} requests", file=sys.stderr)
        # logged here, while stdio's reroute still holds
        log.info(f"Finished, elapsed {time.time() - t0:.2f} seconds")
    finally:
        _restore_logger(saved)


def _task_gateway(params: Dict[str, str]) -> None:
    """task=gateway: the resilient serving gateway (serving/gateway.py),
    a host-side HTTP front end over the ``task=serve`` backends named by
    ``gateway_backends=`` (comma-separated base URLs): least-outstanding
    balancing over backends passing /readyz, full-jitter retries and
    latency-triggered hedges for idempotent ops, per-backend circuit
    breakers, deadline propagation, and a SIGTERM drain. ``GET
    /metrics`` serves the merged exposition of the gateway and every
    live backend."""
    import signal
    import threading

    from .config import Config
    from .resilience import faultinject
    from .serving.gateway import Gateway, gateway_http

    t0 = time.time()
    cfg = Config(dict(params))
    # a fault plan arms the gw_* sites before any request flows
    faultinject.configure(cfg.fault_plan)
    urls = [u.strip() for u in str(cfg.gateway_backends).split(",")
            if u.strip()]
    if not urls:
        log.fatal("task=gateway needs gateway_backends= "
                  "(comma-separated backend base URLs)")
    gw = Gateway(
        urls,
        retries=cfg.gateway_retries,
        backoff_base_s=cfg.gateway_backoff_base_s,
        hedge_quantile=cfg.gateway_hedge_quantile,
        hedge_budget=cfg.gateway_hedge_budget,
        breaker_failures=cfg.gateway_breaker_failures,
        breaker_cooldown_s=cfg.gateway_breaker_cooldown_s,
        default_deadline_ms=cfg.gateway_deadline_ms,
        health_interval_s=cfg.gateway_health_interval_s,
        attempt_timeout_s=cfg.serve_socket_timeout_s,
    )
    gw.start()
    httpd = gateway_http(
        gw, cfg.gateway_port, cfg.gateway_host, block=False,
        max_body_mb=cfg.serve_max_body_mb,
        socket_timeout_s=cfg.serve_socket_timeout_s)

    def _drain(signum, frame):  # noqa: ARG001 — signal API
        def _go() -> None:
            # readiness off and new work shed, the requests in flight
            # finished, then the listener stops
            gw.drain(cfg.gateway_drain_timeout_s)
            httpd.shutdown()

        threading.Thread(target=_go, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _drain)
    except ValueError:
        pass  # not the main thread (an in-process caller)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()
        httpd.server_close()
    log.info(f"Finished, elapsed {time.time() - t0:.2f} seconds")


def _task_loop(params: Dict[str, str]) -> None:
    """task=loop: the online train-and-serve loop (online/). Serves the
    promoted model on the configured transport (HTTP on serve_port,
    else JSON lines over stdin / stdout) while verdict cycles refit,
    gate and promote from the microbatches the ``ingest`` op spools.
    ``valid_data=`` names the holdout shard the gate judges on; v0 comes
    from ``input_model=`` when that file exists, else it is trained from
    ``data=``; a loop_dir that already holds state resumes from it."""
    import threading

    from .config import Config
    from .online import OnlineLoop, state_path
    from .parsers import load_text_file
    from .resilience import faultinject
    from .serving import ModelRegistry, ScoringServer, serve_http

    t0 = time.time()
    cfg = Config(dict(params))
    saved = _save_logger()
    if cfg.serve_port == 0:
        # stdio: the JSON-lines protocol owns stdout to EOF, so every log
        # line goes to stderr from the start (restored on exit)
        log.register_logger(_StderrLogger)
    try:
        # a fault plan arms the loop_* / serve_request sites first
        faultinject.configure(cfg.fault_plan)
        device = "cpu" if cfg.device_type == "cpu" else "cuda"
        vpath = str(params.get("valid_data", params.get("valid", ""))
                    ).split(",")[0]
        if not vpath:
            log.fatal("task=loop needs valid_data= (the holdout shard the "
                      "promotion gate judges on)")
        loaded = load_text_file(
            vpath,
            header=_truthy(params.get("header", "false")),
            label_column=params.get("label_column", 0),
            weight_column=params.get("weight_column", ""),
            group_column=params.get("group_column", ""),
            ignore_column=params.get("ignore_column", ""),
            categorical_feature=params.get("categorical_feature", ""),
        )
        holdout = (loaded["X"], loaded["label"], loaded["weight"])

        init_model = None
        if not Path(state_path(cfg.loop_dir)).exists():
            model_path = params.get("input_model", "")
            if model_path and Path(model_path).exists():
                init_model = model_path
            elif params.get("data"):
                from .engine import train

                ds = _load_dataset(params, params["data"])
                log.info(f"task=loop: training v0 from {params['data']}")
                init_model = train(dict(params), ds,
                                   num_boost_round=cfg.num_iterations)
            else:
                log.fatal("task=loop needs input_model= or data= to seed "
                          "v0 (or an existing loop_dir to resume)")

        loop = OnlineLoop(dict(params), holdout, initial_model=init_model,
                          device=device)
        registry = ModelRegistry(
            buckets=cfg.serve_buckets, warmup=cfg.serve_warmup,
            deadline_s=cfg.serve_deadline_ms / 1000.0,
            queue_cap=cfg.serve_queue_cap, replicas=cfg.serve_replicas,
            device=device,
        )
        loop.attach(registry, cfg.serve_model_name)

        if cfg.serve_port > 0:
            httpd = serve_http(registry, cfg.serve_port, cfg.serve_host,
                               block=False)
            server_thread = threading.Thread(
                target=httpd.serve_forever, name="lgb-loop-http",
                daemon=True)
            server_thread.start()
            try:
                n = loop.run()
                log.info(f"task=loop: {n} verdict cycle(s) complete")
            finally:
                httpd.shutdown()
                httpd.server_close()
        else:
            # the loop runs on its own thread and stops when the request
            # stream ends
            loop_thread = threading.Thread(
                target=loop.run, name="lgb-online-loop", daemon=True)
            loop_thread.start()
            n = ScoringServer(registry).serve(sys.stdin, sys.stdout)
            loop.stop_event.set()
            loop_thread.join(timeout=60.0)
            print(f"[loop] handled {n} requests", file=sys.stderr)
        # logged here, while stdio's reroute still holds
        log.info(f"Finished, elapsed {time.time() - t0:.2f} seconds")
    finally:
        _restore_logger(saved)


# tasks that log their own summary (serve and loop while stdio's
# reroute still holds)
_LOGS_OWN_SUMMARY = ("serve", "gateway", "loop")

_TASKS = {
    "train": _task_train,
    "predict": _task_predict, "prediction": _task_predict,
    "test": _task_predict,
    "save_binary": _task_save_binary,
    "convert_model": _task_convert_model,
    "refit": _task_refit, "refit_tree": _task_refit,
    "serve": _task_serve,
    "gateway": _task_gateway,
    "loop": _task_loop,
}


def _start_profile(profile_dir: str):
    """Span tracing and a torch.profiler session over the task."""
    import torch

    from .obs import tracing

    os.makedirs(profile_dir, exist_ok=True)
    rec = tracing.start_tracing()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — the span trace still works
        log.warning(f"torch.profiler trace capture unavailable: {e}")
        prof = None
    return rec, prof


def _export(task: str, params: Dict[str, str], profile_dir: str,
            manifest_path: str, rec, prof) -> None:
    """Write the traces and the manifest; an export failure is a warning,
    never the task's error."""
    from .obs import tracing

    if profile_dir:
        tracing.stop_tracing()
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(
                    os.path.join(profile_dir, "torch_trace.json"))
            except Exception as e:  # noqa: BLE001
                log.warning(f"torch.profiler export failed: {e}")
        if rec is not None:
            try:
                rec.write_chrome(os.path.join(profile_dir,
                                              "trace_events.json"))
                rec.write_jsonl(os.path.join(profile_dir,
                                             "trace_events.jsonl"))
            except OSError as e:
                log.warning(f"trace export failed: {e}")
    targets = [p for p in (
        manifest_path,
        os.path.join(profile_dir, "run_manifest.json") if profile_dir else "",
    ) if p]
    if not targets:
        return
    try:
        from .config import Config
        from .obs.manifest import write_manifest

        cfg = Config(dict(params))
        for p in targets:
            write_manifest(p, config=cfg, extra={"task": task})
    except Exception as e:  # noqa: BLE001 — incl. config fatals
        log.warning(f"run manifest not written: {e}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    params = parse_kv_args(argv)
    if not params:
        print("usage: python -m lightgbm_tpu_torch config=<file> "
              "[key=value ...]\ntasks: train (default), predict, "
              "save_binary, convert_model, refit, serve, gateway, loop",
              file=sys.stderr)
        return 1
    task = params.get("task", "train")
    if task not in _TASKS:
        log.fatal(f"Unknown task {task}")
    if _truthy(params.get("timetag", "")):
        from .timer import enable_timetag

        enable_timetag()
    profile_dir = str(params.get("profile_dir", "")).strip()
    manifest_path = str(params.get("run_manifest",
                                   params.get("manifest_file", ""))).strip()
    rec = prof = None
    if profile_dir:
        rec, prof = _start_profile(profile_dir)
    t0 = time.time()
    try:
        _TASKS[task](params)
        if task not in _LOGS_OWN_SUMMARY:
            log.info(f"Finished, elapsed {time.time() - t0:.2f} seconds")
        return 0
    finally:
        if profile_dir or manifest_path:
            # after task=serve stdio owns stdout to EOF: export lines go
            # to stderr
            saved = _save_logger()
            if task in ("serve", "loop"):
                log.register_logger(_StderrLogger)
            try:
                _export(task, params, profile_dir, manifest_path, rec, prof)
            finally:
                _restore_logger(saved)


if __name__ == "__main__":
    sys.exit(main())
