"""Multi-machine training (the reference's distributed runtime).

The port of lightgbm_tpu/parallel/multihost.py. The reference runs one
process per machine joined by its socket / MPI collective layer
(src/network/linkers_socket.cpp); the JAX package joins one process per
host with jax.distributed.initialize. Here one process per device joins
a torch.distributed process group over TCP, the first machine of the
list hosting its store: NCCL on the card, gloo on the CPU.

- init_distributed(...): the reference's network params (`machines` /
  `machine_list_filename` / `num_machines` / `local_listen_port`, python
  `lgb.set_network`) -> init_process_group, with the same retry as the
  JAX package (resilience/backoff.py);
- gather_host_rows / allgather_binning_sample: the reference's
  distributed binning (dataset_loader.cpp:1174): every rank's binning
  sample concatenated in rank order, so every rank builds identical bin
  mappers;
- host_global_array: every rank's rows of a per-rank array, on every
  rank;
- write_metrics_snapshot / merged_fleet_snapshot: per-rank metric files
  merged host-side (obs/aggregate.py), no collective;
- run_distributed: the one-call trainer (pre_partition=true: X / y are
  this rank's rows).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .comm import Mesh


def resolve_rank(machines: Sequence[str], local_listen_port: int) -> int:
    """This process's rank: the RANK environment variable (torchrun's)
    when set, else the first machine entry that matches a local address
    and the listen port (the reference matches local IPs against the
    machine list, linkers_socket.cpp:38-49)."""
    import socket

    env = os.environ.get("RANK")
    if env is not None:
        return int(env)
    local_names = {socket.gethostname(), "localhost", "127.0.0.1"}
    try:
        local_names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    for i, m in enumerate(machines):
        host, _, port = m.partition(":")
        if host in local_names and (not port or int(port) == local_listen_port):
            return i
    raise RuntimeError(
        "cannot determine this process's rank: no machine entry matches a "
        "local address; set RANK or pass machine_rank"
    )


def default_backend(device=None) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    if device is not None and torch.device(device).type == "cuda":
        return "nccl"
    return "gloo"


def init_distributed(
    machines: Optional[str] = None,
    machine_list_file: Optional[str] = None,
    num_machines: Optional[int] = None,
    local_listen_port: int = 12400,
    machine_rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    init_method: Optional[str] = None,
    timeout_s: float = 600.0,
) -> int:
    """Join the cluster from reference-style network params; returns this
    process's rank. A no-op when the process group already exists.

    The first machine of the list hosts the TCP store (the reference's
    socket mesh is symmetric; rank 0 is the canonical choice). With no
    machine list, torchrun's environment (MASTER_ADDR / MASTER_PORT /
    RANK / WORLD_SIZE) is used. init_method overrides both (a
    `file://` path gives a store on a shared file system, which the
    tests use). backend: gloo or nccl, else NCCL for a CUDA device and
    gloo otherwise; never switched afterwards."""
    if dist.is_initialized():
        return dist.get_rank()
    import datetime

    from ..resilience.backoff import retry_call

    mlist = []
    if machine_list_file:
        with open(machine_list_file) as f:
            mlist = [ln.strip() for ln in f if ln.strip()]
    elif machines:
        mlist = [m.strip() for m in str(machines).split(",") if m.strip()]
    if init_method is None and not mlist:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("init_distributed needs machines, "
                             "machine_list_file, init_method or torchrun's "
                             "environment")
        init_method = "env://"
    if init_method == "env://":
        n = int(num_machines or os.environ["WORLD_SIZE"])
        rank = (machine_rank if machine_rank is not None
                else int(os.environ["RANK"]))
    else:
        n = int(num_machines or len(mlist))
        rank = (machine_rank if machine_rank is not None
                else resolve_rank(mlist, local_listen_port))
        if init_method is None:
            coord = mlist[0]
            host, _, port = coord.partition(":")
            init_method = f"tcp://{host}:{port or local_listen_port}"
    be = backend or default_backend(device)
    if be == "nccl":
        # one card a rank: the device's index, else torchrun's
        # LOCAL_RANK, else the current device
        d = torch.device(device if device is not None else "cuda")
        torch.cuda.set_device(d.index if d.index is not None else int(
            os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
    # the store's first contact races rank 0's start: a bounded retry
    # with backoff instead of failing the cluster on a few seconds' skew
    retry_call(
        lambda: dist.init_process_group(
            be, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s)),
        retries=3,
        base_s=1.0,
        retry_on=(OSError, RuntimeError),
        describe=f"init_process_group({init_method}, rank {rank} of {n})",
    )
    return rank


def free_distributed() -> None:
    """Leave the cluster (Booster.free_network)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_mesh(axis_name: str = "data") -> Optional[Mesh]:
    """A Mesh over the world group on this rank's device (the current
    CUDA device under NCCL, the CPU under gloo), or None without a
    process group."""
    if not dist.is_initialized():
        return None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if str(dist.get_backend()) == "nccl" else torch.device("cpu"))
    return Mesh(None, axis_name, dev)


def gather_host_rows(arr: np.ndarray) -> np.ndarray:
    """Every rank's host array (1-D or row-major N-D) with uneven leading
    lengths, concatenated in rank order on every rank (global
    init-score statistics and the distributed binning sample)."""
    mesh = world_mesh()
    if mesh is None or mesh.size == 1:
        return np.asarray(arr)
    return mesh.gather_rows(np.asarray(arr))


def allgather_binning_sample(sample: np.ndarray) -> np.ndarray:
    """Concatenate every rank's binning sample (rows) so all ranks derive
    identical BinMappers (dataset_loader.cpp:1174-1250)."""
    return gather_host_rows(sample)


def host_global_array(a) -> np.ndarray:
    """Every rank's rows of a per-rank array (a tensor or array whose
    leading axis is this rank's rows), in rank order, on every rank."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return gather_host_rows(np.asarray(a))


def write_metrics_snapshot(out_dir: str) -> str:
    """Dump this process's metrics registry as a snapshot file in a
    shared directory (obs/aggregate.py schema). Host I/O only, no
    collective: fleet observability keeps working when the training
    fabric is what broke."""
    from ..obs import aggregate

    os.makedirs(out_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(out_dir, f"metrics_rank{rank:05d}.json")
    aggregate.write_snapshot(path, process=rank)
    return path


def merged_fleet_snapshot(out_dir: str):
    """Merge every worker's snapshot file under out_dir into one fleet
    view (counters sum across processes; gauges sum with min/max spread
    — obs/aggregate.py). Any process can call it; it reads only files."""
    import glob

    from ..obs import aggregate

    paths = glob.glob(os.path.join(out_dir, "metrics_rank*.json"))
    if not paths:
        raise FileNotFoundError(
            f"no metrics_rank*.json snapshots under {out_dir}; call "
            "write_metrics_snapshot on each worker first"
        )
    return aggregate.merge_files(paths)


def binning_sample(X: np.ndarray, params: dict, n_ranks: int) -> np.ndarray:
    """One rank's share of the distributed binning sample: up to
    bin_construct_sample_cnt / n_ranks of its rows, drawn with
    data_random_seed (all of them when it holds fewer), float64."""
    sample_cnt = int(params.get("bin_construct_sample_cnt", 200000))
    per_rank = max(1, sample_cnt // max(int(n_ranks), 1))
    X = np.asarray(X)
    if len(X) > per_rank:
        rs = np.random.RandomState(int(params.get("data_random_seed", 1)))
        idx = np.sort(rs.choice(len(X), per_rank, replace=False))
        return np.ascontiguousarray(X[idx], dtype=np.float64)
    return np.ascontiguousarray(X, dtype=np.float64)


def reference_dataset(sample: np.ndarray, params: dict):
    """A Dataset binned on the whole distributed sample: the bin mappers
    every rank shares (its rows binned with reference= to it)."""
    from ..basic import Dataset

    ref = Dataset(
        sample, label=np.zeros(len(sample)),
        params={k: v for k, v in params.items()
                if k not in ("tree_learner", "num_machines")},
        free_raw_data=True)
    ref.construct()
    return ref


def bin_reference(X: np.ndarray, params: dict):
    """The reference's distributed binning (dataset_loader.cpp:1174):
    every rank's binning_sample, gathered in rank order, binned into one
    reference_dataset on every rank."""
    n_ranks = dist.get_world_size() if dist.is_initialized() else 1
    return reference_dataset(
        allgather_binning_sample(binning_sample(X, params, n_ranks)), params)


def run_distributed(
    params: dict,
    X: np.ndarray,
    y: np.ndarray,
    *,
    machines: Optional[str] = None,
    machine_list_file: Optional[str] = None,
    machine_rank: Optional[int] = None,
    num_machines: Optional[int] = None,
    local_listen_port: int = 12400,
    num_boost_round: int = 100,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    valid: Optional[tuple] = None,  # (Xv, yv): this rank's validation rows
    callbacks: Optional[list] = None,
    obs_snapshot_dir: Optional[str] = None,  # shared dir for fleet metrics
    init_method: Optional[str] = None,
):
    """One-call multi-machine training (the python package's dask.py:415
    `_train`): join the cluster from reference-style network params,
    build identical bin mappers on every rank from the gathered binning
    sample, and run lgb.train(tree_learner=data) over every rank.

    X / y are THIS rank's rows (pre_partition=true). Returns the
    Booster, identical on every rank (the lockstep guarantee); save it
    from rank 0."""
    from .. import engine, log
    from ..basic import Dataset

    dev = params.get("device_type", params.get("device"))
    rank = init_distributed(
        machines=machines, machine_list_file=machine_list_file,
        num_machines=num_machines, local_listen_port=local_listen_port,
        machine_rank=machine_rank, init_method=init_method,
        device="cuda" if dev in (None, "cuda", "gpu") else None,
    )
    n_ranks = dist.get_world_size()
    params = dict(params)
    params.setdefault("tree_learner", "data")
    params["num_machines"] = n_ranks
    bin_ref = bin_reference(X, params)
    ds = Dataset(X, label=y, weight=weight, group=group, reference=bin_ref,
                 free_raw_data=False)
    ds.construct()

    valid_sets = valid_names = None
    if valid is not None:
        # every rank evaluates the FULL validation set (the ranks' rows
        # gathered), so metrics and early stopping agree across ranks
        Xv = allgather_binning_sample(
            np.ascontiguousarray(valid[0], dtype=np.float64))
        yv = gather_host_rows(np.asarray(valid[1], dtype=np.float64))
        valid_sets = [Dataset(Xv, label=yv, reference=bin_ref,
                              free_raw_data=False)]
        valid_names = ["valid"]

    heartbeat = None
    if obs_snapshot_dir:
        # per-worker liveness files beside the metrics snapshots: a rank
        # that dies mid-train stops beating, and rank 0's health report
        # names it, with no collective
        from ..resilience.heartbeat import HeartbeatWriter

        heartbeat = HeartbeatWriter(obs_snapshot_dir, rank)
        heartbeat.start()
    try:
        bst = engine.train(params, ds, num_boost_round=num_boost_round,
                           valid_sets=valid_sets, valid_names=valid_names,
                           callbacks=callbacks)
    finally:
        if heartbeat is not None:
            heartbeat.stop()
    bst._distributed_rank = rank
    if obs_snapshot_dir:
        write_metrics_snapshot(obs_snapshot_dir)
        if rank == 0:
            from ..resilience.heartbeat import health_report

            merged = merged_fleet_snapshot(obs_snapshot_dir)
            bst._fleet_metrics = merged
            health = health_report(obs_snapshot_dir, expected=n_ranks)
            bst._fleet_health = health
            if not health["healthy"]:
                log.warning(
                    f"fleet health: stale rank(s) {health['stale']}, "
                    f"missing rank(s) {health['missing']} — a worker "
                    "likely died mid-train; restart the fleet with "
                    "resume=auto to continue from the last checkpoint")
            n = merged.get("processes", 0)
            if n < n_ranks:
                log.warning(
                    f"fleet metrics merged from only {n}/{n_ranks} worker "
                    f"snapshot(s) under {obs_snapshot_dir} — stragglers "
                    "missing; re-merge offline with merged_fleet_snapshot")
            else:
                log.info(f"fleet metrics merged from {n} worker "
                         f"snapshot(s) under {obs_snapshot_dir}")
    return bst
