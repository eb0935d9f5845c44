"""Hand-written Hopper kernels of the training path, and their wrappers.

One kernel, or kernel mode, per TPU kernel that the ported training
paths launch (lightgbm_tpu/learner/pallas_hist.py):

| wrapper          | source             | replaces                          |
|------------------|--------------------|-----------------------------------|
| `hist_nat`       | csrc/hist_nat.cu   | hist_nat_tpu, int16 and int8 modes |
| `hist_nat_f32`   | csrc/hist_nat.cu   | hist_nat_tpu, f32 (nat_ch=5) mode |
| `hist_round`     | csrc/hist_round.cu | hist_round_tpu, int16, int8 and f32 (bf16x2) modes |
| `take_small`     | csrc/take_small.cu | take_small_tpu / _take_kernel     |
| `take_rows`      | csrc/take_small.cu | take_small_tpu, the serving forest's node-major gather |
| `seg_sum`        | csrc/seg_sum.cu    | seg_sum_tpu / _segsum_kernel      |
| `hist`           | csrc/hist.cu       | hist_tpu / _hist_kernel           |
| `hist_slots`     | csrc/hist.cu       | hist_slots_tpu / _hist_slots_kernel |
| `cuda_rank.lambdarank` | csrc/lambdarank.cu | no pallas_call: the XLA pair tensors of learner/ranking.py lambdarank_gradients |

hist_round takes the round's category sets (cat_mask) on datasets with
categorical features: every channel mode then runs its categorical
variant (hist_round_tpu's has_cat).

The sources compile with nvcc for sm_90a into one shared library with
a plain C interface, loaded with ctypes. The library is built at first
use into `build/lgbm_torch_kernels/<source hash>/` at the repository
root (one nvcc per source, all started together, then one link) and
rebuilt when the sources change. Nothing here runs at import time: the
CPU tests import this module on machines without nvcc.

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs (hist_nat's integer modes, hist_round, hist and hist_slots also
keep scratch per device and stream that they allocate once per size,
the parts that must be zero on entry left zero by every call; hist_nat
runs one block a SM),
launches on torch's current stream, raises if the C function reports a
CUDA error, and adds one to its launch count per call (one count per
kernel mode: the int8 modes count as hist_nat_int8 / hist_round_int8; a
hist_round call in its categorical variant adds one to hist_round_cat
as well; take_rows counts as take_small, the TPU kernel both replace).
The plain PyTorch versions live in learner/histogram.py; nothing here
falls back to them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lgbm_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# launches on the card, per kernel; read and reset by chip_smoke.py
LAUNCHES: Dict[str, int] = {
    "hist_nat": 0, "hist_round": 0, "take_small": 0, "seg_sum": 0,
    "hist": 0, "hist_slots": 0, "hist_round_f32": 0,
    "hist_nat_int8": 0, "hist_round_int8": 0, "hist_nat_f32": 0,
    "hist_round_cat": 0, "lambdarank": 0,
}

# shared memory a block may use on sm_90 (mirrors hist_common.cuh)
_MAX_SMEM = 232448

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None
_SMS: Dict[int, int] = {}  # device index -> SM count


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def library_path() -> Path:
    return _BUILD_ROOT / source_hash() / "liblgbm_torch_kernels.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.
    Returns the library path; raises with nvcc's output on failure."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        if BUILD_SECONDS is None:  # built by an earlier process
            BUILD_SECONDS = 0.0
        return out
    t0 = time.perf_counter()
    work = out.parent / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    objs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    errors = []
    for src, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp_lib = work / out.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp_lib, out)
    shutil.rmtree(work, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:  # the per-call path: no lock
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        # one build a process: every other caller needs the library and
        # must wait for it anyway
        lib = ctypes.CDLL(str(build()))  # lint: allow[blocking-under-lock]
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.lgbm_hist_nat.argtypes = [I] + [P] * 5 + [I] * 17 + [P]
        lib.lgbm_hist_nat_f32.argtypes = [P] * 6 + [I] * 8 + [P]
        lib.lgbm_hist_round.argtypes = [I] + [P] * 11 + [I] * 12 + [P]
        lib.lgbm_take_small.argtypes = [P, P, P] + [I] * 5 + [P]
        lib.lgbm_take_rows.argtypes = [P, P, P] + [I] * 5 + [P]
        lib.lgbm_seg_sum.argtypes = [P] * 4 + [I] * 7 + [P, P]
        L = ctypes.c_longlong
        lib.lgbm_hist.argtypes = ([P, P, I, P, P, L, L] + [I] * 3 + [P] * 4
                                  + [I] * 10 + [P] * 3)
        lib.lgbm_hist_slots.argtypes = ([P, P, I, P, P, I] + [P] * 4
                                        + [I] * 10 + [P] * 3)
        F = ctypes.c_float
        lib.lgbm_lambdarank.argtypes = ([P, P, P, I, P, I] + [P] * 5
                                        + [I] * 3 + [F] * 3 + [I] * 3
                                        + [F, I, P])
        # csrc/graph.cu: capture, replay and IF nodes (device_loop.py)
        lib.lgbm_graph_begin.argtypes = [P]
        lib.lgbm_graph_end.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(P),
                                        ctypes.POINTER(L)]
        lib.lgbm_graph_launch.argtypes = [P, P]
        lib.lgbm_graph_destroy.argtypes = [P, P]
        lib.lgbm_if_begin.argtypes = [P, P, P]
        lib.lgbm_if_end.argtypes = [P, ctypes.POINTER(L)]
        for fn in (lib.lgbm_hist_nat, lib.lgbm_hist_nat_f32,
                   lib.lgbm_hist_round, lib.lgbm_take_small,
                   lib.lgbm_take_rows,
                   lib.lgbm_seg_sum, lib.lgbm_hist, lib.lgbm_hist_slots,
                   lib.lgbm_lambdarank,
                   lib.lgbm_graph_begin, lib.lgbm_graph_end,
                   lib.lgbm_graph_launch, lib.lgbm_graph_destroy,
                   lib.lgbm_if_begin, lib.lgbm_if_end):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: Optional[torch.device] = None) -> int:
    """The raw handle of torch's current stream on `device` (the current
    device by default), without building a torch.cuda.Stream."""
    index = device.index if device is not None else None
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _sm_count(device: torch.device) -> int:
    """SM count of `device`, queried once per device."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def check_int_range(n_rows: int, levels: int) -> None:
    """Worst-case int32 cell sum of the integer histograms: n_rows rows
    at `levels` (the hessian channel's maximum level). At 256 levels the
    bound is ~8.4M rows — the same bound histogram.int8_oh_shift guards
    in the JAX package."""
    if n_rows * max(int(levels), 1) >= 2 ** 31:
        raise ValueError(
            f"{n_rows} rows x {levels} levels can overflow the int32 "
            "histogram cells (limit 2^31)"
        )


def _check_hist_inputs(bins, gh, n_rows_vec, name):
    _need(bins, "bins", torch.int32, 2)
    _need(gh, "gh", torch.int8 if gh.dtype == torch.int8 else torch.int32, 2)
    G, N = bins.shape
    if gh.shape != (3, N):
        raise ValueError(f"gh must be (3, {N}), got {tuple(gh.shape)}")
    _need(n_rows_vec, name, torch.int32, 1)
    if n_rows_vec.shape[0] != N:
        raise ValueError(f"{name} must have {N} rows")
    return G, N


# hist_nat's integer modes (csrc/hist_nat.cu "integer modes"): blocks of
# NAT_THREADS threads, one a SM, walk (slot chunk, column group, row
# split) items; a block's (Sc, 3, Bc, P) int32 tile holds as many slots
# as NAT_TILE_BYTES of shared memory allow; with 16-byte alignment the
# rows come through NAT_STAGES shared-memory stages of NAT_CHUNK rows
NAT_THREADS = 1024
NAT_TILE_BYTES = 48 * 1024
NAT_CHUNK = 1152
NAT_STAGES = 2
NAT_ITEM_ROWS = (1 << 23) - 32  # rows of an item: x 256 levels < 2^31
NAT_MIN_ITEM_ROWS = 4096  # rows that warrant a row split of their own


def _nat_stage_bytes(chunk: int, gc: int, int8: bool) -> int:
    """One stage of `chunk` rows (csrc/hist_nat.cu nat_stage_ints): gc
    padded columns of bins, the slots, three channels."""
    return 4 * (gc * (chunk + 4) + chunk + 3 * (chunk // 4 if int8
                                                else chunk))


def hist_nat_plan(G: int, N: int, S: int, Bc: int, sms: int,
                  aligned: bool = True, int8: bool = False) -> dict:
    """The launch of one call of hist_nat's integer modes, from the
    shapes alone; raises ValueError beyond what the kernel takes. A cell
    (slot, channel, bin) of the tile has P positions, one per lane: P =
    32, halved until a slot's 12 x Bc x P bytes fit the block's shared
    memory and, on the staged path (vec: 16-byte aligned inputs, N % 16
    == 0, and all S slots in one tile, since the stages copy every row),
    until the tile fits NAT_TILE_BYTES beside the stages; a lane takes
    one of W (the power of two >= G, at most P) columns, so a tile holds
    Gc <= W of them (n_cg column groups) and Sc slots (n_sc slot
    chunks). The grid holds at most one block a SM (the cooperative
    launch refuses a grid the card cannot hold); each tile is cut into
    R = sms / tiles row splits (at least 1, at most one per
    NAT_MIN_ITEM_ROWS rows, and enough that none passes NAT_ITEM_ROWS)
    of `rows` rows, a multiple of 32. A tile of several items combines
    through partial tiles in scratch (part: items x tcp words)."""
    G, N, S, Bc = int(G), int(N), int(S), int(Bc)
    if min(G, N, S, Bc) < 1:
        raise ValueError(f"hist_nat: empty call G={G} N={N} S={S} Bc={Bc}")
    room = _MAX_SMEM - _SMEM_STATIC
    vec = bool(aligned and N % 16 == 0)

    def layout(P, staged):
        W = min(P, 1 << (G - 1).bit_length())
        n_cg = -(-G // W)
        Gc = -(-G // n_cg)
        stages = (NAT_STAGES * _nat_stage_bytes(NAT_CHUNK, Gc, int8)
                  if staged else 0)
        return W, n_cg, Gc, stages

    for staged in ((True, False) if vec else (False,)):
        # the staged path's tile leaves room for its stages
        budget = min(NAT_TILE_BYTES, room) if staged else room
        P = 32
        while True:
            W, n_cg, Gc, stages = layout(P, staged)
            tile = 12 * Bc * P
            if tile <= budget and tile + stages <= room:
                break
            if P == 1:
                break
            P //= 2
        # the stages copy every row: only where one tile holds every slot
        if 12 * Bc * P + stages <= room and not (
                staged and S * 12 * Bc * P > min(budget, room - stages)):
            break
    else:
        raise ValueError(
            f"hist_nat: num_bins={Bc} needs {12 * Bc} B of shared memory "
            f"per slot; a block has {room} B (kernel limit)")
    vec = staged
    per_slot = 12 * Bc * P
    Sc = max(1, min(S, min(budget, room - stages) // per_slot))
    n_sc = -(-S // Sc)
    Sc = -(-S // n_sc)
    tiles = n_sc * n_cg
    threads = NAT_THREADS
    # the tile's ints rounded up to 16 bytes, then the stages
    smem = max(16 * -(-(Sc * 3 * Bc * P) // 4) + stages, threads // 32 * 512)
    R = max(1, min(int(sms) // tiles, -(-N // NAT_MIN_ITEM_ROWS)),
            -(-N // NAT_ITEM_ROWS))
    rows = -(-(-(-N // R)) // 32) * 32
    R = -(-N // rows)
    items = tiles * R
    if items > 2 ** 31 - 1:
        raise ValueError(f"hist_nat: {items} work items exceed 2^31 - 1 "
                         "(kernel limit)")
    tcp = -(-(Sc * 3 * Bc * Gc) // 4) * 4
    return dict(P=P, W=W, Gc=Gc, n_cg=n_cg, Sc=Sc, n_sc=n_sc, tiles=tiles,
                R=R, rows=rows, items=items, grid=min(items, int(sms)),
                threads=threads, smem=smem, vec=vec,
                chunk=NAT_CHUNK, stages=NAT_STAGES, stage_bytes=stages,
                tcp=tcp, part_words=items * tcp if R > 1 else 0)


def hist_nat(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
             num_slots: int, num_bins: int, levels: int) -> torch.Tensor:
    """(G, N) bins, (3, N) int32 or int8 levels, (N,) slot in [0, S]
    (S = trash) -> (S, 3, G, Bc) f32 exact integer sums. int8 channels
    run the int8 mode (counted as hist_nat_int8)."""
    G, N = _check_hist_inputs(bins, gh, slot, "slot")
    check_int_range(N, levels)
    S, Bc = int(num_slots), int(num_bins)
    dev = bins.device
    out = torch.empty((S, 3, G, Bc), dtype=torch.float32, device=dev)
    if N == 0 or out.numel() == 0:
        return out.zero_()
    int8 = gh.dtype == torch.int8
    name = "hist_nat_int8" if int8 else "hist_nat"
    ptrs = (bins.data_ptr(), gh.data_ptr(), slot.data_ptr())
    plan = hist_nat_plan(
        G, N, S, Bc, _sm_count(dev), all(p % 16 == 0 for p in ptrs), int8)
    part = None
    if plan["R"] > 1:
        part, = _scratch(_NAT_SCRATCH, dev, _stream(dev), plan, _NAT_BUFS)
    rc = load().lgbm_hist_nat(
        int(int8), *ptrs, out.data_ptr(),
        None if part is None else part.data_ptr(), G, N, S, Bc, plan["P"],
        plan["W"], plan["Gc"], plan["Sc"], plan["n_cg"], plan["R"],
        plan["rows"], plan["grid"], plan["threads"], plan["smem"],
        plan["chunk"], plan["stages"], int(plan["vec"]), _stream(dev))
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


# hist_nat's f32 mode (csrc/hist_nat.cu "f32 mode")
_PARTS_MAX = 256  # prepass blocks (kPartsMax)
_PREPASS_ROWS = 4096  # rows per prepass block at least


def hist_nat_f32_plan(N: int, sms: int, aligned: bool = True) -> dict:
    """The launch of hist_nat's f32 mode (one pass of 64-bit atomics
    into an int64 accumulator in device memory, at every slot count),
    from the shapes alone: the histogram's blocks (_row_blocks), the
    prepass's (one row of maxima each, <= _PARTS_MAX), and 16-byte
    loads (vec) when N % 4 == 0 and the inputs are 16-byte aligned."""
    return dict(blocks=_row_blocks(N, sms),
                nparts=max(1, min(_PARTS_MAX, -(-N // _PREPASS_ROWS))),
                vec=aligned and N % 4 == 0)


def _row_blocks(N: int, sms: int) -> int:
    """Blocks of the row-parallel kernels (take_small, hist_nat's f32
    mode): 256 threads x 4 rows each, one 1024-row step per block, at
    most one wave (8 such blocks per SM)."""
    return max(1, min(-(-N // 1024), 8 * sms))


def hist_nat_f32(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                 num_slots: int, num_bins: int) -> torch.Tensor:
    """The f32 mode of hist_nat: (G, N) bins, (3, N) f32 channels, (N,)
    slot in [0, S] (S = trash) -> (S, 3, G, Bc) f32 fixed-point sums, the
    scale taken over all N rows."""
    from .histogram import fx_log2_rows

    _need(bins, "bins", torch.int32, 2)
    _need(gh, "gh", torch.float32, 2)
    _need(slot, "slot", torch.int32, 1)
    G, N = bins.shape
    S, Bc = int(num_slots), int(num_bins)
    if gh.shape != (3, N) or slot.shape[0] != N:
        raise ValueError(f"gh must be (3, {N}) and slot ({N},)")
    dev = bins.device
    if N == 0 or S * G * Bc == 0:
        return torch.zeros((S, 3, G, Bc), dtype=torch.float32, device=dev)
    pb, pg, ps = bins.data_ptr(), gh.data_ptr(), slot.data_ptr()
    plan = hist_nat_f32_plan(N, _sm_count(dev),
                             pb % 16 == 0 and pg % 16 == 0 and ps % 16 == 0)
    parts = torch.empty((plan["nparts"] + 1) * 3, dtype=torch.int32,
                        device=dev)
    acc = torch.empty(S * 3 * G * Bc, dtype=torch.int64, device=dev)
    out = torch.empty((S, 3, G, Bc), dtype=torch.float32, device=dev)
    rc = load().lgbm_hist_nat_f32(
        pb, pg, ps, parts.data_ptr(), acc.data_ptr(), out.data_ptr(), G, N,
        S, Bc, plan["blocks"], plan["nparts"], fx_log2_rows(N),
        int(plan["vec"]), _stream(dev))
    _check(rc, "hist_nat_f32")
    LAUNCHES["hist_nat_f32"] += 1
    return out


def _cat_arg(cat_mask: Optional[torch.Tensor], S: int, Bc: int):
    """The checked (S, Bc) bool category sets of a hist_round call, or
    None; the kernel builds its bitsets itself."""
    if cat_mask is None:
        return None
    _need(cat_mask, "cat_mask", torch.bool, 2)
    if cat_mask.shape != (S, Bc):
        raise ValueError(f"cat_mask must be ({S}, {Bc}), got "
                         f"{tuple(cat_mask.shape)}")
    return cat_mask


# hist_round (csrc/hist_round.cu): a partition launch of 2048-row blocks
# (kPartRows), then a histogram launch over (slot, chunk of kept rows)
# items, a slot of T kept rows cut into min(ROUND_SLOT_ITEMS, ceil(T /
# ROUND_CHUNK)) of them (at least one), and column groups of at most
# ROUND_COLS columns
ROUND_PART_ROWS = 2048  # kPartRows
ROUND_CHUNK = 1024
ROUND_SLOT_ITEMS = 64
ROUND_COLS = 4  # at most 8 (kRoundMaxCols)
ROUND_MAX_PART_BLOCKS = 8192  # the histogram blocks stage 2 ints a block
_SMEM_STATIC = 1024  # a block's static shared memory, at most


def hist_round_plan(G: int, N: int, S: int, Bc: int, L: int,
                    f32: bool = False, has_cat: bool = False) -> dict:
    """The launches and scratch of one hist_round call, from the shapes
    alone; raises ValueError where a block's shared memory cannot hold
    them. Partition: nb blocks of 2048 rows, each holding the leaf ->
    slot table (L + 1 ints), the (S, 16) params, per-slot counts and
    offsets and (has_cat) the category bitsets. Histogram: a grid of
    (max_items, n_cg) blocks, max_items bounding the (slot, chunk) items
    of any round: a slot of T kept rows takes max(1, min(slot_items,
    ceil(T / chunk))) of them, and the slots share at most N rows, so
    there are at most min(ceil(N / chunk) + S, S x slot_items); each
    block holds a (3, gc, Bc) tile (int32 cells, int64 in the f32 mode)
    and its slot's nb counts and starts. Scratch words: state
    (zeroed once, left zeroed by every call), work, the row list (N)
    and the accumulator (S x 3 x G x Bc cells, int64 words)."""
    G, N, S, Bc, L = int(G), int(N), int(S), int(Bc), int(L)
    nb = -(-N // ROUND_PART_ROWS)
    if nb > ROUND_MAX_PART_BLOCKS:
        raise ValueError(f"hist_round: {N} rows exceed the "
                         f"{ROUND_MAX_PART_BLOCKS * ROUND_PART_ROWS} a call "
                         "takes (kernel limit)")
    cat_ints = S * -(-Bc // 32) if has_cat else 0
    smem_part = 4 * ((L + 1) + 16 * S + S + (S + 1) + cat_ints)
    if smem_part > _MAX_SMEM - _SMEM_STATIC:
        raise ValueError(
            f"hist_round: {L} leaves and {S} slots need {smem_part} B of "
            f"shared memory in the partition; a block has "
            f"{_MAX_SMEM - _SMEM_STATIC} B (kernel limit)")
    cell = 8 if f32 else 4
    staged = 4 * (2 * nb + 1)
    room = _MAX_SMEM - _SMEM_STATIC - staged
    if room < 3 * Bc * cell:
        raise ValueError(
            f"hist_round: num_bins={Bc} needs {3 * Bc * cell} B of shared "
            f"memory per column beside {staged} B of row counts; a block "
            f"has {_MAX_SMEM - _SMEM_STATIC} B (kernel limit)")
    n_cg = -(-G // min(ROUND_COLS, 8, room // (3 * Bc * cell)))
    gc = -(-G // n_cg)
    chunk, slot_items = ROUND_CHUNK, ROUND_SLOT_ITEMS
    max_items = min(-(-N // chunk) + S, S * slot_items)
    return dict(
        nb=nb, chunk=chunk, slot_items=slot_items, gc=gc, n_cg=n_cg,
        max_items=max_items, smem_part=smem_part,
        smem_hist=3 * gc * Bc * cell + staged,
        state_words=1 + S + S * n_cg,
        work_words=4 + 3 * S + 2 * max_items + 2 * S * nb + 3 * nb,
        list_words=N, acc_words=S * 3 * G * Bc)


# the scratch of hist_round, and of hist and hist_slots, per (device,
# stream): tensors that only grow
_ROUND_SCRATCH: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
_SEG_SCRATCH: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
_NAT_SCRATCH: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
_ROUND_BUFS = (("state", torch.int32, True), ("work", torch.int32, False),
               ("list", torch.int32, False), ("acc", torch.int64, True))
_SEG_BUFS = (("state", torch.int32, True), ("work", torch.int32, False),
             ("acc", torch.int64, True))
_NAT_BUFS = (("part", torch.int32, False),)


# set while a CUDA graph is captured (device_loop.CudaGraph.capture): the
# capture stream, which keys the scratch of every launch in the graph,
# its IF bodies' streams included (a graph runs its launches one after
# another, so they may share one set of buffers)
_SCRATCH_STREAM: Optional[int] = None


@contextlib.contextmanager
def scratch_stream(stream: int):
    """Key the scratch on `stream` whatever the current stream is."""
    global _SCRATCH_STREAM
    prev, _SCRATCH_STREAM = _SCRATCH_STREAM, stream
    try:
        yield
    finally:
        _SCRATCH_STREAM = prev


def _scratch(table: dict, dev: torch.device, stream: int, plan: dict,
             layout) -> Tuple[torch.Tensor, ...]:
    """The buffers of `layout` ((name, dtype, zeroed) each, sized by
    plan[name + "_words"]) for a call of this plan, kept in table per
    (device, stream), allocated once per size and reused: the zeroed
    ones zeroed when allocated (every call leaves them zero), the others
    uninitialised. During a graph capture the capture stream stands for
    `stream` (scratch_stream)."""
    if _SCRATCH_STREAM is not None:
        stream = _SCRATCH_STREAM
    bufs = table.setdefault((dev.index, stream), {})
    out = []
    for name, dtype, zero in layout:
        n = max(1, plan[name + "_words"])
        t = bufs.get(name)
        if t is None or t.numel() < n:
            t = bufs[name] = (torch.zeros if zero else torch.empty)(
                n, dtype=dtype, device=dev)
        out.append(t)
    return tuple(out)


_ROUND_MODES = {torch.int32: (0, "hist_round"),
                torch.int8: (1, "hist_round_int8"),
                torch.float32: (2, "hist_round_f32")}


def hist_round(bins: torch.Tensor, gh: torch.Tensor, pleaf: torch.Tensor,
               params: torch.Tensor, num_slots: int, num_bins: int,
               num_leaves: int, levels: int,
               cat_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused partition + smaller-child histograms -> ((S, 3, G, Bc) f32,
    (N,) int32 new row -> leaf), in the mode of gh's dtype: int32 levels
    (the int16 mode), int8 levels (the int8 mode, counted as
    hist_round_int8) — `levels` bounds either — or f32 channels summed as
    int64 fixed point with the scale over all N rows (the f32 mode,
    counted as hist_round_f32). params (S, 16) int32 as documented in
    csrc/hist_round.cu; pleaf values lie in [0, num_leaves]. cat_mask
    (S, Bc) bool: the category sets of the slots params column 10 flags,
    tested in the kernel's categorical variant (counted as hist_round_cat
    too). Rows of zero count must have zero gradient and hessian (the
    kernel leaves them out)."""
    from .histogram import fx_log2_rows

    _need(bins, "bins", torch.int32, 2)
    if gh.dtype not in _ROUND_MODES:
        raise TypeError(f"gh must be int32, int8 or float32, got {gh.dtype}")
    _need(gh, "gh", gh.dtype, 2)
    _need(pleaf, "pleaf", torch.int32, 1)
    _need(params, "params", torch.int32, 2)
    G, N = bins.shape
    S, Bc, L = int(num_slots), int(num_bins), int(num_leaves)
    if gh.shape != (3, N) or pleaf.shape[0] != N:
        raise ValueError(f"gh must be (3, {N}) and pleaf ({N},)")
    if params.shape != (S, 16):
        raise ValueError(f"params must be ({S}, 16)")
    mode, name = _ROUND_MODES[gh.dtype]
    if mode != 2:
        check_int_range(N, levels)
    cat = _cat_arg(cat_mask, S, Bc)
    dev = bins.device
    out = torch.empty((S, 3, G, Bc), dtype=torch.float32, device=dev)
    pleaf_new = torch.empty_like(pleaf)
    if N == 0 or S == 0:
        return out.zero_(), pleaf_new.copy_(pleaf)
    plan = hist_round_plan(G, N, S, Bc, L, mode == 2, cat is not None)
    stream = _stream(dev)
    state, work, rows, acc = _scratch(_ROUND_SCRATCH, dev, stream, plan,
                                      _ROUND_BUFS)
    rc = load().lgbm_hist_round(
        mode, bins.data_ptr(), gh.data_ptr(), pleaf.data_ptr(),
        params.data_ptr(), None if cat is None else cat.data_ptr(),
        state.data_ptr(), work.data_ptr(), rows.data_ptr(), acc.data_ptr(),
        out.data_ptr(), pleaf_new.data_ptr(), G, N, S, Bc, L, plan["nb"],
        plan["chunk"], plan["slot_items"], plan["gc"], plan["n_cg"],
        plan["max_items"], fx_log2_rows(N), stream)
    _check(rc, name)
    LAUNCHES[name] += 1
    if cat is not None:
        LAUNCHES["hist_round_cat"] += 1
    return out, pleaf_new


# hist and hist_slots (csrc/hist.cu): a plan launch of at least
# SEG_PLAN_ROWS scale rows a block and at most SEG_PLAN_BLOCKS blocks,
# then a histogram launch over (slot, chunk) items, a slot of T rows cut
# into min(SEG_SLOT_ITEMS, ceil(T / SEG_CHUNK)) of them (at least one;
# more items a slot where N / SEG_SLOT_ITEMS rows would pass
# SEG_ITEM_ROWS, the most rows an item's 32-bit limbs sum exactly), and
# column groups of at most SEG_COLS columns
SEG_CHUNK = 2048
SEG_SLOT_ITEMS = 32
SEG_COLS = 1
SEG_ITEM_ROWS = 65536
SEG_PLAN_ROWS = 8192
SEG_PLAN_BLOCKS = 256
SEG_MAX_ROWS = 1 << 30  # rows of a call, at most (int32 row arithmetic)


def _seg_plan(name: str, G: int, N: int, S: int, Bc: int,
              scale_rows: int) -> dict:
    G, N, S, Bc = int(G), int(N), int(S), int(Bc)
    if N > SEG_MAX_ROWS:
        raise ValueError(f"{name}: {N} rows exceed the {SEG_MAX_ROWS} a "
                         "call takes (kernel limit)")
    per_col = 9 * Bc * 4  # three uint32 limbs of three channels
    room = _MAX_SMEM - _SMEM_STATIC
    if per_col > room:
        raise ValueError(
            f"{name}: num_bins={Bc} needs {per_col} B of shared memory per "
            f"column; a block has {room} B (kernel limit)")
    n_cg = -(-G // min(SEG_COLS, room // per_col))
    if n_cg > 65535:
        raise ValueError(f"{name}: {G} columns need {n_cg} column groups; "
                         "a grid takes 65535 (kernel limit)")
    gc = -(-G // n_cg)
    rows = min(N, scale_rows) if S == 1 else N
    chunk = min(SEG_CHUNK, SEG_ITEM_ROWS)
    slot_items = max(SEG_SLOT_ITEMS, -(-rows // SEG_ITEM_ROWS))
    max_items = min(-(-rows // chunk) + S, S * slot_items)
    if max_items > 2 ** 31 - 1:
        raise ValueError(f"{name}: {S} slots of up to {slot_items} items "
                         "exceed the work-list bound of 2^31 - 1 items "
                         "(kernel limit)")
    return dict(
        chunk=chunk, slot_items=slot_items, gc=gc, n_cg=n_cg,
        max_items=max_items, smem=gc * per_col,
        plan_blocks=max(1, min(SEG_PLAN_BLOCKS,
                               -(-min(N, scale_rows) // SEG_PLAN_ROWS))),
        state_words=4 + S * n_cg, work_words=4 + 4 * max_items,
        acc_words=S * 3 * G * Bc)


def hist_plan(G: int, N: int, cap: int, Bc: int) -> dict:
    """The launches and scratch of one hist call over at most `cap` of
    N rows, from the shapes alone; raises ValueError where the kernel
    cannot take them. Plan: plan_blocks blocks over the segment (the
    fixed-point scale's rows). Histogram: a grid of (max_items, n_cg)
    blocks, each a (3, gc, Bc) tile of int64 sums kept as three uint32
    limbs (smem bytes); a segment of T rows takes seg_items(T, plan)
    items of at most SEG_ITEM_ROWS rows, so max_items = min(ceil(cap /
    chunk) + 1, slot_items) bounds them. Scratch words: state (zeroed
    once, left zeroed by every call), work and acc (int64 words)."""
    return _seg_plan("hist", G, N, 1, Bc, cap)


def hist_slots_plan(G: int, N: int, S: int, Bc: int) -> dict:
    """hist_plan for one hist_slots call of S disjoint segments of N
    rows: the scale over all N rows; the segments share at most N rows,
    so max_items = min(ceil(N / chunk) + S, S x slot_items) bounds the
    items."""
    return _seg_plan("hist_slots", G, N, S, Bc, N)


def seg_items(T: int, plan: dict) -> Tuple[int, int]:
    """(items, rows per item) that the plan launch gives a slot of T
    rows: max(1, min(slot_items, ceil(T / chunk))) items of ceil(T /
    items) rows (at least 1; the last item takes the rest)."""
    n = max(1, min(plan["slot_items"], -(-int(T) // plan["chunk"])))
    return n, max(1, -(-int(T) // n))


def _seg_vec(bins: torch.Tensor, gh: torch.Tensor) -> int:
    """16-byte loads of bins and gh: N % 4 == 0 and both aligned."""
    return int(bins.shape[1] % 4 == 0 and bins.data_ptr() % 16 == 0
               and gh.data_ptr() % 16 == 0)


def _scalar_arg(x, dev, name: str):
    """(pointer, host value, width) of a row bound: a 0-dim (or
    one-element) int32 / int64 tensor on the bins' card is read by the
    kernel (pointer and width); a host int, or a tensor on the CPU, is
    passed by value (pointer None)."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"{name} must have one element")
        if not x.is_cuda:
            return None, int(x), 0
        if x.device != dev:
            raise ValueError(f"{name} must be on {dev}, not {x.device}")
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {x.dtype}")
        return x.data_ptr(), 0, x.element_size()
    return None, int(x), 0


def _fx_args(fx, dev):
    """A sharded run's fixed-point partials: fx = ((3,) f32 channel maxima
    over every rank, the scale's n) -> (the maxima's device pointer, kept
    alive by the returned tensor, ceil(log2 n)); (None, None) for fx
    None."""
    from .histogram import fx_log2_rows

    if fx is None:
        return None, None, None
    absmax, n_rows = fx
    bits = absmax.to(device=dev, dtype=torch.float32).contiguous().view(
        torch.int32)
    return bits, bits.data_ptr(), fx_log2_rows(n_rows)


def hist(bins: torch.Tensor, gh: torch.Tensor, num_bins: int, begin=0,
         count=None, cap: Optional[int] = None, fx=None) -> torch.Tensor:
    """(G, N) bins, (3, N) f32 channels -> (3, G, Bc) f32 fixed-point sums
    over rows [begin, begin + count); begin/count host ints or device
    0-dim int32 / int64 tensors (read by the kernel), cap a host bound on
    count (required for a device count), which also gives the scale's
    n. fx: a sharded run's ((3,) maxima over every rank, the scale's n),
    which set the scale; the result is then the (3, G, Bc) int64 sums."""
    from .histogram import fx_log2_rows

    _need(bins, "bins", torch.int32, 2)
    _need(gh, "gh", torch.float32, 2)
    G, N = bins.shape
    Bc = int(num_bins)
    if gh.shape != (3, N):
        raise ValueError(f"gh must be (3, {N}), got {tuple(gh.shape)}")
    dev = bins.device
    bp, bv, bw = _scalar_arg(begin, dev, "begin")
    if count is None:
        if bp is not None:
            raise ValueError("a device begin needs a device count and a cap")
        count = N - bv
    cp, cv, cw = _scalar_arg(count, dev, "count")
    if cp is None and bp is None and (bv < 0 or cv < 0 or bv + cv > N):
        raise ValueError(f"rows [{bv}, {bv + cv}) outside [0, {N})")
    if cap is None:
        if cp is not None:
            raise ValueError("a device count needs a host cap")
        cap = cv
    cap = min(int(cap), N)
    keep, max_in, log2 = _fx_args(fx, dev)
    odt = torch.float32 if fx is None else torch.int64
    if cap <= 0 or G == 0:
        return torch.zeros((3, G, Bc), dtype=odt, device=dev)
    plan = hist_plan(G, N, cap, Bc)
    stream = _stream(dev)
    state, work, acc = _scratch(_SEG_SCRATCH, dev, stream, plan,
                                 _SEG_BUFS)
    out = torch.empty((3, G, Bc), dtype=odt, device=dev)
    rc = load().lgbm_hist(
        bins.data_ptr(), gh.data_ptr(), N, bp, cp, bv, cv, bw, cw, cap,
        state.data_ptr(), work.data_ptr(), acc.data_ptr(),
        None if fx is not None else out.data_ptr(),
        G, Bc, plan["chunk"], plan["slot_items"], plan["gc"], plan["n_cg"],
        plan["max_items"], plan["plan_blocks"],
        fx_log2_rows(cap) if log2 is None else log2,
        _seg_vec(bins, gh), max_in,
        out.data_ptr() if fx is not None else None, stream)
    _check(rc, "hist")
    del keep
    LAUNCHES["hist"] += 1
    return out


def hist_slots(bins: torch.Tensor, gh: torch.Tensor, begins: torch.Tensor,
               counts: torch.Tensor, num_bins: int,
               num_slots: int, fx=None) -> torch.Tensor:
    """(G, N) leaf-grouped bins, (3, N) f32 channels, (S,) int32 disjoint
    segments -> (S, 3, G, Bc) f32 fixed-point sums, the scale over all N
    rows; empty slots zero. fx: as hist's (int64 sums)."""
    from .histogram import fx_log2_rows

    _need(bins, "bins", torch.int32, 2)
    _need(gh, "gh", torch.float32, 2)
    G, N = bins.shape
    S, Bc = int(num_slots), int(num_bins)
    if gh.shape != (3, N):
        raise ValueError(f"gh must be (3, {N}), got {tuple(gh.shape)}")
    begins = begins.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    _need(begins, "begins", torch.int32, 1)
    _need(counts, "counts", torch.int32, 1)
    if begins.shape[0] != S or counts.shape[0] != S:
        raise ValueError(f"begins and counts must have {S} slots")
    dev = bins.device
    keep, max_in, log2 = _fx_args(fx, dev)
    out = torch.empty((S, 3, G, Bc), dtype=torch.float32 if fx is None
                      else torch.int64, device=dev)
    if N == 0 or S == 0 or G == 0:
        return out.zero_()
    plan = hist_slots_plan(G, N, S, Bc)
    stream = _stream(dev)
    state, work, acc = _scratch(_SEG_SCRATCH, dev, stream, plan,
                                 _SEG_BUFS)
    rc = load().lgbm_hist_slots(
        bins.data_ptr(), gh.data_ptr(), N, begins.data_ptr(),
        counts.data_ptr(), S, state.data_ptr(), work.data_ptr(),
        acc.data_ptr(), None if fx is not None else out.data_ptr(), G, Bc,
        plan["chunk"], plan["slot_items"], plan["gc"], plan["n_cg"],
        plan["max_items"], plan["plan_blocks"],
        fx_log2_rows(N) if log2 is None else log2, _seg_vec(bins, gh),
        max_in, out.data_ptr() if fx is not None else None, stream)
    _check(rc, "hist_slots")
    del keep
    LAUNCHES["hist_slots"] += 1
    return out


def take_small_plan(N: int, sms: int, idx_ptr: int) -> Tuple[int, int]:
    """(blocks, vec_idx) of a take_small launch: the rows' blocks
    (_row_blocks), and 16-byte loads of idx when its data pointer is
    16-byte aligned (an offset view is not)."""
    return _row_blocks(N, sms), int(idx_ptr % 16 == 0)


def take_small(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(k, L) f32 table, (N,) int32 idx -> (k, N) f32 tab[:, idx], 0 for
    idx outside [0, L)."""
    _need(tab, "tab", torch.float32, 2)
    _need(idx, "idx", torch.int32, 1)
    k, L = tab.shape
    N = idx.shape[0]
    dev = tab.device
    out = torch.empty((k, N), dtype=torch.float32, device=dev)
    if k == 0 or N == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("take_small: the output is not 16-byte aligned")
    idx_ptr = idx.data_ptr()
    blocks, vec_idx = take_small_plan(N, _sm_count(dev), idx_ptr)
    rc = load().lgbm_take_small(tab.data_ptr(), idx_ptr, out.data_ptr(), k,
                                L, N, blocks, vec_idx, _stream(dev))
    _check(rc, "take_small")
    LAUNCHES["take_small"] += 1
    return out


# floats a node-major record take_rows reads (kRecord, csrc/take_small.cu;
# serving/forest.py PACK_WIDTH)
TAKE_ROWS_RECORD = 16


def take_rows_plan(tab_rows: torch.Tensor, idx: torch.Tensor, k: int,
                   sms: int) -> dict:
    """The checks and the launch of a take_rows call, from the tensors'
    dtypes, shapes, strides and data pointers alone (no card needed):
    an f32 (L, TAKE_ROWS_RECORD) row-major table, 0 < k <= its width,
    the table 16-byte aligned (every record then is), an int32 (N,) idx;
    raises on anything else. Returns the grid (take_small's:
    _row_blocks), vec_idx (16-byte idx loads from an aligned pointer), L
    and N."""
    if tab_rows.dtype != torch.float32:
        raise TypeError(f"take_rows: tab_rows must be torch.float32, got "
                        f"{tab_rows.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"take_rows: idx must be torch.int32, got "
                        f"{idx.dtype}")
    if tab_rows.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"take_rows: tab_rows must be (L, kp) and idx "
                         f"(N,), got {tuple(tab_rows.shape)} and "
                         f"{tuple(idx.shape)}")
    if not (tab_rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take_rows: tab_rows and idx must be contiguous")
    L, kp = tab_rows.shape
    if kp != TAKE_ROWS_RECORD:
        raise ValueError(f"take_rows: a record of {kp} floats; the kernel "
                         f"reads records of {TAKE_ROWS_RECORD}")
    if not 0 < k <= kp:
        raise ValueError(f"take_rows: k = {k} outside 1..{kp}")
    if tab_rows.data_ptr() % 16:
        raise ValueError("take_rows: the table is not 16-byte aligned")
    N = idx.shape[0]
    blocks, vec_idx = take_small_plan(N, sms, idx.data_ptr())
    return dict(blocks=blocks, vec_idx=vec_idx, L=L, N=N)


def take_rows(tab_rows: torch.Tensor, idx: torch.Tensor,
              k: int) -> torch.Tensor:
    """(L, TAKE_ROWS_RECORD) f32 node-major table, (N,) int32 idx ->
    (k, N) f32 tab_rows[idx, :k].T, 0 for idx outside [0, L)."""
    if not (tab_rows.is_cuda and idx.is_cuda):
        raise ValueError("take_rows: tab_rows and idx must be CUDA tensors")
    dev = tab_rows.device
    plan = take_rows_plan(tab_rows, idx, k, _sm_count(dev))
    N = plan["N"]
    out = torch.empty((k, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("take_rows: the output is not 16-byte aligned")
    rc = load().lgbm_take_rows(tab_rows.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), k, plan["L"], N,
                               plan["blocks"], plan["vec_idx"], _stream(dev))
    _check(rc, "take_rows")
    LAUNCHES["take_small"] += 1
    return out


# seg_sum (csrc/seg_sum.cu)
_SEG_MAX_K = 3  # kSegMaxK
_SEG_PARTS_MAX = 256  # kSegPartsMax


def seg_sum_plan(k: int, L: int, N: int, sms: int,
                 aligned: bool = True) -> dict:
    """The launches of one seg_sum call from the shapes alone: the
    prepass's blocks (one row of k maxima each, <= 256, ~4096 rows a
    block), the sums' blocks (about two per SM, fewer when the rows would
    give a block under 1024), 16-byte loads (vec) when N % 4 == 0 and the
    inputs are 16-byte aligned, the (k, L) int64 tile's shared memory,
    and the scratch's int64 words (accumulator, done counter, maxima).
    Raises ValueError past k = 3 or a tile larger than a block's shared
    memory."""
    k, L, N = int(k), int(L), int(N)
    if not 1 <= k <= _SEG_MAX_K:
        raise ValueError(f"seg_sum: k={k} channels; the kernel takes 1 to "
                         f"{_SEG_MAX_K}")
    smem = 8 * k * L
    if smem > _MAX_SMEM - _SMEM_STATIC:
        raise ValueError(f"seg_sum: k={k} x num_out={L} int64 tile exceeds "
                         "a block's shared memory (kernel limit)")
    nparts = max(1, min(_SEG_PARTS_MAX, -(-N // 4096)))
    return dict(blocks=max(1, min(-(-N // 1024), 2 * sms)), nparts=nparts,
                vec=aligned and N % 4 == 0, smem=smem,
                scratch_words=k * L + 1 + -(-nparts * k // 2))


def seg_sum(vals: torch.Tensor, idx: torch.Tensor,
            num_out: int, fx=None) -> torch.Tensor:
    """(k, N) f32, k <= 3, (N,) int32 -> (k, num_out) f32 per-index sums
    as int64 fixed point (the same bits on every run); idx outside [0,
    num_out) dropped. fx: a sharded run's ((k,) maxima over every rank,
    the scale's n); the result is then the (k, num_out) int64 sums."""
    from .histogram import fx_log2_rows

    _need(vals, "vals", torch.float32, 2)
    _need(idx, "idx", torch.int32, 1)
    k, N = vals.shape
    L = int(num_out)
    if idx.shape[0] != N:
        raise ValueError(f"idx must have {N} rows")
    dev = vals.device
    pv, pi = vals.data_ptr(), idx.data_ptr()
    plan = seg_sum_plan(k, L, N, _sm_count(dev),
                        pv % 16 == 0 and pi % 16 == 0)
    out = torch.empty((k, L), dtype=torch.float32, device=dev)
    if N == 0 or L == 0:
        return out.zero_() if fx is None else out.to(torch.int64).zero_()
    keep, max_in, log2 = _fx_args(fx, dev)
    scratch = torch.empty(plan["scratch_words"], dtype=torch.int64,
                          device=dev)
    rc = load().lgbm_seg_sum(pv, pi, scratch.data_ptr(), out.data_ptr(), k,
                             L, N, plan["blocks"], plan["nparts"],
                             fx_log2_rows(N) if log2 is None else log2,
                             int(plan["vec"]), max_in, _stream(dev))
    _check(rc, "seg_sum")
    del keep
    LAUNCHES["seg_sum"] += 1
    if fx is not None:
        # the accumulator keeps the int64 sums (csrc/seg_sum.cu)
        return scratch[:k * L].reshape(k, L).clone()
    return out

