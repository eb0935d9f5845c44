"""The launch decisions of the kernel wrappers (learner/cuda_hist.py),
which are plain Python and run without a card: hist_nat's f32 grid (one
pass over the rows at every slot count), its prepass and its 16-byte
loads; take_small's grid and idx alignment; take_rows' grid, idx
alignment and refusals (take_rows_plan); seg_sum's grid, prepass,
loads, tile and scratch; hist_round's partition blocks, work-list bound,
column groups, scratch sizes and shared-memory fit, and the refusals
beyond it; hist's and hist_slots' work list (hist_plan, hist_slots_plan,
seg_items), tiles, plan blocks and refusals. The kernels themselves are
held against their plain versions in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.learner import cuda_hist as ch
from _port_threads import one_torch_thread

one_torch_thread()  # one torch thread a test worker (see the module)

SMS = 132  # H100 SXM
N_REFIT = 1_001_472  # 1M rows padded to the 2048-row block


def test_refit_shape_takes_one_pass_over_the_rows():
    """One column, 256 leaf slots, 256 bins: the (S, 3, Bc) int64 tile
    is 1.5 MB, far past one block's shared memory, so the rows go once
    through global atomics: one 1024-row step per block, no slot chunks
    and no row chunks."""
    p = ch.hist_nat_f32_plan(N_REFIT, SMS)
    assert p["blocks"] == -(-N_REFIT // 1024) == 978
    assert p["nparts"] == -(-N_REFIT // 4096) == 245
    assert p["vec"]


@pytest.mark.parametrize("n,blocks", [
    (100_352, 98), (N_REFIT, 978), (N_REFIT + 1, 979), (5, 1), (4096, 4),
    (10 ** 7, 8 * SMS)])
def test_f32_grid_is_sized_to_the_rows(n, blocks):
    """The histogram's grid follows the rows alone, whatever the slot
    count (31 leaves, whose tile would fit a block, run the same one
    pass as 255), capped at one wave of 8 blocks per SM."""
    assert ch.hist_nat_f32_plan(n, SMS)["blocks"] == blocks


@pytest.mark.parametrize("n,aligned,vec", [
    (N_REFIT, True, True), (N_REFIT + 1, True, False),
    (N_REFIT, False, False), (8, True, True)])
def test_f32_vector_loads_need_whole_groups_and_alignment(n, aligned, vec):
    """16-byte loads of slot, bins and channels need rows in whole groups
    of 4 (each channel row starts 16-byte aligned) and aligned inputs."""
    assert ch.hist_nat_f32_plan(n, SMS, aligned)["vec"] == vec


def test_prepass_blocks_stay_within_the_parts_buffer():
    """The prepass writes one row of maxima per block; its grid never
    passes the 256 rows the kernel accepts, and has at least one."""
    assert ch.hist_nat_f32_plan(5, SMS)["nparts"] == 1
    assert ch.hist_nat_f32_plan(10 ** 8, SMS)["nparts"] == 256


@pytest.mark.parametrize("n,blocks", [
    (100_352, 98), (N_REFIT, 978), (N_REFIT + 1, 979), (5, 1),
    (10 ** 7, 8 * SMS)])
def test_take_small_grid_is_sized_to_the_rows(n, blocks):
    """One 1024-row step per block (256 threads x 4 rows), capped at one
    wave of 8 blocks per SM: a 100k-row traversal stages its table in 98
    blocks, not in 8 per SM."""
    assert ch.take_small_plan(n, SMS, 0)[0] == blocks


@pytest.mark.parametrize("ptr,vec", [(0x7f0000000000, 1),
                                     (0x7f0000000004, 0),
                                     (0x7f0000000010, 1),
                                     (0x7f000000000c, 0)])
def test_take_small_idx_alignment(ptr, vec):
    """idx is read 16 bytes at a time only from a 16-byte-aligned
    pointer; an offset view takes the scalar loads."""
    assert ch.take_small_plan(N_REFIT, SMS, ptr)[1] == vec


# ---- take_rows (csrc/take_small.cu): the serving forest's node-major
# gather; the plan takes CPU tensors (it reads dtypes, shapes, strides
# and data pointers only)
SERVE_L, SERVE_LANES = 500 * 254, 4096 * 500  # 500 trees, a 4096-row rung


def _rows_table(L=SERVE_L, kp=16, offset=0, dtype=torch.float32):
    """An (L, kp) table whose data starts `offset` elements into a
    fresh (64-byte aligned) allocation."""
    return torch.zeros(L * kp + offset, dtype=dtype)[offset:].view(L, kp)


def test_take_rows_plan_at_the_serving_shape():
    """2,048,000 lanes need 2,000 steps of 1,024 lanes: the grid is one
    wave of 8 blocks per SM, which strides over the rest; idx is read 16
    bytes at a time."""
    idx = torch.zeros(SERVE_LANES, dtype=torch.int32)
    p = ch.take_rows_plan(_rows_table(), idx, 9, SMS)
    assert p == dict(blocks=8 * SMS, vec_idx=1, L=SERVE_L, N=SERVE_LANES)


@pytest.mark.parametrize("n,blocks", [(1, 1), (1027, 2), (16 * 500, 8),
                                      (SERVE_LANES, 8 * SMS)])
def test_take_rows_grid_is_take_smalls(n, blocks):
    idx = torch.zeros(n, dtype=torch.int32)
    assert ch.take_rows_plan(_rows_table(), idx, 9, SMS)["blocks"] == blocks
    assert blocks == ch.take_small_plan(n, SMS, 0)[0]


@pytest.mark.parametrize("offset,vec", [(0, 1), (1, 0), (2, 0), (3, 0),
                                        (4, 1)])
def test_take_rows_idx_alignment(offset, vec):
    """An idx view that does not start on 16 bytes takes the scalar
    loads; the table has no such path (it is refused instead)."""
    idx = torch.zeros(4096 + offset, dtype=torch.int32)[offset:]
    assert ch.take_rows_plan(_rows_table(), idx, 9, SMS)["vec_idx"] == vec


@pytest.mark.parametrize("kp", [12, 16])
def test_take_rows_takes_every_compiled_width(kp):
    """The kernel is compiled for the forest's 16-float records only
    (TAKE_ROWS_RECORD); 12, which it was timed against, is refused."""
    idx = torch.zeros(8, dtype=torch.int32)
    tab = _rows_table(L=64, kp=kp)
    if kp == ch.TAKE_ROWS_RECORD:
        assert ch.take_rows_plan(tab, idx, 9, SMS)["L"] == 64
    else:
        with pytest.raises(ValueError, match=f"record of {kp}"):
            ch.take_rows_plan(tab, idx, 9, SMS)


@pytest.mark.parametrize("case,exc,match", [
    ("misaligned", ValueError, "16-byte aligned"),
    ("kp8", ValueError, "record of 8"),
    ("kp9", ValueError, "record of 9"),
    ("kp10", ValueError, "record of 10"),
    ("kp20", ValueError, "record of 20"),
    ("k0", ValueError, "outside"),
    ("k17", ValueError, "outside"),
    ("f64_table", TypeError, "float32"),
    ("i64_idx", TypeError, "int32"),
    ("f32_idx", TypeError, "int32"),
    ("strided_table", ValueError, "contiguous"),
    ("strided_idx", ValueError, "contiguous"),
    ("flat_table", ValueError, "dims|\\(L, kp\\)"),
])
def test_take_rows_plan_refuses(case, exc, match):
    """A table 4 bytes off 16-byte alignment (its records would straddle
    the kernel's 16-byte loads), a record width other than 16, k outside
    1..16, wrong dtypes, strided or flat inputs: each raises before any
    launch."""
    tab, idx, k = _rows_table(L=64), torch.zeros(64, dtype=torch.int32), 9
    if case == "misaligned":
        tab = _rows_table(L=64, offset=1)
    elif case.startswith("kp"):
        tab = _rows_table(L=64, kp=int(case[2:]))
    elif case.startswith("k"):
        k = int(case[1:])
    elif case == "f64_table":
        tab = _rows_table(L=64, dtype=torch.float64)
    elif case == "i64_idx":
        idx = idx.long()
    elif case == "f32_idx":
        idx = idx.float()
    elif case == "strided_table":
        tab = _rows_table(L=64, kp=32)[:, ::2]
    elif case == "strided_idx":
        idx = torch.zeros(128, dtype=torch.int32)[::2]
    elif case == "flat_table":
        tab = tab.reshape(-1)
    with pytest.raises(exc, match=match):
        ch.take_rows_plan(tab, idx, k, SMS)


def test_take_rows_wrapper_takes_only_cuda_tensors():
    """The kernel's wrapper never runs the plain version: a CPU tensor
    is refused before any launch (histogram.take_rows sends it to
    take_rows_plain instead)."""
    before = ch.LAUNCHES["take_small"]
    with pytest.raises(ValueError, match="CUDA"):
        ch.take_rows(_rows_table(L=64), torch.zeros(8, dtype=torch.int32), 9)
    assert ch.LAUNCHES["take_small"] == before


# ---- seg_sum (csrc/seg_sum.cu): a prepass and one pass of the sums


def test_seg_sum_plan_at_the_renewal_shape():
    """k = 2 channels over the 255 leaves of 1M rows: about two blocks
    per SM walk the rows, the prepass writes one row of maxima per 4096
    rows, the (2, 255) int64 tile is 4 KB, and the scratch holds the
    accumulator, the done counter and the maxima."""
    p = ch.seg_sum_plan(2, 255, N_REFIT, SMS)
    assert p["blocks"] == 2 * SMS
    assert p["nparts"] == -(-N_REFIT // 4096) == 245
    assert p["vec"] and p["smem"] == 2 * 255 * 8
    assert p["scratch_words"] == 510 + 1 + 245


@pytest.mark.parametrize("n,blocks", [(5, 1), (2048, 2), (100_352, 98),
                                      (N_REFIT, 2 * SMS), (10 ** 8, 2 * SMS)])
def test_seg_sum_grid_is_sized_to_the_card(n, blocks):
    """At most two blocks per SM, each walking many rows (not one block
    per 2048 rows), and no block with under 1024 rows to walk."""
    assert ch.seg_sum_plan(1, 31, n, SMS)["blocks"] == blocks


@pytest.mark.parametrize("n,aligned,vec", [
    (N_REFIT, True, True), (N_REFIT + 1, True, False),
    (N_REFIT, False, False)])
def test_seg_sum_vector_loads_need_whole_groups_and_alignment(n, aligned,
                                                              vec):
    assert ch.seg_sum_plan(2, 255, n, SMS, aligned)["vec"] == vec


@pytest.mark.parametrize("k,L", [(0, 255), (4, 255), (3, 10_000),
                                 (1, 29_000)])
def test_seg_sum_refuses_beyond_the_kernel(k, L):
    """1 to 3 channels, and a (k, L) int64 tile that one block's shared
    memory holds."""
    with pytest.raises(ValueError):
        ch.seg_sum_plan(k, L, N_REFIT, SMS)


def test_seg_sum_prepass_blocks_stay_within_the_maxima():
    assert ch.seg_sum_plan(1, 31, 5, SMS)["nparts"] == 1
    assert ch.seg_sum_plan(1, 31, 10 ** 9, SMS)["nparts"] == 256


# ---- hist_round (csrc/hist_round.cu): a partition, then a histogram
# over the kept rows' work items

G_MAIN, BC, L_MAIN = 28, 256, 255


def test_hist_round_plan_at_the_main_path_shape():
    """1M rows, 28 columns, 48 slots: 489 partition blocks; the kept rows
    cut into items of at least ROUND_CHUNK rows, at most ROUND_SLOT_ITEMS
    a slot; 7 column groups of 4; every scratch size from the shapes."""
    p = ch.hist_round_plan(G_MAIN, N_REFIT, 48, BC, L_MAIN)
    assert p["nb"] == -(-N_REFIT // 2048) == 489
    assert (p["chunk"], p["slot_items"]) == (ch.ROUND_CHUNK,
                                             ch.ROUND_SLOT_ITEMS)
    assert (p["gc"], p["n_cg"]) == (4, 7)
    assert p["max_items"] == min(-(-N_REFIT // p["chunk"]) + 48,
                                 48 * p["slot_items"])
    assert p["state_words"] == 1 + 48 + 48 * 7
    assert p["work_words"] == (4 + 3 * 48 + 2 * p["max_items"]
                               + 2 * 48 * 489 + 3 * 489)
    assert p["list_words"] == N_REFIT
    assert p["acc_words"] == 48 * 3 * G_MAIN * BC


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("has_cat", [False, True])
@pytest.mark.parametrize("S", [1, 8, 32, 48])
def test_hist_round_tiles_fit_two_blocks_per_sm(S, has_cat, f32):
    """At the rounds grower's slot widths, 256 bins and 255 leaves, in
    every mode: the partition's table, params and category sets, and the
    histogram's tile (int32 cells, int64 in the f32 mode) beside the
    staged row counts, leave room for at least two blocks per SM."""
    p = ch.hist_round_plan(G_MAIN, N_REFIT, S, BC, L_MAIN, f32, has_cat)
    assert 2 * (p["smem_hist"] + ch._SMEM_STATIC) <= 233472
    assert 2 * (p["smem_part"] + ch._SMEM_STATIC) <= 233472
    assert p["smem_hist"] >= 3 * p["gc"] * BC * (8 if f32 else 4)
    assert p["gc"] * p["n_cg"] >= G_MAIN and p["gc"] <= 8


def _items(T, chunk, slot_items):
    return sum(max(1, min(slot_items, -(-t // chunk))) for t in T)


@pytest.mark.parametrize("case", ["one_slot_all", "one_slot_half",
                                  "even", "ragged", "empty", "tiny"])
@pytest.mark.parametrize("S", [1, 8, 48])
def test_hist_round_work_list_fits_its_bound(case, S):
    """However the kept rows (at most N) fall over the slots, the work
    items the partition's last block writes fit the histogram grid's
    bound (max_items)."""
    n = 100_000
    rs = np.random.RandomState(S)
    T = {"one_slot_all": [n] + [0] * (S - 1),
         "one_slot_half": [n // 2] + [0] * (S - 1),
         "even": [n // S] * S,
         "ragged": list(rs.multinomial(n, np.ones(S) / S)),
         "empty": [0] * S,
         "tiny": [1] * S}[case]
    p = ch.hist_round_plan(G_MAIN, n, S, BC, L_MAIN)
    assert _items(T, p["chunk"], p["slot_items"]) <= p["max_items"]


def test_hist_round_caps_a_large_slots_items():
    """A first round (one slot holding half of 1M rows) takes at most
    ROUND_SLOT_ITEMS items, so its atomic flush stays bounded."""
    p = ch.hist_round_plan(G_MAIN, N_REFIT, 8, BC, L_MAIN)
    assert _items([N_REFIT // 2] + [0] * 7, p["chunk"],
                  p["slot_items"]) == p["slot_items"] + 7


@pytest.mark.parametrize("kw", [
    dict(N=8192 * 2048 + 1),  # more partition blocks than a block stages
    dict(L=60_000),  # a leaf table past shared memory
    dict(S=3000, has_cat=True),  # params and category sets past it
    dict(Bc=20_000, f32=True),  # one column's int64 tile past it
])
def test_hist_round_refuses_beyond_the_fit(kw):
    """hist_round's wrapper plans before it launches and raises
    ValueError where the kernel's shared memory cannot hold the call."""
    args = dict(G=G_MAIN, N=N_REFIT, S=48, Bc=BC, L=L_MAIN)
    args.update(kw)
    with pytest.raises(ValueError, match="kernel limit"):
        ch.hist_round_plan(**args)


def test_hist_plan_at_the_main_path_shape():
    """The root of the main path (1M rows, 28 columns, 256 bins): column
    groups of at most SEG_COLS columns, split evenly; at most
    SEG_SLOT_ITEMS items; the plan's blocks over the rows; every scratch
    size from the shapes."""
    p = ch.hist_plan(G_MAIN, N_REFIT, N_REFIT, BC)
    assert p["gc"] <= ch.SEG_COLS and p["gc"] * p["n_cg"] >= G_MAIN
    assert (p["n_cg"] - 1) * p["gc"] < G_MAIN  # no empty column group
    assert p["max_items"] == min(-(-N_REFIT // p["chunk"]) + 1,
                                 p["slot_items"])
    assert p["plan_blocks"] == min(ch.SEG_PLAN_BLOCKS,
                                   -(-N_REFIT // ch.SEG_PLAN_ROWS))
    assert p["smem"] == 9 * p["gc"] * BC * 4
    assert p["state_words"] == 4 + p["n_cg"]
    assert p["work_words"] == 4 + 4 * p["max_items"]
    assert p["acc_words"] == 3 * G_MAIN * BC


def test_hist_slots_plan_at_the_round_shape():
    """A round of the exact grower's round phase at 255 leaves: S = 128
    slots over 1M rows."""
    p = ch.hist_slots_plan(G_MAIN, N_REFIT, 128, BC)
    assert p["max_items"] == min(-(-N_REFIT // p["chunk"]) + 128,
                                 128 * p["slot_items"])
    assert p["state_words"] == 4 + 128 * p["n_cg"]
    assert p["work_words"] == 4 + 4 * p["max_items"]
    assert p["acc_words"] == 128 * 3 * G_MAIN * BC


def _seg_rows(case, n, S, rs):
    """Row counts of S disjoint segments of n rows."""
    return {"one_slot_all": [n] + [0] * (S - 1),
            "one_slot_half": [n // 2] + [0] * (S - 1),
            "even": [n // S] * S,
            "ragged": list(rs.multinomial(n, np.ones(S) / S)),
            "tiny": [min(1, n // S)] * S}[case]


@pytest.mark.parametrize("case", ["one_slot_all", "one_slot_half", "even",
                                  "ragged", "tiny"])
@pytest.mark.parametrize("S", [1, 128, 129])
@pytest.mark.parametrize("n", [1, 2047, 2048, N_REFIT])
def test_seg_work_list_fits_its_bound(n, S, case):
    """However the rows fall over the slots (at most n in all), the work
    items the plan launch writes fit the histogram grid's bound
    (max_items); for S = 1 that is hist's plan at cap = n."""
    rs = np.random.RandomState(S + n % 1000)
    T = _seg_rows(case, n, S, rs)
    assert sum(T) <= n
    p = (ch.hist_plan(G_MAIN, n, n, BC) if S == 1
         else ch.hist_slots_plan(G_MAIN, n, S, BC))
    assert sum(ch.seg_items(t, p)[0] for t in T) <= p["max_items"]


@pytest.mark.parametrize("T", [0, 1, 2, 4095, 4096, 4097, 100_000,
                               500_736, N_REFIT])
def test_seg_items_of_a_slot(T):
    """A slot of T rows gets max(1, min(slot_items, ceil(T / chunk)))
    items of ceil(T / items) rows; the items cover the T rows, each holds
    at most SEG_ITEM_ROWS (the tile's 32-bit limbs stay exact) and, with
    chunk >= slot_items, none of them is empty."""
    p = ch.hist_plan(G_MAIN, N_REFIT, N_REFIT, BC)
    n, per = ch.seg_items(T, p)
    assert n == max(1, min(p["slot_items"], -(-T // p["chunk"])))
    assert per == max(1, -(-T // n)) and n * per >= T
    assert per <= ch.SEG_ITEM_ROWS
    assert p["chunk"] >= p["slot_items"]
    assert T == 0 or (n - 1) * per < T


@pytest.mark.parametrize("n", [64 * 65_536, 64 * 65_536 + 1, 10_000_000,
                               1 << 30])
def test_seg_items_stay_within_the_limbs(n):
    """Past SEG_SLOT_ITEMS x SEG_ITEM_ROWS rows the plan gives a slot more
    items, so that even a slot of all n rows has items of at most
    SEG_ITEM_ROWS rows, in hist and hist_slots."""
    for p in (ch.hist_plan(G_MAIN, n, n, BC),
              ch.hist_slots_plan(G_MAIN, n, 128, BC)):
        assert p["slot_items"] == max(ch.SEG_SLOT_ITEMS,
                                      -(-n // ch.SEG_ITEM_ROWS))
        assert ch.seg_items(n, p)[1] <= ch.SEG_ITEM_ROWS


@pytest.mark.parametrize("G", [1, 7, 28, 29, 64])
@pytest.mark.parametrize("Bc", [2, 3, 64, 255, 256])
def test_seg_tiles_fit_shared_memory(Bc, G):
    """At 2 to 256 bins and 1 to 64 columns the (3, gc, Bc) tile (three
    uint32 limbs a cell) fits a block's shared memory beside its static
    part, the column groups cover G with none empty, and hist and
    hist_slots plan the same tiles."""
    for p in (ch.hist_plan(G, N_REFIT, 5000, Bc),
              ch.hist_slots_plan(G, N_REFIT, 128, Bc)):
        assert p["smem"] == 9 * p["gc"] * Bc * 4
        assert p["smem"] + ch._SMEM_STATIC <= ch._MAX_SMEM
        assert 1 <= p["gc"] <= ch.SEG_COLS
        assert p["gc"] * p["n_cg"] >= G > (p["n_cg"] - 1) * p["gc"]


@pytest.mark.parametrize("cap", [1, 8191, 8192, 8193, 500_736, N_REFIT])
def test_hist_plan_blocks_follow_the_cap(cap):
    """hist's plan takes the scale over the segment: about SEG_PLAN_ROWS
    rows a block, at most SEG_PLAN_BLOCKS blocks; its item bound follows
    the cap, not N."""
    p = ch.hist_plan(G_MAIN, N_REFIT, cap, BC)
    assert p["plan_blocks"] == max(1, min(ch.SEG_PLAN_BLOCKS,
                                          -(-cap // ch.SEG_PLAN_ROWS)))
    assert p["max_items"] == min(-(-cap // p["chunk"]) + 1,
                                 p["slot_items"])


@pytest.mark.parametrize("fn,kw,limit", [
    ("hist_plan", dict(Bc=7000), "shared memory"),
    ("hist_slots_plan", dict(Bc=6500), "shared memory"),
    ("hist_plan", dict(N=(1 << 30) + 1), "rows"),
    ("hist_slots_plan", dict(G=65536 * 7 + 1, Bc=256), "column groups"),
    ("hist_slots_plan", dict(S=1 << 31), "work-list bound"),
])
def test_seg_plans_refuse_beyond_the_kernel(fn, kw, limit):
    """hist's and hist_slots' wrappers plan before they launch and raise
    ValueError, naming the limit, where the kernel cannot take the call:
    a column's tile past shared memory, more rows than the kernel's
    int32 row arithmetic takes, more column groups than a grid holds, a
    work list past 2^31 - 1 items."""
    args = dict(G=G_MAIN, N=N_REFIT, Bc=BC)
    args.update(kw)
    if fn == "hist_plan":
        args["cap"] = args["N"]
    else:
        args["S"] = kw.get("S", 128)
    with pytest.raises(ValueError, match="kernel limit") as e:
        getattr(ch, fn)(**args)
    assert limit in str(e.value)


# ---- hist_nat's integer modes (csrc/hist_nat.cu "integer modes"): a grid
# sized to the card over (slot chunk, column group, row split) items


def _nat_tile_bytes(p, Bc):
    return p["Sc"] * 12 * Bc * p["P"]


def test_hist_nat_plan_at_the_root_shape():
    """The root of the int16 and int8 paths (1,001,472 rows, 28 columns,
    256 bins, one slot): the staged path, its 48 KB tile of 16 positions
    a cell beside two stages of 1152 rows; a lane one of 16 columns, so
    two column groups of 14 (slot and levels read twice); one block of
    1024 threads a SM, each taking one (column group, row split) item:
    66 row splits a group, each cell combined from 66 partials."""
    for int8 in (False, True):
        p = ch.hist_nat_plan(G_MAIN, N_REFIT, 1, BC, SMS, int8=int8)
        assert (p["P"], p["W"], p["Gc"], p["n_cg"]) == (16, 16, 14, 2)
        assert (p["Sc"], p["n_sc"], p["tiles"]) == (1, 1, 2)
        assert p["vec"] and (p["chunk"], p["stages"]) == (1152, 2)
        assert p["stage_bytes"] == 2 * 4 * (
            14 * (1152 + 4) + 1152 + 3 * (1152 // 4 if int8 else 1152))
        assert p["smem"] == 12 * BC * 16 + p["stage_bytes"]
        assert p["grid"] == SMS == p["items"]
        assert p["R"] == 66 and p["rows"] == 15_200
        assert (p["R"] - 1) * p["rows"] < N_REFIT <= p["R"] * p["rows"]
        assert p["tcp"] == 3 * BC * 14
        assert p["part_words"] == 132 * 3 * BC * 14


@pytest.mark.parametrize("G", [1, 2, 7, 28, 32, 33, 64])
@pytest.mark.parametrize("Bc", [2, 16, 64, 255, 256, 605, 1000, 5000,
                                19_285])
def test_hist_nat_tiles_fit_shared_memory(Bc, G):
    """From 2 to 19,285 bins and 1 to 64 columns: the tile (Sc slots x 3
    channels x Bc bins x P positions, int32), the row stages where the
    staged path runs, and the reduction's staging fit the block's shared
    memory beside its static part; P is a power of two that halves only
    where 32 positions do not fit the budget (the staged path's
    NAT_TILE_BYTES beside its stages, else the block; one position may
    take the whole block); a lane's column set W is a power of two
    within P, and the column groups (at most W columns each) cover G
    with none empty; a block takes at most half a SM's 2048 threads."""
    p = ch.hist_nat_plan(G, N_REFIT, 4, Bc, SMS)
    room = ch._MAX_SMEM - ch._SMEM_STATIC
    assert _nat_tile_bytes(p, Bc) + p["stage_bytes"] <= p["smem"] <= room
    assert p["vec"] == (p["stage_bytes"] > 0)
    assert p["smem"] >= ch.NAT_THREADS // 32 * 512
    assert p["P"] in (1, 2, 4, 8, 16, 32)
    budget = min(ch.NAT_TILE_BYTES, room) if p["vec"] else room
    assert p["P"] == 1 or 12 * Bc * p["P"] <= budget
    if p["P"] < 32:  # twice the positions would not fit
        w2 = min(2 * p["P"], 1 << (G - 1).bit_length())
        gc2 = -(-G // -(-G // w2))
        st2 = ch.NAT_STAGES * ch._nat_stage_bytes(ch.NAT_CHUNK, gc2, False)
        assert (12 * Bc * 2 * p["P"] > budget
                or 12 * Bc * 2 * p["P"] + (st2 if p["vec"] else 0) > room)
    assert p["W"] <= p["P"] and p["W"] & (p["W"] - 1) == 0
    assert p["W"] == min(p["P"], 1 << (G - 1).bit_length())
    assert 1 <= p["Gc"] <= p["W"]
    assert p["Gc"] * p["n_cg"] >= G > (p["n_cg"] - 1) * p["Gc"]
    assert p["threads"] == ch.NAT_THREADS <= 1024


@pytest.mark.parametrize("S", [1, 4, 48, 400])
@pytest.mark.parametrize("n", [1, 31, 4096, 100_003, N_REFIT, (1 << 24) + 5])
def test_hist_nat_items_cover_the_rows(n, S):
    """At every row and slot count the row splits are multiples of 32
    rows (16-byte aligned starts), cover the N rows with none empty, and
    give a split at most one per NAT_MIN_ITEM_ROWS rows; the slot chunks
    cover S; the grid holds at most the card's blocks and at most one
    block an item, so a cooperative launch fits the card."""
    p = ch.hist_nat_plan(7, n, S, 64, SMS)
    assert p["rows"] % 32 == 0 and p["rows"] >= 32
    assert (p["R"] - 1) * p["rows"] < n <= p["R"] * p["rows"]
    assert p["R"] == 1 or p["R"] <= max(-(-n // ch.NAT_MIN_ITEM_ROWS),
                                        -(-n // ch.NAT_ITEM_ROWS))
    assert p["Sc"] * p["n_sc"] >= S > (p["n_sc"] - 1) * p["Sc"]
    assert p["tiles"] == p["n_sc"] * p["n_cg"]
    assert p["items"] == p["tiles"] * p["R"]
    assert p["grid"] == min(p["items"], SMS)
    # the staged path where the rows allow it and the staged tile holds
    # every slot: a slot of 64 bins at 32 positions takes 24 KB, two fit
    # NAT_TILE_BYTES
    assert p["vec"] == (n % 16 == 0 and S <= 2)
    assert p["tcp"] % 4 == 0 and p["tcp"] >= p["Sc"] * 3 * 64 * p["Gc"]


@pytest.mark.parametrize("n", [1 << 23, (1 << 23) + 1, 1 << 26, 2 ** 31 - 1])
def test_hist_nat_items_keep_int32_cells(n):
    """An item holds at most NAT_ITEM_ROWS = 2^23 - 32 rows, so its int32 tile
    cells stay below 2^31 at 256 levels, at any row count the kernel's
    int32 row arithmetic takes (the final sums are guarded by
    check_int_range)."""
    p = ch.hist_nat_plan(G_MAIN, n, 1, BC, SMS)
    assert p["rows"] <= ch.NAT_ITEM_ROWS == (1 << 23) - 32
    assert p["rows"] * 256 < 2 ** 31
    assert p["R"] * p["rows"] >= n


@pytest.mark.parametrize("n,levels,ok", [
    (N_REFIT, 256, True), (N_REFIT, 127, True), (8_388_607, 256, True),
    (8_388_608, 256, False), (16_909_320, 127, True),
    (16_909_321, 127, False)])
def test_hist_nat_final_sums_are_guarded(n, levels, ok):
    """check_int_range, which the wrapper calls before it plans, refuses
    a call whose worst-case cell sum (rows x levels) reaches 2^31."""
    if ok:
        ch.check_int_range(n, levels)
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            ch.check_int_range(n, levels)


@pytest.mark.parametrize("n,aligned,vec", [
    (N_REFIT, True, True), (N_REFIT + 1, True, False),
    (N_REFIT + 4, True, False), (N_REFIT + 16, True, True),
    (N_REFIT, False, False), (16, True, True), (8, True, False)])
def test_hist_nat_stages_need_whole_groups_and_alignment(n, aligned, vec):
    """The staged path copies 16 bytes at a time (16 int8 levels), so it
    needs N % 16 == 0 (each column, slot and channel row then starts
    aligned) and aligned inputs; otherwise each lane loads its own rows,
    and no stage takes shared memory."""
    for int8 in (False, True):
        p = ch.hist_nat_plan(G_MAIN, n, 1, BC, SMS, aligned, int8)
        assert p["vec"] == vec and (p["stage_bytes"] > 0) == vec


@pytest.mark.parametrize("kw,limit", [
    (dict(Bc=19_286), "shared memory"),
    (dict(Bc=100_000), "shared memory"),
    (dict(N=0), "empty"),
    (dict(S=0), "empty"),
    (dict(G=0), "empty"),
])
def test_hist_nat_refuses_beyond_the_kernel(kw, limit):
    """The wrapper plans before it launches and raises ValueError where
    the kernel cannot take the call: one slot's tile at one position a
    cell past a block's shared memory; an empty call (the wrapper
    answers those itself, with zeros)."""
    args = dict(G=G_MAIN, N=N_REFIT, S=1, Bc=BC, sms=SMS)
    args.update(kw)
    with pytest.raises(ValueError) as e:
        ch.hist_nat_plan(**args)
    assert limit in str(e.value)
    if limit == "shared memory":
        assert "kernel limit" in str(e.value)


def test_hist_nat_scratch_only_where_items_combine():
    """A tile of several items combines through partial tiles (items x
    tcp words, written whole, never zeroed); a call whose tiles are each
    one item (many slots) writes its output directly and needs none."""
    p = ch.hist_nat_plan(G_MAIN, N_REFIT, 1, BC, SMS)
    assert p["R"] > 1 and p["part_words"] == p["items"] * p["tcp"]
    q = ch.hist_nat_plan(7, 8192, 4000, 256, SMS)
    assert q["R"] == 1 and q["tiles"] >= SMS
    assert q["part_words"] == 0
