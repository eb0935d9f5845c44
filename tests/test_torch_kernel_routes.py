"""The launch decisions of the take_small and hist_nat f32 wrappers
(learner/cuda_hist.py), which are plain Python and run without a card:
hist_nat's f32 grid (one pass over the rows at every slot count), its
prepass and its 16-byte loads, and take_small's grid and idx
alignment. The kernels themselves are held against their plain
versions in tests/test_torch_cuda.py."""

import pytest

from lightgbm_tpu_torch.learner import cuda_hist as ch

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
