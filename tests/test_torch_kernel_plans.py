"""The host-side plans of the port's CUDA kernels, on the CPU.

- ``ops.pool.plan_maxpool_bwd`` / ``pool_band`` / ``pool_smem_bytes``:
  the one-launch max-pool backward splits a call into bands of output
  rows and columns and slabs of channels.  Along each dimension every
  input is owned (its dx written) by exactly one band, including inputs
  no window reaches; every window that reaches an owned input is staged
  by that band, with all its taps; the 16-byte path is taken exactly
  when a pixel's channels fill 16-byte vectors and every operand starts
  on 16 bytes; the shared memory of the largest band stays within the
  figure the plan gives.
- ``ops.lrn.plan_lrn``: the LRN kernels' persistent grid walks tiles
  of whole rows; every row lies in exactly one tile and the CTAs' tiles
  cover the call once (m = 1, m one row past a tile, AlexNet's rows);
  16-byte runs exactly where a row fills them and every operand starts
  on 16 bytes; the shared memory of the planned CTAs fits an SM; C up
  to ``lrn_max_channels()`` (at least 8192) is taken and above refused.
- ``ops.flash.flash_fwd_instance`` / ``flash_fwd_schedule``: which
  forward instance a call runs, and the persistent forward's order of
  (query tile, head row) items: each exactly once, the longest causal
  rows first, and the CTAs' loads within one tile of each other at the
  LM's shape.
- ``ops.flash.flash_bwd_instance`` / ``flash_bwd_schedule``: the same
  for the dQ and dK/dV kernels (items of 128 queries, or 128 keys, that
  stream 64-row tiles of the other side): the instance by dtype, D and
  the alignment of each row operand; each item exactly once, longest
  first; the CTAs within one item's work of each other at the LM's
  shape.
- ``ops.paged_attention.paged_split_plan``, ``paged_instance`` and
  ``paged_decode_split_plain``: the paged decode kernel's bulk instance
  splits each lane's table across CTAs; every live block lies in
  exactly one split, a split past the lane's length reads nothing, and
  full tables give the card at least two CTAs an SM.  The instance goes
  by dtype, head_dim, heads, 16-byte alignment and (int8) scale planes
  that end on 16 bytes; every layer of an engine's pool takes layer 0's
  instance.  The plain mirror of
  the split and combine equals the plain versions (fp32 and int8) at
  every split size, with length-0 lanes, lanes whose only live split is
  the first, and tables not a multiple of the split.

Small sizes; torch capped at one thread."""

import itertools

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.ops import flash as FL
from theanompi_tpu_torch.ops import lrn as LR
from theanompi_tpu_torch.ops import paged_attention as PA
from theanompi_tpu_torch.ops import pool as PO
from theanompi_tpu_torch.parallel.quantize import quantize_rows


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (length, window, stride) along one dimension, and band sizes to try
DIMS = [(9, 3, 2), (11, 2, 2), (11, 3, 1), (32, 3, 2), (15, 3, 2),
        (7, 3, 2), (10, 2, 3), (13, 5, 2), (6, 1, 1)]


@pytest.mark.parametrize("length,k,s", DIMS)
def test_pool_bands_own_every_input_once_and_stage_what_they_read(length, k,
                                                                  s):
    out_len = (length - k) // s + 1
    for per in range(1, out_len + 1):
        nb = -(-out_len // per)
        owners = [0] * length
        for b in range(nb):
            band = PO.pool_band(b, per, nb, length, out_len, k, s)
            for i in range(band.o0, band.o1):
                owners[i] += 1
                covering = [p for p in range(out_len) if p * s <= i < p * s + k]
                # the band stages every window that reaches an owned input
                assert all(band.w0 <= p < band.w1 for p in covering)
            # ... and every tap of every staged window
            assert band.x0 == band.w0 * s
            assert band.x1 == (band.w1 - 1) * s + k <= length
            assert band.x0 <= band.o0
        assert owners == [1] * length, (per, owners)


def _shared_bytes_of_band(x_shape, window, stride, itemsize, plan, rb, cb):
    """What csrc/maxpool_bwd.cu stages for band (rb, cb): x, y, shares
    and the two tap tables, each region rounded up to 128 bytes."""
    (kh, kw), (sh, sw) = window, stride
    _, h, w, _ = x_shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    r = PO.pool_band(rb, plan.band_rows, plan.n_bands[0], h, oh, kh, sh)
    c = PO.pool_band(cb, plan.band_cols, plan.n_bands[1], w, ow, kw, sw)
    up = lambda n: -(-n // 128) * 128  # noqa: E731
    wins = (r.w1 - r.w0) * (c.w1 - c.w0) * plan.slab
    return (up((r.x1 - r.x0) * (c.x1 - c.x0) * plan.slab * itemsize)
            + up(wins * itemsize) + up(wins * 4)
            + up((r.o1 - r.o0) * kh * 4) + (c.o1 - c.o0) * kw * 4)


SHAPES = [((2, 9, 11, 3), 3, 2), ((2, 9, 11, 13), 2, 2),
          ((2, 9, 11, 96), 3, 1), ((128, 32, 32, 96), 3, 2),
          ((128, 15, 15, 256), 3, 2), ((128, 7, 7, 256), 3, 2),
          ((1, 9, 2100, 64), 3, 2), ((4, 40, 33, 24), (3, 2), (2, 1))]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("x_shape,window,stride", SHAPES)
def test_pool_plan_fits_and_covers(x_shape, window, stride, itemsize):
    win, st = PO._pair(window), PO._pair(stride)
    plan = PO.plan_maxpool_bwd(x_shape, win, st, itemsize, True)
    n, h, w, c = x_shape
    oh, ow = (h - win[0]) // st[0] + 1, (w - win[1]) // st[1] + 1
    assert plan.n_bands == (-(-oh // plan.band_rows), -(-ow // plan.band_cols))
    assert plan.n_slabs == -(-c // plan.slab)
    assert plan.ctas == n * plan.n_bands[0] * plan.n_bands[1] * plan.n_slabs
    assert plan.slab * itemsize <= PO.POOL_SLAB_BYTES or plan.slab == 1
    assert plan.smem_bytes <= PO.POOL_SMEM_MAX
    assert plan.smem_bytes == PO.pool_smem_bytes(
        x_shape, win, st, itemsize, plan.band_rows, plan.band_cols,
        plan.slab)
    if plan.vec:
        assert plan.slab % (16 // itemsize) == 0
    for rb, cb in itertools.product(range(plan.n_bands[0]),
                                    range(plan.n_bands[1])):
        assert _shared_bytes_of_band(x_shape, win, st, itemsize, plan, rb,
                                     cb) <= plan.smem_bytes


@pytest.mark.parametrize("c,itemsize,aligned,vec", [
    (96, 2, True, True), (96, 4, True, True), (8, 2, True, True),
    (4, 4, True, True), (96, 2, False, False), (13, 2, True, False),
    (3, 4, True, False), (12, 2, True, False), (6, 4, True, False),
])
def test_pool_plan_takes_16_byte_vectors_only_where_they_fit(c, itemsize,
                                                             aligned, vec):
    plan = PO.plan_maxpool_bwd((2, 9, 11, c), (3, 3), (2, 2), itemsize,
                               aligned)
    assert plan.vec is vec


def test_pool_plan_at_alexnet_fills_the_card_in_one_launch_a_call():
    """AlexNet-128's three pools at batch 128: whole-row bands (the two
    small pools in one band), at least two CTAs per SM of an H100."""
    for shape in ((128, 32, 32, 96), (128, 15, 15, 256), (128, 7, 7, 256)):
        plan = PO.plan_maxpool_bwd(shape, (3, 3), (2, 2), 2, True)
        assert plan.vec and plan.n_bands[1] == 1
        assert plan.ctas >= PO.POOL_MIN_CTAS
        assert plan.smem_bytes <= PO.POOL_SMEM_BUDGET


LRN_ALEXNET = ((128 * 32 * 32, 96), (128 * 15 * 15, 256))
LRN_CASES = [(m, c, itemsize, aligned, backward)
             for c in (1, 3, 13, 96, 256, 1024, 4096)
             for itemsize in (4, 2) for aligned in (True, False)
             for backward in (False, True) for m in (1, 198)]


def _lrn_plan_is_sound(plan, m, c, itemsize, backward):
    """What csrc/lrn.cu checks before a launch, and what it assumes."""
    units = -(-c // plan.vec)
    assert plan.vec == 1 or c % plan.vec == 0
    assert 1 <= plan.tx * plan.ty <= LR.LRN_MAX_THREADS
    assert plan.rows % plan.ty == 0 and 2 <= plan.stages <= 8
    assert plan.smem_bytes == LR.lrn_smem_bytes(plan.rows, c, itemsize,
                                                plan.stages, backward)
    assert plan.smem_bytes <= LR.LRN_SMEM_MAX
    # the planned CTAs of an SM fit its shared memory and threads
    assert plan.ctas_per_sm >= 1
    assert (plan.ctas_per_sm * (plan.smem_bytes + LR.LRN_CTA_RESERVED)
            <= LR.LRN_SM_SMEM)
    assert plan.ctas_per_sm * plan.tx * plan.ty <= LR.LRN_SM_THREADS
    assert 1 <= plan.ctas <= min(plan.tiles, plan.ctas_per_sm * LR.LRN_SMS)
    if backward:  # a thread keeps D^-β of its runs in registers
        runs = plan.rows // plan.ty * -(-units // plan.tx)
        assert runs * plan.vec <= LR.LRN_ITEM_FLOATS


@pytest.mark.parametrize("m,c,itemsize,aligned,backward", LRN_CASES + [
    (m, c, itemsize, True, backward) for m, c in LRN_ALEXNET
    for itemsize in (4, 2) for backward in (False, True)])
def test_lrn_plan_tiles_cover_every_row_once(m, c, itemsize, aligned,
                                             backward):
    plan = LR.plan_lrn(m, c, itemsize, aligned, backward)
    _lrn_plan_is_sound(plan, m, c, itemsize, backward)
    assert plan.tiles == -(-m // plan.rows)
    seen = np.zeros(m, np.int64)
    for cta in range(plan.ctas):
        tiles = LR.lrn_cta_tiles(plan, m, cta)
        assert tiles, f"CTA {cta} walks no tile"
        for row0, rows in tiles:
            assert 1 <= rows <= plan.rows
            seen[row0:row0 + rows] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("c,itemsize,backward", [
    (96, 2, False), (96, 4, True), (256, 2, True), (8, 2, False)])
def test_lrn_plan_covers_a_call_one_row_past_a_tile(c, itemsize, backward):
    rows = LR.plan_lrn(10 ** 5, c, itemsize, True, backward).rows
    m = rows + 1
    plan = LR.plan_lrn(m, c, itemsize, True, backward)
    assert plan.rows == rows and plan.tiles == 2
    got = [t for cta in range(plan.ctas) for t in LR.lrn_cta_tiles(plan, m,
                                                                    cta)]
    assert sorted(got) == [(0, rows), (rows, 1)]


@pytest.mark.parametrize("c,itemsize,aligned,vec", [
    (96, 2, True, 8), (96, 4, True, 4), (256, 2, True, 8), (8, 2, True, 8),
    (4, 4, True, 4), (96, 2, False, 1), (96, 4, False, 1), (13, 2, True, 1),
    (3, 4, True, 1), (12, 2, True, 1), (6, 4, True, 1), (1, 2, True, 1),
    (4100, 4, True, 4), (4100, 2, True, 1),
])
def test_lrn_plan_takes_16_byte_runs_only_where_they_fit(c, itemsize,
                                                         aligned, vec):
    for backward in (False, True):
        assert LR.plan_lrn(198, c, itemsize, aligned, backward).vec == vec


def test_lrn_plan_at_alexnet_moves_16_bytes_a_thread_on_a_full_card():
    """AlexNet-128's two LRN inputs at batch 128: 8 bf16 or 4 fp32
    channels a thread, at least two CTAs an SM of an H100, in every
    pass, and tiles to spare for the persistent grid."""
    for m, c in LRN_ALEXNET:
        for itemsize, vec in ((2, 8), (4, 4)):
            for backward in (False, True):
                plan = LR.plan_lrn(m, c, itemsize, True, backward)
                assert plan.vec == vec
                assert plan.ctas_per_sm >= 2
                assert plan.ctas == plan.ctas_per_sm * LR.LRN_SMS
                assert plan.tiles >= 2 * plan.ctas


def test_lrn_plan_takes_channels_up_to_its_limit_and_refuses_above():
    limit = LR.lrn_max_channels()
    assert limit >= 8192
    for itemsize in (4, 2):
        for aligned in (True, False):
            for backward in (False, True):
                for c in (8192, limit):
                    plan = LR.plan_lrn(3, c, itemsize, aligned, backward)
                    _lrn_plan_is_sound(plan, 3, c, itemsize, backward)
                with pytest.raises(ValueError, match="channels"):
                    LR.plan_lrn(3, limit + 1, itemsize, aligned, backward)
    # one more channel would not fit the fp32 backward's two stages
    assert LR.lrn_smem_bytes(1, limit + 1, 4, 2, True) > LR.LRN_SMEM_MAX
    with pytest.raises(ValueError, match="channels"):
        LR.plan_lrn(3, 0, 2, True)


def test_flash_forward_instance_by_shape_dtype_and_alignment():
    bf, f32 = torch.bfloat16, torch.float32
    assert FL.flash_fwd_instance(bf, 64, [0, 16, 32, 48]) == "wgmma"
    assert FL.flash_fwd_instance(bf, 8, [0, 16, 32, 48]) == "wgmma"
    assert FL.flash_fwd_instance(bf, 36, [0, 16, 32, 48]) == "mma"
    assert FL.flash_fwd_instance(bf, 64, [2, 16, 32, 48]) == "mma"
    assert FL.flash_fwd_instance(bf, 96, [0, 16, 32, 48]) == "simt"
    assert FL.flash_fwd_instance(f32, 64, [0, 16, 32, 48]) == "simt"


@pytest.mark.parametrize("bh,t,causal,n_ctas", [
    (64, 1024, True, 132), (64, 1024, False, 132), (3, 129, True, 6),
    (8, 200, False, 16), (1, 1, True, 1), (5, 1000, True, 7),
])
def test_flash_schedule_covers_each_item_once_longest_first(bh, t, causal,
                                                            n_ctas):
    n_q = -(-t // FL.FWD_TILE)
    n_ctas = min(n_ctas, bh * n_q)
    plan = FL.flash_fwd_schedule(bh, t, causal, n_ctas)
    items = [(qt, row) for mine in plan for qt, row, _ in mine]
    assert sorted(items) == sorted(itertools.product(range(n_q), range(bh)))
    assert all(mine for mine in plan)  # every CTA has work
    for mine in plan:
        for qt, _, nk in mine:
            assert nk == (qt + 1 if causal else n_q)
    # round 0 hands out the heaviest items: no CTA's first item is
    # lighter than any item left for a later round
    firsts = min(mine[0][2] for mine in plan)
    later = [nk for mine in plan for _, _, nk in mine[1:]]
    assert all(firsts >= nk for nk in later)


def test_flash_schedule_balances_the_lm_shape():
    """At the LM's rows (64 head rows, T 1024, causal) over an H100's
    132 SMs, the CTAs' K/V tile counts lie within one of each other's
    ceiling: 2304 tiles, 17.45 a CTA, none above 18."""
    plan = FL.flash_fwd_schedule(64, 1024, True, 132)
    loads = [sum(nk for _, _, nk in mine) for mine in plan]
    assert sum(loads) == 64 * 36
    assert max(loads) <= 18 and min(loads) >= 16


@pytest.mark.parametrize("kernel,n_ptrs", [("dq", 5), ("dkv", 6)])
def test_flash_backward_instance_by_shape_dtype_and_alignment(kernel,
                                                              n_ptrs):
    """Row operands: q, k, v, dout and the outputs (dq; or dk, dv)."""
    bf, f32 = torch.bfloat16, torch.float32
    aligned = [64 * i for i in range(n_ptrs)]
    assert FL.flash_bwd_instance(bf, 64, aligned) == "wgmma"
    assert FL.flash_bwd_instance(bf, 8, aligned) == "wgmma"
    assert FL.flash_bwd_instance(bf, 40, aligned) == "wgmma"
    assert FL.flash_bwd_instance(bf, 36, aligned) == "mma"
    for off in range(n_ptrs):  # any one operand off 16 bytes
        ptrs = list(aligned)
        ptrs[off] += 2
        assert FL.flash_bwd_instance(bf, 64, ptrs) == "mma", off
    assert FL.flash_bwd_instance(bf, 96, aligned) == "simt"
    assert FL.flash_bwd_instance(bf, 128, aligned) == "simt"
    assert FL.flash_bwd_instance(f32, 64, aligned) == "simt"
    assert FL.flash_bwd_instance(f32, 32, aligned) == "simt"


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("bh,t,causal,n_ctas", [
    (64, 1024, True, 132), (64, 1024, False, 132), (3, 129, True, 6),
    (8, 200, False, 16), (1, 1, True, 1), (5, 1000, True, 7),
])
def test_flash_bwd_schedule_covers_each_item_once_longest_first(
        kernel, bh, t, causal, n_ctas):
    n_own, n_str = -(-t // FL.FWD_TILE), -(-t // FL.BWD_TILE)
    n_ctas = min(n_ctas, bh * n_own)
    plan = FL.flash_bwd_schedule(kernel, bh, t, causal, n_ctas)
    items = [(tile, row) for mine in plan for tile, row, _ in mine]
    assert sorted(items) == sorted(itertools.product(range(n_own),
                                                     range(bh)))
    assert all(mine for mine in plan)  # every CTA has work
    for mine in plan:
        for tile, _, n in mine:
            # the streamed 64-row tiles that meet the item's 128 rows
            # under the mask: dQ keys [0, 128 (tile + 1)), dK/dV queries
            # [128 tile, t)
            if not causal:
                assert n == n_str
            elif kernel == "dq":
                assert n == min(n_str, 2 * tile + 2)
            else:
                assert n == n_str - 2 * tile >= 1
    firsts = min(mine[0][2] for mine in plan)
    later = [n for mine in plan for _, _, n in mine[1:]]
    assert all(firsts >= n for n in later)


def test_flash_bwd_schedule_rejects_an_unknown_kernel():
    with pytest.raises(ValueError, match="'dq' or 'dkv'"):
        FL.flash_bwd_schedule("fwd", 2, 64, True, 2)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_flash_bwd_schedule_balances_the_lm_shape(kernel):
    """At the LM's rows (64 head rows, T 1024, causal) over an H100's
    132 SMs: 4608 streamed tiles, 34.9 a CTA; the CTAs lie within one
    item's work (16 tiles) of each other, none above 36."""
    plan = FL.flash_bwd_schedule(kernel, 64, 1024, True, 132)
    loads = [sum(n for _, _, n in mine) for mine in plan]
    assert sum(loads) == 64 * 72
    heaviest = max(n for mine in plan for _, _, n in mine)
    assert heaviest == 16
    assert max(loads) - min(loads) <= heaviest
    assert max(loads) <= 36


# (lanes, table entries, block size, SMs)
PAGED_PLANS = [(32, 32, 32, 132), (32, 4, 32, 132), (8, 40, 16, 132),
               (3, 9, 4, 2), (1, 1, 32, 132), (64, 64, 32, 114)]


@pytest.mark.parametrize("n_lanes,n_table,bs,n_sm", PAGED_PLANS)
def test_paged_split_plan_covers_each_live_block_once(n_lanes, n_table, bs,
                                                      n_sm):
    plan = PA.paged_split_plan(n_lanes, n_table, bs, n_sm)
    assert plan.n_splits * plan.blocks_per_split >= n_table
    assert (plan.n_splits - 1) * plan.blocks_per_split < n_table
    for length in range(n_table * bs):
        n_live = length // bs + 1
        seen = [j for i in range(plan.n_splits)
                for j in plan.blocks(i, length, bs, n_table)]
        assert seen == list(range(n_live))  # once each, in order
        for i in range(plan.n_splits):
            if i * plan.blocks_per_split >= n_live:  # past the length
                assert len(plan.blocks(i, length, bs, n_table)) == 0


def test_paged_split_plan_fills_the_card_at_full_tables():
    """32 lanes of 32 full blocks on an H100's 132 SMs: at least about
    two CTAs an SM; short tables take one block a split."""
    plan = PA.paged_split_plan(32, 32, 32, 132)
    assert 32 * plan.n_splits >= 1.9 * 132
    assert PA.paged_split_plan(32, 4, 32, 132).blocks_per_split == 1
    # tiny blocks: a split still holds PAGED_MIN_SPLIT_ROWS rows
    assert PA.paged_split_plan(4, 16, 4, 132).blocks_per_split == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_paged_stage_plan_fits_the_shared_memory(dtype):
    """Wherever the bulk instance runs (fp32 16 x 128 does not)."""
    for h, hd, bs, bps in ((8, 64, 32, 4), (2, 128, 16, 1), (16, 128, 32, 8),
                           (1, 64, 4, 8), (16, 64, 32, 1024)):
        if PA.paged_instance(dtype, h, hd, bs, [0] * 4, 64) != "bulk":
            assert (dtype, h, hd) == (torch.float32, 16, 128)
            continue
        rows, stages, smem = PA.paged_stage_plan(dtype, h, hd, bs, bps)
        assert rows in PA.BULK_ROWS and 2 <= stages <= PA.BULK_MAX_STAGES
        assert smem <= PA.BULK_SMEM_MAX
        esize = torch.empty((), dtype=dtype).element_size()
        assert smem == PA.bulk_smem_bytes(esize, rows, h, hd, stages, bps)


def test_paged_instance_by_dtype_head_dim_and_alignment():
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    aligned = [0, 256, 512, 768]
    for dt in (f32, bf, i8):
        assert PA.paged_instance(dt, 8, 64, 32, aligned, 64) == "bulk"
        assert PA.paged_instance(dt, 2, 128, 16, aligned, 64) == "bulk"
        assert PA.paged_instance(dt, 3, 37, 4, aligned, 64) == "general"
        for off in range(4):  # any pool or scale base off 16 bytes
            ptrs = list(aligned)
            ptrs[off] += 1 if dt == i8 else 4
            assert PA.paged_instance(dt, 8, 64, 32, ptrs, 64) == "general"
    # a row that is not a multiple of 16 bytes
    assert PA.paged_instance(i8, 1, 8, 32, aligned, 64) == "general"
    assert PA.paged_instance(bf, 1, 8, 32, aligned, 64) == "bulk"
    # head_dim past the kernels' layout; heads past one warp each
    assert PA.paged_instance(f32, 8, 130, 32, aligned, 64) == "general"
    assert PA.paged_instance(f32, 17, 64, 32, aligned, 64) == "general"
    # two 8-row stages of 16 fp32 heads of 128 exceed shared memory
    assert PA.paged_instance(f32, 16, 128, 32, aligned, 64) == "general"
    assert PA.paged_instance(bf, 16, 128, 32, aligned, 64) == "bulk"


def test_paged_instance_needs_int8_scale_planes_that_end_on_16_bytes():
    """A chunk's scales are copied in 16-byte units from the boundary
    below them: an int8 plane of R·H floats not a multiple of 16 bytes
    would be read past its end by the copy of its last rows."""
    i8, aligned = torch.int8, [0, 256, 512, 768]
    assert PA.paged_instance(i8, 1, 16, 4, aligned, 4) == "bulk"
    assert PA.paged_instance(i8, 2, 16, 4, aligned, 2) == "bulk"
    for rows, heads in ((3, 1), (5, 1), (6, 1), (3, 2), (1, 3)):
        assert PA.paged_instance(i8, heads, 16, 4, aligned, rows) \
            == "general"
    # fp32 and bf16 pools have no scale plane: any row count
    for dt in (torch.float32, torch.bfloat16):
        assert PA.paged_instance(dt, 1, 16, 4, aligned[:2], 3) == "bulk"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_paged_instance_is_the_same_for_every_layer_of_a_pool(dtype):
    """The engine passes per-layer slices of (layers, R, H, hd) pools and
    (layers, R, H) scale planes: layer i starts i·R·H·hd·esize (scales
    i·R·H·4) bytes past layer 0, so every layer runs layer 0's instance,
    and a bulk layer 0 means every slice is on 16 bytes."""
    esize = torch.empty((), dtype=dtype).element_size()
    n_pools = 4 if dtype == torch.int8 else 2
    for heads, hd, rows in ((8, 64, 257 * 32), (1, 16, 3), (2, 16, 6),
                            (3, 16, 8), (1, 8, 5), (8, 64, 967 * 32)):
        first = PA.paged_instance(dtype, heads, hd, 4, [0] * n_pools, rows)
        for layer in range(1, 4):
            kv = layer * rows * heads * hd * esize
            sc = layer * rows * heads * 4
            ptrs = [kv, 2 ** 30 + kv, 2 ** 31 + sc, 2 ** 32 + sc][:n_pools]
            assert PA.paged_instance(dtype, heads, hd, 4, ptrs, rows) \
                == first
            if first == "bulk":
                assert all(p % 16 == 0 for p in ptrs)


S_, H_, HD_, BS_, NB_, NT_ = 6, 3, 8, 4, 40, 7
# length 0; the last row of the first block; the first split only at
# every split size (3); the whole table; two ragged middles
SPLIT_LENGTHS = [0, 3, 2, 27, 13, 17]


def _split_inputs():
    rng = np.random.RandomState(11)
    q = torch.from_numpy(rng.randn(S_, H_, HD_).astype(np.float32))
    kp = torch.from_numpy(rng.randn(NB_ * BS_, H_, HD_).astype(np.float32))
    vp = torch.from_numpy(rng.randn(NB_ * BS_, H_, HD_).astype(np.float32))
    tables = torch.from_numpy(np.stack([
        rng.choice(NB_ - 1, NT_, replace=False) + 1 for _ in range(S_)
    ]).astype(np.int32))
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("bps", range(1, NT_ + 1))
@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_paged_split_plain_matches_the_plain_versions(pool, bps):
    """fp32 atol 1e-6: the same fp32 arithmetic in another order (and,
    int8, the scales applied to the dot and the weight instead of to
    each element)."""
    q, kp, vp, tables, lengths = _split_inputs()
    if pool == "int8":
        (kq, ks), (vq, vs) = quantize_rows(kp), quantize_rows(vp)
        want = PA.paged_decode_attention_i8_plain(
            q, kq, vq, ks, vs, tables, lengths, block_size=BS_)
        got = PA.paged_decode_split_plain(
            q, kq, vq, tables, lengths, block_size=BS_, blocks_per_split=bps,
            k_scale=ks, v_scale=vs)
    else:
        want = PA.paged_decode_attention_plain(q, kp, vp, tables, lengths,
                                               block_size=BS_)
        got = PA.paged_decode_split_plain(q, kp, vp, tables, lengths,
                                          block_size=BS_,
                                          blocks_per_split=bps)
    assert got.dtype == torch.float32 and got.shape == (S_, H_, HD_)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
