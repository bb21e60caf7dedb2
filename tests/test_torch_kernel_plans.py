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

Small sizes; torch capped at two threads, as the other port tests."""

import itertools

import pytest
import torch

from theanompi_tpu_torch.ops import flash as FL
from theanompi_tpu_torch.ops import pool as PO


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Leave the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
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
