"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``theanompi_tpu.ops.pallas_paged.paged_decode_attention``
(the fp32 / compute-dtype pool kernel ``_paged_kernel`` and the int8
pool kernel ``_paged_kernel_i8``).  One decode tick's attention for
every serving lane: a single query per lane against the K/V rows its
block table points at, rows at positions ``<= length`` attending.

- ``paged_decode_attention`` — the entry the engine calls.  The
  device of ``q`` decides what runs: a CUDA tensor launches the
  hand-written kernel (``csrc/paged_decode_attention.cu``) or raises; a
  CPU tensor takes the plain version; any other device raises.  Nothing
  falls back from the card to the plain version.  int8 pools need
  ``k_scale``/``v_scale`` (one fp32 scale per pool row and head) and go
  to ``paged_decode_attention_i8``.
  ``paged_decode_attention.launches`` counts the fp32/bf16 kernel's
  launches, ``paged_decode_attention_i8.launches`` the int8 kernel's;
  ``.bulk_launches`` beside each counts those of them that ran the
  bulk instance.
- ``paged_decode_attention_plain`` — the gathered-image computation of
  the reference's XLA path (``serving/paging.py`` decode tick): gather
  each lane's whole table image, mask, softmax, weighted sum.  The CPU
  path and the reference the kernel is held to on the card.
- ``paged_decode_attention_i8_plain`` — the same over the dequantized
  image ``int8 · scale`` (the reference's ``_kv_image``), in fp32.
- ``paged_instance`` — which kernel instance a CUDA call runs:
  ``'bulk'`` (tables split across CTAs, all heads of a pool row in one
  CTA, rows staged by 1-D bulk copies; sized by ``paged_split_plan``
  and ``paged_stage_plan``) where a bulk copy can describe the rows,
  ``'general'`` (one CTA per (head, lane)) elsewhere.
- ``paged_decode_split_plain`` — a plain mirror of the bulk instance's
  split and combine (partial softmax per split, merged with weights
  ``exp(m_i − m)``), for the tests and ``chip_smoke.py``.

Numerics: scores, softmax and sums in fp32 on both; the plain version
rounds the probabilities to the pool dtype before the second product
(as the reference's XLA path does), the kernel keeps them fp32 (as the
reference's TPU kernel does).  For fp32 pools the two differ only in
summation order; for bf16 pools by that rounding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from theanompi_tpu_torch import cuda_build
from theanompi_tpu_torch.ops.attention import decode_attention

KERNEL = "paged_decode_attention"
MAX_HEAD_DIM = 128  # the kernels' register layout (csrc: kMaxHeadDim)
_POOL_FNS = {
    torch.float32: "paged_decode_attention_f32",
    torch.bfloat16: "paged_decode_attention_bf16",
}
_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p]
)
_I8_FN = "paged_decode_attention_i8"
_I8_ARGTYPES = [ctypes.c_void_p] * 2 + _ARGTYPES
_BULK_FN = "paged_decode_attention_bulk"
_BULK_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 5 + [ctypes.c_float]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BULK_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
# the bulk instance (csrc: kBulk*): one warp per head, stages of 8, 16
# or 32 rows, the header of mbarriers, H100 shared memory a block may
# take
BULK_MAX_HEADS = 16
BULK_ROWS = (32, 16, 8)
BULK_MAX_STAGES = 16
BULK_HEADER = 256
BULK_SMEM_MAX = 232448
# shared memory the stage plan aims a CTA at (two CTAs fit an SM); the
# split plan's CTAs per SM when every table is full (two resident at a
# time; the splits past a lane's length exit at once, measured best on
# an H100 among 1, 2 and 4 entries a split at 32 x 32 tables); a split
# holds at least PAGED_MIN_SPLIT_ROWS rows (one block at block size 32)
BULK_SMEM_TARGET = 112 * 1024
PAGED_CTAS_PER_SM = 4
PAGED_MIN_SPLIT_ROWS = 32
BULK_MAX_ENTRIES = 1024  # table entries of one split (staged in shared)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _ceil_div(x, m) * m


@dataclasses.dataclass(frozen=True)
class PagedSplitPlan:
    """The bulk instance's grid along a lane's table: split ``i`` takes
    table entries ``[i·bps, (i + 1)·bps)``; ``n_splits`` splits cover
    the table."""

    blocks_per_split: int
    n_splits: int

    def blocks(self, split: int, length: int, block_size: int,
               n_table: int) -> range:
        """The live table entries split ``split`` reads for a lane of
        ``length`` (the kernel's rule): entries up to ``length //
        block_size`` (at most ``n_table - 1``); empty for a split that
        starts past them."""
        n_live = min(length // block_size + 1, n_table)
        j0 = split * self.blocks_per_split
        return range(j0, max(j0, min(j0 + self.blocks_per_split, n_live)))


def paged_split_plan(n_lanes: int, n_table: int, block_size: int,
                     n_sm: int) -> PagedSplitPlan:
    """Table entries per split: about PAGED_CTAS_PER_SM CTAs per SM when
    every lane's table is full, one block a split when the tables are
    short, never fewer than PAGED_MIN_SPLIT_ROWS rows a split, never more
    than BULK_MAX_ENTRIES entries."""
    full = _ceil_div(n_lanes * n_table, PAGED_CTAS_PER_SM * n_sm)
    least = _ceil_div(PAGED_MIN_SPLIT_ROWS, block_size)
    bps = max(1, min(n_table, BULK_MAX_ENTRIES, max(full, least)))
    return PagedSplitPlan(bps, _ceil_div(n_table, bps))


def bulk_smem_bytes(esize: int, rows: int, n_heads: int, head_dim: int,
                    stages: int, blocks_per_split: int) -> int:
    """Dynamic shared memory of a bulk CTA (csrc: ``bulk_smem_bytes``):
    the header, the split's table entries, ``stages`` stages of ``rows``
    rows of K and V and (int8, ``esize`` 1) their scale rows, each of
    those copied from the 16-byte boundary at or below its first."""
    stage = 2 * rows * n_heads * head_dim * esize
    if esize == 1:
        stage += 2 * _round_up(rows * n_heads * 4 + 12, 16)
    return (BULK_HEADER + _round_up(blocks_per_split * 4, 128)
            + stages * stage)


def paged_stage_plan(dtype: torch.dtype, n_heads: int, head_dim: int,
                     block_size: int,
                     blocks_per_split: int = 1) -> Tuple[int, int, int]:
    """(rows a stage, stages, shared bytes) of a bulk CTA: the most rows
    (32, 16 or 8; no more than the smallest of those that holds a
    block) for which two stages fit in BULK_SMEM_TARGET bytes, then as
    many stages as fit (at most BULK_MAX_STAGES).  Falls back to two
    stages of 8 rows when even those exceed the target."""
    target = BULK_SMEM_TARGET
    esize = _ESIZE[dtype]
    cap = min(r for r in BULK_ROWS if r >= min(block_size, 32))
    for rows in BULK_ROWS:
        if rows > cap:
            continue
        two = bulk_smem_bytes(esize, rows, n_heads, head_dim, 2,
                              blocks_per_split)
        if two <= target or rows == BULK_ROWS[-1]:
            stages = 2
            while stages < BULK_MAX_STAGES and bulk_smem_bytes(
                    esize, rows, n_heads, head_dim, stages + 1,
                    blocks_per_split) <= target:
                stages += 1
            return rows, stages, bulk_smem_bytes(
                esize, rows, n_heads, head_dim, stages, blocks_per_split)
    raise AssertionError("unreachable")


def paged_instance(dtype: torch.dtype, n_heads: int, head_dim: int,
                   block_size: int, pointers: Sequence[int],
                   pool_rows: int) -> str:
    """The kernel instance a CUDA call runs for pools of ``pool_rows``
    rows of ``dtype`` with ``n_heads`` heads of ``head_dim``, blocks of
    ``block_size`` rows, at the addresses ``pointers`` (k, v, and for
    int8 k_scale, v_scale): ``'bulk'`` where a 1-D bulk copy can
    describe the rows — head_dim even and at most MAX_HEAD_DIM,
    1..BULK_MAX_HEADS heads, a pool row a multiple of 16 bytes, every
    base on 16 bytes, int8 scale planes of a multiple of 16 bytes (a
    chunk's scales are copied in whole 16-byte units from the boundary
    below them, so the plane must end on one), and two stages of 8 rows
    (with BULK_MAX_ENTRIES table entries) within the block's shared
    memory — else ``'general'``.  Per-layer slices of one (layers, R,
    H, ...) pool stay on 16 bytes exactly when their own bytes are a
    multiple of 16, which these conditions then hold for every layer."""
    if (block_size >= 1 and _bulk_shape(dtype, n_heads, head_dim)
            and (dtype != torch.int8 or pool_rows * n_heads % 4 == 0)
            and all(p % 16 == 0 for p in pointers)):
        return "bulk"
    return "general"


@functools.lru_cache(maxsize=256)
def _bulk_shape(dtype: torch.dtype, n_heads: int, head_dim: int) -> bool:
    """``paged_instance``'s conditions on the dtype and the row's shape
    (once per shape: they run on every decode tick's host path)."""
    esize = _ESIZE.get(dtype)
    return (esize is not None and head_dim % 2 == 0
            and 2 <= head_dim <= MAX_HEAD_DIM
            and 1 <= n_heads <= BULK_MAX_HEADS
            and (n_heads * head_dim * esize) % 16 == 0
            and bulk_smem_bytes(esize, 8, n_heads, head_dim, 2,
                                BULK_MAX_ENTRIES) <= BULK_SMEM_MAX)


def image_rows(tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """Block tables ``(S, NT)`` → pool row of every logical position
    ``(S, NT·block_size)``: position t of lane s lives in row
    ``tables[s, t // bs] * bs + t % bs``."""
    bs = int(block_size)
    rows = (tables.long()[:, :, None] * bs
            + torch.arange(bs, device=tables.device)[None, None, :])
    return rows.reshape(tables.shape[0], -1)


def paged_decode_attention_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, *, block_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q ``(S, H, hd)``, pools ``(R, H, hd)``, tables ``(S, NT)``,
    lengths ``(S,)`` → fp32 ``(S, H, hd)``, through the gathered
    ``(S, NT·bs, H, hd)`` image of every lane's table."""
    rows = image_rows(tables, block_size)
    return decode_attention(q, k_pool[rows], v_pool[rows], lengths, scale)


def paged_decode_attention_i8_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_scale: torch.Tensor, v_scale: torch.Tensor, tables: torch.Tensor,
    lengths: torch.Tensor, *, block_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """int8 pools ``(R, H, hd)`` with fp32 scales ``(R, H)``: each lane's
    table image is gathered and dequantized (``int8 · scale`` in fp32),
    then attended as in ``paged_decode_attention_plain``."""
    rows = image_rows(tables, block_size)
    k_img = k_pool[rows].float() * k_scale[rows][..., None]
    v_img = v_pool[rows].float() * v_scale[rows][..., None]
    return decode_attention(q, k_img, v_img, lengths, scale)


def paged_decode_split_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, *, block_size: int,
    blocks_per_split: int, scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The bulk instance's arithmetic in plain PyTorch, in fp32: each
    lane's table is cut into splits of ``blocks_per_split`` entries;
    every split takes its own softmax partial ``(m, l, acc)`` over its
    live rows (int8: ``score = s_k · (q · k8)``, weights ``p · s_v``);
    the partials merge with weights ``exp(m_i − m)``, a split with no
    live row contributing exactly 0.  Held to the plain versions by the
    tests; used nowhere on the serving path."""
    s_, h, hd = q.shape
    nt, bs, bps = tables.shape[1], int(block_size), int(blocks_per_split)
    n_splits = _ceil_div(nt, bps)
    scale = float(scale) if scale is not None else hd ** -0.5
    rows = image_rows(tables, bs)  # (S, T)
    k_img = k_pool[rows].float()  # (S, T, H, hd)
    v_img = v_pool[rows].float()
    dots = torch.einsum("shd,sthd->sht", q.float(), k_img)
    if k_scale is not None:
        dots = dots * k_scale[rows].permute(0, 2, 1)
    t_all = n_splits * bps * bs
    pad = t_all - rows.shape[1]
    live = (torch.arange(t_all, device=q.device)[None, :]
            <= lengths.long()[:, None])
    live[:, rows.shape[1]:] = False
    scores = torch.nn.functional.pad(dots * scale, (0, pad))
    scores = scores.reshape(s_, h, n_splits, bps * bs)
    live = live.reshape(s_, 1, n_splits, bps * bs)
    neg = torch.tensor(float("-inf"), device=q.device)
    m = torch.where(live, scores, neg).amax(-1)  # (S, H, splits)
    has = torch.isfinite(m)
    p = torch.where(live, torch.exp(scores - torch.where(has, m, 0.0)[
        ..., None]), 0.0)
    l_ = p.sum(-1)
    if v_scale is not None:
        p = p * torch.nn.functional.pad(
            v_scale[rows].permute(0, 2, 1), (0, pad)).reshape(p.shape)
    v_img = torch.nn.functional.pad(v_img, (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("shnr,snrhd->shnd", p,
                       v_img.reshape(s_, n_splits, bps * bs, h, hd))
    m_all = m.amax(-1, keepdim=True)  # split 0 is live in every lane
    w = torch.where(has, torch.exp(m - m_all), 0.0)
    return (w[..., None] * acc).sum(2) / (w * l_).sum(2)[..., None]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fn in _POOL_FNS.values():
        f = getattr(lib, fn)
        f.argtypes = _ARGTYPES
        f.restype = ctypes.c_int
    for fn, argtypes in ((_I8_FN, _I8_ARGTYPES),
                         (_BULK_FN, _BULK_ARGTYPES)):
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.paged_decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(q, k_pool, v_pool, tables, lengths, k_scale=None,
                       v_scale=None) -> None:
    dev = q.device
    named = dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
                 lengths=lengths)
    if k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8:
        _need_scales(k_pool, k_scale, v_scale)
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pool.dim() != 3 or tables.dim() != 2:
        raise ValueError(
            f"want q (S,H,hd), pools (R,H,hd), tables (S,NT); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(tables.shape)}"
        )
    s_, h, hd = q.shape
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[1:]) != (h, hd):
        raise ValueError(
            f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if k_pool.dtype != v_pool.dtype or (
            k_pool.dtype not in _POOL_FNS and k_pool.dtype != torch.int8):
        raise TypeError(
            f"pools must both be float32, bfloat16 or int8, got "
            f"{k_pool.dtype}/{v_pool.dtype}"
        )
    if k_pool.dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            t = named[name]
            if t.dtype != torch.float32 or t.shape != k_pool.shape[:2]:
                raise ValueError(
                    f"{name} must be float32 {tuple(k_pool.shape[:2])}, got "
                    f"{t.dtype} {tuple(t.shape)}"
                )
    if not q.dtype.is_floating_point:
        raise TypeError(f"q must be floating point, got {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if tables.shape[0] != s_ or tuple(lengths.shape) != (s_,):
        raise ValueError(
            f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
            f"do not match {s_} lanes"
        )
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {hd} outside the kernel's 1..{MAX_HEAD_DIM} (a wider "
            f"head on the card is ROADMAP B5; the CPU takes any)"
        )
    if tables.shape[1] < 1:
        raise ValueError("tables need at least one column")


def _need_scales(k_pool, k_scale, v_scale) -> None:
    if k_scale is None or v_scale is None:
        raise ValueError(
            f"int8 pools need k_scale/v_scale, got "
            f"k_scale={k_scale is not None}, v_scale={v_scale is not None} "
            f"(pool {k_pool.dtype})"
        )


def _on_cuda(q: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(
        f"{what} runs on cuda (kernel) or cpu (plain version), not "
        f"{q.device}"
    )


def _launch(fn: str, q, pools, tables, lengths, block_size,
            scale) -> torch.Tensor:
    """Launch entry ``fn`` on the current stream: ``pools`` are the
    pool (and scale) tensors between q and the tables in its C
    signature.  Returns the fp32 (S, H, hd) output."""
    s_, h, hd = q.shape
    scale = float(scale) if scale is not None else hd ** -0.5
    lib = _library()
    qf = q.float().contiguous()
    out = torch.empty((s_, h, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, fn)(
        qf.data_ptr(), *[t.data_ptr() for t in pools], tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), s_, h, hd, tables.shape[1],
        int(block_size), scale, stream,
    )
    if rc != 0:
        msg = lib.paged_decode_attention_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg}")
    return out


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _bulk_config(dtype: torch.dtype, n_lanes: int, n_heads: int,
                 head_dim: int, n_table: int, block_size: int,
                 index: int) -> Tuple[PagedSplitPlan, int, int]:
    """(split plan, rows a stage, stages) of a call shape, computed once
    per shape (the host's part of every decode tick)."""
    plan = paged_split_plan(n_lanes, n_table, block_size, _n_sm(index))
    rows, stages, _ = paged_stage_plan(dtype, n_heads, head_dim, block_size,
                                       plan.blocks_per_split)
    return plan, rows, stages


_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, n_lanes: int,
             ws_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bulk instance's per-lane counters (zeros at first; every
    launch leaves them 0) and its partials' workspace, one pair per
    (device, stream): launches on one stream run in order, so they share
    both, and launches on two streams never do.  Grown when too small."""
    key = (device.index, stream)
    got = _SCRATCH.get(key)
    if got is None or got[0].numel() < n_lanes or got[1].numel() < ws_floats:
        tickets = torch.zeros(max(n_lanes, 64), dtype=torch.int32,
                              device=device)
        ws = torch.empty(max(ws_floats, 1), dtype=torch.float32,
                         device=device)
        got = _SCRATCH[key] = (tickets, ws)
    return got


def _launch_bulk(q, pools, ptrs, tables, lengths, block_size,
                 scale) -> torch.Tensor:
    """Launch the bulk instance on the current stream, planned by
    ``paged_split_plan`` and ``paged_stage_plan``: ``pools`` are (k, v)
    or (k, v, k_scale, v_scale), ``ptrs`` their addresses.  Returns the
    fp32 (S, H, hd) output."""
    s_, h, hd = q.shape
    nt, bs = tables.shape[1], int(block_size)
    scale = float(scale) if scale is not None else hd ** -0.5
    k_pool = pools[0]
    plan, rows, stages = _bulk_config(k_pool.dtype, s_, h, hd, nt, bs,
                                      q.device.index or 0)
    lib = _library()
    qf = q.float().contiguous()
    out = torch.empty((s_, h, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _scratch(q.device, stream, s_,
                           s_ * plan.n_splits * h * (hd + 2))
    rc = getattr(lib, _BULK_FN)(
        _BULK_DTYPES[k_pool.dtype], qf.data_ptr(), *ptrs[:2],
        *(ptrs[2:] if len(ptrs) == 4 else (None, None)),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr() if plan.n_splits > 1 else None, tickets.data_ptr(),
        s_, h, hd, nt, bs, scale, rows, stages, plan.blocks_per_split,
        plan.n_splits, stream,
    )
    if rc != 0:
        msg = lib.paged_decode_attention_error_string(rc).decode()
        raise RuntimeError(f"{_BULK_FN} launch failed: {msg}")
    return out


def _run(fn: str, q, pools, tables, lengths, block_size,
         scale) -> Tuple[torch.Tensor, bool]:
    """The instance ``paged_instance`` picks for these pools: the bulk
    kernel, or the general entry ``fn``.  Returns the output and whether
    the bulk instance ran."""
    h, hd = q.shape[1:]
    ptrs = [t.data_ptr() for t in pools]
    if paged_instance(pools[0].dtype, h, hd, block_size, ptrs,
                      pools[0].shape[0]) == "bulk":
        return _launch_bulk(q, pools, ptrs, tables, lengths, block_size,
                            scale), True
    return _launch(fn, q, pools, tables, lengths, block_size, scale), False


def paged_decode_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, *, block_size: int,
    scale: Optional[float] = None, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q·Kᵀ·scale)·V over each lane's paged K/V, one layer.

    - ``q`` (S, H, hd): the decode tick's single query per lane.
    - ``k_pool``/``v_pool`` (R, H, hd), R = n_blocks · block_size, in
      fp32, bf16 or int8.
    - ``tables`` (S, NT) int32: per-lane block ids (0 = the trash
      block); every id must be below n_blocks.
    - ``lengths`` (S,) int32, ``>= 0``: the incoming token's position;
      rows at positions ``<= length`` attend (the token's own K/V was
      written before the call).
    - ``k_scale``/``v_scale`` (R, H) fp32: required for int8 pools, the
      dequantization scale of every pool row and head.

    Returns fp32 (S, H, hd).  On CUDA tensors this launches the kernel
    instance ``paged_instance`` picks on the current stream and raises
    if the launch is refused.
    """
    if k_pool.dtype == torch.int8:
        _need_scales(k_pool, k_scale, v_scale)
        return paged_decode_attention_i8(
            q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
            block_size=block_size, scale=scale,
        )
    if not _on_cuda(q, "paged_decode_attention"):
        return paged_decode_attention_plain(
            q, k_pool, v_pool, tables, lengths, block_size=block_size,
            scale=scale,
        )
    _check_cuda_inputs(q, k_pool, v_pool, tables, lengths)
    out, bulk = _run(_POOL_FNS[k_pool.dtype], q, (k_pool, v_pool), tables,
                     lengths, block_size, scale)
    paged_decode_attention.launches += 1
    paged_decode_attention.bulk_launches += bulk
    return out


def paged_decode_attention_i8(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_scale: torch.Tensor, v_scale: torch.Tensor, tables: torch.Tensor,
    lengths: torch.Tensor, *, block_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``paged_decode_attention`` over int8 pools with their scales:
    the int8 kernel on CUDA tensors, ``paged_decode_attention_i8_plain``
    on CPU tensors."""
    if not _on_cuda(q, "paged_decode_attention_i8"):
        return paged_decode_attention_i8_plain(
            q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
            block_size=block_size, scale=scale,
        )
    _check_cuda_inputs(q, k_pool, v_pool, tables, lengths, k_scale, v_scale)
    if k_pool.dtype != torch.int8:
        raise TypeError(f"paged_decode_attention_i8 takes int8 pools, got "
                        f"{k_pool.dtype}")
    out, bulk = _run(_I8_FN, q, (k_pool, v_pool, k_scale, v_scale), tables,
                     lengths, block_size, scale)
    paged_decode_attention_i8.launches += 1
    paged_decode_attention_i8.bulk_launches += bulk
    return out


paged_decode_attention.launches = 0
paged_decode_attention_i8.launches = 0
paged_decode_attention.bulk_launches = 0
paged_decode_attention_i8.bulk_launches = 0
