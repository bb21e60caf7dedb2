"""Max pooling whose backward is a hand-written CUDA kernel.

Counterpart of ``theanompi_tpu.ops.pallas_pool`` (``maxpool_pallas``,
the custom_vjp whose backward is ``_pool_bwd_kernel`` through
``maxpool_bwd``).  The forward stays the framework's pool
(``F.max_pool2d`` here, XLA's ``reduce_window`` there).  The backward
splits each window's cotangent EQUALLY across its tied maxima, as the
reference's mask and Pallas backwards do; torch's own backward routes
it to one max.  VALID padding only.

- ``maxpool_pallas`` — the ``torch.autograd.Function`` the ``MaxPool``
  layer calls with ``grad_impl='pallas'``; it saves x and y.
- ``maxpool_bwd`` — the backward pass.  The device of ``x`` decides
  what runs: a CUDA tensor launches the kernel of
  ``csrc/maxpool_bwd.cu`` (one launch a call) or raises; a CPU tensor
  takes the plain version.  ``maxpool_bwd.launches`` counts kernel
  launches.
- ``plan_maxpool_bwd`` — the kernel's launch plan, on the host: the
  bands of output rows and columns and the slab of channels a CTA
  owns, and whether it moves channels in 16-byte vectors.
  ``pool_band`` gives a band's windows, staged inputs and owned inputs
  (the kernel's ``span``), ``pool_smem_bytes`` its shared memory.
- ``maxpool_bwd_plain`` — the shifted-mask backward of the reference's
  ``_maxpool_mask_bwd`` in torch ops: the CPU path, and what the kernel
  is held to on the card.
- ``maxpool_fwd`` — VALID max pool of an NHWC tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from theanompi_tpu_torch import cuda_build

KERNEL = "maxpool_bwd"
_FNS = {torch.float32: "maxpool_bwd_f32", torch.bfloat16: "maxpool_bwd_bf16"}


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def maxpool_fwd(x: torch.Tensor, window, stride) -> torch.Tensor:
    """VALID max pool of contiguous NHWC ``x``; returns contiguous NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(window), _pair(stride))
    return y.permute(0, 2, 3, 1).contiguous()


def _offsets(x_shape, y_shape, window, stride):
    """(di, dj, slice_h, slice_w) for every window offset: the input
    sample each window reads at that offset is
    ``x[:, slice_h, slice_w, :]`` (shape of y)."""
    (kh, kw), (sh, sw) = _pair(window), _pair(stride)
    h, w = x_shape[1:3]
    oh, ow = y_shape[1:3]
    span_h, span_w = (oh - 1) * sh + 1, (ow - 1) * sw + 1
    return [
        (di, dj, slice(di, di + span_h, sh), slice(dj, dj + span_w, sw))
        for di in range(kh) for dj in range(kw)
        if di + span_h <= h and dj + span_w <= w
    ]


def maxpool_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                      window, stride) -> torch.Tensor:
    """dx of a VALID max pool, cotangent split equally across ties;
    fp32 inside, returned in x's dtype."""
    offs = _offsets(x.shape, y.shape, window, stride)
    yf = y.float()
    cnt = torch.zeros_like(yf)
    for _, _, si, sj in offs:
        cnt = cnt + (x[:, si, sj, :].float() == yf).float()
    dyc = dy.float() / cnt  # every window holds its max: cnt >= 1
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for _, _, si, sj in offs:
        contrib = torch.where(x[:, si, sj, :].float() == yf, dyc, 0.0)
        dx[:, si, sj, :] += contrib
    return dx.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernel's launch plan (host side; csrc/maxpool_bwd.cu mirrors
# `pool_band` as `span` and `pool_smem_bytes` as `layout`)
# ---------------------------------------------------------------------------

POOL_THREADS = 256      # threads per CTA
POOL_SLAB_BYTES = 128   # channels of one pixel a CTA owns, at most
POOL_SMEM_BUDGET = 64 * 1024   # bytes per CTA: three CTAs on an SM
POOL_SMEM_MAX = 227 * 1024     # what a CTA may opt into on Hopper
POOL_MIN_CTAS = 2 * 132        # two per SM of an H100 before bands shrink
_ALIGN = 128


class PoolBand(NamedTuple):
    """One band along a spatial dimension: windows ``[w0, w1)`` staged
    (the band's own and the halo of earlier ones that reach its first
    owned input), inputs ``[o0, o1)`` owned (dx written), inputs
    ``[x0, x1)`` staged (every tap of the staged windows)."""
    w0: int
    w1: int
    o0: int
    o1: int
    x0: int
    x1: int


def pool_band(b: int, per: int, n_bands: int, length: int, out_length: int,
              k: int, s: int) -> PoolBand:
    """Band ``b`` of ``n_bands`` with ``per`` outputs each, along a
    dimension of ``length`` inputs and ``out_length`` outputs, window
    ``k``, stride ``s``: the outputs ``[p0, p1)`` own the inputs
    ``[p0·s, p1·s)``, the last band up to ``length``."""
    p0 = b * per
    p1 = min(p0 + per, out_length)
    w0 = max(0, p0 - (k - 1) // s)
    return PoolBand(w0, p1, p0 * s, length if b == n_bands - 1 else p1 * s,
                    w0 * s, (p1 - 1) * s + k)


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def pool_smem_bytes(x_shape, window, stride, itemsize: int, band_rows: int,
                    band_cols: int, slab: int) -> int:
    """Shared memory of a CTA (the largest band): staged x, staged y,
    fp32 shares, and the owned rows' and columns' tap tables."""
    (kh, kw), (sh, sw) = _pair(window), _pair(stride)
    _, h, w, _ = x_shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    nbh, nbw = -(-oh // band_rows), -(-ow // band_cols)
    win_r = min(band_rows + (kh - 1) // sh, oh)
    win_c = min(band_cols + (kw - 1) // sw, ow)
    x_r = min((win_r - 1) * sh + kh, h)
    x_c = min((win_c - 1) * sw + kw, w)
    own_r = min(max(band_rows * sh, h - (nbh - 1) * band_rows * sh), h)
    own_c = min(max(band_cols * sw, w - (nbw - 1) * band_cols * sw), w)
    return (_up(x_r * x_c * slab * itemsize)
            + _up(win_r * win_c * slab * itemsize)
            + _up(win_r * win_c * slab * 4) + _up(own_r * kh * 4)
            + own_c * kw * 4)


class PoolPlan(NamedTuple):
    vec: bool        # 16-byte vectors of channels (else one a thread)
    band_rows: int   # output rows per band
    band_cols: int   # output columns per band
    slab: int        # channels per CTA
    n_bands: Tuple[int, int]
    n_slabs: int
    smem_bytes: int
    ctas: int


@functools.lru_cache(maxsize=4096)
def plan_maxpool_bwd(x_shape: Tuple[int, int, int, int], window, stride,
                     itemsize: int, aligned: bool) -> PoolPlan:
    """How the kernel splits a call: 16-byte vectors when a pixel's
    channels are a multiple of 16 bytes and every operand starts on 16
    bytes (``aligned``); slabs of at most ``POOL_SLAB_BYTES`` a pixel;
    then the tallest band of whole output rows (or, when even one row is
    too wide, the widest band of columns) whose shared memory fits
    ``POOL_SMEM_BUDGET``, shrunk while the grid has fewer than
    ``POOL_MIN_CTAS`` CTAs, and evened out over the bands.  Raises when
    even one window's column of one vector exceeds ``POOL_SMEM_MAX``."""
    (kh, kw), (sh, sw) = _pair(window), _pair(stride)
    n, h, w, c = x_shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    vec = bool(aligned) and (c * itemsize) % 16 == 0
    per = 16 // itemsize if vec else 1
    units = -(-c // per)
    most = max(1, min(POOL_SLAB_BYTES // (per * itemsize), POOL_THREADS))
    n_slabs = -(-units // most)
    slab = per * -(-units // n_slabs)

    def smem(bp, bq, sl):
        return pool_smem_bytes(x_shape, window, stride, itemsize, bp, bq, sl)

    def ctas(bp, bq, sl):
        return n * -(-oh // bp) * -(-ow // bq) * -(-c // sl)

    choice = None
    while choice is None:
        fits = [(bp, ow) for bp in range(oh, 0, -1)
                if smem(bp, ow, slab) <= POOL_SMEM_BUDGET]
        fits += [(1, bq) for bq in range(ow - 1, 0, -1)
                 if smem(1, bq, slab) <= POOL_SMEM_BUDGET]
        if fits:
            # the tallest fit whose grid fills the card, else the smallest
            choice = next((f for f in fits
                           if ctas(*f, slab) >= POOL_MIN_CTAS), fits[-1])
        elif slab > per:
            slab = per * max(1, slab // per // 2)
        else:
            if smem(1, 1, slab) > POOL_SMEM_MAX:
                raise ValueError(
                    f"maxpool_bwd kernel: a {kh}x{kw}/{sh}x{sw} window over "
                    f"{x_shape} needs {smem(1, 1, slab)} bytes of shared "
                    f"memory, more than {POOL_SMEM_MAX}")
            choice = (1, 1)
    bp, bq = choice
    nbh, nbw = -(-oh // bp), -(-ow // bq)
    bp, bq = -(-oh // nbh), -(-ow // nbw)  # even the bands out
    return PoolPlan(vec, bp, bq, slab, (nbh, nbw), -(-c // slab),
                    smem(bp, bq, slab), ctas(bp, bq, slab))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fn in _FNS.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.maxpool_bwd_max_elements.restype = ctypes.c_long
    lib.maxpool_bwd_error_string.argtypes = [ctypes.c_int]
    lib.maxpool_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(x, y, dy, window, stride) -> None:
    if x.dtype not in _FNS:
        raise TypeError(
            f"maxpool_bwd kernel takes float32 or bfloat16, not {x.dtype}")
    for name, t in dict(x=x, y=y, dy=dy).items():
        if t.dim() != 4:
            raise ValueError(f"{name} must be NHWC (4-D), got {t.shape}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; x is {x.dtype} on "
                f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous NHWC (channels last in memory)")
    limit = _library().maxpool_bwd_max_elements()
    if x.numel() > limit:
        raise ValueError(f"maxpool_bwd kernel takes at most {limit} input "
                         f"elements (32-bit indices), got {x.numel()}")
    (kh, kw), (sh, sw) = _pair(window), _pair(stride)
    n, h, w, c = x.shape
    want = (n, (h - kh) // sh + 1, (w - kw) // sw + 1, c)
    if tuple(y.shape) != want or tuple(dy.shape) != want:
        raise ValueError(
            f"y {tuple(y.shape)} / dy {tuple(dy.shape)} are not the VALID "
            f"{(kh, kw)}/{(sh, sw)} pool of x {tuple(x.shape)} (want {want})")


def maxpool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                window, stride) -> torch.Tensor:
    """dx for a VALID max pool of NHWC ``x`` with pooled ``y`` and
    cotangent ``dy`` (ties split equally); dx in x's dtype."""
    if x.device.type == "cpu":
        return maxpool_bwd_plain(x, y, dy, window, stride)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_bwd runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    _check_cuda(x, y, dy, window, stride)
    (kh, kw), (sh, sw) = _pair(window), _pair(stride)
    n, h, w, c = x.shape
    oh, ow = y.shape[1:3]
    dx = torch.empty_like(x)
    ptrs = (x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr())
    plan = plan_maxpool_bwd(tuple(x.shape), (kh, kw), (sh, sw),
                            x.element_size(), all(p % 16 == 0 for p in ptrs))
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, _FNS[x.dtype])(
        *ptrs, n, h, w, c, oh, ow, kh, kw, sh, sw, plan.band_rows,
        plan.band_cols, plan.slab, int(plan.vec), stream)
    if rc != 0:
        msg = lib.maxpool_bwd_error_string(rc).decode()
        raise RuntimeError(f"maxpool_bwd launch failed: {msg}")
    maxpool_bwd.launches += 1
    return dx


maxpool_bwd.launches = 0


def _require_valid(padding) -> None:
    if padding != "VALID":
        raise ValueError(
            f"maxpool_pallas supports VALID padding only, got {padding!r}")


class _MaxPoolPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, stride):
        y = maxpool_fwd(x, window, stride)
        ctx.save_for_backward(x, y)
        ctx.geom = (window, stride)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        dx = maxpool_bwd(x, y, dy.to(x.dtype).contiguous(), *ctx.geom)
        return dx, None, None


def maxpool_pallas(x: torch.Tensor, window, stride,
                   padding: str = "VALID") -> torch.Tensor:
    """Max pool of contiguous NHWC ``x`` whose backward is
    ``maxpool_bwd``."""
    _require_valid(padding)
    return _MaxPoolPallas.apply(x, _pair(window), _pair(stride))
