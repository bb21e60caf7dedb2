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
  what runs: a CUDA tensor launches the kernel pair of
  ``csrc/maxpool_bwd.cu`` or raises; a CPU tensor takes the plain
  version.  ``maxpool_bwd.launches`` counts kernel calls (one call =
  the tie-share launch and the gather launch).
- ``maxpool_bwd_plain`` — the shifted-mask backward of the reference's
  ``_maxpool_mask_bwd`` in torch ops: the CPU path, and what the kernel
  is held to on the card.
- ``maxpool_fwd`` — VALID max pool of an NHWC tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fn in _FNS.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
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
    dyc = torch.empty(y.shape, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, _FNS[x.dtype])(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), dyc.data_ptr(),
        dx.data_ptr(), n, h, w, c, oh, ow, kh, kw, sh, sw, stream)
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
