"""Cross-channel LRN: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``theanompi_tpu.ops.pallas_lrn`` (the ``lrn``
custom_vjp over ``_fwd_kernel`` and ``_bwd_kernel``).  An NHWC
activation is normalized over its last (channel) axis:

    D_c = k + α · Σ_{j∈W(c)} x_j²,   W(c) = {j : j − c ∈ [−⌊size/2⌋, size−1−⌊size/2⌋]}
    y_c = x_c · D_c^−β

and its gradient, with u_c = dy_c · x_c · D_c^(−β−1):

    dx_i = dy_i · D_i^−β − 2αβ · x_i · Σ_{c : i∈W(c)} u_c

- ``lrn`` — the ``torch.autograd.Function`` the ``LRN`` layer calls.
  It saves only x; the backward recomputes D, as the TPU kernel does.
- ``lrn_fwd`` / ``lrn_bwd`` — one pass each.  The device of ``x``
  decides what runs: a CUDA tensor launches the hand-written kernel
  (``csrc/lrn.cu``) or raises; a CPU tensor takes the plain version.
  Nothing falls back from the card to the plain version.  Each counts
  its kernel launches in ``.launches``.
- ``lrn_fwd_plain`` / ``lrn_bwd_plain`` — the same formulas in fp32
  with slice sums over a zero-padded channel axis.  The CPU path, and
  what the kernels are held to on the card.

Numerics: fp32 inside on both, the output rounded once to x's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from theanompi_tpu_torch import cuda_build

KERNEL = "lrn"
_FNS = {
    torch.float32: ("lrn_fwd_f32", "lrn_bwd_f32"),
    torch.bfloat16: ("lrn_fwd_bf16", "lrn_bwd_bf16"),
}
_SCALARS = [ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _window_sum(a: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """out[..., c] = Σ_{j=c−lo}^{c+hi} a[..., j] (zero outside), summed
    in increasing j."""
    c = a.shape[-1]
    p = torch.nn.functional.pad(a, (lo, hi))
    out = p[..., 0:c]
    for i in range(1, lo + hi + 1):
        out = out + p[..., i:i + c]
    return out


def _denominator(xf: torch.Tensor, size: int, alpha: float, k: float):
    pad = size // 2
    return k + alpha * _window_sum(xf * xf, pad, size - 1 - pad)


def lrn_fwd_plain(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                  beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """y = x · D^−β over the last axis, in fp32, returned in x's dtype."""
    xf = x.float()
    d = _denominator(xf, size, alpha, k)
    return (xf * torch.exp(-beta * torch.log(d))).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, dy: torch.Tensor, size: int = 5,
                  alpha: float = 1e-4, beta: float = 0.75,
                  k: float = 1.0) -> torch.Tensor:
    """dx from x and dy (D recomputed), in fp32, returned in x's dtype."""
    xf, dyf = x.float(), dy.float()
    d = _denominator(xf, size, alpha, k)
    d_mb = torch.exp(-beta * torch.log(d))
    u = dyf * xf * d_mb / d
    pad = size // 2
    # reverse window {c : i ∈ W(c)} = [i − (size−1−pad), i + pad]
    rs = _window_sum(u, size - 1 - pad, pad)
    return (dyf * d_mb - (2.0 * alpha * beta) * xf * rs).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fwd, bwd in _FNS.values():
        getattr(lib, fwd).argtypes = [ctypes.c_void_p] * 2 + _SCALARS
        getattr(lib, fwd).restype = ctypes.c_int
        getattr(lib, bwd).argtypes = [ctypes.c_void_p] * 3 + _SCALARS
        getattr(lib, bwd).restype = ctypes.c_int
    lib.lrn_max_channels.restype = ctypes.c_int
    lib.lrn_error_string.argtypes = [ctypes.c_int]
    lib.lrn_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dtype not in _FNS:
        raise TypeError(f"lrn kernels take float32 or bfloat16, not {x.dtype}")
    for t in (x, *others):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(
                f"lrn: every tensor must match x ({x.dtype}, "
                f"{tuple(x.shape)}, {x.device}); got {t.dtype}, "
                f"{tuple(t.shape)}, {t.device}")
        if not t.is_contiguous():
            raise ValueError(
                "lrn: tensors must be contiguous with channels last in "
                "memory (NHWC)")
    max_c = _library().lrn_max_channels()
    if x.dim() < 1 or not 1 <= x.shape[-1] <= max_c:
        raise ValueError(
            f"lrn kernel supports 1..{max_c} channels, got shape "
            f"{tuple(x.shape)}")


def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain version), "
                     f"not {x.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().lrn_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def lrn_fwd(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """LRN forward over the last axis of contiguous ``x``."""
    if not _route(x, "lrn_fwd"):
        return lrn_fwd_plain(x, size, alpha, beta, k)
    _check_cuda(x)
    y = torch.empty_like(x)
    c = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(_library(), _FNS[x.dtype][0])(
        x.data_ptr(), y.data_ptr(), x.numel() // c, c, int(size),
        float(alpha), float(beta), float(k), stream)
    _raise_on(rc, "lrn_fwd")
    lrn_fwd.launches += 1
    return y


def lrn_bwd(x: torch.Tensor, dy: torch.Tensor, size: int = 5,
            alpha: float = 1e-4, beta: float = 0.75,
            k: float = 1.0) -> torch.Tensor:
    """LRN backward: dx from the saved input and the cotangent."""
    if not _route(x, "lrn_bwd"):
        return lrn_bwd_plain(x, dy, size, alpha, beta, k)
    _check_cuda(x, dy)
    dx = torch.empty_like(x)
    c = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(_library(), _FNS[x.dtype][1])(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel() // c, c,
        int(size), float(alpha), float(beta), float(k), stream)
    _raise_on(rc, "lrn_bwd")
    lrn_bwd.launches += 1
    return dx


lrn_fwd.launches = 0
lrn_bwd.launches = 0


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hyper = (size, alpha, beta, k)
        return lrn_fwd(x, size, alpha, beta, k)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx = lrn_bwd(x, dy.to(x.dtype).contiguous(), *ctx.hyper)
        return dx, None, None, None, None


def lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Fused cross-channel LRN over the last axis of ``x`` (NHWC), with
    the backward pass through ``lrn_bwd``."""
    return _LRN.apply(x, int(size), float(alpha), float(beta), float(k))
