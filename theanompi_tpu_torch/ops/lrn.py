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
  its kernel launches in ``.launches`` and keeps the plan of its last
  launch in ``.last_plan``.
- ``plan_lrn`` — the kernels' launch plan, on the host: the vector
  width, the CTA's shape, rows per tile, ring stages, shared memory and
  the persistent grid.  ``lrn_smem_bytes`` is a CTA's shared memory
  (the kernel's ``smem_bytes``), ``lrn_max_channels`` the most channels
  a plan takes, ``lrn_cta_tiles`` the rows a CTA walks.
- ``lrn_fwd_plain`` / ``lrn_bwd_plain`` — the same formulas in fp32
  with slice sums over a zero-padded channel axis.  The CPU path, and
  what the kernels are held to on the card.

Numerics: fp32 inside on both, the output rounded once to x's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from theanompi_tpu_torch import cuda_build

KERNEL = "lrn"
_FNS = {
    torch.float32: ("lrn_fwd_f32", "lrn_bwd_f32"),
    torch.bfloat16: ("lrn_fwd_bf16", "lrn_bwd_bf16"),
}
# m, c, size, alpha, beta, k, the plan's seven ints, the stream
_SCALARS = ([ctypes.c_long, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])


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


# ---------------------------------------------------------------------------
# the kernels' launch plan (host side; csrc/lrn.cu mirrors
# `lrn_smem_bytes` as `smem_bytes` and `lrn_max_channels` as
# `max_channels`, and refuses a plan whose shared memory differs)
# ---------------------------------------------------------------------------

LRN_THREADS = 256          # threads a CTA, unless a row needs more
LRN_MAX_THREADS = 1024     # the kernels' launch bound (64 registers)
LRN_STAGES = 2             # ring depth
LRN_STAGE_BYTES = 8192     # rows per tile: about this much a stage
LRN_ITEM_FLOATS = 16       # backward: D^-β floats a thread keeps a tile
LRN_HEADER = 128           # the stages' mbarriers
LRN_SMEM_MAX = 227 * 1024  # what a CTA may opt into on Hopper
LRN_SM_SMEM = 228 * 1024   # an SM's shared memory for its CTAs
LRN_CTA_RESERVED = 1024    # shared memory the card keeps for each CTA
LRN_SM_THREADS = 1024      # 64 registers a thread: 65536 / 64
LRN_SMS = 132              # SMs of an H100


def _up(n: int, a: int) -> int:
    return -(-n // a) * a


def lrn_smem_bytes(rows: int, c: int, itemsize: int, stages: int,
                   backward: bool) -> int:
    """Shared memory of a CTA: the mbarriers, ``stages`` stages of x
    (forward) or x and dy (backward), each array's slot the 16-byte span
    around its tile on 128 bytes, and the backward's fp32 u-tile."""
    slot = _up(_up(rows * c * itemsize, 16) + 16, 128)
    return (LRN_HEADER + stages * (2 if backward else 1) * slot
            + (rows * c * 4 if backward else 0))


@functools.lru_cache(maxsize=None)
def lrn_max_channels() -> int:
    """The most channels whose one-row tile fits two stages of every pass
    and dtype (the fp32 backward needs the most)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if lrn_smem_bytes(1, mid, 4, 2, True) <= LRN_SMEM_MAX:
            lo = mid
        else:
            hi = mid - 1
    return lo


class LrnPlan(NamedTuple):
    vec: int          # channels a thread's run: 16 bytes of them, or 1
    tx: int           # threads along a row (runs tx apart)
    ty: int           # rows in flight at once (rows ty apart)
    rows: int         # rows a tile (a multiple of ty)
    stages: int       # ring depth
    smem_bytes: int
    ctas_per_sm: int
    ctas: int         # the persistent grid
    tiles: int

    def args(self) -> Tuple[int, ...]:
        """What the C entry points take, in their order."""
        return (self.vec, self.tx, self.ty, self.rows, self.stages,
                self.smem_bytes, self.ctas)


@functools.lru_cache(maxsize=4096)
def plan_lrn(m: int, c: int, itemsize: int, aligned: bool,
             backward: bool = False) -> LrnPlan:
    """How the kernel of one pass (``backward`` or not) splits an
    (m, c) call.  A run is 16 bytes of channels when a row is a multiple
    of 16 bytes and every operand starts on 16 bytes (``aligned``), else
    one channel.  tx threads share a row, each taking every tx-th run
    (at most LRN_ITEM_FLOATS / vec runs a tile in the backward, which
    keeps D^-β of each in registers); ty = LRN_THREADS // tx rows are in
    flight at once; a tile is ty·j whole rows, about LRN_STAGE_BYTES of
    x (forward) or of x and dy (backward); LRN_STAGES stages.  The
    persistent grid has as many CTAs an SM as threads (64 registers
    each) and shared memory allow, on LRN_SMS SMs, and never more CTAs
    than tiles.  Raises for C outside 1..lrn_max_channels()."""
    limit = lrn_max_channels()
    if not 1 <= c <= limit:
        raise ValueError(f"lrn kernel takes 1..{limit} channels, got {c}")
    if m < 0:
        raise ValueError(f"lrn kernel: m = {m} rows")
    vec = 16 // itemsize if aligned and c * itemsize % 16 == 0 else 1
    units = -(-c // vec)
    items = LRN_ITEM_FLOATS // vec
    nb = -(-units // LRN_THREADS)  # runs a row a thread
    if backward:
        nb = min(nb, items)
    tx = -(-units // nb)
    ty = max(1, LRN_THREADS // tx)
    arrays = 2 if backward else 1
    # j: rows a thread a tile
    j = max(1, LRN_STAGE_BYTES // (arrays * ty * c * itemsize))
    if backward:
        j = min(j, max(1, items // nb))
    j = min(j, max(1, -(-m // ty)))
    rows = ty * j
    smem = lrn_smem_bytes(rows, c, itemsize, LRN_STAGES, backward)
    per_sm = max(1, min(LRN_SM_THREADS // (tx * ty),
                        LRN_SM_SMEM // (smem + LRN_CTA_RESERVED)))
    tiles = -(-m // rows)
    return LrnPlan(vec, tx, ty, rows, LRN_STAGES, smem, per_sm,
                   min(tiles, per_sm * LRN_SMS), tiles)


def lrn_cta_tiles(plan: LrnPlan, m: int, cta: int) -> List[Tuple[int, int]]:
    """The (first row, rows) of each tile CTA ``cta`` walks, in order:
    tiles cta, cta + ctas, ... (the kernel's loop)."""
    return [(t * plan.rows, min(plan.rows, m - t * plan.rows))
            for t in range(cta, plan.tiles, plan.ctas)]


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
    if lib.lrn_max_channels() != lrn_max_channels():
        raise RuntimeError(
            f"csrc/lrn.cu takes {lib.lrn_max_channels()} channels, the "
            f"plan {lrn_max_channels()}: the two layouts differ")
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
    max_c = lrn_max_channels()
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


def _launch(wrapper, fn: int, tensors, size, alpha, beta, k):
    """Plan and launch pass ``fn`` (0 forward, 1 backward) of the kernel
    on ``tensors`` (its inputs, then its output)."""
    x = tensors[0]
    if int(size) < 1:
        raise ValueError(f"lrn: size must be at least 1, got {size}")
    c = x.shape[-1]
    m = x.numel() // c
    plan = plan_lrn(m, c, x.element_size(),
                    all(t.data_ptr() % 16 == 0 for t in tensors),
                    backward=bool(fn))
    if m == 0:
        return
    rc = getattr(_library(), _FNS[x.dtype][fn])(
        *(t.data_ptr() for t in tensors), m, c, int(size), float(alpha),
        float(beta), float(k), *plan.args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    wrapper.last_plan = plan


def lrn_fwd(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """LRN forward over the last axis of contiguous ``x``."""
    if not _route(x, "lrn_fwd"):
        return lrn_fwd_plain(x, size, alpha, beta, k)
    _check_cuda(x)
    y = torch.empty_like(x)
    _launch(lrn_fwd, 0, (x, y), size, alpha, beta, k)
    return y


def lrn_bwd(x: torch.Tensor, dy: torch.Tensor, size: int = 5,
            alpha: float = 1e-4, beta: float = 0.75,
            k: float = 1.0) -> torch.Tensor:
    """LRN backward: dx from the saved input and the cotangent."""
    if not _route(x, "lrn_bwd"):
        return lrn_bwd_plain(x, dy, size, alpha, beta, k)
    _check_cuda(x, dy)
    dx = torch.empty_like(x)
    _launch(lrn_bwd, 1, (x, dy, dx), size, alpha, beta, k)
    return dx


lrn_fwd.launches = lrn_bwd.launches = 0
lrn_fwd.last_plan = lrn_bwd.last_plan = None


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
