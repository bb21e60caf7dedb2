"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``theanompi_tpu.ops.pallas_flash`` (``_fwd_kernel``,
``_dq_kernel``, ``_dkv_kernel`` and the ``flash_attention`` custom_vjp
over them).  Operands of the kernels are contiguous rows ``(B·H, T,
D)`` (``to_rows``); the public functions take ``(B, T, H, D)`` like
``ops.attention.local_attention``.

- ``flash_fwd`` — softmax(QKᵀ·scale)V with the online-softmax
  recurrence; returns ``out`` in the input dtype and the per-row
  log-sum-exp ``lse`` in fp32 ``(B·H, T)``.
- ``flash_dq`` / ``flash_dkv`` — the FlashAttention-2 backward: the
  probabilities are recomputed from ``lse`` as ``P = exp(S − lse)``,
  and with ``Δ = rowsum(dO·O)`` (fp32, computed outside the kernels as
  the reference computes it in XLA)
  ``dS = P ∘ (dP − Δ) · scale``, ``dQ = dS·K``, ``dK = dSᵀ·Q``,
  ``dV = Pᵀ·dO``.  dQ, dK and dV come out in the input dtype.
- ``flash_attention`` — the ``torch.autograd.Function`` the attention
  layer calls with ``attn_impl='flash'``; its forward saves the rows
  q, k, v, out and lse, as the reference's ``_vjp_fwd`` does.
- ``flash_forward_with_lse`` and ``flash_backward_rows`` — the forward
  with its lse, and the backward on rows with a given Δ, kept apart for
  the ring path, which drives them per block (ROADMAP A13).

The device of ``q`` decides what runs: a CUDA tensor launches the
hand-written kernel (``csrc/flash_attention.cu``) or raises; a CPU
tensor takes the plain version.  Nothing falls back from the card to
the plain version.  Each wrapper counts its kernel launches in
``.launches``.  Both routes take q/k/v of one shape and any ``T ≥ 1``,
and raise ``ValueError`` for anything else.  The plain versions take
fp32, bf16 or fp16 and any head dim ``D``, as the reference's kernels
widen any float and take any D; the CUDA kernels take fp32 or bf16 with
``D ≤ 128`` (fp16 or a wider head on the card raises before a launch,
naming ROADMAP B4).

Numerics, as the Pallas kernels: q/k/v are widened to fp32, every
product and the softmax statistics are fp32, and the probabilities
multiply V (and dO) in fp32 — they are not rounded to the input dtype,
as ``local_attention`` rounds them; the two paths differ at bf16 by
design.  Masked scores are ``NEG_INF`` and masked probabilities are
zeroed again after the exp, so a fully masked row gives no NaN.  On
the card, bf16 with D <= 64 runs on the tensor cores: the bf16 products
are exact in fp32, and P and dS enter their products as two bf16 terms
each (16 significant bits), so the outputs stay within one bf16 step
of the plain version; fp32, and bf16 with D > 64, run fp32 FMAs.  The
bf16 forward with D a multiple of 8 and every operand on 16 bytes runs
the ``wgmma`` instance fed by TMA, the other bf16 forwards with
D <= 64 the ``mma.sync`` one (``flash_fwd_instance``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from theanompi_tpu_torch import cuda_build

KERNEL = "flash_attention"
NEG_INF = -1e30
MAX_HEAD_DIM = 128
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}  # CUDA kernels


# ---------------------------------------------------------------------------
# layout and scale
# ---------------------------------------------------------------------------

def to_rows(x: torch.Tensor) -> torch.Tensor:
    """``(B, T, H, D)`` → contiguous ``(B·H, T, D)``."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).contiguous().view(b * h, t, d)


def from_rows(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``(B·H, T, D)`` → a ``(B, T, H, D)`` view."""
    _, t, d = x.shape
    return x.view(b, h, t, d).permute(0, 2, 1, 3)


def resolve_scale(scale: Optional[float], d: int) -> float:
    """The default-scale policy, resolved once: forward and backward
    must agree."""
    return float(scale) if scale is not None else d ** -0.5


def _check(what: str, ref: torch.Tensor, *others: torch.Tensor) -> None:
    if ref.dtype not in _FLOATS:
        raise ValueError(f"{what}: q/k/v must be float32, bfloat16 or "
                         f"float16, not {ref.dtype}")
    if ref.dim() != 3 or ref.shape[1] < 1 or ref.shape[2] < 1:
        raise ValueError(
            f"{what}: want rows (B·H, T >= 1, D >= 1), got "
            f"{tuple(ref.shape)}")
    for t in others:
        if (t.shape != ref.shape or t.dtype != ref.dtype
                or t.device != ref.device):
            raise ValueError(
                f"{what}: every operand must match q ({ref.dtype}, "
                f"{tuple(ref.shape)}, {ref.device}); got {t.dtype}, "
                f"{tuple(t.shape)}, {t.device}")


def _check_stats(what: str, ref: torch.Tensor, *stats: torch.Tensor) -> None:
    for s in stats:
        if (s.shape != ref.shape[:2] or s.dtype != torch.float32
                or s.device != ref.device):
            raise ValueError(
                f"{what}: lse and delta must be float32 {tuple(ref.shape[:2])}"
                f" on {ref.device}; got {s.dtype} {tuple(s.shape)} on "
                f"{s.device}")


def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain version), "
                     f"not {x.device}")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------------

def _scores(qf, kf, causal: bool, scale: float):
    """S = QKᵀ·scale in fp32 with the causal mask applied; returns
    (S, mask or None)."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if not causal:
        return s, None
    t = qf.shape[-2]
    pos = torch.arange(t, device=qf.device)
    mask = pos[:, None] >= pos[None, :]
    return s.masked_fill(~mask, NEG_INF), mask


def _probs(s, stat, mask):
    p = torch.exp(s - stat[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def flash_fwd_plain(qr: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows forward in fp32: ``(out in qr's dtype, lse fp32)``."""
    s, mask = _scores(qr.float(), kr.float(), causal, scale)
    m = s.amax(dim=-1)
    p = _probs(s, m, mask)
    den = p.sum(dim=-1)
    out = torch.matmul(p, vr.float()) / den[..., None]
    return out.to(qr.dtype), m + torch.log(den)


def _ds(qr, kr, vr, do, lse, delta, causal, scale):
    """(P, dS, q, k, dO) in fp32, P recomputed from lse."""
    qf, kf, dof = qr.float(), kr.float(), do.float()
    s, mask = _scores(qf, kf, causal, scale)
    p = _probs(s, lse, mask)
    dp = torch.matmul(dof, vr.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale, qf, kf, dof


def flash_dq_plain(qr, kr, vr, do, lse, delta, causal: bool,
                   scale: float) -> torch.Tensor:
    """dQ = dS·K in fp32, returned in qr's dtype."""
    _, ds, _, kf, _ = _ds(qr, kr, vr, do, lse, delta, causal, scale)
    return torch.matmul(ds, kf).to(qr.dtype)


def flash_dkv_plain(qr, kr, vr, do, lse, delta, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = dSᵀ·Q and dV = Pᵀ·dO in fp32, returned in k's/v's dtype."""
    p, ds, qf, _, dof = _ds(qr, kr, vr, do, lse, delta, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(kr.dtype), dv.to(vr.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i32, i32, i32, i32, f32, ptr]  # bh, t, d, causal, scale, stream
    for name, n_ptr in (("fwd_f32", 5), ("fwd_bf16", 5), ("fwd_bf16_tma", 5),
                        ("dq_f32", 7), ("dq_bf16", 7), ("dkv_f32", 8),
                        ("dkv_bf16", 8)):
        fn = getattr(lib, f"flash_{name}")
        fn.argtypes = [ptr] * n_ptr + dims
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_head_dim(what: str, x: torch.Tensor) -> None:
    """The CUDA kernels hold a row of q, the output and its accumulator
    in registers, ``D <= 128``; the plain versions have no limit."""
    if x.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: the CUDA kernels take D <= {MAX_HEAD_DIM}, got D = "
            f"{x.shape[-1]} (a wider head on the card is ROADMAP B4; the "
            f"CPU takes any D)")


def _check_kernel_dtype(what: str, x: torch.Tensor) -> None:
    """The CUDA kernels take fp32 or bf16; the plain versions also fp16."""
    if x.dtype not in _SUFFIX:
        raise ValueError(
            f"{what}: the CUDA kernels take float32 or bfloat16, not "
            f"{x.dtype} (fp16 on the card is ROADMAP B4; the CPU takes it)")


def flash_fwd_instance(dtype: torch.dtype, d: int, ptrs) -> str:
    """The forward kernel instance for rows of ``dtype`` and head dim
    ``d`` at the addresses ``ptrs`` (q, k, v, out): ``'wgmma'`` (fed by
    TMA) for bf16 with ``d <= 64``, ``d`` a multiple of 8 (16-byte row
    strides) and every base on 16 bytes; ``'mma'`` (``mma.sync``) for
    the other bf16 rows with ``d <= 64``; ``'simt'`` for fp32, and for
    bf16 with ``64 < d <= 128``."""
    if dtype != torch.bfloat16 or d > 64:
        return "simt"
    if d % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


FWD_TILE = 128  # query rows per item and keys per K/V tile, wgmma forward


def flash_fwd_schedule(bh: int, t: int, causal: bool,
                       n_ctas: int) -> list:
    """The wgmma forward's persistent schedule (``tma_item`` in
    ``csrc/flash_attention.cu``; the kernel runs ``min(items, SMs)``
    CTAs): for each CTA, its items in order as ``(query tile, head row,
    K/V tiles)``.  Item ``w`` of the ``bh · ⌈t/128⌉`` is query tile
    ``n_q − 1 − w // bh`` of head row ``w % bh`` (the longest causal rows
    first); the CTAs take them in rounds, forwards in even rounds and
    backwards in odd ones."""
    n_q = -(-t // FWD_TILE)
    n_items = bh * n_q
    rounds = -(-n_items // n_ctas)
    plan = []
    for c in range(n_ctas):
        mine = []
        for k in range(rounds):
            w = k * n_ctas + (c if k % 2 == 0 else n_ctas - 1 - c)
            if w < n_items:
                qt = n_q - 1 - w // bh
                mine.append((qt, w % bh, min(n_q, qt + 1) if causal else n_q))
        plan.append(mine)
    return plan


def _launch(name: str, x: torch.Tensor, ptrs, causal: bool,
            scale: float) -> None:
    _check_kernel_dtype(f"flash_{name}", x)
    _check_kernel_head_dim(f"flash_{name}", x)
    bh, t, d = x.shape
    addrs = [p.data_ptr() for p in ptrs]
    fn = f"flash_{name}_{_SUFFIX[x.dtype]}"
    if name == "fwd" and flash_fwd_instance(x.dtype, d,
                                            addrs[:4]) == "wgmma":
        fn += "_tma"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _library()
    rc = getattr(lib, fn)(*addrs, bh, t, d, int(bool(causal)), float(scale),
                          stream)
    if rc != 0:
        raise RuntimeError(f"flash_{name} launch failed: "
                           f"{lib.flash_error_string(rc).decode()}")


def _contig(*ts):
    return tuple(t.contiguous() for t in ts)


def flash_fwd(qr: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows forward: ``(out, lse)``; see the module docstring."""
    _check("flash_fwd", qr, kr, vr)
    if not _route(qr, "flash_fwd"):
        return flash_fwd_plain(qr, kr, vr, causal, scale)
    qr, kr, vr = _contig(qr, kr, vr)
    out = torch.empty_like(qr)
    lse = torch.empty(qr.shape[:2], dtype=torch.float32, device=qr.device)
    _launch("fwd", qr, (qr, kr, vr, out, lse), causal, scale)
    flash_fwd.launches += 1
    return out, lse


def flash_dq(qr, kr, vr, do, lse, delta, causal: bool,
             scale: float) -> torch.Tensor:
    """dQ on rows, from the forward's lse and Δ = rowsum(dO·O)."""
    _check("flash_dq", qr, kr, vr, do)
    _check_stats("flash_dq", qr, lse, delta)
    if not _route(qr, "flash_dq"):
        return flash_dq_plain(qr, kr, vr, do, lse, delta, causal, scale)
    qr, kr, vr, do, lse, delta = _contig(qr, kr, vr, do, lse, delta)
    dq = torch.empty_like(qr)
    _launch("dq", qr, (qr, kr, vr, do, lse, delta, dq), causal, scale)
    flash_dq.launches += 1
    return dq


def flash_dkv(qr, kr, vr, do, lse, delta, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) on rows, from the forward's lse and Δ."""
    _check("flash_dkv", qr, kr, vr, do)
    _check_stats("flash_dkv", qr, lse, delta)
    if not _route(qr, "flash_dkv"):
        return flash_dkv_plain(qr, kr, vr, do, lse, delta, causal, scale)
    qr, kr, vr, do, lse, delta = _contig(qr, kr, vr, do, lse, delta)
    dk, dv = torch.empty_like(kr), torch.empty_like(vr)
    _launch("dkv", qr, (qr, kr, vr, do, lse, delta, dk, dv), causal, scale)
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def flash_backward_rows(qr, kr, vr, do, lse, delta, causal: bool,
                        scale: float):
    """The FA-2 backward on rows with a precomputed Δ: ``(dq, dk, dv)``.
    ``scale`` must already be resolved.  With the global lse and Δ each
    (Q, K/V block) pair's results are exact additive parts of the full
    gradient, which is what the ring backward needs."""
    dq = flash_dq(qr, kr, vr, do, lse, delta, causal, scale)
    dk, dv = flash_dkv(qr, kr, vr, do, lse, delta, causal, scale)
    return dq, dk, dv


def flash_forward_with_lse(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = False,
                           scale: Optional[float] = None):
    """Forward only: ``(out (B, T, H, D), lse (B, H, T))``, with no
    autograd rule."""
    b, t, h, _ = q.shape
    out, lse = flash_fwd(to_rows(q), to_rows(k), to_rows(v), causal,
                         resolve_scale(scale, q.shape[-1]))
    return from_rows(out, b, h), lse.view(b, h, t)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, _, h, _ = q.shape
        qr, kr, vr = to_rows(q), to_rows(k), to_rows(v)
        out, lse = flash_fwd(qr, kr, vr, causal, scale)
        ctx.save_for_backward(qr, kr, vr, out, lse)
        ctx.meta = (b, h, causal, scale)
        return from_rows(out, b, h)

    @staticmethod
    def backward(ctx, ct):
        qr, kr, vr, out, lse = ctx.saved_tensors
        b, h, causal, scale = ctx.meta
        do = to_rows(ct.to(out.dtype))
        delta = (do.float() * out.float()).sum(dim=-1)
        dq, dk, dv = flash_backward_rows(qr, kr, vr, do, lse, delta, causal,
                                         scale)
        return (from_rows(dq, b, h), from_rows(dk, b, h),
                from_rows(dv, b, h), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(QKᵀ·scale)V over ``(B, T, H, D)`` with the flash forward
    and the FA-2 backward; returns ``(B, T, H, D)`` in q's dtype."""
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 resolve_scale(scale, q.shape[-1]))
