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
  launches, ``paged_decode_attention_i8.launches`` the int8 kernel's.
- ``paged_decode_attention_plain`` — the gathered-image computation of
  the reference's XLA path (``serving/paging.py`` decode tick): gather
  each lane's whole table image, mask, softmax, weighted sum.  The CPU
  path and the reference the kernel is held to on the card.
- ``paged_decode_attention_i8_plain`` — the same over the dequantized
  image ``int8 · scale`` (the reference's ``_kv_image``), in fp32.

Numerics: scores, softmax and sums in fp32 on both; the plain version
rounds the probabilities to the pool dtype before the second product
(as the reference's XLA path does), the kernel keeps them fp32 (as the
reference's TPU kernel does).  For fp32 pools the two differ only in
summation order; for bf16 pools by that rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fn in _POOL_FNS.values():
        f = getattr(lib, fn)
        f.argtypes = _ARGTYPES
        f.restype = ctypes.c_int
    f = getattr(lib, _I8_FN)
    f.argtypes = _I8_ARGTYPES
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
    on the current stream and raises if the launch is refused.
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
    out = _launch(_POOL_FNS[k_pool.dtype], q, (k_pool, v_pool), tables,
                  lengths, block_size, scale)
    paged_decode_attention.launches += 1
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
    out = _launch(_I8_FN, q, (k_pool, v_pool, k_scale, v_scale), tables,
                  lengths, block_size, scale)
    paged_decode_attention_i8.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_i8.launches = 0
