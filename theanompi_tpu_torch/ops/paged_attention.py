"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``theanompi_tpu.ops.pallas_paged.paged_decode_attention``
(the fp32 / compute-dtype pool kernel ``_paged_kernel``).  One decode
tick's attention for every serving lane: a single query per lane
against the K/V rows its block table points at, rows at positions
``<= length`` attending.

- ``paged_decode_attention`` — the entry the engine calls.  The
  device of ``q`` decides what runs: a CUDA tensor launches the
  hand-written kernel (``csrc/paged_decode_attention.cu``) or raises; a
  CPU tensor takes the plain version; any other device raises.  Nothing
  falls back from the card to the plain version.
  ``paged_decode_attention.launches`` counts kernel launches.
- ``paged_decode_attention_plain`` — the gathered-image computation of
  the reference's XLA path (``serving/paging.py`` decode tick): gather
  each lane's whole table image, mask, softmax, weighted sum.  The CPU
  path and the reference the kernel is held to on the card.

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
_POOL_FNS = {
    torch.float32: "paged_decode_attention_f32",
    torch.bfloat16: "paged_decode_attention_bf16",
}
_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p]
)


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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    for fn in _POOL_FNS.values():
        f = getattr(lib, fn)
        f.argtypes = _ARGTYPES
        f.restype = ctypes.c_int
    lib.paged_decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(q, k_pool, v_pool, tables, lengths) -> None:
    dev = q.device
    named = dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
                 lengths=lengths)
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
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in _POOL_FNS:
        raise TypeError(
            f"pools must both be float32 or bfloat16, got {k_pool.dtype}/"
            f"{v_pool.dtype}"
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
    if not 1 <= hd <= 128:
        raise ValueError(f"head_dim {hd} outside the kernel's 1..128")
    if tables.shape[1] < 1:
        raise ValueError("tables need at least one column")


def paged_decode_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, *, block_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q·Kᵀ·scale)·V over each lane's paged K/V, one layer.

    - ``q`` (S, H, hd): the decode tick's single query per lane.
    - ``k_pool``/``v_pool`` (R, H, hd), R = n_blocks · block_size, in
      fp32 or bf16.
    - ``tables`` (S, NT) int32: per-lane block ids (0 = the trash
      block); every id must be below n_blocks.
    - ``lengths`` (S,) int32, ``>= 0``: the incoming token's position;
      rows at positions ``<= length`` attend (the token's own K/V was
      written before the call).

    Returns fp32 (S, H, hd).  On CUDA tensors this launches the kernel
    on the current stream and raises if the launch is refused.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, tables, lengths, block_size=block_size,
            scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention runs on cuda (kernel) or cpu (plain "
            f"version), not {q.device}"
        )
    _check_cuda_inputs(q, k_pool, v_pool, tables, lengths)
    s_, h, hd = q.shape
    scale = float(scale) if scale is not None else hd ** -0.5
    lib = _library()
    qf = q.float().contiguous()
    out = torch.empty((s_, h, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, _POOL_FNS[k_pool.dtype])(
        qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        s_, h, hd, tables.shape[1], int(block_size), scale, stream,
    )
    if rc != 0:
        msg = lib.paged_decode_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
