"""Block quantization of the gradient wire: the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``theanompi_tpu.parallel.quantize`` (``quantize_blocks``,
``quantize_blocks_fp16``, ``dequantize_blocks`` and the Pallas kernels
``_quant_kernel``, ``_quant_sr_kernel``, ``_quant_fp16_kernel``,
``_dequant_kernel``).  Every function takes ``(…, BLOCK)`` inputs: one
quantization block per row of 256 fp32 elements, any number of rows,
and one fp32 scale per row.

- ``quantize_int8`` — ``q = round(x / safe)`` (half to even), the
  scale ``s = amax / 127``, ``safe = s if s > 0 else 1``.
- ``quantize_int8_sr`` — stochastic rounding: ``q = clip(floor(x /
  safe + u), -127, 127)`` with the reference kernel's counter-hash
  dither ``u = hash(idx·0x9E3779B9 + seed)`` (uint32 arithmetic, top 24
  bits as a fraction of 2²⁴), ``idx`` the element's index in the
  call's flattened input, ``seed`` a uint32 word.  The reference's
  Pallas kernel draws that word with ``jax.random.bits(key, (1, 1),
  uint32)``; here the caller passes it, and the same word gives the
  same payload.
- ``quantize_fp16`` — ``q = fp16(x / safe)`` with ``s = amax / 256``
  (``FP16_CAP``): every block lands in fp16's normal range.
- ``dequantize`` — ``float(q) · s`` for an int8 or fp16 payload;
  with ``n`` only the first ``n`` elements of the flattened result, and
  with ``divisor`` each divided by it (IEEE, after the product): the
  block wire's last step, the mean over the ranks, in one pass.
- ``dequant_sum_quantize_int8``, ``dequant_sum_quantize_int8_sr`` and
  ``dequant_sum_quantize_fp16`` — leg 2 of the ``int8``, ``int8_sr``
  and ``fp16s`` wires, each in one call: the gathered ``(world, nb,
  256)`` int8 (fp16) shards and ``(world, nb)`` scales are dequantized,
  summed over the ranks in ascending order (``((d₀ + d₁) + d₂) + …``,
  each product and sum rounded once: what ``torch.sum(dim=0)`` gives on
  the CPU) and quantized as ``quantize_int8``, ``quantize_int8_sr``
  (with ``seed``) or ``quantize_fp16`` would quantize the ``(nb, 256)``
  sum.  Only the payload and scales of the sum come out.
- ``quantize_rows`` / ``dequantize_rows`` — the same int8
  round-to-nearest codec over the last axis of any width, in plain
  torch on any device (no kernel: the reference applies
  ``quantize_blocks`` over head_dim in XLA).  The int8 KV cache writes
  its rows through it (``serving.paging``).

The device of the input decides what runs: a CUDA tensor launches the
hand-written kernel (``csrc/block_quant.cu``) or raises; a CPU tensor
takes the plain version (``*_plain``).  Nothing falls back from the
card to the plain version.  Each wrapper counts its kernel launches in
``.launches``.

Numerics, the same on both routes: the scale is the IEEE quotient
``amax / cap`` (the reference's XLA path and source text; its Pallas
kernel under interpret mode multiplies by ``fp32(1/127)`` instead and
can land one ulp away), ``x / safe`` is an IEEE division, and
round-to-nearest is half to even.  The plain versions divide by a
tensor, never by a Python number: on the card torch turns a division by
a scalar into a multiplication by its reciprocal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from theanompi_tpu_torch import cuda_build

KERNEL = "block_quant"
BLOCK = 256  # elements per quantization block (one fp32 scale each)
INT8_CAP = 127.0
FP16_CAP = 256.0
_M32 = 0xFFFFFFFF
_PAYLOADS = (torch.int8, torch.float16)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------------

def _check_input(what: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() < 1 or x.shape[-1] != BLOCK:
        raise ValueError(f"{what}: want float32 (…, {BLOCK}), got {x.dtype} "
                         f"{tuple(x.shape)}")


def _scale(x: torch.Tensor, cap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(s, safe)``: ``s = amax / cap`` as an IEEE division and
    the divide-safe ``where(s > 0, s, 1)``."""
    amax = x.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, cap)
    return s, torch.where(s > 0, s, torch.ones_like(s))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a · b mod 2³²`` for int64 ``a`` in [0, 2³²): the product taken
    in 16-bit halves of ``a`` so that no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_uniform(counter: torch.Tensor) -> torch.Tensor:
    """The reference's ``_hash_uniform``: xor-shift/multiply avalanche of
    a uint32 counter (int64 values in [0, 2³²)), top 24 bits → fp32 in
    [0, 1)."""
    x = counter
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _sr_dither(n: int, seed: int, device=None) -> torch.Tensor:
    """``u`` for elements ``0..n-1`` of one call: ``hash(idx·0x9E3779B9
    + seed)`` with uint32 wraparound."""
    idx = torch.arange(n, dtype=torch.int64, device=device) & _M32
    return hash_uniform((_mul32(idx, 0x9E3779B9) + (int(seed) & _M32)) & _M32)


def quantize_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 256) fp32 → ((…, 256) int8 round-to-nearest-even, (…,) fp32)."""
    _check_input("quantize_int8", x)
    s, safe = _scale(x, INT8_CAP)
    q = torch.round(x / safe[..., None]).clamp_(-INT8_CAP, INT8_CAP)
    return q.to(torch.int8), s


def quantize_int8_sr_plain(x: torch.Tensor, seed: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 256) fp32 → ((…, 256) int8 stochastically rounded, (…,) fp32)."""
    _check_input("quantize_int8_sr", x)
    s, safe = _scale(x, INT8_CAP)
    u = _sr_dither(x.numel(), seed, x.device).view(x.shape)
    q = torch.floor(x / safe[..., None] + u).clamp_(-INT8_CAP, INT8_CAP)
    return q.to(torch.int8), s


def quantize_fp16_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 256) fp32 → ((…, 256) fp16, (…,) fp32), amax mapped to 256."""
    _check_input("quantize_fp16", x)
    s, safe = _scale(x, FP16_CAP)
    return (x / safe[..., None]).to(torch.float16), s


def dequantize_plain(q: torch.Tensor, s: torch.Tensor,
                     divisor: Optional[float] = None,
                     n: Optional[int] = None) -> torch.Tensor:
    """int8 or fp16 (…, 256) payload and (…,) scales → fp32 (…, 256), or
    with ``n`` the first ``n`` elements flat; with ``divisor`` each
    value divided by it (by a tensor: an IEEE division on every
    device)."""
    _check_payload(q, s)
    _check_length(q, n)
    out = q.to(torch.float32) * s[..., None]
    if n is not None:
        out = out.view(-1)[:n]
    if divisor is not None:
        out = out / torch.full_like(out, float(divisor))
    return out


def _rank_sum_plain(q_t: torch.Tensor, s_t: torch.Tensor,
                    what: str, payload: torch.dtype) -> torch.Tensor:
    """``dequantize_plain(q_t, s_t).sum(dim=0)``, the sum written out in
    ascending rank order so that it is that order on every device."""
    _check_shards(q_t, s_t, what, payload)
    d = dequantize_plain(q_t, s_t)
    total = d[0]
    for p in range(1, d.shape[0]):
        total = total + d[p]
    return total


def dequant_sum_quantize_int8_plain(q_t: torch.Tensor, s_t: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(world, nb, 256) int8 and (world, nb) fp32 → the RN-quantized
    ``(nb, 256)`` sum over the ranks: ``quantize_int8_plain(
    dequantize_plain(q_t, s_t).sum(dim=0))``, the ranks in ascending
    order."""
    return quantize_int8_plain(_rank_sum_plain(
        q_t, s_t, "dequant_sum_quantize_int8", torch.int8))


def dequant_sum_quantize_int8_sr_plain(q_t: torch.Tensor, s_t: torch.Tensor,
                                       seed: int
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(world, nb, 256) int8 and (world, nb) fp32 → the SR-quantized
    ``(nb, 256)`` sum over the ranks: ``quantize_int8_sr_plain(
    dequantize_plain(q_t, s_t).sum(dim=0), seed)``, the ranks in
    ascending order."""
    return quantize_int8_sr_plain(_rank_sum_plain(
        q_t, s_t, "dequant_sum_quantize_int8_sr", torch.int8), seed)


def dequant_sum_quantize_fp16_plain(q_t: torch.Tensor, s_t: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(world, nb, 256) fp16 and (world, nb) fp32 → the fp16-quantized
    ``(nb, 256)`` sum over the ranks: ``quantize_fp16_plain(
    dequantize_plain(q_t, s_t).sum(dim=0))``, the ranks in ascending
    order."""
    return quantize_fp16_plain(_rank_sum_plain(
        q_t, s_t, "dequant_sum_quantize_fp16", torch.float16))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, n) float → ((…, n) int8, (…,) fp32): one scale ``amax / 127``
    per row of the last axis, round half to even, clip to ±127.  Runs
    where ``x`` lies (plain torch; the division is by a tensor, so the
    scale is the IEEE quotient on the card too)."""
    x = x.to(torch.float32)
    s, safe = _scale(x, INT8_CAP)
    q = torch.round(x / safe[..., None]).clamp_(-INT8_CAP, INT8_CAP)
    return q.to(torch.int8), s


def dequantize_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(…, n) int8 and (…,) fp32 scales → fp32 (…, n)."""
    return q.to(torch.float32) * s[..., None]


def _check_length(q: torch.Tensor, n: Optional[int]) -> None:
    if n is not None and not 0 <= n <= q.numel():
        raise ValueError(f"dequantize: n={n} outside 0..{q.numel()}, the "
                         "payload's elements")


def _check_shards(q_t: torch.Tensor, s_t: torch.Tensor, what: str,
                  payload: torch.dtype) -> None:
    if (q_t.dtype != payload or q_t.dim() != 3 or q_t.shape[0] < 1
            or q_t.shape[-1] != BLOCK or s_t.dtype != torch.float32
            or s_t.shape != q_t.shape[:-1] or s_t.device != q_t.device):
        raise ValueError(
            f"{what}: want (world, nb, {BLOCK}) {payload} shards and "
            f"(world, nb) float32 scales on one device; got "
            f"{q_t.dtype} {tuple(q_t.shape)} on {q_t.device}, {s_t.dtype} "
            f"{tuple(s_t.shape)} on {s_t.device}")


def _check_payload(q: torch.Tensor, s: torch.Tensor) -> None:
    if (q.dtype not in _PAYLOADS or q.dim() < 1 or q.shape[-1] != BLOCK
            or s.dtype != torch.float32 or s.shape != q.shape[:-1]
            or s.device != q.device):
        raise ValueError(
            f"dequantize: want an int8 or float16 (…, {BLOCK}) payload and "
            f"float32 (…,) scales on one device; got {q.dtype} "
            f"{tuple(q.shape)} on {q.device}, {s.dtype} {tuple(s.shape)} on "
            f"{s.device}")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    ptr, rows = ctypes.c_void_p, ctypes.c_long
    deq = [ctypes.c_long, ctypes.c_float]  # n, divisor
    for name, n_ptr, extra in (
        ("block_quant_int8", 3, [rows]),
        ("block_quant_int8_sr", 3, [rows, ctypes.c_uint32]),
        ("block_quant_fp16", 3, [rows]),
        ("block_dequant_int8", 3, [rows] + deq),
        ("block_dequant_fp16", 3, [rows] + deq),
        ("block_dequant_sum_quant_int8", 4, [ctypes.c_int, rows]),
        ("block_dequant_sum_quant_int8_sr", 4,
         [ctypes.c_int, rows, ctypes.c_uint32]),
        ("block_dequant_sum_quant_fp16", 4, [ctypes.c_int, rows]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + extra + [ptr]
        fn.restype = ctypes.c_int
    lib.block_quant_error_string.argtypes = [ctypes.c_int]
    lib.block_quant_error_string.restype = ctypes.c_char_p
    return lib


def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain version), "
                     f"not {x.device}")


def _launch(name: str, ptrs, *extra) -> None:
    lib = _library()
    stream = torch.cuda.current_stream(ptrs[0].device).cuda_stream
    rc = getattr(lib, name)(*[p.data_ptr() for p in ptrs], *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.block_quant_error_string(rc).decode()}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernels load
    16 bytes a lane)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _quantize(name: str, x: torch.Tensor, payload: torch.dtype, *extra):
    x = _dense(x)
    q = torch.empty(x.shape, dtype=payload, device=x.device)
    s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = x.numel() // BLOCK
    if rows:
        _launch(name, (x, q, s), rows, *extra)
    return q, s, rows > 0


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest int8 blocks; see the module docstring."""
    if not _route(x, "quantize_int8"):
        return quantize_int8_plain(x)
    _check_input("quantize_int8", x)
    q, s, ran = _quantize("block_quant_int8", x, torch.int8)
    quantize_int8.launches += ran
    return q, s


def quantize_int8_sr(x: torch.Tensor, seed: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastically rounded int8 blocks from a uint32 ``seed`` word."""
    if not _route(x, "quantize_int8_sr"):
        return quantize_int8_sr_plain(x, seed)
    _check_input("quantize_int8_sr", x)
    q, s, ran = _quantize("block_quant_int8_sr", x, torch.int8,
                          int(seed) & _M32)
    quantize_int8_sr.launches += ran
    return q, s


def quantize_fp16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp16 blocks with the block amax mapped to ``FP16_CAP``."""
    if not _route(x, "quantize_fp16"):
        return quantize_fp16_plain(x)
    _check_input("quantize_fp16", x)
    q, s, ran = _quantize("block_quant_fp16", x, torch.float16)
    quantize_fp16.launches += ran
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor,
               divisor: Optional[float] = None,
               n: Optional[int] = None) -> torch.Tensor:
    """fp32 reconstruction of an int8 or fp16 payload: (…, 256), or with
    ``n`` its first ``n`` elements flat, each divided by ``divisor``
    when given."""
    if not _route(q, "dequantize"):
        return dequantize_plain(q, s, divisor, n)
    _check_payload(q, s)
    _check_length(q, n)
    q, s = _dense(q), s.contiguous()
    out = torch.empty(q.shape if n is None else (n,), dtype=torch.float32,
                      device=q.device)
    if out.numel():
        name = ("block_dequant_int8" if q.dtype == torch.int8
                else "block_dequant_fp16")
        _launch(name, (q, s, out), q.numel() // BLOCK, out.numel(),
                1.0 if divisor is None else float(divisor))
        dequantize.launches += 1
    return out


def _leg2(name: str, q_t: torch.Tensor, s_t: torch.Tensor,
          payload: torch.dtype, *extra
          ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """A fused leg 2 on checked CUDA shards: ``(q2, s2, launched)``
    (nothing launches for nb 0)."""
    q_t, s_t = _dense(q_t), s_t.contiguous()
    world, nb = q_t.shape[0], q_t.shape[1]
    q2 = torch.empty((nb, BLOCK), dtype=payload, device=q_t.device)
    s2 = torch.empty((nb,), dtype=torch.float32, device=q_t.device)
    if nb:
        _launch(name, (q_t, s_t, q2, s2), world, nb, *extra)
    return q2, s2, nb > 0


def dequant_sum_quantize_int8(q_t: torch.Tensor, s_t: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leg 2 of the ``int8`` wire in one launch: the RN-quantized sum
    over the ranks of gathered ``(world, nb, 256)`` int8 shards; see the
    module docstring."""
    what = "dequant_sum_quantize_int8"
    if not _route(q_t, what):
        return dequant_sum_quantize_int8_plain(q_t, s_t)
    _check_shards(q_t, s_t, what, torch.int8)
    q2, s2, ran = _leg2("block_dequant_sum_quant_int8", q_t, s_t, torch.int8)
    dequant_sum_quantize_int8.launches += ran
    return q2, s2


def dequant_sum_quantize_int8_sr(q_t: torch.Tensor, s_t: torch.Tensor,
                                 seed: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leg 2 of the ``int8_sr`` wire in one launch: the SR-quantized sum
    over the ranks of gathered ``(world, nb, 256)`` int8 shards; see the
    module docstring."""
    what = "dequant_sum_quantize_int8_sr"
    if not _route(q_t, what):
        return dequant_sum_quantize_int8_sr_plain(q_t, s_t, seed)
    _check_shards(q_t, s_t, what, torch.int8)
    q2, s2, ran = _leg2("block_dequant_sum_quant_int8_sr", q_t, s_t,
                        torch.int8, int(seed) & _M32)
    dequant_sum_quantize_int8_sr.launches += ran
    return q2, s2


def dequant_sum_quantize_fp16(q_t: torch.Tensor, s_t: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leg 2 of the ``fp16s`` wire in one launch: the fp16-quantized sum
    over the ranks of gathered ``(world, nb, 256)`` fp16 shards; see the
    module docstring."""
    what = "dequant_sum_quantize_fp16"
    if not _route(q_t, what):
        return dequant_sum_quantize_fp16_plain(q_t, s_t)
    _check_shards(q_t, s_t, what, torch.float16)
    q2, s2, ran = _leg2("block_dequant_sum_quant_fp16", q_t, s_t,
                        torch.float16)
    dequant_sum_quantize_fp16.launches += ran
    return q2, s2


quantize_int8.launches = 0
quantize_int8_sr.launches = 0
quantize_fp16.launches = 0
dequantize.launches = 0
dequant_sum_quantize_int8.launches = 0
dequant_sum_quantize_int8_sr.launches = 0
dequant_sum_quantize_fp16.launches = 0
WRAPPERS = (quantize_int8, quantize_int8_sr, quantize_fp16, dequantize,
            dequant_sum_quantize_int8, dequant_sum_quantize_int8_sr,
            dequant_sum_quantize_fp16)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    """Wrapper name → its launch count."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
