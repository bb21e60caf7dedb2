"""Temperature and top-k sampling on the decode path — counterpart of
``theanompi_tpu.serving.sampling``.

The picks, as the reference's ``_sample_core``, on the same fp32 logits:

- ``temperature == 0`` is exact greedy: ``argmax`` (first maximum on
  ties), not a small-temperature limit.
- top-k: the threshold is the k-th largest logit of the descending sort
  (``k`` clipped to 1..V); every logit below it becomes ``-1e30``.
  ``top_k == 0`` keeps every logit.
- The kept logits are divided by ``max(T, 1e-6)`` and the pick is
  ``argmax(scaled + g)`` over Gumbel noise ``g``: the Gumbel-max form of
  a categorical draw, which is what ``jax.random.categorical`` computes.

The noise.  Torch cannot reproduce ``jax.random``'s streams, so the port
draws its own, counter-based, on the logits' device: a draw's word
``request_seed(seed, rid, token_index)`` (the request's seed, or
``zlib.crc32`` of its id when unseeded, as the reference's
``request_key``, mixed with the token index) and vocabulary index
``j`` give ``u = hash(j·0x9E3779B9 + word)`` (the gradient wire's
``hash_uniform``, clamped into (0, 1)) and ``g = -log(-log u)``,
computed in fp64 and rounded to fp32.  A request's stream therefore
depends only on (seed, id, token index): the same on the CPU and on the
card, whatever the batch or its interleaving.  Tests hand ``pick_batch``
the reference's own noise, ``jax.random.gumbel(request_key(...))``, and
then the picks are the reference's bit for bit.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from theanompi_tpu_torch.parallel.quantize import _mul32, hash_uniform

NEG_INF = -1e30  # the engine's finite mask value
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_U_MIN = 2.0 ** -25  # u = 0 would give an infinite g


def _fmix32(x: int) -> int:
    """MurmurHash3's 32-bit finalizer (a bijection on uint32)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def request_seed(seed: Optional[int], rid: str, token_index: int) -> int:
    """The uint32 word of one draw: the request's ``seed`` (or, when it
    is None, ``zlib.crc32`` of the id, stable across processes) mixed
    with the token index, so the order of decoding across slots never
    changes a request's stream."""
    if seed is None:
        seed = zlib.crc32(rid.encode("utf-8"))
    s = int(seed) & ((1 << 64) - 1)
    h = _fmix32(int(token_index) ^ _GOLDEN)
    h = _fmix32(h ^ (s & _M32))
    return _fmix32(h ^ (s >> 32))


def gumbel_noise(words: Sequence[int], vocab: int,
                 device=None) -> torch.Tensor:
    """(N, vocab) fp32 Gumbel noise, row i from draw word ``words[i]``."""
    w = torch.as_tensor(np.asarray(words, dtype=np.int64) & _M32,
                        device=device)
    j = torch.arange(vocab, dtype=torch.int64, device=device)
    u = hash_uniform((_mul32(j, _GOLDEN)[None, :] + w[:, None]) & _M32)
    u = u.double().clamp_(min=_U_MIN)
    return (-torch.log(-torch.log(u))).float()


class Sampler:
    """The batched pick of the scheduler.  ``pick_batch`` draws one token
    per row in one pass on the logits' device and one host transfer;
    row i uses row i's noise, temperature and top-k only, so a batched
    pick equals ``len(batch)`` single picks."""

    @staticmethod
    def scores(logits: torch.Tensor, noise: Optional[torch.Tensor],
               temperatures, top_ks) -> torch.Tensor:
        """The fp32 (N, V) scores whose argmax is each row's pick: the
        logits on greedy rows (temperature 0), ``top-k-masked logits /
        max(T, 1e-6) + noise`` on sampled rows."""
        lg = logits.to(torch.float32)
        n, v = lg.shape
        dev = lg.device
        temps = torch.as_tensor(np.asarray(temperatures, np.float32),
                                device=dev)
        ks = torch.as_tensor(np.asarray(top_ks, np.int64), device=dev)
        desc = torch.sort(lg, dim=-1, descending=True).values
        kth = torch.gather(desc, 1, (ks.clamp(1, v) - 1)[:, None])
        masked = torch.where((ks[:, None] > 0) & (lg < kth),
                             torch.full_like(lg, NEG_INF), lg)
        # an IEEE division by a tensor (torch turns a division by a
        # Python number into a reciprocal multiply on the card)
        scaled = masked / temps.clamp(min=1e-6)[:, None]
        if noise is not None:
            scaled = scaled + noise.to(device=dev, dtype=torch.float32)
        return torch.where((temps > 0)[:, None], scaled, lg)

    def pick_batch(self, logits: torch.Tensor, noise: Optional[torch.Tensor],
                   temperatures, top_ks) -> np.ndarray:
        """One token id per row of ``logits`` (N, V): ``noise`` (N, V)
        or None (greedy rows ignore it), ``temperatures`` (N,) float,
        ``top_ks`` (N,) int.  Returns a host int64 array (N,)."""
        s = self.scores(logits, noise, temperatures, top_ks)
        return torch.argmax(s, dim=-1).cpu().numpy()

    def sample(self, logits: torch.Tensor, noise: Optional[torch.Tensor],
               temperature: float, top_k: int = 0) -> int:
        """One token id from ``logits`` (V,) with ``noise`` (V,)."""
        return int(self.pick_batch(
            logits[None], None if noise is None else noise[None],
            [temperature], [top_k],
        )[0])
