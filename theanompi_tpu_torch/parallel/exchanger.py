"""BSP gradient exchange over a ``torch.distributed`` group —
counterpart of ``theanompi_tpu.parallel.exchanger.BSP_Exchanger``.

``reduce_grads`` (cdd) and ``average_params`` (avg) take the mean of a
list of tensors over the group's ranks.  With ``bucket_bytes`` set the
tensors are fused into flat fp32 buckets (``parallel.bucketing``), one
wire per bucket; without it, one wire per tensor.  Wire strategies:

- ``ar``   — fp32 ``all_reduce`` sum, divided by the world size;
- ``bf16`` / ``fp16`` — the payload is cast to the wire dtype, summed
  in it, widened to fp32 and divided (the reference's cast wire);
- ``int8``, ``int8_sr``, ``fp16s`` and their ``pallas_*`` names — the
  block-quantized wire (``parallel.quantize``): each rank pads its flat
  payload to whole shards of 256-element blocks and quantizes it (leg
  1), ``all_to_all_single`` hands shard p to rank p, each rank
  dequantizes and sums its shard in fp32, quantizes the sum (leg 2,
  ``wire_leg2``: one launch), and
  ``all_gather_into_tensor`` gives every rank every shard, which it
  dequantizes (``dequantize`` with the mean's division by the world
  size in the same pass).  Only payload and fp32 scales cross the wire: int8 ≈
  N + N/64 bytes each way, fp16s ≈ 2N + N/64, against 4N for ``ar``.
  Every rank dequantizes the same gathered bytes, so the reduced
  gradients are bitwise equal across the ranks.  A payload too small
  to win (``4n < chunk · payload bytes``) rides a lossless fp32
  ``all_reduce``, and at a world of 1 the wire is the identity, both
  as in the reference.

The ``pallas_`` prefix keeps one effect here: the reference's Pallas
kernels take 32-row tiles, so its chunk is ``world · 256 · 32`` instead
of ``world · 256``; the port pads and falls back exactly where the
reference does.  Both names run the same CUDA kernels on the card (the
plain versions on the CPU).  The reference's XLA ``int8_sr`` draws its
dither with ``jax.random.uniform``, which torch cannot reproduce; the
port's ``int8_sr`` uses the counter-hash dither of the reference's
Pallas kernel for both names.  Stochastic rounding takes per-call seed
words: ``seeds[u] = (leg-1 word, leg-2 word)`` for bucket (or tensor)
``u``, in the reference's key order (``fold_in(rng, u)``, then
``fold_in(·, 0)`` for its one exchange axis, then ``split`` into the
two legs' keys, each drawn as ``jax.random.bits(key, (1, 1), uint32)``
by its Pallas kernel).  Models draw them per rank and per step.

Error feedback (``reduce_with_residual``, ``local_roundtrip``): the
leg-1 image of this rank's contribution, from the same ``_leg1_pack``
the wire uses, so the residual ``send - roundtrip`` is exactly what
leg 1 dropped.  Flat wire only: the reference's two-level DCN wire
(``_hier_chain``) is ROADMAP A9.

The reduction runs on the current stream.  Gloo takes CUDA tensors in
``all_reduce``, ``all_to_all_single`` and ``all_gather_into_tensor``
(ranks that share one card run gloo; ``runtime.dist``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from theanompi_tpu_torch.parallel import bucketing
from theanompi_tpu_torch.parallel import quantize as Q

STRATEGIES = ("ar", "bf16", "fp16", "fp16s", "pallas_fp16s", "int8",
              "pallas_int8", "int8_sr", "pallas_int8_sr")
_WIRE = {"ar": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
_FP16S_STRATEGIES = ("fp16s", "pallas_fp16s")
_SR_STRATEGIES = ("int8_sr", "pallas_int8_sr")
_BLOCK_STRATEGIES = ("int8", "pallas_int8") + _SR_STRATEGIES + \
    _FP16S_STRATEGIES
DATA_AXIS = "dp"
Seeds = Optional[Sequence[Tuple[int, int]]]


def block_wire_kernels(strategy: str):
    """``(quant, dequant)`` for a block strategy: ``quant(x, seed)``
    (``seed`` is used by the SR strategies only) and ``dequant(q, s)``
    — the one selection every block-wire path shares."""
    if strategy in _FP16S_STRATEGIES:
        def quant(x, seed):
            return Q.quantize_fp16(x)
    elif strategy in _SR_STRATEGIES:
        def quant(x, seed):
            return Q.quantize_int8_sr(x, seed)
    elif strategy in _BLOCK_STRATEGIES:
        def quant(x, seed):
            return Q.quantize_int8(x)
    else:
        raise ValueError(f"{strategy!r} is not a block strategy")
    return quant, Q.dequantize


def wire_leg2(strategy: str, q_t: torch.Tensor, s_t: torch.Tensor,
              seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leg 2 of a block wire on this rank's gathered shards (``(world,
    nb, 256)`` payload, ``(world, nb)`` scales): the requantized fp32
    sum over the ranks, ``(q2, s2)``, in one call for every block
    strategy (``seed``, the leg-2 word, is used by the SR strategies
    only)."""
    if strategy in _SR_STRATEGIES:
        return Q.dequant_sum_quantize_int8_sr(q_t, s_t, seed)
    if strategy in _FP16S_STRATEGIES:
        return Q.dequant_sum_quantize_fp16(q_t, s_t)
    if strategy in _BLOCK_STRATEGIES:
        return Q.dequant_sum_quantize_int8(q_t, s_t)
    raise ValueError(f"{strategy!r} is not a block strategy")


def blocks_per_shard(n: int, world: int, strategy: str) -> Optional[int]:
    """Quantization blocks in each rank's shard of an ``n``-element flat
    payload on a block ``strategy``'s wire at ``world`` ranks, or None
    when the payload rides the lossless fp32 ``all_reduce`` (the
    reference's crossover ``4n < chunk · payload bytes``).  Each shard
    is padded to whole blocks (whole 32-block tiles for ``pallas_*``)."""
    chunk = world * Q.BLOCK * (32 if strategy.startswith("pallas_") else 1)
    payload_bytes = 2 if strategy in _FP16S_STRATEGIES else 1
    if 4 * n < chunk * payload_bytes:
        return None
    return (n + (-n) % chunk) // (world * Q.BLOCK)


class BSP_Exchanger:
    """Mean over the ranks of ``group`` (default: the default group)."""

    def __init__(self, strategy: str = "ar", group=None,
                 bucket_bytes: Optional[int] = None):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r}; pick from {STRATEGIES}")
        self.strategy = strategy
        self.group = group
        self.bucket_bytes = int(bucket_bytes) if bucket_bytes else None
        self.block = strategy in _BLOCK_STRATEGIES
        self.needs_seeds = strategy in _SR_STRATEGIES

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    # -- the block-quantized wire -------------------------------------------
    def _leg1_pack(self, flat: torch.Tensor, seed=None) -> Optional[dict]:
        """Leg-1 quantization of this rank's flat fp32 contribution: the
        one definition the wire and the error-feedback image share.
        None when the payload rides the lossless fallback."""
        w1 = w2 = None
        if self.needs_seeds:
            if seed is None:
                raise ValueError(
                    f"strategy {self.strategy!r} needs per-call seed words: "
                    "reduce_grads(grads, names, seeds=[(w1, w2), ...])")
            w1, w2 = (int(w) for w in seed)
        n, world = flat.numel(), self.world
        nb = blocks_per_shard(n, world, self.strategy)
        if nb is None:
            return None
        pad = world * nb * Q.BLOCK - n
        if pad:
            flat = F.pad(flat, (0, pad))
        quant, _ = block_wire_kernels(self.strategy)
        q, s = quant(flat.view(world, nb, Q.BLOCK), w1)
        return dict(q=q, s=s, w2=w2, n=n)

    def _wire_from_packed(self, packed: dict,
                          divisor: Optional[int] = None) -> torch.Tensor:
        """The two collective legs after a leg-1 pack; returns the fp32
        sum over the ranks, flat, of the packed length, each element
        divided by ``divisor`` when given (the mean)."""
        q, s = packed["q"], packed["s"]
        q_t, s_t = torch.empty_like(q), torch.empty_like(s)
        # row p of the result is rank p's shard for this rank
        dist.all_to_all_single(q_t, q, group=self.group)
        dist.all_to_all_single(s_t, s, group=self.group)
        q2, s2 = wire_leg2(self.strategy, q_t, s_t, packed["w2"])
        world = q.shape[0]
        q_all = torch.empty((world, *q2.shape), dtype=q2.dtype,
                            device=q2.device)
        s_all = torch.empty((world, *s2.shape), dtype=s2.dtype,
                            device=s2.device)
        # flat on both sides: gloo refuses a (world, …) output
        dist.all_gather_into_tensor(q_all.view(-1), q2.view(-1),
                                    group=self.group)
        dist.all_gather_into_tensor(s_all.view(-1), s2.view(-1),
                                    group=self.group)
        # the first n elements, divided in the same pass for the mean
        return Q.dequantize(q_all, s_all, divisor, packed["n"])

    @staticmethod
    def _img_from_packed(packed: dict) -> torch.Tensor:
        """The dequantized leg-1 image, flat, of the packed length."""
        return Q.dequantize(packed["q"], packed["s"], n=packed["n"])

    def _sum_fp32(self, flat: torch.Tensor) -> torch.Tensor:
        out = flat.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    # -- per-flat-payload recipes -------------------------------------------
    def _flat_mean(self, flat: torch.Tensor, seed=None) -> torch.Tensor:
        """fp32 flat payload → its mean over the ranks, fp32."""
        world = self.world
        if not self.block:
            # a copy: flat may be a view of the caller's tensor
            wire = flat.to(_WIRE[self.strategy], copy=True)
            dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
            return wire.float() / world
        if world == 1:
            return flat
        packed = self._leg1_pack(flat, seed)
        if packed is None:
            return self._sum_fp32(flat) / world
        return self._wire_from_packed(packed, world)

    def _require_ef_capable(self) -> None:
        if self.strategy != "ar" and not self.block:
            raise ValueError(
                f"error feedback is not defined for the cast wire "
                f"{self.strategy!r} (use a block strategy: "
                f"{sorted(_BLOCK_STRATEGIES)})")

    def _flat_mean_with_rt(self, flat: torch.Tensor, seed=None):
        """(mean, roundtrip) with one leg-1 pack; the roundtrip is the
        reference's ``g - (g - image)``."""
        self._require_ef_capable()
        if self.strategy == "ar":
            return self._flat_mean(flat), flat
        world = self.world
        if world == 1:
            return flat, flat
        packed = self._leg1_pack(flat, seed)
        if packed is None:  # lossless fallback: nothing dropped
            return self._sum_fp32(flat) / world, flat
        loss = flat - self._img_from_packed(packed)
        return self._wire_from_packed(packed, world), flat - loss

    def _flat_roundtrip(self, flat: torch.Tensor, seed=None) -> torch.Tensor:
        """This rank's contribution as leg 1 represents it."""
        self._require_ef_capable()
        if self.strategy == "ar" or self.world == 1:
            return flat
        packed = self._leg1_pack(flat, seed)
        return flat if packed is None else self._img_from_packed(packed)

    # -- over lists of tensors ------------------------------------------------
    def _units(self, tensors: Sequence[torch.Tensor],
               names: Optional[Sequence[str]]):
        """``[(indices, offsets, sizes)]``: the buckets of the plan, or
        one unit per tensor without bucketing."""
        if self.bucket_bytes is None:
            return [((i,), (0,), (t.numel(),)) for i, t in enumerate(tensors)]
        names = tuple(names) if names is not None else tuple(
            str(i) for i in range(len(tensors)))
        plan = bucketing.cached_plan(
            names,
            tuple((tuple(t.shape), str(t.dtype)) for t in tensors),
            ((DATA_AXIS,),) * len(tensors),
            self.strategy, self.bucket_bytes,
        )
        return [(b.idx, b.offsets, b.sizes) for b in plan.buckets]

    def unit_sizes(self, tensors: Sequence[torch.Tensor],
                   names: Optional[Sequence[str]] = None) -> List[int]:
        """The flat fp32 length of each wire (bucket, or tensor without
        bucketing) of one call; ``seeds`` needs one pair per wire."""
        return [sum(sizes) for _, _, sizes in self._units(tensors, names)]

    def _map(self, tensors, names, seeds: Seeds, fn, n_out: int = 1):
        """Run ``fn(flat, seed)`` per unit; split each of its ``n_out``
        outputs back per tensor.  Returns one list per output."""
        tensors = list(tensors)
        units = self._units(tensors, names)
        if seeds is not None and len(seeds) < len(units):
            raise ValueError(f"{len(units)} wires need as many seed pairs, "
                             f"got {len(seeds)}")
        outs = [[None] * len(tensors) for _ in range(n_out)]
        for u, (idx, offsets, sizes) in enumerate(units):
            parts = [tensors[i].float().reshape(-1) for i in idx]
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            res = fn(flat, None if seeds is None else seeds[u])
            for out, r in zip(outs, res if n_out > 1 else (res,)):
                for i, off, sz in zip(idx, offsets, sizes):
                    t = tensors[i]
                    out[i] = r[off:off + sz].reshape(t.shape).to(t.dtype)
        return outs

    def reduce_grads(self, grads: Sequence[torch.Tensor],
                     names: Optional[Sequence[str]] = None,
                     seeds: Seeds = None) -> List[torch.Tensor]:
        """Mean-reduce gradients across the ranks (cdd mode).  ``seeds``:
        one (leg-1, leg-2) uint32 pair per wire, for the SR strategies."""
        return self._map(grads, names, seeds, self._flat_mean)[0]

    def average_params(self, params: Sequence[torch.Tensor],
                       names: Optional[Sequence[str]] = None,
                       seeds: Seeds = None) -> List[torch.Tensor]:
        """Parameter averaging after local steps (avg mode), through the
        same wire as ``reduce_grads``."""
        return self._map(params, names, seeds, self._flat_mean)[0]

    def reduce_with_residual(self, grads: Sequence[torch.Tensor],
                             names: Optional[Sequence[str]] = None,
                             seeds: Seeds = None):
        """``(reduce_grads(grads), roundtrip(grads))`` with one leg-1
        quantization per wire — what error feedback runs: the residual
        ``grads - roundtrip`` is what leg 1 dropped."""
        red, rt = self._map(grads, names, seeds, self._flat_mean_with_rt,
                            n_out=2)
        return red, rt

    def local_roundtrip(self, tensors: Sequence[torch.Tensor],
                        names: Optional[Sequence[str]] = None,
                        seeds: Seeds = None) -> List[torch.Tensor]:
        """This rank's contribution per tensor as the wire's leg 1
        represents it (no collective)."""
        return self._map(tensors, names, seeds, self._flat_roundtrip)[0]

    def __repr__(self):
        extra = (f", bucket_bytes={self.bucket_bytes}"
                 if self.bucket_bytes is not None else "")
        return f"BSP_Exchanger(strategy={self.strategy!r}{extra})"
