"""BSP gradient exchange over a ``torch.distributed`` group —
counterpart of ``theanompi_tpu.parallel.exchanger.BSP_Exchanger``.

``reduce_grads`` (cdd) and ``average_params`` (avg) take the mean of a
list of tensors over the group's ranks.  With ``bucket_bytes`` set the
tensors are fused into flat fp32 buckets (``parallel.bucketing``), one
``all_reduce`` per bucket; without it, one ``all_reduce`` per tensor.
Wire strategies:

- ``ar``   — fp32 sum, divided by the world size;
- ``bf16`` / ``fp16`` — the payload is cast to the wire dtype, summed
  in it, widened to fp32 and divided (the reference's cast wire).

The block-quantized strategies (``fp16s``, ``int8``, ``int8_sr`` and
their ``pallas_*`` kernels) come with the block-quantize kernels
(ROADMAP B3) and raise here.  The reduction runs on the current stream
and returns without a host sync.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from theanompi_tpu_torch.parallel import bucketing

STRATEGIES = ("ar", "bf16", "fp16", "fp16s", "pallas_fp16s", "int8",
              "pallas_int8", "int8_sr", "pallas_int8_sr")
_WIRE = {"ar": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
DATA_AXIS = "dp"


class BSP_Exchanger:
    """Mean over the ranks of ``group`` (default: the default group)."""

    def __init__(self, strategy: str = "ar", group=None,
                 bucket_bytes: Optional[int] = None):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r}; pick from {STRATEGIES}")
        if strategy not in _WIRE:
            raise NotImplementedError(
                f"exchange strategy {strategy!r} (block-quantized wire) is "
                "not ported yet: ROADMAP B3")
        self.strategy = strategy
        self.group = group
        self.bucket_bytes = int(bucket_bytes) if bucket_bytes else None

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    def _mean_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """fp32 flat payload → its mean over the ranks, fp32."""
        wire = flat.to(_WIRE[self.strategy])
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        return wire.float() / self.world

    def _tree_mean(self, tensors: Sequence[torch.Tensor],
                   names: Optional[Sequence[str]] = None
                   ) -> List[torch.Tensor]:
        tensors = list(tensors)
        if self.bucket_bytes is None:
            return [self._mean_flat(t.float().reshape(-1))
                    .reshape(t.shape).to(t.dtype) for t in tensors]
        names = tuple(names) if names is not None else tuple(
            str(i) for i in range(len(tensors)))
        plan = bucketing.cached_plan(
            names,
            tuple((tuple(t.shape), str(t.dtype)) for t in tensors),
            ((DATA_AXIS,),) * len(tensors),
            self.strategy, self.bucket_bytes,
        )
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for b in plan.buckets:
            parts = [tensors[i].float().reshape(-1) for i in b.idx]
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            red = self._mean_flat(flat)
            for i, off, sz in zip(b.idx, b.offsets, b.sizes):
                t = tensors[i]
                out[i] = red[off:off + sz].reshape(t.shape).to(t.dtype)
        return out

    def reduce_grads(self, grads: Sequence[torch.Tensor],
                     names: Optional[Sequence[str]] = None
                     ) -> List[torch.Tensor]:
        """Mean-reduce gradients across the ranks (cdd mode)."""
        return self._tree_mean(grads, names)

    def average_params(self, params: Sequence[torch.Tensor],
                       names: Optional[Sequence[str]] = None
                       ) -> List[torch.Tensor]:
        """Parameter averaging after local steps (avg mode), through the
        same wire as ``reduce_grads``."""
        return self._tree_mean(params, names)

    def __repr__(self):
        extra = (f", bucket_bytes={self.bucket_bytes}"
                 if self.bucket_bytes is not None else "")
        return f"BSP_Exchanger(strategy={self.strategy!r}{extra})"
