"""Serving for the transformer LM (counterpart of ``theanompi_tpu.serving``).

- ``engine``    — ``ServingEngine``: bucketed prefill and single-token
  decode over a contiguous per-slot KV cache.
- ``paging``    — ``BlockPool``, ``PrefixCache`` and
  ``PagedServingEngine``: the paged KV cache, whose decode attention is
  the hand-written CUDA kernels on the card (fp32/bf16 or int8 pool).
- ``sampling``  — ``Sampler``: temperature and top-k picks with a
  counter-based Gumbel draw per (seed, id, token index).
- ``scheduler`` — ``ContinuousBatchingScheduler`` and ``Request``:
  continuous batching with greedy and sampled picks.
"""

from theanompi_tpu_torch.serving.engine import ServingEngine
from theanompi_tpu_torch.serving.paging import (
    BlockPool,
    PagedServingEngine,
    PrefixCache,
)
from theanompi_tpu_torch.serving.sampling import Sampler
from theanompi_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)

__all__ = [
    "BlockPool",
    "ContinuousBatchingScheduler",
    "PagedServingEngine",
    "PrefixCache",
    "Request",
    "Sampler",
    "ServingEngine",
]
