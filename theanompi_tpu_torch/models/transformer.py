"""Decoder-only transformer LM — counterpart of
``theanompi_tpu.models.transformer.TransformerLM`` for the dense stack.

The layer list is the reference's ``Sequential`` one for one::

    [Embedding, PositionalEmbedding, TransformerBlock × n_layers,
     LayerNorm, Dense(vocab, output fp32)]

so ``state_dict`` key ``net.{i}.…`` holds the reference's ``params[i]``
(see ``convert.params_from_jax``).  ``forward`` is the no-cache,
full-recompute pass: the correctness oracle every KV-cache path is held
to (greedy decode through a cache must pick the same tokens).

Sequence, tensor and pipeline parallelism and MoE blocks are not part
of this port yet; a config asking for them raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from theanompi_tpu_torch.device import DeviceLike, resolve_device, resolve_dtype
from theanompi_tpu_torch.ops import attention as A
from theanompi_tpu_torch.ops.layers import Dense

DEFAULT_CONFIG = dict(
    seq_len=512,
    vocab_size=256,
    d_model=256,
    n_heads=8,
    n_layers=4,
    mlp_ratio=4,
    compute_dtype=None,
)

# reference config keys whose non-trivial values select paths this
# port does not have yet; their trivial values are accepted
_UNSUPPORTED = dict(moe_experts=0, sp=1, tp=1, pp=1)


def _check_config(cfg: Dict) -> Dict:
    out = dict(DEFAULT_CONFIG)
    for key, value in cfg.items():
        if key in _UNSUPPORTED:
            if int(value or 0) not in (0, _UNSUPPORTED[key]):
                raise ValueError(
                    f"{key}={value}: the port serves the dense, single-"
                    f"device stack only ({key}={_UNSUPPORTED[key]})"
                )
            continue
        if key not in DEFAULT_CONFIG:
            raise ValueError(
                f"unknown TransformerLM config key {key!r}; known: "
                f"{sorted(DEFAULT_CONFIG)}"
            )
        out[key] = value
    return out


class TransformerLM(nn.Module):
    """``config`` keys: d_model, n_heads, n_layers, vocab_size, seq_len,
    mlp_ratio, compute_dtype (None = fp32, or e.g. ``'bfloat16'``).
    Weights are drawn from ``torch.Generator().manual_seed(seed)``.
    ``device`` defaults to the card and raises without one."""

    def __init__(self, config: Optional[Dict] = None, *, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cfg = _check_config(dict(config or {}))
        self.config = cfg
        self.compute_dtype = resolve_dtype(cfg["compute_dtype"])
        d = int(cfg["d_model"])
        vocab = int(cfg["vocab_size"])
        self.n_layers = int(cfg["n_layers"])
        dev, dt = resolve_device(device), self.compute_dtype
        self.net = nn.Sequential(
            A.Embedding(vocab, d, compute_dtype=dt, device=dev),
            A.PositionalEmbedding(int(cfg["seq_len"]), d, device=dev),
            *[
                A.TransformerBlock(
                    d, int(cfg["n_heads"]), mlp_ratio=int(cfg["mlp_ratio"]),
                    compute_dtype=dt, device=dev,
                )
                for _ in range(self.n_layers)
            ],
            A.LayerNorm(d, device=dev),
            Dense(d, vocab, compute_dtype=dt, output_dtype=torch.float32,
                  device=dev),
        )
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    # the reference's Sequential split (serving/engine.py ``_weights``)
    @property
    def embedding(self) -> A.Embedding:
        return self.net[0]

    @property
    def positions(self) -> A.PositionalEmbedding:
        return self.net[1]

    @property
    def blocks(self):
        return self.net[2:2 + self.n_layers]

    @property
    def final_norm(self) -> A.LayerNorm:
        return self.net[2 + self.n_layers]

    @property
    def head(self) -> Dense:
        return self.net[3 + self.n_layers]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full recompute: tokens ``(B, T)`` → fp32 logits ``(B, T, V)``."""
        return self.net(tokens)
