"""Decoder-only transformer LM — counterpart of
``theanompi_tpu.models.transformer.TransformerLM`` for the dense,
single-device stack.

As in the reference, ``TransformerLM`` is a ``TpuModel``: ``BSP``
trains it like any model::

    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=2, modelfile="theanompi_tpu_torch.models.transformer",
              modelclass="TransformerLM", model_config=dict(attn_impl="flash"))
    rule.wait()

(one process per rank, each started with ``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT``; two ranks on one card also set
``LOCAL_RANK=0`` and ``LOCAL_WORLD_SIZE=2`` and run gloo), with the
reference's default wire, ``int8_sr``: the block-quantized exchange
with stochastic rounding (``parallel.exchanger``),
and the serving engines take the same object.  Its ``net`` is the
reference's layer list one for one::

    [Embedding, PositionalEmbedding, TransformerBlock × n_layers,
     LayerNorm, Dense(vocab, output fp32)]

so ``state_dict`` key ``net.{i}.…`` holds the reference's ``params[i]``
(see ``convert.params_from_jax``).  ``forward`` (and calling the model)
is the no-cache, full-recompute pass: the correctness oracle every
KV-cache path is held to.  The loss is the per-token softmax
cross-entropy over ``(B·T, V)``, with top-1 and top-5 error over the
vocabulary.

Not ported yet, and raising: sequence, tensor and pipeline parallelism
and MoE blocks (``sp``/``tp``/``pp``/``moe_experts``, ``ValueError``,
ROADMAP A13) and ``remat`` (``NotImplementedError``, ROADMAP A12).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from theanompi_tpu_torch.data.providers import LMTextData
from theanompi_tpu_torch.device import DeviceLike
from theanompi_tpu_torch.models.base import TpuModel
from theanompi_tpu_torch.ops import attention as A
from theanompi_tpu_torch.ops import losses, optim
from theanompi_tpu_torch.ops.layers import Dense

# reference config keys whose non-trivial values select paths this
# port does not have yet; their trivial values are accepted
_UNSUPPORTED = dict(moe_experts=0, sp=1, tp=1, pp=1)


def _check_config(cfg: dict) -> None:
    for key, trivial in _UNSUPPORTED.items():
        value = cfg.get(key, trivial)
        if int(value or 0) not in (0, trivial):
            raise ValueError(
                f"{key}={value}: the port runs the dense, single-device "
                f"stack only ({key}={trivial}; ROADMAP A13)")
    if cfg.get("remat"):
        raise NotImplementedError(
            "remat (gradient checkpointing per block) is not ported yet: "
            "ROADMAP A12")


class TransformerLM(TpuModel):
    """``config`` keys (besides the common ones of ``models.base``):
    d_model, n_heads, n_layers, vocab_size, seq_len, mlp_ratio,
    attn_impl ('xla' | 'flash'), compute_dtype (None = fp32, or e.g.
    ``'bfloat16'``).  ``seed`` draws the weights from
    ``torch.Generator().manual_seed(seed)``.  ``device`` defaults to the
    card and raises without one."""

    default_config = dict(
        batch_size=8,  # per data-parallel rank
        seq_len=512,
        vocab_size=256,
        d_model=256,
        n_heads=8,
        n_layers=4,
        mlp_ratio=4,
        attn_impl="xla",  # 'xla' (plain) | 'flash' (the flash kernels)
        lr=0.1,
        momentum=0.9,
        weight_decay=0.0,
        n_epochs=5,
        lr_boundaries=(3,),
        data_dir=None,
        n_synth_train=32,
        n_synth_val=2,
        val_top5=True,
        exch_strategy="int8_sr",  # the reference's default
    )

    def __init__(self, config: Optional[dict] = None,
                 device: DeviceLike = None, **overrides):
        # refused before a process group is made
        _check_config({**(config or {}), **overrides})
        super().__init__(config, device=device, **overrides)

    def build_data(self) -> None:
        cfg = self.config
        self.data = LMTextData(
            batch_size=self.global_batch,
            seq_len=int(cfg.seq_len),
            vocab_size=int(cfg.vocab_size),
            data_dir=cfg.data_dir,
            n_synth_train=int(cfg.n_synth_train),
            n_synth_val=int(cfg.n_synth_val),
            seed=int(cfg.seed),
        )

    def build_net(self):
        cfg = self.config
        dt = self.compute_dtype
        d, vocab = int(cfg.d_model), int(cfg.vocab_size)
        self.n_layers = int(cfg.n_layers)
        net = nn.Sequential(
            A.Embedding(vocab, d, compute_dtype=dt),
            A.PositionalEmbedding(int(cfg.seq_len), d),
            *[
                A.TransformerBlock(
                    d, int(cfg.n_heads), mlp_ratio=int(cfg.mlp_ratio),
                    compute_dtype=dt, attn_impl=str(cfg.attn_impl),
                )
                for _ in range(self.n_layers)
            ],
            A.LayerNorm(d),
            Dense(d, vocab, compute_dtype=dt, output_dtype=torch.float32),
        )
        self.lr_schedule = optim.step_decay(
            float(cfg.lr), list(cfg.lr_boundaries), 0.1)
        return net, (int(cfg.seq_len),)

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

    def parameters(self):
        return self.net.parameters()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full recompute: tokens ``(B, T)`` → fp32 logits ``(B, T, V)``."""
        return self.net(tokens)

    __call__ = forward

    def loss_and_metrics(self, x, y, train: bool):
        """Tokens ``(B, T)`` int → per-token loss and (top-1, top-5)
        error over the flattened ``(B·T, V)`` logits."""
        self.net.train(train)
        logits = self.net(x)
        flat = logits.reshape(-1, logits.shape[-1])
        flat_y = y.reshape(-1)
        loss = losses.softmax_cross_entropy(flat, flat_y)
        return loss, self._metrics(flat.detach(), flat_y)
