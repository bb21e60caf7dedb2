"""AlexNet — the ImageNet benchmark model (counterpart of
``theanompi_tpu.models.alex_net.AlexNet``): single tower, LRN after
conv1 and conv2, three overlapping 3×3/2 max-pools, three dense layers
with dropout, at 128 px by default.  The layer list, widths and
``default_config`` are the reference's; the reference's ``params[i]``
is this net's ``net.{i}``."""

from __future__ import annotations

import torch
from torch import nn

from theanompi_tpu_torch import convert
from theanompi_tpu_torch.data.providers import ImageNetData
from theanompi_tpu_torch.models.base import TpuModel
from theanompi_tpu_torch.ops import layers as L
from theanompi_tpu_torch.ops import optim


class AlexNet(TpuModel):
    default_config = dict(
        batch_size=128,
        n_epochs=60,
        lr=0.01,
        momentum=0.9,
        weight_decay=5e-4,
        dropout_rate=0.5,
        lr_boundaries=(20, 40, 50),
        image_size=128,
        crop_size=None,
        mirror=True,
        n_classes=1000,
        data_dir=None,
        n_synth_batches=64,
        lrn_impl="auto",  # auto|xla|pallas (window|shift: ROADMAP A2)
        lrn_remat=False,
        lrn_stats=None,
        pool_grad="native",  # native|pallas (mask: ROADMAP A2)
        stem="conv",  # 's2d': ROADMAP A2
    )
    # checkpoints: conv weights HWIO in the reference's tree
    params_to_reference = staticmethod(convert.alexnet_params_to_jax)
    params_from_reference = staticmethod(convert.alexnet_params_from_jax)

    def build_data(self):
        cfg = self.config
        self.data = ImageNetData(
            batch_size=self.global_batch,
            data_dir=cfg.data_dir,
            image_size=int(cfg.image_size),
            n_classes=int(cfg.n_classes),
            n_synth_batches=int(cfg.n_synth_batches),
            seed=int(cfg.seed),
            crop_size=cfg.crop_size,
            mirror=bool(cfg.mirror),
            mean_subtract=bool(cfg.get("mean_subtract", True)),
        )

    def build_net(self):
        cfg = self.config
        if cfg.stem not in ("conv", "s2d"):
            raise ValueError(f"stem must be conv|s2d, got {cfg.stem!r}")
        if cfg.lrn_stats not in (None, "f32", "float32", "bf16", "bfloat16"):
            raise ValueError(
                f"lrn_stats must be None|f32|bf16, got {cfg.lrn_stats!r}")
        dt = self.compute_dtype
        drop = float(cfg.dropout_rate)
        lrn = dict(impl=str(cfg.lrn_impl), remat=bool(cfg.lrn_remat),
                   stats_dtype=(cfg.lrn_stats
                                if cfg.lrn_stats in ("bf16", "bfloat16")
                                else None))
        pg = str(cfg.pool_grad)
        size = int(cfg.crop_size or cfg.image_size)
        shape = (size, size, 3)
        layers = []

        def add(layer):
            nonlocal shape
            shape = layer.out_shape(shape)
            layers.append(layer)

        def conv(filters, kernel, stride=1, **kw):
            add(L.Conv2d(shape[-1], filters, kernel, stride=stride,
                         padding="SAME", compute_dtype=dt, **kw))

        def dense(features, **kw):
            add(L.Dense(shape[-1], features, compute_dtype=dt, **kw))

        conv(96, 11, stride=4, s2d=cfg.stem == "s2d")
        add(L.Relu())
        add(L.LRN(**lrn))
        add(L.MaxPool(3, stride=2, grad_impl=pg))
        conv(256, 5)
        add(L.Relu())
        add(L.LRN(**lrn))
        add(L.MaxPool(3, stride=2, grad_impl=pg))
        conv(384, 3)
        add(L.Relu())
        conv(384, 3)
        add(L.Relu())
        conv(256, 3)
        add(L.Relu())
        add(L.MaxPool(3, stride=2, grad_impl=pg))
        add(L.Flatten())
        dense(4096)
        add(L.Relu())
        add(L.Dropout(drop, self.generator))
        dense(4096)
        add(L.Relu())
        add(L.Dropout(drop, self.generator))
        dense(int(cfg.n_classes), output_dtype=torch.float32)
        self.lr_schedule = optim.step_decay(
            float(cfg.lr), list(cfg.lr_boundaries), 0.1)
        return nn.Sequential(*layers), (size, size, 3)
