"""Model-contract base class — counterpart of
``theanompi_tpu.models.base.TpuModel`` (same class name, so the two
are easy to find side by side).

The contract the workers consume: ``__init__(config)``,
``build_model()``, ``compile_train()``, ``compile_val()``,
``train_iter(count, recorder)``, ``val_iter``/``run_validation``,
``adjust_hyperp(epoch)``, ``scale_lr(factor)``, ``cleanup()``, and the
attributes ``params``, ``data``, ``batch_size``, ``global_batch``,
``n_epochs``.

What the port does in place of the reference's one jitted, shard-mapped
XLA step: each process is one rank of a ``torch.distributed`` group
(``runtime.dist``) holding a full replica of the model on its device;
``compile_train`` builds the step as a Python function that runs
forward and backward eagerly, reduces the gradients through
``BSP_Exchanger`` (one ``all_reduce`` per bucket) and applies the
optimizer in place.  ``batch_size`` is per rank and the providers
deliver global batches (``batch_size × world``); rank r trains on
rows ``[r·b, (r+1)·b)``, the reference's ``dp`` sharding order.

Ported: ``sync_mode`` 'cdd' and 'avg', ``exchange_overlap`` 'bucket'
and 'leaf', strategies ``ar``/``bf16``/``fp16``, ``grad_accum=1``.
Not yet (each raises with its ROADMAP item): ZeRO-1, error feedback,
in-DAG issue, the two-level wire (A9), gradient accumulation and
clipping (A4), on-device augmentation (A3), the block wires (B3),
checkpoints (A6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from theanompi_tpu_torch.data.loader import prefetch_to_device
from theanompi_tpu_torch.device import DeviceLike, resolve_dtype
from theanompi_tpu_torch.ops import losses
from theanompi_tpu_torch.ops import optim as optim_lib
from theanompi_tpu_torch.ops.layers import count_params
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.runtime.config import Config
from theanompi_tpu_torch.runtime.dist import init_process_group

COMMON_DEFAULTS = dict(
    seed=0,
    batch_size=128,  # per data-parallel rank
    n_epochs=10,
    lr=0.01,
    momentum=0.9,
    nesterov=False,
    weight_decay=1e-4,
    sync_mode="cdd",  # 'cdd' = gradient reduce; 'avg' = param averaging
    exch_strategy="ar",  # 'ar' | 'bf16' | 'fp16' (block wires: B3)
    prefetch_depth=2,
    grad_clip_norm=None,
    print_freq=40,
    val_top5=True,
    compute_dtype=None,  # e.g. 'bfloat16'
    device_aug=False,
    comm_probe=True,  # accepted; the comm-fraction probe is not ported
    sync_each_iter=False,  # True = read the step's loss every step
    zero1=False,
    grad_accum=1,
    exchange_overlap="bucket",  # 'leaf' | 'bucket' ('indag': A9)
    exchange_bucket_mb=4.0,
    dcn_shape=None,
)


def _refuse_unported(cfg, n_workers: int) -> None:
    checks = {
        "zero1 (ROADMAP A9)": bool(cfg.zero1) and n_workers > 1,
        "error_feedback (ROADMAP A9, B3)": bool(
            cfg.get("error_feedback", False)),
        "exchange_overlap='indag' (ROADMAP A9)":
            cfg.exchange_overlap == "indag",
        "dcn_shape (ROADMAP A9)": bool(cfg.dcn_shape),
        "grad_accum > 1 (ROADMAP A4)": int(cfg.grad_accum or 1) > 1,
        "grad_clip_norm (ROADMAP A4)": cfg.grad_clip_norm is not None,
        "device_aug (ROADMAP A3)": bool(cfg.device_aug),
    }
    bad = [k for k, v in checks.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)}")
    if cfg.exchange_overlap not in ("leaf", "bucket", "indag"):
        raise ValueError(f"exchange_overlap must be leaf|bucket|indag, got "
                         f"{cfg.exchange_overlap!r}")
    if cfg.sync_mode not in ("cdd", "avg"):
        raise ValueError(
            f"sync_mode must be 'cdd' or 'avg', got {cfg.sync_mode!r}")


class TpuModel:
    default_config: dict = {}

    def __init__(self, config: Optional[dict] = None,
                 device: DeviceLike = None, **overrides):
        self.config = Config(COMMON_DEFAULTS)
        self.config.update(self.default_config)
        if config:
            self.config.update(dict(config))
        self.config.update(overrides)
        cfg = self.config
        self.world = init_process_group(device)
        self.device = self.world.device
        self.rank = self.world.rank
        self.n_workers = self.world.size
        _refuse_unported(cfg, self.n_workers)
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.batch_size = int(cfg.batch_size)
        self.global_batch = self.batch_size * self.n_workers
        self.n_epochs = int(cfg.n_epochs)
        # dropout masks: one stream per rank (the reference folds the
        # rank into its step key)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg.seed) * 1_000_003 + self.rank)
        self.data = None
        self.net: Optional[nn.Module] = None
        self.input_shape: Optional[Tuple[int, ...]] = None
        self.lr_schedule = optim_lib.constant(float(cfg.lr))
        self._lr_scale = 1.0
        self.build_data()
        self.build_model()
        self.train_fn = None
        self.val_fn = None
        self.exchanger = None
        self._train_it = None
        self._val_it = None
        self.current_epoch = 0

    # ---- subclass hooks ---------------------------------------------------
    def build_data(self) -> None:
        raise NotImplementedError

    def build_net(self) -> Tuple[nn.Module, Tuple[int, ...]]:
        raise NotImplementedError

    # ---- contract: build_model ------------------------------------------
    def build_model(self) -> None:
        cfg = self.config
        self.net, self.input_shape = self.build_net()
        self.net.to(self.device)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        for m in self.net.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        self.param_names = [n for n, _ in self.net.named_parameters()]
        self.params = [p for _, p in self.net.named_parameters()]
        self.optimizer = optim_lib.from_config(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.n_params = count_params(self.net)

    def state_dict(self) -> dict:
        """Parameters as ``net.{i}.{w,b}`` (the reference's
        ``params[i]``; see ``convert``)."""
        return {f"net.{k}": v for k, v in self.net.state_dict().items()}

    def load_state_dict(self, state: dict) -> None:
        """Load ``net.{i}.…`` parameters (e.g. from ``convert``), copied
        to the model's device; the optimizer state is left as it is."""
        bad = [k for k in state if not k.startswith("net.")]
        if bad:
            raise KeyError(f"expected keys 'net.…', got {bad[:3]}")
        self.net.load_state_dict({k[4:]: v for k, v in state.items()})

    # ---- loss -----------------------------------------------------------
    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if self.compute_dtype else x

    def _metrics(self, logits, y):
        err = losses.classification_error(logits, y)
        if self.config.val_top5 and logits.shape[-1] > 5:
            return err, losses.topk_error(logits, y, k=5)
        return err, err

    def loss_and_metrics(self, x, y, train: bool):
        self.net.train(train)
        logits = self.net(self._cast_input(x))
        loss = losses.softmax_cross_entropy(logits, y)
        err, err5 = self._metrics(logits.detach(), y)
        return loss, (err, err5)

    def _mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        if self.n_workers > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.world.group)
            t = t / self.n_workers
        return t

    # ---- contract: compile_train / compile_val --------------------------
    def compile_train(self):
        """Build the training step ``train_fn(x, y) -> (loss, err)``:
        forward + backward, the exchange, the optimizer update (in
        place).  Loss and error are the means over the ranks, as device
        scalars (no host sync)."""
        cfg = self.config
        bucket_bytes = (None if cfg.exchange_overlap == "leaf" else
                        int(float(cfg.exchange_bucket_mb) * (1 << 20)))
        exchanger = BSP_Exchanger(
            strategy=cfg.exch_strategy, group=self.world.group,
            bucket_bytes=bucket_bytes)
        params, names = self.params, self.param_names
        opt, avg = self.optimizer, cfg.sync_mode == "avg"

        def train_fn(x, y):
            loss, (err, _) = self.loss_and_metrics(x, y, True)
            grads = torch.autograd.grad(loss, params)
            if not avg:
                grads = exchanger.reduce_grads(grads, names)
                opt.update(params, grads, self.opt_state)
            else:
                opt.update(params, grads, self.opt_state)
                with torch.no_grad():
                    for p, a in zip(params,
                                    exchanger.average_params(params, names)):
                        p.copy_(a)
                    vel = self.opt_state["velocity"]
                    for v, a in zip(vel, exchanger.average_params(vel, names)):
                        v.copy_(a)
            m = self._mean_over_ranks(torch.stack([loss.detach(), err]))
            return m[0], m[1]

        self.train_fn = train_fn
        self.exchanger = exchanger
        return train_fn

    def compile_val(self):
        def val_fn(x, y):
            with torch.no_grad():
                loss, (err, err5) = self.loss_and_metrics(x, y, False)
                m = self._mean_over_ranks(torch.stack([loss, err, err5]))
            return m[0], m[1], m[2]

        self.val_fn = val_fn
        return val_fn

    # ---- contract: train_iter / val_iter --------------------------------
    def _loader(self, batches, depth: int):
        return prefetch_to_device(batches, self.device, self.rank,
                                  self.n_workers, depth=depth)

    def reset_train_iter(self, epoch: int) -> None:
        self.data.shuffle(epoch)
        self._train_it = self._loader(self.data.train_batches(),
                                      int(self.config.prefetch_depth))

    def reset_val_iter(self) -> None:
        self._val_it = self._loader(self.data.val_batches(), 1)

    def train_iter(self, count: int, recorder):
        if self.train_fn is None:
            self.compile_train()
        if self._train_it is None:
            self.reset_train_iter(self.current_epoch)
        recorder.start("wait")
        x, y = next(self._train_it)
        recorder.end("wait")
        recorder.start("calc")
        loss, err = self.train_fn(x, y)
        if self.config.sync_each_iter:
            loss, err = float(loss), float(err)
        recorder.end("calc")
        recorder.train_error(count, loss, err)
        return loss, err

    def val_iter(self, count: int, recorder):
        if self.val_fn is None:
            self.compile_val()
        x, y = next(self._val_it)
        return self.val_fn(x, y)

    def run_validation(self, count: int, recorder):
        """Full-set validation; one host read at the end."""
        if not self.data.n_batch_val:
            return float("nan"), float("nan"), float("nan")
        if self.val_fn is None:
            self.compile_val()
        self.reset_val_iter()
        tot = torch.zeros(3, device=self.device)
        for _ in range(self.data.n_batch_val):
            tot += torch.stack(self.val_iter(count, recorder))
        loss, err, err5 = (tot / self.data.n_batch_val).tolist()
        recorder.val_error(count, loss, err, err5)
        recorder.print_val_info(count)
        return loss, err, err5

    # ---- contract: hyperparameter scheduling ----------------------------
    def adjust_hyperp(self, epoch: int) -> None:
        """Per-epoch lr schedule (reference: shared-var lr set)."""
        self.current_epoch = epoch
        optim_lib.set_lr(self.opt_state,
                         self.lr_schedule(epoch) * self._lr_scale)

    def scale_lr(self, factor: float) -> None:
        """Linear lr scaling for N workers (reference: ``scale_lr``)."""
        self._lr_scale = float(factor)
        optim_lib.set_lr(
            self.opt_state,
            self.lr_schedule(self.current_epoch) * self._lr_scale)

    def describe(self) -> str:
        cfg = self.config
        eff_lr = self.lr_schedule(self.current_epoch) * self._lr_scale
        lines = [
            f"{type(self).__name__}: {self.n_params:,} params, "
            f"{self.world.backend} world of {self.n_workers} on "
            f"{self.device}, global_batch={self.global_batch} "
            f"({self.batch_size}/rank x {self.n_workers})",
            f"  optimizer={cfg.get('optimizer', 'sgd')} lr={eff_lr:g} "
            f"exch={cfg.exch_strategy} sync={cfg.sync_mode}",
        ]
        if cfg.compute_dtype:
            lines.append(f"  compute_dtype={cfg.compute_dtype}")
        return "\n".join(lines)

    def cleanup(self) -> None:
        self._train_it = None
        self._val_it = None
