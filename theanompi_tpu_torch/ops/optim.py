"""SGD and learning-rate schedules (counterpart of
``theanompi_tpu.ops.optim``).

An optimizer is an ``init``/``update`` pair over a list of parameters.
The state is a dict: ``velocity`` (one fp32 tensor per parameter),
``lr`` (a Python float the host sets between steps, as the reference
keeps lr in its state so that ``adjust_hyperp`` needs no recompile) and
``step``.  ``update`` changes parameters and velocity in place (the
reference returns new pytrees; in place saves a copy of every
parameter per step).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with optional (Nesterov) momentum; weight decay is classic L2
    applied as ``g += wd · p``, as the reference's update builders did."""

    def init(params: List[torch.Tensor]) -> dict:
        return {
            "velocity": [torch.zeros_like(p, dtype=torch.float32)
                         for p in params],
            "lr": float(lr),
            "step": 0,
        }

    @torch.no_grad()
    def update(params: List[torch.Tensor], grads: List[torch.Tensor],
               state: dict) -> dict:
        lr_t = state["lr"]
        for p, g, v in zip(params, grads, state["velocity"]):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p
            if momentum:
                v.copy_(momentum * v - lr_t * g)
                step = momentum * v - lr_t * g if nesterov else v
            else:
                step = -lr_t * g
            p.add_(step)
        state["step"] += 1
        return state

    return Optimizer(init, update)


def from_config(cfg) -> Optimizer:
    """The optimizer a model config names (``optimizer``, default
    'sgd').  adam/adamw/lars/lamb are not ported yet (ROADMAP A3)."""
    name = str(cfg.get("optimizer", "sgd")).lower()
    if name == "sgd":
        return sgd(lr=float(cfg.lr), momentum=float(cfg.momentum),
                   nesterov=bool(cfg.nesterov),
                   weight_decay=float(cfg.weight_decay))
    if name in ("adam", "adamw", "lars", "lamb"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: ROADMAP A3")
    raise ValueError(f"unknown optimizer {name!r} (sgd|adam|adamw|lars|lamb)")


def set_lr(state: dict, lr: float) -> dict:
    """Host-side lr change between steps (reference: shared-var set)."""
    state["lr"] = float(lr)
    return state


def get_lr(state: dict) -> float:
    return float(state["lr"])


# learning-rate schedules: host functions epoch -> lr, driven by
# model.adjust_hyperp(epoch)

def step_decay(base_lr: float, boundaries, factor: float = 0.1):
    """lr = base · factor^(number of boundaries passed)."""
    boundaries = sorted(boundaries)

    def schedule(epoch: int) -> float:
        return base_lr * factor ** sum(1 for b in boundaries if epoch >= b)

    return schedule


def exp_decay(base_lr: float, rate: float):
    def schedule(epoch: int) -> float:
        return base_lr * rate ** epoch

    return schedule


def constant(base_lr: float):
    def schedule(epoch: int) -> float:
        return base_lr

    return schedule


def linear_warmup_step(base_lr: float, warmup_epochs: int, boundaries,
                       factor: float = 0.1):
    """Warmup then step decay."""
    step = step_decay(base_lr, boundaries, factor)

    def schedule(epoch: int) -> float:
        if warmup_epochs and epoch < warmup_epochs:
            return base_lr * float(epoch + 1) / warmup_epochs
        return step(epoch)

    return schedule
