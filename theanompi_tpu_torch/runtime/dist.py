"""The data-parallel process group — the port's counterpart of
``theanompi_tpu.runtime.mesh`` (whose one ``dp`` mesh axis becomes the
ranks of a ``torch.distributed`` group).

``init_process_group`` joins (or forms) the default group and returns
the ``World`` this process trains in:

- NCCL when the device is a CUDA card, gloo on the CPU;
- under a launcher (``RANK`` and ``WORLD_SIZE`` in the environment,
  with ``MASTER_ADDR``/``MASTER_PORT``) it joins that group through
  ``env://``; a rank on the card takes device ``LOCAL_RANK`` (default:
  the rank);
- a single process with no launcher environment forms a world of 1 on
  its own, through an in-process ``HashStore`` (no port, no file).

A group that is already initialized is reused when its backend fits;
when it does not (a CPU model in a process whose default group is
NCCL), a group of the same ranks with the needed backend is made once
and kept (``World.group``; None = the default group).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from theanompi_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class World:
    rank: int
    size: int
    backend: str
    device: torch.device
    group: Optional[Any] = None  # None = the default group


_GROUPS: Dict[str, Any] = {}


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_process_group(device: DeviceLike = None) -> World:
    """Join or form the default process group; see the module docstring."""
    dev = resolve_device(device)
    backend = _backend_for(dev)
    env_rank, env_world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if dev.type == "cuda" and env_world is not None and (
            device is None or torch.device(device).index is None):
        local = int(os.environ.get("LOCAL_RANK", env_rank or 0))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = None
    if dist.is_initialized():
        if dist.get_backend() != backend:
            if backend not in _GROUPS:  # collective: every rank gets here
                _GROUPS[backend] = dist.new_group(backend=backend)
            group = _GROUPS[backend]
    elif env_rank is not None and env_world is not None:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(env_rank),
                                world_size=int(env_world))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return World(dist.get_rank(), dist.get_world_size(), backend, dev,
                 group)


def destroy_process_group() -> None:
    """Leave the default group (no-op when none is initialized)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
