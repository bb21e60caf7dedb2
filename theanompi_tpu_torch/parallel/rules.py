"""Training rules — the user-facing API, counterpart of
``theanompi_tpu.parallel.rules``::

    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.alex_net",
              modelclass="AlexNet", model_config=dict(...))
    rule.wait()

``init`` joins the process group (``runtime.dist``): one process is
one rank on one device.  ``devices`` is the number of ranks; a single
process with no launcher environment is a world of 1, and a larger
world is started by a launcher that sets ``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT`` for every rank (``python -m
theanompi_tpu_torch.launch --spawn-procs N``).  ``device`` defaults to
the card; ``device="cpu"`` runs on the CPU (gloo).  The remaining
keywords go to ``BSP_Worker`` (checkpoints, resume, the watchdog,
TensorBoard).  EASGD and GOSGD are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import importlib
from typing import Any, Optional

from theanompi_tpu_torch.device import DeviceLike
from theanompi_tpu_torch.runtime.dist import init_process_group


def _world_for(devices, world) -> None:
    if devices is None:
        return
    n = devices if isinstance(devices, int) else len(list(devices))
    if n != world.size:
        raise NotImplementedError(
            f"devices={devices!r} asks for {n} ranks but this process is "
            f"in a world of {world.size}; start one process per rank: "
            f"python -m theanompi_tpu_torch.launch --devices {n} "
            f"--spawn-procs {n} ...")


class Rule:
    def __init__(self):
        self.model = None
        self.worker = None

    def _setup(self, modelfile, modelclass, model_config, device, **kw):
        raise NotImplementedError

    def init(self, devices=None,
             modelfile: str = "theanompi_tpu_torch.models.alex_net",
             modelclass: str = "AlexNet",
             model_config: Optional[dict] = None,
             device: DeviceLike = None, **worker_kwargs: Any) -> "Rule":
        world = init_process_group(device)
        _world_for(devices, world)
        self._setup(modelfile, modelclass, model_config, world.device,
                    **worker_kwargs)
        return self

    def wait(self):
        """Run training to completion on this rank."""
        if self.worker is None:
            raise RuntimeError("call rule.init(...) before rule.wait()")
        self.worker.run()
        return self.model


class BSP(Rule):
    """Bulk-synchronous data parallelism (reference ``BSP``)."""

    def _setup(self, modelfile, modelclass, model_config, device, **kw):
        from theanompi_tpu_torch.parallel.workers import BSP_Worker

        cls = getattr(importlib.import_module(modelfile), modelclass)
        self.model = cls(config=model_config, device=device)
        self.worker = BSP_Worker(self.model, **kw)
