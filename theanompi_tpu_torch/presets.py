"""Ready-to-run presets — counterpart of ``theanompi_tpu.presets``
for the configurations the port can train so far.

``alexnet-bsp`` is BASELINE config #2 (AlexNet ImageNet-128 px, BSP
with a sync allreduce) as the reference pins it: bf16 compute, 8
ranks.  The port's training slice runs it with the hand-written
kernels (``lrn_impl='pallas'``, ``pool_grad='pallas'``); see
``run_preset``'s ``overrides``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

PRESETS: Dict[str, Dict[str, Any]] = {
    "alexnet-bsp": dict(
        rule="BSP",
        modelfile="theanompi_tpu_torch.models.alex_net",
        modelclass="AlexNet",
        model_config=dict(compute_dtype="bfloat16"),
        rule_kwargs=dict(devices=8),
    ),
}


def run_preset(name: str, overrides: Optional[dict] = None, **rule_kwargs):
    """Build the preset's rule with ``overrides`` merged into its model
    config (and ``rule_kwargs`` into its rule kwargs), run it, return
    the trained model."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    p = PRESETS[name]
    rules = importlib.import_module("theanompi_tpu_torch.parallel.rules")
    rule = getattr(rules, p["rule"])()
    cfg = dict(p["model_config"], **(overrides or {}))
    rule.init(modelfile=p["modelfile"], modelclass=p["modelclass"],
              model_config=cfg, **dict(p["rule_kwargs"], **rule_kwargs))
    return rule.wait()
