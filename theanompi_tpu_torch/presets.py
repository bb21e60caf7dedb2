"""Ready-to-run presets — counterpart of ``theanompi_tpu.presets``
for the configurations the port can train so far::

    python -m theanompi_tpu_torch.launch --preset alexnet-bsp --devices 1

``alexnet-bsp`` is BASELINE config #2 (AlexNet ImageNet-128 px, BSP
with a sync allreduce) as the reference pins it: bf16 compute, 8
ranks.  The port's training slice runs it with the hand-written
kernels (``lrn_impl='pallas'``, ``pool_grad='pallas'`` in the config).
The reference's other presets are known by name and refused with the
ROADMAP item that ports them (``UNPORTED``).
"""

from __future__ import annotations

import copy
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

# the reference's presets that the port cannot run yet → what they wait on
UNPORTED: Dict[str, str] = {
    "wresnet-smoke": "the WResNet model (ROADMAP A8)",
    "googlenet-bsp": "the GoogLeNet model (ROADMAP A8)",
    "vgg16-bsp": "the VGG16 model (ROADMAP A8)",
    "resnet50-easgd": "the ResNet-50 model (ROADMAP A8) and the EASGD "
                      "rule (ROADMAP A10)",
    "lsgan-gosgd": "the LS-GAN model and the GOSGD rule (ROADMAP A10)",
}


def get_preset(name: str) -> Dict[str, Any]:
    """A copy of the preset's (rule, modelfile, modelclass,
    model_config, rule_kwargs)."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet: it needs {UNPORTED[name]}")
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return copy.deepcopy(PRESETS[name])


def run_preset(name: str, overrides: Optional[dict] = None, **rule_kwargs):
    """Build the preset's rule with ``overrides`` merged into its model
    config (and ``rule_kwargs`` into its rule kwargs), run it, return
    the trained model."""
    p = get_preset(name)
    rules = importlib.import_module("theanompi_tpu_torch.parallel.rules")
    rule = getattr(rules, p["rule"])()
    cfg = dict(p["model_config"], **(overrides or {}))
    rule.init(modelfile=p["modelfile"], modelclass=p["modelclass"],
              model_config=cfg, **dict(p["rule_kwargs"], **rule_kwargs))
    return rule.wait()
