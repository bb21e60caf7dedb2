"""Time the LM training step with the bf16 flash backward on each of its
two tensor-core instances, in turns inside one process on one card.

    python3 -m theanompi_tpu_torch.utils.lm_step_ab [--reps 6] [--out FILE]

(from the root of a checkout, which must be importable).

At the LM's rows the bf16 dQ and dK/dV run the ``wgmma`` instance fed
by TMA; the ``mma.sync`` instance (the kernels that ran there before
the ``wgmma`` backward) still serves the rows TMA cannot describe, so
both are in the library.  The script builds ``TransformerLM`` once at
``kernel_ab.LM_STEP_CFG`` (the serving flagship's width, batch 8, bf16,
flash) and times ``utils.benchmark.measure_step_time`` windows of 20
steps, ``--reps`` a instance, the two in alternating order (host clock
after a device sync), then a step's device time under each from
``torch.profiler`` (all kernels, and the flash kernels alone).  The
process, the model and the batches stay the same, so only the backward
kernels differ; ``kernel_ab.py --lm-step`` compares two trees across
processes, which also differ in host placement.  Prints the card's
name and power limit and one JSON line.  Runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch

from theanompi_tpu_torch import BSP
from theanompi_tpu_torch.ops import flash as FL
from theanompi_tpu_torch.utils.benchmark import measure_step_time
from theanompi_tpu_torch.utils.kernel_ab import LM_STEP_CFG

INSTANCES = ("mma", "wgmma")
PROFILED_STEPS = 5


@contextlib.contextmanager
def backward_on(instance: str):
    """Route the bf16 backward that would run ``wgmma`` to ``instance``
    (the wrappers look ``flash_bwd_instance`` up at each launch)."""
    rule = FL.flash_bwd_instance

    def forced(dtype, d, ptrs):
        chosen = rule(dtype, d, ptrs)
        return instance if chosen == "wgmma" else chosen

    FL.flash_bwd_instance = forced
    try:
        yield
    finally:
        FL.flash_bwd_instance = rule


def device_ms(model) -> tuple:
    """(all kernels, flash kernels) device ms per step under the profiler."""
    fn = model.train_fn or model.compile_train()
    measure_step_time(model, n_steps=2, warmup=1, train_fn=fn)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        measure_step_time(model, n_steps=PROFILED_STEPS, warmup=0,
                          train_fn=fn)
    events = prof.key_averages()
    total = sum(e.device_time_total for e in events)
    flash = sum(e.device_time_total for e in events if "flash" in e.key)
    return (total / PROFILED_STEPS / 1e3, flash / PROFILED_STEPS / 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_step_ab: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.transformer",
              modelclass="TransformerLM", model_config=dict(LM_STEP_CFG),
              device=dev)
    model = rule.model
    step_ms = {name: [] for name in INSTANCES}
    for rep in range(args.reps):
        for name in (INSTANCES if rep % 2 == 0 else INSTANCES[::-1]):
            with backward_on(name):
                step_ms[name].append(
                    1e3 * measure_step_time(model, n_steps=20))
            print(f"{name}: {step_ms[name][-1]:.3f} ms/step", flush=True)
    busy = {}
    for name in INSTANCES:
        with backward_on(name):
            busy[name] = device_ms(model)
    result = dict(card=card, reps=args.reps, step_ms=step_ms, summary={
        name: dict(step_ms_median=float(np.median(step_ms[name])),
                   step_ms_min=min(step_ms[name]),
                   step_ms_max=max(step_ms[name]),
                   device_ms_per_step=busy[name][0],
                   flash_device_ms_per_step=busy[name][1])
        for name in INSTANCES})
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
