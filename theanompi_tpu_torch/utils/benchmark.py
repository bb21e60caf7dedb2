"""Step timing and throughput — counterpart of
``theanompi_tpu.utils.benchmark`` (``measure_step_time``,
``images_per_sec``).

The step is timed on a few pre-loaded batches, so data loading is not
in the number; on the card the window ends in
``torch.cuda.synchronize``, so it measures the device, not the enqueue.
The model's parameters, velocity, error-feedback residual, step
counter, dropout stream and wire seed stream are restored afterwards:
a probe does not move the training state.
The comm-fraction probe and scaling efficiency are not ported yet
(ROADMAP A7).
"""

from __future__ import annotations

import itertools
import time

import torch

from theanompi_tpu_torch.data.loader import rank_rows, to_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_step_time(model, n_steps: int = 20, warmup: int = 3,
                      train_fn=None, max_batches: int = 8) -> float:
    """Steady-state seconds per training step (warm-up excluded)."""
    fn = train_fn or model.train_fn or model.compile_train()
    dev = model.device
    batches = [
        to_device(rank_rows(b, model.rank, model.n_workers), dev)
        for b in itertools.islice(model.data.train_batches(), max_batches)
    ]
    with torch.no_grad():
        saved_p = [p.detach().clone() for p in model.params]
        saved_v = [v.clone() for v in model.opt_state["velocity"]]
        saved_ef = [e.clone() for e in model.opt_state.get("ef_wire", ())]
    saved_step = model.opt_state["step"]
    saved_gen = model.generator.get_state()
    saved_wire = model.wire_generator.get_state()
    try:
        for i in range(warmup):
            fn(*batches[i % len(batches)])
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(n_steps):
            fn(*batches[i % len(batches)])
        _sync(dev)
        return (time.perf_counter() - t0) / n_steps
    finally:
        with torch.no_grad():
            for p, s in zip(model.params, saved_p):
                p.copy_(s)
            for v, s in zip(model.opt_state["velocity"], saved_v):
                v.copy_(s)
            for e, s in zip(model.opt_state.get("ef_wire", ()), saved_ef):
                e.copy_(s)
        model.opt_state["step"] = saved_step
        model.generator.set_state(saved_gen)
        model.wire_generator.set_state(saved_wire)


def images_per_sec(model, n_steps: int = 20) -> float:
    """Global images per second of the training step."""
    return model.global_batch / measure_step_time(model, n_steps=n_steps)
