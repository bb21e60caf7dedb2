"""Time two trees' flash, max-pool backward, LRN, paged decode and
block-wire kernels, and their serving decode tick, on one card.

    python3 theanompi_tpu_torch/utils/kernel_ab.py OLD_TREE NEW_TREE \
        [--order old,new,new,old] \
        [--kernels flash,pool,lrn,paged,serve,wire] \
        [--lm-step] [--alexnet-step] [--out FILE]

Each tree is a checkout of the repository (``OLD_TREE`` typically a
``git archive`` of the parent commit in an ignored directory).  For
each entry of ``--order`` the script starts itself as a child process
with ``PYTHONPATH`` set to that tree, so the child imports and builds
that tree's ``theanompi_tpu_torch`` and its kernels from that tree's
``csrc/``.  The child times, on the card, with a cold L2 (a 256 MiB
memset before each call, twice, so that the device is still busy when
the host has enqueued the call) and as the median of 30 calls:

- ``flash_fwd`` on bf16 rows at the LM path's shape (B·H 64, T 1024,
  D 64, causal), and ``F.scaled_dot_product_attention`` on the same
  inputs (the one-call yardstick);
- ``flash_dq`` and ``flash_dkv`` on the same rows, with dO from the
  seed and lse from that tree's ``flash_fwd``, and aten's
  ``_scaled_dot_product_flash_attention_backward`` alone, fed what
  aten's flash forward returns (dQ, dK and dV in one call);
- ``maxpool_bwd`` (bf16, 3×3/2) at AlexNet-128's three pool inputs at
  batch 128, and aten's ``max_pool2d_with_indices_backward``;
- ``lrn_fwd`` and ``lrn_bwd`` (bf16, size 5, α 1e-4, β 0.75, k 1) at
  AlexNet-128's two LRN inputs at batch 128, each summed over the two
  (one launch of each a step); beside them two calls that move the
  same bytes and compute nothing, ``copy_`` (x in, y out: the
  forward's bytes) and ``torch.add(x, dy, out=dx)`` (the backward's);
  and all four again after a flush that reads 256 MiB instead of
  writing it (``_clean``: L2 then holds no dirty lines whose write-back
  the call would pay);
- ``paged_decode_attention`` on fp32 and int8 pools (the serving
  engine's two decode kernels; int8 rows quantized by
  ``quantize_rows``) at two shapes of the serving flagship (32 lanes, 8
  heads, head_dim 64, block 32, 32-entry tables): ``kernel``, lengths
  0..1023 drawn from a seed with the boundary cases of
  ``chip_smoke.py``'s kernel phase, and ``serve``, 8 live lanes at the
  serve prompts' lengths plus 16 and 24 lanes at length 0 with all-zero
  tables; pools of 257 fp32 or 967 int8 blocks; beside each, the host
  microseconds a call takes to return (its launch enqueued; the median
  of five windows of 50 calls);
- ``serve``: the decode tick of the serving flagship (``SERVE_CFG``
  behind ``PagedServingEngine`` at ``SERVE_ENGINE``, seeded weights)
  serving the 8 greedy ``serve_requests()``, on the fp32 pool and on
  the int8 pool of ``I8_BLOCKS`` blocks: ``ServeClock``'s median over
  the requests of (last token − first token) / (tokens − 1), host
  clock, for each of SERVE_ROUNDS runs of the 8 requests (after one
  warm-up request), and their median; beside it the host time of a
  tick's ``decode_step_paged`` call (``_step_host_ms``: the enqueue of
  the tick's work, without the wait for its logits and the picks),
  the median over the runs of its mean a tick; then the ticks again
  after one fp32 run under ``torch.profiler`` with CUDA activity
  (``_after_profile``: what a profile leaves behind for the runs after
  it);
- ``wire``: the ``int8_sr``, ``int8`` and ``fp16s`` block wires
  (``WIRE_CHAINS``) of one 4 MB bucket at a world of 2 (``WIRE_ROWS``
  rows of 256 fp32 in leg 1), without the collectives (at a world of 2
  the gathered shards have the shape of the leg-1 payload, which stands
  in for them), each wire ``S`` in turn: the leg-1 quantize
  (``wire_S_quant_ms``); leg 2 (``wire_S_leg2_ms``), one fused call
  (``dequant_sum_quantize_int8_sr``, ``_int8``, ``_fp16``) where the
  tree has it, else its three public calls ``quant(dequantize(q_t,
  s_t).sum(dim=0))``; the last dequantize with the mean's divide
  (``wire_S_final_ms``), ``dequantize(q_all, s_all, 2, n)`` where the
  tree takes a divisor, else ``dequantize(q_all, s_all).view(-1)[:n] /
  2``; the three in a row (``wire_S_chain_ms``); beside each a
  ``copy_`` that moves the bytes the call must move
  (``wire_S_*_copy_ms``), and all of them again after the reading
  flush (``*_clean_ms``: L2 then holds no dirty lines, so the floor
  that a write-back puts under a call of a few MB is gone).  Last in
  the child, after every timed call, each wire's chain over every live
  bucket of the LM's step (``LM_STEP_CFG``'s parameters, 4 MB buckets;
  ``int8`` with its error-feedback image dequantize) under
  ``torch.profiler``, five times: the device time of its kernels a
  step (``wire_S_step_device_ms``), by kernel, and their count;
- with ``--lm-step``, the end-to-end training step of ``TransformerLM``
  at the serving flagship's width (d_model 512, 8 heads, 8 layers,
  vocab 4096, seq_len 1024), batch 8, bf16, flash, through
  ``BSP().init`` on a world of 1: ``utils.benchmark.measure_step_time``
  over 20 steps, five times, the median (host clock after a device
  sync, so host dispatch is in it);
- with ``--alexnet-step``, the same for the AlexNet-128 training step
  of ``chip_smoke.py``'s training phase (batch 128, bf16, the LRN and
  pool kernels; ``ALEXNET_STEP_CFG``);

and prints one JSON line.  ``--kernels`` picks which of the six
groups (flash, pool, lrn, paged, serve, wire) a child times.  The parent prints
the card's name and power limit (``nvidia-smi``) and every child's
line, then each tree's values sorted, and writes them all to
``--out``.  Runs only on a CUDA card.

The module owns the serving flagship's shapes and traffic
(``SERVE_CFG``, ``SERVE_ENGINE``, ``I8_BLOCKS``, ``serve_requests``)
and the decode tick's clock (``ServeClock``): ``chip_smoke.py``'s serve
runs use them, so both time the same requests the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

LM_ROWS = (64, 1024, 64)
LM_LAYERS = 8  # launches of each flash kernel per LM step
POOL_SHAPES = ((128, 32, 32, 96), (128, 15, 15, 256), (128, 7, 7, 256))
LRN_SHAPES = ((128, 32, 32, 96), (128, 15, 15, 256))
LRN_HYPER = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)
ITERS = 30
KERNEL_GROUPS = ("flash", "pool", "lrn", "paged", "serve", "wire")
# the block wires of one 4 MB bucket at a world of 2: the strategies,
# leg 1's rows, the world, and the SR legs' seed words
WIRE_CHAINS = ("int8_sr", "int8", "fp16s")
WIRE_ROWS = 4096
WIRE_WORLD = 2
WIRE_SEEDS = (0x9E3779B9, 0x7F4A7C15)
WIRE_PROFILE_REPS = 5
# the serving flagship: the model, its paged engine, and its traffic (8
# greedy requests, prompts of 16..256 tokens drawn from seed 1, 32 new
# tokens each)
SERVE_CFG = dict(d_model=512, n_heads=8, n_layers=8, vocab_size=4096,
                 seq_len=1024)
SERVE_ENGINE = dict(n_slots=32, max_len=1024, block_size=32, n_blocks=257,
                    prefill_chunk=256)
SERVE_REQUESTS = dict(seed=1, n=8, lo=16, hi=256, new_tokens=32)
SERVE_ROUNDS = 10
# the int8 KV cache: as many int8 blocks as fit in the fp32 pool's bytes
# (kv_block_bytes per (row, head): fp32 2·4·hd, int8 2·(hd + 4))
_HD = SERVE_CFG["d_model"] // SERVE_CFG["n_heads"]
I8_BLOCKS = (SERVE_ENGINE["n_blocks"] * 2 * 4 * _HD) // (2 * (_HD + 4))
# the paged kernels at the flagship's decode (lanes, heads, head_dim,
# block, table entries), pools of the fp32 and int8 engines' blocks (the
# same bytes); the serve shape's lanes 16 tokens into their 32 new ones
PAGED = dict(lanes=SERVE_ENGINE["n_slots"], heads=SERVE_CFG["n_heads"],
             head_dim=_HD, block_size=SERVE_ENGINE["block_size"],
             n_table=SERVE_ENGINE["max_len"] // SERVE_ENGINE["block_size"])
PAGED_BLOCKS = dict(fp32=SERVE_ENGINE["n_blocks"], int8=I8_BLOCKS)
SERVE_AT = 16


LM_STEP_CFG = dict(d_model=512, n_heads=8, n_layers=LM_LAYERS,
                   vocab_size=4096, seq_len=1024, batch_size=8,
                   compute_dtype="bfloat16", attn_impl="flash",
                   exch_strategy="ar", n_synth_train=8, n_synth_val=1,
                   n_epochs=1)


ALEXNET_STEP_CFG = dict(compute_dtype="bfloat16", lrn_impl="pallas",
                        pool_grad="pallas", n_synth_batches=8, n_epochs=1)


def _alexnet_step_ms(dev) -> float:
    """Median of five ``measure_step_time`` windows of the AlexNet-128
    step, TF32 off as in ``chip_smoke.py``."""
    import numpy as np
    import torch

    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.utils.benchmark import measure_step_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.alex_net",
              modelclass="AlexNet", model_config=dict(ALEXNET_STEP_CFG),
              device=dev)
    return float(np.median([1e3 * measure_step_time(rule.model, n_steps=20)
                            for _ in range(5)]))


def _lm_step_ms(dev) -> float:
    """Median of five ``measure_step_time`` windows of the LM step."""
    import numpy as np

    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.utils.benchmark import measure_step_time

    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.transformer",
              modelclass="TransformerLM", model_config=dict(LM_STEP_CFG),
              device=dev)
    return float(np.median([1e3 * measure_step_time(rule.model, n_steps=20)
                            for _ in range(5)]))


def serve_prompts() -> list:
    """The serving flagship's SERVE_REQUESTS["n"] prompts, drawn from
    SERVE_REQUESTS["seed"]."""
    import numpy as np

    p = SERVE_REQUESTS
    rng = np.random.RandomState(p["seed"])
    vocab = SERVE_CFG["vocab_size"]
    return [rng.randint(0, vocab, size=rng.randint(p["lo"], p["hi"] + 1))
            .tolist() for _ in range(p["n"])]


def serve_requests() -> list:
    """Fresh greedy ``Request`` objects for ``serve_prompts()``."""
    from theanompi_tpu_torch.serving import Request

    return [Request(id=f"r{i}", prompt=p,
                    max_new_tokens=SERVE_REQUESTS["new_tokens"])
            for i, p in enumerate(serve_prompts())]


class ServeClock:
    """The scheduler's metrics hooks, recording host times."""

    def __init__(self):
        self.admitted_at, self.first_at, self.done_at = {}, {}, {}
        self.engine_stats = None

    def admitted(self, rid, prompt_len, t):
        self.admitted_at[rid] = t

    def first_token(self, rid, t):
        self.first_at[rid] = t

    def finished(self, rid, n_tokens, t):
        self.done_at[rid] = t

    def set_engine_stats(self, stats):
        self.engine_stats = stats

    def decode_tick_ms(self, reqs) -> float:
        """Median over ``reqs`` of (last token − first token) /
        (tokens − 1), in ms."""
        import numpy as np

        return float(np.median([
            1e3 * (self.done_at[r.id] - self.first_at[r.id])
            / max(len(r.output) - 1, 1) for r in reqs]))


def paged_lengths(shape: str, rng):
    """Lane lengths of the paged ``kernel`` or ``serve`` shape."""
    import numpy as np

    s_, bs, nt = PAGED["lanes"], PAGED["block_size"], PAGED["n_table"]
    if shape == "serve":
        out = np.zeros(s_, np.int32)
        live = [len(p) + SERVE_AT for p in serve_prompts()]
        out[:len(live)] = live
        return out
    out = rng.randint(0, nt * bs, size=s_).astype(np.int32)
    out[:6] = [0, bs - 1, bs, 2 * bs, nt * bs // 2 - 1, nt * bs - 1]
    return out


def paged_tables(lengths, n_blocks: int, rng):
    """Distinct random blocks for every lane's live entries; the rest of
    each row, and every row of a length-0 lane, 0 (the trash block)."""
    import numpy as np

    bs, nt = PAGED["block_size"], PAGED["n_table"]
    tables = np.zeros((len(lengths), nt), np.int32)
    for i, n in enumerate(lengths):
        if n > 0:
            live = min(n // bs + 1, nt)
            tables[i, :live] = rng.choice(n_blocks - 1, live,
                                          replace=False) + 1
    return tables


def _paged_times(dev, time_ms, rng) -> dict:
    """ms of the fp32 and int8 paged kernels at both shapes."""
    import numpy as np
    import torch

    from theanompi_tpu_torch.ops import paged_attention as PA
    from theanompi_tpu_torch.parallel import quantize as Q

    s_, h, hd = PAGED["lanes"], PAGED["heads"], PAGED["head_dim"]
    out = {}
    for pool in ("fp32", "int8"):
        rows = PAGED_BLOCKS[pool] * PAGED["block_size"]
        k, v = (torch.from_numpy(rng.randn(rows, h, hd).astype(np.float32))
                .to(dev) for _ in range(2))
        scales = {}
        if pool == "int8":
            (k, ks), (v, vs) = Q.quantize_rows(k), Q.quantize_rows(v)
            scales = dict(k_scale=ks, v_scale=vs)
        q = torch.from_numpy(rng.randn(s_, h, hd).astype(np.float32)).to(dev)
        for shape in ("kernel", "serve"):
            lengths = paged_lengths(shape, rng)
            tables = torch.from_numpy(paged_tables(
                lengths, PAGED_BLOCKS[pool], rng)).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            def call():
                return PA.paged_decode_attention(
                    q, k, v, tables, ln, block_size=PAGED["block_size"],
                    **scales)

            out[f"paged_{pool}_{shape}_ms"] = time_ms(call)
            out[f"paged_{pool}_{shape}_host_us"] = _host_us(call)
    return out


def _lrn_times(dev, time_ms, rng) -> dict:
    """ms of the bf16 LRN forward and backward at LRN_SHAPES, and of the
    same-bytes ``copy_`` and ``add``, after a writing and a reading
    flush; and their sums over the shapes (a step)."""
    import numpy as np
    import torch

    from theanompi_tpu_torch.ops import lrn as LR

    out = {}
    for shape in LRN_SHAPES:
        x = torch.from_numpy(np.maximum(rng.randn(*shape), 0).astype(
            np.float32) * 2.0).to(dev).bfloat16()
        dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).bfloat16()
        y = torch.empty_like(x)
        calls = dict(lrn_fwd=lambda: LR.lrn_fwd(x, **LRN_HYPER),
                     lrn_bwd=lambda: LR.lrn_bwd(x, dy, **LRN_HYPER),
                     copy=lambda: y.copy_(x),
                     add=lambda: torch.add(x, dy, out=y))
        for name, fn in calls.items():
            for clean in (False, True):
                key = f"{name}{'_clean' if clean else ''}_ms"
                out.setdefault(key, []).append(time_ms(fn, clean))
    for key in list(out):
        out[key + "_per_step"] = sum(out[key])
    return out


def _wire_chain(Q, x, n: int, strategy: str):
    """The three calls of a block wire (``int8``, ``int8_sr`` or
    ``fp16s``) on ``x`` ((world, nb, 256) fp32, the first n elements
    live) in this tree's API: ``(leg1, leg2, final, image)``, each a
    function of no arguments, leg 2 and the last dequantize on the
    leg-1 payload standing in for the gathered shards; ``image`` is the
    error-feedback image of leg 1 (``dequantize(q, s, n=n)``).  Leg 2
    is the tree's fused call where it has one, else its three public
    calls."""
    w1, w2 = WIRE_SEEDS
    world = x.shape[0]
    quant = dict(int8=Q.quantize_int8, fp16s=Q.quantize_fp16,
                 int8_sr=lambda t: Q.quantize_int8_sr(t, w1))[strategy]
    requant = dict(int8_sr=lambda t: Q.quantize_int8_sr(t, w2)).get(
        strategy, quant)
    fused = getattr(Q, dict(int8="dequant_sum_quantize_int8",
                            int8_sr="dequant_sum_quantize_int8_sr",
                            fp16s="dequant_sum_quantize_fp16")[strategy],
                    None)
    q, s = quant(x)

    def leg1():
        return quant(x)

    if fused is None:
        def leg2():
            return requant(Q.dequantize(q, s).sum(dim=0))
    elif strategy == "int8_sr":
        def leg2():
            return fused(q, s, w2)
    else:
        def leg2():
            return fused(q, s)

    if hasattr(Q, "dequant_sum_quantize_int8_sr"):  # a divisor and n
        def final():
            return Q.dequantize(q, s, world, n)

        def image():
            return Q.dequantize(q, s, n=n)
    else:
        def final():
            return Q.dequantize(q, s).view(-1)[:n] / world

        def image():
            return Q.dequantize(q, s).view(-1)[:n]
    return leg1, leg2, final, image


def _wire_times(dev, time_ms, rng) -> dict:
    """ms of each block wire's calls at one 4 MB bucket (WIRE_CHAINS'
    strategies), and of a ``copy_`` of each call's bytes, each after the
    writing flush and after the reading one (``_clean``)."""
    import numpy as np
    import torch

    from theanompi_tpu_torch.parallel import quantize as Q

    w, nb = WIRE_WORLD, WIRE_ROWS // WIRE_WORLD
    n = WIRE_ROWS * Q.BLOCK
    x = torch.from_numpy((rng.randn(WIRE_ROWS, Q.BLOCK) * 10.0 ** rng.uniform(
        -6, 0, (WIRE_ROWS, 1))).astype(np.float32)).to(dev).view(w, nb,
                                                                 Q.BLOCK)
    out = {}
    for strategy in WIRE_CHAINS:
        leg1, leg2, final, _ = _wire_chain(Q, x, n, strategy)

        def chain():
            leg1()
            leg2()
            final()

        pb = 2 if strategy == "fp16s" else 1  # payload bytes an element
        nbytes = dict(quant=WIRE_ROWS * ((4 + pb) * Q.BLOCK + 4),
                      leg2=(w + 1) * nb * (pb * Q.BLOCK + 4),
                      final=WIRE_ROWS * (pb * Q.BLOCK + 4) + 4 * n)
        nbytes["chain"] = sum(nbytes.values())
        for key, fn in (("quant", leg1), ("leg2", leg2), ("final", final),
                        ("chain", chain)):
            src = torch.empty(nbytes[key] // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            tag = f"wire_{strategy}_{key}"
            for clean in (False, True):
                sfx = "_clean" if clean else ""
                out[f"{tag}{sfx}_ms"] = time_ms(fn, clean)
                out[f"{tag}_copy{sfx}_ms"] = time_ms(
                    lambda: dst.copy_(src), clean)
            out[f"{tag}_bytes"] = nbytes[key]
    return out


def _wire_step_profile(dev) -> dict:
    """Device time of each block wire's kernels over every live bucket of
    one LM step (no collectives; ``int8`` with its error-feedback image
    dequantize), from ``torch.profiler`` over WIRE_PROFILE_REPS steps a
    wire; run after every timed call of the process."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.parallel import quantize as Q
    from theanompi_tpu_torch.parallel.exchanger import (
        BSP_Exchanger, blocks_per_shard,
    )

    model = TransformerLM(dict(LM_STEP_CFG), seed=0, device=dev)
    order = model.exchange_order
    sizes = BSP_Exchanger("int8_sr", bucket_bytes=int(
        float(model.config.exchange_bucket_mb) * (1 << 20))).unit_sizes(
        [model.params[i] for i in order],
        [model.param_names[i] for i in order])
    del model
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for strategy in WIRE_CHAINS:
        chains = []
        for n in sizes:
            nb = blocks_per_shard(n, WIRE_WORLD, strategy)
            if nb is None:
                continue
            x = F.pad(torch.randn(n, generator=gen, device=dev),
                      (0, WIRE_WORLD * nb * Q.BLOCK - n))
            chains.append(_wire_chain(Q, x.view(WIRE_WORLD, nb, Q.BLOCK), n,
                                      strategy))

        def step():
            for leg1, leg2, final, image in chains:
                leg1()
                if strategy == "int8":
                    image()
                leg2()
                final()

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(WIRE_PROFILE_REPS):
                step()
            torch.cuda.synchronize()
        by_name = {}
        count = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (
                    e.device_time_total / 1e3 / WIRE_PROFILE_REPS)
                count += 1
        tag = f"wire_{strategy}_step"
        out.update({f"{tag}_buckets": len(chains),
                    f"{tag}_device_ms": sum(by_name.values()),
                    f"{tag}_kernels": count / WIRE_PROFILE_REPS,
                    f"{tag}_by_kernel": by_name})
    return out


def _serve_ticks(dev) -> dict:
    """The flagship's decode tick (ms) on the fp32 and int8 pools:
    SERVE_ROUNDS runs of ``serve_requests()`` each, and their median;
    then one fp32 run under ``torch.profiler`` (CPU and CUDA activity,
    as ``chip_smoke.py``'s tick profile) and both pools' rounds again
    (``..._after_profile``)."""
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.serving import (
        ContinuousBatchingScheduler, PagedServingEngine,
    )

    class Engine(PagedServingEngine):
        """Adds up the host time of its decode ticks' calls (the
        enqueue of a tick's work; the scheduler's wait for the logits
        and its picks are outside)."""

        step_s = 0.0

        def decode_step_paged(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().decode_step_paged(*args, **kwargs)
            self.step_s += time.perf_counter() - t0
            return out

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(SERVE_CFG, seed=0, device=dev)
    engines = {}
    for pool, n_blocks in (("fp32", SERVE_ENGINE["n_blocks"]),
                           ("int8", I8_BLOCKS)):
        engines[pool] = Engine(model, device=dev, kv_dtype=pool,
                               **dict(SERVE_ENGINE, n_blocks=n_blocks))
        engines[pool].greedy(serve_prompts()[0][:SERVE_REQUESTS["lo"]], 2)

    def rounds(engine, n, steps=None):
        ticks = []
        for _ in range(n):
            reqs, clock = serve_requests(), ServeClock()
            sched = ContinuousBatchingScheduler(engine, metrics=clock)
            for r in reqs:
                sched.submit(r)
            engine.step_s = 0.0
            sched.run()
            torch.cuda.synchronize()
            ticks.append(clock.decode_tick_ms(reqs))
            if steps is not None:
                steps.append(1e3 * engine.step_s
                             / sched.stats["decode_ticks"])
        return ticks

    out = {}
    for pool, engine in engines.items():
        steps = []
        ticks = rounds(engine, SERVE_ROUNDS, steps)
        out[f"serve_{pool}_tick_ms"] = float(np.median(ticks))
        out[f"serve_{pool}_tick_ms_rounds"] = ticks
        out[f"serve_{pool}_step_host_ms"] = float(np.median(steps))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        rounds(engines["fp32"], 1)
    for pool, engine in engines.items():
        out[f"serve_{pool}_tick_ms_after_profile"] = float(np.median(
            rounds(engine, SERVE_ROUNDS)))
    return out


def _host_us(fn, calls: int = 50, rounds: int = 5) -> float:
    """Host microseconds a call of ``fn`` takes to return (its launch
    enqueued, the device not waited for): the median of ``rounds``
    windows of ``calls`` calls, each window after a device sync."""
    import time

    import numpy as np
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


def _child(steps, groups) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import flash as FL
    from theanompi_tpu_torch.ops import pool as PO

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def time_ms(fn, clean: bool = False) -> float:
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(ITERS):
            for _ in range(2):  # twice: longer than any wrapper's host work
                if clean:
                    flush.sum()
                else:
                    flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))

    rng = np.random.RandomState(0)
    out = dict(tree=os.environ.get("PYTHONPATH", ""))
    bh, t, d = LM_ROWS
    scale = d ** -0.5
    if "flash" in groups:
        q, k, v = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
                   .to(dev).bfloat16() for _ in range(3))
        q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
        out["flash_fwd_ms"] = time_ms(
            lambda: FL.flash_fwd(q, k, v, True, scale))
        out["sdpa_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale))
    if "pool" in groups:
        out["maxpool_bwd_ms"], out["aten_pool_bwd_ms"] = [], []
        for shape in POOL_SHAPES:
            x = torch.from_numpy(np.maximum(rng.randn(*shape), 0).astype(
                np.float32) * 2.0).to(dev).bfloat16()
            y = PO.maxpool_fwd(x, 3, 2)
            dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).to(
                dev).bfloat16()
            x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            _, idx = F.max_pool2d(x_nchw, 3, 2, return_indices=True)
            out["maxpool_bwd_ms"].append(
                time_ms(lambda: PO.maxpool_bwd(x, y, dy, 3, 2)))
            out["aten_pool_bwd_ms"].append(time_ms(
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    dy_nchw, x_nchw, [3, 3], [2, 2], [0, 0], [1, 1], False,
                    idx)))
        out["maxpool_bwd_ms_per_step"] = sum(out["maxpool_bwd_ms"])
        out["aten_pool_bwd_ms_per_step"] = sum(out["aten_pool_bwd_ms"])
    if "lrn" in groups:
        out.update(_lrn_times(dev, time_ms, np.random.RandomState(3)))
    if "flash" in groups:
        do = torch.from_numpy(rng.randn(bh, t, d).astype(np.float32)).to(
            dev).bfloat16()
        o, lse = FL.flash_fwd(q, k, v, True, scale)
        bwd = (q, k, v, do, lse, (do.float() * o.float()).sum(dim=-1), True,
               scale)
        out["flash_dq_ms"] = time_ms(lambda: FL.flash_dq(*bwd))
        out["flash_dkv_ms"] = time_ms(lambda: FL.flash_dkv(*bwd))
        o4, lse4, cq, ck, mq, mk, seed, offset, _ = (
            torch.ops.aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, True, False, scale=scale))
        do4 = do.view(1, bh, t, d)
        aten_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        out["aten_bwd_ms"] = time_ms(lambda: aten_bwd(
            do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, True, seed,
            offset, scale=scale))
        out["flash_fwd_ms_per_step"] = LM_LAYERS * out["flash_fwd_ms"]
        out["sdpa_fwd_ms_per_step"] = LM_LAYERS * out["sdpa_fwd_ms"]
        out["flash_bwd_ms_per_step"] = LM_LAYERS * (out["flash_dq_ms"]
                                                    + out["flash_dkv_ms"])
        out["aten_bwd_ms_per_step"] = LM_LAYERS * out["aten_bwd_ms"]
    if "paged" in groups:
        out.update(_paged_times(dev, time_ms, np.random.RandomState(7)))
    if "serve" in groups:
        out.update(_serve_ticks(dev))
    if "wire" in groups:
        out.update(_wire_times(dev, time_ms, np.random.RandomState(5)))
    if "--lm-step" in steps:
        out["lm_step_ms"] = _lm_step_ms(dev)
    if "--alexnet-step" in steps:
        out["alexnet_step_ms"] = _alexnet_step_ms(dev)
    if "wire" in groups:  # profiled last: a profile slows what follows
        out.update(_wire_step_profile(dev))
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print(json.dumps(_child(sys.argv[3:], sys.argv[2].split(","))))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--order", default="old,new,new,old")
    ap.add_argument("--kernels", default=",".join(KERNEL_GROUPS),
                    help="groups to time, of " + ",".join(KERNEL_GROUPS))
    ap.add_argument("--lm-step", action="store_true",
                    help="also time the LM training step (end to end)")
    ap.add_argument("--alexnet-step", action="store_true",
                    help="also time the AlexNet-128 training step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    trees = dict(old=os.path.abspath(args.old), new=os.path.abspath(args.new))
    runs = []
    for label in args.order.split(","):
        env = dict(os.environ, PYTHONPATH=trees[label])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             args.kernels] + (["--lm-step"] if args.lm_step else [])
            + (["--alexnet-step"] if args.alexnet_step else []),
            cwd=trees[label], env=env, check=True, capture_output=True,
            text=True)
        row = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   label=label)
        runs.append(row)
        print(json.dumps(row))
    summary = {}
    for label in trees:
        mine = [r for r in runs if r["label"] == label]
        keys = [k for k in (mine[0] if mine else ())
                if k.endswith("_per_step") or k.startswith("paged_")
                or k.startswith("wire_") and k.endswith("_ms")
                or ("_tick_ms" in k or "_host_ms" in k)
                and not k.endswith("_rounds")
                or k in ("lm_step_ms", "alexnet_step_ms")]
        summary[label] = {k: sorted(r[k] for r in mine) for k in keys}
    result = dict(card=card, order=args.order, runs=runs, summary=summary)
    print(json.dumps(dict(card=card, summary=summary)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
