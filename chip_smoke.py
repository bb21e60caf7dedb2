"""Drive the PyTorch/CUDA port (``theanompi_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. environment — torch and CUDA versions, the card's name and power
   limit as ``nvidia-smi`` reports them, ``nvcc``, whether ``triton``
   imports; TF32 is switched off for every fp32 product.
2. build — every CUDA kernel of the port (paged decode attention, LRN,
   max-pool backward, flash attention, block quantization), from
   ``csrc/``, one ``nvcc`` each, all at once.
3. kernel vs plain (serving) — the paged decode attention kernel
   against its plain PyTorch version at the serving path's full width
   (32 lanes, 8 heads, head_dim 64, block 32, 32-entry tables, lengths
   0..1023), fp32 and bf16 pools; times of the kernel, the plain
   version and ``F.scaled_dot_product_attention`` over the pre-gathered
   image (the one-call yardstick, used nowhere in the port), beside the
   bound.  Then the int8 kernel (int8 pool of 967 blocks, the fp32
   pool's bytes; rows quantized by ``quantize_rows``; the same lengths)
   against its plain version (dequantized image, atol 1e-5; also on a
   K pool that starts on an odd byte, and at head_dim 37 and 128), timed
   beside its bound and SDPA over the image dequantized beforehand (not
   the same function: no single PyTorch call attends int8 rows with
   per-(row, head) scales, so its ``library_ms`` is null).
4. kernels vs plain (training) — LRN forward and backward (size 5) on
   AlexNet-128's two LRN inputs at batch 128, (128,32,32,96) and
   (128,15,15,256), and the max-pool backward on its three 3×3/2
   pools, (128,32,32,96), (128,15,15,256) and (128,7,7,256); fp32 and
   bf16 inputs made from a seed as ReLU outputs (real ties: zeros and
   repeated bf16 values).  Each against its plain version, with times
   of the kernel (cold L2), the plain version and the one-call
   yardstick (``F.local_response_norm`` with α·size for the forward;
   aten's ``max_pool2d_with_indices_backward`` for the pool, which
   routes ties to one max and so is a yardstick of time only; none for
   the LRN backward), beside the bound.  Then the max-pool backward's
   edge cases (one launch a call, the 16-byte or the one-channel path):
   C 3, 13 and 96, windows 2/2, 3/2 and 3/1 on (2, 9, 11, C), fp32 and
   bf16, inputs drawn from four levels so that most windows tie, C 96
   with x off 16 bytes, and (1, 9, 2100, 64) in bands of columns.
5. serve — ``TransformerLM`` at the flagship serving config (d_model
   512, 8 heads, 8 layers, vocab 4096, seq_len 1024; seeded random
   weights) behind ``PagedServingEngine`` (32 slots, block 32, 257
   blocks, prefill chunk 256) and ``ContinuousBatchingScheduler``: 8
   greedy requests, prompts of 16..256 tokens, 32 new tokens each.
   The kernel's launch count over this run must equal n_layers × decode
   ticks, and every request's tokens must equal greedy decoding by the
   no-cache full-recompute forward on the card.  Then the same 8
   requests from the int8 KV cache (``kv_dtype='int8'``, 967 blocks in
   the fp32 pool's bytes): int8 kernel launches = n_layers × decode
   ticks and no fp32 launch; tokens equal to the CPU int8 engine's on
   the same weights (a divergence passes only at a decision margin
   below 1e-3); the reference's ``kv_quant`` probe (capacity ratio >= 2,
   greedy agreement with the fp32 run >= 0.8); the pool's
   ``torch.cuda.memory_allocated`` against n_blocks × kv_block_bytes.
   Then 4 seeded sampled requests (T 0.8, top-k 50) on the fp32 pool,
   interleaved with 2 greedy ones and then each alone: the same tokens
   both times, every token inside its row's top-k, tokens equal to the
   CPU's.
6. train — ``BSP().init(devices=1, ...)`` / ``rule.wait()`` for
   AlexNet-128 (1000 classes, batch 128, bf16 compute,
   ``lrn_impl='pallas'``, ``pool_grad='pallas'``; seeded random
   weights) on synthetic ImageNet-128: one epoch of 32 steps and the 4
   validation batches, NCCL with a world of 1.  The kernels' launch
   counts over the run must be exactly 2 LRN forwards per forward pass
   (32 steps + 4 validation batches), 2 LRN backwards and 3 pool
   backwards per step; the loss must be finite and fall.  Prints the
   host time waiting on data, the run's wall time, and images/s and
   step time from ``utils.benchmark.images_per_sec`` (the step on
   pre-loaded batches), then the device time of the step by part
   (conv/dense, LRN, pool backward, exchange, the rest) and the
   device's idle share from ``torch.profiler`` over 10 more steps.
7. train oracle — one fp32 step (batch 8, dropout 0, full width) of the
   port on the card and the same step of the port on the CPU (which
   takes the plain versions), from the same weights and batch: loss
   and every updated parameter must agree.
8. flash kernels vs plain — the flash forward (out and lse), dQ and
   dK/dV kernels against their plain versions at the LM path's rows
   (B·H = 64, T = 1024, D = 64, causal) and at three tail shapes
   (T = 200, D = 32, full; T = 100, D = 64, causal; T = 130, D = 96,
   causal: the 128-wide instance), fp32 and bf16; times of the kernel
   (cold L2), the plain version and the one-call yardsticks, used
   nowhere in the port: ``F.scaled_dot_product_attention`` for the
   forward, and for dQ with dK/dV (bf16) aten's
   ``_scaled_dot_product_flash_attention_backward`` timed alone on what
   aten's flash forward returns; beside the bound (bf16 products at the
   tensor cores' 989 TFLOP/s, fp32 at 67 TFLOP/s, or the bytes at 3.35
   TB/s).  bf16 with D <= 64 and D % 8 = 0 runs the wgmma forward, dQ
   and dK/dV fed by TMA (asserted per row).  Then the bf16 edge cases
   of all three: T 1, 127, 128 and 129, D 16, 32, 40, 64 (the wgmma
   instances) and 36 (mma.sync), causal and full, and q off 16 bytes
   (mma.sync); and dQ, dK/dV with several items a CTA at (B·H, T, D) =
   (200, 64, 64) and (300, 256, 64), causal and full.
9. LM train — ``BSP().init(devices=1, ...)`` / ``rule.wait()`` for
   ``TransformerLM`` at the serving config's full width (d_model 512, 8
   heads, 8 layers, vocab 4096, seq_len 1024) with batch 8, bf16
   compute, ``attn_impl='flash'``, ``exch_strategy='ar'``, seeded random
   weights, synthetic tokens: one epoch of 32 steps and 2 validation
   batches, NCCL with a world of 1.  The launch counts must be exactly
   n_layers flash forwards per forward pass (32 + 2) and n_layers dQ
   and dK/dV per step; the loss must be finite and fall.  Prints the
   step time and tokens/s from ``utils.benchmark.measure_step_time``,
   the host time waiting on data, and the device time by part and the
   idle share from ``torch.profiler``.
10. LM train oracle — one fp32 step (batch 2, seq_len 1024, full width,
   flash) on the card and on the CPU from the same weights and batch.
11. wire kernels vs plain — the four block-quantization kernels (int8
   round-to-nearest, int8 stochastic rounding with a fixed seed word,
   fp16 with a block scale, dequantize of int8 and fp16 payloads)
   against their plain versions, exact, at the shapes one bucket of 4
   MB gives them at a world of 2 (leg 1 (2, 2048, 256), leg 2 (2048,
   256)) and at AlexNet-128's largest bucket from its bucketing plan;
   then timed (cold L2) at every shape of the LM's step at a world of
   2, beside the bytes bound.  No single PyTorch call computes a
   per-256-block amax quantization, so there is no yardstick.
12. LM train at a world of 2 on the one card — two processes (this
   script with ``--bsp2-rank``) with ``RANK``, ``WORLD_SIZE=2``,
   ``LOCAL_RANK=0``, ``LOCAL_WORLD_SIZE=2``, each running
   ``BSP().init(devices=2, ...)`` / ``rule.wait()`` for
   ``TransformerLM`` at the LM phase's width, batch 8 per rank, bf16,
   flash, with the default wire ``int8_sr``: 8 steps and a validation
   batch.  Checks: both ranks run gloo on ``cuda:0``; the quantize and
   dequantize launches equal what the bucket plan predicts (2 of each
   per live bucket and step); the loss is finite and falls; every
   parameter is bitwise equal across the ranks; on one step the first
   bucket's ``int8_sr`` mean lies within 2·max|g|/127 of the fp32
   ``all_reduce`` mean.  Then two steps each of ``int8`` with error
   feedback and of ``fp16s`` (their launches checked the same way, the
   parameters still equal).  Prints step ms, the wire's share of the
   step and peak memory per rank.

Prints, before the last line, a JSON line of the serving and training
numbers and the kernel instances, then the JSON line
``{"kernels": [...]}`` (12 hand-written kernels) — the paged kernel's
fp32 instance (what the fp32 serving run runs) and the int8 kernel
(launches from the int8 serving run), for each training kernel its
bf16 instance (what the training paths run) summed over the launches
of one step (AlexNet's shapes; the LM's n_layers launches), and for
each wire kernel its launches of one LM step at a world of 2 — and as
the last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when no card is present or the port is not importable.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import torch.distributed as dist

from theanompi_tpu_torch import BSP, cuda_build
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.ops import flash as FL
from theanompi_tpu_torch.ops import lrn as LR
from theanompi_tpu_torch.ops import paged_attention as PA
from theanompi_tpu_torch.ops import pool as PO
from theanompi_tpu_torch.parallel import quantize as Q
from theanompi_tpu_torch.parallel.exchanger import (
    BSP_Exchanger, blocks_per_shard,
)
from theanompi_tpu_torch.runtime.dist import destroy_process_group
from theanompi_tpu_torch.utils.benchmark import (
    images_per_sec, measure_step_time,
)
from theanompi_tpu_torch.serving import (
    ContinuousBatchingScheduler, PagedServingEngine, Request, Sampler,
)
from theanompi_tpu_torch.serving.sampling import gumbel_noise, request_seed

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
SERVE_CFG = dict(d_model=512, n_heads=8, n_layers=8, vocab_size=4096,
                 seq_len=1024)
SERVE_ENGINE = dict(n_slots=32, max_len=1024, block_size=32, n_blocks=257,
                    prefill_chunk=256)
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 8, 16, 256, 32
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.int8: 1e-5}
TIE_MARGIN = 1e-4
# the int8 KV cache: as many int8 blocks as fit in the fp32 pool's bytes
# (kv_block_bytes per (row, head): fp32 2·4·hd, int8 2·(hd + 4))
I8_BLOCKS = (SERVE_ENGINE["n_blocks"] * 2 * 4 * 64) // (2 * (64 + 4))
# card vs CPU tokens (int8 pool; sampled requests): the two sides' fp32
# logits differ in summation order, and an int8 payload may land one
# quantum apart where a value sits on a rounding edge; a divergence
# passes only where the top-2 margin of what the pick was decided on
# (logits, or scaled logits + noise) is below this
CARD_CPU_MARGIN = 1e-3
KV_QUANT_MIN_CAPACITY, KV_QUANT_MIN_AGREEMENT = 2.0, 0.8  # the reference's
# sampled requests: T 0.8, top-k 50, seeded; shorter prompts
N_SAMPLED, SAMPLED_T, SAMPLED_TOP_K, SAMPLED_NEW = 4, 0.8, 50, 16
# training slice: AlexNet-128 at batch 128
LRN_SHAPES = ((128, 32, 32, 96), (128, 15, 15, 256))
POOL_SHAPES = ((128, 32, 32, 96), (128, 15, 15, 256), (128, 7, 7, 256))
LRN_HYPER = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)
# kernel vs plain: fp32 — the same formulas and summation order, only
# expf/logf and FMA contraction differ; bf16 — one bf16 step of the
# plain value (|err| <= 2^-7 |plain|), the fp32 results differing by
# ~1e-7 before the final rounding
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
TRAIN_CFG = dict(compute_dtype="bfloat16", lrn_impl="pallas",
                 pool_grad="pallas", n_synth_batches=32, n_epochs=1,
                 print_freq=4)
N_VAL_BATCHES = 4  # ImageNetData's synthetic validation set
ORACLE_CFG = dict(batch_size=8, dropout_rate=0.0, lrn_impl="pallas",
                  pool_grad="pallas", n_synth_batches=1)
# card vs CPU, one fp32 step: cuDNN and the CPU sum the convolutions in
# other orders (TF32 off); measured on an H100: loss equal, updates 5e-6
ORACLE_LOSS_ATOL = 1e-5
ORACLE_UPDATE_RTOL = 1e-4  # ||update_card - update_cpu|| / ||update_cpu||
# LM training slice: the flash kernels' rows on the LM path (B·H = 8·8)
# and three tail shapes (T not a multiple of the 64-row tile; D < 64
# and D = 64, the tensor-core instances at bf16, and D in (64, 128], the
# CUDA-core instance at bf16; every fp32 instance runs on the CUDA cores)
FLASH_SHAPES = ((64, 1024, 64, True), (8, 200, 32, False),
                (4, 100, 64, True), (6, 130, 96, True))
# kernel vs plain: fp32 — the same formulas, the softmax online over
# 64-key tiles in the kernel and over the whole row in the plain
# version, sums of up to 1024 terms in other orders (the reference's
# own flash-vs-dense test allows 2e-5 on out and 2e-4 on gradients);
# bf16 — one bf16 step of the plain value; lse stays fp32
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}
LSE_TOL = dict(rtol=1e-5, atol=2e-5)
# on-card edge checks of the flash forward (bf16: the wgmma instance fed
# by TMA, and the mma.sync one where D is not a multiple of 8 or q lies
# off 16 bytes) and of the max-pool backward (channels that do and do not
# fill 16-byte vectors, three windows, odd H and W, inputs drawn from four
# levels so that most windows tie; an operand off 16 bytes; a row too
# wide for one band), at FLASH_TOL / LSE_TOL and KERNEL_TOL
FLASH_EDGE_T = (1, 127, 128, 129)
FLASH_EDGE_D = (16, 32, 40, 64, 36)
# the wgmma backward with several items a CTA: the shapes at which a
# truncating hi/lo split of P and dS left one element outside FLASH_TOL
FLASH_BWD_MANY = ((200, 64, 64), (300, 256, 64))
POOL_EDGE_C = (3, 13, 96)
POOL_EDGE_WINDOWS = ((2, 2), (3, 2), (3, 1))
POOL_EDGE_HW = (9, 11)
POOL_EDGE_LEVELS = (0.0, 0.5, 1.0, 1.5)
POOL_EDGE_WIDE = (1, 9, 2100, 64)  # 3/2: one row of a band is too wide
LM_CFG = dict(SERVE_CFG, batch_size=8, compute_dtype="bfloat16",
              attn_impl="flash", exch_strategy="ar", n_synth_train=32,
              n_synth_val=2, n_epochs=1, print_freq=4)
LM_ORACLE_CFG = dict(SERVE_CFG, batch_size=2, attn_impl="flash",
                     exch_strategy="ar", n_synth_train=1, n_synth_val=1)
# card vs CPU, one fp32 LM step: 8 layers of fp32 GEMMs blocked
# differently (TF32 off), the flash sums in other orders, the embedding
# gradient a scatter-add with atomics on the card; the loss is a mean
# of 2048 token losses near 8.3.  The gradients of the attention
# projections and LayerNorm scales cancel (softmax rows, normalized
# rows), so summation order alone moves their updates by ~1e-4 in norm:
# the phase prints the CPU's own spread (the same step at 1 thread and
# at the default count) beside the card-vs-CPU difference
LM_ORACLE_LOSS_ATOL = 1e-4
LM_ORACLE_UPDATE_RTOL = 5e-4
# the wire at a world of 2 on one card
WIRE_WORLD = 2
WIRE_SEED = 0x9E3779B9  # the SR check's fixed seed word
# operations per element (bounds): amax, divide, round, clamp; the SR
# hash adds ~14 integer operations; fp16 a convert; dequantize 2
WIRE_OPS = dict(block_quant_int8=6, block_quant_int8_sr=20,
                block_quant_fp16=4, block_dequant=2)
BSP2_CFG = dict(SERVE_CFG, batch_size=8, compute_dtype="bfloat16",
                attn_impl="flash", n_synth_train=8, n_synth_val=1,
                n_epochs=1, print_freq=4)
# after the default int8_sr run: two steps of each other kernel's path
BSP2_MORE = (("int8+ef", dict(exch_strategy="int8", error_feedback=True)),
             ("fp16s", dict(exch_strategy="fp16s", error_feedback=False)))
BSP2_MORE_STEPS = 2
BSP2_TIMEOUT_S = 600
BSP2_DEVICE = "cuda:0"  # both ranks on the one card


def phase_environment() -> None:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = cuda_build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], check=True,
                         capture_output=True, text=True).stdout
    print(f"nvcc {nvcc}: {ver.strip().splitlines()[-1]}")
    print(f"triton importable: {importlib.util.find_spec('triton') is not None}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = cuda_build.build([PA.KERNEL, LR.KERNEL, PO.KERNEL, FL.KERNEL,
                              Q.KERNEL])
    dt = time.perf_counter() - t0
    for name, path in paths.items():
        print(f"built {name}: {path.name} ({dt:.1f} s)")
        log = path.with_name(path.name + ".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "C7514" in line:
                print(f"  ptxas: {line.strip()}")


def _time_ms(fn, flush: torch.Tensor, iters: int = 30,
             warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` calls, each with a
    cold L2 (a 256 MiB memset between calls, which also keeps the
    device busy while the host enqueues the timed call)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def phase_kernel(dev: torch.device) -> dict:
    """The kernel against its plain version at the serving shapes."""
    s_, h, hd, bs, nt = 32, 8, 64, 32, 32
    n_blocks = SERVE_ENGINE["n_blocks"]
    rng = np.random.RandomState(SEED)
    q = torch.from_numpy(rng.randn(s_, h, hd).astype(np.float32)).to(dev)
    kp32 = torch.from_numpy(
        rng.randn(n_blocks * bs, h, hd).astype(np.float32)).to(dev)
    vp32 = torch.from_numpy(
        rng.randn(n_blocks * bs, h, hd).astype(np.float32)).to(dev)
    tables_np = np.stack([
        rng.choice(n_blocks - 1, nt, replace=False) + 1 for _ in range(s_)
    ]).astype(np.int32)
    lengths_np = rng.randint(0, nt * bs, size=s_).astype(np.int32)
    # boundary cases: empty history, last row of a block, first row of
    # a block, the whole table
    lengths_np[:6] = [0, bs - 1, bs, 2 * bs, nt * bs // 2 - 1, nt * bs - 1]
    tables = torch.from_numpy(tables_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    scale = hd ** -0.5
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    live_rows = int((lengths_np.astype(np.int64) + 1).sum())
    live_blocks = int((lengths_np // bs + 1).sum())
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        kp, vp = kp32.to(dt), vp32.to(dt)

        def kern(kp=kp, vp=vp):
            return PA.paged_decode_attention(
                q, kp, vp, tables, lengths, block_size=bs, scale=scale)

        def plain(kp=kp, vp=vp):
            return PA.paged_decode_attention_plain(
                q, kp, vp, tables, lengths, block_size=bs, scale=scale)

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > ATOL[dt]:
            raise AssertionError(
                f"paged kernel vs plain ({dt}): max |err| {err} > {ATOL[dt]}")
        # one-call yardstick: SDPA over the image gathered beforehand
        rows = PA.image_rows(tables, bs)
        k_img = kp[rows].permute(0, 2, 1, 3).contiguous()  # (S, H, T, hd)
        v_img = vp[rows].permute(0, 2, 1, 3).contiguous()
        q_l = q.to(dt)[:, :, None, :]
        mask = (torch.arange(nt * bs, device=dev)[None, :]
                <= lengths.long()[:, None])[:, None, None, :]

        def library(k_img=k_img, v_img=v_img, q_l=q_l):
            return F.scaled_dot_product_attention(
                q_l, k_img, v_img, attn_mask=mask, scale=scale)

        lib_err = float((library()[:, :, 0].float() - want).abs().max())
        esize = kp.element_size()
        nbytes = (2 * live_rows * h * hd * esize + 2 * s_ * h * hd * 4
                  + live_blocks * 4 + s_ * 4)
        flops = 4 * live_rows * h * hd
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
        res = dict(
            max_abs_err=err,
            ms=_time_ms(kern, flush),
            plain_ms=_time_ms(plain, flush),
            library_ms=_time_ms(library, flush),
            bound_ms=bound_s * 1e3,
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / FP32_FLOP_PER_S else "operations"),
            bytes=nbytes, library_max_abs_err=lib_err,
        )
        print(f"paged_decode_attention {str(dt).replace('torch.', '')}: "
              f"max|err| {err:.3e} (atol {ATOL[dt]}), kernel "
              f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, sdpa "
              f"{res['library_ms']:.4f} ms (max|err| {lib_err:.3e}), bound "
              f"{res['bound_ms']:.4f} ms ({nbytes} B, Σ(len+1)={live_rows})")
        results[dt] = res
    results[torch.int8] = _kernel_i8(dev, q, tables_np, lengths_np, flush,
                                     rng)
    return results


def _kernel_i8(dev, q, tables_np, lengths_np, flush, rng) -> dict:
    """The int8 kernel against its plain version at the serving shapes,
    over an int8 pool of I8_BLOCKS blocks (the fp32 pool's bytes):
    seeded rows quantized by ``quantize_rows``, the fp32 instance's
    lengths (boundary cases included), tables drawn from the larger
    pool."""
    s_, h, hd = q.shape
    bs, nt = 32, tables_np.shape[1]
    rows_n = I8_BLOCKS * bs
    kq, ks = Q.quantize_rows(torch.from_numpy(
        rng.randn(rows_n, h, hd).astype(np.float32)).to(dev))
    vq, vs = Q.quantize_rows(torch.from_numpy(
        rng.randn(rows_n, h, hd).astype(np.float32)).to(dev))
    tables_np = np.stack([
        rng.choice(I8_BLOCKS - 1, nt, replace=False) + 1 for _ in range(s_)
    ]).astype(np.int32)
    tables = torch.from_numpy(tables_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    scale = hd ** -0.5

    def kern():
        return PA.paged_decode_attention(
            q, kq, vq, tables, lengths, block_size=bs, scale=scale,
            k_scale=ks, v_scale=vs)

    def plain():
        return PA.paged_decode_attention_i8_plain(
            q, kq, vq, ks, vs, tables, lengths, block_size=bs, scale=scale)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or err > ATOL[torch.int8]:
        raise AssertionError(
            f"paged int8 kernel vs plain: max |err| {err} > "
            f"{ATOL[torch.int8]}")
    _kernel_i8_edges(dev, q, kq, vq, ks, vs, tables, lengths, bs, scale)
    # no one PyTorch call attends int8 rows with per-(row, head) scales;
    # beside it, SDPA over the image dequantized beforehand (not the same
    # function: it reads 4 bytes per element where the kernel reads 1)
    rows = PA.image_rows(tables, bs)
    k_img = (kq[rows].float() * ks[rows][..., None]).permute(0, 2, 1, 3)
    v_img = (vq[rows].float() * vs[rows][..., None]).permute(0, 2, 1, 3)
    k_img, v_img = k_img.contiguous(), v_img.contiguous()
    mask = (torch.arange(nt * bs, device=dev)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k_img, v_img, attn_mask=mask, scale=scale)

    sdpa_err = float((sdpa()[:, :, 0] - want).abs().max())
    live_rows = int((lengths_np.astype(np.int64) + 1).sum())
    live_blocks = int((lengths_np // bs + 1).sum())
    # each live (row, head): hd int8 values and one fp32 scale, K and V
    nbytes = (2 * live_rows * h * (hd + 4) + 2 * s_ * h * hd * 4
              + live_blocks * 4 + s_ * 4)
    ops = 6 * live_rows * h * hd  # dequantize K and V, q·k, p·v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    res = dict(
        max_abs_err=err, ms=_time_ms(kern, flush),
        plain_ms=_time_ms(plain, flush), library_ms=None,
        sdpa_dequantized_image_ms=_time_ms(sdpa, flush),
        sdpa_max_abs_err=sdpa_err, bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, n_blocks=I8_BLOCKS,
    )
    print(f"paged_decode_attention_i8: max|err| {err:.3e} (atol "
          f"{ATOL[torch.int8]}), kernel {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, sdpa on the dequantized image (not the "
          f"same function) {res['sdpa_dequantized_image_ms']:.4f} ms "
          f"(max|err| {sdpa_err:.3e}), bound {res['bound_ms']:.4f} ms "
          f"({nbytes} B, {I8_BLOCKS} blocks, Σ(len+1)={live_rows})")
    return res


def _kernel_i8_edges(dev, q, kq, vq, ks, vs, tables, lengths, bs,
                     scale) -> None:
    """The int8 kernel's other paths against its plain version: a K pool
    that starts on an odd byte (byte loads in place of ``char2``), an
    odd head_dim (37) and the widest (128), atol 1e-5."""
    flat = torch.empty(kq.numel() + 1, dtype=torch.int8, device=dev)
    k_odd = flat[1:].view(kq.shape)
    k_odd.copy_(kq)
    cases = [("odd-aligned K pool", (q, k_odd, vq, ks, vs, tables, lengths,
                                     bs))]
    rng = np.random.RandomState(SEED + 3)
    for s_, h, hd, bs_e, nb, nt in ((5, 3, 37, 4, 20, 6),
                                    (4, 2, 128, 16, 30, 8)):
        pools = [Q.quantize_rows(torch.from_numpy(
            rng.randn(nb * bs_e, h, hd).astype(np.float32)).to(dev))
            for _ in range(2)]
        ln = rng.randint(0, nt * bs_e, size=s_).astype(np.int32)
        ln[:2] = [0, nt * bs_e - 1]
        cases.append((f"hd {hd}", (
            torch.from_numpy(rng.randn(s_, h, hd).astype(np.float32)).to(dev),
            pools[0][0], pools[1][0], pools[0][1], pools[1][1],
            torch.from_numpy(np.stack([
                rng.choice(nb - 1, nt, replace=False) + 1 for _ in range(s_)
            ]).astype(np.int32)).to(dev),
            torch.from_numpy(ln).to(dev), bs_e)))
    for name, (q_, k_, v_, ks_, vs_, t_, l_, bs_) in cases:
        sc = scale if name.startswith("odd") else None
        got = PA.paged_decode_attention(q_, k_, v_, t_, l_, block_size=bs_,
                                        scale=sc, k_scale=ks_, v_scale=vs_)
        want = PA.paged_decode_attention_i8_plain(
            q_, k_, v_, ks_, vs_, t_, l_, block_size=bs_, scale=sc)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > ATOL[torch.int8]:
            raise AssertionError(
                f"paged int8 kernel vs plain ({name}): max |err| {err}")
        print(f"paged_decode_attention_i8 {name}: max|err| {err:.3e}")


class _Timeline:
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


def _oracle_check(model, dev, req) -> None:
    """The request's tokens against greedy decoding by the no-cache
    full-recompute forward; a divergence passes only at a true tie."""
    toks = list(req.prompt)
    with torch.no_grad():
        for step, served in enumerate(req.output):
            logits = model(torch.tensor([toks], device=dev))[0, -1]
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{req.id}: non-finite logits")
            want = int(torch.argmax(logits))
            if want != served:
                top2 = torch.topk(logits, 2).values
                margin = float(top2[0] - top2[1])
                print(f"{req.id}: diverges at token {step} (served {served}, "
                      f"oracle {want}), top-2 margin {margin:.3e}")
                if margin >= TIE_MARGIN:
                    raise AssertionError(
                        f"{req.id}: served tokens differ from the full-"
                        f"recompute oracle at token {step}")
                return
            toks.append(served)


class _Recorder(ContinuousBatchingScheduler):
    """The scheduler, keeping every pick's logits row (on the host) and
    token, by (request id, token index)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.picks = {}

    def _pick_tokens(self, picks, logits):
        toks = super()._pick_tokens(picks, logits)
        rows = logits.float().cpu()
        for i, p in enumerate(picks):
            if p is not None:
                self.picks[(p[0].id, p[1])] = (rows[i], int(toks[i]))
        return toks


def _serve_run(engine, reqs, record: bool = False) -> dict:
    """Serve ``reqs`` through a fresh scheduler: every paged kernel's
    count set to 0 just before, read just after; the device bytes the
    scheduler's pool took."""
    timeline = _Timeline()
    on_card = engine.device.type == "cuda"
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    sched = (_Recorder if record else ContinuousBatchingScheduler)(
        engine, metrics=timeline)
    pool_bytes = torch.cuda.memory_allocated() - mem0 if on_card else None
    PA.paged_decode_attention.launches = 0
    PA.paged_decode_attention_i8.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fp32=PA.paged_decode_attention.launches,
                    int8=PA.paged_decode_attention_i8.launches)
    vocab = engine.vocab_size
    for r in reqs:
        if len(r.output) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.output):
            raise AssertionError(f"{r.id}: bad output {r.output}")
    n_tok = sum(len(r.output) for r in reqs)
    ttft = [timeline.first_at[r.id] - timeline.admitted_at[r.id]
            for r in reqs]
    tick_ms = [1e3 * (timeline.done_at[r.id] - timeline.first_at[r.id])
               / max(len(r.output) - 1, 1) for r in reqs]
    return dict(
        sched=sched, launches=launches, pool_bytes=pool_bytes,
        summary=dict(
            tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
            ttft_ms_median=1e3 * float(np.median(ttft)),
            ttft_ms_max=1e3 * float(np.max(ttft)),
            decode_tick_ms_median=float(np.median(tick_ms)),
            decode_ticks=sched.stats["decode_ticks"],
        ),
    )


def _want_paged_launches(run, key: str, engine) -> int:
    """The paged kernel ``key`` launched n_layers × decode ticks times
    and the other paged kernel never."""
    ticks = run["sched"].stats["decode_ticks"]
    want = {k: 0 for k in run["launches"]}
    want[key] = engine.n_layers * ticks
    if run["launches"] != want or want[key] == 0:
        raise AssertionError(
            f"paged kernel launches {run['launches']} over the run; want "
            f"{want} (n_layers × {ticks} decode ticks)")
    return want[key]


def _decision_margin(req, index: int, row: torch.Tensor) -> float:
    """The top-2 margin of what pick ``index`` of ``req`` was decided
    on: the logits, or for a sampled request its scaled logits + noise."""
    if req.temperature > 0:
        noise = gumbel_noise(
            [request_seed(req.seed, req.id, req.token_index0 + index)],
            row.shape[-1])
        row = Sampler.scores(row[None], noise, [req.temperature],
                             [req.top_k])[0]
    top2 = torch.topk(row, 2).values
    return float(top2[0] - top2[1])


def _same_tokens(what: str, a, b, reqs) -> int:
    """The tokens of two recorded runs, request by request: a divergence
    passes only where either run's decision margin at that token is
    below CARD_CPU_MARGIN (and ends that request's comparison).
    Returns the number of requests equal throughout."""
    equal = 0
    for r in reqs:
        ta, tb = a.finished[r.id], b.finished[r.id]
        if len(ta) != len(tb):
            raise AssertionError(f"{what} {r.id}: {len(ta)} vs {len(tb)} "
                                 f"tokens")
        for i, (x, y) in enumerate(zip(ta, tb)):
            if x != y:
                margin = min(_decision_margin(r, i, a.picks[(r.id, i)][0]),
                             _decision_margin(r, i, b.picks[(r.id, i)][0]))
                print(f"{what} {r.id}: diverges at token {i} ({x} vs {y}), "
                      f"decision margin {margin:.3e}")
                if margin >= CARD_CPU_MARGIN:
                    raise AssertionError(
                        f"{what} {r.id}: tokens differ at token {i} with a "
                        f"decision margin {margin} >= {CARD_CPU_MARGIN}")
                break
        else:
            equal += 1
    return equal


def phase_serve(dev: torch.device):
    """The fp32 pool's run; returns its numbers and what the int8 and
    sampled runs reuse (the model, the engine, the prompts, the tokens)."""
    model = TransformerLM(SERVE_CFG, seed=SEED, device=dev)
    engine = PagedServingEngine(model, device=dev, **SERVE_ENGINE)
    rng = np.random.RandomState(SEED + 1)
    vocab = SERVE_CFG["vocab_size"]
    prompts = [
        rng.randint(0, vocab, size=rng.randint(PROMPT_LO, PROMPT_HI + 1))
        .tolist() for _ in range(N_REQUESTS)
    ]
    # warm-up (cuBLAS handles, allocator), outside the counted run
    engine.greedy(prompts[0][:PROMPT_LO], 2)
    torch.cuda.synchronize()

    reqs = [Request(id=f"r{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    run = _serve_run(engine, reqs)
    launches = _want_paged_launches(run, "fp32", engine)
    for r in reqs:
        _oracle_check(model, dev, r)
    out = dict(run["summary"], launches=launches,
               stats=run["sched"].metrics.engine_stats)
    print(f"serve: {N_REQUESTS} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tokens_per_s']:.1f} tokens/s; TTFT "
          f"median {out['ttft_ms_median']:.2f} ms, max "
          f"{out['ttft_ms_max']:.2f} ms; decode tick "
          f"{out['decode_tick_ms_median']:.3f} ms; {out['decode_ticks']} "
          f"decode ticks, {launches} kernel launches; all requests match the "
          f"full-recompute oracle")
    print(f"serve stats: {json.dumps(out['stats'], sort_keys=True)}")
    cpu_model = TransformerLM(SERVE_CFG, seed=SEED, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    ctx = dict(model=model, cpu_model=cpu_model, engine=engine,
               prompts=prompts, tokens={r.id: r.output for r in reqs})
    return out, ctx


def phase_serve_int8(dev: torch.device, ctx) -> dict:
    """The same 8 requests from the int8 KV cache at the fp32 pool's
    bytes (I8_BLOCKS blocks): int8 kernel launches = n_layers × decode
    ticks and no fp32 launch; tokens equal to the CPU int8 engine's on
    the same weights; the reference's kv_quant probe (capacity ratio,
    greedy agreement with the fp32 run); the pool's device bytes."""
    fp32 = ctx["engine"]
    geom = dict(SERVE_ENGINE, n_blocks=I8_BLOCKS)
    engine = PagedServingEngine(ctx["model"], device=dev, kv_dtype="int8",
                                **geom)
    budget = SERVE_ENGINE["n_blocks"] * fp32.kv_block_bytes()
    if engine.blocks_at_budget(budget) != I8_BLOCKS:
        raise AssertionError(
            f"int8 blocks at the fp32 pool's bytes: "
            f"{engine.blocks_at_budget(budget)}, not {I8_BLOCKS}")
    capacity = engine.blocks_at_budget(budget) / fp32.blocks_at_budget(budget)
    engine.greedy(ctx["prompts"][0][:PROMPT_LO], 2)  # warm-up
    torch.cuda.synchronize()

    def requests():
        return [Request(id=f"r{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(ctx["prompts"])]

    reqs = requests()
    run = _serve_run(engine, reqs, record=True)
    launches = _want_paged_launches(run, "int8", engine)
    want_bytes = engine.n_blocks * engine.kv_block_bytes()
    if not 0 <= run["pool_bytes"] - want_bytes <= 4 * 512:
        raise AssertionError(
            f"int8 pool took {run['pool_bytes']} B of device memory; "
            f"n_blocks × kv_block_bytes = {want_bytes}")
    cpu_engine = PagedServingEngine(ctx["cpu_model"], device="cpu",
                                    kv_dtype="int8", **geom)
    t0 = time.perf_counter()
    cpu_run = _serve_run(cpu_engine, requests(), record=True)
    cpu_s = time.perf_counter() - t0
    equal = _same_tokens("int8 card vs cpu", run["sched"], cpu_run["sched"],
                         reqs)
    agree = sum(int(x == y) for r in reqs
                for x, y in zip(r.output, ctx["tokens"][r.id]))
    agreement = agree / sum(len(r.output) for r in reqs)
    if capacity < KV_QUANT_MIN_CAPACITY or agreement < KV_QUANT_MIN_AGREEMENT:
        raise AssertionError(
            f"kv_quant probe: capacity {capacity:.3f} (>= "
            f"{KV_QUANT_MIN_CAPACITY}), greedy agreement with fp32 "
            f"{agreement:.3f} (>= {KV_QUANT_MIN_AGREEMENT})")
    out = dict(run["summary"], launches=launches, n_blocks=I8_BLOCKS,
               capacity_ratio=capacity, greedy_agreement_fp32=agreement,
               requests_equal_to_cpu=equal, pool_bytes=run["pool_bytes"],
               n_blocks_x_kv_block_bytes=want_bytes,
               fp32_pool_bytes=fp32.n_blocks * fp32.kv_block_bytes(),
               cpu_run_s=cpu_s)
    print(f"serve int8: {N_REQUESTS} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tokens_per_s']:.1f} tokens/s; TTFT "
          f"median {out['ttft_ms_median']:.2f} ms; decode tick "
          f"{out['decode_tick_ms_median']:.3f} ms; {out['decode_ticks']} "
          f"decode ticks, {launches} int8 kernel launches, 0 fp32; "
          f"{equal}/{N_REQUESTS} requests equal to the CPU int8 engine's "
          f"({cpu_s:.1f} s on the CPU)")
    print(f"kv_quant: capacity ratio {capacity:.4f} ({I8_BLOCKS} int8 blocks "
          f"in the bytes of {SERVE_ENGINE['n_blocks']} fp32), greedy agreement "
          f"with fp32 {agreement:.4f} ({agree} tokens); pool memory_allocated "
          f"{run['pool_bytes']} B, n_blocks × kv_block_bytes {want_bytes} B "
          f"(fp32 pool {out['fp32_pool_bytes']} B)")
    return out


def phase_serve_sampled(dev: torch.device, ctx) -> dict:
    """N_SAMPLED seeded requests at T 0.8, top-k 50 on the fp32 pool,
    interleaved with two greedy requests, then each alone: the same
    tokens both times, every token inside its row's top-k, and the
    tokens equal to the CPU's."""
    engine = ctx["engine"]
    rng = np.random.RandomState(SEED + 2)
    vocab = SERVE_CFG["vocab_size"]
    prompts = [rng.randint(0, vocab, size=rng.randint(16, 65)).tolist()
               for _ in range(N_SAMPLED)]

    def sampled(ids=range(N_SAMPLED)):
        return [Request(id=f"s{i}", prompt=prompts[i],
                        max_new_tokens=SAMPLED_NEW, temperature=SAMPLED_T,
                        top_k=SAMPLED_TOP_K, seed=SEED + 100 + i)
                for i in ids]

    def mixed():
        greedy = [Request(id=f"g{i}", prompt=ctx["prompts"][i][:48],
                          max_new_tokens=SAMPLED_NEW) for i in range(2)]
        reqs = sampled()
        return reqs[:2] + greedy + reqs[2:]

    reqs = mixed()
    run = _serve_run(engine, reqs, record=True)
    launches = _want_paged_launches(run, "fp32", engine)
    for (rid, _), (row, tok) in run["sched"].picks.items():
        if rid.startswith("s") and row[tok] < torch.topk(
                row, SAMPLED_TOP_K).values[-1]:
            raise AssertionError(f"{rid}: token {tok} outside the top-"
                                 f"{SAMPLED_TOP_K}")
    alone_equal = 0
    for r in sampled():
        one = _serve_run(engine, [r], record=True)
        alone_equal += _same_tokens("sampled alone vs interleaved",
                                    one["sched"], run["sched"], [r])
    cpu_engine = PagedServingEngine(ctx["cpu_model"], device="cpu",
                                    **SERVE_ENGINE)
    cpu_run = _serve_run(cpu_engine, mixed(), record=True)
    cpu_equal = _same_tokens("sampled card vs cpu", run["sched"],
                             cpu_run["sched"], reqs)
    out = dict(run["summary"], launches=launches,
               alone_equal=alone_equal, cpu_equal=cpu_equal,
               requests=len(reqs), sampled=N_SAMPLED)
    print(f"serve sampled: {N_SAMPLED} requests at T {SAMPLED_T}, top-k "
          f"{SAMPLED_TOP_K} (seeded) + 2 greedy; {alone_equal}/{N_SAMPLED} "
          f"equal alone and interleaved; {cpu_equal}/{len(reqs)} equal to the "
          f"CPU's; every sampled token inside its top-{SAMPLED_TOP_K}; "
          f"{launches} kernel launches; {out['tokens_per_s']:.1f} tokens/s")
    return out


def _relu_input(rng, shape, dt, dev) -> torch.Tensor:
    x = torch.from_numpy(np.maximum(rng.randn(*shape), 0).astype(np.float32)
                         * 2.0)
    return x.to(dev).to(dt)


def _check_close(name, got, want, dt, tol=None) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    tol = tol or KERNEL_TOL[dt]
    bad = (g - w).abs() > tol["atol"] + tol["rtol"] * w.abs()
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(
            f"{name} ({dt}): {int(bad.sum())} elements outside "
            f"rtol {tol['rtol']} atol {tol['atol']} of the plain version")
    return float((g - w).abs().max())


def _bound(nbytes: float, ops: float,
           flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    """(least ms, what bounds it): the bytes at the memory rate or the
    operations at the peak for the operands' type, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flop_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_train_kernels(dev: torch.device) -> list:
    """The three training kernels against their plain versions at the
    shapes AlexNet-128 gives them at batch 128, fp32 and bf16."""
    rng = np.random.RandomState(SEED + 2)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = []
    size = LRN_HYPER["size"]
    for shape in LRN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = _relu_input(rng, shape, dt, dev)
            dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                  ).to(dev).to(dt)
            n, es = x.numel(), x.element_size()
            x_nchw = x.permute(0, 3, 1, 2)
            fwd = dict(
                kern=lambda x=x: LR.lrn_fwd(x, **LRN_HYPER),
                plain=lambda x=x: LR.lrn_fwd_plain(x, **LRN_HYPER),
                library=lambda x=x_nchw: torch.nn.functional.
                local_response_norm(x, size, alpha=1e-4 * size, beta=0.75,
                                    k=1.0),
                bytes=2 * n * es, ops=(size + 7) * n)
            bwd = dict(
                kern=lambda x=x, dy=dy: LR.lrn_bwd(x, dy, **LRN_HYPER),
                plain=lambda x=x, dy=dy: LR.lrn_bwd_plain(x, dy, **LRN_HYPER),
                library=None, bytes=3 * n * es, ops=(2 * size + 16) * n)
            for name, d in (("lrn_fwd", fwd), ("lrn_bwd", bwd)):
                err = _check_close(name, d["kern"](), d["plain"](), dt)
                row = dict(name=name, shape=shape, dtype=str(dt)[6:],
                           max_abs_err=err)
                if d["library"] is not None:
                    lib = d["library"]().permute(0, 2, 3, 1)
                    row["library_max_abs_err"] = float(
                        (lib.float() - d["plain"]().float()).abs().max())
                rows.append((row, d))
    for shape in POOL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = _relu_input(rng, shape, dt, dev)
            y = PO.maxpool_fwd(x, 3, 2)
            dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)
                                  ).to(dev).to(dt)
            x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            _, idx = torch.nn.functional.max_pool2d(x_nchw, 3, 2,
                                                    return_indices=True)
            n_in, n_out, es = x.numel(), y.numel(), x.element_size()
            d = dict(
                kern=lambda x=x, y=y, dy=dy: PO.maxpool_bwd(x, y, dy, 3, 2),
                plain=lambda x=x, y=y, dy=dy: PO.maxpool_bwd_plain(
                    x, y, dy, 3, 2),
                library=lambda dy=dy_nchw, x=x_nchw, idx=idx:
                torch.ops.aten.max_pool2d_with_indices_backward(
                    dy, x, [3, 3], [2, 2], [0, 0], [1, 1], False, idx),
                bytes=(2 * n_in + 2 * n_out) * es,
                ops=10 * n_out + 8 * n_in)
            err = _check_close("maxpool_bwd", d["kern"](), d["plain"](), dt)
            rows.append((dict(name="maxpool_bwd", shape=shape,
                              dtype=str(dt)[6:], max_abs_err=err), d))
    for row, d in rows:
        row["ms"] = _time_ms(d["kern"], flush)
        row["plain_ms"] = _time_ms(d["plain"], flush)
        row["library_ms"] = (_time_ms(d["library"], flush)
                             if d["library"] is not None else None)
        row["bound_ms"], row["bound_by"] = _bound(d["bytes"], d["ops"])
        row["bytes"] = d["bytes"]
        lib = (f"{row['library_ms']:.4f} ms" if row["library_ms"] is not None
               else "none")
        print(f"{row['name']} {row['dtype']} {row['shape']}: max|err| "
              f"{row['max_abs_err']:.3e} (tol {KERNEL_TOL[getattr(torch, row['dtype'])]}), "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {lib}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {d['bytes']} B)")
    return [r for r, _ in rows]


def _per_step(rows, name, dtype="bfloat16") -> dict:
    """One kernel's bf16 instances summed over the shapes of one step."""
    mine = [r for r in rows if r["name"] == name and r["dtype"] == dtype]
    libs = [r["library_ms"] for r in mine]
    return dict(
        max_abs_err=max(r["max_abs_err"] for r in mine),
        ms=sum(r["ms"] for r in mine),
        plain_ms=sum(r["plain_ms"] for r in mine),
        bound_ms=sum(r["bound_ms"] for r in mine),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in mine)
                  else "operations"),
        library_ms=None if None in libs else sum(libs),
    )


def phase_train(dev: torch.device) -> dict:
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.alex_net",
              modelclass="AlexNet", model_config=dict(TRAIN_CFG), device=dev)
    model, rec = rule.model, rule.worker.recorder
    if (model.world.backend, model.n_workers) != ("nccl", 1):
        raise AssertionError(f"want an NCCL world of 1, got {model.world}")
    LR.lrn_fwd.launches = LR.lrn_bwd.launches = PO.maxpool_bwd.launches = 0
    t0 = time.perf_counter()
    rule.wait()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lrn_fwd=LR.lrn_fwd.launches, lrn_bwd=LR.lrn_bwd.launches,
                    maxpool_bwd=PO.maxpool_bwd.launches)
    steps = model.data.n_batch_train
    want = dict(lrn_fwd=2 * (steps + N_VAL_BATCHES), lrn_bwd=2 * steps,
                maxpool_bwd=3 * steps)
    if launches != want or steps != TRAIN_CFG["n_synth_batches"]:
        raise AssertionError(
            f"kernel launches over the training run {launches}, want "
            f"{want} ({steps} steps, {N_VAL_BATCHES} validation batches)")
    costs = [r["cost"] for r in rec.history]
    if len(costs) != steps // TRAIN_CFG["print_freq"] or not all(
            np.isfinite(costs)) or not np.isfinite(rec.val_history[-1]["cost"]):
        raise AssertionError(f"bad training record: {rec.history}")
    if not costs[-1] < costs[0]:
        raise AssertionError(f"the loss did not fall: {costs}")
    ips = images_per_sec(model, n_steps=20)
    out = dict(
        steps=steps, wall_s=wall, run_images_per_s=steps * model.global_batch
        / wall, data_wait_s=rec.totals["wait"], calc_s=rec.totals["calc"],
        data_wait_share=rec.totals["wait"] / wall,
        images_per_s=ips, step_ms=1e3 * model.global_batch / ips,
        loss_first=costs[0], loss_last=costs[-1],
        val_loss=rec.val_history[-1]["cost"], launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
    )
    print(f"train: AlexNet-128 bf16, batch {model.global_batch}, {steps} "
          f"steps + {N_VAL_BATCHES} val batches in {wall:.3f} s "
          f"({out['run_images_per_s']:.1f} images/s end to end); host "
          f"waited on data {out['data_wait_s']:.3f} s "
          f"({100 * out['data_wait_share']:.1f} % of the run); "
          f"images_per_sec {ips:.1f}, step {out['step_ms']:.3f} ms; loss "
          f"{costs[0]:.4f} -> {costs[-1]:.4f} (windows of "
          f"{TRAIN_CFG['print_freq']}: {[round(c, 4) for c in costs]}), val "
          f"{out['val_loss']:.4f}; launches {launches}")
    out["profile"] = phase_train_profile(model)
    out["wire_sizes"] = _wire_sizes(model)
    return out


PROFILE_STEPS = 10
# kernel name → part of the step (lower-case substrings, first match)
STEP_PARTS = (
    ("flash attention (kernel)", ("flash_fwd_kernel", "flash_dq_kernel",
                                  "flash_dkv_kernel")),
    ("wire quantize/dequantize (kernel)", ("quant_int8_kernel",
                                           "quant_int8_sr_kernel",
                                           "quant_fp16_kernel",
                                           "dequant_int8_kernel",
                                           "dequant_fp16_kernel")),
    ("memcpy (host<->card; gloo stages the wire)", ("memcpy",)),
    ("lrn (kernel)", ("lrn_fwd_kernel", "lrn_bwd_kernel")),
    ("pool bwd (kernel)", ("maxpool_bwd_kernel",)),
    ("exchange (nccl)", ("nccl",)),
    ("conv/dense (cuDNN/cuBLAS)", ("conv", "cudnn", "xmma", "gemm",
                                   "cutlass", "cublas", "wgrad", "dgrad",
                                   "fprop", "winograd", "fft", "sm90_")),
    ("pool fwd", ("max_pool",)),
)


def _step_part(kernel_name: str) -> str:
    low = kernel_name.lower()
    for part, keys in STEP_PARTS:
        if any(k in low for k in keys):
            return part
    return "other (elementwise, casts, SGD, loss)"


def phase_train_profile(model, label: str = "AlexNet-128") -> dict:
    """Device time of the training step by part, and the device's idle
    share, from ``torch.profiler`` over PROFILE_STEPS steps on
    pre-loaded batches (after the counted run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.data.loader import rank_rows, to_device

    batches = [to_device(rank_rows(b, model.rank, model.n_workers),
                         model.device)
               for b, _ in zip(model.data.train_batches(), range(2))]
    for i in range(3):
        model.train_fn(*batches[i % 2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            model.train_fn(*batches[i % 2])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    parts, by_name = {}, {}
    intervals = []
    for e in kernels:
        us = e.device_time_total
        parts[_step_part(e.name)] = parts.get(_step_part(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        intervals.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    per_step = {k: v / PROFILE_STEPS / 1e3 for k, v in sorted(parts.items())}
    out = dict(
        steps=PROFILE_STEPS, wall_ms_per_step=wall_us / PROFILE_STEPS / 1e3,
        kernel_ms_per_step=per_step,
        device_busy_ms_per_step=busy / PROFILE_STEPS / 1e3,
        device_idle_share=(1.0 - busy / wall_us) if kernels else None,
        kernels_per_step=len(kernels) / PROFILE_STEPS,
        top_kernels_ms_per_step={
            k[:80]: v / PROFILE_STEPS / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]},
    )
    if not kernels:
        print("train profile: torch.profiler recorded no device kernels "
              "(device split not measured)")
        return out
    print(f"{label} train profile ({PROFILE_STEPS} steps, bf16, batch "
          f"{model.batch_size}/rank): {out['wall_ms_per_step']:.3f} ms/step "
          f"under the profiler, device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms/step (idle share "
          f"{out['device_idle_share']:.3f}), "
          f"{out['kernels_per_step']:.0f} kernels/step")
    for part, ms in per_step.items():
        print(f"  {part}: {ms:.4f} ms/step")
    for name, ms in out["top_kernels_ms_per_step"].items():
        print(f"  kernel {name}: {ms:.4f} ms/step")
    return out


def phase_train_oracle(dev: torch.device) -> dict:
    """One fp32 step of the port on the card against the same step on
    the CPU (plain versions), same weights and batch."""
    card = AlexNet(config=dict(ORACLE_CFG), device=dev)
    cpu = AlexNet(config=dict(ORACLE_CFG), device="cpu")
    before = {k: v.detach().cpu().clone() for k, v in card.state_dict().items()}
    cpu.load_state_dict(before)
    rng = np.random.RandomState(SEED + 3)
    x = rng.randn(8, 128, 128, 3).astype(np.float32)
    y = rng.randint(0, 1000, 8).astype(np.int64)
    launches = (LR.lrn_fwd.launches, PO.maxpool_bwd.launches)
    loss_card, _ = card.compile_train()(torch.tensor(x, device=dev),
                                        torch.tensor(y, device=dev))
    loss_cpu, _ = cpu.compile_train()(torch.tensor(x), torch.tensor(y))
    loss_card, loss_cpu = float(loss_card), float(loss_cpu)
    if (LR.lrn_fwd.launches - launches[0],
            PO.maxpool_bwd.launches - launches[1]) != (2, 3):
        raise AssertionError("the card step did not run the kernels")
    worst = 0.0
    after_card, after_cpu = card.state_dict(), cpu.state_dict()
    for k in before:
        upd_cpu = after_cpu[k] - before[k]
        upd_card = after_card[k].cpu() - before[k]
        rel = float((upd_card - upd_cpu).norm() / upd_cpu.norm())
        worst = max(worst, rel)
        if not rel <= ORACLE_UPDATE_RTOL:
            raise AssertionError(f"oracle: {k} update differs by {rel:.3e} "
                                 f"(> {ORACLE_UPDATE_RTOL}) in norm")
    if not abs(loss_card - loss_cpu) <= ORACLE_LOSS_ATOL:
        raise AssertionError(
            f"oracle: loss card {loss_card} vs cpu {loss_cpu}")
    print(f"train oracle (fp32, batch 8, TF32 off): loss card {loss_card:.6f} "
          f"cpu {loss_cpu:.6f} (|diff| {abs(loss_card - loss_cpu):.2e} <= "
          f"{ORACLE_LOSS_ATOL}); worst parameter update ||card-cpu||/||cpu|| "
          f"{worst:.3e} <= {ORACLE_UPDATE_RTOL}")
    return dict(loss_card=loss_card, loss_cpu=loss_cpu,
                worst_update_rel=worst)


def _flash_cost(bh, t, d, causal, esize) -> dict:
    """Bytes (each input read once, each output written once) and
    operations (the products only: 2·d flops per (query, key) pair and
    product; causal counts the pairs on and below the diagonal) of one
    call of each flash kernel."""
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    n, stats = bh * t * d * esize, bh * t * 4
    return dict(flash_fwd=(4 * n + stats, 4 * d * pairs),
                flash_dq=(5 * n + 2 * stats, 6 * d * pairs),
                flash_dkv=(6 * n + 2 * stats, 8 * d * pairs))


def _aten_flash_backward(q4, k4, v4, do4, causal: bool, scale: float):
    """aten's flash-attention backward alone (dQ, dK, dV of (B, H, T, D)
    bf16 views), fed what aten's flash forward returns; its schema,
    positional up to the keyword ``scale``: (grad_out, query, key,
    value, out, logsumexp, cum_seq_q, cum_seq_k, max_q, max_k,
    dropout_p, is_causal, philox_seed, philox_offset)."""
    out, lse, cq, ck, mq, mk, seed, offset, _ = (
        torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, causal, False, scale=scale))

    def bwd():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, out, lse, cq, ck, mq, mk, 0.0, causal, seed,
            offset, scale=scale)
    return bwd


def phase_flash_kernels(dev: torch.device) -> list:
    """The three flash kernels against their plain versions, fp32 and
    bf16, at FLASH_SHAPES; one row per (kernel, shape, dtype)."""
    rng = np.random.RandomState(SEED + 4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = []
    for bh, t, d, causal in FLASH_SHAPES:
        base = [torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
                .to(dev) for _ in range(4)]
        scale = FL.resolve_scale(None, d)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (a.to(dt) for a in base)
            out_p, lse_p = FL.flash_fwd_plain(q, k, v, causal, scale)
            delta = (do.float() * out_p.float()).sum(dim=-1)
            bwd = (q, k, v, do, lse_p, delta, causal, scale)
            tol = FLASH_TOL[dt]
            out_k, lse_k = FL.flash_fwd(q, k, v, causal, scale)
            instance = dict(flash_fwd=FL.flash_fwd_instance(
                dt, d, [a.data_ptr() for a in (q, k, v, out_k)]))
            err_f = max(_check_close("flash_fwd out", out_k, out_p, dt, tol),
                        _check_close("flash_fwd lse", lse_k, lse_p, dt,
                                     LSE_TOL))
            dq_k = FL.flash_dq(*bwd)
            err_q = _check_close("flash_dq", dq_k, FL.flash_dq_plain(*bwd),
                                 dt, tol)
            dk_k, dv_k = FL.flash_dkv(*bwd)
            dk_p, dv_p = FL.flash_dkv_plain(*bwd)
            instance["flash_dq"] = FL.flash_bwd_instance(
                dt, d, [a.data_ptr() for a in (q, k, v, do, dq_k)])
            instance["flash_dkv"] = FL.flash_bwd_instance(
                dt, d, [a.data_ptr() for a in (q, k, v, do, dk_k, dv_k)])
            # fresh allocations lie on 16 bytes: the instance goes by
            # dtype and D (the LM's rows take wgmma for all three)
            want = ("simt" if dt != torch.bfloat16 or d > 64
                    else "wgmma" if d % 8 == 0 else "mma")
            if set(instance.values()) != {want}:
                raise AssertionError(f"flash (bh {bh}, T {t}, D {d}, {dt}): "
                                     f"instances {instance}, want {want}")
            err_kv = max(_check_close("flash_dkv dk", dk_k, dk_p, dt, tol),
                         _check_close("flash_dkv dv", dv_k, dv_p, dt, tol))
            # one-call yardsticks over (1, B·H, T, D) views: SDPA's
            # forward, and (bf16) aten's flash backward alone, fed the
            # outputs of aten's flash forward
            q4, k4, v4, do4 = (a.view(1, bh, t, d) for a in (q, k, v, do))

            def sdpa(q4=q4, k4=k4, v4=v4):
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=scale)

            lib_err = float((sdpa()[0].float() - out_p.float()).abs().max())
            lib_fwd = _time_ms(sdpa, flush)
            lib_bwd = (_time_ms(_aten_flash_backward(q4, k4, v4, do4, causal,
                                                     scale), flush)
                       if dt == torch.bfloat16 else None)
            cost = _flash_cost(bh, t, d, causal, q.element_size())
            peak = BF16_FLOP_PER_S if dt == torch.bfloat16 else FP32_FLOP_PER_S
            for name, kern, plain, err, lib in (
                ("flash_fwd", lambda: FL.flash_fwd(q, k, v, causal, scale),
                 lambda: FL.flash_fwd_plain(q, k, v, causal, scale), err_f,
                 lib_fwd),
                ("flash_dq", lambda: FL.flash_dq(*bwd),
                 lambda: FL.flash_dq_plain(*bwd), err_q, lib_bwd),
                ("flash_dkv", lambda: FL.flash_dkv(*bwd),
                 lambda: FL.flash_dkv_plain(*bwd), err_kv, None),
            ):
                nbytes, ops = cost[name]
                bound_ms, bound_by = _bound(nbytes, ops, peak)
                row = dict(name=name, shape=(bh, t, d), causal=causal,
                           dtype=str(dt)[6:], instance=instance[name],
                           max_abs_err=err,
                           ms=_time_ms(kern, flush),
                           plain_ms=_time_ms(plain, flush),
                           library_ms=lib, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes, ops=ops,
                           sdpa_max_abs_err=lib_err)
                rows.append(row)
                lib_s = f"{lib:.4f} ms" if lib is not None else "none"
                print(f"{name} {row['dtype']} (bh {bh}, T {t}, D {d}, "
                      f"causal {causal}, instance {instance[name]}): max|err| "
                      f"{err:.3e} (tol "
                      f"{tol}), kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, library {lib_s}, bound "
                      f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
                      f"{ops / 1e9:.3f} GFLOP)")
            bwd_s = (f"{lib_bwd:.4f} ms (dQ, dK, dV in one call: the "
                     f"flash_dq row's library_ms)" if lib_bwd is not None
                     else "not timed (aten's flash backward takes fp16/bf16)")
            print(f"  sdpa {row['dtype']} (bh {bh}, T {t}, D {d}): forward "
                  f"{lib_fwd:.4f} ms, aten flash backward alone {bwd_s}, "
                  f"max|err| vs plain {lib_err:.3e}")
    return rows


def _flash_bwd_edge(what, args, want, dt) -> float:
    """dQ and dK/dV on ``args`` against their plain versions; asserts
    that both run the ``want`` instance.  Returns the largest error."""
    dq = FL.flash_dq(*args)
    dk, dv = FL.flash_dkv(*args)
    q, k, v, do = args[:4]
    for name, outs in (("flash_dq", (dq,)), ("flash_dkv", (dk, dv))):
        inst = FL.flash_bwd_instance(
            dt, q.shape[-1], [a.data_ptr() for a in (q, k, v, do, *outs)])
        if inst != want:
            raise AssertionError(f"{name} {what}: instance {inst}, want "
                                 f"{want}")
    dk_p, dv_p = FL.flash_dkv_plain(*args)
    return max(
        _check_close(f"flash_dq {what}", dq, FL.flash_dq_plain(*args), dt,
                     FLASH_TOL[dt]),
        _check_close(f"flash_dkv dk {what}", dk, dk_p, dt, FLASH_TOL[dt]),
        _check_close(f"flash_dkv dv {what}", dv, dv_p, dt, FLASH_TOL[dt]))


def phase_flash_edges(dev: torch.device) -> dict:
    """The bf16 forward, dQ and dK/dV against their plain versions at T
    in FLASH_EDGE_T, D in FLASH_EDGE_D, causal and full (3 rows of
    (batch, head)), and with q at a storage offset of one element;
    asserts the instance each case runs.  Then dQ and dK/dV at
    FLASH_BWD_MANY, causal and full (several items a CTA)."""
    rng = np.random.RandomState(SEED + 6)
    dt, bh, worst, worst_bwd, n = torch.bfloat16, 3, 0.0, 0.0, 0
    seen = set()
    for t in FLASH_EDGE_T:
        for d in FLASH_EDGE_D:
            q, k, v, do = (torch.from_numpy(rng.randn(bh, t, d).astype(
                np.float32)).to(dev).to(dt) for _ in range(4))
            shifted = torch.empty(q.numel() + 1, dtype=dt, device=dev)[1:]
            shifted = shifted.view(q.shape).copy_(q)
            scale = FL.resolve_scale(None, d)
            for causal in (False, True):
                for label, qq in (("aligned", q), ("q off 16 B", shifted)):
                    out_p, lse_p = FL.flash_fwd_plain(qq, k, v, causal, scale)
                    out_k, lse_k = FL.flash_fwd(qq, k, v, causal, scale)
                    inst = FL.flash_fwd_instance(
                        dt, d, [a.data_ptr() for a in (qq, k, v, out_k)])
                    want = ("wgmma" if d % 8 == 0 and label == "aligned"
                            else "mma")
                    if inst != want:
                        raise AssertionError(
                            f"flash_fwd T {t} D {d} {label}: instance {inst},"
                            f" want {want}")
                    what = f"edge T {t} D {d} causal {causal} {label}"
                    worst = max(worst,
                                _check_close(f"flash_fwd {what} out", out_k,
                                             out_p, dt, FLASH_TOL[dt]),
                                _check_close(f"flash_fwd {what} lse", lse_k,
                                             lse_p, dt, LSE_TOL))
                    delta = (do.float() * out_p.float()).sum(dim=-1)
                    worst_bwd = max(worst_bwd, _flash_bwd_edge(
                        what, (qq, k, v, do, lse_p, delta, causal, scale),
                        want, dt))
                    seen.add(inst)
                    n += 1
    print(f"flash edges: {n} cases each of flash_fwd, flash_dq and "
          f"flash_dkv (T {FLASH_EDGE_T}, D {FLASH_EDGE_D}, causal and full, "
          f"aligned and q off 16 B; instances {sorted(seen)}) within "
          f"{FLASH_TOL[dt]} / lse {LSE_TOL}, max|err| fwd {worst:.3e}, "
          f"bwd {worst_bwd:.3e}")
    n_many = 0
    for bh_, t, d in FLASH_BWD_MANY:
        q, k, v, do = (torch.from_numpy(rng.randn(bh_, t, d).astype(
            np.float32)).to(dev).to(dt) for _ in range(4))
        scale = FL.resolve_scale(None, d)
        for causal in (False, True):
            out_p, lse_p = FL.flash_fwd_plain(q, k, v, causal, scale)
            delta = (do.float() * out_p.float()).sum(dim=-1)
            worst_bwd = max(worst_bwd, _flash_bwd_edge(
                f"B.H {bh_} T {t} D {d} causal {causal}",
                (q, k, v, do, lse_p, delta, causal, scale), "wgmma", dt))
            n_many += 1
    print(f"flash_dq / flash_dkv at {FLASH_BWD_MANY} (B.H, T, D), causal "
          f"and full: {n_many} cases, instance wgmma, within "
          f"{FLASH_TOL[dt]}; max|err| bwd over all edges {worst_bwd:.3e}")
    return dict(cases=n, bwd_many_cases=n_many, max_abs_err=worst,
                bwd_max_abs_err=worst_bwd, instances=sorted(seen))


def _pool_edge_case(dev, rng, shape, window, stride, dt, shift=False):
    levels = np.asarray(POOL_EDGE_LEVELS, np.float32)
    x = torch.from_numpy(levels[rng.randint(0, len(levels), size=shape)])
    x = x.to(dev).to(dt)
    if shift:  # x at a storage offset of one element: off 16 bytes
        x = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:].view(
            x.shape).copy_(x)
    y = PO.maxpool_fwd(x, window, stride)
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).to(dev)
    dy = dy.to(dt)
    dx = torch.empty_like(x)
    plan = PO.plan_maxpool_bwd(tuple(x.shape), window, stride,
                               x.element_size(),
                               all(a.data_ptr() % 16 == 0
                                   for a in (x, y, dy, dx)))
    what = f"maxpool_bwd edge {tuple(shape)} {window}/{stride} shift {shift}"
    err = _check_close(what, PO.maxpool_bwd(x, y, dy, window, stride),
                       PO.maxpool_bwd_plain(x, y, dy, window, stride), dt)
    return err, plan


def phase_pool_edges(dev: torch.device) -> dict:
    """The max-pool backward against its plain version, fp32 and bf16,
    at POOL_EDGE_C × POOL_EDGE_WINDOWS on (2, 9, 11, C), x from four
    levels; C = 96 with x off 16 bytes; POOL_EDGE_WIDE (column bands).
    Asserts the vector or scalar path the plan picks."""
    rng = np.random.RandomState(SEED + 7)
    worst, n, paths = 0.0, 0, set()
    for c in POOL_EDGE_C:
        for window, stride in POOL_EDGE_WINDOWS:
            for dt in (torch.float32, torch.bfloat16):
                for shift in ((False, True) if c == 96 else (False,)):
                    err, plan = _pool_edge_case(
                        dev, rng, (2, *POOL_EDGE_HW, c), window, stride, dt,
                        shift)
                    itemsize = torch.finfo(dt).bits // 8
                    want = c * itemsize % 16 == 0 and not shift
                    if plan.vec != want:
                        raise AssertionError(
                            f"maxpool_bwd C {c} shift {shift}: vec "
                            f"{plan.vec}, want {want}")
                    worst, n = max(worst, err), n + 1
                    paths.add("vector" if plan.vec else "scalar")
    err, plan = _pool_edge_case(dev, rng, POOL_EDGE_WIDE, 3, 2,
                                torch.bfloat16)
    if plan.n_bands[1] < 2:
        raise AssertionError(f"{POOL_EDGE_WIDE}: want column bands, got "
                             f"{plan}")
    worst, n = max(worst, err), n + 1
    print(f"maxpool_bwd edges: {n} cases (C {POOL_EDGE_C}, windows "
          f"{POOL_EDGE_WINDOWS}, H x W {POOL_EDGE_HW}, levels "
          f"{POOL_EDGE_LEVELS}, x off 16 B at C 96, {POOL_EDGE_WIDE} in "
          f"{plan.n_bands} bands; paths {sorted(paths)}) within KERNEL_TOL, "
          f"max|err| {worst:.3e}")
    return dict(cases=n, max_abs_err=worst, paths=sorted(paths))


def _flash_per_step(rows, name, n_layers) -> dict:
    """The LM path's instance (bf16, B·H 64, T 1024, D 64, causal) of
    one flash kernel, times n_layers: its launches in one step."""
    (r,) = [r for r in rows if r["name"] == name and r["dtype"] == "bfloat16"
            and r["shape"] == FLASH_SHAPES[0][:3]]
    return dict(
        max_abs_err=r["max_abs_err"], ms=n_layers * r["ms"],
        plain_ms=n_layers * r["plain_ms"], bound_ms=n_layers * r["bound_ms"],
        bound_by=r["bound_by"],
        library_ms=(None if r["library_ms"] is None
                    else n_layers * r["library_ms"]),
    )


def _flash_launches() -> dict:
    return dict(flash_fwd=FL.flash_fwd.launches, flash_dq=FL.flash_dq.launches,
                flash_dkv=FL.flash_dkv.launches)


def phase_lm_train(dev: torch.device) -> dict:
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.transformer",
              modelclass="TransformerLM", model_config=dict(LM_CFG),
              device=dev)
    model, rec = rule.model, rule.worker.recorder
    if (model.world.backend, model.n_workers) != ("nccl", 1):
        raise AssertionError(f"want an NCCL world of 1, got {model.world}")
    torch.cuda.reset_peak_memory_stats(dev)
    FL.flash_fwd.launches = FL.flash_dq.launches = FL.flash_dkv.launches = 0
    t0 = time.perf_counter()
    rule.wait()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_launches()
    steps, n_val = model.data.n_batch_train, model.data.n_batch_val
    layers = model.n_layers
    want = dict(flash_fwd=layers * (steps + n_val), flash_dq=layers * steps,
                flash_dkv=layers * steps)
    if (launches != want or steps != LM_CFG["n_synth_train"]
            or n_val != LM_CFG["n_synth_val"]):
        raise AssertionError(
            f"flash launches over the LM run {launches}, want {want} "
            f"({steps} steps, {n_val} validation batches, {layers} layers)")
    costs = [r["cost"] for r in rec.history]
    if len(costs) != steps // LM_CFG["print_freq"] or not all(
            np.isfinite(costs)) or not np.isfinite(rec.val_history[-1]["cost"]):
        raise AssertionError(f"bad LM training record: {rec.history}")
    if not costs[-1] < costs[0]:
        raise AssertionError(f"the LM loss did not fall: {costs}")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_s = measure_step_time(model, n_steps=10, warmup=2)
    tokens = model.global_batch * int(model.config.seq_len)
    out = dict(
        steps=steps, val_batches=n_val, wall_s=wall,
        run_tokens_per_s=steps * tokens / wall,
        data_wait_s=rec.totals["wait"], calc_s=rec.totals["calc"],
        data_wait_share=rec.totals["wait"] / wall,
        step_ms=1e3 * step_s, tokens_per_s=tokens / step_s,
        loss_first=costs[0], loss_last=costs[-1],
        val_loss=rec.val_history[-1]["cost"],
        val_err5=rec.val_history[-1]["error_top5"], launches=launches,
        peak_mem_gib=peak_gib,
    )
    cfg = model.config
    print(f"LM train: TransformerLM d{cfg.d_model} h{cfg.n_heads} L{layers} "
          f"V{cfg.vocab_size} T{cfg.seq_len} {cfg.compute_dtype} "
          f"{cfg.attn_impl}, batch {model.global_batch}, {steps} steps + "
          f"{n_val} val "
          f"batches in {wall:.3f} s ({out['run_tokens_per_s']:.1f} tokens/s "
          f"end to end); host waited on data {out['data_wait_s']:.3f} s "
          f"({100 * out['data_wait_share']:.1f} % of the run); step "
          f"{out['step_ms']:.3f} ms = {out['tokens_per_s']:.1f} tokens/s "
          f"(measure_step_time); loss {costs[0]:.4f} -> {costs[-1]:.4f} "
          f"(windows of {LM_CFG['print_freq']}: "
          f"{[round(c, 4) for c in costs]}), val {out['val_loss']:.4f}; "
          f"launches {launches}; peak {peak_gib:.2f} GiB")
    out["profile"] = phase_train_profile(model, "LM")
    out["wire_sizes"] = _wire_sizes(model)
    return out


def phase_lm_oracle(dev: torch.device) -> dict:
    """One fp32 LM step (flash) on the card against the same step on
    the CPU (plain versions), same weights and batch."""
    card = TransformerLM(config=dict(LM_ORACLE_CFG), device=dev)
    cpu = TransformerLM(config=dict(LM_ORACLE_CFG), device="cpu")
    before = {k: v.detach().cpu().clone() for k, v in card.state_dict().items()}
    cpu.load_state_dict(before)
    rng = np.random.RandomState(SEED + 5)
    vocab, t = LM_ORACLE_CFG["vocab_size"], LM_ORACLE_CFG["seq_len"]
    x = rng.randint(0, vocab, size=(2, t)).astype(np.int32)
    y = rng.randint(0, vocab, size=(2, t)).astype(np.int32)
    launches = _flash_launches()
    loss_card, _ = card.compile_train()(torch.tensor(x, device=dev),
                                        torch.tensor(y, device=dev))
    loss_card = float(loss_card)
    ran = {k: v - launches[k] for k, v in _flash_launches().items()}
    loss_cpu = float(cpu.compile_train()(torch.tensor(x), torch.tensor(y))[0])
    layers = card.n_layers
    if ran != dict(flash_fwd=layers, flash_dq=layers, flash_dkv=layers):
        raise AssertionError(f"the card step did not run the kernels: {ran}")
    # the CPU's own spread: the same step on one thread
    threads = torch.get_num_threads()
    cpu1 = TransformerLM(config=dict(LM_ORACLE_CFG), device="cpu")
    cpu1.load_state_dict(before)
    torch.set_num_threads(1)
    try:
        cpu1.compile_train()(torch.tensor(x), torch.tensor(y))
    finally:
        torch.set_num_threads(threads)
    after_cpu = cpu.state_dict()

    def rel_updates(after):
        out = {}
        for k in before:
            upd_cpu = after_cpu[k] - before[k]
            upd = after[k].cpu() - before[k]
            out[k] = float((upd - upd_cpu).norm() / upd_cpu.norm())
        return out

    rel, spread = rel_updates(card.state_dict()), rel_updates(cpu1.state_dict())
    worst_key = max(rel, key=rel.get)
    spread_key = max(spread, key=spread.get)
    print(f"LM train oracle (fp32, batch 2, T {t}, flash, TF32 off): loss "
          f"card {loss_card:.6f} cpu {loss_cpu:.6f} (|diff| "
          f"{abs(loss_card - loss_cpu):.2e}, tol {LM_ORACLE_LOSS_ATOL}); "
          f"worst parameter update ||card-cpu||/||cpu|| {rel[worst_key]:.3e} "
          f"({worst_key}; tol {LM_ORACLE_UPDATE_RTOL}); the CPU at 1 vs "
          f"{threads} threads: worst {spread[spread_key]:.3e} ({spread_key})")
    bad = [k for k, r in rel.items() if not r <= LM_ORACLE_UPDATE_RTOL]
    if bad:
        raise AssertionError(f"LM oracle: updates differ in norm beyond "
                             f"{LM_ORACLE_UPDATE_RTOL}: "
                             f"{ {k: rel[k] for k in bad} }")
    if not abs(loss_card - loss_cpu) <= LM_ORACLE_LOSS_ATOL:
        raise AssertionError(
            f"LM oracle: loss card {loss_card} vs cpu {loss_cpu}")
    return dict(loss_card=loss_card, loss_cpu=loss_cpu,
                worst_update_rel=rel[worst_key], worst_update_key=worst_key,
                cpu_thread_spread=spread[spread_key],
                cpu_thread_spread_key=spread_key)


def _wire_sizes(model) -> list:
    """Flat fp32 lengths of the exchange's buckets for ``model``'s
    parameters (its bucket size, the reference's order)."""
    order = model.exchange_order
    ex = BSP_Exchanger("int8_sr", bucket_bytes=int(
        float(model.config.exchange_bucket_mb) * (1 << 20)))
    return ex.unit_sizes([model.params[i] for i in order],
                         [model.param_names[i] for i in order])


def _wire_launch_rows(sizes, strategy: str) -> dict:
    """Rows of every launch one step gives each wire kernel at a world
    of WIRE_WORLD: per live bucket, leg 1 quantizes (world·nb) rows and
    leg 2 nb rows, and both legs dequantize (world·nb) rows."""
    quant, deq = [], []
    for n in sizes:
        nb = blocks_per_shard(n, WIRE_WORLD, strategy)
        if nb is not None:
            quant += [WIRE_WORLD * nb, nb]
            deq += [WIRE_WORLD * nb, WIRE_WORLD * nb]
    return dict(quant=quant, dequant=deq)


def _wire_input(rows: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Gradient-like fp32 blocks: normal values with block magnitudes
    over six decades, a zero block, and a block of half-way ties
    (amax 127 pins the int8 scale at 1, the other values k + 0.5)."""
    x = torch.randn(rows, Q.BLOCK, generator=gen, device=dev)
    x *= 10.0 ** torch.empty(rows, 1, device=dev).uniform_(-6, 0,
                                                           generator=gen)
    x[0] = 0.0
    if rows > 1:
        x[1] = (torch.arange(Q.BLOCK, device=dev) - 128) + 0.5
        x[1, 0] = 127.0
    return x


_WIRE_QUANT = (
    ("block_quant_int8", Q.quantize_int8, Q.quantize_int8_plain),
    ("block_quant_int8_sr", lambda x: Q.quantize_int8_sr(x, WIRE_SEED),
     lambda x: Q.quantize_int8_sr_plain(x, WIRE_SEED)),
    ("block_quant_fp16", Q.quantize_fp16, Q.quantize_fp16_plain),
)


def _wire_exact(x: torch.Tensor, where: str) -> dict:
    """Every wire kernel against its plain version on ``x``: payloads,
    scales and dequantized values must be equal.  Returns name → max
    |kernel − plain| (0 when equal)."""
    errs = {}
    for name, kern, plain in _WIRE_QUANT:
        qk, sk = kern(x)
        qp, sp = plain(x)
        dk, dp = Q.dequantize(qk, sk), Q.dequantize_plain(qk, sk)
        torch.cuda.synchronize()
        if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
            raise AssertionError(
                f"{name} at {tuple(x.shape)} ({where}): kernel != plain, "
                f"{int((qk != qp).sum())} payload and {int((sk != sp).sum())}"
                f" scale elements differ")
        if not torch.equal(dk, dp):
            raise AssertionError(f"block_dequant of {name}'s payload at "
                                 f"{tuple(x.shape)} ({where}): kernel != "
                                 "plain")
        errs[name] = max(errs.get(name, 0.0),
                         float((qk.float() - qp.float()).abs().max()),
                         float((sk - sp).abs().max()))
        errs["block_dequant"] = max(errs.get("block_dequant", 0.0),
                                    float((dk - dp).abs().max()))
    return errs


def _wire_bytes(name: str, n: int) -> int:
    """Bytes each input read once and each output written once: fp32
    in, int8 (fp16) payload and one fp32 scale per 256 out; dequantize
    reads the int8 payload of the int8_sr wire."""
    if name == "block_quant_fp16":
        return 4 * n + 2 * n + n // 64
    return 4 * n + n + n // 64


def phase_wire_kernels(dev: torch.device, lm_sizes, alex_sizes) -> list:
    """The four wire kernels against their plain versions, exact, at
    the LM's 4 MB bucket (world 2) and at AlexNet-128's largest bucket,
    then their times per call and per LM step at a world of 2."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    errs = {}
    n_lm = 4 << 20 >> 2  # one 4 MB bucket of fp32
    nb_lm = blocks_per_shard(n_lm, WIRE_WORLD, "int8_sr")
    n_alex = max(alex_sizes)
    nb_alex = blocks_per_shard(n_alex, WIRE_WORLD, "int8_sr")
    for where, nb in (("LM 4 MB bucket", nb_lm),
                      (f"AlexNet-128 largest bucket, {n_alex} fp32", nb_alex)):
        for shape in ((WIRE_WORLD, nb, Q.BLOCK), (nb, Q.BLOCK)):
            x = _wire_input(WIRE_WORLD * nb if len(shape) == 3 else nb,
                            gen, dev).view(shape)
            for k, v in _wire_exact(x, where).items():
                errs[k] = max(errs.get(k, 0.0), v)
            print(f"wire kernels at {shape} ({where}): int8, int8_sr (seed "
                  f"{WIRE_SEED:#x}), fp16 payloads, scales and dequantized "
                  "values equal to the plain versions")
    step_rows = _wire_launch_rows(lm_sizes, "int8_sr")
    per_rows = {}
    big = WIRE_WORLD * nb_lm  # the per-call shape: one bucket's leg 1
    for r in sorted(set(step_rows["quant"]) | set(step_rows["dequant"])
                    | {big}):
        x = _wire_input(r, gen, dev)
        q8, s8 = Q.quantize_int8(x)
        calls = {
            "block_quant_int8": (lambda x=x: Q.quantize_int8(x),
                                 lambda x=x: Q.quantize_int8_plain(x)),
            "block_quant_int8_sr": (
                lambda x=x: Q.quantize_int8_sr(x, WIRE_SEED),
                lambda x=x: Q.quantize_int8_sr_plain(x, WIRE_SEED)),
            "block_quant_fp16": (lambda x=x: Q.quantize_fp16(x),
                                 lambda x=x: Q.quantize_fp16_plain(x)),
            "block_dequant": (lambda q=q8, s=s8: Q.dequantize(q, s),
                              lambda q=q8, s=s8: Q.dequantize_plain(q, s)),
        }
        per_rows[r] = {name: (_time_ms(k, flush), _time_ms(p, flush))
                       for name, (k, p) in calls.items()}
    rows = []
    for name in ("block_quant_int8", "block_quant_int8_sr",
                 "block_quant_fp16", "block_dequant"):
        launch_rows = step_rows["dequant" if name == "block_dequant"
                                else "quant"]
        ms = sum(per_rows[r][name][0] for r in launch_rows)
        plain_ms = sum(per_rows[r][name][1] for r in launch_rows)
        nbytes = sum(_wire_bytes(name, r * Q.BLOCK) for r in launch_rows)
        ops = sum(WIRE_OPS[name] * r * Q.BLOCK for r in launch_rows)
        bound_ms, bound_by = _bound(nbytes, ops)
        call_bound, _ = _bound(_wire_bytes(name, big * Q.BLOCK),
                               WIRE_OPS[name] * big * Q.BLOCK)
        row = dict(name=name, max_abs_err=errs[name], ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None, launches_per_step=len(launch_rows),
                   bytes_per_step=nbytes, call_rows=big,
                   call_ms=per_rows[big][name][0],
                   call_plain_ms=per_rows[big][name][1],
                   call_bound_ms=call_bound)
        rows.append(row)
        print(f"{name}: max|err| {row['max_abs_err']:.1e} (exact); per call "
              f"at ({big}, 256): kernel {row['call_ms']:.4f} ms, plain "
              f"{row['call_plain_ms']:.4f} ms, bound {call_bound:.4f} ms; "
              f"per LM step at world {WIRE_WORLD} ({len(launch_rows)} "
              f"launches): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B); library "
              "none (no one PyTorch call quantizes per 256-block amax)")
    return rows


def _params_digest(model) -> str:
    h = hashlib.sha1()
    for p in model.params:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _bsp2_rank(out_path: str) -> int:
    """One rank of phase 12 (``--bsp2-rank OUT``): the LM's BSP run at a
    world of 2 with the default wire, then the checks' measurements;
    writes a JSON record to OUT."""
    from theanompi_tpu_torch.data.loader import rank_rows, to_device

    rule = BSP()
    rule.init(devices=WIRE_WORLD,
              modelfile="theanompi_tpu_torch.models.transformer",
              modelclass="TransformerLM", model_config=dict(BSP2_CFG))
    model, rec = rule.model, rule.worker.recorder
    dev = model.device
    res = dict(rank=model.rank, world=model.n_workers,
               backend=model.world.backend, device=str(dev),
               strategy=model.config.exch_strategy,
               wire_sizes=_wire_sizes(model))
    torch.cuda.reset_peak_memory_stats(dev)
    Q.reset_launches()
    FL.flash_fwd.launches = FL.flash_dq.launches = FL.flash_dkv.launches = 0
    t0 = time.perf_counter()
    rule.wait()
    torch.cuda.synchronize()
    res.update(wall_s=time.perf_counter() - t0, launches=Q.launches(),
               flash_launches=_flash_launches(),
               steps=model.data.n_batch_train,
               costs=[r["cost"] for r in rec.history],
               val_cost=rec.val_history[-1]["cost"],
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               params_sha1=_params_digest(model))
    step_s = measure_step_time(model, n_steps=5, warmup=1)
    # the wire alone on one step's gradients, and the SR bound on its
    # first bucket against the fp32 all_reduce mean
    order = model.exchange_order
    names = [model.param_names[i] for i in order]
    x, y = to_device(rank_rows(next(iter(model.data.train_batches())),
                               model.rank, model.n_workers), dev)
    loss, _ = model.loss_and_metrics(x, y, True)
    grads = torch.autograd.grad(loss, model.params)
    g = [grads[i] for i in order]
    ex = model.exchanger
    seeds = torch.randint(0, 1 << 32, (len(ex.unit_sizes(g, names)), 2),
                          generator=model.wire_generator).tolist()
    ex.reduce_grads(g, names, seeds)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        ex.reduce_grads(g, names, seeds)
    torch.cuda.synchronize()
    wire_s = (time.perf_counter() - t0) / 5
    first = g[0].float()
    red = ex.reduce_grads([first], names[:1], seeds[:1])[0]
    mean = first.clone()
    dist.all_reduce(mean)
    mean /= model.n_workers
    gmax = first.abs().max().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX)
    res.update(step_ms=1e3 * step_s, wire_ms=1e3 * wire_s,
               wire_share=wire_s / step_s,
               sr_check=dict(name=names[0], n=first.numel(),
                             max_err=float((red - mean).abs().max()),
                             atol=float(2.0 * gmax[0] / 127.0),
                             inexact=int((red != mean).sum()),
                             sha1=hashlib.sha1(red.cpu().numpy().tobytes())
                             .hexdigest()))
    res["profile"] = phase_train_profile(
        model, f"LM world {WIRE_WORLD} rank {model.rank}")
    res["more"] = {}
    for label, over in BSP2_MORE:
        model.config.update(over)
        model.train_fn = None
        model.compile_train()
        Q.reset_launches()
        for c in range(BSP2_MORE_STEPS):
            loss, _ = model.train_iter(c, rec)
        torch.cuda.synchronize()
        res["more"][label] = dict(launches=Q.launches(), loss=float(loss),
                                  strategy=model.config.exch_strategy,
                                  params_sha1=_params_digest(model))
    with open(out_path, "w") as f:
        json.dump(res, f)
    destroy_process_group()
    return 0


def _want_launches(sizes, strategy: str, steps: int, ef: bool) -> dict:
    """Launch counts the bucket plan predicts over ``steps`` steps: 2
    quantizes and 2 dequantizes per live bucket and step, and with
    error feedback one more dequantize (the leg-1 image)."""
    live = sum(blocks_per_shard(n, WIRE_WORLD, strategy) is not None
               for n in sizes)
    quant = {"int8_sr": "quantize_int8_sr", "pallas_int8_sr":
             "quantize_int8_sr", "fp16s": "quantize_fp16",
             "pallas_fp16s": "quantize_fp16"}.get(strategy, "quantize_int8")
    want = dict(quantize_int8=0, quantize_int8_sr=0, quantize_fp16=0,
                dequantize=(3 if ef else 2) * live * steps)
    want[quant] = 2 * live * steps
    return want


def phase_lm_bsp2(dev: torch.device) -> dict:
    """Two ranks of the LM on this card over gloo; see phase 12."""
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bsp2_")
    env = dict(os.environ, WORLD_SIZE=str(WIRE_WORLD), LOCAL_RANK="0",
               LOCAL_WORLD_SIZE=str(WIRE_WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(WIRE_WORLD)]
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(WIRE_WORLD)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(WIRE_WORLD):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--bsp2-rank", outs[r]],
                    env=dict(env, RANK=str(r)), stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + BSP2_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        for r, path in enumerate(logs):
            with open(path) as f:
                print(f"--- rank {r} (exit {procs[r].returncode}):\n"
                      + f.read()[-4000:])
        raise AssertionError("a rank of the two-rank LM run failed")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    r0 = res[0]
    for r in res:
        if (r["backend"], r["device"], r["world"], r["strategy"]) != (
                "gloo", BSP2_DEVICE, WIRE_WORLD, "int8_sr"):
            raise AssertionError(f"rank {r['rank']}: {r['backend']} on "
                                 f"{r['device']}, world {r['world']}, "
                                 f"{r['strategy']}")
    sizes, steps = r0["wire_sizes"], r0["steps"]
    want = _want_launches(sizes, "int8_sr", steps, ef=False)
    layers = SERVE_CFG["n_layers"]
    want_flash = dict(flash_fwd=layers * (steps + 1), flash_dq=layers * steps,
                      flash_dkv=layers * steps)
    for r in res:
        if (r["launches"] != want or r["flash_launches"] != want_flash
                or r["steps"] != BSP2_CFG["n_synth_train"]):
            raise AssertionError(
                f"rank {r['rank']}: launches {r['launches']} "
                f"{r['flash_launches']}, want {want} {want_flash} "
                f"({r['steps']} steps, {len(sizes)} buckets)")
        costs = r["costs"]
        if (len(costs) != steps // BSP2_CFG["print_freq"]
                or not all(np.isfinite(costs))
                or not np.isfinite(r["val_cost"]) or not costs[-1] < costs[0]):
            raise AssertionError(f"rank {r['rank']}: bad or flat loss "
                                 f"{costs}, val {r['val_cost']}")
        sr = r["sr_check"]
        if not sr["max_err"] <= sr["atol"] or sr["inexact"] == 0:
            raise AssertionError(f"rank {r['rank']}: int8_sr mean vs the "
                                 f"fp32 mean: {sr}")
    if len({r["params_sha1"] for r in res}) != 1 or len(
            {r["sr_check"]["sha1"] for r in res}) != 1:
        raise AssertionError("the ranks' parameters (or reduced gradients) "
                             "differ after the int8_sr run")
    for label, over in BSP2_MORE:
        strategy = over["exch_strategy"]
        w = _want_launches(sizes, strategy, BSP2_MORE_STEPS,
                           ef=bool(over.get("error_feedback")))
        got = [r["more"][label] for r in res]
        if any(g["launches"] != w or g["strategy"] != strategy
               or not np.isfinite(g["loss"]) for g in got):
            raise AssertionError(f"{label}: {got}, want launches {w}")
        if len({g["params_sha1"] for g in got}) != 1:
            raise AssertionError(f"{label}: the ranks' parameters differ")
    sr = r0["sr_check"]
    live = sum(blocks_per_shard(n, WIRE_WORLD, "int8_sr") is not None
               for n in sizes)
    print(f"LM BSP at world {WIRE_WORLD} on one card (gloo, cuda:0, "
          f"int8_sr, bf16, flash, batch {BSP2_CFG['batch_size']}/rank): "
          f"{steps} steps + 1 val batch; two processes in {wall:.1f} s; "
          f"launches per rank {r0['launches']} = plan ({len(sizes)} "
          f"buckets, {live} live); loss {[round(c, 4) for c in r0['costs']]}"
          f", val {r0['val_cost']:.4f}; parameters bitwise equal across the "
          f"ranks")
    for r in res:
        print(f"  rank {r['rank']}: step {r['step_ms']:.3f} ms, wire "
              f"{r['wire_ms']:.3f} ms ({100 * r['wire_share']:.1f} % of the "
              f"step), run {r['wall_s']:.3f} s, peak {r['peak_mem_gib']:.2f}"
              " GiB")
    prof = r0["profile"]
    if prof["device_idle_share"] is not None:
        print(f"  rank 0 under torch.profiler ({prof['steps']} steps): "
              f"{prof['wall_ms_per_step']:.3f} ms/step, its own device work "
              f"{prof['device_busy_ms_per_step']:.3f} ms/step (idle share "
              f"of its timeline {prof['device_idle_share']:.3f}; the other "
              f"rank's kernels are not on it), "
              f"{prof['kernels_per_step']:.0f} kernels/step")
        for part, ms in prof["kernel_ms_per_step"].items():
            print(f"    {part}: {ms:.4f} ms/step")
    print(f"  int8_sr mean of {sr['name']} ({sr['n']} fp32) vs the fp32 "
          f"all_reduce mean: max|err| {sr['max_err']:.3e} <= 2·max|g|/127 = "
          f"{sr['atol']:.3e} ({sr['inexact']} elements inexact)")
    for label, _ in BSP2_MORE:
        g = r0["more"][label]
        print(f"  {label}: {BSP2_MORE_STEPS} steps, launches {g['launches']}"
              f", loss {g['loss']:.4f}, parameters equal across the ranks")
    return dict(wall_s=wall, ranks=res, want_launches=want)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--bsp2-rank":
        return _bsp2_rank(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    phase_environment()
    phase_build()
    kern = phase_kernel(dev)
    train_rows = phase_train_kernels(dev)
    pool_edges = phase_pool_edges(dev)
    flash_rows = phase_flash_kernels(dev)
    flash_edges = phase_flash_edges(dev)
    serve, serve_ctx = phase_serve(dev)
    serve_i8 = phase_serve_int8(dev, serve_ctx)
    serve_sampled = phase_serve_sampled(dev, serve_ctx)
    del serve_ctx
    train = phase_train(dev)
    oracle = phase_train_oracle(dev)
    lm = phase_lm_train(dev)
    lm_oracle = phase_lm_oracle(dev)
    wire_rows = phase_wire_kernels(dev, lm["wire_sizes"], train["wire_sizes"])
    destroy_process_group()
    bsp2 = phase_lm_bsp2(dev)
    k32 = kern[torch.float32]  # the serving path's pool dtype
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "theanompi_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "theanompi_tpu/ops/pallas_paged.py:100",
        "launches": serve["launches"],
        "max_abs_err": k32["max_abs_err"],
        "ms": k32["ms"],
        "plain_ms": k32["plain_ms"],
        "bound_ms": k32["bound_ms"],
        "bound_by": k32["bound_by"],
        "library_ms": k32["library_ms"],
    }, {
        "name": "paged_decode_attention_i8",
        "route": "cuda",
        "source": "theanompi_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "theanompi_tpu/ops/pallas_paged.py:129",
        "launches": serve_i8["launches"],
        **{k: kern[torch.int8][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    }]
    for name, source, replaces in (
        ("lrn_fwd", "lrn.cu", "theanompi_tpu/ops/pallas_lrn.py:73"),
        ("lrn_bwd", "lrn.cu", "theanompi_tpu/ops/pallas_lrn.py:79"),
        ("maxpool_bwd", "maxpool_bwd.cu",
         "theanompi_tpu/ops/pallas_pool.py:63"),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"theanompi_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": train["launches"][name],
            **_per_step(train_rows, name),
        })
    for name, line in (("flash_fwd", 96), ("flash_dq", 179),
                       ("flash_dkv", 209)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "theanompi_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"theanompi_tpu/ops/pallas_flash.py:{line}",
            "launches": lm["launches"][name],
            **_flash_per_step(flash_rows, name, SERVE_CFG["n_layers"]),
        })
    # launches: the default int8_sr run for its quantize and the
    # dequantize; the int8 (error feedback) and fp16s runs for theirs
    r0 = bsp2["ranks"][0]
    wire_launches = dict(
        block_quant_int8=r0["more"]["int8+ef"]["launches"]["quantize_int8"],
        block_quant_int8_sr=r0["launches"]["quantize_int8_sr"],
        block_quant_fp16=r0["more"]["fp16s"]["launches"]["quantize_fp16"],
        block_dequant=r0["launches"]["dequantize"])
    for row, line in zip(wire_rows, (107, 134, 207, 218)):
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": "theanompi_tpu_torch/csrc/block_quant.cu",
            "replaces": f"theanompi_tpu/parallel/quantize.py:{line}",
            "launches": wire_launches[row["name"]],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        })
    print(json.dumps({
        "serve": {k: v for k, v in serve.items() if k != "stats"},
        "serve_int8": serve_i8, "serve_sampled": serve_sampled,
        "paged_decode_attention_bf16": {
            k: v for k, v in kern[torch.bfloat16].items() if k != "bytes"
        },
        "paged_decode_attention_i8": {
            k: v for k, v in kern[torch.int8].items() if k != "bytes"
        },
        "train": train, "train_oracle": oracle,
        "train_kernels": [dict(r, shape=list(r["shape"])) for r in train_rows],
        "lm_train": lm, "lm_oracle": lm_oracle,
        "flash_kernels": [dict(r, shape=list(r["shape"]))
                          for r in flash_rows],
        "pool_edges": pool_edges, "flash_edges": flash_edges,
        "wire_kernels": wire_rows, "lm_bsp2": bsp2,
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
