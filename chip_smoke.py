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
   (32 lanes, 8 heads, head_dim 64, block 32, 32-entry tables) in two
   shapes: the kernel shape (lengths 0..1023 with boundary cases) and
   the serve run's shape (8 live lanes at the serve prompts' lengths
   plus 16, 24 lanes at length 0 with all-zero tables), on fp32, bf16
   and int8 pools (int8: 967 blocks, the fp32 pool's bytes, rows
   quantized by ``quantize_rows``); each call's instance asserted
   (``paged_instance``: ``bulk`` here); times of the kernel, the plain
   version and ``F.scaled_dot_product_attention`` over the pre-gathered
   image (the one-call yardstick, used nowhere in the port; for int8
   over the image dequantized beforehand, not the same function, so its
   ``library_ms`` is null), beside the bound.  Then the edge cases,
   fp32, bf16 and int8, at the unchanged ATOL: lengths 0, bs − 1, bs, a
   full table and both sides of a split boundary; head_dim 128 (bulk)
   and 37 (general); an int8 K pool that starts on an odd byte
   (general).
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
   the LRN backward), beside the bound; each LRN call's run width
   asserted (16 bytes of channels a thread here).  Then the LRN
   kernels' edge cases, fp32 and bf16, at KERNEL_TOL, each call's run
   width asserted (``lrn_fwd.last_plan.vec``): C 1, 3, 13, 96, 256,
   1024 and 4096 at sizes 3, 4, 5 and 7; C 96 with x off 16 bytes; one
   row; one row past a tile of each pass.  Then the max-pool backward's
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
   ticks, every launch on the bulk instance (the wrapper's
   ``bulk_launches``), and every request's tokens must equal greedy
   decoding by the
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
   CPU's.  Last, after every counted serve run, a decode-tick profile
   of each pool (``torch.profiler`` over the 8 requests served again,
   the engine's ``record_function`` ranges marking ticks, prefills and
   KV writes): per tick the device time of the paged kernel, the GEMMs,
   the KV write (int8: quantize on write), memcpy and the rest, kernels
   per tick, and the device's idle share inside the ticks and over the
   run.
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
   (conv/dense, LRN, pool backward, exchange, the rest), the device
   µs a launch of each of the port's kernels inside the step, and the
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
   (mma.sync); and the forward, dQ and dK/dV with several items a CTA
   at (B·H, T, D) = (200, 64, 64) and (300, 256, 64), causal and full.
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
11. wire kernels vs plain — the block-quantization kernels (int8
   round-to-nearest, int8 stochastic rounding with a fixed seed word,
   fp16 with a block scale, dequantize of int8 and fp16 payloads, and
   leg 2 of each of the ``int8``, ``int8_sr`` and ``fp16s`` wires in
   one launch) against their plain versions, exact, at the shapes one
   bucket of 4 MB gives them at a world of 2 (leg 1 (2, 2048, 256),
   leg 2 (2, 2048, 256) → (2048, 256)) and at AlexNet-128's largest
   bucket from its bucketing plan; each fused leg 2 also at world 4, at
   nb 1 and on inputs 16 bytes off their base, each with a zero block
   and a block of half-way ties in the sum (fp16: and a block of tiny
   magnitude whose quotients reach fp16's subnormals); the
   dequantize with the mean's divisor and a length n at worlds 2, 3 and
   4, n whole and short of a block, int8 and fp16.  Then timed (cold
   L2) per call at the 4 MB bucket and per LM step at a world of 2 on
   each kernel's path, beside the bytes bound and a ``copy_`` of the
   same bytes after the same flush; the quantizers and legs 2 also per
   call at AlexNet-128's largest bucket, with their share of the bound.  No single PyTorch call computes a
   per-256-block amax quantization, so there is no library yardstick.
12. LM train at a world of 2 on the one card — two processes (this
   script with ``--bsp2-rank``) with ``RANK``, ``WORLD_SIZE=2``,
   ``LOCAL_RANK=0``, ``LOCAL_WORLD_SIZE=2``, each running
   ``BSP().init(devices=2, ...)`` / ``rule.wait()`` for
   ``TransformerLM`` at the LM phase's width, batch 8 per rank, bf16,
   flash, with the default wire ``int8_sr``: 8 steps and a validation
   batch.  Checks: both ranks run gloo on ``cuda:0``; the wire's
   launches equal what the bucket plan predicts (per live bucket and
   step 1 SR quantize, 1 fused leg 2, 1 dequantize); the loss is finite
   and falls; every
   parameter is bitwise equal across the ranks; on one step the first
   bucket's ``int8_sr`` mean lies within 2·max|g|/127 of the fp32
   ``all_reduce`` mean.  Then two steps each of ``int8`` with error
   feedback and of ``fp16s`` (their launches checked the same way: 1
   RN or fp16 quantize, 1 fused leg 2, 1 dequantize, and with error
   feedback 1 more dequantize; the parameters still equal).  Prints step ms, the wire's share of the
   step and peak memory per rank, and rank 0's step profile with each
   wire kernel's device µs a launch inside the step and the wire
   kernels' device ms a step.
13. launch — the CLI entry point (``theanompi_tpu_torch.launch``) with
   checkpoints, a crash and a restart, and two ranks.  (a) Writes a
   raw-shard ImageNet directory (``data.shards.write_shard_dir``: 8
   train shards of 128 seeded synthetic 128 px images, no val split) in
   a temporary directory.  (b) ``launch.main(["--preset",
   "alexnet-bsp", "--devices", "1", "--config", {lrn_impl and
   pool_grad 'pallas', data_dir, n_epochs 2}, "--checkpoint-dir", D,
   "--keep-last", "1", "--restarts", "1"])``: batches through the
   native ring loader (mirror in its C++ thread), a snapshot per epoch;
   a ``TrainingFault`` is injected once at the third step of epoch 2
   (``runtime.fault.FaultInjector``), and ``run_with_restart``'s second
   attempt must resume at epoch 1 (not 0) and finish.  Checks: exactly
   one ``ckpt_*.npz`` is left (``ckpt_0002``); the LRN and pool launch
   counts equal the steps that ran (2 LRN forwards and backwards and 3
   pool backwards a step: 8 + 2 + 8 steps); a fresh model that loads
   the file holds the trained parameters bitwise.  (c) ``python -m
   theanompi_tpu_torch.launch --preset alexnet-bsp --devices 2
   --spawn-procs 2`` on this card (gloo on ``cuda:0``), synthetic data,
   4 steps of batch 128 a rank on the ``int8`` wire with error
   feedback: one checkpoint, written by rank 0 alone, whose ``ef_wire``
   has a leading axis of 2, and parameters bitwise equal across the
   ranks (each rank's record carries their SHA-1).  (d) Prints the wall
   time of each part, the host's data-wait share of the raw-shard run
   beside phase 6's synthetic run, and the time of one checkpoint
   save: synchronous, and under ``AsyncCheckpointer`` the loop's stall
   (the device→host copy) beside the write behind it.

Prints, before the last line, a JSON line of the serving and training
numbers and the kernel instances, then the JSON line
``{"kernels": [...]}`` (15 hand-written kernels) — the paged kernel's
fp32 instance (what the fp32 serving run runs) and the int8 kernel
(launches from the int8 serving run), for each training kernel its
bf16 instance (what the training paths run) summed over the launches
of one step (AlexNet's shapes; the LM's n_layers launches), and for
each wire kernel its launches over the two-rank run of its path and
its time over one LM step of that path at a world of 2 — and as
the last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when no card is present or the port is not importable.
"""

from __future__ import annotations

import bisect
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

from theanompi_tpu_torch import BSP, cuda_build, launch
from theanompi_tpu_torch.data.providers import _synthetic_classification
from theanompi_tpu_torch.data.shards import write_shard_dir
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.base import TpuModel
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
from theanompi_tpu_torch.runtime.fault import FaultInjector
from theanompi_tpu_torch.runtime.recorder import Recorder
from theanompi_tpu_torch.utils import checkpoint as ckpt
from theanompi_tpu_torch.utils import kernel_ab as KA
from theanompi_tpu_torch.utils.benchmark import (
    images_per_sec, measure_step_time,
)
from theanompi_tpu_torch.serving import (
    ContinuousBatchingScheduler, PagedServingEngine, Request, Sampler,
)
from theanompi_tpu_torch.serving.paging import (
    KV_WRITE_RANGE, PREFILL_RANGE, TICK_RANGE,
)
from theanompi_tpu_torch.serving.sampling import gumbel_noise, request_seed

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
# the serving flagship and its 8 greedy requests (utils.kernel_ab owns
# them, so that its A/B serves the same traffic)
SERVE_CFG, SERVE_ENGINE = KA.SERVE_CFG, KA.SERVE_ENGINE
N_REQUESTS, PROMPT_LO = KA.SERVE_REQUESTS["n"], KA.SERVE_REQUESTS["lo"]
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.int8: 1e-5}
TIE_MARGIN = 1e-4
I8_BLOCKS = KA.I8_BLOCKS  # int8 blocks in the fp32 pool's bytes
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
# the LRN kernels' edge cases: runs of one channel (C 1, 3, 13, and C 96
# off 16 bytes) and of 16 bytes, the register windows (sizes 3, 4, 5:
# even and odd) and the loop (7), rows past the old 768-channel cap, one
# row, and one row past a tile
LRN_EDGE_C = (1, 3, 13, 96, 256, 1024, 4096)
LRN_EDGE_SIZES = (3, 4, 5, 7)
LRN_EDGE_LEAD = {1024: (2, 3, 7), 4096: (2, 3, 7)}  # else (2, 9, 11)
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
# each block strategy's leg-1 quantizer and fused leg 2 (kernel names)
WIRE_QUANT = dict(int8="block_quant_int8", int8_sr="block_quant_int8_sr",
                  fp16s="block_quant_fp16")
WIRE_LEG2 = dict(int8="block_dequant_sum_quant_int8",
                 int8_sr="block_dequant_sum_quant_int8_sr",
                 fp16s="block_dequant_sum_quant_fp16")
BSP2_CFG = dict(SERVE_CFG, batch_size=8, compute_dtype="bfloat16",
                attn_impl="flash", n_synth_train=8, n_synth_val=1,
                n_epochs=1, print_freq=4)
# after the default int8_sr run: two steps of each other kernel's path
BSP2_MORE = (("int8+ef", dict(exch_strategy="int8", error_feedback=True)),
             ("fp16s", dict(exch_strategy="fp16s", error_feedback=False)))
BSP2_MORE_STEPS = 2
BSP2_TIMEOUT_S = 600
BSP2_DEVICE = "cuda:0"  # both ranks on the one card
# phase 13: the launcher over raw shards (one rank), then two ranks
LAUNCH_STEPS, LAUNCH_EPOCHS = 8, 2  # shards of 128 images = steps an epoch
LAUNCH_CRASH_AT = LAUNCH_STEPS + 3  # the third step of epoch 2
LAUNCH_CFG = dict(lrn_impl="pallas", pool_grad="pallas",
                  n_epochs=LAUNCH_EPOCHS, print_freq=4)
LAUNCH2_CFG = dict(lrn_impl="pallas", pool_grad="pallas", n_synth_batches=4,
                   n_epochs=1, print_freq=2, exch_strategy="int8",
                   error_feedback=True)
LAUNCH2_TIMEOUT_S = 600


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
    cold L2 (a 256 MiB memset between calls, twice: the memsets also
    keep the device busy while the host enqueues the timed call, and one
    (~90 µs on an H100) is shorter than the paged wrapper's host work at
    times, which then lands in the reading)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _paged_bound(lengths_np, h, hd, esize, bs) -> tuple:
    """(bytes, ops) of one call: each live K/V row once (int8: hd bytes
    and an fp32 scale per head), q and out, the live table entries and
    the lengths; 2·hd flops a (row, head) for q·k and as many for p·v
    (int8: 2·hd more for the dequantization)."""
    s_ = len(lengths_np)
    live_rows = int((lengths_np.astype(np.int64) + 1).sum())
    live_blocks = int((lengths_np // bs + 1).sum())
    row = hd + 4 if esize == 1 else hd * esize
    nbytes = (2 * live_rows * h * row + 2 * s_ * h * hd * 4
              + live_blocks * 4 + s_ * 4)
    ops = (6 if esize == 1 else 4) * live_rows * h * hd
    return nbytes, ops


def _paged_measure(label, q, pools, tables, lengths_np, bs, flush,
                   want_instance) -> dict:
    """The paged kernel on ``pools`` ((k, v) or (k, v, k_scale,
    v_scale)) against its plain version at ATOL, the instance it ran
    asserted; then timed (cold L2) beside its plain version, the
    one-call yardstick and the bound."""
    dev, (s_, h, hd) = q.device, q.shape
    dt = pools[0].dtype
    lengths = torch.from_numpy(lengths_np).to(dev)
    scale = hd ** -0.5
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if len(pools) == 4 \
        else {}
    inst = PA.paged_instance(dt, h, hd, bs, [t.data_ptr() for t in pools],
                             pools[0].shape[0])
    if inst != want_instance:
        raise AssertionError(f"paged {label} ({dt}): instance {inst}, want "
                             f"{want_instance}")

    def kern():
        return PA.paged_decode_attention(
            q, pools[0], pools[1], tables, lengths, block_size=bs,
            scale=scale, **scales)

    if dt == torch.int8:
        def plain():
            return PA.paged_decode_attention_i8_plain(
                q, *pools, tables, lengths, block_size=bs, scale=scale)
    else:
        def plain():
            return PA.paged_decode_attention_plain(
                q, pools[0], pools[1], tables, lengths, block_size=bs,
                scale=scale)

    got = _ran_instance(f"paged {label}", kern, dt, inst)
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or err > ATOL[dt]:
        raise AssertionError(
            f"paged {label} kernel vs plain ({dt}): max |err| {err} > "
            f"{ATOL[dt]}")
    # one-call yardstick: SDPA over the image gathered beforehand (int8:
    # dequantized beforehand, not the same function: no one PyTorch call
    # attends int8 rows with per-(row, head) scales)
    rows = PA.image_rows(tables, bs)
    if dt == torch.int8:
        k_img = pools[0][rows].float() * pools[2][rows][..., None]
        v_img = pools[1][rows].float() * pools[3][rows][..., None]
        q_l = q[:, :, None, :]
    else:
        k_img, v_img = pools[0][rows], pools[1][rows]
        q_l = q.to(dt)[:, :, None, :]
    k_img = k_img.permute(0, 2, 1, 3).contiguous()  # (S, H, T, hd)
    v_img = v_img.permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(rows.shape[1], device=dev)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q_l, k_img, v_img,
                                              attn_mask=mask, scale=scale)

    sdpa_err = float((sdpa()[:, :, 0].float() - want).abs().max())
    nbytes, ops = _paged_bound(lengths_np, h, hd, pools[0].element_size(),
                               bs)
    bound_ms, bound_by = _bound(nbytes, ops)
    sdpa_ms = _time_ms(sdpa, flush)
    res = dict(
        max_abs_err=err, instance=inst, ms=_time_ms(kern, flush),
        plain_ms=_time_ms(plain, flush), bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes, sdpa_max_abs_err=sdpa_err,
        library_ms=None if dt == torch.int8 else sdpa_ms,
        live_rows=int((lengths_np.astype(np.int64) + 1).sum()),
    )
    if dt == torch.int8:
        res["sdpa_dequantized_image_ms"] = sdpa_ms
    what = ("sdpa on the dequantized image (not the same function)"
            if dt == torch.int8 else "sdpa")
    print(f"paged_decode_attention {str(dt).replace('torch.', '')} {label} "
          f"({inst}): max|err| {err:.3e} (atol {ATOL[dt]}), kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, {what} "
          f"{sdpa_ms:.4f} ms (max|err| {sdpa_err:.3e}), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
          f"Σ(len+1)={res['live_rows']})")
    return res


def _paged_wrapper(dt):
    """The wrapper whose counters a paged call on ``dt`` pools moves."""
    return (PA.paged_decode_attention_i8 if dt == torch.int8
            else PA.paged_decode_attention)


def _ran_instance(what, call, dt, want_instance):
    """``call()`` (one paged kernel call), asserting by the wrapper's
    counters that it launched once and ran ``want_instance``."""
    w = _paged_wrapper(dt)
    n0, b0 = w.launches, w.bulk_launches
    out = call()
    ran = "bulk" if w.bulk_launches - b0 == 1 else "general"
    if w.launches - n0 != 1 or ran != want_instance:
        raise AssertionError(
            f"{what} ({dt}): {w.launches - n0} launches, "
            f"{w.bulk_launches - b0} bulk; want one {want_instance}")
    return out


def _pools(dt, rng, rows, h, hd, dev) -> tuple:
    """Seeded K and V pools of ``rows`` rows in ``dt``; int8 rows
    quantized by ``quantize_rows``, with their scales after them."""
    k, v = (torch.from_numpy(rng.randn(rows, h, hd).astype(np.float32))
            .to(dev) for _ in range(2))
    if dt == torch.int8:
        (kq, ks), (vq, vs) = Q.quantize_rows(k), Q.quantize_rows(v)
        return kq, vq, ks, vs
    return k.to(dt), v.to(dt)


def phase_kernel(dev: torch.device) -> dict:
    """The paged kernel against its plain version at the serving shapes:
    the kernel shape (32 lanes, lengths 0..1023 with boundary cases) and
    the serve run's shape (8 live lanes at the serve prompts' lengths
    plus 16, 24 lanes at length 0 with all-zero tables), fp32, bf16 and
    int8 pools; then the edge cases."""
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
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        results[dt] = _paged_measure("kernel shape", q, (kp32.to(dt),
                                     vp32.to(dt)), tables, lengths_np, bs,
                                     flush, "bulk")
    # int8: a pool of I8_BLOCKS blocks (the fp32 pool's bytes), tables
    # drawn from it, the same lengths
    pools8 = _pools(torch.int8, rng, I8_BLOCKS * bs, h, hd, dev)
    tables8 = torch.from_numpy(np.stack([
        rng.choice(I8_BLOCKS - 1, nt, replace=False) + 1 for _ in range(s_)
    ]).astype(np.int32)).to(dev)
    results[torch.int8] = dict(_paged_measure(
        "kernel shape", q, pools8, tables8, lengths_np, bs, flush, "bulk"),
        n_blocks=I8_BLOCKS)
    # the serve run's shape
    live = [len(p) + KA.SERVE_AT for p in KA.serve_prompts()]
    srng = np.random.RandomState(SEED + 7)
    serve_len = np.zeros(s_, np.int32)
    serve_len[:len(live)] = live
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        blocks = I8_BLOCKS if dt == torch.int8 else n_blocks
        pools = _pools(dt, srng, blocks * bs, h, hd, dev)
        st = torch.from_numpy(KA.paged_tables(serve_len, blocks, srng)).to(
            dev)
        results[dt]["serve_shape"] = _paged_measure(
            "serve shape", q, pools, st, serve_len, bs, flush, "bulk")
    results["edges"] = _paged_edges(dev)
    return results


def _paged_edges(dev) -> dict:
    """The paged kernel's edge cases against its plain version at ATOL,
    fp32, bf16 and int8, with the instance each runs asserted: lengths
    0, bs - 1, bs, a full table and both sides of a split boundary
    (bulk); head_dim 128 (bulk) and 37 (general); an int8 K pool that
    starts on an odd byte (general)."""
    rng = np.random.RandomState(SEED + 3)
    worst, n, seen = {}, 0, set()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        cases = []
        for s_, h, hd, bs, nb, nt in ((32, 8, 64, 32, 257, 32),
                                      (4, 2, 128, 16, 30, 8),
                                      (6, 4, 128, 32, 60, 12),
                                      (5, 3, 37, 4, 20, 6)):
            plan = PA.paged_split_plan(s_, nt, bs, n_sm)
            edge = plan.blocks_per_split * bs  # first row of split 1
            ln = rng.randint(0, nt * bs, size=s_).astype(np.int32)
            ln[:min(s_, 7)] = [0, bs - 1, bs, nt * bs - 1, edge - 1, edge,
                               edge + 1][:min(s_, 7)]
            ln = np.minimum(ln, nt * bs - 1)
            q = torch.from_numpy(rng.randn(s_, h, hd).astype(np.float32)).to(
                dev)
            pools = _pools(dt, rng, nb * bs, h, hd, dev)
            tables = torch.from_numpy(np.stack([
                rng.choice(nb - 1, nt, replace=False) + 1 for _ in range(s_)
            ]).astype(np.int32)).to(dev)
            want = "general" if hd % 2 else "bulk"
            cases.append((f"H {h} hd {hd} bs {bs}", q, pools, tables, ln, bs,
                          want))
            if dt == torch.int8 and hd == 64:
                flat = torch.empty(pools[0].numel() + 1, dtype=torch.int8,
                                   device=dev)
                k_odd = flat[1:].view(pools[0].shape)
                k_odd.copy_(pools[0])
                cases.append(("K pool on an odd byte", q,
                              (k_odd,) + pools[1:], tables, ln, bs,
                              "general"))
        for name, q, pools, tables, ln, bs, want in cases:
            inst = PA.paged_instance(dt, q.shape[1], q.shape[2], bs,
                                     [t.data_ptr() for t in pools],
                                     pools[0].shape[0])
            if inst != want:
                raise AssertionError(f"paged edge {name} ({dt}): instance "
                                     f"{inst}, want {want}")
            lengths = torch.from_numpy(ln).to(dev)
            scales = (dict(k_scale=pools[2], v_scale=pools[3])
                      if dt == torch.int8 else {})
            got = _ran_instance(
                f"paged edge {name}", lambda: PA.paged_decode_attention(
                    q, pools[0], pools[1], tables, lengths, block_size=bs,
                    **scales), dt, want)
            want_out = (PA.paged_decode_attention_i8_plain(
                q, *pools, tables, lengths, block_size=bs)
                if dt == torch.int8 else PA.paged_decode_attention_plain(
                    q, pools[0], pools[1], tables, lengths, block_size=bs))
            torch.cuda.synchronize()
            err = float((got - want_out).abs().max())
            if not torch.isfinite(got).all() or err > ATOL[dt]:
                raise AssertionError(f"paged edge {name} ({dt}): max |err| "
                                     f"{err} > {ATOL[dt]}")
            key = str(dt).replace("torch.", "")
            worst[key] = max(worst.get(key, 0.0), err)
            seen.add(inst)
            n += 1
    print(f"paged edges: {n} cases (lengths 0, bs - 1, bs, a full table, "
          f"both sides of a split boundary; H 8 hd 64, H 2 and 4 hd 128, "
          f"H 3 hd 37; an int8 K pool on an odd byte), instances "
          f"{sorted(seen)}, max|err| {worst} within {ATOL}")
    return dict(cases=n, max_abs_err=worst, instances=sorted(seen))


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
    count (and bulk-instance count) set to 0 just before, read just
    after; the device bytes the scheduler's pool took."""
    timeline = KA.ServeClock()
    on_card = engine.device.type == "cuda"
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    sched = (_Recorder if record else ContinuousBatchingScheduler)(
        engine, metrics=timeline)
    pool_bytes = torch.cuda.memory_allocated() - mem0 if on_card else None
    for w in (PA.paged_decode_attention, PA.paged_decode_attention_i8):
        w.launches = w.bulk_launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fp32=PA.paged_decode_attention.launches,
                    int8=PA.paged_decode_attention_i8.launches)
    bulk = dict(fp32=PA.paged_decode_attention.bulk_launches,
                int8=PA.paged_decode_attention_i8.bulk_launches)
    vocab = engine.vocab_size
    for r in reqs:
        if len(r.output) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.output):
            raise AssertionError(f"{r.id}: bad output {r.output}")
    n_tok = sum(len(r.output) for r in reqs)
    ttft = [timeline.first_at[r.id] - timeline.admitted_at[r.id]
            for r in reqs]
    return dict(
        sched=sched, launches=launches, bulk_launches=bulk,
        pool_bytes=pool_bytes,
        summary=dict(
            tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
            ttft_ms_median=1e3 * float(np.median(ttft)),
            ttft_ms_max=1e3 * float(np.max(ttft)),
            decode_tick_ms_median=timeline.decode_tick_ms(reqs),
            decode_ticks=sched.stats["decode_ticks"],
        ),
    )


def _want_paged_launches(run, key: str, engine) -> int:
    """The paged kernel ``key`` launched n_layers × decode ticks times,
    each on the bulk instance, and the other paged kernel never."""
    ticks = run["sched"].stats["decode_ticks"]
    want = {k: 0 for k in run["launches"]}
    want[key] = engine.n_layers * ticks
    if (run["launches"] != want or run["bulk_launches"] != want
            or want[key] == 0):
        raise AssertionError(
            f"paged kernel launches {run['launches']} over the run, "
            f"{run['bulk_launches']} of them bulk; want {want}, all bulk "
            f"(n_layers × {ticks} decode ticks)")
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


# the decode tick's device time by part (first match; kernels launched
# inside the engine's KV write are the int8 pool's quantize-on-write)
TICK_GEMM = ("gemm", "cublas", "cutlass", "xmma", "sm90_", "sm80_",
             "ampere")


def _tick_part(kernel_name: str, in_kv_write: bool) -> str:
    low = kernel_name.lower()
    if "paged_decode" in low:
        return "paged attention (kernel)"
    if in_kv_write:
        return "KV write (int8: quantize on write)"
    if any(k in low for k in TICK_GEMM):
        return "GEMM (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset (tokens, tables, lengths)"
    return "rest (embedding, LayerNorm, GELU, residuals, head)"


def _covering(ranges, t) -> int:
    """Index of the (start, end) range of the sorted ``ranges`` that holds
    ``t``, else -1."""
    i = bisect.bisect_right([a for a, _ in ranges], t) - 1
    return i if i >= 0 and t <= ranges[i][1] else -1


def _union_us(intervals) -> float:
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def phase_serve_profile(engine, label: str) -> dict:
    """Device time of the decode tick by part, kernels per tick and the
    device's idle share inside the ticks, from ``torch.profiler`` over a
    serve run of the 8 requests (run after every counted serve run: the
    profiler's CUDA tracing may slow the launches of what follows it).
    While the profiler records, the engine opens ``record_function``
    ranges (``serving.paging``'s TICK_RANGE, PREFILL_RANGE and
    KV_WRITE_RANGE); a kernel belongs to the tick whose window holds its
    start (a window runs from its tick's range start to the next tick's
    or prefill's), and to the KV write part when the host op that
    launched it ran inside a KV write range.  A tick spans from its
    range's start to the end of its last kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tags = (TICK_RANGE, PREFILL_RANGE, KV_WRITE_RANGE)
    reqs = KA.serve_requests()
    sched = ContinuousBatchingScheduler(engine)
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    ranges = {tag: sorted((e.time_range.start, e.time_range.end)
                          for e in events if e.name == tag
                          and e.device_type == DeviceType.CPU)
              for tag in tags}
    ticks = ranges[TICK_RANGE]
    n = len(ticks)
    # a tick's window runs from its range's start to the next tick's or
    # prefill's start; the device's kernels that start in it are its own
    starts = [a for tag in (TICK_RANGE, PREFILL_RANGE)
              for a, _ in ranges[tag]]
    tick_starts = [a for a, _ in ticks]
    # device events, less the device-side copies of the ranges above
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in tags]
    by_tick = [[] for _ in ticks]
    for d in kernels:
        i = bisect.bisect_right(tick_starts, d.time_range.start) - 1
        if i >= 0 and d.time_range.start < min(
                [t for t in starts if t > ticks[i][0]] + [float("inf")]):
            by_tick[i].append(d)
    parts, by_name = {}, {}
    for d in (d for mine in by_tick for d in mine):
        us = d.time_range.end - d.time_range.start
        part = _tick_part(d.name, False)
        parts[part] = parts.get(part, 0.0) + us
        by_name[d.name] = by_name.get(d.name, 0.0) + us
    # the KV write's kernels: those its host ops launched (int8: the
    # quantization on write), moved out of the part their names gave
    for e in events:
        if (e.device_type == DeviceType.CPU and e.kernels
                and _covering(ticks, e.time_range.start) >= 0
                and _covering(ranges[KV_WRITE_RANGE], e.time_range.start)
                >= 0):
            for k in e.kernels:
                part = _tick_part(k.name, False)
                parts[part] = parts.get(part, 0.0) - k.duration
                write = _tick_part(k.name, True)
                parts[write] = parts.get(write, 0.0) + k.duration
    spans = [max([ticks[i][1]] + [d.time_range.end for d in by_tick[i]])
             - ticks[i][0] for i in range(n)]
    busy = sum(_union_us([(d.time_range.start, d.time_range.end)
                          for d in by_tick[i]]) for i in range(n))
    n_kernels = sum(len(mine) for mine in by_tick)
    all_kernels = [(d.time_range.start, d.time_range.end) for d in kernels]
    out = dict(
        label=label, decode_ticks=n, wall_ms=wall_us / 1e3,
        kernel_ms_per_tick={k: v / max(n, 1) / 1e3
                            for k, v in sorted(parts.items())},
        kernels_per_tick=n_kernels / max(n, 1),
        tick_span_ms_median=float(np.median(spans)) / 1e3 if n else None,
        device_busy_ms_per_tick=busy / max(n, 1) / 1e3,
        tick_idle_share=(1.0 - busy / sum(spans)) if n_kernels else None,
        run_idle_share=(1.0 - _union_us(all_kernels) / wall_us)
        if all_kernels else None,
        top_kernels_ms_per_tick={
            k[:80]: v / max(n, 1) / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]},
    )
    if not n_kernels:
        print(f"decode-tick profile {label}: torch.profiler recorded no "
              f"device kernels in the ticks (not measured)")
        return out
    print(f"decode-tick profile {label} ({n} decode ticks of "
          f"{len(reqs)} requests, under the profiler): tick span median "
          f"{out['tick_span_ms_median']:.3f} ms, device busy "
          f"{out['device_busy_ms_per_tick']:.4f} ms a tick (idle share "
          f"{out['tick_idle_share']:.3f} inside the ticks, "
          f"{out['run_idle_share']:.3f} over the run), "
          f"{out['kernels_per_tick']:.1f} kernels a tick")
    for part, ms in out["kernel_ms_per_tick"].items():
        print(f"  {part}: {ms:.4f} ms a tick")
    for name, ms in out["top_kernels_ms_per_tick"].items():
        print(f"  kernel {name}: {ms:.4f} ms a tick")
    return out


def phase_serve(dev: torch.device):
    """The fp32 pool's run; returns its numbers and what the int8 and
    sampled runs reuse (the model, the engine, the prompts, the tokens)."""
    model = TransformerLM(SERVE_CFG, seed=SEED, device=dev)
    engine = PagedServingEngine(model, device=dev, **SERVE_ENGINE)
    prompts = KA.serve_prompts()
    # warm-up (cuBLAS handles, allocator), outside the counted run
    engine.greedy(prompts[0][:PROMPT_LO], 2)
    torch.cuda.synchronize()

    reqs = KA.serve_requests()
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
          f"decode ticks, {launches} kernel launches (all bulk); all "
          f"requests match the full-recompute oracle")
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
    ctx["engine_i8"] = engine

    reqs = KA.serve_requests()
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
    cpu_run = _serve_run(cpu_engine, KA.serve_requests(), record=True)
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
          f"decode ticks, {launches} int8 kernel launches (all bulk), 0 "
          f"fp32; "
          f"{equal}/{N_REQUESTS} requests equal to the CPU int8 engine's "
          f"({cpu_s:.1f} s on the CPU)")
    print(f"kv_quant: capacity ratio {capacity:.4f} ({I8_BLOCKS} int8 blocks "
          f"in the bytes of {SERVE_ENGINE['n_blocks']} fp32), greedy agreement "
          f"with fp32 {agreement:.4f} ({agree} tokens); pool memory_allocated "
          f"{run['pool_bytes']} B, n_blocks × kv_block_bytes {want_bytes} B "
          f"(fp32 pool {out['fp32_pool_bytes']} B)")
    return out


def phase_serve_profiles(ctx) -> dict:
    """The decode-tick profiles of the fp32 and int8 pools, after every
    counted serve run."""
    return {label: phase_serve_profile(ctx[key], f"{label} pool")
            for label, key in (("fp32", "engine"), ("int8", "engine_i8"))}


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


def _want_lrn_vec(name: str, vec: int, what: str) -> None:
    """The run width of the last launch of ``LR.<name>``."""
    plan = getattr(LR, name).last_plan
    if plan is None or plan.vec != vec:
        raise AssertionError(f"{name} at {what} ran {plan}, want vec {vec}")


def _lrn_edge(dev, rng, shape, size, dt, shift=False,
              names=("lrn_fwd", "lrn_bwd")) -> float:
    """The named LRN kernels against their plain versions on one input
    (x off 16 bytes with ``shift``), each call's run width asserted."""
    x = _relu_input(rng, shape, dt, dev)
    if shift:  # x at a storage offset of one element: off 16 bytes
        x = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:].view(
            shape).copy_(x)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    dy = dy.to(dt)
    es, hyper = x.element_size(), dict(LRN_HYPER, size=size)
    vec = 16 // es if shape[-1] * es % 16 == 0 and not shift else 1
    calls = dict(
        lrn_fwd=(lambda: LR.lrn_fwd(x, **hyper),
                 lambda: LR.lrn_fwd_plain(x, **hyper)),
        lrn_bwd=(lambda: LR.lrn_bwd(x, dy, **hyper),
                 lambda: LR.lrn_bwd_plain(x, dy, **hyper)))
    worst = 0.0
    for name in names:
        what = f"{tuple(shape)} size {size} {dt} shift {shift}"
        kern, plain = calls[name]
        worst = max(worst, _check_close(f"{name} edge {what}", kern(),
                                        plain(), dt))
        _want_lrn_vec(name, vec, what)
    return worst


def phase_lrn_edges(dev: torch.device) -> dict:
    """Both LRN kernels against their plain versions, fp32 and bf16, at
    KERNEL_TOL: C in LRN_EDGE_C at every size of LRN_EDGE_SIZES; C 96 with
    x off 16 bytes; one row; one row past a tile of each pass."""
    rng = np.random.RandomState(SEED + 8)
    worst, n = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        for c in LRN_EDGE_C:
            for size in LRN_EDGE_SIZES:
                worst = max(worst, _lrn_edge(
                    dev, rng, (*LRN_EDGE_LEAD.get(c, (2, 9, 11)), c), size,
                    dt))
                n += 2
        for size in LRN_EDGE_SIZES:
            worst = max(worst, _lrn_edge(dev, rng, (2, 9, 11, 96), size, dt,
                                         shift=True))
            n += 2
        worst = max(worst, _lrn_edge(dev, rng, (1, 1, 1, 96), 5, dt))
        n += 2
        for c in (96, 256):
            for name in ("lrn_fwd", "lrn_bwd"):
                rows = LR.plan_lrn(10 ** 6, c, torch.finfo(dt).bits // 8,
                                   True, name == "lrn_bwd").rows
                worst = max(worst, _lrn_edge(dev, rng, (1, 1, rows + 1, c),
                                             5, dt, names=(name,)))
                if getattr(LR, name).last_plan.tiles != 2:
                    raise AssertionError(
                        f"{name}: {rows + 1} rows in "
                        f"{getattr(LR, name).last_plan}, want 2 tiles")
                n += 1
    print(f"lrn edges: {n} calls (C {LRN_EDGE_C}, sizes {LRN_EDGE_SIZES}, "
          f"C 96 off 16 B, one row, one row past a tile; fp32 and bf16; "
          f"run width asserted per call) within KERNEL_TOL, max|err| "
          f"{worst:.3e}; limit {LR.lrn_max_channels()} channels")
    return dict(calls=n, max_abs_err=worst,
                max_channels=LR.lrn_max_channels())


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
                _want_lrn_vec(name, 16 // es, f"{shape} {dt}")
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
WIRE_PART = "wire quantize/leg 2/dequantize (kernel)"
# kernel name → part of the step (lower-case substrings, first match)
STEP_PARTS = (
    ("flash attention (kernel)", ("flash_fwd_kernel", "flash_dq_kernel",
                                  "flash_dkv_kernel")),
    (WIRE_PART, ("quant_rows", "dequant_sum_quant_rows", "dequant_rows")),
    ("memcpy (host<->card; gloo stages the wire)", ("memcpy",)),
    ("lrn (kernel)", ("lrn_fwd_staged", "lrn_bwd_staged")),
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
    parts, by_name, count = {}, {}, {}
    intervals = []
    for e in kernels:
        us = e.device_time_total
        parts[_step_part(e.name)] = parts.get(_step_part(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        count[e.name] = count.get(e.name, 0) + 1
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
        # the port's own kernels inside the step: device µs a launch and
        # launches a step
        port_kernels={
            k[:80]: dict(us_per_launch=v / count[k],
                         launches_per_step=count[k] / PROFILE_STEPS)
            for k, v in sorted(by_name.items())
            if _step_part(k).endswith("(kernel)")},
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
    _print_port_kernels(out, "  ")
    return out


def _print_port_kernels(profile: dict, indent: str) -> None:
    for name, k in profile["port_kernels"].items():
        print(f"{indent}port kernel {name}: {k['us_per_launch']:.2f} us a "
              f"launch, {k['launches_per_step']:g} launches a step")


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
    n_many, worst_fwd_many = 0, 0.0
    for bh_, t, d in FLASH_BWD_MANY:
        q, k, v, do = (torch.from_numpy(rng.randn(bh_, t, d).astype(
            np.float32)).to(dev).to(dt) for _ in range(4))
        scale = FL.resolve_scale(None, d)
        for causal in (False, True):
            what = f"B.H {bh_} T {t} D {d} causal {causal}"
            out_p, lse_p = FL.flash_fwd_plain(q, k, v, causal, scale)
            # the forward too (its P split truncates where the backward's
            # rounds), at the shapes where a truncating split once left
            # the backward outside one bf16 step
            out_k, lse_k = FL.flash_fwd(q, k, v, causal, scale)
            inst = FL.flash_fwd_instance(
                dt, d, [a.data_ptr() for a in (q, k, v, out_k)])
            if inst != "wgmma":
                raise AssertionError(f"flash_fwd {what}: instance {inst}, "
                                     f"want wgmma")
            worst_fwd_many = max(
                worst_fwd_many,
                _check_close(f"flash_fwd {what} out", out_k, out_p, dt,
                             FLASH_TOL[dt]),
                _check_close(f"flash_fwd {what} lse", lse_k, lse_p, dt,
                             LSE_TOL))
            delta = (do.float() * out_p.float()).sum(dim=-1)
            worst_bwd = max(worst_bwd, _flash_bwd_edge(
                what, (q, k, v, do, lse_p, delta, causal, scale), "wgmma",
                dt))
            n_many += 1
    print(f"flash_fwd, flash_dq, flash_dkv at {FLASH_BWD_MANY} (B.H, T, D), "
          f"causal and full: {n_many} cases each, instance wgmma, within "
          f"{FLASH_TOL[dt]} / lse {LSE_TOL}; max|err| fwd there "
          f"{worst_fwd_many:.3e}, bwd over all edges {worst_bwd:.3e}")
    return dict(cases=n, bwd_many_cases=n_many, max_abs_err=worst,
                fwd_many_max_abs_err=worst_fwd_many,
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


def _wire_step_calls(sizes, strategy: str) -> dict:
    """Every launch one step gives each wire kernel at a world of
    WIRE_WORLD, name → shapes: a quantizer's rows, leg 2's (world, nb),
    a dequantize's (rows, n, divisor).  Per live bucket, leg 1
    quantizes (world·nb) rows, leg 2 is one launch, and the last
    dequantize returns the bucket's n elements divided by the world
    size."""
    w = WIRE_WORLD
    quant, leg2 = WIRE_QUANT[strategy], WIRE_LEG2[strategy]
    calls = {quant: [], leg2: [], "block_dequant": []}
    for n in sizes:
        nb = blocks_per_shard(n, w, strategy)
        if nb is None:
            continue
        calls[quant].append((w * nb,))
        calls[leg2].append((w, nb))
        calls["block_dequant"].append((w * nb, n, w))
    return calls


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


def _leg2_input(world: int, nb: int, gen: torch.Generator, dev) -> tuple:
    """Gathered leg-1 shards ``(q_t, s_t)``, ``(world, nb, 256)`` int8 and
    ``(world, nb)`` fp32: every rank's SR payload of ``_wire_input``
    blocks, with block 0 zero on every rank (a zero sum) and block 1
    summing to half-way ties pinned at scale 1 (rank 0: k − 128 at scale
    1, rank 1: ones at scale 1/2, column 0 126 + 1)."""
    x = _wire_input(world * nb, gen, dev).view(world, nb, Q.BLOCK)
    x[:, 0] = 0.0
    q_t, s_t = Q.quantize_int8_sr(x, WIRE_SEED)
    if nb > 1 and world > 1:
        q_t[:, 1], s_t[:, 1] = 0, 0.0
        q_t[0, 1] = (torch.arange(Q.BLOCK, device=dev) - 128).clamp(-127, 126)
        q_t[0, 1, 0] = 126
        q_t[1, 1] = 1
        q_t[1, 1, 0] = 2
        s_t[0, 1], s_t[1, 1] = 1.0, 0.5
    return q_t, s_t


def _leg2_input_fp16(world: int, nb: int, gen: torch.Generator, dev
                     ) -> tuple:
    """The fp16 counterpart of ``_leg2_input``: every rank's fp16 payload
    of ``_wire_input`` blocks, block 0 zero on every rank, block 1
    summing to half-way ties of fp16 pinned at scale 1 (rank 0: ±(1 +
    k·2⁻¹⁰) at scale 1, rank 1: ±1 at scale 2⁻¹¹, column 0 256 + 0),
    and block 2 of rank 0 at amax 1e-20 with values down to 40 binades
    below it (quotients in fp16's subnormals and below; the other ranks'
    block 2 zero)."""
    x = _wire_input(world * nb, gen, dev).view(world, nb, Q.BLOCK)
    x[:, 0] = 0.0
    k = torch.arange(Q.BLOCK, device=dev)
    sign = torch.where(k % 3 == 0, -1.0, 1.0)
    if nb > 2:
        x[:, 2] = 0.0
        x[0, 2] = 1e-20 * torch.exp2(-(k % 41).float()) * sign
    q_t, s_t = Q.quantize_fp16(x)
    if nb > 1 and world > 1:
        q_t[:, 1], s_t[:, 1] = 0, 0.0
        q_t[0, 1] = (sign * (1.0 + k / 1024.0)).half()
        q_t[0, 1, 0] = 256.0
        q_t[1, 1] = sign.half()
        q_t[1, 1, 0] = 0.0
        s_t[0, 1], s_t[1, 1] = 1.0, 2.0 ** -11
    return q_t, s_t


def _off16(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 16 bytes past its allocation's base."""
    pad = 16 // t.element_size()
    buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    out = buf[pad:].view(t.shape)
    out.copy_(t)
    return out


_WIRE_QUANT = (
    ("block_quant_int8", Q.quantize_int8, Q.quantize_int8_plain),
    ("block_quant_int8_sr", lambda x: Q.quantize_int8_sr(x, WIRE_SEED),
     lambda x: Q.quantize_int8_sr_plain(x, WIRE_SEED)),
    ("block_quant_fp16", Q.quantize_fp16, Q.quantize_fp16_plain),
)


def _wire_exact(x: torch.Tensor, where: str) -> dict:
    """Every quantizer against its plain version on ``x``, and the
    dequantize of each payload: payloads, scales and dequantized values
    must be equal.  Returns name → max |kernel − plain| (0 when
    equal)."""
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


# each fused leg 2: (kernel call, plain call, maker of its gathered
# shards (world, nb, gen, dev) → (q_t, s_t))
_WIRE_LEG2 = {
    "block_dequant_sum_quant_int8": (
        Q.dequant_sum_quantize_int8, Q.dequant_sum_quantize_int8_plain,
        _leg2_input),
    "block_dequant_sum_quant_int8_sr": (
        lambda q_t, s_t: Q.dequant_sum_quantize_int8_sr(q_t, s_t, WIRE_SEED),
        lambda q_t, s_t: Q.dequant_sum_quantize_int8_sr_plain(q_t, s_t,
                                                              WIRE_SEED),
        _leg2_input),
    "block_dequant_sum_quant_fp16": (
        Q.dequant_sum_quantize_fp16, Q.dequant_sum_quantize_fp16_plain,
        _leg2_input_fp16),
}


def _leg2_exact(name: str, q_t, s_t, where: str) -> float:
    """A fused leg 2 against its plain version: payload and scales
    equal.  Returns max |kernel − plain|."""
    kern, plain, _ = _WIRE_LEG2[name]
    qk, sk = kern(q_t, s_t)
    qp, sp = plain(q_t, s_t)
    torch.cuda.synchronize()
    if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
        raise AssertionError(
            f"{name} at {tuple(q_t.shape)} ({where}): kernel != plain, "
            f"{int((qk != qp).sum())} payload and {int((sk != sp).sum())} "
            "scale elements differ")
    print(f"{name} at {tuple(q_t.shape)} ({where}): payload and scales "
          "equal to the plain version")
    return max(float((qk.float() - qp.float()).abs().max()),
               float((sk - sp).abs().max()))


def _dequant_exact(q, s, divisor, n, where: str) -> float:
    """The dequantize with n and divisor against its plain version."""
    got = Q.dequantize(q, s, divisor, n)
    want = Q.dequantize_plain(q, s, divisor, n)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(
            f"block_dequant ({q.dtype}) of {tuple(q.shape)}, n {n}, divisor "
            f"{divisor} ({where}): kernel != plain")
    return float((got - want).abs().max())


def _wire_bytes(name: str, shape) -> int:
    """Bytes each input read once and each output written once: fp32
    in, int8 (fp16) payload and one fp32 scale per 256 out; leg 2 the
    ranks' int8 (fp16) shards and scales in, one payload and its scales
    out; a dequantize the rows that hold its n elements in (int8 and
    their scales), n fp32 out."""
    if name in _WIRE_LEG2:
        world, nb = shape
        payload = 2 if name.endswith("fp16") else 1
        return (world + 1) * nb * (payload * Q.BLOCK + 4)
    if name == "block_dequant":
        _, n, _ = shape
        rows = -(-n // Q.BLOCK)
        return rows * (Q.BLOCK + 4) + 4 * n
    (rows,) = shape
    payload = 2 if name == "block_quant_fp16" else 1
    return rows * ((4 + payload) * Q.BLOCK + 4)


def _wire_ops(name: str, shape) -> int:
    """Operations: per element amax, divide, round, clamp (the SR hash
    ~14 more; fp16 a convert); leg 2 a convert, product and sum per
    rank's element and its wire's quantize of the sum; a dequantize a
    convert and a product (and the divide)."""
    if name in _WIRE_LEG2:
        world, nb = shape
        quant = name.replace("dequant_sum_quant", "quant")
        return (3 * world + WIRE_OPS[quant]) * nb * Q.BLOCK
    if name == "block_dequant":
        _, n, divisor = shape
        return (WIRE_OPS[name] + (divisor is not None)) * n
    (rows,) = shape
    return WIRE_OPS[name] * rows * Q.BLOCK


def _wire_call(name: str, shape, gen, dev) -> tuple:
    """(kernel call, plain call) of one wire launch shape, on fresh
    inputs."""
    if name in _WIRE_LEG2:
        kern, plain, shards = _WIRE_LEG2[name]
        q_t, s_t = shards(*shape, gen, dev)
        return lambda: kern(q_t, s_t), lambda: plain(q_t, s_t)
    if name == "block_dequant":
        rows, n, divisor = shape
        q, s = Q.quantize_int8_sr(_wire_input(rows, gen, dev), WIRE_SEED)
        return (lambda: Q.dequantize(q, s, divisor, n),
                lambda: Q.dequantize_plain(q, s, divisor, n))
    x = _wire_input(shape[0], gen, dev)
    _, kern, plain = next(c for c in _WIRE_QUANT if c[0] == name)
    return lambda: kern(x), lambda: plain(x)


def _copy_call(nbytes: int, dev):
    """``copy_`` of nbytes / 2 bytes: the same bytes moved, nothing
    computed (the yardstick of a bytes-bound call)."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


# the wire kernels of phase 11: name → (the path whose step launches
# it, the reference's kernel line in theanompi_tpu/parallel/quantize.py)
WIRE_KERNELS = (("block_quant_int8", "int8", 107),
                ("block_quant_int8_sr", "int8_sr", 134),
                ("block_quant_fp16", "fp16s", 207),
                ("block_dequant", "int8_sr", 218),
                ("block_dequant_sum_quant_int8", "int8", 107),
                ("block_dequant_sum_quant_int8_sr", "int8_sr", 134),
                ("block_dequant_sum_quant_fp16", "fp16s", 207))


def phase_wire_kernels(dev: torch.device, lm_sizes, alex_sizes) -> list:
    """The wire kernels against their plain versions, exact, at the LM's
    4 MB bucket (world 2) and at AlexNet-128's largest bucket, the fused
    legs 2 and the dequantize with n and divisor at their edges, then
    their times per call and per LM step at a world of 2."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    errs = {}
    n_lm = 4 << 20 >> 2  # one 4 MB bucket of fp32
    nb_lm = blocks_per_shard(n_lm, WIRE_WORLD, "int8_sr")
    n_alex = max(alex_sizes)
    nb_alex = blocks_per_shard(n_alex, WIRE_WORLD, "int8_sr")
    lm_where = "LM 4 MB bucket"
    alex_where = f"AlexNet-128 largest bucket, {n_alex} fp32"
    for where, nb in ((lm_where, nb_lm), (alex_where, nb_alex)):
        for shape in ((WIRE_WORLD, nb, Q.BLOCK), (nb, Q.BLOCK)):
            x = _wire_input(WIRE_WORLD * nb if len(shape) == 3 else nb,
                            gen, dev).view(shape)
            for k, v in _wire_exact(x, where).items():
                errs[k] = max(errs.get(k, 0.0), v)
            print(f"wire kernels at {shape} ({where}): int8, int8_sr (seed "
                  f"{WIRE_SEED:#x}), fp16 payloads, scales and dequantized "
                  "values equal to the plain versions")
    for name, (_, _, shards) in _WIRE_LEG2.items():
        leg2 = []
        for world, nb, where in ((WIRE_WORLD, nb_lm, lm_where),
                                 (WIRE_WORLD, nb_alex, alex_where),
                                 (4, nb_lm, "world 4"),
                                 (WIRE_WORLD, 1, "nb 1")):
            leg2.append(_leg2_exact(name, *shards(world, nb, gen, dev),
                                    where))
        q_t, s_t = shards(WIRE_WORLD, 37, gen, dev)
        leg2.append(_leg2_exact(name, _off16(q_t), _off16(s_t),
                                "inputs 16 bytes off their base"))
        errs[name] = max(leg2)
    deq = []
    for world in (WIRE_WORLD, 3, 4):
        q, s = Q.quantize_int8_sr(_wire_input(world * nb_lm, gen, dev).view(
            world, nb_lm, Q.BLOCK), WIRE_SEED)
        qh, sh = Q.quantize_fp16(_wire_input(world * 37, gen, dev).view(
            world, 37, Q.BLOCK))
        full = q.numel()
        for qq, ss, n, div in ((q, s, full, world), (q, s, full - 37, world),
                               (q, s, 1, world), (q, s, full - 37, None),
                               (qh, sh, qh.numel() - 300, world),
                               (_off16(q), s, full - 5, world)):
            deq.append(_dequant_exact(qq, ss, div, n, f"world {world}"))
    errs["block_dequant"] = max(errs["block_dequant"], max(deq))
    print(f"block_dequant with n and divisor: {len(deq)} calls (worlds "
          f"{WIRE_WORLD}, 3, 4; n whole, short of a block by 37 and 5, 1; "
          "int8 and fp16; no divisor; a payload 16 bytes off its base) "
          "equal to the plain version")
    steps = {path: _wire_step_calls(lm_sizes, path)
             for path in ("int8", "int8_sr", "fp16s")}
    leg1 = (WIRE_WORLD * nb_lm,)  # the per-call shapes: one 4 MB bucket
    per_call = dict(block_quant_int8=leg1, block_quant_int8_sr=leg1,
                    block_quant_fp16=leg1,
                    block_dequant=(WIRE_WORLD * nb_lm, n_lm, WIRE_WORLD),
                    **{name: (WIRE_WORLD, nb_lm) for name in _WIRE_LEG2})
    shapes = set(per_call.items())
    for name, path, _ in WIRE_KERNELS:
        shapes |= {(name, shape) for shape in steps[path][name]}
    times, copies = {}, {}
    for name, shape in sorted(shapes, key=str):
        kern, plain = _wire_call(name, shape, gen, dev)
        nbytes = _wire_bytes(name, shape)
        times[name, shape] = (_time_ms(kern, flush), _time_ms(plain, flush))
        if nbytes not in copies:
            copies[nbytes] = _time_ms(_copy_call(nbytes, dev), flush)
    # the quantizers and legs 2 at AlexNet-128's largest bucket, where
    # bytes rather than launch latency bound a call (kernel and copy_)
    big = {name: (WIRE_WORLD * nb_alex,) for name in WIRE_QUANT.values()}
    big.update({name: (WIRE_WORLD, nb_alex) for name in _WIRE_LEG2})
    for name, shape in big.items():
        kern, _ = _wire_call(name, shape, gen, dev)
        nbytes = _wire_bytes(name, shape)
        times[name, shape] = (_time_ms(kern, flush), None)
        if nbytes not in copies:
            copies[nbytes] = _time_ms(_copy_call(nbytes, dev), flush)
    rows = []
    for name, path, line in WIRE_KERNELS:
        call = per_call[name]
        launches = steps[path][name]
        nbytes = sum(_wire_bytes(name, sh) for sh in launches)
        ops = sum(_wire_ops(name, sh) for sh in launches)
        bound_ms, bound_by = _bound(nbytes, ops)
        call_bound, _ = _bound(_wire_bytes(name, call), _wire_ops(name, call))
        row = dict(
            name=name, replaces=f"theanompi_tpu/parallel/quantize.py:{line}",
            path=path, max_abs_err=errs[name],
            ms=sum(times[name, sh][0] for sh in launches),
            plain_ms=sum(times[name, sh][1] for sh in launches),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            copy_ms=sum(copies[_wire_bytes(name, sh)] for sh in launches),
            launches_per_step=len(launches), bytes_per_step=nbytes,
            call_shape=list(call), call_ms=times[name, call][0],
            call_plain_ms=times[name, call][1], call_bound_ms=call_bound,
            call_copy_ms=copies[_wire_bytes(name, call)])
        if name in big:
            shape = big[name]
            row.update(alex_shape=list(shape), alex_ms=times[name, shape][0],
                       alex_bound_ms=_bound(_wire_bytes(name, shape),
                                            _wire_ops(name, shape))[0],
                       alex_copy_ms=copies[_wire_bytes(name, shape)])
            print(f"{name} at {shape} ({alex_where}): kernel "
                  f"{row['alex_ms']:.4f} ms, bound {row['alex_bound_ms']:.4f}"
                  f" ms ({row['alex_bound_ms'] / row['alex_ms']:.3f} of it),"
                  f" copy_ of the same bytes {row['alex_copy_ms']:.4f} ms")
        rows.append(row)
        print(f"{name}: max|err| {row['max_abs_err']:.1e} (exact); per call "
              f"at {call}: kernel {row['call_ms']:.4f} ms, plain "
              f"{row['call_plain_ms']:.4f} ms, bound {call_bound:.4f} ms, "
              f"copy_ of the same bytes {row['call_copy_ms']:.4f} ms; per "
              f"LM step of {path} at world {WIRE_WORLD} ({len(launches)} "
              f"launches): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {nbytes} B), copy_ {row['copy_ms']:.4f} ms; "
              "library none (no one PyTorch call quantizes per 256-block "
              "amax)")
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
    """Launch counts the bucket plan predicts over ``steps`` steps, per
    live bucket and step for every block strategy: 1 quantize (``int8``
    RN, ``int8_sr`` SR, ``fp16s`` fp16), 1 fused leg 2 of that wire and
    1 dequantize; with error feedback one more dequantize (the leg-1
    image)."""
    per = sum(blocks_per_shard(n, WIRE_WORLD, strategy) is not None
              for n in sizes) * steps
    want = {fn.__name__: 0 for fn in Q.WRAPPERS}
    suffix = strategy.replace("pallas_", "").replace("fp16s", "fp16")
    want.update({f"quantize_{suffix}": per,
                 f"dequant_sum_quantize_{suffix}": per,
                 "dequantize": per * (2 if ef else 1)})
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
        _print_port_kernels(prof, "    ")
        wire = [k for n, k in prof["port_kernels"].items()
                if _step_part(n) == WIRE_PART]
        n_wire = sum(k["launches_per_step"] for k in wire)
        us_wire = sum(k["us_per_launch"] * k["launches_per_step"]
                      for k in wire)
        print(f"    the wire kernels inside the step: {us_wire / 1e3:.4f} "
              f"ms/step in {n_wire:g} launches ({us_wire / max(n_wire, 1):.2f}"
              " us a launch)")
    print(f"  int8_sr mean of {sr['name']} ({sr['n']} fp32) vs the fp32 "
          f"all_reduce mean: max|err| {sr['max_err']:.3e} <= 2·max|g|/127 = "
          f"{sr['atol']:.3e} ({sr['inexact']} elements inexact)")
    for label, _ in BSP2_MORE:
        g = r0["more"][label]
        print(f"  {label}: {BSP2_MORE_STEPS} steps, launches {g['launches']}"
              f", loss {g['loss']:.4f}, parameters equal across the ranks")
    return dict(wall_s=wall, ranks=res, want_launches=want)


def _write_raw_imagenet(root: str) -> float:
    """(a): LAUNCH_STEPS raw shards of 128 synthetic ImageNet-128 images
    (the synthetic provider's class structure, seeded)."""
    t0 = time.perf_counter()
    size = AlexNet.default_config["image_size"]
    batches = [_synthetic_classification(
        AlexNet.default_config["batch_size"], (size, size, 3),
        AlexNet.default_config["n_classes"], seed=SEED + i, proto_seed=SEED)
        for i in range(LAUNCH_STEPS)]
    write_shard_dir(os.path.join(root, "train"), batches)
    return time.perf_counter() - t0


def _launch_crash_restart(data_dir: str, ckpt_dir: str) -> dict:
    """(b): the launcher with a crash injected once and a restart."""
    plan = FaultInjector([(0, LAUNCH_CRASH_AT)])
    seen, steps = [], [0]
    real_iter, real_adjust = TpuModel.train_iter, TpuModel.adjust_hyperp

    def train_iter(self, count, recorder):
        plan.maybe_fail(self.rank, count)
        steps[0] += 1
        return real_iter(self, count, recorder)

    def adjust_hyperp(self, epoch):
        seen.append((self, epoch))
        return real_adjust(self, epoch)

    cfg = dict(LAUNCH_CFG, data_dir=data_dir)
    LR.lrn_fwd.launches = LR.lrn_bwd.launches = PO.maxpool_bwd.launches = 0
    TpuModel.train_iter, TpuModel.adjust_hyperp = train_iter, adjust_hyperp
    t0 = time.perf_counter()
    try:
        rc = launch.main(["--preset", "alexnet-bsp", "--devices", "1",
                          "--config", json.dumps(cfg), "--checkpoint-dir",
                          ckpt_dir, "--keep-last", "1", "--restarts", "1"])
        torch.cuda.synchronize()
    finally:
        TpuModel.train_iter, TpuModel.adjust_hyperp = real_iter, real_adjust
    wall = time.perf_counter() - t0
    launches = dict(lrn_fwd=LR.lrn_fwd.launches, lrn_bwd=LR.lrn_bwd.launches,
                    maxpool_bwd=PO.maxpool_bwd.launches)
    ran = LAUNCH_EPOCHS * LAUNCH_STEPS + LAUNCH_CRASH_AT - LAUNCH_STEPS - 1
    epochs = [e for _, e in seen]
    models = list(dict.fromkeys(m for m, _ in seen))
    if rc != 0 or epochs != [0, 1, 1] or len(models) != 2:
        raise AssertionError(f"launch: rc {rc}, epochs started {epochs} "
                             f"by {len(models)} models; want [0, 1, 1] by "
                             "2 (a crash in epoch 2, resumed at epoch 1)")
    trained = models[-1]
    if (trained.current_epoch != LAUNCH_EPOCHS or not trained.data.raw_meta
            or trained.n_workers != 1):
        raise AssertionError(f"launch: ended at epoch {trained.current_epoch}"
                             f", raw {bool(trained.data.raw_meta)}")
    want = dict(lrn_fwd=2 * ran, lrn_bwd=2 * ran, maxpool_bwd=3 * ran)
    if steps[0] != ran or launches != want:
        raise AssertionError(f"launch: {steps[0]} steps ran, launches "
                             f"{launches}; want {ran} steps, {want}")
    left = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
    if left != [f"ckpt_{LAUNCH_EPOCHS:04d}.npz"]:
        raise AssertionError(f"launch: checkpoints left {left}, want one")
    path = os.path.join(ckpt_dir, left[0])
    fresh = AlexNet(config=dict(cfg), device=trained.device)
    fresh.load_model(path)
    for a, b in zip(fresh.params, trained.params):
        if not torch.equal(a, b):
            raise AssertionError("launch: the loaded parameters differ from "
                                 "the trained ones")
    rows = Recorder.load(os.path.join(ckpt_dir, "record_rank0.jsonl"))
    epoch_s = sum(r["seconds"] for r in rows if r["kind"] == "epoch")
    wait_s = sum(r["wait"] for r in rows if r["kind"] == "train")
    return dict(wall_s=wall, steps=ran, launches=launches,
                resumed_epochs=epochs, checkpoint=left[0],
                resumed_epoch_s=epoch_s, resumed_wait_s=wait_s,
                data_wait_share=wait_s / epoch_s,
                model=fresh, checkpoint_path=path)


def _save_times(model, root: str) -> dict:
    """(d): one checkpoint of AlexNet-128, synchronous and async."""
    t0 = time.perf_counter()
    path = model.save_model(os.path.join(root, "sync.npz"))
    sync = time.perf_counter() - t0
    with ckpt.AsyncCheckpointer() as writer:
        t0 = time.perf_counter()
        model.save_model(os.path.join(root, "async.npz"), checkpointer=writer)
        stall = time.perf_counter() - t0
        writer.wait()
        behind = time.perf_counter() - t0
    return dict(sync_s=sync, async_stall_s=stall, async_total_s=behind,
                bytes=os.path.getsize(path))


def _launch_two_ranks(ckpt_dir: str) -> dict:
    """(c): two ranks on this card through the CLI."""
    log_path = ckpt_dir + ".log"
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.launch", "--preset",
           "alexnet-bsp", "--devices", "2", "--spawn-procs", "2",
           "--config", json.dumps(LAUNCH2_CFG), "--checkpoint-dir",
           ckpt_dir]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
            __file__)), stdout=log, stderr=subprocess.STDOUT,
            timeout=LAUNCH2_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        out = f.read()
    if proc.returncode != 0:
        print(out[-6000:])
        raise AssertionError(f"launch --spawn-procs 2: exit "
                             f"{proc.returncode}")
    files = sorted(os.listdir(ckpt_dir))
    want = ["ckpt_0001.npz", "record_rank0.jsonl", "record_rank1.jsonl"]
    if files != want:
        raise AssertionError(f"launch --spawn-procs 2: files {files}, want "
                             f"{want} (one checkpoint, from rank 0)")
    blob = ckpt.restore(os.path.join(ckpt_dir, "ckpt_0001.npz"))
    ef = []
    ckpt.map_tree(ef.append, blob["opt_state"]["ef_wire"])
    if not ef or any(a.shape[0] != 2 for a in ef) or (
            blob["torch_state"]["world"] != 2):
        raise AssertionError("launch --spawn-procs 2: ef_wire leading axes "
                             f"{sorted({a.shape[0] for a in ef})}, want 2")
    digests = [[r["sha1"] for r in Recorder.load(os.path.join(
        ckpt_dir, f"record_rank{k}.jsonl")) if r["kind"] == "params"]
        for k in (0, 1)]
    if len(digests[0]) != 1 or digests[0] != digests[1]:
        raise AssertionError(f"launch --spawn-procs 2: parameters differ "
                             f"across the ranks: {digests}")
    if "gloo world of 2 on cuda:0" not in out:
        raise AssertionError("launch --spawn-procs 2: not a gloo world of 2 "
                             "on cuda:0")
    steps = [r["iter"] for r in Recorder.load(os.path.join(
        ckpt_dir, "record_rank0.jsonl")) if r["kind"] == "epoch"]
    return dict(wall_s=wall, steps=steps[-1], ef_leaves=len(ef),
                params_sha1=digests[0][0],
                checkpoint_bytes=os.path.getsize(
                    os.path.join(ckpt_dir, "ckpt_0001.npz")))


def phase_launch(train: dict) -> dict:
    """Phase 13; see the module docstring."""
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    try:
        data, one, two = (os.path.join(root, d) for d in ("data", "one",
                                                          "two"))
        write_s = _write_raw_imagenet(data)
        res = _launch_crash_restart(data, one)
        model = res.pop("model")
        res["save"] = _save_times(model, root)
        del model
        destroy_process_group()
        torch.cuda.empty_cache()
        res["two_ranks"] = _launch_two_ranks(two)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["write_s"] = write_s
    res.pop("checkpoint_path")
    sv, tr = res["save"], res["two_ranks"]
    print(f"launch: (a) {LAUNCH_STEPS} raw shards of 128 ImageNet-128 "
          f"images written in {write_s:.2f} s; (b) launch.main --preset "
          f"alexnet-bsp --devices 1 over them, {LAUNCH_EPOCHS} epochs of "
          f"{LAUNCH_STEPS} steps, a crash injected at step {LAUNCH_CRASH_AT}"
          f", restarted at epoch {res['resumed_epochs'][-1]}: "
          f"{res['wall_s']:.2f} s, {res['steps']} steps ran, launches "
          f"{res['launches']}, {res['checkpoint']} left and loaded "
          "bitwise; (c) --spawn-procs 2 on this card (gloo, int8 + EF): "
          f"{tr['wall_s']:.2f} s for {tr['steps']} steps, one checkpoint "
          f"of {tr['checkpoint_bytes'] / 2**20:.0f} MiB from rank 0, "
          f"ef_wire with a leading axis of 2 on its {tr['ef_leaves']} "
          "leaves, parameters equal across the ranks")
    print(f"  host waited on data: raw shards (native loader, resumed epoch)"
          f" {res['resumed_wait_s']:.3f} s of {res['resumed_epoch_s']:.3f} s "
          f"({100 * res['data_wait_share']:.1f} %); phase 6's synthetic run "
          f"{100 * train['data_wait_share']:.1f} %")
    print(f"  one checkpoint of AlexNet-128 ({sv['bytes'] / 2**20:.0f} MiB): "
          f"sync save {sv['sync_s']:.3f} s; async: the loop stalls "
          f"{sv['async_stall_s']:.3f} s, on disk after "
          f"{sv['async_total_s']:.3f} s")
    return res


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
    lrn_edges = phase_lrn_edges(dev)
    pool_edges = phase_pool_edges(dev)
    flash_rows = phase_flash_kernels(dev)
    flash_edges = phase_flash_edges(dev)
    serve, serve_ctx = phase_serve(dev)
    serve_i8 = phase_serve_int8(dev, serve_ctx)
    serve_sampled = phase_serve_sampled(dev, serve_ctx)
    profiles = phase_serve_profiles(serve_ctx)
    serve["tick_profile"], serve_i8["tick_profile"] = (profiles["fp32"],
                                                       profiles["int8"])
    del serve_ctx
    train = phase_train(dev)
    oracle = phase_train_oracle(dev)
    lm = phase_lm_train(dev)
    lm_oracle = phase_lm_oracle(dev)
    wire_rows = phase_wire_kernels(dev, lm["wire_sizes"], train["wire_sizes"])
    destroy_process_group()
    bsp2 = phase_lm_bsp2(dev)
    launched = phase_launch(train)
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
    int8, fp16 = (r0["more"][k]["launches"] for k in ("int8+ef", "fp16s"))
    wire_launches = dict(
        block_quant_int8=int8["quantize_int8"],
        block_quant_int8_sr=r0["launches"]["quantize_int8_sr"],
        block_quant_fp16=fp16["quantize_fp16"],
        block_dequant=r0["launches"]["dequantize"],
        block_dequant_sum_quant_int8=int8["dequant_sum_quantize_int8"],
        block_dequant_sum_quant_int8_sr=r0["launches"][
            "dequant_sum_quantize_int8_sr"],
        block_dequant_sum_quant_fp16=fp16["dequant_sum_quantize_fp16"])
    for row in wire_rows:
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": "theanompi_tpu_torch/csrc/block_quant.cu",
            "replaces": row["replaces"],
            "launches": wire_launches[row["name"]],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        })
    print(json.dumps({
        "serve": {k: v for k, v in serve.items() if k != "stats"},
        "serve_int8": serve_i8, "serve_sampled": serve_sampled,
        **{f"paged_decode_attention_{name}": {
            k: v for k, v in kern[dt].items() if k != "bytes"
        } for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                           ("i8", torch.int8))},
        "paged_edges": kern["edges"],
        "train": train, "train_oracle": oracle,
        "train_kernels": [dict(r, shape=list(r["shape"])) for r in train_rows],
        "lm_train": lm, "lm_oracle": lm_oracle,
        "flash_kernels": [dict(r, shape=list(r["shape"]))
                          for r in flash_rows],
        "lrn_edges": lrn_edges, "pool_edges": pool_edges,
        "flash_edges": flash_edges,
        "wire_kernels": wire_rows, "lm_bsp2": bsp2, "launch": launched,
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
