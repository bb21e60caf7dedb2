"""Drive the PyTorch/CUDA port (``theanompi_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. environment — torch and CUDA versions, the card's name and power
   limit as ``nvidia-smi`` reports them, ``nvcc``, whether ``triton``
   imports; TF32 is switched off for every fp32 product.
2. build — every CUDA kernel of the port (paged decode attention, LRN,
   max-pool backward), from ``csrc/``, one ``nvcc`` each, all at once.
3. kernel vs plain (serving) — the paged decode attention kernel
   against its plain PyTorch version at the serving path's full width
   (32 lanes, 8 heads, head_dim 64, block 32, 32-entry tables, lengths
   0..1023), fp32 and bf16 pools; times of the kernel, the plain
   version and ``F.scaled_dot_product_attention`` over the pre-gathered
   image (the one-call yardstick, used nowhere in the port), beside the
   bound.
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
   the LRN backward), beside the bound.
5. serve — ``TransformerLM`` at the flagship serving config (d_model
   512, 8 heads, 8 layers, vocab 4096, seq_len 1024; seeded random
   weights) behind ``PagedServingEngine`` (32 slots, block 32, 257
   blocks, prefill chunk 256) and ``ContinuousBatchingScheduler``: 8
   greedy requests, prompts of 16..256 tokens, 32 new tokens each.
   The kernel's launch count over this run must equal n_layers × decode
   ticks, and every request's tokens must equal greedy decoding by the
   no-cache full-recompute forward on the card.
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

Prints, before the last line, a JSON line of the serving and training
numbers and the kernel instances, then the JSON line
``{"kernels": [...]}`` — the paged kernel's fp32 instance (what the
serving path runs) and, for each training kernel, its bf16 instance
(what the training path runs) summed over the shapes of one step — and
as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result, when no card is present or the port is not importable.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from theanompi_tpu_torch import BSP, cuda_build
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.ops import lrn as LR
from theanompi_tpu_torch.ops import paged_attention as PA
from theanompi_tpu_torch.ops import pool as PO
from theanompi_tpu_torch.runtime.dist import destroy_process_group
from theanompi_tpu_torch.utils.benchmark import images_per_sec
from theanompi_tpu_torch.serving import (
    ContinuousBatchingScheduler, PagedServingEngine, Request,
)

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
SERVE_CFG = dict(d_model=512, n_heads=8, n_layers=8, vocab_size=4096,
                 seq_len=1024)
SERVE_ENGINE = dict(n_slots=32, max_len=1024, block_size=32, n_blocks=257,
                    prefill_chunk=256)
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 8, 16, 256, 32
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TIE_MARGIN = 1e-4
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
    paths = cuda_build.build([PA.KERNEL, LR.KERNEL, PO.KERNEL])
    dt = time.perf_counter() - t0
    for name, path in paths.items():
        print(f"built {name}: {path.name} ({dt:.1f} s)")
        log = path.with_name(path.name + ".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
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
    return results


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


def phase_serve(dev: torch.device) -> dict:
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

    timeline = _Timeline()
    sched = ContinuousBatchingScheduler(engine, metrics=timeline)
    reqs = [Request(id=f"r{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches

    ticks = sched.stats["decode_ticks"]
    want = engine.n_layers * ticks
    if launches != want or launches == 0:
        raise AssertionError(
            f"paged kernel launched {launches} times over the serving run; "
            f"want n_layers × decode ticks = {want}")
    for r in reqs:
        if len(r.output) != NEW_TOKENS or not all(0 <= t < vocab
                                                  for t in r.output):
            raise AssertionError(f"{r.id}: bad output {r.output}")
        _oracle_check(model, dev, r)
    n_tok = sum(len(r.output) for r in reqs)
    ttft = [timeline.first_at[r.id] - timeline.admitted_at[r.id]
            for r in reqs]
    tick_ms = [1e3 * (timeline.done_at[r.id] - timeline.first_at[r.id])
               / (len(r.output) - 1) for r in reqs]
    out = dict(
        tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        ttft_ms_median=1e3 * float(np.median(ttft)),
        ttft_ms_max=1e3 * float(np.max(ttft)),
        decode_tick_ms_median=float(np.median(tick_ms)),
        decode_ticks=ticks, launches=launches,
        stats=timeline.engine_stats,
    )
    print(f"serve: {N_REQUESTS} requests, {n_tok} tokens in {wall:.3f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s; TTFT median "
          f"{out['ttft_ms_median']:.2f} ms, max {out['ttft_ms_max']:.2f} ms; "
          f"decode tick {out['decode_tick_ms_median']:.3f} ms; {ticks} decode "
          f"ticks, {launches} kernel launches; all requests match the "
          f"full-recompute oracle")
    print(f"serve stats: {json.dumps(timeline.engine_stats, sort_keys=True)}")
    return out


def _relu_input(rng, shape, dt, dev) -> torch.Tensor:
    x = torch.from_numpy(np.maximum(rng.randn(*shape), 0).astype(np.float32)
                         * 2.0)
    return x.to(dev).to(dt)


def _check_close(name, got, want, dt) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    tol = KERNEL_TOL[dt]
    bad = (g - w).abs() > tol["atol"] + tol["rtol"] * w.abs()
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(
            f"{name} ({dt}): {int(bad.sum())} elements outside "
            f"rtol {tol['rtol']} atol {tol['atol']} of the plain version")
    return float((g - w).abs().max())


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
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
    return out


PROFILE_STEPS = 10
# kernel name → part of the step (lower-case substrings, first match)
STEP_PARTS = (
    ("lrn (kernel)", ("lrn_fwd_kernel", "lrn_bwd_kernel")),
    ("pool bwd (kernel)", ("pool_share_kernel", "pool_gather_kernel")),
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


def phase_train_profile(model) -> dict:
    """Device time of the training step by part, and the device's idle
    share, from ``torch.profiler`` over PROFILE_STEPS steps on
    pre-loaded batches (after the counted run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.data.loader import rank_rows, to_device

    batches = [to_device(rank_rows(b, 0, 1), model.device)
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
    print(f"train profile ({PROFILE_STEPS} steps, bf16, batch "
          f"{model.global_batch}): {out['wall_ms_per_step']:.3f} ms/step "
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


def main() -> int:
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
    serve = phase_serve(dev)
    train = phase_train(dev)
    oracle = phase_train_oracle(dev)
    destroy_process_group()
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
    print(json.dumps({
        "serve": {k: v for k, v in serve.items() if k != "stats"},
        "paged_decode_attention_bf16": {
            k: v for k, v in kern[torch.bfloat16].items() if k != "bytes"
        },
        "train": train, "train_oracle": oracle,
        "train_kernels": [dict(r, shape=list(r["shape"])) for r in train_rows],
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
