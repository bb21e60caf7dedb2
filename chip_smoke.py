"""Drive the PyTorch/CUDA port (``theanompi_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. environment — torch and CUDA versions, the card's name and power
   limit as ``nvidia-smi`` reports them, ``nvcc``, whether ``triton``
   imports; TF32 is switched off for every fp32 product.
2. build — every CUDA kernel of the serving path, from ``csrc/``.
3. kernel vs plain — the paged decode attention kernel against its
   plain PyTorch version at the serving path's full width (32 lanes,
   8 heads, head_dim 64, block 32, 32-entry tables, lengths 0..1023),
   fp32 and bf16 pools; times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` over the pre-gathered image (the
   one-call yardstick, used nowhere in the port), beside the bound.
4. serve — ``TransformerLM`` at the flagship serving config (d_model
   512, 8 heads, 8 layers, vocab 4096, seq_len 1024; seeded random
   weights) behind ``PagedServingEngine`` (32 slots, block 32, 257
   blocks, prefill chunk 256) and ``ContinuousBatchingScheduler``: 8
   greedy requests, prompts of 16..256 tokens, 32 new tokens each.
   The kernel's launch count over this run must equal n_layers × decode
   ticks, and every request's tokens must equal greedy decoding by the
   no-cache full-recompute forward on the card.

Prints, before the last line, a JSON line of the serving numbers and
the bf16 kernel instance, then the JSON line ``{"kernels": [...]}``
(the fp32 instance, which the serving path runs), and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when no card is present or the port is not importable.
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

from theanompi_tpu_torch import cuda_build
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.ops import paged_attention as PA
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
    paths = cuda_build.build([PA.KERNEL])
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
    serve = phase_serve(dev)
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
    print(json.dumps({
        "serve": {k: v for k, v in serve.items() if k != "stats"},
        "paged_decode_attention_bf16": {
            k: v for k, v in kern[torch.bfloat16].items() if k != "bytes"
        },
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
