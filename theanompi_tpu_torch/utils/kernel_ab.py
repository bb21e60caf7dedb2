"""Time two trees' flash and max-pool backward kernels on one card.

    python3 theanompi_tpu_torch/utils/kernel_ab.py OLD_TREE NEW_TREE \
        [--order old,new,new,old] [--lm-step] [--out FILE]

Each tree is a checkout of the repository (``OLD_TREE`` typically a
``git archive`` of the parent commit in an ignored directory).  For
each entry of ``--order`` the script starts itself as a child process
with ``PYTHONPATH`` set to that tree, so the child imports and builds
that tree's ``theanompi_tpu_torch`` and its kernels from that tree's
``csrc/``.  The child times, on the card, with a cold L2 (a 256 MiB
memset before each call) and as the median of 30 calls:

- ``flash_fwd`` on bf16 rows at the LM path's shape (B·H 64, T 1024,
  D 64, causal), and ``F.scaled_dot_product_attention`` on the same
  inputs (the one-call yardstick);
- ``flash_dq`` and ``flash_dkv`` on the same rows, with dO from the
  seed and lse from that tree's ``flash_fwd``, and aten's
  ``_scaled_dot_product_flash_attention_backward`` alone, fed what
  aten's flash forward returns (dQ, dK and dV in one call);
- ``maxpool_bwd`` (bf16, 3×3/2) at AlexNet-128's three pool inputs at
  batch 128, and aten's ``max_pool2d_with_indices_backward``;
- with ``--lm-step``, the end-to-end training step of ``TransformerLM``
  at the serving flagship's width (d_model 512, 8 heads, 8 layers,
  vocab 4096, seq_len 1024), batch 8, bf16, flash, through
  ``BSP().init`` on a world of 1: ``utils.benchmark.measure_step_time``
  over 20 steps, five times, the median (host clock after a device
  sync, so host dispatch is in it);

and prints one JSON line.  The parent prints the card's name and power
limit (``nvidia-smi``) and every child's line, then the medians per
tree, and writes them all to ``--out``.  Runs only on a CUDA card.
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
ITERS = 30


LM_STEP_CFG = dict(d_model=512, n_heads=8, n_layers=LM_LAYERS,
                   vocab_size=4096, seq_len=1024, batch_size=8,
                   compute_dtype="bfloat16", attn_impl="flash",
                   exch_strategy="ar", n_synth_train=8, n_synth_val=1,
                   n_epochs=1)


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


def _child(lm_step: bool) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import flash as FL
    from theanompi_tpu_torch.ops import pool as PO

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(ITERS):
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
    bh, t, d = LM_ROWS
    q, k, v = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
               .to(dev).bfloat16() for _ in range(3))
    scale = d ** -0.5
    q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
    out = dict(
        tree=os.environ.get("PYTHONPATH", ""),
        flash_fwd_ms=time_ms(lambda: FL.flash_fwd(q, k, v, True, scale)),
        sdpa_fwd_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale)),
        maxpool_bwd_ms=[], aten_pool_bwd_ms=[])
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
    out["aten_bwd_ms"] = time_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, True, seed,
            offset, scale=scale))
    out["flash_fwd_ms_per_step"] = LM_LAYERS * out["flash_fwd_ms"]
    out["sdpa_fwd_ms_per_step"] = LM_LAYERS * out["sdpa_fwd_ms"]
    out["flash_bwd_ms_per_step"] = LM_LAYERS * (out["flash_dq_ms"]
                                                + out["flash_dkv_ms"])
    out["aten_bwd_ms_per_step"] = LM_LAYERS * out["aten_bwd_ms"]
    out["maxpool_bwd_ms_per_step"] = sum(out["maxpool_bwd_ms"])
    out["aten_pool_bwd_ms_per_step"] = sum(out["aten_pool_bwd_ms"])
    if lm_step:
        out["lm_step_ms"] = _lm_step_ms(dev)
    return out


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        print(json.dumps(_child("--lm-step" in sys.argv[2:])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--order", default="old,new,new,old")
    ap.add_argument("--lm-step", action="store_true",
                    help="also time the LM training step (end to end)")
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
            [sys.executable, os.path.abspath(__file__), "--child"]
            + (["--lm-step"] if args.lm_step else []),
            cwd=trees[label], env=env, check=True, capture_output=True,
            text=True)
        row = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   label=label)
        runs.append(row)
        print(json.dumps(row))
    keys = ("flash_fwd_ms_per_step", "sdpa_fwd_ms_per_step",
            "flash_bwd_ms_per_step", "aten_bwd_ms_per_step",
            "maxpool_bwd_ms_per_step", "aten_pool_bwd_ms_per_step")
    keys += ("lm_step_ms",) if args.lm_step else ()
    summary = {}
    for label in trees:
        mine = [r for r in runs if r["label"] == label]
        summary[label] = {key: sorted(r[key] for r in mine) for key in keys}
    result = dict(card=card, order=args.order, runs=runs, summary=summary)
    print(json.dumps(dict(card=card, summary=summary)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
