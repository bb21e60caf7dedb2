"""Recorder — per-iteration timing and metric bookkeeping.

The port's own copy of ``theanompi_tpu.runtime.recorder.Recorder``'s
surface that ``train_iter`` and the worker call (the reference imports
jax inside it).  Wall-clock time is split into calc / comm / wait /
load segments; the running train loss and error are summed lazily (the
values may be device tensors, so bookkeeping forces no per-step
device sync) and read once per print window.

Honesty note: CUDA launches are asynchronous, so ``calc`` measures the
host's enqueue of the step unless something in it waits for the device
(a full launch queue, a host read).  ``wait`` is the host blocked on
the data loader.  Throughput comes from a device-synchronized wall
clock (``utils.benchmark``).  ``totals`` keeps each segment's seconds
over the whole run (the print window's sums are reset at each print).

``log_event`` records one-off rows (memory snapshots, …) beside the
epoch rows; ``save`` writes the record as JSONL and ``load`` reads it
back.  With ``tensorboard_dir`` the record is mirrored to TensorBoard
event files through ``torch.utils.tensorboard``, as the reference
mirrors it; when that writer is unavailable the recorder says so once
and keeps the JSONL record only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

PHASES = ("calc", "comm", "wait", "load")


class Recorder:
    def __init__(self, print_freq: int = 40, rank: int = 0,
                 verbose: bool = True, save_dir: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self.print_freq = int(print_freq)
        self.rank = rank
        self.verbose = verbose
        self.save_dir = save_dir
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except Exception as e:
                print(f"tensorboard writer unavailable "
                      f"({type(e).__name__}: {e}); recording JSONL only",
                      flush=True)
        self._t0: Dict[str, float] = {}
        self._acc: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.history: List[dict] = []
        self.val_history: List[dict] = []
        self.events: List[dict] = []
        self._train_cost = 0.0
        self._train_err = 0.0
        self._train_n = 0
        self.epoch_start: Optional[float] = None

    # ---- timing segments ------------------------------------------------
    def start(self, what: str = "calc") -> None:
        self._t0[what] = time.perf_counter()

    def end(self, what: str = "calc") -> float:
        t0 = self._t0.pop(what, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self._acc[what] = self._acc.get(what, 0.0) + dt
        self.totals[what] = self.totals.get(what, 0.0) + dt
        return dt

    # ---- epoch ----------------------------------------------------------
    def start_epoch(self) -> None:
        self.epoch_start = time.perf_counter()

    def end_epoch(self, count: int, epoch: int) -> float:
        dt = (time.perf_counter() - self.epoch_start
              if self.epoch_start is not None else 0.0)
        if self.verbose and self.rank == 0:
            print(f"epoch {epoch} took {dt:.2f}s", flush=True)
        if self._tb is not None:
            self._tb.add_scalar("epoch/seconds", dt, epoch)
        self.events.append({"kind": "epoch", "epoch": epoch, "iter": count,
                            "seconds": dt})
        self.epoch_start = None
        return dt

    # ---- train metrics --------------------------------------------------
    def train_error(self, count: int, cost, error) -> None:
        self._train_cost = self._train_cost + cost
        self._train_err = self._train_err + error
        self._train_n += 1

    def print_train_info(self, count: int, force: bool = False) -> None:
        if (count % self.print_freq != 0 and not force) or self._train_n == 0:
            return
        n = self._train_n
        row = {
            "iter": count,
            "cost": float(self._train_cost) / n,  # the one sync per window
            "error": float(self._train_err) / n,
            **{p: self._acc.get(p, 0.0) for p in PHASES},
        }
        self.history.append(row)
        if self._tb is not None:
            self._tb.add_scalar("train/cost", row["cost"], count)
            self._tb.add_scalar("train/error", row["error"], count)
            for p in PHASES:
                self._tb.add_scalar(f"time/{p}", row[p], count)
        if self.verbose and self.rank == 0:
            t = {p: row[p] for p in PHASES}
            print(
                f"iter {count}: cost {row['cost']:.4f} err {row['error']:.4f} "
                f"| calc {t['calc']:.3f}s comm {t['comm']:.3f}s "
                f"wait {t['wait']:.3f}s load {t['load']:.3f}s",
                flush=True,
            )
        self._train_cost = self._train_err = 0.0
        self._train_n = 0
        for p in PHASES:
            self._acc[p] = 0.0

    # ---- one-off events -------------------------------------------------
    def log_event(self, kind: str, **fields) -> None:
        """Record a structured one-off row (saved with its own
        ``kind``; printed on rank 0)."""
        self.events.append({"kind": kind, **fields})
        if self._tb is not None:
            self._tb.add_text(f"event/{kind}", json.dumps(fields))
        if self.verbose and self.rank == 0:
            body = " ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in fields.items())
            print(f"[{kind}] {body}", flush=True)

    # ---- val metrics ----------------------------------------------------
    def val_error(self, count: int, cost: float, error: float,
                  error_top5: float = 0.0) -> None:
        self.val_history.append({"iter": count, "cost": float(cost),
                                 "error": float(error),
                                 "error_top5": float(error_top5)})
        if self._tb is not None:
            self._tb.add_scalar("val/cost", float(cost), count)
            self._tb.add_scalar("val/error", float(error), count)
            self._tb.add_scalar("val/error_top5", float(error_top5), count)

    def print_val_info(self, count: int) -> None:
        if self.val_history and self.verbose and self.rank == 0:
            row = self.val_history[-1]
            print(f"val @ iter {count}: cost {row['cost']:.4f} "
                  f"err {row['error']:.4f} err5 {row['error_top5']:.4f}",
                  flush=True)

    # ---- persistence ----------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        """Dump the record as JSONL (events, train rows, val rows)."""
        if self._train_n:
            last = (self.history[-1]["iter"] if self.history else 0)
            self.print_train_info(last + self._train_n, force=True)
        if path is None:
            d = self.save_dir or "."
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"record_rank{self.rank}.jsonl")
        with open(path, "w") as f:
            for row in self.events:
                f.write(json.dumps(row) + "\n")
            for row in self.history:
                f.write(json.dumps({"kind": "train", **row}) + "\n")
            for row in self.val_history:
                f.write(json.dumps({"kind": "val", **row}) + "\n")
        if self._tb is not None:
            self._tb.flush()
        return path

    def close(self) -> None:
        """Release the TensorBoard writer (no-op without one)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    @staticmethod
    def load(path: str) -> List[dict]:
        """The rows of a saved record."""
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
