"""The BSP training loop — counterpart of
``theanompi_tpu.parallel.workers.BSP_Worker``, with its signature.

Every rank of the process group runs this same loop (the reference's
N MPI ranks; its single-controller JAX loop drove them all from one
process).  Rank 0 prints and writes checkpoints.  Per epoch: lr
schedule, the epoch's batches through ``train_iter``, validation every
``val_freq`` epochs, a snapshot every ``checkpoint_freq`` epochs
(``ckpt_{epoch:04d}.npz``; ``keep_last`` prunes to the newest N),
a memory event where the device reports its memory.  ``resume`` loads
the newest snapshot of ``checkpoint_dir`` first; ``watchdog_timeout``
arms the stall watchdog at the first completed iteration and pauses it
around validation and saves; ``tensorboard_dir`` mirrors rank 0's
record to TensorBoard.

Config keys ``comm_probe`` and ``log_wire_bytes`` are accepted and
inert here: the comm-fraction probe lands with the port's bench
(ROADMAP A7).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys
from typing import Optional

import torch

from theanompi_tpu_torch.runtime.fault import Watchdog
from theanompi_tpu_torch.runtime.recorder import Recorder
from theanompi_tpu_torch.utils import checkpoint as ckpt


def params_sha1(model) -> str:
    """SHA-1 over the bytes of every parameter, in the net's order (the
    record's ``params`` event: equal on every rank of a BSP group)."""
    h = hashlib.sha1()
    for p in model.params:
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class BSP_Worker:
    """Bulk-synchronous data-parallel training loop (reference
    ``BSP_Worker``).  The world is fixed: a dead rank stops the group,
    and recovery is restart-from-checkpoint (``run_with_restart``,
    ``launch.py --restarts``)."""

    def __init__(
        self,
        model,
        recorder: Optional[Recorder] = None,
        val_freq: int = 1,  # epochs between validations (0 = never)
        checkpoint_dir: Optional[str] = None,
        checkpoint_freq: int = 1,  # epochs between snapshots (0 = never)
        resume: bool = False,
        async_checkpoint: bool = True,  # write snapshots on a thread
        # (the device→host copy stays synchronous: the step updates in
        # place); False = the loop waits for the disk
        tensorboard_dir: Optional[str] = None,  # rank 0's record
        keep_last: Optional[int] = None,  # prune to the newest N after
        # each save (None = keep all); with async saves N+1 files may
        # exist mid-run, and the final prune after the drain leaves N
        watchdog_timeout: Optional[float] = None,  # seconds without a
        # completed iteration before the stall watchdog fires
        watchdog_action: str = "dump",
    ):
        self.model = model
        self.rank = model.rank
        if recorder is not None and tensorboard_dir is not None:
            raise ValueError(
                "pass tensorboard_dir OR a pre-built recorder, not both — "
                "an explicit recorder would silently drop the TB mirror "
                "(build it with Recorder(tensorboard_dir=...) instead)"
            )
        self.recorder = recorder or Recorder(
            print_freq=int(model.config.get("print_freq", 40)),
            rank=self.rank, verbose=self.rank == 0,
            save_dir=checkpoint_dir,
            tensorboard_dir=tensorboard_dir if self.rank == 0 else None,
        )
        self.val_freq = val_freq
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_freq = checkpoint_freq
        self.resume = resume
        self.keep_last = keep_last
        # fail at construction; the watchdog itself starts in run()
        Watchdog.validate_action(watchdog_action)
        self._watchdog_cfg = ((float(watchdog_timeout), watchdog_action)
                              if watchdog_timeout else None)
        self._watchdog = None
        self._ckpt = None
        if async_checkpoint and checkpoint_dir and self.rank == 0:
            self._ckpt = ckpt.AsyncCheckpointer()

    def _log_memory(self, rec: Recorder, tag: str) -> None:
        """Device-memory snapshot as a record event; skipped on the CPU,
        which reports no memory statistics."""
        dev = self.model.device
        if dev.type != "cuda":
            return
        stats = torch.cuda.memory_stats(dev)
        rec.log_event(
            "memory", tag=tag,
            bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
            peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
            bytes_limit=int(torch.cuda.get_device_properties(dev)
                            .total_memory),
        )

    def _prune_checkpoints(self) -> None:
        if self.keep_last and self.rank == 0:
            ckpt.prune(self.checkpoint_dir, self.keep_last)

    def _paused(self):
        return (self._watchdog.pause() if self._watchdog is not None
                else contextlib.nullcontext())

    def run(self) -> None:
        model, rec = self.model, self.recorder
        if self.resume and self.checkpoint_dir:
            path = ckpt.latest(self.checkpoint_dir)
            if path:
                model.load_model(path)
                print(f"resumed from {path} at epoch {model.current_epoch}",
                      flush=True)
        if (bool(model.config.get("lr_linear_scaling", True))
                and model.n_workers > 1):
            model.scale_lr(float(model.n_workers))
            if self.rank == 0:
                print(f"lr linearly scaled x{model.n_workers} for "
                      f"{model.n_workers}-worker data parallelism "
                      "(lr_linear_scaling=False to disable)", flush=True)
        model.compile_train()
        model.compile_val()
        self._log_memory(rec, "train_start")
        if self.rank == 0:
            print(model.describe(), flush=True)
        count = model.current_epoch * model.data.n_batch_train
        try:
            if self._watchdog_cfg is not None:
                # armed at the first completed iteration: compile and
                # resume never count as a stall
                self._watchdog = Watchdog.maybe(*self._watchdog_cfg)
            for epoch in range(model.current_epoch, model.n_epochs):
                model.adjust_hyperp(epoch)
                rec.start_epoch()
                model.reset_train_iter(epoch)
                for _ in range(model.data.n_batch_train):
                    count += 1
                    model.train_iter(count, rec)
                    rec.print_train_info(count)
                    if self._watchdog is not None:
                        self._watchdog.tick()
                if self.val_freq and (epoch + 1) % self.val_freq == 0:
                    with self._paused():
                        model.run_validation(count, rec)
                rec.end_epoch(count, epoch)
                self._log_memory(rec, f"epoch_{epoch + 1}")
                model.current_epoch = epoch + 1
                if self.checkpoint_dir and self.checkpoint_freq and (
                        (epoch + 1) % self.checkpoint_freq == 0):
                    path = os.path.join(self.checkpoint_dir,
                                        f"ckpt_{epoch + 1:04d}.npz")
                    with self._paused():
                        # every rank enters (the state is gathered);
                        # rank 0 writes
                        model.save_model(path, checkpointer=self._ckpt)
                        self._prune_checkpoints()
        finally:
            # the watchdog first: a later finalizer may raise, and a
            # leaked exit-mode watchdog would kill a restarted attempt
            if self._watchdog is not None:
                self._watchdog.close()
                self._watchdog = None
            rec.close()
            # drain the writer on the crash path too: a restart reads
            # the last snapshot at once
            if self._ckpt is not None:
                if sys.exc_info()[0] is None:
                    self._ckpt.close()
                    self._prune_checkpoints()
                else:
                    try:
                        self._ckpt.close()
                        self._prune_checkpoints()
                    except Exception as ce:
                        print(f"async checkpoint error during crash "
                              f"drain: {type(ce).__name__}: {ce}", flush=True)
        if self.checkpoint_dir:
            rec.log_event("params", sha1=params_sha1(model))
            rec.save()
        model.cleanup()
