"""The BSP training loop — counterpart of
``theanompi_tpu.parallel.workers.BSP_Worker``.

Every rank of the process group runs this same loop (the reference's
N MPI ranks; its single-controller JAX loop drove them all from one
process).  Rank 0 prints.  Per epoch: lr schedule, the epoch's
batches through ``train_iter``, validation every ``val_freq`` epochs.
Checkpoints, resume, TensorBoard, the stall watchdog and the
comm-fraction probe are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional

from theanompi_tpu_torch.runtime.recorder import Recorder


class BSP_Worker:
    def __init__(self, model, recorder: Optional[Recorder] = None,
                 val_freq: int = 1, checkpoint_dir: Optional[str] = None,
                 resume: bool = False, **unported):
        if resume or unported:
            names = sorted(unported) + (["resume"] if resume else [])
            raise NotImplementedError(
                f"BSP_Worker options not ported yet: {', '.join(names)} "
                "(ROADMAP A6)")
        self.model = model
        self.rank = model.rank
        self.recorder = recorder or Recorder(
            print_freq=int(model.config.get("print_freq", 40)),
            rank=self.rank, verbose=self.rank == 0,
            save_dir=checkpoint_dir)
        self.val_freq = int(val_freq)
        self.checkpoint_dir = checkpoint_dir

    def run(self) -> None:
        model, rec = self.model, self.recorder
        if (bool(model.config.get("lr_linear_scaling", True))
                and model.n_workers > 1):
            model.scale_lr(float(model.n_workers))
            if self.rank == 0:
                print(f"lr linearly scaled x{model.n_workers} for "
                      f"{model.n_workers}-worker data parallelism "
                      "(lr_linear_scaling=False to disable)", flush=True)
        model.compile_train()
        model.compile_val()
        if self.rank == 0:
            print(model.describe(), flush=True)
        count = model.current_epoch * model.data.n_batch_train
        for epoch in range(model.current_epoch, model.n_epochs):
            model.adjust_hyperp(epoch)
            rec.start_epoch()
            model.reset_train_iter(epoch)
            for _ in range(model.data.n_batch_train):
                count += 1
                model.train_iter(count, rec)
                rec.print_train_info(count)
            if self.val_freq and (epoch + 1) % self.val_freq == 0:
                model.run_validation(count, rec)
            rec.end_epoch(count, epoch)
            model.current_epoch = epoch + 1
        if self.checkpoint_dir:
            rec.save()
        model.cleanup()
