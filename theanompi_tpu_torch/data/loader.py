"""Prefetching device loader — counterpart of
``theanompi_tpu.data.loader.PrefetchLoader``.

A background thread pulls host batches from the provider, takes this
rank's rows, copies them into pinned host memory and issues
non-blocking copies to the device, keeping ``depth`` batches in flight
so the device step, not input, bounds iteration time when the host
keeps up.  Exceptions in the thread reach the consumer at its next
``__next__``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def rank_rows(batch: Tuple[np.ndarray, ...], rank: int, world: int):
    """Rows ``[rank·b, (rank+1)·b)`` of a global batch, b = rows/world:
    the reference's ``shard_batch`` order over ``dp``."""
    n = batch[0].shape[0]
    if n % world:
        raise ValueError(f"global batch of {n} rows does not split over "
                         f"{world} ranks")
    b = n // world
    return tuple(a[rank * b:(rank + 1) * b] for a in batch)


def to_device(batch: Tuple[np.ndarray, ...], device: torch.device):
    """numpy arrays → tensors on ``device`` (pinned, non-blocking copies
    for a CUDA device)."""
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


class PrefetchLoader:
    """Wrap a host batch iterator; yield placed batches."""

    _SENTINEL = object()

    def __init__(self, batches: Iterator, place: Callable, depth: int = 2):
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _run(self, it) -> None:
        try:
            for batch in it:
                self._q.put(self._place(batch))
        except BaseException as e:  # surfaced to the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            self._q.put(self._SENTINEL)  # later calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch_to_device(batches, device: torch.device, rank: int = 0,
                       world: int = 1, depth: int = 2) -> PrefetchLoader:
    """Each global (x, y) host batch → this rank's rows on ``device``."""
    return PrefetchLoader(
        batches, lambda b: to_device(rank_rows(b, rank, world), device),
        depth=depth)
