"""Gradient bucketing — counterpart of
``theanompi_tpu.parallel.bucketing`` (``plan_buckets``,
``cached_plan``).

Gradients are fused into ~``bucket_bytes`` flat fp32 payloads before
the wire: one collective per bucket instead of one per parameter.
Plans are deterministic (parameter order, greedy fill, leaves grouped
by their reduction-axes tuple) and cached per (names, shapes/dtypes,
axes, strategy, bucket size), so every step and every rank uses the
same layout.  The in-DAG issue points (``GradSyncGroup``,
``exchange_overlap='indag'``) are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import math
import threading
from typing import List, Sequence, Tuple

DEFAULT_BUCKET_BYTES = 4 << 20


class Bucket:
    """Contiguous leaves that reduce over the same axes; ``offsets[i]``
    and ``sizes[i]`` locate leaf ``idx[i]`` in the flat payload."""

    __slots__ = ("axes", "idx", "offsets", "sizes")

    def __init__(self, axes: Tuple, idx: Tuple[int, ...],
                 offsets: Tuple[int, ...], sizes: Tuple[int, ...]):
        self.axes = tuple(axes)
        self.idx = tuple(idx)
        self.offsets = tuple(offsets)
        self.sizes = tuple(sizes)

    @property
    def n(self) -> int:
        return sum(self.sizes)

    def __repr__(self):
        return f"Bucket(axes={self.axes}, leaves={len(self.idx)}, n={self.n})"


class BucketPlan:
    __slots__ = ("buckets", "n_leaves")

    def __init__(self, buckets: Sequence[Bucket], n_leaves: int):
        self.buckets = tuple(buckets)
        self.n_leaves = int(n_leaves)

    def __repr__(self):
        return f"BucketPlan({len(self.buckets)} buckets, {self.n_leaves} leaves)"


def plan_buckets(sizes: Sequence[int], axes_list: Sequence[Tuple],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> BucketPlan:
    """Greedy deterministic bucket assignment (the reference's rule):
    walk leaves in order; each distinct axes tuple keeps one open bucket
    that closes when its fp32 payload would pass ``bucket_bytes`` (an
    oversized leaf gets a bucket of its own); leaves with no reduction
    axes collect into passthrough buckets (``axes == ()``)."""
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    open_by_axes: dict = {}
    order: List = []

    def close(key):
        b = open_by_axes.pop(key, None)
        if b:
            offs, total = [], 0
            for s in b["sizes"]:
                offs.append(total)
                total += s
            order[b["slot"]] = Bucket(b["axes"], b["idx"], tuple(offs),
                                      tuple(b["sizes"]))

    for i, (n, axes) in enumerate(zip(sizes, axes_list)):
        key = tuple(axes)
        b = open_by_axes.get(key)
        if (b is not None and key
                and 4 * (sum(b["sizes"]) + int(n)) > bucket_bytes):
            close(key)
            b = None
        if b is None:
            b = open_by_axes[key] = {"axes": key, "idx": [], "sizes": [],
                                     "slot": len(order)}
            order.append(None)
        b["idx"].append(i)
        b["sizes"].append(int(n))
    for key in list(open_by_axes):
        close(key)
    return BucketPlan([b for b in order if b is not None], len(sizes))


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 256
_PLAN_LOCK = threading.Lock()


def cached_plan(names: Tuple, shapes_dtypes: Tuple,
                axes_list: Tuple[Tuple, ...], strategy: str,
                bucket_bytes: int) -> BucketPlan:
    """Memoized :func:`plan_buckets`; ``names`` (the parameter names in
    order) take the place of the reference's treedef."""
    key = (tuple(names), tuple(shapes_dtypes), tuple(axes_list),
           str(strategy), int(bucket_bytes))
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            return plan
    sizes = [math.prod(shape) for shape, _ in shapes_dtypes]
    plan = plan_buckets(sizes, axes_list, bucket_bytes)
    with _PLAN_LOCK:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.clear()
        return _PLAN_CACHE.setdefault(key, plan)

