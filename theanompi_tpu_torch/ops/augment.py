"""Host-side augmentation: per-image random crop + horizontal mirror.

The port's own copy of ``theanompi_tpu.ops.augment.np_crop_mirror``
and ``apply_crop_mirror`` (pure numpy; the reference module imports
jax).  The on-device ``random_crop_mirror`` is not ported yet
(``device_aug``, ROADMAP A3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def apply_crop_mirror(x: np.ndarray, oh, ow, flip, crop_h: int, crop_w: int):
    """Apply given per-image (oh, ow) crop windows and mirror flags as
    one vectorized gather."""
    n = x.shape[0]
    oh = np.asarray(oh)
    ow = np.asarray(ow)
    rows = oh[:, None, None] + np.arange(crop_h)[None, :, None]
    cols = ow[:, None, None] + np.arange(crop_w)[None, None, :]
    out = x[np.arange(n)[:, None, None], rows, cols]
    return np.where(
        np.asarray(flip).astype(bool)[:, None, None, None],
        out[:, :, ::-1, :],
        out,
    )


def np_crop_mirror(
    rng: np.random.RandomState,
    x: np.ndarray,
    crop_size: Optional[int] = None,
    mirror: bool = True,
) -> np.ndarray:
    """Per-image random crop + mirror of an NHWC batch, drawing offsets
    and flips from ``rng`` in the reference's order."""
    n, h, w = x.shape[:3]
    c = int(crop_size) if crop_size and crop_size < h else h
    oh = rng.randint(0, h - c + 1, size=n) if c < h else np.zeros(n, np.int64)
    ow = rng.randint(0, w - c + 1, size=n) if c < w else np.zeros(n, np.int64)
    flip = (rng.rand(n) < 0.5) if mirror else np.zeros(n, bool)
    return np.ascontiguousarray(apply_crop_mirror(x, oh, ow, flip, c, c))
