"""Device resolution for every entry point of the port.

The port exists to run on the card, so ``None`` means ``cuda`` and a
machine without one raises instead of quietly computing on the CPU.
The CPU runs only when a caller names it (the parity tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` → a CUDA device, raising
    ``RuntimeError`` when no card is present; ``"cpu"`` → the CPU.
    Any other device type raises ``ValueError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "by default — pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"device {device!r}: the port runs on 'cuda' or, on request, 'cpu'"
    )


def resolve_dtype(compute_dtype) -> Optional[torch.dtype]:
    """The config's ``compute_dtype`` (None, a name such as
    ``'bfloat16'``, or a ``torch.dtype``) → a floating ``torch.dtype``
    or None (= fp32 end to end, the reference's default)."""
    if compute_dtype is None:
        return None
    if isinstance(compute_dtype, torch.dtype):
        dt = compute_dtype
    else:
        dt = getattr(torch, str(compute_dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not a float dtype")
    return dt
