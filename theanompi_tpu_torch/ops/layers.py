"""Dense layer and initializers — the part of ``theanompi_tpu.ops.layers``
that the transformer LM needs.

Conventions kept from the reference so parameters convert one to one:

- a dense weight is stored as ``(in, out)`` and applied as ``x @ w``
  (not ``nn.Linear``'s ``(out, in)``);
- a product with ``compute_dtype`` set rounds both operands to that
  dtype and accumulates in fp32 (the reference's
  ``preferred_element_type=float32``); the fp32 result is then narrowed
  to the flowing dtype, or kept fp32 for a logits head;
- the reference's ``Sequential`` (a list of layers applied in order,
  with a list of per-layer params) is ``torch.nn.Sequential`` here, so
  ``state_dict`` key ``net.{i}.…`` is the reference's ``params[i]``.

Initializers draw from an explicit ``torch.Generator`` on the CPU and
are copied to the parameter's device, so one seed gives the same
weights on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn


def normal_init(std: float) -> Callable:
    def f(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, dtype=torch.float32) * std

    return f


def xavier_uniform(gen: torch.Generator, shape, fan_in: int,
                   fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def dot(x: torch.Tensor, w: torch.Tensor,
        compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ w`` with operands rounded to ``compute_dtype`` (when set)
    and the sum taken in fp32; returns fp32.  A product of two bf16
    values is exact in fp32, so this equals a bf16 matmul with fp32
    accumulation up to summation order."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    return torch.matmul(x.float(), w.float())


class Dense(nn.Module):
    """Fully-connected layer over the last dim (reference ``Dense``)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        w_init: Optional[Callable] = None,
        compute_dtype: Optional[torch.dtype] = None,
        output_dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.in_features = int(in_features)
        self.features = int(features)
        self.w_init = w_init
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype
        self.w = nn.Parameter(
            torch.empty(self.in_features, self.features, device=device)
        )
        self.b = (
            nn.Parameter(torch.empty(self.features, device=device))
            if use_bias else None
        )

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        d, f = self.in_features, self.features
        if self.w_init is not None:
            w = self.w_init(gen, (d, f), d)
        else:
            w = xavier_uniform(gen, (d, f), d, f)
        self.w.copy_(w)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dot(x, self.w, self.compute_dtype)
        out_dtype = self.output_dtype or self.compute_dtype
        if out_dtype is not None:
            y = y.to(out_dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y
