"""Layers and initializers — the part of ``theanompi_tpu.ops.layers``
that the transformer LM and AlexNet need.

Conventions kept from the reference so parameters convert one to one:

- activations are contiguous NHWC ``(N, H, W, C)`` tensors, as in the
  reference; a convolution hands cuDNN the channels-last NCHW view
  ``x.permute(0, 3, 1, 2)`` and permutes its output back, so
  ``Flatten`` keeps the reference's (h, w, c) feature order and the
  first dense weight needs no row permutation;
- a convolution weight is stored OIHW (torch's layout; the reference's
  HWIO transposed, see ``convert``); a dense weight is stored as
  ``(in, out)`` and applied as ``x @ w`` (not ``nn.Linear``'s
  ``(out, in)``);
- a dense product with ``compute_dtype`` set rounds both operands to
  that dtype and accumulates in fp32 (the reference's
  ``preferred_element_type=float32``); the fp32 result is then narrowed
  to the flowing dtype, or kept fp32 for a logits head;
- a convolution with ``compute_dtype`` set follows the reference's
  ``_conv_operand_dtypes``: on the card, narrow operands (cuDNN
  accumulates in fp32); on the CPU, fp32 operands with the output
  narrowed — what the reference does off the TPU;
- the reference's ``Sequential`` (a list of layers applied in order,
  with a list of per-layer params) is ``torch.nn.Sequential`` here, so
  ``state_dict`` key ``net.{i}.…`` is the reference's ``params[i]``;
- every layer has ``out_shape(in_shape)`` (per-example shapes, HWC),
  the shape inference of the reference's ``init``.

Initializers draw from an explicit ``torch.Generator`` on the CPU and
are copied to the parameter's device, so one seed gives the same
weights on every device.  Settings the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from theanompi_tpu_torch.ops.lrn import lrn as kernel_lrn
from theanompi_tpu_torch.ops.pool import maxpool_fwd, maxpool_pallas

Shape = Tuple[int, ...]


def he_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    std = math.sqrt(2.0 / fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


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

    def out_shape(self, in_shape: Shape) -> Shape:
        return (*in_shape[:-1], self.features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dot(x, self.w, self.compute_dtype)
        out_dtype = self.output_dtype or self.compute_dtype
        if out_dtype is not None:
            y = y.to(out_dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def explicit_padding(padding, kernel, stride, hw):
    """Resolve a padding spec to explicit ((lo, hi), (lo, hi)) pairs.
    SAME uses XLA's convention: lo = total//2 (hi gets the odd pixel)."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            pads = []
            for d in range(2):
                out = -(-hw[d] // stride[d])
                total = max(0, (out - 1) * stride[d] + kernel[d] - hw[d])
                pads.append((total // 2, total - total // 2))
            return tuple(pads)
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        raise ValueError(f"unsupported padding spec {padding!r}")
    return tuple((int(p[0]), int(p[1])) for p in padding)


def conv_out_hw(hw, window, stride, padding):
    h, w = hw
    pads = explicit_padding(padding, window, stride, hw)
    oh = (h + pads[0][0] + pads[0][1] - window[0]) // stride[0] + 1
    ow = (w + pads[1][0] + pads[1][1] - window[1]) // stride[1] + 1
    return oh, ow


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    # contiguous NHWC; a no-op when cuDNN already returned channels-last
    return y.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Module):
    """2-D convolution over NHWC activations, OIHW weight (reference
    ``Conv2d``).  SAME padding is resolved to explicit, possibly
    asymmetric pads (AlexNet's 11×11/4 stem on 128 px pads (3, 4)) and
    applied before a VALID cuDNN convolution."""

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel: Union[int, Tuple[int, int]],
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        compute_dtype: Optional[torch.dtype] = None,
        s2d: bool = False,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        if s2d:
            raise NotImplementedError(
                "Conv2d(s2d=True) (space-to-depth stem) is not ported yet: "
                "ROADMAP A2")
        self.in_channels = int(in_channels)
        self.filters = int(filters)
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.compute_dtype = compute_dtype
        kh, kw = self.kernel
        self.w = nn.Parameter(torch.empty(
            self.filters, self.in_channels, kh, kw, device=device))
        self.b = nn.Parameter(torch.empty(self.filters, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        kh, kw = self.kernel
        hwio = he_normal(gen, (kh, kw, self.in_channels, self.filters),
                         kh * kw * self.in_channels)
        self.w.copy_(hwio.permute(3, 2, 0, 1))
        self.b.zero_()

    def out_shape(self, in_shape: Shape) -> Shape:
        oh, ow = conv_out_hw(in_shape[:2], self.kernel, self.stride,
                             self.padding)
        return (oh, ow, self.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, narrow_to = self.w, None
        if self.compute_dtype is not None:
            if x.device.type == "cuda":
                x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
            else:
                x, w = x.float(), w.float()
                narrow_to = self.compute_dtype
        (hlo, hhi), (wlo, whi) = explicit_padding(
            self.padding, self.kernel, self.stride, x.shape[1:3])
        if hlo or hhi or wlo or whi:
            x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
        y = _nhwc(F.conv2d(_nchw(x), w.to(memory_format=torch.channels_last),
                           stride=self.stride))
        if narrow_to is not None:
            y = y.to(narrow_to)
        return y + self.b.to(y.dtype)


class Relu(nn.Module):
    def out_shape(self, in_shape: Shape) -> Shape:
        return in_shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class Flatten(nn.Module):
    """(N, H, W, C) → (N, H·W·C) in NHWC order (reference ``Flatten``)."""

    def out_shape(self, in_shape: Shape) -> Shape:
        return (math.prod(in_shape),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class Dropout(nn.Module):
    """Inverted dropout (reference ``Dropout``) drawing its mask from an
    explicit generator on the activation's device.  Active only in
    training mode (``module.train()``)."""

    def __init__(self, rate: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def out_shape(self, in_shape: Shape) -> Shape:
        return in_shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout in train mode requires a generator")
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class MaxPool(nn.Module):
    """Max pooling over NHWC.  ``grad_impl``: 'native' = torch's own
    backward (routes a window's cotangent to one max); 'pallas' = the
    hand-written backward kernel (``ops.pool``, ties split equally, as
    the reference's Pallas kernel).  VALID padding only (SAME:
    ROADMAP A2).  Unlike the
    reference's kernel the port's needs no whole plane in fast memory,
    so no plane size falls back to 'native'."""

    def __init__(self, window=2, stride=None, grad_impl="native"):
        super().__init__()
        self.window = _pair(window)
        self.stride = _pair(stride if stride is not None else window)
        if grad_impl not in ("native", "mask", "pallas"):
            raise ValueError(
                f"grad_impl must be native|mask|pallas, got {grad_impl!r}")
        if grad_impl == "mask":
            raise NotImplementedError(
                "MaxPool(grad_impl='mask') is not ported yet: ROADMAP A2")
        self.grad_impl = grad_impl

    def out_shape(self, in_shape: Shape) -> Shape:
        h, w, c = in_shape
        oh, ow = conv_out_hw((h, w), self.window, self.stride, "VALID")
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"MaxPool window {self.window} on {h}x{w} input produces "
                f"an empty {oh}x{ow} output")
        return (oh, ow, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.grad_impl == "pallas":
            return maxpool_pallas(x, self.window, self.stride)
        return maxpool_fwd(x, self.window, self.stride)


def lrn_band_matrix(c: int, size: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(C, C) 0/1 matrix B with B[j, c] = 1 iff source channel j lies in
    the LRN window of output channel c:
    ``j - c ∈ [-size//2, size-1-size//2]``."""
    pad = size // 2
    idx = torch.arange(c, device=device)
    d = idx[:, None] - idx[None, :]
    return ((d >= -pad) & (d <= size - 1 - pad)).to(dtype)


class LRN(nn.Module):
    """Local response normalization over the channel axis of NHWC
    (reference ``LRN``).  ``impl``: 'auto' (= 'xla') is the reference's
    band-matmul path in torch ops; 'pallas' is the hand-written kernel
    pair (``ops.lrn``).  'window', 'shift', ``remat`` and
    ``stats_dtype`` are not ported yet (ROADMAP A2)."""

    def __init__(self, size=5, alpha=1e-4, beta=0.75, k=1.0, impl="auto",
                 remat=False, stats_dtype=None):
        super().__init__()
        if impl not in ("auto", "xla", "pallas", "window", "shift"):
            raise ValueError(
                f"impl must be auto|xla|pallas|window|shift, got {impl!r}")
        if impl in ("window", "shift"):
            raise NotImplementedError(
                f"LRN(impl={impl!r}) is not ported yet: ROADMAP A2")
        if remat or stats_dtype:
            raise NotImplementedError(
                "LRN remat / stats_dtype are not ported yet: ROADMAP A2")
        self.size = int(size)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.k = float(k)
        self.impl = impl

    def out_shape(self, in_shape: Shape) -> Shape:
        return in_shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "pallas":
            return kernel_lrn(x, self.size, self.alpha, self.beta, self.k)
        band = lrn_band_matrix(x.shape[-1], self.size, torch.float32,
                               x.device)
        # x² in the flowing dtype (as the reference squares before its
        # fp32-accumulating einsum), summed in fp32
        win = torch.matmul((x * x).float(), band)
        denom = torch.pow(self.k + self.alpha * win, self.beta)
        return (x.float() / denom).to(x.dtype)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
