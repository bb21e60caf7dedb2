"""Transformer layers — counterpart of ``theanompi_tpu.ops.attention``
(dense path) and of ``parallel.ring_attention.local_attention`` (the
``attn_impl`` dispatch: ``'xla'`` is the plain path here, ``'flash'``
the flash kernels of ``ops.flash``).

Activations are ``(B, T, D)``; token inputs ``(B, T)`` int64/int32.
Numerics follow the reference: LayerNorm statistics in fp32 (eps 1e-5),
softmax in fp32 with the finite mask value ``NEG_INF``, projections
through ``layers.dot`` (fp32 accumulation), and the MLP's GELU in its
tanh form — ``jax.nn.gelu``'s default, which ``F.gelu``'s default (the
erf form) is not.

Each layer's pieces (``MultiHeadAttention.qkv``/``.out``,
``TransformerBlock.mlp``) are the ones the serving engines call, so the
full-recompute forward and the KV-cache paths share one definition of
the math.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from theanompi_tpu_torch.ops.flash import flash_attention
from theanompi_tpu_torch.ops.layers import Dense, dot, normal_init

NEG_INF = -1e30  # finite mask value: exp() stays NaN-free on masked rows


class LayerNorm(nn.Module):
    """Layer normalization over the last dim with fp32 statistics."""

    def __init__(self, features: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class Embedding(nn.Module):
    """Token embedding ``(…,)`` → ``(…, D)``; the fp32 master table is
    looked up and the rows enter the stream in ``compute_dtype``."""

    def __init__(self, vocab_size: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.table = nn.Parameter(
            torch.empty(vocab_size, features, device=device)
        )

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        v, d = self.table.shape
        self.table.copy_(normal_init(0.02)(gen, (v, d), d))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        y = self.table[tokens]
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        return y


class PositionalEmbedding(nn.Module):
    """Learned absolute positions (``max_len`` rows)."""

    def __init__(self, max_len: int, features: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.pos = nn.Parameter(torch.empty(max_len, features, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        t, d = self.pos.shape
        self.pos.copy_(normal_init(0.02)(gen, (t, d), d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pos[: x.shape[1]].to(x.dtype)


ATTN_IMPLS = ("xla", "flash")


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    attn_impl: str = "xla") -> torch.Tensor:
    """Softmax attention, q ``(B, Tq, H, D)``, k/v ``(B, Tk, H, D)`` →
    ``(B, Tq, H, D)`` in q's dtype.  ``attn_impl='flash'`` runs
    ``ops.flash.flash_attention`` (Tq == Tk, no ``mask``); ``'xla'`` the
    plain path: scores and softmax in fp32, probabilities rounded to v's
    dtype before the second product.  ``causal`` masks ``k > q``
    positions; ``mask`` (B, Tq, Tk) bool (True = attend) masks
    explicitly, e.g. by absolute positions."""
    if attn_impl == "flash":
        if mask is not None:
            raise ValueError("attn_impl='flash' takes no explicit mask")
        return flash_attention(q, k, v, causal, scale)
    if attn_impl != "xla":
        raise ValueError(
            f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~tri, NEG_INF)
    if mask is not None:
        s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     lengths: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query per lane against that lane's K/V image: q ``(N, H,
    D)``, kc/vc ``(N, T, H, D)``; rows at positions ``<= lengths[n]``
    attend.  Returns fp32 ``(N, H, D)``; probabilities are rounded to
    vc's dtype before the second product, as in ``local_attention``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("nhd,nthd->nht", q.float(), kc.float()) * scale
    mask = (torch.arange(kc.shape[1], device=q.device)[None, :]
            <= lengths.long()[:, None])
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nht,nthd->nhd", p.to(vc.dtype).float(), vc.float())


class MultiHeadAttention(nn.Module):
    """Dense causal multi-head self-attention (no sequence or tensor
    parallelism in this slice).  ``attn_impl``: 'xla' (the plain path)
    or 'flash' (the flash kernels) for the full-sequence forward; the
    serving engines' cached paths call ``local_attention`` themselves."""

    def __init__(self, d_model: int, n_heads: int, causal: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None,
                 attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be 'xla' or 'flash', got {attn_impl!r}")
        self.attn_impl = attn_impl
        if d_model % n_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by n_heads {n_heads}"
            )
        self.n_heads = int(n_heads)
        self.head_dim = d_model // n_heads
        self.causal = causal
        self.compute_dtype = compute_dtype
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(
                torch.empty(d_model, d_model, device=device)
            ))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        d = self.wq.shape[0]
        init = normal_init(1.0 / math.sqrt(d))
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(init(gen, (d, d), d))

    def _proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = dot(x, w, self.compute_dtype)
        return y.to(self.compute_dtype) if self.compute_dtype else y

    def qkv(self, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(…, D)`` → q, k, v each ``(…, H, hd)`` in the flowing dtype."""
        shape = (*x.shape[:-1], self.n_heads, self.head_dim)
        return tuple(
            self._proj(x, w).reshape(shape) for w in (self.wq, self.wk, self.wv)
        )

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """``(…, H, hd)`` → the output projection ``(…, D)``."""
        return self._proj(o.reshape(*o.shape[:-2], -1), self.wo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x)
        return self.out(local_attention(q, k, v, causal=self.causal,
                                        attn_impl=self.attn_impl))


class TransformerBlock(nn.Module):
    """Pre-LN decoder block: LN→MHA→residual, LN→GELU MLP→residual."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int = 4,
                 causal: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None,
                 attn_impl: str = "xla"):
        super().__init__()
        dm = d_model * int(mlp_ratio)
        self.compute_dtype = compute_dtype
        self.ln1 = LayerNorm(d_model, device=device)
        self.attn = MultiHeadAttention(
            d_model, n_heads, causal=causal, compute_dtype=compute_dtype,
            device=device, attn_impl=attn_impl,
        )
        self.ln2 = LayerNorm(d_model, device=device)
        # mlp_in keeps its fp32 product for the bias add and the GELU;
        # mlp_out narrows to the flowing dtype before its bias
        self.mlp_in = Dense(
            d_model, dm, w_init=normal_init(1.0 / math.sqrt(d_model)),
            compute_dtype=compute_dtype, output_dtype=torch.float32,
            device=device,
        )
        self.mlp_out = Dense(
            dm, d_model, w_init=normal_init(1.0 / math.sqrt(dm)),
            compute_dtype=compute_dtype, device=device,
        )

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.mlp_in(x), approximate="tanh")
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        return self.mlp_out(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))
