"""KV-cache inference engine for ``TransformerLM`` — counterpart of
``theanompi_tpu.serving.engine``.

Two host entries over a preallocated contiguous cache:

- ``prefill``: one whole-prompt pass that fills one slot's K/V rows and
  returns the logits at the last real token.  Prompts pad to a small
  set of *length buckets*, as in the reference, so the port runs the
  same bounded set of shapes.
- ``decode_step``: one token for every slot at once — q/k/v for the new
  token only, attention against the cached K/V.

The engine runs the model's own layer pieces (``ops.attention``), so
its numerics are those of the full-recompute forward.  Unlike the
reference's pure functions, the port writes the cache **in place**
(no copy of a multi-GB cache per token) and returns only the logits.

Decode correctness contract: greedy decode through the cache picks the
same tokens as the no-cache full-recompute forward.

Scope: the dense single-device stack; the engine runs on the model's
device, which defaults to the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from theanompi_tpu_torch.device import DeviceLike, resolve_device
from theanompi_tpu_torch.ops.attention import decode_attention, local_attention


def default_buckets(max_len: int, lo: int = 16) -> Tuple[int, ...]:
    """Power-of-two prefill buckets ``lo, 2·lo, … , max_len`` (max_len
    always included so every admissible prompt has a bucket)."""
    out: List[int] = []
    b = lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def _validate_buckets(buckets, max_len: int) -> Tuple[int, ...]:
    """Normalize prefill bucket lengths to a sorted tuple of distinct
    positive ints.  Each bucket is a padded prompt shape: a float
    bucket truncates to a shape no prompt maps back to, a bool is a
    config mistake, a duplicate is a wasted shape — all raise here."""
    try:
        items = list(buckets)
    except TypeError:
        raise TypeError(
            f"buckets must be an iterable of ints, got "
            f"{type(buckets).__name__}"
        ) from None
    if not items:
        raise ValueError("buckets must contain at least one length")
    out = []
    for b in items:
        if isinstance(b, bool) or not isinstance(b, (int, np.integer)):
            raise TypeError(
                f"bucket lengths must be ints (they are padded prompt "
                f"shapes), got {b!r} of type {type(b).__name__}"
            )
        b = int(b)
        if b < 1:
            raise ValueError(f"bucket lengths must be >= 1, got {b}")
        out.append(b)
    if len(set(out)) != len(out):
        dupes = sorted({b for b in out if out.count(b) > 1})
        raise ValueError(
            f"duplicate bucket length(s) {dupes}: each bucket is one "
            "padded shape — duplicates are config mistakes"
        )
    out = tuple(sorted(out))
    if out[-1] > max_len:
        raise ValueError(f"bucket {out[-1]} exceeds max_len={max_len}")
    return out


class ServingEngine:
    """Prefill + continuous-decode executor over a ``TransformerLM``.

    ``device`` defaults to the card (raising without one); the model
    must already live there.  The engine never changes the model.
    """

    is_paged = False

    def __init__(
        self,
        model,
        n_slots: int = 4,
        max_len: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
        *,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError(
                f"model lives on {model_device}, engine device is "
                f"{self.device}"
            )
        cfg = model.config
        self.model = model
        self.d_model = int(cfg["d_model"])
        self.n_heads = int(cfg["n_heads"])
        self.n_layers = int(cfg["n_layers"])
        self.vocab_size = int(cfg["vocab_size"])
        self.head_dim = self.d_model // self.n_heads
        self.scale = self.head_dim ** -0.5
        self.compute_dtype = model.compute_dtype
        self.n_slots = int(n_slots)
        train_len = int(cfg["seq_len"])
        self.max_len = int(max_len) if max_len is not None else train_len
        if self.max_len > train_len:
            raise ValueError(
                f"max_len={self.max_len} exceeds the learned positional "
                f"table ({train_len} rows, config seq_len)"
            )
        self.buckets = _validate_buckets(
            buckets if buckets is not None else default_buckets(self.max_len),
            self.max_len,
        )

    @property
    def cache_dtype(self) -> torch.dtype:
        """The cache's element type: the compute dtype, else fp32."""
        return self.compute_dtype or torch.float32

    # ------------------------------------------------------------------
    # cache
    # ------------------------------------------------------------------
    def init_cache(self) -> Dict[str, torch.Tensor]:
        """``k``/``v`` of (layers, slots, max_len, heads, head_dim) plus
        per-slot ``length`` (tokens resident), on the engine's device."""
        shape = (self.n_layers, self.n_slots, self.max_len,
                 self.n_heads, self.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.cache_dtype,
                             device=self.device),
            "v": torch.zeros(shape, dtype=self.cache_dtype,
                             device=self.device),
            "length": torch.zeros(self.n_slots, dtype=torch.int32,
                                  device=self.device),
        }

    def pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds the largest bucket "
            f"{self.buckets[-1]} (max_len={self.max_len})"
        )

    # ------------------------------------------------------------------
    # shared forward pieces
    # ------------------------------------------------------------------
    def _as_device(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _embed(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        x = self.model.embedding(tokens)
        pos = self.model.positions.pos[positions.clamp(max=self.max_len - 1)]
        return x + pos.to(x.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.head(self.model.final_norm(x))

    # ------------------------------------------------------------------
    # prefill: whole padded prompt, one slot
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, cache: Dict[str, torch.Tensor], slot: int,
                tokens) -> torch.Tensor:
        """Pad ``tokens`` to its bucket, write slot ``slot``'s K/V rows
        ``[0, bucket)`` (rows past the prompt are pad the decode mask
        never reads) and its length, in place.  Returns fp32 logits
        (V,) at the last real token."""
        toks = np.asarray(tokens, dtype=np.int64).reshape(-1)
        n = int(toks.size)
        if n < 1:
            raise ValueError("cannot prefill an empty prompt")
        b = self.pick_bucket(n)
        padded = np.zeros((b,), np.int64)
        padded[:n] = toks
        x = self._embed(
            self._as_device(padded, torch.long)[None],
            torch.arange(b, device=self.device)[None],
        )  # (1, B, D)
        dt = cache["k"].dtype
        for i, blk in enumerate(self.model.blocks):
            y = blk.ln1(x)
            q, k, v = blk.attn.qkv(y)  # (1, B, H, hd)
            o = local_attention(q, k, v, causal=True, scale=self.scale)
            x = x + blk.attn.out(o)
            x = x + blk.mlp(blk.ln2(x))
            cache["k"][i, slot, :b] = k[0].to(dt)
            cache["v"][i, slot, :b] = v[0].to(dt)
        cache["length"][slot] = n
        return self._head(x[0, n - 1])

    # ------------------------------------------------------------------
    # decode: one token for every slot
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor], tokens,
                    active) -> torch.Tensor:
        """``tokens`` (S,) — the token entering each slot; ``active``
        (S,) bool, both host arrays.  Writes each slot's K/V at its
        current length, advances active slots' lengths (in place) and
        returns fp32 logits (S, V).  Inactive slots compute garbage that
        is never read: their length does not advance, so the row is
        overwritten by the slot's next real token."""
        s_ = self.n_slots
        pos_idx = cache["length"].long()
        x = self._embed(self._as_device(tokens, torch.long), pos_idx)
        wr = pos_idx.clamp(max=self.max_len - 1)
        lanes = torch.arange(s_, device=self.device)
        dt = cache["k"].dtype
        for i, blk in enumerate(self.model.blocks):
            y = blk.ln1(x)
            q, k, v = blk.attn.qkv(y)  # (S, H, hd)
            cache["k"][i, lanes, wr] = k.to(dt)
            cache["v"][i, lanes, wr] = v.to(dt)
            o = decode_attention(q, cache["k"][i], cache["v"][i], pos_idx,
                                 self.scale).to(y.dtype)
            x = x + blk.attn.out(o)
            x = x + blk.mlp(blk.ln2(x))
        cache["length"] += self._as_device(active, torch.bool).int()
        return self._head(x)

    # ------------------------------------------------------------------
    # convenience: single-sequence greedy decode (tests / smoke)
    # ------------------------------------------------------------------
    def greedy(self, prompt, n_new: int) -> List[int]:
        """Greedy-decode ``n_new`` tokens after ``prompt`` on slot 0."""
        cache = self.init_cache()
        logits = self.prefill(cache, 0, prompt)
        out = [int(torch.argmax(logits))]
        tokens = np.zeros((self.n_slots,), np.int64)
        active = np.zeros((self.n_slots,), bool)
        active[0] = True
        for _ in range(n_new - 1):
            tokens[0] = out[-1]
            logits = self.decode_step(cache, tokens, active)
            out.append(int(torch.argmax(logits[0])))
        return out
