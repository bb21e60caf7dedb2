"""Paged KV cache: fixed-size blocks, block tables, prefix reuse —
counterpart of ``theanompi_tpu.serving.paging``.

- ``BlockPool`` — host-side allocator over the device row pool
  ``k``/``v`` of shape ``(n_layers, n_blocks * block_size, heads,
  head_dim)``.  Block 0 is the *trash block*: masked or inactive lanes
  write their garbage there, so a freed and reallocated block is never
  corrupted by a stale lane.  Refcounted: a block shared by several
  sequences (prefix reuse) frees when the last reference drops.
- ``PrefixCache`` — hash-consed chains of full, immutable blocks: the
  sha1 of (parent digest, block tokens) names a block's exact content
  and position, so requests sharing a prompt prefix map its full blocks
  to the same physical block.  The final prompt token is never served
  from cache (its logits must be computed).
- ``PagedServingEngine`` — the contiguous engine's math over block
  tables: prefill and decode write K/V rows at
  ``table[block] * block_size + offset`` and read them back through the
  table.  Prefill is batched and chunked: up to ``prefill_rows`` lanes
  advance by up to ``prefill_chunk`` tokens in one padded call.  The
  decode tick's attention is ``ops.paged_attention``: the CUDA kernel
  on the card, its plain version on the CPU — the device decides.

Profiling: while ``torch.profiler`` records, the decode tick, each
prefill call and each KV write run inside ``record_function`` ranges
named ``TICK_RANGE``, ``PREFILL_RANGE`` and ``KV_WRITE_RANGE``; outside
a profile they cost one flag check.

The pool holds the compute dtype (fp32 or bf16), or with
``kv_dtype='int8'`` int8 rows beside fp32 scale planes ``ks``/``vs``
(one scale per pool row and head, ``parallel.quantize.quantize_rows``
over head_dim): K/V are quantized once, on write, so every reader (the
prefill image, the decode kernel, a prefix-sharing sibling) sees the
same bytes, and about 3.8× the blocks fit in the same bytes at head_dim
64.  Prefill attends the dequantized image in the compute dtype; the
decode tick's kernel dequantizes in registers.  The speculative-decoding
verify pass is a later slice of the port.

Correctness contract: greedy decode through block tables picks the same
tokens as the contiguous engine and the no-cache full recompute; a
prefix hit changes which physical rows are read, never their values.
"""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torch.profiler import record_function

from theanompi_tpu_torch.device import DeviceLike
from theanompi_tpu_torch.ops.attention import local_attention
from theanompi_tpu_torch.ops.paged_attention import (
    image_rows,
    paged_decode_attention,
)
from theanompi_tpu_torch.parallel.quantize import quantize_rows
from theanompi_tpu_torch.serving.engine import ServingEngine

TRASH_BLOCK = 0  # reserved physical block: masked/inactive writes land here
KV_DTYPES = ("fp32", "int8")

_LATER_SLICE = "is a later slice of the PyTorch port"
TICK_RANGE = "serve.decode_tick"
PREFILL_RANGE = "serve.prefill"
KV_WRITE_RANGE = "serve.kv_write"


def _ranged(name: str):
    """Run the method inside a ``record_function`` range ``name`` while
    a profiler records; call it directly otherwise."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class BlockPool:
    """Host-side accounting for the device block pool: block identities
    (free list + refcounts).  The device rows live in the engine state.
    One pool per scheduler."""

    def __init__(self, n_blocks: int, block_size: int):
        if int(n_blocks) < 2:
            raise ValueError(
                f"n_blocks={n_blocks}: need at least 2 (block 0 is the "
                "reserved trash block)"
            )
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # block 0 reserved; allocatable ids are 1..n_blocks-1, handed
        # out lowest first
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks (ref 1 each), or None — never a partial
        grant, so a failed admission has nothing to roll back."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return out

    def retain(self, block: int) -> None:
        if self._ref.get(block, 0) < 1:
            raise ValueError(f"retain of unallocated block {block}")
        self._ref[block] += 1

    def release(self, block: int) -> None:
        r = self._ref.get(block, 0)
        if r < 1:
            raise ValueError(f"release of unallocated block {block}")
        if r == 1:
            del self._ref[block]
            self._free.append(block)
        else:
            self._ref[block] = r - 1

    def release_all(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.release(b)


class PrefixCache:
    """Hash-consed chains of immutable full blocks.

    ``digest(parent_digest, block_tokens)`` → physical block id whose
    K/V rows hold exactly those tokens at exactly those positions.  The
    cache holds one reference per entry; ``evict_unused`` drops every
    entry nothing else references.  Digests are sha1 over the tokens'
    int64 bytes — content addressing must not depend on Python's salted
    ``hash``.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self._entries: Dict[bytes, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def _digest(self, parent: bytes, tokens: Sequence[int]) -> bytes:
        h = hashlib.sha1(parent)
        h.update(np.asarray(tokens, dtype=np.int64).tobytes())
        return h.digest()

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached chain of full blocks covering a prefix of
        ``prompt``, each matched block retained for the caller; capped
        so at least the final prompt token is always prefilled.
        Returns (blocks, tokens covered)."""
        bs = self.block_size
        limit = (len(prompt) - 1) // bs
        out: List[int] = []
        parent = b""
        for j in range(limit):
            parent = self._digest(parent, prompt[j * bs:(j + 1) * bs])
            block = self._entries.get(parent)
            if block is None:
                break
            out.append(block)
        for b in out:
            self.pool.retain(b)
        return out, len(out) * bs

    def insert(self, prompt: Sequence[int], blocks: Sequence[int]) -> int:
        """Register every full block of a just-prefilled prompt; new
        entries retain their block on behalf of the cache.  Returns the
        number of entries added."""
        bs = self.block_size
        added = 0
        parent = b""
        for j in range(len(prompt) // bs):
            parent = self._digest(parent, prompt[j * bs:(j + 1) * bs])
            if parent in self._entries:
                continue  # identical content already cached; keep it
            self._entries[parent] = blocks[j]
            self.pool.retain(blocks[j])
            added += 1
        return added

    def evict_unused(self) -> int:
        """Free every cached block whose only reference is the cache
        itself (the pool-exhaustion pressure valve).  Evicting a parent
        strands its children; they have ref 1 too, so the same sweep
        collects them."""
        dropped = 0
        for digest in list(self._entries):
            block = self._entries[digest]
            if self.pool.ref(block) == 1:
                self.pool.release(block)
                del self._entries[digest]
                dropped += 1
        return dropped


class PagedServingEngine(ServingEngine):
    """The serving engine over a paged KV cache.

    Geometry (as in the reference):

    - ``block_size`` — KV rows per block (the allocation granule).
    - ``n_blocks`` — pool capacity including the trash block; defaults
      to contiguous parity (``n_slots * blocks_per_seq + 1``).
    - ``prefill_rows`` — lanes per batched prefill call (= ``n_slots``).
    - ``prefill_chunk`` — most prompt tokens one prefill call advances a
      lane by (None = whole prompt).  Chunks pad to ``chunk_buckets``.
    - ``kv_dtype`` — ``'fp32'``: the pool holds the compute dtype;
      ``'int8'``: int8 rows with per-(row, head) fp32 scales.
    """

    is_paged = True

    def __init__(
        self,
        model,
        n_slots: int = 4,
        max_len: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        kv_dtype: str = "fp32",
        *,
        device: DeviceLike = None,
    ):
        super().__init__(model, n_slots=n_slots, max_len=max_len,
                         buckets=buckets, device=device)
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
            )
        self.kv_dtype = kv_dtype
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self.blocks_per_seq = math.ceil(self.max_len / self.block_size)
        # gathered-attention width: every sequence's full table image
        self.t_pad = self.blocks_per_seq * self.block_size
        if n_blocks is None:
            n_blocks = self.n_slots * self.blocks_per_seq + 1
        self.n_blocks = int(n_blocks)
        if self.n_blocks < 2:
            raise ValueError(
                f"n_blocks={self.n_blocks}: need at least one usable "
                "block plus the reserved trash block"
            )
        self.prefill_rows = self.n_slots
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}"
                )
        self.prefill_chunk = prefill_chunk
        cap = prefill_chunk if prefill_chunk is not None else self.buckets[-1]
        self.chunk_buckets = tuple(sorted(
            {b for b in self.buckets if b <= cap} | {cap}
        ))

    # ------------------------------------------------------------------
    # state + pool construction
    # ------------------------------------------------------------------
    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Device block pool: ``k``/``v`` of (layers, n_blocks·bs, heads,
        head_dim); ``kv_dtype='int8'`` adds the scale planes ``ks``/``vs``
        of (layers, n_blocks·bs, heads).  Lengths and block tables stay
        host-side and ship with each call."""
        shape = (self.n_layers, self.n_blocks * self.block_size,
                 self.n_heads, self.head_dim)
        dt = torch.int8 if self.quantized else self.cache_dtype
        state = {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device),
        }
        if self.quantized:
            for key in ("ks", "vs"):
                state[key] = torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=self.device)
        return state

    def kv_block_bytes(self) -> int:
        """Device bytes one pool block occupies across all layers (K+V
        payload, plus the int8 pool's scale planes)."""
        payload = 1 if self.quantized else torch.empty(
            (), dtype=self.cache_dtype).element_size()
        rows = self.block_size * self.n_heads
        b = 2 * self.n_layers * rows * self.head_dim * payload
        if self.quantized:
            b += 2 * self.n_layers * rows * 4  # fp32 scale per (row, head)
        return b

    def blocks_at_budget(self, budget_bytes: int) -> int:
        """How many pool blocks fit in ``budget_bytes`` of cache memory
        at this engine's kv_dtype (the trash block counts like any
        other)."""
        return max(0, int(budget_bytes) // self.kv_block_bytes())

    def make_pool(self, n_blocks: Optional[int] = None) -> BlockPool:
        """A fresh allocator over (a prefix of) the device pool."""
        n = int(n_blocks) if n_blocks is not None else self.n_blocks
        if n > self.n_blocks:
            raise ValueError(
                f"pool of {n} blocks exceeds the device pool "
                f"({self.n_blocks})"
            )
        return BlockPool(n, self.block_size)

    def pick_chunk_bucket(self, n: int) -> int:
        for b in self.chunk_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"chunk of {n} tokens exceeds the largest chunk bucket "
            f"{self.chunk_buckets[-1]}"
        )

    def max_seq_blocks(self, total_tokens: int) -> int:
        return math.ceil(total_tokens / self.block_size)

    # ------------------------------------------------------------------
    # pool rows
    # ------------------------------------------------------------------
    @_ranged(KV_WRITE_RANGE)
    def _kv_write(self, state, key: str, layer: int, rows: torch.Tensor,
                  wr: torch.Tensor) -> None:
        """Write K or V ``rows`` (N, H, hd) into one layer's pool at row
        indices ``wr``, in place.  int8: quantized once, here, over
        head_dim (``quantize_rows``), the scales into ``ks``/``vs``."""
        if self.quantized:
            q8, sc = quantize_rows(rows)
            state[key][layer][wr] = q8
            state[key + "s"][layer][wr] = sc
        else:
            state[key][layer][wr] = rows.to(state[key].dtype)

    def _kv_image(self, state, key: str, layer: int,
                  gr: torch.Tensor) -> torch.Tensor:
        """One layer's K or V image through the gathered rows ``gr``
        (P, t_pad) → (P, t_pad, H, hd); int8 rows are dequantized with
        their scales and cast to the compute dtype (the reference's
        ``_kv_image``)."""
        img = state[key][layer][gr]
        if self.quantized:
            img = img.float() * state[key + "s"][layer][gr][..., None]
            img = img.to(self.cache_dtype)
        return img

    # ------------------------------------------------------------------
    # host entries (state is written in place)
    # ------------------------------------------------------------------
    @_ranged(PREFILL_RANGE)
    @torch.no_grad()
    def prefill_chunks(self, state: Dict[str, torch.Tensor],
                       rows: List[Dict]) -> torch.Tensor:
        """One batched chunked-prefill call.

        ``rows`` holds up to ``prefill_rows`` dicts with ``tokens``
        (this lane's chunk), ``p0`` (its absolute start position) and
        ``table`` (the lane's block ids).  Writes each chunk's K/V into
        its blocks (in place) and returns fp32 logits (prefill_rows, V);
        row i belongs to rows[i] and is meaningful only on the lane's
        final chunk."""
        if not rows or len(rows) > self.prefill_rows:
            raise ValueError(
                f"prefill_chunks wants 1..{self.prefill_rows} rows, "
                f"got {len(rows)}"
            )
        c_ = self.pick_chunk_bucket(max(len(r["tokens"]) for r in rows))
        p_ = self.prefill_rows
        tokens = np.zeros((p_, c_), np.int64)
        tables = np.zeros((p_, self.blocks_per_seq), np.int32)
        p0 = np.zeros((p_,), np.int64)
        true_len = np.zeros((p_,), np.int64)  # stays 0 on pad lanes
        for i, r in enumerate(rows):
            n = len(r["tokens"])
            tokens[i, :n] = r["tokens"]
            tables[i, :len(r["table"])] = r["table"]
            p0[i] = int(r["p0"])
            true_len[i] = n
        dev = self.device
        tables_d = self._as_device(tables, torch.int32)
        true_len_d = self._as_device(true_len, torch.long)
        bs = self.block_size
        positions = (self._as_device(p0, torch.long)[:, None]
                     + torch.arange(c_, device=dev)[None, :])  # (P, C)
        x = self._embed(self._as_device(tokens, torch.long), positions)
        blk_idx = (positions // bs).clamp(max=self.blocks_per_seq - 1)
        blk = torch.gather(tables_d.long(), 1, blk_idx)
        # pad positions (and every position of a pad lane) write to trash
        valid = torch.arange(c_, device=dev)[None, :] < true_len_d[:, None]
        wr = torch.where(valid, blk * bs + positions % bs,
                         TRASH_BLOCK).reshape(-1)
        gr = image_rows(tables_d, bs)  # (P, t_pad)
        # causal over absolute positions: a chunk's queries see the
        # whole cached history plus the intra-chunk triangle
        mask = (torch.arange(self.t_pad, device=dev)[None, None, :]
                <= positions[:, :, None])  # (P, C, t_pad)
        for i, blk_l in enumerate(self.model.blocks):
            y = blk_l.ln1(x)
            q, k, v = blk_l.attn.qkv(y)  # (P, C, H, hd)
            rows_k = k.reshape(-1, self.n_heads, self.head_dim)
            rows_v = v.reshape(-1, self.n_heads, self.head_dim)
            self._kv_write(state, "k", i, rows_k, wr)
            self._kv_write(state, "v", i, rows_v, wr)
            o = local_attention(q, self._kv_image(state, "k", i, gr),
                                self._kv_image(state, "v", i, gr),
                                mask=mask, scale=self.scale)
            x = x + blk_l.attn.out(o)
            x = x + blk_l.mlp(blk_l.ln2(x))
        last = x[torch.arange(p_, device=dev), (true_len_d - 1).clamp(min=0)]
        return self._head(last)

    def verify_chunks(self, *args, **kwargs):
        raise NotImplementedError(
            f"verify_chunks (speculative decoding) {_LATER_SLICE}"
        )

    @_ranged(TICK_RANGE)
    @torch.no_grad()
    def decode_step_paged(self, state: Dict[str, torch.Tensor], tokens,
                          tables, lengths, active) -> torch.Tensor:
        """One decode tick for every lane; host arrays in (tokens (S,),
        tables (S, blocks_per_seq), lengths (S,) = the incoming token's
        position, active (S,) bool), fp32 logits (S, V) out.  Inactive
        lanes write to the trash block."""
        dev = self.device
        bs = self.block_size
        tables_d = self._as_device(tables, torch.int32)
        lengths_d = self._as_device(lengths, torch.int32)
        active_d = self._as_device(active, torch.bool)
        pos_idx = lengths_d.long()
        x = self._embed(self._as_device(tokens, torch.long), pos_idx)
        blk = torch.gather(
            tables_d.long(), 1,
            (pos_idx // bs).clamp(max=self.blocks_per_seq - 1)[:, None],
        )[:, 0]
        wr = torch.where(active_d, blk * bs + pos_idx % bs, TRASH_BLOCK)
        for i, blk_l in enumerate(self.model.blocks):
            y = blk_l.ln1(x)
            q, k, v = blk_l.attn.qkv(y)  # (S, H, hd)
            self._kv_write(state, "k", i, k, wr)
            self._kv_write(state, "v", i, v, wr)
            scales = (dict(k_scale=state["ks"][i], v_scale=state["vs"][i])
                      if self.quantized else {})
            o = paged_decode_attention(
                q, state["k"][i], state["v"][i], tables_d, lengths_d,
                block_size=bs, scale=self.scale, **scales,
            ).to(y.dtype)
            x = x + blk_l.attn.out(o)
            x = x + blk_l.mlp(blk_l.ln2(x))
        return self._head(x)

    def greedy(self, prompt, n_new: int) -> List[int]:
        """Greedy-decode through the full paged scheduler path."""
        from theanompi_tpu_torch.serving.scheduler import (
            ContinuousBatchingScheduler, Request,
        )

        sched = ContinuousBatchingScheduler(self)
        sched.submit(
            Request(id="greedy", prompt=list(prompt), max_new_tokens=n_new)
        )
        return sched.run()["greedy"]
