"""Continuous batching over a fixed set of decode slots — counterpart of
``theanompi_tpu.serving.scheduler``.

Each slot is an independent lane: a request joins the moment a slot is
free (its prefill runs between decode ticks) and leaves the moment it
finishes, returning the slot.  The decode step keeps one shape.

- **contiguous** (``ServingEngine``) — each slot owns a ``max_len``
  cache region; admission prefills one slot at a time.
- **paged** (``paging.PagedServingEngine``) — slots own block tables
  into a shared pool.  Admission allocates exactly the blocks a request
  can ever need (prompt + ``max_new_tokens``), reuses cached prefix
  blocks, and defers — backpressure, never a crash — when the pool is
  exhausted after evicting idle cached prefixes.  Prefill is chunked
  and batched; finishing releases the slot's blocks.

Determinism: every per-slot computation is independent across slots,
so a request's output under any interleaving equals its output alone.

Picks: a greedy request (``temperature=0``) takes the exact argmax of
its fp32 logits; a sampled one draws through ``sampling.Sampler`` with
the noise of its own (seed, id, token index), so its stream does not
depend on the batch.  One batched pick on the device and one host
transfer per call, greedy or not.  Speculative decoding, draining,
serving metrics and request tracing are later slices of the port.
``metrics``, when given, receives the reference's hook calls:
``admitted(rid, prompt_len, t)``, ``first_token(rid, t)``,
``finished(rid, n_tokens, t)`` (``t`` from ``time.perf_counter``) and,
after ``run``, ``set_engine_stats(stats)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from theanompi_tpu_torch.serving.sampling import (
    Sampler,
    gumbel_noise,
    request_seed,
)

_LATER_SLICE = "is a later slice of the PyTorch port"


@dataclass
class Request:
    """One generation request.

    ``temperature=0`` = greedy (exact argmax, the default);
    ``temperature>0`` samples, optionally through a ``top_k`` filter,
    deterministically per ``seed`` (an unseeded request derives its seed
    from its id).  ``token_index0`` is the token index of the first new
    pick (a request that replays earlier output as its prompt keeps the
    stream it would have drawn).
    """

    id: str
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    seed: Optional[int] = None
    token_index0: int = 0
    # filled by the scheduler
    output: List[int] = field(default_factory=list)

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.id!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.id!r}: max_new_tokens must be >= 1"
            )
        if self.temperature < 0:
            raise ValueError(
                f"request {self.id!r}: temperature must be >= 0 "
                f"(0 = greedy), got {self.temperature}"
            )
        if self.top_k < 0:
            raise ValueError(
                f"request {self.id!r}: top_k must be >= 0 "
                f"(0 = disabled), got {self.top_k}"
            )


class _Slot:
    __slots__ = ("request", "produced", "blocks", "n_fed", "decoding")

    def __init__(self):
        self.request: Optional[Request] = None
        self.produced = 0   # tokens generated so far for the request
        self.blocks: List[int] = []  # paged: block ids this slot holds
        self.n_fed = 0      # paged: prompt tokens resident (hits + fed)
        self.decoding = False  # paged: prompt fully prefilled


class ContinuousBatchingScheduler:
    """Admission queue + slot table driving one serving engine.

    ``step()`` is one serving tick: admissions, (paged) one batched
    chunked-prefill call, then one batched decode step for every active
    slot.  ``run()`` loops until drained.  Completed requests land in
    ``finished`` (id → token list).  ``pool`` (paged engines only)
    overrides the block allocator.
    """

    def __init__(self, engine, metrics=None, pool=None, spec_k: int = 0,
                 draft_engine=None):
        if int(spec_k) or draft_engine is not None:
            raise NotImplementedError(
                f"speculative decoding (spec_k, draft_engine) {_LATER_SLICE}"
            )
        self.engine = engine
        self.metrics = metrics
        self.paged = bool(getattr(engine, "is_paged", False))
        self.slots = [_Slot() for _ in range(engine.n_slots)]
        self.queue: List[Request] = []
        self.finished: Dict[str, List[int]] = {}
        self.sampler = Sampler()
        self._tokens = np.zeros((engine.n_slots,), np.int64)
        self._active = np.zeros((engine.n_slots,), bool)
        # per-run reuse/capacity stats (host-side, exact)
        self.stats = {
            "peak_concurrent": 0,
            "prefill_tokens": 0,
            "prefill_chunks": 0,
            "prefix_hits": 0,
            "prefix_misses": 0,
            "prefix_hit_tokens": 0,
            "backpressure_events": 0,
            "decode_ticks": 0,
        }
        if self.paged:
            if pool is not None and pool.block_size != engine.block_size:
                raise ValueError("pool/engine block_size mismatch")
            self.pool = pool if pool is not None else engine.make_pool()
            from theanompi_tpu_torch.serving.paging import PrefixCache

            self.prefix = PrefixCache(self.pool)
            self.state = engine.init_state()
            self._tables = np.zeros(
                (engine.n_slots, engine.blocks_per_seq), np.int32
            )
            self._lengths = np.zeros((engine.n_slots,), np.int32)
        else:
            if pool is not None:
                raise ValueError("pool= applies to paged engines only")
            self.pool = None
            self.prefix = None
            self.cache = engine.init_cache()

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        total = len(request.prompt) + request.max_new_tokens
        if total > self.engine.max_len:
            raise ValueError(
                f"request {request.id!r} needs {total} cache rows > "
                f"max_len={self.engine.max_len}"
            )
        if self.paged:
            need = self.engine.max_seq_blocks(total)
            if need > self.pool.n_blocks - 1:
                raise ValueError(
                    f"request {request.id!r} needs {need} KV blocks > "
                    f"pool capacity {self.pool.n_blocks - 1} — it could "
                    "never be admitted"
                )
        if self.metrics is not None:
            self.metrics.admitted(request.id, len(request.prompt),
                                  t=time.perf_counter())
        self.queue.append(request)

    @property
    def n_active(self) -> int:
        """Occupied slots (prefilling or decoding)."""
        if self.paged:
            return sum(1 for s in self.slots if s.request is not None)
        return int(self._active.sum())

    def _note_concurrency(self) -> None:
        self.stats["peak_concurrent"] = max(
            self.stats["peak_concurrent"], self.n_active
        )

    def _finish(self, i: int) -> None:
        slot, req = self.slots[i], self.slots[i].request
        self.finished[req.id] = req.output
        if self.metrics is not None:
            self.metrics.finished(req.id, len(req.output),
                                  t=time.perf_counter())
        if self.paged:
            # join-on-finish recycling also reclaims memory: every block
            # reference this slot holds goes back to the pool
            # (prefix-cached blocks drop one ref and live on)
            self.pool.release_all(slot.blocks)
            slot.blocks = []
            slot.n_fed = 0
            slot.decoding = False
            self._tables[i, :] = 0
            self._lengths[i] = 0
        slot.request = None
        slot.produced = 0
        self._active[i] = False

    def _pick_batch(self, reqs: List[Optional[Request]],
                    logits: torch.Tensor) -> np.ndarray:
        """The next token for every row of ``logits`` (N, V);
        ``reqs[i] is None`` marks a row whose pick is discarded."""
        return self._pick_tokens(
            [(r, len(r.output)) if r is not None else None for r in reqs],
            logits,
        )

    def _pick_tokens(self, picks, logits: torch.Tensor) -> np.ndarray:
        """Row i of ``logits`` (N, V) picks for ``picks[i] = (request,
        token_index)`` (None = discarded row).  With no sampled row this
        is one device argmax (the first maximum wins ties); otherwise
        sampled rows draw with the noise of (seed, id, token_index0 +
        token_index) and greedy rows stay the argmax.  One host
        transfer either way."""
        sampled = [p is not None and p[0].temperature > 0.0 for p in picks]
        if not any(sampled):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        n = len(picks)
        temps = np.zeros((n,), np.float32)
        top_ks = np.zeros((n,), np.int64)
        words = np.zeros((n,), np.int64)
        for i, p in enumerate(picks):
            if not sampled[i]:
                continue
            r, idx = p
            temps[i] = r.temperature
            top_ks[i] = r.top_k
            words[i] = request_seed(r.seed, r.id, r.token_index0 + idx)
        noise = gumbel_noise(words, logits.shape[-1], device=logits.device)
        return self.sampler.pick_batch(logits, noise, temps, top_ks)

    def _emit(self, i: int, token: int) -> bool:
        """Append one generated token to slot i's request; True when the
        request just finished (eos or budget)."""
        slot = self.slots[i]
        req = slot.request
        req.output.append(token)
        slot.produced += 1
        if slot.produced == 1 and self.metrics is not None:
            self.metrics.first_token(req.id, t=time.perf_counter())
        return (
            slot.produced >= req.max_new_tokens
            or (req.eos_id is not None and token == req.eos_id)
        )

    # ------------------------------------------------------------------
    # contiguous tick
    # ------------------------------------------------------------------
    def _step_contiguous(self) -> int:
        produced = 0
        # 1) join-on-finish admission: every free slot takes the oldest
        # queued request; its prefill yields the request's first token
        for i, slot in enumerate(self.slots):
            if slot.request is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            slot.request = req
            logits = self.engine.prefill(self.cache, i, req.prompt)
            self._active[i] = True
            self._note_concurrency()
            produced += 1
            if self._emit(i, int(self._pick_batch([req], logits[None])[0])):
                self._finish(i)
        # 2) one fixed-shape decode tick over the active slots
        if self._active.any():
            for i, slot in enumerate(self.slots):
                # the token entering each active slot = its last output
                self._tokens[i] = (
                    slot.request.output[-1] if self._active[i] else 0
                )
            was_active = self._active.copy()
            logits = self.engine.decode_step(
                self.cache, self._tokens, self._active
            )
            self.stats["decode_ticks"] += 1
            toks = self._pick_batch(
                [s.request if was_active[i] else None
                 for i, s in enumerate(self.slots)], logits)
            for i in range(len(self.slots)):
                if not was_active[i]:
                    continue
                produced += 1
                if self._emit(i, int(toks[i])):
                    self._finish(i)
        return produced

    # ------------------------------------------------------------------
    # paged tick
    # ------------------------------------------------------------------
    def _admit_paged(self) -> None:
        """Free slots take queued requests FIFO; each admission reuses
        every cached prefix block it can, then allocates exactly the
        fresh blocks the request can ever need.  An exhausted pool (after
        evicting idle cached prefixes) defers admission to a later tick
        and keeps FIFO order (nothing jumps the stuck head)."""
        for i, slot in enumerate(self.slots):
            if slot.request is not None or not self.queue:
                continue
            req = self.queue[0]
            need = self.engine.max_seq_blocks(
                len(req.prompt) + req.max_new_tokens
            )
            hits, hit_tokens = self.prefix.match(req.prompt)
            fresh = self.pool.alloc(need - len(hits))
            if fresh is None:
                self.prefix.evict_unused()
                fresh = self.pool.alloc(need - len(hits))
            if fresh is None:
                # roll back the prefix refs; the request stays queued
                self.pool.release_all(hits)
                self.stats["backpressure_events"] += 1
                break
            self.queue.pop(0)
            slot.request = req
            slot.blocks = hits + fresh
            slot.n_fed = hit_tokens
            slot.decoding = False
            self._tables[i, :] = 0
            self._tables[i, :len(slot.blocks)] = slot.blocks
            self._lengths[i] = hit_tokens
            self.stats["prefix_hits"] += 1 if hits else 0
            self.stats["prefix_misses"] += 0 if hits else 1
            self.stats["prefix_hit_tokens"] += hit_tokens
            self._note_concurrency()

    def _prefill_tick_paged(self) -> int:
        """One batched prefill call: every lane still holding unfed
        prompt tokens advances by one chunk (up to ``prefill_rows``
        lanes).  A lane whose prompt completes emits its first token
        this tick; longer prompts resume next tick."""
        pending = [
            i for i, s in enumerate(self.slots)
            if s.request is not None
            and s.n_fed < len(s.request.prompt)
        ][: self.engine.prefill_rows]
        if not pending:
            return 0
        cap = (
            self.engine.prefill_chunk
            if self.engine.prefill_chunk is not None
            else self.engine.chunk_buckets[-1]
        )
        rows = []
        for i in pending:
            s = self.slots[i]
            chunk = s.request.prompt[s.n_fed:s.n_fed + cap]
            rows.append({"tokens": chunk, "p0": s.n_fed, "table": s.blocks})
        logits = self.engine.prefill_chunks(self.state, rows)
        self.stats["prefill_chunks"] += 1
        produced = 0
        completing: List[int] = []
        for r_idx, i in enumerate(pending):
            s = self.slots[i]
            s.n_fed += len(rows[r_idx]["tokens"])
            self._lengths[i] = s.n_fed
            if s.n_fed >= len(s.request.prompt):
                completing.append(r_idx)
            self.stats["prefill_tokens"] += len(rows[r_idx]["tokens"])
        if completing:
            reqs = [None] * logits.shape[0]
            for r_idx in completing:
                reqs[r_idx] = self.slots[pending[r_idx]].request
            picks = self._pick_batch(reqs, logits)
            for r_idx in completing:
                i = pending[r_idx]
                s = self.slots[i]
                self.prefix.insert(s.request.prompt, s.blocks)
                s.decoding = True
                self._active[i] = True
                produced += 1
                if self._emit(i, int(picks[r_idx])):
                    self._finish(i)
        return produced

    def _decode_tick_paged(self) -> int:
        decoding = np.array([s.decoding for s in self.slots], dtype=bool)
        if not decoding.any():
            return 0
        for i, slot in enumerate(self.slots):
            self._tokens[i] = slot.request.output[-1] if decoding[i] else 0
        logits = self.engine.decode_step_paged(
            self.state, self._tokens, self._tables, self._lengths, decoding,
        )
        self.stats["decode_ticks"] += 1
        # the tick wrote each active lane's token at row `length`;
        # advance after the call so the next tick writes the next row
        self._lengths[decoding] += 1
        toks = self._pick_batch(
            [s.request if decoding[i] else None
             for i, s in enumerate(self.slots)], logits)
        produced = 0
        for i in range(len(self.slots)):
            if not decoding[i]:
                continue
            produced += 1
            if self._emit(i, int(toks[i])):
                self._finish(i)
        return produced

    def _step_paged(self) -> int:
        self._admit_paged()
        produced = self._prefill_tick_paged()
        return produced + self._decode_tick_paged()

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One tick: admissions, (paged) chunked prefill, then one
        decode step.  Returns the number of tokens generated."""
        return self._step_paged() if self.paged else self._step_contiguous()

    def run(self, max_ticks: int = 100_000) -> Dict[str, List[int]]:
        """Drive ``step()`` until queue and slots drain.  Returns
        ``finished`` (id → generated tokens)."""
        ticks = 0
        while self.queue or self.n_active:
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"scheduler did not drain within {max_ticks} ticks"
                )
            self.step()
        if self.metrics is not None:
            stats = dict(self.stats)
            if self.paged:
                stats["pool_peak_used_blocks"] = self.pool.peak_used
                stats["pool_blocks"] = self.pool.n_blocks - 1
                stats["prefix_entries"] = len(self.prefix)
            self.metrics.set_engine_stats(stats)
        return self.finished
