"""Continuous-batching serve engine over the paged KV cache (port of
``repro/serve/continuous.py``).

Slots join and leave the running batch every step:

* arrivals queue in ``submit``; the engine itself refuses a request that
  exceeds the context window or could never fit the pool, and a bounded
  queue (``max_queue``) refuses overflow at submit;
* admitted requests prefill **individually** into a free slot (B=1 at a
  power-of-two bucketed length, left-padded) while other slots keep
  decoding;
* prompts longer than ``prefill_chunk`` (when set) prefill in **chunks**
  interleaved with decode steps: each engine step advances every
  mid-prefill slot by one chunk through the paged S>1 decode path;
* the KV lands in the block pool (:class:`PagedKVCache`) and grows
  incrementally: admission allocates only the blocks the prefill needs,
  and decode allocates one more each time a request's write position
  crosses a block boundary;
* EOS / token-budget completion frees the slot and its blocks at once.

Mispredicted load is a handled event: **preemption** (the youngest
running request is evicted when the pool cannot supply a growing one,
keeps its generated tokens, re-queues at the head and resumes by
re-prefilling prompt + generated tokens), **deadlines + watchdog**
(``Request.deadline_ms`` and ``watchdog_ms`` expire queued and running
requests into the terminal ``EXPIRED`` state) and a seeded
:class:`~repro_torch.serve.faults.FaultPlan` that injects allocation
failures and slow steps.

Every decode step runs all decodable slots through
``transformer.decode_step`` over the pool, whose attention goes through
the paged-decode CUDA kernel on the card.  Sampling is greedy at
temperature 0, else ``torch.multinomial`` driven by a ``torch.Generator``
seeded from ``ContinuousConfig.seed`` (a different stream from the
reference's ``jax.random``, so only greedy runs match it token for token).

Not in this slice: admission pricing through a cost engine
(``SLOScheduler``, backend failover, degraded mode and the config fields
that drive them) — passing ``cost_engine`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import PlacementRefused

__all__ = ["ContinuousConfig", "ContinuousEngine"]

COST_ENGINE_TODO = ("admission through a cost engine is not ported yet "
                    "(ROADMAP.md, Queue 1: 'Cost engine and serve admission')")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class ContinuousConfig:
    max_len: int = 512
    n_slots: int = 8
    temperature: float = 0.0
    eos_id: int = 1
    seed: int = 0
    block_size: int | None = None     # None → serve_kv tiling default
    pool_tokens: int | None = None    # None → n_slots·max_len / 2 budget
    prefill_chunk: int | None = None  # chunked prefill: max tokens prefilled
    #                                   per engine step (None = whole prompt)
    max_queue: int | None = None      # bounded wait queue; None = unbounded
    watchdog_ms: float | None = None  # engine-wide TTL; None = off


class ContinuousEngine:
    def __init__(self, cfg: ArchConfig, params,
                 scfg: ContinuousConfig | None = None, *,
                 cost_engine=None, faults=None, clock=None, device="cuda"):
        if cost_engine is not None:
            raise NotImplementedError(COST_ENGINE_TODO)
        self.device = resolve_device(device)
        param_device = params.embed.device
        if param_device.type != self.device.type:
            raise ValueError(f"params live on {param_device}, engine device "
                             f"is {self.device}")
        self.cfg = cfg
        self.scfg = scfg = scfg or ContinuousConfig()
        self.params = params
        self.faults = faults
        self._clock = clock or time.perf_counter
        self._skew_s = 0.0                 # virtual stall from "slow" faults
        self.kv = PagedKVCache(
            cfg, n_slots=scfg.n_slots, max_len=scfg.max_len,
            block_size=scfg.block_size, pool_tokens=scfg.pool_tokens,
            faults=faults, device=self.device)

        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * scfg.n_slots
        self.finished: list[Request] = []
        self.refused: list[Request] = []
        self.expired: list[Request] = []
        self.submitted = 0
        self._admit_seq = 0
        self._cache_len = np.zeros(scfg.n_slots, np.int64)
        self._last_tok = np.zeros(scfg.n_slots, np.int32)
        self._prefilling = np.zeros(scfg.n_slots, bool)  # mid-chunked-prefill
        self._step = 0
        self.decode_steps = 0
        # stall = a step where a decodable slot existed but no decode ran
        # (0 by construction: chunked prefill interleaves with decode)
        self._stall_run = 0
        self.max_decode_stall_steps = 0
        # widest prefill forward (padded tokens) run while decodable slots
        # waited — the stall bound a running slot can see between tokens
        self.max_prefill_stall_tokens = 0
        self.kv_gathered_bytes = 0.0   # (B · nb) blocks a gather would read
        self.kv_touched_bytes = 0.0    # live blocks the decode kernel touches
        self.counters = {
            "preemptions": 0,        # running requests evicted for blocks
            "resumes": 0,            # preempted requests re-admitted
            "expired_queued": 0,     # deadline/watchdog sheds from the queue
            "expired_running": 0,    # watchdog kills of running requests
            "shed_backpressure": 0,  # bounded-queue refusals at submit
            "alloc_denied": 0,       # pool alloc failures (real or injected)
            "prefill_chunks": 0,     # chunked-prefill chunks processed
        }
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)

    # ------------------------------------------------------------------

    def _sample(self, logits) -> np.ndarray:
        """(B, S, V) logits → (B,) token ids sampled at the last position."""
        z = logits[:, -1].float()
        if self.scfg.temperature <= 0:
            ids = torch.argmax(z, dim=-1)
        else:
            probs = torch.softmax(z / self.scfg.temperature, dim=-1)
            ids = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return ids.to(torch.int32).cpu().numpy()

    @property
    def n_running(self) -> int:
        return sum(r is not None for r in self.slots)

    def _has_decodable(self) -> bool:
        return any(r is not None and not self._prefilling[i]
                   for i, r in enumerate(self.slots))

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_running == 0

    def _now(self) -> float:
        return self._clock() + self._skew_s

    @property
    def lost(self) -> int:
        """Zero-lost accounting: submitted requests not in a terminal
        state and no longer queued or running.  Must be 0 always."""
        in_flight = len(self.queue) + self.n_running
        terminal = len(self.finished) + len(self.refused) + len(self.expired)
        return self.submitted - in_flight - terminal

    def submit(self, request: Request) -> Request:
        self.submitted += 1
        request.step_submitted = self._step
        if (self.scfg.max_queue is not None
                and len(self.queue) >= self.scfg.max_queue):
            request.state = RequestState.REFUSED
            request.refusal = PlacementRefused(
                f"request {request.rid} refused: wait queue full "
                f"({self.scfg.max_queue} deep) — backpressure",
                {"reason": "queue full", "max_queue": self.scfg.max_queue})
            self.refused.append(request)
            self.counters["shed_backpressure"] += 1
            return request
        self.queue.append(request)
        return request

    # ------------------------------------------------------------------
    # deadlines, TTL, shedding (requests leave without a crash)

    def _deadline_reason(self, req: Request, now: float) -> str | None:
        t_dl = req.t_deadline
        if t_dl is not None and now > t_dl:
            return f"deadline ({req.deadline_ms:.0f}ms TTL) passed"
        wd = self.scfg.watchdog_ms
        if wd is not None and now > req.t_arrival + wd / 1e3:
            return f"watchdog ({wd:.0f}ms) expired stuck request"
        return None

    def _release_slot(self, req: Request) -> None:
        if req.blocks:
            self.kv.free(req.blocks)
            req.blocks = []
        if req.slot is not None:
            self.slots[req.slot] = None
            self._cache_len[req.slot] = 0
            self._last_tok[req.slot] = 0
            self._prefilling[req.slot] = False
            req.slot = None
        req.prefill_pos = 0

    def _expire_request(self, req: Request, reason: str) -> None:
        """Typed terminal EXPIRED state: blocks and slot are released, the
        partial output (req.tokens) is retained for the caller."""
        req.state = RequestState.EXPIRED
        req.expiry = reason
        req.t_finished = self._now()
        self._release_slot(req)
        self.expired.append(req)

    def _expire_sweep(self) -> None:
        now = self._now()
        if self.queue:
            keep: deque[Request] = deque()
            for req in self.queue:
                reason = self._deadline_reason(req, now)
                if reason is None:
                    keep.append(req)
                else:
                    self._expire_request(req, reason)
                    self.counters["expired_queued"] += 1
            self.queue = keep
        for req in list(self.slots):
            if req is None:
                continue
            reason = self._deadline_reason(req, now)
            if reason is not None:
                self._expire_request(req, reason)
                self.counters["expired_running"] += 1

    # ------------------------------------------------------------------
    # admission + prefill (slots join)

    def _refuse(self, req: Request, reason: str, info: dict | None = None) -> None:
        self.queue.popleft()
        req.state = RequestState.REFUSED
        req.refusal = PlacementRefused(
            f"request {req.rid} (prompt={req.prompt_len}, "
            f"max_new={req.max_new_tokens}) refused: {reason}",
            dict(info or {}, reason=reason))
        self.refused.append(req)

    def _admissions(self) -> None:
        while self.queue and None in self.slots:
            req = self.queue[0]
            if req.state is not RequestState.PREEMPTED:
                need = req.prompt_len + req.max_new_tokens
                if need > self.scfg.max_len:
                    self._refuse(req, f"needs {need} tokens > "
                                      f"max_len={self.scfg.max_len}")
                    continue
                # a request whose lifetime footprint exceeds the whole pool
                # can never be packed: retrying it every step is a livelock
                need_blocks = self.kv.blocks_for(min(need, self.scfg.max_len))
                if need_blocks > self.kv.usable_blocks:
                    self._refuse(
                        req, f"pool capacity: needs {need_blocks} KV blocks "
                             f"> pool of {self.kv.usable_blocks}",
                        {"need_blocks": need_blocks,
                         "pool_blocks": self.kv.usable_blocks})
                    continue
            # incremental allocation: only what the prefill itself needs
            # (+ the first decode write)
            total = req.prompt_len + req.n_generated
            blocks = self.kv.alloc(self.kv.blocks_for(
                min(total + 1, self.scfg.max_len)))
            if blocks is None:
                self.counters["alloc_denied"] += 1
                break                      # pool busy: retry next step
            self.queue.popleft()
            req.blocks = blocks
            if req.state is RequestState.PREEMPTED:
                self.counters["resumes"] += 1
            req.state = RequestState.ADMITTED
            if req.admit_seq is None:      # age = FIRST admission order
                req.admit_seq = self._admit_seq
                self._admit_seq += 1
            self._prefill_into(req, self.slots.index(None))

    def _first_token(self, req: Request, slot: int, tok: int) -> None:
        req.tokens.append(tok)
        if req.t_first_token is None:
            req.t_first_token = self._now()
            req.step_first_token = self._step
        self._cache_len[slot] = len(req.sequence()) - 1
        self._last_tok[slot] = tok

    def _prefill_into(self, req: Request, slot: int) -> None:
        # A resumed request re-prefills over prompt + generated tokens
        # (recompute-on-resume).
        seq = req.sequence()
        S = len(seq)
        others_decodable = self._has_decodable()
        req.state = RequestState.RUNNING
        req.slot = slot
        self.slots[slot] = req
        chunk = self.scfg.prefill_chunk
        if chunk is not None and S > chunk:
            # chunked prefill: occupy the slot now, feed the prompt in
            # ``chunk``-sized pieces interleaved with decode steps
            req.prefill_pos = 0
            self._prefilling[slot] = True
            self._cache_len[slot] = 0
            self._last_tok[slot] = 0
            return
        bs = self.kv.block_size
        width = min(_next_pow2(max(S, bs)), -(-self.scfg.max_len // bs) * bs)
        if others_decodable:
            self.max_prefill_stall_tokens = max(
                self.max_prefill_stall_tokens, width)
        pad = width - S
        tokens = np.zeros((1, width), np.int32)
        tokens[0, pad:] = seq
        out = T.prefill(self.params, {
            "tokens": torch.from_numpy(tokens).to(self.device),
            "pos_offset": torch.tensor([pad], dtype=torch.int32,
                                       device=self.device),
        }, self.cfg, max_len=-(-width // bs) * bs)
        tok = int(self._sample(out["logits"])[0])
        self.kv.pack_prefill(out["cache"], req.blocks, prompt_len=S, pad=pad)
        self._first_token(req, slot, tok)
        self._retire_if_done(req)   # max_new_tokens=1 / instant EOS

    def _prefill_chunks(self) -> None:
        """Advance every mid-prefill slot by one chunk through the paged
        S > 1 ``decode_step`` path, right-padded to a pow2 width; junk
        positions lie beyond every real token and write to scratch block 0
        through table columns past the row's own blocks.  The final chunk
        samples the first new token from the last *real* position, exactly
        where the solo prefill samples."""
        chunk = self.scfg.prefill_chunk
        bs = self.kv.block_size
        for slot in np.flatnonzero(self._prefilling):
            slot = int(slot)
            req = self.slots[slot]
            seq = req.sequence()
            s0 = req.prefill_pos
            clen = min(chunk, len(seq) - s0)
            width = _next_pow2(clen)
            if self._has_decodable():
                self.max_prefill_stall_tokens = max(
                    self.max_prefill_stall_tokens, width)
            tokens = np.zeros((1, width), np.int32)
            tokens[0, :clen] = seq[s0:s0 + clen]
            nb = _next_pow2((s0 + width - 1) // bs + 1)
            table = np.zeros((1, nb), np.int32)   # pad → scratch block 0
            table[0, :len(req.blocks[:nb])] = req.blocks[:nb]
            logits, _ = T.decode_step(self.params, self.kv.pool, {
                "tokens": torch.from_numpy(tokens).to(self.device),
                "cache_len": torch.tensor([s0], dtype=torch.int32,
                                          device=self.device),
                "block_table": torch.from_numpy(table).to(self.device),
            }, self.cfg)
            self.counters["prefill_chunks"] += 1
            req.prefill_pos = s0 + clen
            self._cache_len[slot] = req.prefill_pos
            if req.prefill_pos < len(seq):
                continue
            # final chunk: the slot joins the decodable set from the next
            # _decode_once on
            tok = int(self._sample(logits[:, clen - 1:clen])[0])
            self._prefilling[slot] = False
            req.prefill_pos = 0
            self._first_token(req, slot, tok)
            self._retire_if_done(req)

    # ------------------------------------------------------------------
    # preemption under pool pressure (slots leave involuntarily)

    def _preempt(self, req: Request) -> None:
        """Evict a running request: blocks back to the pool, generated
        tokens retained, re-queued at the head."""
        self.counters["preemptions"] += 1
        req.preemptions += 1
        self._release_slot(req)      # chunked prefill restarts on resume
        req.state = RequestState.PREEMPTED
        self.queue.appendleft(req)

    def _youngest_running(self) -> Request | None:
        alive = [r for r in self.slots if r is not None]
        if not alive:
            return None
        return max(alive, key=lambda r: r.admit_seq)

    def _grow_blocks(self) -> None:
        """Before decoding, make sure every occupied slot owns the block
        its next KV write lands in.  A pool shortfall preempts the
        youngest running request (possibly the grower itself) — never the
        oldest while younger victims exist."""
        order = sorted(
            (i for i, r in enumerate(self.slots) if r is not None),
            key=lambda i: self.slots[i].admit_seq)
        for i in order:
            req = self.slots[i]
            if req is None:
                continue               # already taken as a victim
            need_idx = int(self._cache_len[i]) // self.kv.block_size
            while req.slot is not None and len(req.blocks) <= need_idx:
                got = self.kv.alloc(1)
                if got is not None:
                    req.blocks.extend(got)
                    continue
                self.counters["alloc_denied"] += 1
                victim = self._youngest_running()
                if victim is None or victim is req:
                    self._preempt(req)     # nobody younger: yield itself
                    break
                self._preempt(victim)      # then retry the alloc

    # ------------------------------------------------------------------
    # decode (all occupied slots advance one token)

    def _decode_once(self) -> None:
        self._grow_blocks()
        # Mid-prefill slots are occupied but not decodable: their table
        # rows stay empty (scratch) and cache_len is masked to 0, so the
        # batched step writes their junk token to scratch block 0.
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and not self._prefilling[i]]
        if not active:
            return
        bs = self.kv.block_size
        nb_need = max(int(self._cache_len[i]) // bs + 1 for i in active)
        nb = min(_next_pow2(nb_need), self.kv.blocks_per_seq)
        decodable = np.zeros(len(self.slots), bool)
        decodable[active] = True
        table = self.kv.table_array(
            [r.blocks[:nb] if decodable[i] else []
             for i, r in enumerate(self.slots)], nb)
        cache_len = np.where(decodable, self._cache_len, 0).astype(np.int32)
        per_block = self.kv.bytes / self.kv.n_blocks
        self.kv_gathered_bytes += len(self.slots) * nb * per_block
        self.kv_touched_bytes += per_block * sum(
            int(self._cache_len[i]) // bs + 1 for i in active)
        logits, _ = T.decode_step(self.params, self.kv.pool, {
            "tokens": torch.from_numpy(self._last_tok[:, None].copy()).to(
                self.device),
            "cache_len": torch.from_numpy(cache_len).to(self.device),
            "block_table": table,
        }, self.cfg)
        toks = self._sample(logits)
        self.decode_steps += 1
        now = self._now()
        for i in active:
            req = self.slots[i]
            tok = int(toks[i])
            req.tokens.append(tok)
            self._cache_len[i] += 1
            self._last_tok[i] = tok
            self._retire_if_done(req, now)

    def _retire_if_done(self, req: Request, now: float | None = None) -> None:
        done = (req.tokens[-1] == self.scfg.eos_id
                or req.n_generated >= req.max_new_tokens
                or req.prompt_len + req.n_generated >= self.scfg.max_len)
        if not done:
            return
        req.state = RequestState.FINISHED
        req.t_finished = now if now is not None else self._now()
        self._release_slot(req)
        self.finished.append(req)

    # ------------------------------------------------------------------

    def step(self) -> None:
        """One engine iteration: expire stale work, admit+prefill into
        free slots, advance chunked prefills, then one ragged decode step
        for every decodable slot.  Injected faults (allocation denial,
        slow steps) are handled inside the call."""
        self._step += 1
        if self.faults is not None:
            self.faults.begin_step(self._step)
            self._skew_s += float(self.faults.fire("slow"))
        self._expire_sweep()
        self._admissions()
        self._prefill_chunks()
        decodable_before = self._has_decodable()
        before = self.decode_steps
        self._decode_once()
        if (decodable_before and self.decode_steps == before
                and self._has_decodable()):
            self._stall_run += 1
            self.max_decode_stall_steps = max(self.max_decode_stall_steps,
                                              self._stall_run)
        else:
            self._stall_run = 0

    def run(self, requests: list[Request] | None = None, *,
            max_steps: int = 100_000) -> list[Request]:
        """Drain: submit ``requests`` (if given) and step until idle."""
        for r in requests or ():
            self.submit(r)
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.finished

    # ------------------------------------------------------------------

    def metrics(self) -> dict:
        ttfts = [r.ttft_s for r in self.finished if r.ttft_s is not None]
        tpots = [r.tpot_s for r in self.finished if r.tpot_s is not None]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else float("nan")

        out = {
            "finished": len(self.finished),
            "refused": len(self.refused),
            "expired": len(self.expired),
            "submitted": self.submitted,
            "lost": self.lost,
            "decode_steps": self.decode_steps,
            "tokens_out": sum(r.n_generated for r in self.finished),
            "ttft_p50_ms": pct(ttfts, 50) * 1e3,
            "ttft_p99_ms": pct(ttfts, 99) * 1e3,
            "tpot_p50_ms": pct(tpots, 50) * 1e3,
            "tpot_p99_ms": pct(tpots, 99) * 1e3,
            "kv_bytes": self.kv.bytes,
            "kv_dense_bytes": self.kv.dense_bytes,
            "block_size": self.kv.block_size,
            "max_decode_stall_steps": self.max_decode_stall_steps,
            "max_prefill_stall_tokens": self.max_prefill_stall_tokens,
            "kv_gathered_bytes": self.kv_gathered_bytes,
            "kv_touched_bytes": self.kv_touched_bytes,
            **self.counters,
        }
        if self.faults is not None:
            out["faults"] = self.faults.summary()
        return out
